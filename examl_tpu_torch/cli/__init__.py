"""Command-line entry points of examl_tpu_torch."""
