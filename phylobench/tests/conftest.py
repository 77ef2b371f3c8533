"""The benchmark's own tests: CPU at tiny sizes, and the card where the
`cuda` marker says so (run on the card with
`python3 -m pytest phylobench/tests -m cuda`)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where torch.cuda is "
        "unavailable")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none here")


def tiny(workload: str) -> dict:
    """A cell's configuration cut to a size the CPU runs in seconds."""
    from phylobench import run
    bench = run.load_json(ROOT / "BENCHMARK.json")
    cfg = run.config_of(bench, run.cell_of(bench, workload)["config"])
    cut = {"dna_birds48": dict(taxa=9, patterns=700),
           "aa_kite144": dict(taxa=8, patterns=900, partitions=7,
                              least_gene_width=20)}[cfg["name"]]
    cfg.update(cut)
    return cfg


WORKLOADS = ["birds48.probe", "birds48.spr", "kite144.probe"]
