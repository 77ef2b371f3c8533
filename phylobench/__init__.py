"""phylobench: the benchmark of examl_tpu_torch on an NVIDIA H100.

See README.md.  `python3 -m phylobench --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once.
"""
