"""Run one cell of BENCHMARK.json once and print its one-line result.

    python3 -m phylobench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic mix by name, makes every
input from the seed, builds the program's instance, warms up, measures
for `--seconds`, reads the device peak, frees the program's state, has
the plain reference judge a sample of what the timed path answered,
checks that no JAX module was loaded, and prints the result as the last
line of standard output (the compared numbers and their limits also as
the last lines of standard error).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

T_START = time.perf_counter()

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "examl_tpu")


class NoCard(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def cache_dirs() -> None:
    """The program's kernel builds (and Triton's cache, should anything
    use it) go to fixed directories inside the checkout."""
    base = ROOT / "build" / "phylobench"
    os.environ["EXAML_BUILD_DIR"] = str(base / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def read_metric(name: str, measure) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(
        "phylobench_metric_" + name.replace(".", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(measure)


class Measure:
    """What the per-layer readers read: the benchmark's spans, the
    program's counters over the window and the device trace."""

    def __init__(self, kind, spans, counters, trace):
        self.kind = kind
        self.spans = spans
        self.counters = counters
        self.trace = trace


def build(inputs, device, clv_dtype=None, dtype=None, devices=None):
    """The program's instance and tree, from the generated inputs, in the
    configuration's float32 unless a test asks for `dtype`; with more
    than one of `devices`, a site mesh over them (one site shard a
    device)."""
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import AlignmentData, PartitionData
    import numpy as np
    import torch
    cfg = inputs.config
    dt = datatypes.DNA if cfg["datatype"] == "DNA" else datatypes.AA
    parts, o = [], 0
    for g, w in enumerate(inputs.widths.tolist()):
        parts.append(PartitionData(
            name=f"g{g}", datatype=dt, model_name=cfg["model"],
            patterns=inputs.codes[:, o:o + w],
            weights=np.ones(w, dtype=np.int64),
            empirical_freqs=inputs.freqs,
            use_empirical_freqs=cfg["model"] == "GTR", optimize_freqs=False))
        o += w
    sharding = None
    if devices is not None and len(devices) > 1:
        from examl_tpu_torch.parallel.sharding import make_mesh, site_sharding
        sharding = site_sharding(make_mesh(devices))
    inst = PhyloInstance(AlignmentData(inputs.names, parts),
                         dtype=dtype or torch.float32, device=device,
                         clv_dtype=clv_dtype, sharding=sharding)
    tree = inst.tree_from_newick(inputs.topo.newick(inputs.names))
    return inst, tree


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, config: Optional[dict] = None,
             clv_dtype=None, fault=None):
    """One run: (result dict, compared numbers).  `device` None is the
    card (cuda:0); tests pass "cpu", a cut `config` and a `fault` that
    breaks the instance after it is built."""
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_of(bench, workload)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < int(cell["chips"])):
            raise NoCard(f"{workload} needs {cell['chips']} CUDA device(s); "
                         f"torch.cuda.is_available()="
                         f"{torch.cuda.is_available()}, device_count="
                         f"{torch.cuda.device_count()}")
        device = torch.device("cuda:0")
    device = torch.device(device)
    cfg = dict(config or config_of(bench, cell["config"]))
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    # A mix over S site shards runs S cards' shares of the deployment,
    # one on each card (on the CPU, S shards of the one device).
    shards = int(mix.get("site_shards", 1))
    cfg["patterns"] = int(cfg["patterns"]) * shards
    devices = ([torch.device(f"cuda:{i}") for i in range(shards)]
               if device.type == "cuda" else [device] * shards)

    from examl_tpu_torch import obs
    from phylobench import gen, mixes
    from phylobench.devtrace import DeviceTrace

    marks = [("imports", time.perf_counter())]
    inputs = gen.make_inputs(cfg, seed, device)
    marks.append(("inputs", time.perf_counter()))
    inst, tree = build(inputs, device, clv_dtype, devices=devices)
    marks.append(("instance", time.perf_counter()))
    if fault is not None:
        fault(inst)
    spans = mixes.Spans(trace, devices)
    drv = mixes.load_kind(mix["kind"])(inputs, inst, tree, mix, spans)
    try:
        if hasattr(drv, "start"):
            drv.start()
        drv.warm()
        mixes.sync(devices)
        # Set-up's objects leave the collector's generations, so that a
        # collection in the window scans only what the window made.
        gc.collect()
        gc.freeze()
        counted = {k: obs.counter(k) for k in mix.get("counters", [])}
        setup_s = time.perf_counter() - T_START
        marks.append(("warm-up", time.perf_counter()))
        print("phylobench: set-up " + ", ".join(
            f"{name} {t - t_prev:.2f} s" for (name, t), t_prev in
            zip(marks, [T_START] + [t for _, t in marks])), file=sys.stderr)

        done, steps = 0, 0
        dt = None
        tr_from = seconds * float(mix["trace_start"])
        tr_len = min(seconds * 0.5, float(mix["trace_seconds"]))
        tr_info = {}
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if trace and dt is None and time.perf_counter() - t0 >= tr_from:
                dt = DeviceTrace(int(cell["chips"]))
                s0, w0 = steps, done
                with dt.window():
                    t1 = time.perf_counter()
                    while time.perf_counter() - t1 < tr_len:
                        done += drv.step()
                        steps += 1
                tr_info = {"steps": steps - s0, "work": done - w0}
                continue
            done += drv.step()
            steps += 1
        mixes.sync(devices)
        wall = time.perf_counter() - t0
        counters = {k: obs.counter(k) - v for k, v in counted.items()}
        peak = (max(torch.cuda.max_memory_allocated(d)
                    for d in range(int(cell["chips"])))
                if device.type == "cuda" else 0)
    finally:
        if hasattr(drv, "close"):
            drv.close()
    if inst.shard_pool is not None:
        inst.shard_pool.close()
    del inst, tree, drv.inst, drv.tree
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    compared = [(n, v) for n, v in drv.checks(device) if n in limits]
    print(f"phylobench: reference {time.perf_counter() - t_ref:.1f} s, "
          f"window {seconds} s", file=sys.stderr)
    rows = [(name, value, limits[name]) for name, value in compared]
    correct = all(v <= lim for _, v, lim in rows)

    devinfo = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
               "count": int(cell["chips"]),
               "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": steps, "failed": 0}
    if not trace:
        metrics = {}
        for m in bench["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif workload in m.get("workloads", [workload]) and \
                    m["name"] == mix["rate_metric"]:
                metrics[m["name"]] = {
                    "value": done * float(mix["rate_scale"]) / wall,
                    "unit": m["unit"]}
        out["metrics"] = metrics
    else:
        tr = dict(dt.summary) if dt is not None else {}
        if tr:
            tr.update(tr_info)
            tr["least_s"] = tr_info["steps"] * getattr(drv, "step_least_s",
                                                       0.0)
        measure = Measure(mix["kind"], spans.total, counters,
                          tr if tr.get("busy_s") else None)
        metrics = {}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = read_metric(m["name"], measure)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        devinfo["busy_s"] = tr.get("busy_s", 0.0)
        devinfo["window_s"] = tr.get("window_s", 0.0)
        if tr.get("breakdown"):
            out["breakdown"] = tr["breakdown"]
    out["device"] = devinfo
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m phylobench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--clv-dtype", choices=("bf16",), default=None,
                    help="the program's bfloat16 CLV storage: the control "
                         "run of the lower precision, never a cell")
    args = ap.parse_args(argv)
    cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    # One process with few threads: the host's cores are shared, and
    # pools of idle BLAS and OpenMP threads only add noise to a host-bound
    # loop.
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    import torch
    torch.set_num_threads(1)
    clv = torch.bfloat16 if args.clv_dtype == "bf16" else None
    try:
        out, rows = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), clv_dtype=clv)
    except NoCard as exc:
        print(f"phylobench: {exc}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"phylobench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    card = power_limit()
    if card:
        print(f"phylobench: card {card}", file=sys.stderr)
        checks = out.pop("checks")
        out["card"] = card
        out["checks"] = checks
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
