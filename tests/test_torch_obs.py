"""The port's instruments (examl_tpu_torch/obs/) against the JAX package's
(examl_tpu/obs/), on the CPU.

* `hist` buckets, quantiles and merges, the registry's semantics
  (counters, gauges, timers with histograms, collectors, reset) and the
  `traffic` byte model and GB/s windows: equal between the packages,
  exactly for integers and at rel 1e-12 for floats, on inputs made from
  a numpy seed (the port has no regime verdict and no `time_dispatch`:
  nothing of it read them);
* the port's trace files, two ranks' ledgers and a metrics snapshot are
  read by JAX's `read_events`, `merge` and `merge_summary`, and
  `tools/run_report.py` renders them (exit 0); an unfinished span leaves
  a readable, crash-truncated trace;
* the program observatory: rows from a ptxas log, XLA's analyses counted
  missing, the table in every snapshot, host memory on the CPU;
* both CLIs on tests/test_torch_cli.py's 8-taxon alignment (`-f e`, then
  `-f d -i 5` from one newick), f64, with --metrics/--ledger/
  --trace-events: the port's lnL equals its run without the flags (rtol
  1e-10), every `search.*` / `optimize.*` counter equals JAX's, the
  `phase.*` timer names and the ledger's `phase` / `run` sequence are
  JAX's, and the traces are balanced with `engine:` and `phase:` spans;
* no added synchronization: with every instrument on, an evaluate, an NR
  iteration and a batched insertion call `Tensor.item`, `.cpu`,
  `.tolist` and `torch.cuda.synchronize` exactly as often as with every
  instrument off.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from examl_tpu.obs import hist as jhist
from examl_tpu.obs import ledger as jledger
from examl_tpu.obs import metrics as jmetrics
from examl_tpu.obs import trace as jtrace
from examl_tpu.obs import traffic as jtraffic
from examl_tpu_torch import obs
from examl_tpu_torch.obs import hist, ledger, metrics, programs, trace
from examl_tpu_torch.obs import traffic
from tests.test_torch_cli import _inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_clean_obs():
    """One torch thread (the suite runs on several workers) and no
    instrument state leaking between tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.reset()
    programs.reset()
    yield
    trace.finalize()
    ledger.reset()
    obs.reset()
    programs.reset()
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


# -- hist, registry, traffic against JAX --------------------------------------


def test_hist_buckets_quantiles_and_merges_equal_jax():
    rng = np.random.default_rng(11)
    samples = [10.0 ** rng.uniform(-8, 4.5, 500),
               rng.exponential(1e-3, 300), np.array([0.0, 1e-7, 1e5])]
    dicts = []
    for xs in samples:
        h, j = hist.Histogram(), jhist.Histogram()
        for x in xs:
            h.observe(float(x))
            j.observe(float(x))
            assert hist.bucket_index(float(x)) == jhist.bucket_index(float(x))
        assert h.to_dict() == j.to_dict() and h.count == j.count
        for q, v in h.quantiles((0.01, 0.5, 0.95, 0.99, 1.0)).items():
            assert _rel(v, j.quantiles((0.01, 0.5, 0.95, 0.99, 1.0))[q])
        dicts.append(h.to_dict())
    merged = hist.merge_bucket_dicts(*dicts)
    assert merged == jhist.merge_bucket_dicts(*dicts)
    for q in (0.5, 0.95, 0.99):
        assert _rel(hist.quantile_from_buckets(merged, q),
                    jhist.quantile_from_buckets(merged, q))
    h = hist.Histogram()
    for d in dicts:
        h.merge_dict(d)
    assert h.to_dict() == merged
    assert hist.quantile_from_buckets({}, 0.5) is None
    for i in (0, 7, 219):
        assert hist.bucket_bounds(i) == jhist.bucket_bounds(i)
        assert hist.bucket_mid(i) == jhist.bucket_mid(i)


def test_registry_semantics_equal_jax():
    rng = np.random.default_rng(5)
    regs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    ops = []
    for _ in range(400):
        k = int(rng.integers(3))
        name = f"n{int(rng.integers(6))}"
        ops.append((k, name, float(rng.exponential(0.01))))
    for reg in regs:
        for k, name, v in ops:
            (reg.inc, reg.gauge, reg.observe)[k](name, v)
        reg.inc("whole")
        with reg.timer("ctx") as t:
            pass
        assert t.elapsed >= 0
    snaps = [reg.snapshot() for reg in regs]
    assert snaps[0]["counters"].keys() == snaps[1]["counters"].keys()
    for n, v in snaps[0]["counters"].items():
        assert _rel(v, snaps[1]["counters"][n])
    assert snaps[0]["gauges"] == snaps[1]["gauges"]
    for n, t in snaps[0]["timers"].items():
        jt = snaps[1]["timers"][n]
        assert t["count"] == jt["count"]
        if n != "ctx":
            assert t["buckets"] == jt["buckets"]
            assert _rel(t["total_s"], jt["total_s"])
            assert t["min_s"] == jt["min_s"] and t["max_s"] == jt["max_s"]
            assert t["p99_s"] == jt["p99_s"]
    # Collectors: run at snapshot, unregistered on False or a raise;
    # reset clears values but keeps them.
    for reg in regs:
        calls = []

        def live():
            calls.append(1)
            reg.gauge("live", len(calls))
            return True

        reg.add_collector(live)
        reg.add_collector(lambda: False)
        reg.add_collector(lambda: 1 / 0)
        reg.snapshot()
        reg.reset()
        snap = reg.snapshot()
        assert snap["gauges"] == {"live": 2} and snap["counters"] == {}
        assert reg.snapshot_light()["gauges"] == {"live": 2}
        assert len(reg._collectors) == 1


def test_traffic_bytes_and_regimes_equal_jax():
    rng = np.random.default_rng(3)

    class E:
        def __init__(self, left, right):
            self.left, self.right = left, right

    for _ in range(40):
        n, tips = int(rng.integers(1, 500)), int(rng.integers(0, 200))
        pat, R, K = int(rng.integers(1, 10 ** 6)), int(rng.integers(1, 5)), \
            int(rng.choice([2, 4, 20]))
        it = int(rng.choice([2, 4, 8]))
        assert traffic.bytes_per_traversal_counts(n, tips, pat, R, K, it) \
            == jtraffic.bytes_per_traversal_counts(n, tips, pat, R, K, it)
        assert traffic.bytes_per_grad_pass(n, tips, 2 * n + 1, pat, R, K,
                                           it) == \
            jtraffic.bytes_per_grad_pass(n, tips, 2 * n + 1, pat, R, K, it)
        ntips = int(rng.integers(3, 60))
        ents = [E(np.int64(rng.integers(1, 2 * ntips)),
                  int(rng.integers(1, 2 * ntips))) for _ in range(n)]
        assert traffic.count_tip_children(ents, ntips) == \
            jtraffic.count_tip_children(ents, ntips)
        assert traffic.bytes_per_traversal(ents, ntips, pat, R, K, it) == \
            jtraffic.bytes_per_traversal(ents, ntips, pat, R, K, it)
    # The GB/s windows close alike; JAX's also carries its regime
    # verdict, which the port does not compute.
    wins = traffic.TrafficWindow(3, 1e9), jtraffic.TrafficWindow(3, 1e9)
    closed = 0
    for _ in range(10):
        nbytes, wall = int(rng.integers(1, 10 ** 9)), \
            float(rng.uniform(1e-4, 1e-2))
        a = wins[0].add(nbytes, wall)
        b = wins[1].add(nbytes, wall, int(rng.integers(1, 50)))
        assert (a is None) == (b is None)
        if a is not None:
            closed += 1
            assert _rel(a[0], b[0]) and a[1] == b[2]
    assert closed == 3


# -- artifacts read by the JAX package's readers ----------------------------


def _run_report(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "tools/run_report.py", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=env)


def test_trace_ledger_and_snapshot_read_by_jax(tmp_path):
    tdir, ldir = tmp_path / "trace", tmp_path / "ledger"
    # Two ranks' ledgers, written one after the other (one process).
    for rank in (1, 0):
        ledger.enable(str(ldir), proc=rank)
        obs.ledger_event("run", status="start", rank=rank)
        obs.ledger_event("phase", name="startup", status="begin")
        obs.ledger_event("phase", name="startup", status="end",
                         seconds=0.5)
        ledger.finalize()
    trace.enable(str(tdir), procid=0)
    with obs.span("phase:startup", cat="phase"):
        with obs.device_span("engine:evaluate", args={"entries": 3}):
            obs.instant("marker", args={"k": 1})
        with obs.span("engine:traverse"):
            pass
    trace.finalize()
    obs.inc("engine.dispatch_count", 3)
    obs.observe("phase.startup", 0.5)
    obs.gauge("mem.host.rss", 123)
    programs.record("newview_chunk", "k", "built", 1.5, {"registers": 96})
    snap = obs.snapshot()
    mfile = tmp_path / "m.json"
    mfile.write_text(json.dumps(snap))

    evs = jtrace.read_events(str(tdir / "trace.p0.jsonl"))
    json.loads((tdir / "trace.p0.jsonl").read_text())   # valid JSON array
    names = [(e["ph"], e["name"]) for e in evs if e["ph"] in "BEi"]
    assert names == [("B", "phase:startup"), ("B", "engine:evaluate"),
                     ("i", "marker"), ("E", "engine:evaluate"),
                     ("B", "engine:traverse"), ("E", "engine:traverse"),
                     ("E", "phase:startup")]
    summ = json.loads(open(jtrace.merge_summary(str(tdir))).read())
    assert summ["spans"]["engine:evaluate"]["count"] == 1
    assert summ == json.loads((tdir / "summary.json").read_text())
    merged = jledger.merge(str(ldir))
    events = jledger.read_events(merged)
    assert sorted(e["proc"] for e in events) == [0] * 3 + [1] * 3
    assert [e["kind"] for e in events if e["proc"] == 0] == \
        ["run", "phase", "phase"]
    assert {n for n in os.listdir(ldir)} >= {"ledger.p0.jsonl",
                                             "ledger.p1.jsonl",
                                             "ledger.merged.jsonl"}
    r = _run_report("--metrics", str(mfile), "--ledger", str(ldir))
    assert r.returncode == 0, r.stderr
    assert "engine.dispatch_count" in r.stdout or "dispatch" in r.stdout
    assert "newview_chunk" in r.stdout


def test_unfinished_span_leaves_a_truncated_readable_trace(tmp_path):
    trace.enable(str(tmp_path), procid=0)
    cm = obs.span("engine:traverse", args={"entries": 5})
    cm.__enter__()
    # A crash here: the file is never finalized, yet every event is on
    # disk and the last line is the unmatched "B".
    text = (tmp_path / "trace.p0.jsonl").read_text()
    assert not text.rstrip().endswith("]")
    evs = jtrace.read_events(str(tmp_path / "trace.p0.jsonl"))
    assert evs[-1]["ph"] == "B" and evs[-1]["name"] == "engine:traverse"
    summ = json.load(open(jtrace.merge_summary(str(tmp_path))))
    assert summ["spans"]["engine:traverse"]["unfinished"] == 1
    cm.__exit__(None, None, None)


def test_program_observatory_rows_and_memory():
    log = ("ptxas info    : Compiling entry function '_Z4flowILi4EEvv' for "
           "'sm_90a'\nptxas info    : Function properties for "
           "_Z4flowILi4EEvv\n    0 bytes stack frame, 28 bytes spill "
           "stores, 24 bytes spill loads\nptxas info    : Used 96 "
           "registers, used 1 barriers\n")
    rows = programs.record_extension("newview_chunk", "built", 2.0, log)
    assert len(rows) == 1 and rows[0]["registers"] == 96
    assert rows[0]["spill_stores"] == 28 and rows[0]["spill_loads"] == 24
    assert rows[0]["missing"] == ["cost_analysis", "memory_analysis"]
    assert programs.has_family("newview_chunk")
    snap = obs.snapshot()
    assert snap["programs"][0]["key"] == "_Z4flowILi4EEvv"
    assert snap["counters"]["program.analysis_missing.cost_analysis"] == 1
    assert snap["gauges"]["mem.host.rss"] > 0    # the CPU's memory rung
    assert programs.record_extension("x", "cached", 0.0, "")[0]["key"] == "x"


# -- both CLIs with the instruments on --------------------------------------

MODES = {"e": ["-f", "e"], "d": ["-f", "d", "-i", "5"]}


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_cli")
    return tmp, _inputs(tmp)


def _port_cli(tmp, aln, trees, mode, name, flags):
    from examl_tpu_torch.cli.main import main
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp / name
        argv = ["-s", aln, "-t", trees, "-n", "T", "-w", str(out)] + \
            MODES[mode]
        if flags:
            argv += ["--metrics", str(out / "m.json"), "--ledger",
                     str(out / "led"), "--trace-events", str(out / "tr")]
        assert main(argv, device="cpu") == 0
    finally:
        torch.set_num_threads(n)
    return out


_RUNS = {}


def _run_once(key, fn):
    if key not in _RUNS:
        _RUNS[key] = fn()
    return _RUNS[key]


def _port_run(cli_inputs, mode, flags):
    tmp, (aln, trees) = cli_inputs
    return _run_once(("port", mode, flags), lambda: _port_cli(
        tmp, aln, trees, mode, f"port_{mode}_{int(flags)}", flags))


def _jax_run(cli_inputs, mode):
    def run():
        from examl_tpu.cli.main import main as jmain
        import jax
        tmp, (aln, trees) = cli_inputs
        out = tmp / f"jax_{mode}"
        prior = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            assert jmain(["-s", aln, "-t", trees, "-n", "T", "-w", str(out),
                          "--single-device", "--metrics",
                          str(out / "m.json"), "--ledger", str(out / "led"),
                          "--trace-events", str(out / "tr")]
                         + MODES[mode]) == 0
        finally:
            jax.config.update("jax_enable_x64", prior)
        return out
    return _run_once(("jax", mode), run)


def _info_lnl(out, mode) -> float:
    text = (out / "ExaML_info.T").read_text()
    key = "Likelihood of best tree: " if mode == "d" else "Likelihood tree 1: "
    return float(text.split(key)[-1].split()[0])


@pytest.mark.parametrize("mode", ["e", "d"])
def test_cli_flags_leave_the_lnl_unchanged(cli_inputs, mode):
    with_flags = _port_run(cli_inputs, mode, True)
    plain = _port_run(cli_inputs, mode, False)
    a, b = _info_lnl(with_flags, mode), _info_lnl(plain, mode)
    assert a == pytest.approx(b, rel=1e-10)
    assert not (plain / "m.json").exists()


@pytest.mark.parametrize("mode", ["e", "d"])
def test_cli_counters_phases_and_ledger_match_jax(cli_inputs, mode):
    port = _port_run(cli_inputs, mode, True)
    jx = _jax_run(cli_inputs, mode)
    pm = json.loads((port / "m.json").read_text())
    jm = json.loads((jx / "m.json").read_text())

    def search_opt(m):
        return {k: v for k, v in m["counters"].items()
                if k.split(".")[0] in ("search", "optimize")}

    assert search_opt(pm) and search_opt(pm) == search_opt(jm)
    assert sorted(k for k in pm["timers"] if k.startswith("phase.")) == \
        sorted(k for k in jm["timers"] if k.startswith("phase."))

    def seq(out):
        evs = jledger.read_events(str(out / "led" / "ledger.merged.jsonl"))
        return [(e["kind"], e.get("name"), e.get("status")) for e in evs
                if e["kind"] in ("phase", "run")]

    assert seq(port) == seq(jx) and seq(port)[0] == ("run", None, "start")
    assert _info_lnl(port, mode) == pytest.approx(_info_lnl(jx, mode),
                                                  rel=1e-9)
    # The port's trace: balanced per (tid, name), with engine and phase
    # spans, and the summary rank 0 merged.
    evs = jtrace.read_events(str(port / "tr" / "trace.p0.jsonl"))
    depth = {}
    for e in evs:
        if e["ph"] in "BE":
            k = (e["tid"], e["name"])
            depth[k] = depth.get(k, 0) + (1 if e["ph"] == "B" else -1)
            assert depth[k] >= 0
    assert all(v == 0 for v in depth.values())
    names = {e["name"] for e in evs if e["ph"] == "B"}
    assert any(n.startswith("engine:") for n in names)
    assert any(n.startswith("phase:") for n in names)
    assert (port / "tr" / "summary.json").exists()
    assert pm["counters"]["engine.dispatch_count"] > 0
    assert pm["counters"]["engine.traffic_bytes"] > 0


def test_cli_artifacts_render_with_run_report(cli_inputs):
    port = _port_run(cli_inputs, "e", True)
    r = _run_report("--metrics", str(port / "m.json"), "--ledger",
                    str(port / "led"))
    assert r.returncode == 0, r.stderr
    assert "phase" in r.stdout


# -- no added synchronization ------------------------------------------------


def _sync_counts(monkeypatch, fn) -> dict:
    """Calls of the host-reading tensor methods and of
    torch.cuda.synchronize made by fn()."""
    counts = {}
    for owner, name in ((torch.Tensor, "item"), (torch.Tensor, "cpu"),
                        (torch.Tensor, "tolist"),
                        (torch.cuda, "synchronize")):
        orig = getattr(owner, name)

        def wrap(*a, _orig=orig, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(owner, name, wrap)
    try:
        fn()
    finally:
        monkeypatch.undo()
    return counts


def test_instruments_add_no_device_reads(monkeypatch, tmp_path):
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.search import batchscan
    from examl_tpu_torch.search.spr import SprContext, rearrange_auto
    aln, _ = _inputs(tmp_path)
    data = read_bytefile(aln)

    def work(inst, tree):
        p = tree.nodep[tree.ntips + 2]
        return {
            "evaluate": lambda: inst.evaluate(tree, full=True),
            "nr": lambda: inst.makenewz(tree, p, p.back, p.z, maxiter=1),
            "insertion": lambda: rearrange_auto(
                inst, tree, SprContext(inst, do_cutoff=False),
                tree.nodep[tree.ntips + 3], 1, 3),
        }

    def measure(on: bool) -> dict:
        obs.reset()
        if on:
            trace.enable(str(tmp_path / "tr"), procid=0)
            ledger.enable(str(tmp_path / "led"), proc=0)
            obs.set_annotations(True)
        inst = PhyloInstance(data, dtype=torch.float64, device="cpu",
                             batch_scan=True)
        tree = inst.random_tree(3)
        inst.evaluate(tree, full=True)
        out = {}
        for name, fn in work(inst, tree).items():
            fn()                                   # warm the caches
            out[name] = _sync_counts(monkeypatch, fn)
        calls0 = batchscan.SCAN_CALLS
        work(inst, tree)["insertion"]()
        assert batchscan.SCAN_CALLS > calls0      # the batched route
        if on:
            obs.set_annotations(False)
            trace.finalize()
            ledger.finalize()
        return out

    off, on = measure(False), measure(True)
    assert on == off and off["evaluate"]
    assert obs.counter("engine.dispatch_count") > 0
    assert (tmp_path / "tr" / "trace.p0.jsonl").exists()
