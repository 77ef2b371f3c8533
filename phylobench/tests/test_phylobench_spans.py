"""The readers of the program's spans (`phylobench/spans.py` and the
`program_span` metrics): their values on hand-made spans, None without a
device trace or without the program's recorder, and, on the card
(marked `cuda`), one traced run of each cell reporting them."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, WORKLOADS
from examl_tpu_torch.obs import trace
from phylobench import run

S = trace.Span
MS = 1_000_000


def _probe(i: int, t: int) -> list:
    """The spans of probe i from t (ns): two gamma shapes, the push with
    its stack, and an evaluate of 10 ms with an upload of 1 ms and a
    read-back of 2 ms."""
    b = 10 * i
    return [S(b, "models:gamma_rates", t, t + 1 * MS, 1, -1, b, None),
            S(b + 1, "models:gamma_rates", t + 1 * MS, t + 2 * MS, 1, -1,
              b + 1, None),
            S(b + 2, "models:push", t + 2 * MS, t + 5 * MS, 1, -1, b + 2,
              {"partitions": 2}),
            S(b + 3, "models:stack", t + 3 * MS, t + 4 * MS, 1, b + 2, b + 2,
              {"partitions": 2}),
            S(b + 4, "instance:evaluate", t + 5 * MS, t + 15 * MS, 1, -1,
              b + 4, {"full": True, "engines": 1}),
            S(b + 5, "engine:trav_eval", t + 6 * MS, t + 14 * MS, 1, b + 4,
              b + 4, None),
            S(b + 6, "engine:operands", t + 6 * MS, t + 7 * MS, 1, b + 5,
              b + 4, {"p_matrices": 8, "p_bytes": 3_000_000}),
            S(b + 7, "engine:readback", t + 11 * MS, t + 13 * MS, 1, b + 5,
              b + 4, None),
            S(b + 8, "engine:root", t + 8 * MS, t + 11 * MS, 1, b + 5,
              b + 4, None),
            S(b + 9, "engine:upload", t + 8 * MS, t + 9 * MS, 1, b + 8,
              b + 4, None)]


def _prune(i: int, t: int) -> list:
    """A prune of 20 ms with a Newton step of 1 ms and two scans of 6
    ms, one holding a nested scan span that must not count twice."""
    b = 10 * i
    return [S(b, "search:rearrange", t, t + 20 * MS, 1, -1, b, None),
            S(b + 6, "engine:newton", t, t + 1 * MS, 1, b, b, None),
            S(b + 1, "search:plan", t + 1 * MS, t + 2 * MS, 1, b, b,
              {"candidates": 30}),
            S(b + 2, "search:spr_batched_scan", t + 2 * MS, t + 9 * MS, 1,
              b, b, {"candidates": 30}),
            S(b + 3, "engine:spr_scan", t + 3 * MS, t + 9 * MS, 1, b + 2, b,
              None),
            S(b + 4, "engine:spr_scan", t + 4 * MS, t + 5 * MS, 1, b + 3, b,
              None),
            S(b + 5, "engine:spr_scan", t + 12 * MS, t + 18 * MS, 1, b, b,
              None)]


def _measure(kind, spans, monkeypatch, steps, work, window_s=1.0):
    monkeypatch.setattr(trace, "recorded", lambda: spans)
    tr = {"steps": steps, "work": work, "window_s": window_s,
          "busy_s": 0.5}
    return run.Measure(kind, {}, {}, tr)


NEW = ["host_ms_per_probe", "model_host_ms_per_probe",
       "p_build_mb_per_probe", "search_host_ms_per_insertion"]


def test_probe_readers_on_hand_made_spans(monkeypatch):
    t0 = 10 ** 18
    # A span of an earlier window, far before this one, stays out.
    old = [S(900, "instance:evaluate", t0 - 10 ** 10, t0 - 10 ** 10 + MS,
             1, -1, 900, None)]
    spans = old + _probe(0, t0) + _probe(1, t0 + 20 * MS) + \
        _probe(2, t0 + 40 * MS)
    m = _measure("probe", spans, monkeypatch, steps=3, work=3)
    assert run.read_metric("host_ms_per_probe", m) == pytest.approx(7.0)
    assert run.read_metric("model_host_ms_per_probe", m) == \
        pytest.approx(5.0)
    assert run.read_metric("p_build_mb_per_probe", m) == pytest.approx(3.0)
    assert run.read_metric("search_host_ms_per_insertion", m) is None


def test_search_reader_on_hand_made_spans(monkeypatch):
    t0 = 10 ** 18
    spans = _prune(0, t0) + _prune(1, t0 + 30 * MS)
    m = _measure("spr", spans, monkeypatch, steps=2, work=40)
    # Each prune: 20 ms less its Newton step and its two outermost scans
    # (1 + 6 + 6 ms).
    assert run.read_metric("search_host_ms_per_insertion", m) == \
        pytest.approx(2 * 7.0 / 40)
    for name in NEW[:3]:
        assert run.read_metric(name, m) is None


def test_readers_give_none_without_a_device_trace(monkeypatch):
    spans = _probe(0, 10 ** 18) + _prune(1, 10 ** 18 + 30 * MS)
    monkeypatch.setattr(trace, "recorded", lambda: spans)
    for kind in ("probe", "spr"):
        m = run.Measure(kind, {}, {}, None)
        for name in NEW:
            assert run.read_metric(name, m) is None


def test_readers_give_none_without_the_recorder(monkeypatch):
    """A program without the recorder (an older checkout) or one that
    recorded nothing: the metric is left out, nothing raises."""
    spans = _probe(0, 10 ** 18)
    m = _measure("probe", spans, monkeypatch, steps=1, work=1)
    monkeypatch.delattr(trace, "recorded")
    for name in NEW:
        assert run.read_metric(name, m) is None
    monkeypatch.setattr(trace, "recorded", lambda: [], raising=False)
    for name in NEW:
        assert run.read_metric(name, m) is None


WINDOW_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from phylobench import mixes, run
pushes = []
real = mixes.Spans.run


def timed(self, name, fn, *args):
    t = time.perf_counter()
    out = real(self, name, fn, *args)
    if name == "push" and torch._C._autograd._profiler_enabled():
        pushes.append(time.perf_counter() - t)
    return out


mixes.Spans.run = timed
run.cache_dirs()
out, _ = run.run_cell({workload!r}, 2147484011, 8.0, True)
out["window_push_ms"] = 1e3 * sum(pushes) / len(pushes) if pushes else None
print(json.dumps(out))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_cell_reports_the_program_spans(card, workload):
    """A traced run reports the cell's `program_span` metrics.  The
    program's model spans lie inside the benchmark's `push` span, so
    within the traced window their sum a probe is at most the push's
    (`push_ms_per_probe` itself averages every probe of the run, warm-up
    included, and kite's push varies by a fifth from one stretch of a
    run to another)."""
    p = subprocess.run([sys.executable, "-c",
                        WINDOW_RUN.format(root=str(ROOT), workload=workload)],
                       cwd=ROOT, capture_output=True, text=True, timeout=420)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    got = out["metrics"]
    bench = run.load_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in bench["per_layer"] if m["name"] in NEW
            and workload in m["workloads"]}
    assert want and want <= set(got), sorted(got)
    assert all(got[n]["value"] > 0 for n in want)
    if "model_host_ms_per_probe" in want:
        assert got["model_host_ms_per_probe"]["value"] <= \
            out["window_push_ms"]
