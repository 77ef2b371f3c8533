"""The port's in-memory span recorder (examl_tpu_torch/obs/trace.py) on
the CPU.

* a span tree with parents, root ids and args is recorded under a
  torch.profiler session and under `--trace-events`, and nothing (no
  span, no record_function twin) when neither is on;
* `self_time` subtracts the union of a span's children;
* a quiet thread records nothing; a full buffer counts what it drops;
* every recorded span has a profiler twin of its name whose start and
  end lie within 100 us of the recorder's stamps;
* the probe path (model set-up, full evaluate) and the batched SPR path
  record the span tree and counts of the layer boundaries, and make
  exactly the device reads they make untraced.
"""

import threading

import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.obs import trace
from tests.test_torch_cli import _inputs
from tests.test_torch_obs import _sync_counts


@pytest.fixture(autouse=True)
def _clean_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset_recorder()
    yield
    trace.finalize()
    obs.set_annotations(False)
    trace.reset_recorder()
    torch.set_num_threads(n)


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _tree_of_spans():
    with obs.span("outer", args={"k": 1}):
        with obs.device_span("mid") as sp:
            sp.note(rows=3)
            with obs.span("leaf"):
                pass
        with obs.span("leaf"):
            pass
    with obs.span("second"):
        pass


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("mode", ["profiler", "trace_events"])
def test_span_tree_is_recorded_while_traced(mode, tmp_path):
    if mode == "profiler":
        with _profiler():
            _tree_of_spans()
    else:
        trace.enable(str(tmp_path), procid=0)
        _tree_of_spans()
        trace.finalize()
    spans = trace.recorded()
    assert [s.name for s in spans] == ["outer", "mid", "leaf", "leaf",
                                       "second"]
    by = _by_name(spans)
    outer, mid, second = by["outer"][0], by["mid"][0], by["second"][0]
    inner_leaf, outer_leaf = by["leaf"]
    assert outer.parent == -1 and outer.root == outer.index
    assert mid.parent == outer.index and outer_leaf.parent == outer.index
    assert inner_leaf.parent == mid.index
    assert {s.root for s in (mid, inner_leaf, outer_leaf)} == {outer.index}
    assert second.parent == -1 and second.root == second.index
    assert outer.args == {"k": 1} and mid.args == {"rows": 3}
    assert all(s.end >= s.start > 0 for s in spans)
    assert outer.start <= mid.start and mid.end <= outer.end
    assert len({s.thread for s in spans}) == 1 and trace.dropped() == 0
    if mode == "trace_events":
        evs = trace.read_events(str(tmp_path / "trace.p0.jsonl"))
        ends = [e for e in evs if e.get("ph") == "E" and e["name"] == "mid"]
        assert ends[0]["args"] == {"rows": 3}


def test_nothing_is_recorded_or_twinned_when_untraced(monkeypatch,
                                                     tmp_path):
    twins = []
    monkeypatch.setattr(trace, "_twin",
                        lambda name: twins.append(name) or None)
    assert not torch._C._autograd._profiler_enabled()
    assert obs.span("x") is trace._NULL
    assert obs.device_span("x") is trace._NULL
    _tree_of_spans()
    assert trace.recorded() == [] and twins == []
    # Off again after a trace file was opened and closed.
    trace.enable(str(tmp_path), procid=0)
    trace.finalize()
    trace.reset_recorder()
    _tree_of_spans()
    assert trace.recorded() == [] and twins == []


def test_annotations_alone_record_spans():
    obs.set_annotations(True)
    _tree_of_spans()
    obs.set_annotations(False)
    assert len(trace.recorded()) == 5
    with obs.span("after"):
        pass
    assert len(trace.recorded()) == 5


def test_self_time_subtracts_the_union_of_children():
    S = trace.Span
    parent = S(0, "p", 100, 200, 1, -1, 0, None)
    spans = [parent,
             S(1, "a", 110, 140, 1, 0, 0, None),
             S(2, "b", 130, 150, 1, 0, 0, None),     # overlaps a
             S(3, "g", 112, 118, 1, 1, 0, None),     # a grandchild
             S(4, "c", 190, 230, 1, 0, 0, None),     # runs past the end
             S(5, "x", 160, 170, 1, -1, 5, None)]    # not a child
    assert trace.self_time(spans, parent) == 100 - 40 - 10
    assert trace.self_time(spans, spans[1]) == 30 - 6
    assert trace.self_time(spans, spans[5]) == 10
    with _profiler():
        _tree_of_spans()
    rec = trace.recorded()
    outer = rec[0]
    kids = [s for s in rec if s.parent == outer.index]
    assert trace.self_time(rec, outer) == \
        outer.duration - sum(s.duration for s in kids)


def test_quiet_thread_records_nothing():
    def quiet_work():
        obs.set_quiet(True)
        try:
            _tree_of_spans()
        finally:
            obs.set_quiet(False)

    with _profiler():
        t = threading.Thread(target=quiet_work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with obs.span("main"):
            pass
    assert [s.name for s in trace.recorded()] == ["main"]


def test_full_buffer_counts_its_drops():
    trace.reset_recorder(capacity=3)
    with _profiler():
        _tree_of_spans()
    spans = trace.recorded()
    assert [s.name for s in spans] == ["outer", "mid", "leaf"]
    assert trace.dropped() == 2
    # Spans still open when the buffer filled close normally.
    assert spans[1].parent == spans[0].index and spans[2].parent == \
        spans[1].index
    trace.reset_recorder()
    assert trace.dropped() == 0 and trace.recorded() == []


def test_every_span_has_a_profiler_twin_on_the_same_clock():
    with _profiler() as prof:
        with obs.span("warm"):
            pass
        for i in range(40):
            with obs.span(f"s{i}"):
                with obs.device_span(f"d{i}"):
                    torch.ones(8).sum()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        events.setdefault(ev.name(), []).append(ev)
    spans = [s for s in trace.recorded() if s.name != "warm"]
    assert len(spans) == 80
    for s in spans:
        (ev,) = events[s.name]
        assert abs(ev.start_ns() - s.start) < 100_000, s
        assert abs(ev.end_ns() - s.end) < 100_000, s


def _probe_and_prune(tmp_path):
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.models.gtr import with_alpha, with_rates
    from examl_tpu_torch.search.spr import SprContext, rearrange_batched
    aln, _ = _inputs(tmp_path)
    inst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                         device="cpu", batch_scan=True)
    tree = inst.random_tree(3)
    inst.evaluate(tree, full=True)

    def probe():
        for gid in range(inst.num_parts):
            m = with_alpha(inst.models[gid], 0.7 + 0.1 * gid)
            inst.set_model(gid, with_rates(m, m.rates * 1.1), push=False)
        inst.push_models()
        inst.evaluate(tree, full=True)

    def prune():
        rearrange_batched(inst, tree, SprContext(inst, do_cutoff=False),
                          tree.nodep[tree.ntips + 3], 1, 3)

    return probe, prune


def test_probe_and_spr_paths_record_their_span_tree(monkeypatch, tmp_path):
    probe, prune = _probe_and_prune(tmp_path)
    probe(), prune()                                # warm the caches
    off = {"probe": _sync_counts(monkeypatch, probe),
           "prune": _sync_counts(monkeypatch, prune)}
    trace.reset_recorder()
    with _profiler():
        on = {"probe": _sync_counts(monkeypatch, probe)}
        probe_spans = trace.recorded()
        on["prune"] = _sync_counts(monkeypatch, prune)
    assert on == off and off["probe"]
    spans = trace.recorded()
    by_index = {s.index: s for s in spans}

    def parent(s):
        return by_index[s.parent].name if s.parent >= 0 else None

    # The probe: models, then one evaluate rooted at instance:evaluate.
    names = [s.name for s in probe_spans]
    assert names.count("models:gamma_rates") == 2
    assert names.count("models:eigen") == 2
    (push,) = [s for s in probe_spans if s.name == "models:push"]
    assert push.args == {"partitions": 2}
    (stack,) = [s for s in probe_spans if s.name == "models:stack"]
    assert stack.parent == push.index and stack.args == {"partitions": 2}
    (ev,) = [s for s in probe_spans if s.name == "instance:evaluate"]
    assert ev.parent == -1 and ev.args == {"full": True, "engines": 1}
    inner = {s.name: s for s in probe_spans if s.root == ev.index}
    assert set(inner) == {"instance:evaluate", "engine:schedule",
                          "engine:trav_eval", "engine:operands",
                          "newview:chunk_apply", "engine:root",
                          "engine:upload", "engine:readback"}
    for name in ("engine:operands", "newview:chunk_apply", "engine:root",
                 "engine:readback"):
        assert parent(inner[name]) == "engine:trav_eval"
    assert parent(inner["engine:upload"]) == "engine:root"
    hits = [s.args for s in probe_spans if s.name == "engine:schedule"
            and parent(s) == "engine:trav_eval"]
    assert hits == [{"hit": 1}]
    ops = inner["engine:operands"].args
    assert ops["p_matrices"] > 0 and ops["p_bytes"] == \
        ops["p_matrices"] * 4 * 4 * 8        # f64 P, no tip products here
    # The prune: rooted at search:rearrange, a plan with its candidates,
    # then the batched scan's set-up, scan and read-back.
    (root,) = [s for s in spans if s.name == "search:rearrange"]
    tree_names = {s.name for s in spans if s.root == root.index}
    assert {"search:plan", "search:spr_batched_scan", "engine:scan_setup",
            "engine:spr_scan", "engine:readback"} <= tree_names
    plans = [s for s in spans if s.name == "search:plan"]
    assert all(parent(s) == "search:rearrange" for s in plans)
    assert sum(s.args["candidates"] for s in plans) > 0
    for s in spans:
        if s.name == "engine:scan_setup":
            assert parent(s) == "search:spr_batched_scan"
            assert set(s.args) == {"down", "up", "grew"}
        if s.name == "engine:readback" and s.root == root.index:
            assert parent(s) == "engine:spr_scan"
