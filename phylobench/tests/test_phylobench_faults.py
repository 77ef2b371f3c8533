"""`correct` comes out false for the lower-precision control and for the
faults each cell can have, the timed path broken underneath a run on
the CPU at a tiny size."""

import numpy as np
import pytest
import torch

from conftest import WORKLOADS, tiny
from phylobench import run
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.ops.engine import LikelihoodEngine
from examl_tpu_torch.search import batchscan, spr


def run_broken(workload, monkeypatch=None, **kw):
    out, rows = run.run_cell(workload, 4242, 0.8, False, device="cpu",
                             config=tiny(workload), **kw)
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    assert run_broken(workload)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_bf16_control_is_not_correct(workload):
    """The program's own lower precision: bfloat16 CLV storage."""
    assert not run_broken(workload, clv_dtype=torch.bfloat16)["correct"]


@pytest.mark.parametrize("workload", ["birds48.probe", "kite144.probe"])
def test_probe_faults(workload, monkeypatch):
    # A step that leaves its state unchanged: the models are never pushed.
    with monkeypatch.context() as m:
        m.setattr(PhyloInstance, "push_models", lambda self, *a, **k: None)
        assert not run_broken(workload)["correct"]

    # Half of the sites left out, the rest counted twice.
    def halve(inst):
        for eng in inst.engines.values():
            for shard in eng.shards:
                B = shard.weights.shape[0]
                shard.weights[B // 2:] = 0
                shard.weights[:B // 2] *= 2
    assert not run_broken(workload, fault=halve)["correct"]

    # An answer altered where it is produced.
    real = LikelihoodEngine.traverse_evaluate
    with monkeypatch.context() as m:
        m.setattr(LikelihoodEngine, "traverse_evaluate",
                  lambda self, *a, **k: np.asarray(real(self, *a, **k))
                  * (1 + 1e-4))
        assert not run_broken(workload)["correct"]


def test_spr_faults(monkeypatch):
    real = LikelihoodEngine.batched_scan
    last = {}

    def stale(self, plan):
        """The scan answers with the state of the call before."""
        fresh = real(self, plan)
        old = last.get("v", fresh)
        last["v"] = fresh
        return np.resize(old, fresh.shape)

    def half(self, plan):
        v = real(self, plan).copy()
        n = len(v) // 2
        if n:
            v[n:] = v[:n].mean()
        return v

    def altered(self, plan):
        v = real(self, plan).copy()
        v[len(v) // 2] *= 1 + 1e-4
        return v

    for fault in (stale, half, altered):
        with monkeypatch.context() as m:
            m.setattr(LikelihoodEngine, "batched_scan", fault)
            assert not run_broken("birds48.spr")["correct"], fault.__name__


def every_other(real):
    """`real`, with every other call passed over."""
    calls = []

    def skipping(*a, **k):
        calls.append(1)
        return real(*a, **k) if len(calls) % 2 else None
    return skipping


def test_spr_windows_left_out(monkeypatch):
    """The program passes over half of the radius windows (no plan), or
    half of the prunes (it returns before scanning): the windows that
    no plan answered are counted, and `correct` is false."""
    with monkeypatch.context() as m:
        m.setattr(batchscan, "plan_for_endpoints",
                  every_other(batchscan.plan_for_endpoints))
        out, rows = run.run_cell("birds48.spr", 4242, 0.8, False,
                                 device="cpu", config=tiny("birds48.spr"))
        assert dict((n, v) for n, v, _ in rows)["plan_mismatches"] > 0
        assert not out["correct"]
    with monkeypatch.context() as m:
        m.setattr(spr, "rearrange_batched",
                  every_other(spr.rearrange_batched))
        assert not run_broken("birds48.spr")["correct"]


def test_spr_with_no_plan_scored_is_not_correct(monkeypatch):
    monkeypatch.setattr(spr, "rearrange_batched", lambda *a, **k: False)
    out, rows = run.run_cell("birds48.spr", 4242, 0.8, False, device="cpu",
                             config=tiny("birds48.spr"))
    gaps = dict((n, v) for n, v, _ in rows)
    assert gaps["plan_mismatches"] > 0 and gaps["lnl_rel_gap"] == np.inf
    assert not out["correct"]
