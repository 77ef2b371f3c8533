"""The plain reference against the program at a tiny size on the CPU,
the program in float64 (where the two agree to rounding) and in the
cell's float32."""

import numpy as np
import pytest
import torch

from conftest import tiny
from phylobench import gen, mixes, run
from phylobench.reference.likelihood import eigensystem, gamma_means


def test_eigensystem_and_gamma():
    ex, freqs = gen.lg_matrix()
    e = eigensystem(ex, freqs)
    P = (e.ev * np.exp(e.lam * 0.3)) @ e.ei
    assert np.allclose(P.sum(1), 1.0, atol=1e-12)
    assert np.allclose(freqs / freqs.sum() @ P, freqs / freqs.sum(),
                       atol=1e-12)
    g = gamma_means(0.7)
    assert g.mean() == pytest.approx(1.0, abs=1e-12)
    assert np.all(np.diff(g) > 0)


@pytest.mark.parametrize("workload,dtype,tol", [
    ("birds48.probe", torch.float64, 1e-12),
    ("kite144.probe", torch.float64, 1e-12),
    ("birds48.probe", torch.float32, 1e-5),
    ("kite144.probe", torch.float32, 1e-5)])
def test_probe_lnl_matches_the_reference(workload, dtype, tol):
    cfg = tiny(workload)
    inputs = gen.make_inputs(cfg, 123, "cpu")
    inst, tree = run.build(inputs, "cpu", dtype=dtype)
    drv = mixes.load_kind("probe")(inputs, inst, tree, {"check_samples": 3},
                            mixes.Spans(False, "cpu"))
    for _ in range(4):
        drv.step()
    gaps = dict(drv.checks("cpu"))
    assert gaps["lnl_rel_gap"] < tol


def test_spr_scores_match_the_reference_in_float64():
    cfg = tiny("birds48.spr")
    inputs = gen.make_inputs(cfg, 321, "cpu")
    inst, tree = run.build(inputs, "cpu", dtype=torch.float64)
    mix = run.load_json(run.HERE / "traffic" / "spr_lazy.json")
    drv = mixes.load_kind("spr")(inputs, inst, tree, mix, mixes.Spans(False, "cpu"))
    try:
        drv.start()
        for _ in range(len(drv.slots)):
            drv.step()
    finally:
        drv.close()
    gaps = dict(drv.checks("cpu"))
    assert gaps["plan_mismatches"] == 0
    assert gaps["lnl_rel_gap"] < 1e-10


def mesh_probe(monkeypatch=None):
    """The probe driver over a 4x1 site mesh of the CPU (a mix's
    `site_shards`): four shares of the tiny configuration."""
    cfg = tiny("birds48.probe")
    cfg["patterns"] *= 4
    inputs = gen.make_inputs(cfg, 99, "cpu")
    inst, tree = run.build(inputs, "cpu", devices=["cpu"] * 4)
    assert inst.site_shards == 4
    drv = mixes.load_kind("probe")(inputs, inst, tree, {"check_samples": 2},
                            mixes.Spans(False, ["cpu"]))
    try:
        for _ in range(3):
            drv.step()
    finally:
        inst.shard_pool.close()
    return dict(drv.checks("cpu"))["lnl_rel_gap"]


def test_site_mesh_matches_the_reference():
    assert mesh_probe() < 1e-5


def test_site_mesh_without_the_exchange_is_caught(monkeypatch):
    """Each site shard keeps its own partial sums: far off."""
    from examl_tpu_torch.parallel.sharding import ThreadSiteGroup
    monkeypatch.setattr(ThreadSiteGroup, "allreduce",
                        lambda self, a: np.asarray(a, dtype=np.float64))
    assert mesh_probe() > 1e-2
