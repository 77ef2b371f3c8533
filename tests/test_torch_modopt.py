"""Model optimization of the port against the JAX package (float64).

* `brent.bracket` / `minimize_vector` give JAX's results exactly (the same
  numpy code on the same vector objectives);
* a restricted (`only_states`) evaluate equals the unrestricted one, and
  refuses to run before any unrestricted evaluate;
* `mod_opt(inst, tree, 0.1, max_rounds=2)` on two synthetic DNA partitions
  (one with optimized frequencies) on both port tiers, with per-branch
  smoothing on both sides (the port's `grad_smooth=False`, the JAX
  package's EXAML_GRAD_SMOOTH=0; tests/test_torch_psr.py holds a PSR
  `mod_opt` on the default gradient route): final lnL at
  rtol 1e-9, each partition's alpha, rates and frequencies at rtol 1e-6,
  and the number of evaluations within 1% of JAX's.  Brent is a
  trajectory: here the two packages' per-partition lnLs differ by one
  ulp (4.5e-13 on 3422) at one probe, which moves one parabolic step
  by 1e-16 and the port ends with 294 evaluations against JAX's 295, at
  the same optimum (lnL within 1.4e-14, parameters within 2.5e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.io.partitions import PartitionSpec as JSpec
from examl_tpu.optimize import brent as jbrent
from examl_tpu.optimize import model_opt as jmodel_opt
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.partitions import PartitionSpec
from examl_tpu_torch.optimize import brent, model_opt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test runs: the suite runs on several
    xdist workers at once, and a full pool per worker oversubscribes the
    cores so that the many small torch ops here spin (measured: 225 s
    instead of 4 s for one mod_opt parity case on 3 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objectives():
    """Vector objectives f(x[G]) -> f[G] with minima inside, at and
    beyond the bounds."""
    c = np.array([0.3, 2.5, 7.0, -1.0])
    return [
        (lambda x: (x - c) ** 2, np.full(4, 1.0), np.full(4, 0.0),
         np.full(4, 5.0)),
        (lambda x: np.cosh(x - 1.5) + 0.1 * x, np.array([0.2, 4.0, 1.0,
                                                           3.0]),
         np.full(4, 0.02), np.full(4, 1000.0)),
        (lambda x: -np.log(x) + 0.5 * x, np.array([1.0, 0.5, 9.0, 2.0]),
         np.full(4, 1e-7), np.full(4, 1e6)),
    ]


@pytest.mark.parametrize("case", range(3))
def test_brent_matches_jax_exactly(case):
    fn, x0, lo, hi = _objectives()[case]
    for a, b in zip(brent.bracket(x0, lo, hi, fn),
                    jbrent.bracket(x0, lo, hi, fn)):
        np.testing.assert_array_equal(a, b)
    tx, tf = brent.minimize_vector(x0, lo, hi, fn, 1e-4)
    jx, jf = jbrent.minimize_vector(x0, lo, hi, fn, 1e-4)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tf, jf)


def _synthetic(ntaxa=10, nsites=600, seed=11):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in names:
        flip = rng.random(nsites) < 0.25
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    half = nsites // 2
    cols = [np.arange(0, half), np.arange(half, nsites)]
    jad = jbuild_alignment(names, seqs, [
        JSpec(f"p{g}", "DNA", "GTR", cols[g], optimize_freqs=g == 1)
        for g in range(2)])
    tad = build_alignment_data(names, seqs, [
        PartitionSpec(f"p{g}", "DNA", "GTR", cols[g],
                      optimize_freqs=g == 1) for g in range(2)])
    return jad, tad


def _counted(inst):
    """Count the instance's evaluate calls."""
    calls = [0]
    inner = inst.evaluate

    def evaluate(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    inst.evaluate = evaluate
    return calls


@pytest.fixture(scope="module")
def jax_endpoint():
    mp = pytest.MonkeyPatch()
    mp.setenv("EXAML_GRAD_SMOOTH", "0")
    try:
        jad, _ = _synthetic()
        jinst = JaxInstance(jad, dtype=jnp.float64)
        jtree = jinst.random_tree(2)
        calls = _counted(jinst)
        lnl = jmodel_opt.mod_opt(jinst, jtree, 0.1, max_rounds=2)
    finally:
        mp.undo()
    return lnl, calls[0], jinst.models


@pytest.mark.parametrize("newview", ["chunk", "whole"])
def test_mod_opt_matches_jax(jax_endpoint, newview):
    jl, jcalls, jmodels = jax_endpoint
    _, tad = _synthetic()
    tinst = PhyloInstance(tad, dtype=torch.float64, device="cpu",
                          newview=newview, grad_smooth=False)
    ttree = tinst.random_tree(2)
    l0 = tinst.evaluate(ttree, full=True)
    calls = _counted(tinst)
    tl = model_opt.mod_opt(tinst, ttree, 0.1, max_rounds=2)
    assert tl > l0 + 1.0                        # the model moved
    assert abs(calls[0] - jcalls) <= jcalls // 100
    assert tl == pytest.approx(jl, rel=1e-9)
    for tm, jm in zip(tinst.models, jmodels):
        assert tm.alpha == pytest.approx(jm.alpha, rel=1e-6)
        np.testing.assert_allclose(tm.rates, jm.rates, rtol=1e-6)
        np.testing.assert_allclose(tm.freqs, jm.freqs, rtol=1e-6)
    assert not np.allclose(tinst.models[1].freqs,
                           tad.partitions[1].empirical_freqs)


@pytest.mark.parametrize("newview", ["chunk", "whole"])
def test_only_states_evaluate_matches_unrestricted(newview):
    _, tad = _synthetic()
    tinst = PhyloInstance(tad, dtype=torch.float64, device="cpu",
                          newview=newview)
    tree = tinst.random_tree(2)
    with pytest.raises(RuntimeError, match="restricted evaluate"):
        tinst.evaluate(tree, full=True, only_states={20})
    full = tinst.evaluate(tree, full=True)
    per_part = tinst.per_partition_lnl.copy()
    assert tinst.evaluate(tree, full=True, only_states={4}) == full
    np.testing.assert_array_equal(tinst.per_partition_lnl, per_part)
    # A bucket the instance does not hold: nothing recomputed, cached lnL.
    assert tinst.evaluate(tree, full=True, only_states={20}) == full
