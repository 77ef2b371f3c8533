"""The port's slice end to end on the CPU against the JAX package:
PhyloInstance -> evaluate(full=True) -> makenewz -> one smooth_tree sweep
-> evaluate, on the same inputs in both packages (float64).

Tolerances: lnL rtol 1e-10; makenewz z rtol 1e-8 (an NR iterate, whose
convergence test can stop one step apart only if two derivative sums
straddle its threshold); the smoothing endpoint rtol 1e-9; the ref49
anchor abs 2e-3 against the reference binary, as
tests/test_reference_parity.py holds the JAX package.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.io.bytefile import read_bytefile as jread_bytefile
from examl_tpu.io.partitions import PartitionSpec as JSpec
from examl_tpu.optimize import branch as jbranch
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.bytefile import read_bytefile
from examl_tpu_torch.io.partitions import PartitionSpec
from examl_tpu_torch.optimize import branch
from examl_tpu_torch.transfer import install_model_params
from tests.refmodel import install_reference_params, parse_model_file

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "ref49")
REF_LNL = -16205.671990


def _ref49_pair():
    params = parse_model_file(os.path.join(FIX, "modelFile"))
    with open(os.path.join(FIX, "TreeFile")) as f:
        newick = f.read()
    jinst = JaxInstance(jread_bytefile(os.path.join(FIX, "aln49.binary")),
                        dtype=jnp.float64)
    install_reference_params(jinst, params)
    tinst = PhyloInstance(read_bytefile(os.path.join(FIX, "aln49.binary")),
                          dtype=torch.float64, device="cpu")
    install_model_params(tinst, [(p.rates, p.freqs, p.alpha)
                                 for p in params])
    return (jinst, jinst.tree_from_newick(newick),
            tinst, tinst.tree_from_newick(newick))


def test_ref49_anchor_and_makenewz_match_jax():
    jinst, jtree, tinst, ttree = _ref49_pair()
    jl = jinst.evaluate(jtree, full=True)
    tl = tinst.evaluate(ttree, full=True)
    assert tl == pytest.approx(REF_LNL, abs=2e-3)
    assert tl == pytest.approx(jl, rel=1e-10)
    np.testing.assert_allclose(tinst.per_partition_lnl,
                               jinst.per_partition_lnl, rtol=1e-10)
    # makenewz after the full traversal reads through the wave-ordered
    # row map the chunk program installed.
    for num in (ttree.ntips + 5, 7, ttree.ntips + 30):
        jp, tp = jtree.nodep[num], ttree.nodep[num]
        jz = jinst.makenewz(jtree, jp, jp.back, list(jp.z), maxiter=30)
        tz = tinst.makenewz(ttree, tp, tp.back, list(tp.z), maxiter=30)
        np.testing.assert_allclose(tz, jz, rtol=1e-8)
        jp.z[:] = list(jz)
        tp.z[:] = list(tz)
    assert tinst.evaluate(ttree) == pytest.approx(jinst.evaluate(jtree),
                                                  rel=1e-10)


def _synthetic(ntaxa, nsites, seed, parts=1):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in names:
        flip = rng.random(nsites) < 0.2
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    bounds = np.linspace(0, nsites, parts + 1).astype(int)
    jspecs = [JSpec(f"p{g}", "DNA", "GTR", np.arange(bounds[g],
                                                     bounds[g + 1]))
              for g in range(parts)]
    tspecs = [PartitionSpec(f"p{g}", "DNA", "GTR", np.arange(bounds[g],
                                                            bounds[g + 1]))
              for g in range(parts)]
    return (jbuild_alignment(names, seqs, jspecs),
            build_alignment_data(names, seqs, tspecs))


def _pair(ntaxa, nsites, seed, parts=1, grad_smooth=True, **kw):
    jad, tad = _synthetic(ntaxa, nsites, seed, parts)
    jinst = JaxInstance(jad, dtype=jnp.float64, **kw)
    tinst = PhyloInstance(tad, dtype=torch.float64, device="cpu",
                          grad_smooth=grad_smooth, **kw)
    rng = np.random.default_rng(seed + 100)
    params = []
    for _ in range(parts):
        rates = rng.uniform(0.5, 5.0, 6)
        rates[-1] = 1.0
        params.append((rates, rng.dirichlet(np.ones(4) * 4),
                       rng.uniform(0.3, 1.5)))
    from examl_tpu.models.gtr import build_model as jbuild_model
    for gid, (rates, freqs, alpha) in enumerate(params):
        jinst.models[gid] = jbuild_model(
            jad.partitions[gid].datatype, freqs, rates=rates, alpha=alpha)
    jinst.push_models()
    install_model_params(tinst, params)
    jtree = jinst.random_tree(seed)
    ttree = tinst.random_tree(seed)
    zs = rng.uniform(0.1, 0.95, len(jtree.all_branches()))
    for (jp, _), (tp, _), z in zip(jtree.all_branches(),
                                   ttree.all_branches(), zs):
        jp.z[:] = [float(z)] * len(jp.z)
        tp.z[:] = [float(z)] * len(tp.z)
    return jinst, jtree, tinst, ttree


def test_smooth_tree_sweep_matches_jax_per_branch(monkeypatch):
    monkeypatch.setenv("EXAML_GRAD_SMOOTH", "0")
    jinst, jtree, tinst, ttree = _pair(16, 400, 3, grad_smooth=False)
    jl0 = jinst.evaluate(jtree, full=True)
    tl0 = tinst.evaluate(ttree, full=True)
    assert tl0 == pytest.approx(jl0, rel=1e-10)
    jbranch.smooth_tree(jinst, jtree, 1)
    branch.smooth_tree(tinst, ttree, 1)
    jl1 = jinst.evaluate(jtree, full=True)
    tl1 = tinst.evaluate(ttree, full=True)
    assert tl1 > tl0 + 1.0                     # the sweep optimized
    assert tl1 == pytest.approx(jl1, rel=1e-9)
    jz = [p.z[0] for p, _ in jtree.all_branches()]
    tz = [p.z[0] for p, _ in ttree.all_branches()]
    np.testing.assert_allclose(tz, jz, rtol=1e-7)


@pytest.mark.parametrize("per_partition_branches", [False, True])
def test_two_partitions_per_partition_lnl(per_partition_branches):
    jinst, jtree, tinst, ttree = _pair(
        18, 500, 4, parts=2, per_partition_branches=per_partition_branches)
    jl = jinst.evaluate(jtree, full=True)
    tl = tinst.evaluate(ttree, full=True)
    assert tl == pytest.approx(jl, rel=1e-10)
    np.testing.assert_allclose(tinst.per_partition_lnl,
                               jinst.per_partition_lnl, rtol=1e-10)
    jp, tp = jtree.nodep[20], ttree.nodep[20]
    jz = jinst.makenewz(jtree, jp, jp.back, list(jp.z), maxiter=30)
    tz = tinst.makenewz(ttree, tp, tp.back, list(tp.z), maxiter=30)
    np.testing.assert_allclose(tz, jz, rtol=1e-8)
    assert tz.shape == (2 if per_partition_branches else 1,)


def test_f32_cpu_within_budget_of_f64():
    """The main-path dtype on the CPU: f32 lnL within NUMERICS.md's f32
    budget on 49 (7.8e-5 abs against f64, with margin 1e-3)."""
    _, _, t64, tree64 = _ref49_pair()
    t32 = PhyloInstance(read_bytefile(os.path.join(FIX, "aln49.binary")),
                        dtype=torch.float32, device="cpu")
    install_model_params(t32, t64.models)
    with open(os.path.join(FIX, "TreeFile")) as f:
        tree32 = t32.tree_from_newick(f.read())
    l64 = t64.evaluate(tree64, full=True)
    l32 = t32.evaluate(tree32, full=True)
    assert abs(l32 - l64) < 1e-3


def test_entry_points_default_to_cuda():
    _, tad = _synthetic(5, 50, 0)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        PhyloInstance(tad)
