"""Whole-tree gradients of the port (ops/gradient.py, the outroot kernel
forms, `LikelihoodEngine.whole_tree_gradients`, the gradient route of
`smooth_tree`) against the JAX package, float64 on the CPU.

* kernel forms: `outroot_wave` and `outroot_pass` over random inputs
  equal JAX's, GAMMA and PSR, plain and with forced rescaling (rtol
  1e-12); the port's gradient plan is JAX's without its padding;
  `newton_step` equals JAX's bit for bit;
* engine: `tree_gradients` equals JAX's on both tiers, with one and with
  two branch slots (d1, d2 rtol 1e-9 of the largest entry); 2n-3 edges,
  edge 0 the root edge; d1 matches central finite differences of the
  port's own lnL for GAMMA, -M and PSR (as tests/test_gradients.py holds
  the JAX package);
* route: `gradient_smooth_tree` equals the JAX package's default route
  from one newick text (endpoint lnL rel 1e-9, every branch rtol 1e-6,
  the same sweep count); gradient `tree_evaluate` reaches the per-branch
  endpoint from a common smoothed start (abs 1e-4); `grad_smooth=False`,
  `local_smooth` and `region_smooth` run no gradient pass; a 2,000-taxon
  caterpillar builds its gradient schedule and descends without a
  RecursionError;
* search: `compute_big_rapid` on the pinned 8-taxon case, both packages
  on their default gradient route, ends on JAX's topology with JAX's
  iteration counts.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu import datatypes as jdt
from examl_tpu import obs
from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.models.gtr import build_model as jbuild_model
from examl_tpu.ops import gradient as jgradient
from examl_tpu.ops import kernels as jk
from examl_tpu.ops.engine import stack_models as jstack
from examl_tpu.optimize import branch as jbranch
from examl_tpu.search import raxml_search as jsearch
from examl_tpu.search import snapshots as jsnap
from examl_tpu.tree.topology import Tree as JTree
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.ops import engine, gradient
from examl_tpu_torch.ops import kernels as tk
from examl_tpu_torch.optimize import branch
from examl_tpu_torch.search import raxml_search, snapshots
from examl_tpu_torch.transfer import install_psr_state, state_from_numpy
from examl_tpu_torch.tree.topology import Tree

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    """Both packages on their default gradient route (the JAX package's
    EXAML_GRAD_SMOOTH unset), the JAX search on the sequential SPR arm
    the port has, and one torch intra-op thread (the suite runs on several
    xdist workers at once)."""
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    monkeypatch.setenv("EXAML_BATCH_SCAN", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(ntaxa, nsites, seed=42, mut=0.15):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < mut
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _specs(nsites, parts, module):
    bounds = np.linspace(0, nsites, parts + 1).astype(int)
    return [module.PartitionSpec(f"p{g}", "DNA", "GTR",
                                 np.arange(bounds[g], bounds[g + 1]))
            for g in range(parts)]


def _pair(ntaxa=12, nsites=300, seed=42, parts=1, tree_seed=3,
          newview="chunk", psr=False, **kw):
    """(JAX instance, JAX tree, port instance, port tree) on one alignment
    and one newick text, with random GTR models (GAMMA) or random per-site
    rate categories (PSR) installed identically in both."""
    from examl_tpu.io import partitions as jparts
    from examl_tpu_torch.io import partitions as tparts
    names, seqs = _sequences(ntaxa, nsites, seed)
    model = dict(rate_model="PSR") if psr else {}
    jinst = JaxInstance(jbuild_alignment(names, seqs,
                                         _specs(nsites, parts, jparts)),
                        dtype=jnp.float64, **model, **kw)
    tinst = PhyloInstance(build_alignment_data(names, seqs,
                                               _specs(nsites, parts, tparts)),
                          dtype=torch.float64, device="cpu", newview=newview,
                          **model, **kw)
    rng = np.random.default_rng(seed + 1)
    for gid, part in enumerate(jinst.alignment.partitions):
        rates = rng.uniform(0.5, 4.0, 6)
        rates[-1] = 1.0
        jinst.models[gid] = jbuild_model(
            part.datatype, rng.dirichlet(np.ones(4) * 5), rates=rates,
            alpha=rng.uniform(0.4, 1.5), ncat=jinst.ncat)
    jinst.push_models()
    from examl_tpu_torch.transfer import install_model_params
    install_model_params(tinst, [(m.rates, m.freqs, m.alpha)
                                 for m in jinst.models])
    if psr:
        for gid, part in enumerate(jinst.alignment.partitions):
            jinst.per_site_rates[gid] = np.array([0.3, 1.0, 2.5])
            jinst.rate_category[gid] = rng.integers(
                0, 3, part.width).astype(np.int32)
        jinst.push_site_rates()
        install_psr_state(tinst, jinst.patrat, jinst.rate_category,
                          jinst.per_site_rates)
    newick = jinst.random_tree(seed=tree_seed).to_newick(names)
    return (jinst, jinst.tree_from_newick(newick), tinst,
            tinst.tree_from_newick(newick))


# -- kernel forms ------------------------------------------------------------


def _outroot_inputs(psr: bool, rescale: bool, seed=11, ntips=12, B=2,
                    lane=128):
    """Random models, tips, post-order arena and outroot arena, with the
    pre-order schedule of a random tree from the JAX package's own
    GradStructure (wave cap 4, so waves split over several steps)."""
    rng = np.random.default_rng(seed)
    R = 1 if psr else 4
    models = []
    for _ in range(2):
        rates = rng.uniform(0.3, 6.0, 6)
        rates[-1] = 1.0
        models.append(jbuild_model(jdt.DNA, rng.dirichlet(np.ones(4) * 5),
                                   rates=rates, alpha=rng.uniform(0.2, 1.5),
                                   ncat=R))
    jm = jstack(models, [0, 0], jnp.float64, psr=psr)
    codes = rng.choice([1, 2, 4, 8, 15, 5, 10], (ntips, B, lane)).astype(
        np.uint8)
    table = jdt.DNA.tip_indicator_table()
    block_part = np.array([0, 1], np.int32)
    arrays = {k: np.asarray(getattr(jm, k)) for k in jm._fields}
    arrays.update(codes=codes, table=table, block_part=block_part,
                  weights=np.ones((B, lane)))
    tm, tt, tbp, _ = state_from_numpy(arrays, CPU)
    mag = 2.0 ** -200 if rescale else 1.0
    clv = rng.uniform(0.05, 1.0, (ntips - 1, B, lane, R, 4)) * mag
    out = rng.uniform(0.05, 1.0, (2 * ntips - 1, B, lane, R, 4)) * mag
    scaler = np.zeros((ntips - 1, B, lane), np.int32)
    sr = rng.uniform(0.1, 3.0, (B, lane, 1)) if psr else None
    tree = JTree.random([f"t{i}" for i in range(ntips)], seed, 1)
    for i, (p, _) in enumerate(tree.all_branches()):
        p.z[:] = [0.2 + 0.03 * i]
    p = tree.centroid_branch()
    flat = tree.flat_full_traversal(p)
    gs = jgradient.build_structure(flat, 4)
    row_map = np.full(2 * ntips - 1, -1, np.int64)
    row_map[ntips + 1:] = np.arange(ntips - 2)
    pre, *_ = jgradient.grad_arrays(gs, flat, row_map, 1, p.z)
    return dict(jm=jm, jt=jk.TipState(codes=jnp.asarray(codes),
                                      table=jnp.asarray(table)),
                tm=tm, tt=tt, bp=block_part, tbp=tbp, clv=clv, out=out,
                scaler=scaler, sr=sr, pre=pre, ntips=ntips, gs=gs)


@pytest.mark.parametrize("psr", [False, True], ids=["gamma", "psr"])
@pytest.mark.parametrize("rescale", [False, True], ids=["plain", "rescale"])
def test_outroot_pass_matches_jax(psr, rescale):
    d = _outroot_inputs(psr, rescale)
    pre = d["pre"]
    jtv = jk.OutrootTraversal(*(jnp.asarray(a) for a in pre))
    ref = np.asarray(jk.outroot_pass(
        d["jm"], jnp.asarray(d["bp"]), d["jt"], jnp.asarray(d["clv"]),
        jnp.asarray(d["scaler"]), jnp.asarray(d["out"]), jtv, 256,
        d["ntips"], None if d["sr"] is None else jnp.asarray(d["sr"])))
    ttv = tk.OutrootTraversal(*(torch.as_tensor(np.asarray(a)).long()
                                for a in pre[:5]),
                              *(torch.as_tensor(np.asarray(a))
                                for a in pre[5:]))
    got = tk.outroot_pass(
        d["tm"], d["tbp"], d["tt"], torch.as_tensor(d["clv"]),
        torch.as_tensor(d["scaler"]), torch.tensor(d["out"]), ttv, 256,
        d["ntips"], None if d["sr"] is None else torch.as_tensor(d["sr"]))
    real = slice(0, 2 * d["ntips"] - 2)          # scratch row excluded
    np.testing.assert_allclose(got.numpy()[real], ref[real], rtol=1e-12,
                               atol=0)
    written = np.concatenate([np.asarray(pre[1]), np.asarray(pre[2])])
    assert not np.array_equal(got.numpy()[written], d["out"][written])


@pytest.mark.parametrize("psr", [False, True], ids=["gamma", "psr"])
def test_outroot_wave_matches_jax(psr):
    """One wave's sibling combine, on magnitudes that straddle the rescale
    threshold (2^-256 for f64)."""
    d = _outroot_inputs(psr, rescale=False)
    rng = np.random.default_rng(4)
    W, R = 5, 1 if psr else 4
    shape = (W,) + d["clv"].shape[1:4] + (4,)
    mag = 2.0 ** rng.uniform(-136, -120, (3, W) + shape[1:3] + (1, 1))
    xu, xl, xr = rng.uniform(0.0, 1.0, (3,) + shape) * mag
    zu, zl, zr = rng.uniform(0.05, 0.95, (3, W, 1))
    jsr = None if d["sr"] is None else jnp.asarray(d["sr"])
    tsr = None if d["sr"] is None else torch.as_tensor(d["sr"])
    ref = jk.outroot_wave(d["jm"], jnp.asarray(d["bp"]), *(
        jnp.asarray(a) for a in (xu, xl, xr, zu, zl, zr)), 256, jsr)
    got = tk.outroot_wave(d["tm"], d["tbp"], *(
        torch.as_tensor(a) for a in (xu, xl, xr, zu, zl, zr)), 256, tsr)
    assert R == shape[3]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=0)


def test_grad_structure_matches_jax_without_padding():
    """The port's plan is JAX's with the bucket padding of the step count
    and the edge chunks dropped: the same steps, rows, gather indices,
    branch vectors and edge table."""
    d = _outroot_inputs(False, False, seed=5, ntips=19)
    jgs = d["gs"]
    ntips = d["ntips"]
    names = [f"t{i}" for i in range(ntips)]
    tree = Tree.random(names, 5, 1)
    for i, (p, _) in enumerate(tree.all_branches()):
        p.z[:] = [0.2 + 0.03 * i]
    p = tree.centroid_branch()
    flat = tree.flat_full_traversal(p)
    gs = gradient.build_structure(flat, 4)
    row_map = np.full(2 * ntips - 1, -1, np.int64)
    row_map[ntips + 1:] = np.arange(ntips - 2)
    jrow_map = row_map.copy()
    jflat = JTree.random(names, 5, 1)
    for i, (q, _) in enumerate(jflat.all_branches()):
        q.z[:] = [0.2 + 0.03 * i]
    jflat = jflat.flat_full_traversal(jflat.centroid_branch())
    jgs = jgradient.build_structure(jflat, 4)
    jpre, jex, jey, jez = jgradient.grad_arrays(jgs, jflat, jrow_map, 1,
                                                p.z)
    pre, ex, ey, ez = gradient.grad_arrays(gs, flat, row_map, 1, p.z)
    L = gs.n_steps
    assert L <= jgs.n_steps and gs.roots == jgs.roots
    assert not jgs.pk_pad[:L].all(axis=1).any()
    assert jgs.pk_pad[L:].all()
    for a, b in zip(pre, jpre):
        np.testing.assert_array_equal(a, np.asarray(b)[:L])
    E = gs.n_edges
    assert E == jgs.n_edges == 2 * ntips - 3
    np.testing.assert_array_equal(ex, jex.reshape(-1)[:E])
    np.testing.assert_array_equal(ey, jey.reshape(-1)[:E])
    np.testing.assert_array_equal(ez, jez.reshape(-1, 1)[:E])


def test_newton_step_matches_jax_bitwise():
    rng = np.random.default_rng(9)
    z = rng.uniform(1e-6, 1.0, (400, 2))
    d1 = rng.normal(0.0, 50.0, (400, 2))
    d2 = rng.normal(-20.0, 30.0, (400, 2))
    d1[:5] = 0.0
    d2[5:10] = 0.0
    got = gradient.newton_step(z, d1, d2)
    ref = jgradient.newton_step(z, d1, d2)
    np.testing.assert_array_equal(got, ref)


# -- engine ------------------------------------------------------------------


@pytest.mark.parametrize("newview", ["chunk", "whole"])
@pytest.mark.parametrize("slots", [1, 2], ids=["C1", "M_C2"])
def test_whole_tree_gradients_match_jax(newview, slots):
    jinst, jtree, tinst, ttree = _pair(
        parts=2, newview=newview, per_partition_branches=slots == 2)
    jinst.evaluate(jtree, full=True)
    tinst.evaluate(ttree, full=True)
    passes = engine.GRAD_PASSES
    jslots, jd1, jd2 = jbranch.tree_gradients(jinst, jtree)
    tslots, td1, td2 = branch.tree_gradients(tinst, ttree)
    assert engine.GRAD_PASSES == passes + 1
    assert td1.shape == jd1.shape == (2 * 12 - 3, slots)
    assert [s.number for s in tslots] == [s.number for s in jslots]
    assert tslots[0] is ttree.centroid_branch()
    assert len({id(s.z) for s in tslots}) == len(tslots)
    np.testing.assert_allclose(td1, jd1, rtol=0,
                               atol=1e-9 * np.abs(jd1).max())
    np.testing.assert_allclose(td2, jd2, rtol=0,
                               atol=1e-9 * np.abs(jd2).max())


def _fd_check(inst, tree, edge_picks=(0, 3, -1), h=1e-6, rtol=5e-5):
    """Central finite differences of the port's lnL against its analytic
    d1, per branch slot (tests/test_gradients.py's check)."""
    from examl_tpu_torch.utils import z_slots
    inst.evaluate(tree, full=True)
    slots, d1, d2 = branch.tree_gradients(inst, tree)
    C = inst.num_branch_slots
    E = len(slots)
    for k in [p % E for p in edge_picks]:
        s = slots[k]
        z0 = list(s.z)
        for c in range(C):
            lz = float(np.log(z_slots(z0, C)[c]))
            zs = list(z0)
            zs[c if len(z0) == C else 0] = float(np.exp(lz + h))
            s.z[:] = zs
            lp = inst.evaluate(tree, full=True)
            zs[c if len(z0) == C else 0] = float(np.exp(lz - h))
            s.z[:] = zs
            lm = inst.evaluate(tree, full=True)
            s.z[:] = z0
            fd = (lp - lm) / (2 * h)
            assert float(d1[k, c]) == pytest.approx(fd, rel=rtol, abs=1e-3)
    assert np.isfinite(d1).all() and np.isfinite(d2).all()


@pytest.mark.parametrize("case", ["gamma", "M", "psr"])
def test_gradients_match_finite_differences(case):
    _, _, tinst, ttree = _pair(
        ntaxa=10, nsites=200, parts=2 if case == "M" else 1,
        per_partition_branches=case == "M", psr=case == "psr")
    _fd_check(tinst, ttree, edge_picks=(0, 2) if case == "M" else
              (0, 3, -1))


# -- the smoothing route -----------------------------------------------------


def test_gradient_smooth_tree_matches_jax_default_route():
    jinst, jtree, tinst, ttree = _pair(ntaxa=14, nsites=300, tree_seed=6)
    jinst.evaluate(jtree, full=True)
    tinst.evaluate(ttree, full=True)
    s0 = obs.counter("optimize.grad_smooth_sweeps")
    t0 = branch.GRAD_SWEEPS
    jbranch.smooth_tree(jinst, jtree, 8)
    branch.smooth_tree(tinst, ttree, 8)
    jsweeps = obs.counter("optimize.grad_smooth_sweeps") - s0
    assert jsweeps > 1
    assert branch.GRAD_SWEEPS - t0 == jsweeps
    jl = jinst.evaluate(jtree, full=True)
    tl = tinst.evaluate(ttree, full=True)
    assert tl == pytest.approx(jl, rel=1e-9)
    jz = [p.z[0] for p, _ in jtree.all_branches()]
    tz = [p.z[0] for p, _ in ttree.all_branches()]
    np.testing.assert_allclose(tz, jz, rtol=1e-6)


def test_gradient_tree_evaluate_reaches_per_branch_endpoint():
    """From a common smoothed start both routes land on the same optimum
    (tests/test_gradients.py's contract for the JAX package)."""
    names, seqs = _sequences(16, 400, seed=3)
    data = build_alignment_data(names, seqs)
    inst0 = PhyloInstance(data, dtype=torch.float64, device="cpu",
                          grad_smooth=False)
    t0 = inst0.random_tree(seed=7)
    branch.tree_evaluate(inst0, t0)
    newick = t0.to_newick(names)
    out = {}
    for grad in (True, False):
        inst = PhyloInstance(data, dtype=torch.float64, device="cpu",
                             grad_smooth=grad)
        tree = inst.tree_from_newick(newick)
        inst.evaluate(tree, full=True)
        passes = engine.GRAD_PASSES
        out[grad] = (branch.tree_evaluate(inst, tree),
                     engine.GRAD_PASSES - passes)
    assert out[True][0] == pytest.approx(out[False][0], abs=1e-4)
    assert out[True][1] > 0 and out[False][1] == 0


def test_local_and_region_smooth_run_no_gradient_pass():
    _, _, tinst, ttree = _pair(ntaxa=10, nsites=150)
    tinst.evaluate(ttree, full=True)
    passes = engine.GRAD_PASSES
    p = ttree.centroid_branch()
    p = p if not ttree.is_tip(p.number) else p.back
    assert branch.local_smooth(tinst, ttree, p, 2)
    assert branch.region_smooth(tinst, ttree, p, 2, 2)
    assert engine.GRAD_PASSES == passes


def _caterpillar_newick(n):
    out = "(t0,t1)"
    for i in range(2, n):
        out = f"({out},t{i})"
    return out + ";"


def test_deep_caterpillar_host_schedule_no_recursion_error():
    """A 2,000-taxon caterpillar: the gradient plan, its per-pass arrays,
    the edge slots and the per-branch descent are host work only (no
    likelihood), and none of it recurses per node."""
    n = 2000
    names = [f"t{i}" for i in range(n)]
    tree = Tree.from_newick(_caterpillar_newick(n), names, 1)
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(min(limit, 1000))
    try:
        p = tree.centroid_branch()
        flat = tree.flat_full_traversal(p)
        gs = gradient.build_structure(flat, 8)
        row_map = np.full(2 * n - 1, -1, np.int64)
        row_map[n + 1:] = np.arange(n - 2)
        pre, ex, ey, ez = gradient.grad_arrays(gs, flat, row_map, 1, p.z)
        slots = branch._edge_slots(tree, flat, p)

        class _Stub:
            num_branch_slots = 1
            partition_smoothed = np.ones(1, dtype=bool)
            partition_converged = np.zeros(1, dtype=bool)
            updates = views = 0

            def makenewz(self, tree, p, q, z0, maxiter=1,
                         mask_converged=False):
                self.updates += 1
                return np.asarray(z0, dtype=np.float64)

            def new_view(self, tree, slot):
                self.views += 1

        stub = _Stub()
        branch.smooth_subtree(stub, tree, tree.start.back)
    finally:
        sys.setrecursionlimit(limit)
    assert gs.n_edges == len(slots) == ex.shape[0] == 2 * n - 3
    assert len({id(s.z) for s in slots}) == len(slots)
    assert pre[0].shape[0] == gs.n_steps >= n // 2 - 1
    assert stub.updates == 2 * n - 3 and stub.views == n - 2


def test_search_on_gradient_route_ends_on_jax_topology():
    """compute_big_rapid on tests/test_torch_search.py's pinned 8-taxon
    case, both packages on their default (gradient) smoothing route."""
    names, seqs = _sequences(8, 150)
    jinst = JaxInstance(jbuild_alignment(names, seqs), dtype=jnp.float64)
    newick = jinst.random_tree(seed=7).to_newick(names)
    jtree = jinst.tree_from_newick(newick)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu")
    ttree = tinst.tree_from_newick(newick)
    opts = dict(initial_set=True, initial=5)
    jres = jsearch.compute_big_rapid(jinst, jtree,
                                     jsearch.SearchOptions(**opts))
    t0 = tinst.evaluate(ttree, full=True)
    passes = engine.GRAD_PASSES
    tres = raxml_search.compute_big_rapid(tinst, ttree,
                                          raxml_search.SearchOptions(**opts))
    assert engine.GRAD_PASSES > passes
    assert (tres.fast_iterations, tres.thorough_iterations) == \
        (jres.fast_iterations, jres.thorough_iterations)
    assert snapshots.topology_key(ttree) == jsnap.topology_key(jtree)
    assert tres.likelihood > t0
    assert tres.likelihood == pytest.approx(jres.likelihood, rel=1e-9)
