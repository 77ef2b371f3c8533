"""The port's SPR search against the JAX package (float64 on the CPU).

Both packages build their trees from the same newick text: the SPR slot
order follows the order in which a tree was built, so trees drawn by each
package's `random_tree` would be searched in a different order.  The JAX
side runs the sequential SPR arm with per-branch smoothing
(EXAML_BATCH_SCAN=0, EXAML_GRAD_SMOOTH=0), the port side its per-branch
route (`grad_smooth=False`); tests/test_torch_gradient.py holds the two
packages' default gradient routes together.

* snapshots: the round trip restores the likelihood; `topology_key`,
  BestList ranks and InfoList contents equal JAX's;
* `rearrange` on three fixed slots, lazy and thorough, with the cutoff
  heuristic on: `best_of_node`/`end_lh` at rtol 1e-10, the chosen prune and
  insert nodes equal, the saved branch vectors at rtol 1e-8, `lh_avg` at
  rtol 1e-9, `lh_dec` equal, the tree restored exactly;
* `local_smooth` and `region_smooth` move every branch as JAX's do
  (rtol 1e-8);
* one `tree_optimize_rapid` cycle commits JAX's topology, lnL rtol 1e-9;
* `compute_big_rapid` on the pinned 8-taxon case: JAX's iteration counts
  and final topology, lnL at rtol 1e-10 of JAX's run and at rtol 1e-8 of
  the JAX package's recorded endpoint from its own `random_tree(seed=7)`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.optimize import branch as jbranch
from examl_tpu.optimize.branch import tree_evaluate as jtree_evaluate
from examl_tpu.search import raxml_search as jsearch
from examl_tpu.search import snapshots as jsnap
from examl_tpu.search import spr as jspr
from examl_tpu.tree.topology import Tree as JTree
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.optimize import branch
from examl_tpu_torch.optimize.branch import tree_evaluate
from examl_tpu_torch.search import raxml_search, snapshots, spr
from examl_tpu_torch.tree.topology import Tree

# compute_big_rapid's endpoint in the JAX package on the pinned case,
# started from its own random_tree(seed=7) (f64 on the CPU).
JAX_PINNED_LNL = -695.5408116147864


@pytest.fixture(autouse=True)
def _reference_semantics(monkeypatch):
    """One torch intra-op thread (the suite runs on several xdist workers
    at once and a full pool per worker oversubscribes the cores), and the
    JAX package on the port's semantics."""
    monkeypatch.setenv("EXAML_GRAD_SMOOTH", "0")
    monkeypatch.setenv("EXAML_BATCH_SCAN", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _correlated_dna(ntaxa, nsites, seed=42, mut=0.15):
    """tests/test_search.py's alignment, as names and sequences."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < mut
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _pair(ntaxa, nsites, tree_seed, seed=42):
    """(JAX instance, JAX tree, port instance, port tree) on the same
    alignment and the same newick (JAX's random tree)."""
    names, seqs = _correlated_dna(ntaxa, nsites, seed)
    jinst = JaxInstance(jbuild_alignment(names, seqs), dtype=jnp.float64)
    newick = jinst.random_tree(seed=tree_seed).to_newick(names)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu",
                          grad_smooth=False)
    return (jinst, jinst.tree_from_newick(newick), tinst,
            tinst.tree_from_newick(newick))


def _tree_pair(names, seed):
    """The same random topology as a JAX tree and a port tree."""
    newick = JTree.random(names, seed, 1).to_newick(names)
    return (JTree.from_newick(newick, names, 1),
            Tree.from_newick(newick, names, 1))


def _edges(snap):
    return sorted((min(u, v), max(u, v), z) for u, v, z in snap.edges)


def test_snapshot_roundtrip_and_topology_key():
    names, seqs = _correlated_dna(10, 120)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu")
    jinst = JaxInstance(jbuild_alignment(names, seqs), dtype=jnp.float64)
    for seed in (1, 3, 9):
        newick = jinst.random_tree(seed=seed).to_newick(names)
        jkey = jsnap.topology_key(jinst.tree_from_newick(newick))
        assert snapshots.topology_key(tinst.tree_from_newick(newick)) == jkey
    tree = tinst.tree_from_newick(newick)
    lnl = tinst.evaluate(tree, full=True)
    snap = snapshots.TreeSnapshot.capture(tree, lnl)
    # Through the checkpoint's dict form, then onto another topology.
    snap = snapshots.TreeSnapshot.from_dict(snap.to_dict())
    other = snapshots.TreeSnapshot.capture(tinst.random_tree(seed=2), 0.0)
    other.restore_into(tree)
    assert tinst.evaluate(tree, full=True) != pytest.approx(lnl)
    snap.restore_into(tree)
    assert snapshots.topology_key(tree) == jkey
    assert tinst.evaluate(tree, full=True) == pytest.approx(lnl, rel=1e-12)


def test_bestlist_and_infolist_match_jax():
    names, _ = _correlated_dna(9, 10)
    trees = {s: _tree_pair(names, s) for s in (1, 2, 3, 4)}
    saves = [(1, -100.0), (1, -200.0), (1, -50.0), (2, -75.0), (3, -60.0),
             (4, -40.0), (2, -30.0), (3, -90.0), (4, -10.0), (1, -45.0)]
    tbl, jbl = snapshots.BestList(3), jsnap.BestList(3)
    for seed, lnl in saves:
        jt, tt = trees[seed]
        assert tbl.save(tt, lnl) == jbl.save(jt, lnl)
        assert tbl.nvalid == jbl.nvalid
        assert [e.likelihood for e in tbl.entries] == \
            [e.likelihood for e in jbl.entries]
        assert [e.key for e in tbl.entries] == [e.key for e in jbl.entries]
    til, jil = snapshots.InfoList(4), jsnap.InfoList(4)
    for i, lnl in enumerate([-10.0, -5.0, -20.0, -1.0, -30.0, -3.0, -2.0]):
        til.insert(i, lnl)
        jil.insert(i, lnl)
        assert til.nodes == jil.nodes and til.lnls == jil.lnls
        assert til.valid == jil.valid
        assert til.active_nodes() == jil.active_nodes()


@pytest.fixture(scope="module")
def smoothed_pair():
    """A 10-taxon pair whose branches the JAX package smoothed; the port
    tree is built from the JAX tree's newick, so both start equal."""
    mp = pytest.MonkeyPatch()
    mp.setenv("EXAML_GRAD_SMOOTH", "0")
    try:
        jinst, jtree, tinst, _ = _pair(10, 150, tree_seed=5)
        jtree_evaluate(jinst, jtree, 1.0)
        names = jinst.alignment.taxon_names
        newick = jtree.to_newick(names)
    finally:
        mp.undo()
    return names, newick


@pytest.mark.parametrize("thorough", [False, True])
def test_rearrange_matches_jax(smoothed_pair, thorough):
    names, newick = smoothed_pair
    _, seqs = _correlated_dna(10, 150)
    jinst = JaxInstance(jbuild_alignment(names, seqs), dtype=jnp.float64)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu",
                          grad_smooth=False)
    jtree = jinst.tree_from_newick(newick)
    ttree = tinst.tree_from_newick(newick)
    jl = jinst.evaluate(jtree, full=True)
    tl = tinst.evaluate(ttree, full=True)
    assert tl == pytest.approx(jl, rel=1e-12)
    jctx = jspr.SprContext(jinst, thorough=thorough)
    tctx = spr.SprContext(tinst, thorough=thorough)
    for ctx, lnl in ((jctx, jl), (tctx, tl)):
        ctx.start_lh = ctx.end_lh = lnl
        ctx.lh_cutoff = lnl / -1000.0
    before = snapshots.TreeSnapshot.capture(ttree, tl)
    jslots = jspr.dfs_slot_order(jtree)
    tslots = spr.dfs_slot_order(ttree)
    for k in (1, 10 + 1, 10 + 4):          # a tip, then two inner slots
        assert tslots[k].number == jslots[k].number
        for ctx in (jctx, tctx):
            ctx.best_of_node = -1.0e300
        jspr.rearrange(jinst, jtree, jctx, jslots[k], 1, 5)
        spr.rearrange(tinst, ttree, tctx, tslots[k], 1, 5)
        assert tctx.best_of_node == pytest.approx(jctx.best_of_node,
                                                  rel=1e-10)
        assert tctx.end_lh == pytest.approx(jctx.end_lh, rel=1e-10)
        assert tctx.insert_node.number == jctx.insert_node.number
        assert tctx.remove_node.number == jctx.remove_node.number
        for name in ("current_zqr", "lzq", "lzr", "lzs", "current_lzq",
                     "current_lzr", "current_lzs"):
            np.testing.assert_allclose(getattr(tctx, name),
                                       getattr(jctx, name), rtol=1e-8,
                                       err_msg=name)
        assert tctx.lh_avg == pytest.approx(jctx.lh_avg, rel=1e-9)
        assert tctx.lh_dec == jctx.lh_dec
    assert tctx.lh_dec > 0
    after = snapshots.TreeSnapshot.capture(ttree, tl)
    assert after.key == before.key
    assert _edges(after) == _edges(before)


def test_local_and_region_smooth_match_jax():
    jinst, jtree, tinst, ttree = _pair(10, 150, tree_seed=4)
    k = 10 + 3                              # an inner slot
    jp, tp = jspr.dfs_slot_order(jtree)[k], spr.dfs_slot_order(ttree)[k]
    start = _edges(snapshots.TreeSnapshot.capture(ttree, 0.0))
    assert jbranch.local_smooth(jinst, jtree, jp, 4)
    assert branch.local_smooth(tinst, ttree, tp, 4)
    assert jbranch.region_smooth(jinst, jtree, jp, 2, 4)
    assert branch.region_smooth(tinst, ttree, tp, 2, 4)
    jz = _edges(jsnap.TreeSnapshot.capture(jtree, 0.0))
    tz = _edges(snapshots.TreeSnapshot.capture(ttree, 0.0))
    assert [e[:2] for e in tz] == [e[:2] for e in jz]
    np.testing.assert_allclose([e[2] for e in tz], [e[2] for e in jz],
                               rtol=1e-8)
    assert sum(e != f for e, f in zip(tz, start)) >= 8   # branches moved
    assert tinst.evaluate(ttree, full=True) == pytest.approx(
        jinst.evaluate(jtree, full=True), rel=1e-10)


def test_spr_cycle_commits_jax_topology():
    jinst, jtree, tinst, ttree = _pair(10, 150, tree_seed=7)
    out = []
    for inst, tree, mod, ev in ((jinst, jtree, jsearch, jtree_evaluate),
                                (tinst, ttree, raxml_search, tree_evaluate)):
        l0 = ev(inst, tree, 1.0)
        snap = jsnap if mod is jsearch else snapshots
        sprm = jspr if mod is jsearch else spr
        ctx = sprm.SprContext(inst, do_cutoff=True)
        bt = snap.BestList(20)
        lnl = mod.tree_optimize_rapid(inst, tree, ctx, 1, 5, bt, None,
                                      snap.InfoList(50))
        out.append((l0, lnl, snap.topology_key(tree), bt.nvalid,
                    bt.best_lnl))
    (jl0, jl, jkey, jn, jbest), (tl0, tl, tkey, tn, tbest) = out
    assert tl0 == pytest.approx(jl0, rel=1e-10)
    assert tl > tl0
    assert tkey == jkey
    assert tl == pytest.approx(jl, rel=1e-9)
    assert tn == jn and tbest == pytest.approx(jbest, rel=1e-9)


def test_compute_big_rapid_pinned_case():
    jinst, jtree, tinst, ttree = _pair(8, 150, tree_seed=7)
    opts = dict(initial_set=True, initial=5)
    jres = jsearch.compute_big_rapid(jinst, jtree,
                                     jsearch.SearchOptions(**opts))
    t0 = tinst.evaluate(ttree, full=True)
    tres = raxml_search.compute_big_rapid(tinst, ttree,
                                          raxml_search.SearchOptions(**opts))
    assert (tres.fast_iterations, tres.thorough_iterations) == \
        (jres.fast_iterations, jres.thorough_iterations) == (2, 1)
    assert snapshots.topology_key(ttree) == jsnap.topology_key(jtree)
    assert tres.likelihood > t0
    assert tres.likelihood == pytest.approx(jres.likelihood, rel=1e-10)
    assert tres.likelihood == pytest.approx(JAX_PINNED_LNL, rel=1e-8)
    assert tinst.evaluate(ttree, full=True) == pytest.approx(
        tres.likelihood, rel=1e-12)
