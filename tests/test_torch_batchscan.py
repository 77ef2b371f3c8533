"""The port's batched SPR scan against the JAX package (float64 on the CPU).

Both packages build their trees from one newick text (slot order follows
build order), so the same pruned slot has the same number on both sides.

* `plan_for_endpoints`: JAX's candidates in JAX's order, the same up
  entries and down entries (node numbers and z);
* `run_plan`: each candidate's lazy lnL at rtol 1e-10 of JAX's, GAMMA
  DNA, GAMMA amino acids (K = 20), PSR, -M (two partitions, a branch
  slot each) and mixed state buckets (a DNA and an amino-acid engine,
  whose scores add up); `run_plan_thorough`: lnLs at
  rtol 1e-10, the smoothed branch triplets at rtol 1e-8, GAMMA and PSR;
* the port's batched arm equals its sequential arm on every candidate
  (rtol 1e-10), lazy and thorough;
* `rearrange_batched` leaves JAX's ctx under EXAML_BATCH_SCAN=1 and
  restores the tree exactly; a full traversal after a scan evaluates as
  before (rtol 1e-12);
* the gates: the CPU is sequential, `batch_scan=True` batches the lazy
  arm, `batch_thorough=True` the thorough arm where one bucket and one
  branch slot allow it (not under -M or mixed buckets);
* the slice as a whole: the pinned 8-taxon `compute_big_rapid` with
  `batch_scan=True` against JAX under EXAML_BATCH_SCAN=1 (both thorough
  arms sequential on the CPU, as in the JAX package), and with
  `batch_thorough=True` against EXAML_BATCH_THOROUGH=1;
* on the card (marked cuda): batched against sequential, f64.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.partitions import PartitionSpec
from examl_tpu_torch.ops import engine
from examl_tpu_torch.search import batchscan, raxml_search, snapshots, spr
from examl_tpu_torch.transfer import install_psr_state
from examl_tpu_torch.tree.topology import hookup

ALPHABET = {"DNA": "ACGT", "AA": "ARNDCQEGHILKMFPSTWYV"}


def _jax():
    """The JAX package's modules, imported inside the tests that use them:
    the card's machine, which runs the cuda case, has no JAX."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as Instance
    from examl_tpu.io.alignment import build_alignment_data as build
    from examl_tpu.io.partitions import PartitionSpec as Spec
    from examl_tpu.optimize.psr import optimize_rate_categories
    from examl_tpu.search import (batchscan, raxml_search, snapshots,
                                  spr)
    return SimpleNamespace(jnp=jnp, Instance=Instance, build=build,
                           Spec=Spec,
                           optimize_psr=optimize_rate_categories,
                           batchscan=batchscan, search=raxml_search,
                           snap=snapshots, spr=spr)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One torch intra-op thread (the suite runs on several xdist workers
    at once), the JAX package on per-branch smoothing as the port's
    `grad_smooth=False`, and no batching switch inherited."""
    monkeypatch.setenv("EXAML_GRAD_SMOOTH", "0")
    monkeypatch.delenv("EXAML_BATCH_SCAN", raising=False)
    monkeypatch.delenv("EXAML_BATCH_THOROUGH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(ntaxa, nsites, seed, datatype="DNA", mut=None):
    """Random sequences (independent columns), or a correlated walk with
    mutation rate `mut` (DNA)."""
    rng = np.random.default_rng(seed)
    alphabet = ALPHABET[datatype]
    names = [f"t{i}" for i in range(ntaxa)]
    if mut is None:
        return names, ["".join(alphabet[c] for c in
                               rng.integers(0, len(alphabet), nsites))
                       for _ in names]
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in names:
        flip = rng.random(nsites) < mut
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return names, seqs


def _alignment(build, spec, names, seqs, datatype, layout, seed):
    """One package's alignment of `seqs`: one partition (layout None), two
    DNA partitions ("M"), or the DNA partition and an amino-acid one of
    half its width ("mixed", two state buckets)."""
    if layout is None:
        return build(names, seqs, datatype_name=datatype)
    n = len(seqs[0])
    if layout == "M":
        return build(names, seqs, [spec("a", "DNA", "GTR", np.arange(n // 2)),
                                   spec("b", "DNA", "GTR",
                                        np.arange(n // 2, n))])
    ad = build(names, seqs, [spec("d", "DNA", "GTR", np.arange(n))])
    aa = _sequences(len(names), n // 2, seed + 1, "AA")[1]
    ad.partitions += build(names, aa, [spec("p", "AA", "WAG",
                                            np.arange(n // 2))]).partitions
    return ad


def _pair(ntaxa, nsites, seed, datatype="DNA", mut=None, psr=False,
          layout=None, **kwargs):
    """(JAX instance, JAX tree, port instance, port tree) on one alignment
    and one newick (JAX's random tree), both evaluated; under PSR the JAX
    side's categorized site rates are installed in the port.  Layout "M"
    gives both sides a branch slot per partition."""
    J = _jax()
    names, seqs = _sequences(ntaxa, nsites, seed, datatype, mut)
    model = "PSR" if psr else "GAMMA"
    per_part = layout == "M"
    jinst = J.Instance(_alignment(J.build, J.Spec, names, seqs, datatype,
                                  layout, seed),
                       dtype=J.jnp.float64, rate_model=model,
                       per_partition_branches=per_part)
    newick = jinst.random_tree(seed).to_newick(names)
    jtree = jinst.tree_from_newick(newick)
    jinst.evaluate(jtree, full=True)
    tinst = PhyloInstance(_alignment(build_alignment_data, PartitionSpec,
                                     names, seqs, datatype, layout, seed),
                          dtype=torch.float64, device="cpu",
                          grad_smooth=False, rate_model=model,
                          per_partition_branches=per_part, **kwargs)
    if psr:
        J.optimize_psr(jinst, jtree)
        install_psr_state(tinst, jinst.patrat, jinst.rate_category,
                          jinst.per_site_rates)
        jinst.evaluate(jtree, full=True)
    ttree = tinst.tree_from_newick(newick)
    tinst.evaluate(ttree, full=True)
    assert tinst.likelihood == pytest.approx(jinst.likelihood, rel=1e-12)
    return jinst, jtree, tinst, ttree


def _deep_slot(tree):
    """The first inner node with inner nodes on both of its other sides."""
    return next(tree.nodep[n] for n in tree.inner_numbers()
                if not tree.is_tip(tree.nodep[n].next.back.number)
                and not tree.is_tip(tree.nodep[n].next.next.back.number))


def _prune(mod, inst, tree, thorough):
    """remove_node at the first deep slot; (ctx, p, q1, q2)."""
    ctx = mod.SprContext(inst, thorough=thorough, do_cutoff=False)
    p = _deep_slot(tree)
    q1, q2 = p.next.back, p.next.next.back
    mod.remove_node(inst, tree, ctx, p)
    return ctx, p, q1, q2


def _plans(jinst, jtree, tinst, ttree, thorough=False, maxtrav=5):
    J = _jax()
    jctx, jp, jq1, jq2 = _prune(J.spr, jinst, jtree, thorough)
    tctx, tp, tq1, tq2 = _prune(spr, tinst, ttree, thorough)
    assert tp.number == jp.number
    jplan = J.batchscan.plan_for_endpoints(jinst, jtree, jp, jq1, jq2, 1,
                                           maxtrav)
    tplan = batchscan.plan_for_endpoints(tinst, ttree, tp, tq1, tq2, 1,
                                         maxtrav)
    return (jctx, jp, jplan), (tctx, tp, tplan)


def _entry(e):
    return (e.parent, e.left, e.right, e.zl, e.zr)


def test_plan_matches_jax():
    jinst, jtree, tinst, ttree = _pair(14, 60, seed=0)
    (_, _, jplan), (_, _, tplan) = _plans(jinst, jtree, tinst, ttree,
                                          maxtrav=8)
    assert len(tplan.candidates) >= 10
    assert [(c.q_num, c.q_slot.back.number, c.up_slot, c.depth)
            for c in tplan.candidates] == \
        [(c.q_num, c.q_slot.back.number, c.up_slot, c.depth)
         for c in jplan.candidates]
    np.testing.assert_allclose([c.z for c in tplan.candidates],
                               [c.z for c in jplan.candidates], rtol=1e-15)
    assert [tuple(e) for e in tplan.up_entries] == \
        [tuple(e) for e in jplan.up_entries]
    assert [_entry(e) for e in tplan.down_entries] == \
        [_entry(e) for e in jplan.down_entries]
    assert (tplan.s_num, tplan.zp) == (jplan.s_num, jplan.zp)


@pytest.mark.parametrize("datatype,psr,layout", [
    pytest.param("DNA", False, None, id="DNA-False"),
    pytest.param("AA", False, None, id="AA-False"),
    pytest.param("DNA", True, None, id="DNA-True"),
    pytest.param("DNA", False, "M", id="DNA-M"),
    pytest.param("DNA", False, "mixed", id="DNA-mixed")])
def test_lazy_scan_matches_jax_and_sequential(datatype, psr, layout):
    nsites = {"DNA": 400, "AA": 150}[datatype]
    jinst, jtree, tinst, ttree = _pair(14, nsites, seed=1, datatype=datatype,
                                       mut=0.25 if psr else None, psr=psr,
                                       layout=layout)
    assert tinst.num_branch_slots == (2 if layout == "M" else 1)
    assert len(tinst.engines) == (2 if layout == "mixed" else 1)
    (_, _, jplan), (tctx, tp, tplan) = _plans(jinst, jtree, tinst, ttree)
    assert len(tplan.candidates) >= 8
    jl = _jax().batchscan.run_plan(jinst, jtree, jplan)
    tl = batchscan.run_plan(tinst, ttree, tplan)
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    # The sequential arm's insert -> evaluate -> undo on every candidate.
    seq = []
    for cand in tplan.candidates:
        q = cand.q_slot
        r, qz = q.back, list(q.z)
        spr.insert_node(tinst, ttree, tctx, tp, q)
        seq.append(tinst.evaluate(ttree, tp.next.next))
        hookup(q, r, qz)
        tp.next.back = tp.next.next.back = None
    np.testing.assert_allclose(tl, seq, rtol=1e-10)


def _sequential_thorough(inst, tree, ctx, p, plan):
    """spr.test_insert's thorough arm on every candidate: lnLs and the
    smoothed branch triplets."""
    lnls, es = [], []
    for cand in plan.candidates:
        q = cand.q_slot
        r, qz, pz = q.back, list(q.z), list(p.z)
        spr.insert_node(inst, tree, ctx, p, q)
        lnls.append(inst.evaluate(tree, p.next.next))
        es.append((p.next.z[0], p.next.next.z[0], p.z[0]))
        hookup(q, r, qz)
        p.next.back = p.next.next.back = None
        hookup(p, p.back, pz)
    return np.asarray(lnls), np.asarray(es)


@pytest.mark.parametrize("psr", [False, True])
def test_thorough_scan_matches_jax_and_sequential(psr):
    jinst, jtree, tinst, ttree = _pair(12, 300, seed=11, mut=0.25, psr=psr)
    (_, _, jplan), (tctx, tp, tplan) = _plans(jinst, jtree, tinst, ttree,
                                              thorough=True, maxtrav=3)
    assert len(tplan.candidates) >= 3
    jl, je = _jax().batchscan.run_plan_thorough(jinst, jtree, jplan)
    tl, te = batchscan.run_plan_thorough(tinst, ttree, tplan)
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    np.testing.assert_allclose(te, je, rtol=1e-8)
    sl, se = _sequential_thorough(tinst, ttree, tctx, tp, tplan)
    np.testing.assert_allclose(tl, sl, rtol=1e-10)
    np.testing.assert_allclose(te, se, rtol=1e-8)


def test_newton_lanes_match_one_at_a_time():
    """Lanes of the batched Newton-Raphson equal separate solves bit for
    bit, started anywhere from converged to far off."""
    _, _, tinst, ttree = _pair(8, 120, seed=3, mut=0.2)
    (eng,) = tinst.engines.values()
    pairs = [(p.number, p.back.number) for p, _ in ttree.all_branches()][:6]
    for a, b in pairs:
        tinst.new_view(ttree, ttree.nodep[a])
        tinst.new_view(ttree, ttree.nodep[b])
    st = torch.stack([eng.make_sumtable(a, b) for a, b in pairs])
    z0 = np.array([0.9, 0.5, 1e-3, 0.99999, 0.1, 0.7])[:, None]
    args = (eng.models, eng.block_part, eng.weights)
    lanes = engine.kernels.newton_raphson_branch(
        *args, st, z0, np.full((6, 1), 10), np.zeros((6, 1), bool), 1)
    for i in range(6):
        one = engine.kernels.newton_raphson_branch(
            *args, st[i], z0[i], np.full(1, 10), np.zeros(1, bool), 1)
        assert lanes[i, 0] == pytest.approx(one[0], rel=1e-13)


def _ctx_pair(jinst, tinst, thorough, lnl):
    out = []
    for mod, inst in ((_jax().spr, jinst), (spr, tinst)):
        ctx = mod.SprContext(inst, thorough=thorough)
        ctx.start_lh = ctx.end_lh = lnl
        ctx.lh_cutoff = lnl / -1000.0
        out.append(ctx)
    return out


@pytest.mark.parametrize("thorough", [False, True])
def test_rearrange_batched_matches_jax(monkeypatch, thorough):
    """rearrange_batched over three slots (a tip, two inner slots) leaves
    JAX's ctx under EXAML_BATCH_SCAN=1 (EXAML_BATCH_THOROUGH=1 for the
    thorough arm), and the tree restored exactly."""
    monkeypatch.setenv("EXAML_BATCH_SCAN", "1")
    monkeypatch.setenv("EXAML_BATCH_THOROUGH", "1")
    jspr = _jax().spr
    jinst, jtree, tinst, ttree = _pair(10, 150, seed=5, mut=0.15)
    lnl = tinst.likelihood
    jctx, tctx = _ctx_pair(jinst, tinst, thorough, lnl)
    before = snapshots.TreeSnapshot.capture(ttree, lnl)
    jslots, tslots = jspr.dfs_slot_order(jtree), spr.dfs_slot_order(ttree)
    for k in (1, 10 + 1, 10 + 4):
        assert tslots[k].number == jslots[k].number
        for ctx in (jctx, tctx):
            ctx.best_of_node = -1.0e300
        assert jspr.rearrange_batched(jinst, jtree, jctx, jslots[k], 1, 5,
                                      thorough=thorough)
        assert spr.rearrange_batched(tinst, ttree, tctx, tslots[k], 1, 5,
                                     thorough=thorough)
        assert tctx.best_of_node == pytest.approx(jctx.best_of_node,
                                                  rel=1e-10)
        assert tctx.end_lh == pytest.approx(jctx.end_lh, rel=1e-10)
        assert tctx.insert_node.number == jctx.insert_node.number
        assert tctx.insert_node.back.number == jctx.insert_node.back.number
        assert tctx.remove_node.number == jctx.remove_node.number
        for name in ("current_zqr", "current_lzq", "current_lzr",
                     "current_lzs"):
            np.testing.assert_allclose(getattr(tctx, name),
                                       getattr(jctx, name), rtol=1e-8,
                                       err_msg=name)
        assert tctx.lh_avg == pytest.approx(jctx.lh_avg, rel=1e-9)
        assert tctx.lh_dec == jctx.lh_dec
    assert tctx.lh_dec > 0
    after = snapshots.TreeSnapshot.capture(ttree, lnl)
    assert after.key == before.key
    assert sorted(after.edges) == sorted(before.edges)
    # The deferred new_view(prune): a partial evaluate trusting the
    # x-flags, then a full traversal, give the lnL from before the scans.
    p = tslots[10 + 4]
    assert tinst.evaluate(ttree, p) == pytest.approx(lnl, rel=1e-12)
    assert tinst.evaluate(ttree, full=True) == pytest.approx(lnl, rel=1e-12)


def test_gates():
    names, seqs = _sequences(8, 40, 0)
    ad = build_alignment_data(names, seqs)

    def inst(**kw):
        return PhyloInstance(ad, dtype=torch.float64, device="cpu", **kw)

    cpu = inst()
    assert not spr.batched_scan_enabled(cpu)
    assert not spr.thorough_batched_ok(cpu)
    on = inst(batch_scan=True)
    assert spr.batched_scan_enabled(on) and not spr.thorough_batched_ok(on)
    both = inst(batch_scan=True, batch_thorough=True)
    assert spr.batched_scan_enabled(both) and spr.thorough_batched_ok(both)
    assert spr.thorough_batched_ok(inst(batch_thorough=True))
    off = inst(batch_scan=False, batch_thorough=True)
    assert not spr.batched_scan_enabled(off)
    assert not spr.thorough_batched_ok(off)
    assert not spr.thorough_batched_ok(inst(batch_thorough=False,
                                            batch_scan=True))
    # -M: one branch slot per partition keeps the sequential thorough arm.
    from examl_tpu_torch.io.partitions import PartitionSpec
    two = build_alignment_data(names, seqs, [
        PartitionSpec("a", "DNA", "GTR", np.arange(20)),
        PartitionSpec("b", "DNA", "GTR", np.arange(20, 40))])
    per_part = PhyloInstance(two, dtype=torch.float64, device="cpu",
                             per_partition_branches=True, batch_scan=True,
                             batch_thorough=True)
    assert spr.batched_scan_enabled(per_part)
    assert not spr.thorough_batched_ok(per_part)
    # Mixed state buckets likewise.
    aa = build_alignment_data(names, _sequences(8, 20, 1, "AA")[1], [
        PartitionSpec("p", "AA", "WAG", np.arange(20))])
    two.partitions += aa.partitions
    mixed = PhyloInstance(two, dtype=torch.float64, device="cpu",
                          batch_thorough=True)
    assert len(mixed.engines) == 2
    assert not spr.thorough_batched_ok(mixed)


@pytest.mark.parametrize("thorough_env,kwargs", [
    ({}, dict(batch_scan=True)),
    ({"EXAML_BATCH_THOROUGH": "1"}, dict(batch_scan=True,
                                        batch_thorough=True))])
def test_compute_big_rapid_batched_matches_jax(monkeypatch, thorough_env,
                                               kwargs):
    """The pinned 8-taxon search (tests/test_torch_search.py) on the
    batched route: JAX's iteration counts and topology, lnL rtol 1e-10."""
    monkeypatch.setenv("EXAML_BATCH_SCAN", "1")
    for k, v in thorough_env.items():
        monkeypatch.setenv(k, v)
    J = _jax()
    names, seqs = _sequences(8, 150, 42, mut=0.15)
    jinst = J.Instance(J.build(names, seqs), dtype=J.jnp.float64)
    newick = jinst.random_tree(seed=7).to_newick(names)
    jtree = jinst.tree_from_newick(newick)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu",
                          grad_smooth=False, **kwargs)
    ttree = tinst.tree_from_newick(newick)
    calls = batchscan.SCAN_CALLS
    opts = dict(initial_set=True, initial=5)
    jres = J.search.compute_big_rapid(jinst, jtree,
                                      J.search.SearchOptions(**opts))
    t0 = tinst.evaluate(ttree, full=True)
    tres = raxml_search.compute_big_rapid(tinst, ttree,
                                          raxml_search.SearchOptions(**opts))
    assert batchscan.SCAN_CALLS > calls
    assert (tres.fast_iterations, tres.thorough_iterations) == \
        (jres.fast_iterations, jres.thorough_iterations)
    assert snapshots.topology_key(ttree) == J.snap.topology_key(jtree)
    assert tres.likelihood > t0
    assert tres.likelihood == pytest.approx(jres.likelihood, rel=1e-10)
    assert tinst.evaluate(ttree, full=True) == pytest.approx(
        tres.likelihood, rel=1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("thorough", [False, True])
def test_cuda_batched_matches_sequential(cuda_device, thorough):
    """On the card in f64: the batched arm's ctx equals the sequential
    arm's on every slot of one SPR pass (cutoff off, so both scan the same
    window), and the tree comes back unchanged."""
    names, seqs = _sequences(14, 400, 2, mut=0.2)
    inst = PhyloInstance(build_alignment_data(names, seqs),
                         dtype=torch.float64, device=cuda_device)
    assert spr.batched_scan_enabled(inst) and spr.thorough_batched_ok(inst)
    tree = inst.random_tree(2)
    lnl = inst.evaluate(tree, full=True)
    before = snapshots.TreeSnapshot.capture(tree, lnl)
    for p in spr.dfs_slot_order(tree)[:20]:
        ctxs = [spr.SprContext(inst, thorough=thorough, do_cutoff=False)
                for _ in range(2)]
        for ctx in ctxs:
            ctx.start_lh = ctx.end_lh = lnl
            ctx.best_of_node = -1.0e300
        spr.rearrange(inst, tree, ctxs[0], p, 1, 5)
        spr.rearrange_batched(inst, tree, ctxs[1], p, 1, 5,
                              thorough=thorough)
        seq, bat = ctxs
        assert bat.best_of_node == pytest.approx(seq.best_of_node,
                                                 rel=1e-10)
        assert bat.end_lh == pytest.approx(seq.end_lh, rel=1e-10)
        if seq.insert_node is not None:
            assert bat.insert_node is seq.insert_node
    after = snapshots.TreeSnapshot.capture(tree, lnl)
    assert after.key == before.key
    assert sorted(after.edges) == sorted(before.edges)
    assert inst.evaluate(tree, full=True) == pytest.approx(lnl, rel=1e-12)
