"""The in-process site axis of the port (parallel/shards.py): S site
shards of one tree in one process, each an engine set over its block
window on its card of an `Sx1` mesh, on a thread of its own, every site
sum reduced over the shards in rank order (float64 on the CPU).

The shards run on `[cpu] * S` here; the JAX package's sharded instance on
the test conftest's 8 virtual CPU devices (`make_fabric_mesh(S, 1)`,
`block_multiple=S`, as tests/test_sharding.py and tests/test_mesh.py
build it).  Against it and the port's one-card instance:

* ref49 lnL and per-partition lnL (S = 2, 4): rtol 1e-10 of JAX's `Sx1`,
  1e-12 of one card; NR derivatives (rtol 1e-9), makenewz (1e-10) and
  whole-tree gradients (1e-9);
* bit for bit with two gloo ranks of tests/test_torch_multiproc.py's
  worker over the same windows (S = 2), the same collectives a rank;
* one lazy SPR cycle picks the same topology as one card
  (tests/test_sharding.py::test_sharded_spr_cycle's check); `-M` with two
  partitions; one PSR categorization round (the same categories, rates
  rtol 1e-9); `-S`: the pooled lnL and each shard's pool region (cell
  map, free cells, capacity) as JAX's sharded `SevState`'s region;
* a shard that raises ends the call with its own error and leaves no
  shard waiting; the instruments count an op once, as on one card; a
  checkpoint crosses from one card to `2x1` and back (rtol 1e-10);
* `select_sharding`'s default and its meshes as JAX's, the CLI's `--mesh`
  checks (JAX's messages where both refuse), and `-f e` on `2x1` through
  the CLI as on one card;
* on the card only (`@pytest.mark.cuda`): `2x1` on cuda:0 twice, kernel
  B1 and kernel B2 once a shard a traversal, bit for bit with two gloo
  ranks on the card.

JAX is imported inside the tests that use it (the card's machine runs
the card case with --noconftest and has no JAX).
"""

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data as tbuild
from examl_tpu_torch.io.bytefile import read_bytefile
from examl_tpu_torch.io.partitions import PartitionSpec as TSpec
from examl_tpu_torch.parallel import sharding as tsh
from examl_tpu_torch.parallel.shards import ShardedEngine
from examl_tpu_torch.transfer import install_model_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF49 = os.path.join(REPO, "tests", "fixtures", "ref49")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (the suite runs on several xdist workers, and
    the gloo ranks run with one), no mesh from the environment."""
    monkeypatch.delenv("EXAML_MESH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(s, devices=None):
    return tsh.fabric_sharding(tsh.make_fabric_mesh(
        s, 1, devices if devices is not None else [CPU] * s))


def _ref49_params():
    from tests.refmodel import parse_model_file
    return parse_model_file(os.path.join(REF49, "modelFile"))


def _ref49_text():
    with open(os.path.join(REF49, "TreeFile")) as f:
        return f.read()


def _port49(s=1, **kw):
    """The port's ref49 instance (float64, the reference's models) on one
    CPU "card", or on s site shards."""
    if s > 1:
        kw["sharding"] = _mesh(s)
    inst = PhyloInstance(read_bytefile(os.path.join(REF49, "aln49.binary")),
                         dtype=torch.float64, device="cpu", **kw)
    install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                for p in _ref49_params()])
    return inst


def _jax49(s, **kw):
    """JAX's ref49 instance on an Sx1 fabric of the virtual devices."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.io.bytefile import read_bytefile as jread
    from examl_tpu.parallel.sharding import (fabric_sharding,
                                             make_fabric_mesh)
    from tests.refmodel import install_reference_params
    inst = JaxInstance(jread(os.path.join(REF49, "aln49.binary")),
                       dtype=jnp.float64, block_multiple=s,
                       sharding=fabric_sharding(make_fabric_mesh(s, 1)),
                       **kw)
    install_reference_params(inst, _ref49_params())
    return inst


def _seqs(ntaxa, nsites, seed):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < 0.15
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


# -- two gloo ranks of tests/test_torch_multiproc.py's worker ---------------


@pytest.fixture(scope="module")
def gloo_ranks():
    """Two ranks of the multiproc worker's "gamma" task on ref49, started
    by the module's first test (their processes run beside the tests) and
    collected by its last, which reads them."""
    from tests import test_torch_multiproc as mp
    port = mp._free_port()
    procs = mp._start({"gamma": [(r, 2, port, "gamma", "") for r in (0, 1)]})
    yield lambda: mp._results(mp._collect(procs), "gamma")
    for ps in procs.values():
        for _, p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def _pruned_plan(inst, tree, maxtrav):
    """The multiproc worker's `pruned_plan` (lazy arm)."""
    from examl_tpu_torch.search import batchscan, spr
    ctx = spr.SprContext(inst, thorough=False, do_cutoff=False)
    p = next(tree.nodep[k] for k in tree.inner_numbers()
             if not tree.is_tip(tree.nodep[k].next.back.number)
             and not tree.is_tip(tree.nodep[k].next.next.back.number))
    q1, q2 = p.next.back, p.next.next.back
    spr.remove_node(inst, tree, ctx, p)
    return batchscan.plan_for_endpoints(inst, tree, p, q1, q2, 1, maxtrav)


def _gamma_task(inst):
    """The multiproc worker's "gamma" task, call for call."""
    from examl_tpu_torch.optimize.branch import tree_gradients
    from examl_tpu_torch.search import batchscan
    text = _ref49_text()

    def mk():
        t = inst.tree_from_newick(text)
        inst.evaluate(t, full=True)
        return t
    tree = mk()
    out = {"pp": inst.per_partition_lnl.tolist()}
    p = tree.nodep[tree.ntips + 3]
    inst.new_view(tree, p)
    inst.new_view(tree, p.back)
    (eng,) = inst.engines.values()
    st = eng.make_sumtable(p.number, p.back.number)
    out["d"] = np.stack(eng.branch_derivatives(st, p.z)).tolist()
    q = tree.nodep[5]
    out["nr"] = inst.makenewz(tree, q, q.back, [0.3], maxiter=16).tolist()
    out["grad"] = np.stack(tree_gradients(inst, tree)[1:]).tolist()
    t = mk()
    out["lazy"] = batchscan.run_plan(inst, t, _pruned_plan(inst, t,
                                                           5)).tolist()
    return out


# -- against the JAX package's sharded instance and one card ----------------


@pytest.mark.parametrize("s", [2, 4])
def test_ref49_lnl_derivatives_makenewz_as_jax(s, gloo_ranks):
    """Per-partition lnL rtol 1e-10 of JAX's Sx1 and 1e-12 of one card;
    NR derivatives rtol 1e-9 and makenewz 1e-10 of JAX's Sx1; whole-tree
    gradients 1e-9 of one card.  The shards tile the padded block axis
    and each engine lives on its shard's device."""
    from examl_tpu_torch.optimize.branch import tree_gradients
    text = _ref49_text()
    one, inst, jinst = _port49(), _port49(s), _jax49(s)
    eng = inst.engines[4]
    assert isinstance(eng, ShardedEngine) and len(eng.shards) == s
    assert eng.bucket.num_blocks % s == 0
    assert [(e.bucket.block_offset, e.B) for e in eng.shards] == [
        tsh.block_window(eng.bucket.num_blocks, r, s)[:1]
        + (eng.bucket.num_blocks // s,) for r in range(s)]
    trees = [x.tree_from_newick(text) for x in (one, inst, jinst)]
    for x, t in zip((one, inst, jinst), trees):
        x.evaluate(t, full=True)
    np.testing.assert_allclose(inst.per_partition_lnl,
                               np.asarray(jinst.per_partition_lnl),
                               rtol=1e-10)
    np.testing.assert_allclose(inst.per_partition_lnl, one.per_partition_lnl,
                               rtol=1e-12)
    assert inst.likelihood == pytest.approx(one.likelihood, rel=1e-12)
    derivs, zs = [], []
    for x, t in zip((inst, jinst), trees[1:]):
        p = t.nodep[t.ntips + 3]
        x.new_view(t, p)
        x.new_view(t, p.back)
        e = next(iter(x.engines.values()))
        derivs.append(np.stack(e.branch_derivatives(
            e.make_sumtable(p.number, p.back.number), p.z)))
        q = t.nodep[5]
        zs.append(np.asarray(x.makenewz(t, q, q.back, q.z, maxiter=16)))
    np.testing.assert_allclose(derivs[0], derivs[1], rtol=1e-9)
    np.testing.assert_allclose(zs[0], zs[1], rtol=1e-10)
    g1 = np.stack(tree_gradients(one, trees[0])[1:])
    gs = np.stack(tree_gradients(inst, trees[1])[1:])
    np.testing.assert_allclose(gs, g1, rtol=1e-9, atol=1e-9 * abs(g1).max())


def test_lazy_spr_cycle_picks_the_same_topology():
    """One lazy SPR cycle on 2x1 chooses the moves of one card: the same
    topology, lnL rel 1e-10."""
    from examl_tpu_torch.search.raxml_search import tree_optimize_rapid
    from examl_tpu_torch.search.snapshots import BestList, InfoList
    from examl_tpu_torch.search.spr import SprContext
    data = tbuild(*_seqs(8, 300, 7))
    out = []
    for kw in ({}, {"sharding": _mesh(2)}):
        inst = PhyloInstance(data, dtype=torch.float64, device="cpu", **kw)
        tree = inst.random_tree(seed=3)
        inst.evaluate(tree, full=True)
        tree_optimize_rapid(inst, tree, SprContext(inst), 1, 2,
                            BestList(20), None, InfoList(50))
        out.append((inst.evaluate(tree, full=True), tree.to_newick(
            data.taxon_names, with_lengths=False)))
    (l1, n1), (l2, n2) = out
    assert n2 == n1
    assert l2 == pytest.approx(l1, rel=1e-10)


def test_per_partition_branches_two_partitions_as_jax():
    """-M with two partitions (two branch slots) on 2x1: lnL rtol 1e-10 of
    JAX's Sx1 and 1e-12 of one card, and makenewz's two slots rtol 1e-10
    of one card."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.io.alignment import build_alignment_data as jbuild
    from examl_tpu.io.partitions import PartitionSpec as JSpec
    from examl_tpu.parallel.sharding import (fabric_sharding,
                                             make_fabric_mesh)
    names, seqs = _seqs(12, 300, 7)
    spans = [np.arange(0, 150), np.arange(150, 300)]
    data = tbuild(names, seqs, [TSpec(f"g{i}", "DNA", "GTR", c)
                                for i, c in enumerate(spans)])
    jinst = JaxInstance(jbuild(names, seqs, [JSpec(f"g{i}", "DNA", "GTR", c)
                                             for i, c in enumerate(spans)]),
                        dtype=jnp.float64, per_partition_branches=True,
                        block_multiple=2,
                        sharding=fabric_sharding(make_fabric_mesh(2, 1)))
    one, inst = (PhyloInstance(data, dtype=torch.float64, device="cpu",
                               per_partition_branches=True, **kw)
                 for kw in ({}, {"sharding": _mesh(2)}))
    text = one.random_tree(seed=3).to_newick(names)
    lnls, zs = [], []
    for x in (one, inst, jinst):
        t = x.tree_from_newick(text)
        lnls.append(x.evaluate(t, full=True))
        if x is not jinst:
            q = t.nodep[4]
            zs.append(x.makenewz(t, q, q.back, [0.3, 0.6], maxiter=16))
    assert lnls[1] == pytest.approx(lnls[2], rel=1e-10)
    assert lnls[1] == pytest.approx(lnls[0], rel=1e-12)
    np.testing.assert_allclose(zs[1], zs[0], rtol=1e-10)


def test_psr_round_same_categories():
    """One PSR categorization round on 2x1 from a fixed per-site rate state:
    the lnL before it rtol 1e-10 of JAX's Sx1, then the same categories
    as one card and the category rates rtol 1e-9."""
    from examl_tpu_torch.optimize.psr import optimize_rate_categories
    from examl_tpu_torch.transfer import install_psr_state
    rng = np.random.default_rng(5)
    widths = [p.width for p in read_bytefile(
        os.path.join(REF49, "aln49.binary")).partitions]
    cats = [rng.integers(0, 4, w).astype(np.int32) for w in widths]
    rates = [rng.uniform(0.3, 2.5, 4) for _ in widths]
    state = ([r[c] for r, c in zip(rates, cats)], cats, rates)
    jinst = _jax49(2, rate_model="PSR")
    jinst.patrat, jinst.rate_category, jinst.per_site_rates = \
        [np.array(a, copy=True) for a in state[0]], \
        [np.array(a, copy=True) for a in cats], \
        [np.array(a, copy=True) for a in rates]
    jinst.push_site_rates()
    jl = jinst.evaluate(jinst.tree_from_newick(_ref49_text()), full=True)
    out = []
    for s in (1, 2):
        inst = _port49(s, rate_model="PSR")
        install_psr_state(inst, *state)
        tree = inst.tree_from_newick(_ref49_text())
        lnl = inst.evaluate(tree, full=True)
        optimize_rate_categories(inst, tree)
        out.append((lnl, inst.rate_category, inst.per_site_rates))
    assert out[1][0] == pytest.approx(jl, rel=1e-10)
    for a, b in zip(out[1][1], out[0][1]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out[1][2], out[0][2]):
        np.testing.assert_allclose(a, b, rtol=1e-9)


def test_sev_pool_regions_as_jax():
    """-S on 2x1: the pooled lnL rtol 1e-10 of the dense one-card lnL, and
    after two topologies each shard's pool is JAX's sharded SevState's
    region of its blocks: the same cell ids, next cell, free cells and
    region capacity."""
    text = _ref49_text()
    dense, inst, jinst = _port49(), _port49(2, save_memory=True), \
        _jax49(2, save_memory=True)
    lnl = dense.evaluate(dense.tree_from_newick(text), full=True)
    assert inst.evaluate(inst.tree_from_newick(text), full=True) == \
        pytest.approx(lnl, rel=1e-10)
    jinst.evaluate(jinst.tree_from_newick(text), full=True)
    other = dense.random_tree(seed=5).to_newick(dense.alignment.taxon_names)
    for x in (inst, jinst):
        x.evaluate(x.tree_from_newick(other), full=True)
    jsev = next(iter(jinst.engines.values())).sev
    assert jsev.ndev == 2
    Bl = jsev.B_local
    for r, eng in enumerate(inst.engines[4].shards):
        sev = eng.sev
        assert sev.B == Bl
        np.testing.assert_array_equal(
            sev.cell_of, jsev.cell_of[:, r * Bl:(r + 1) * Bl])
        assert sev.next_cell == [jsev.next_cell[r]]
        assert sev.free == [jsev.free[r]]
        assert sev.cap == jsev.cap
        assert sev.pool.shape[0] == sev.cap


# -- the shards' threads ------------------------------------------------------


class ShardFault(RuntimeError):
    pass


@pytest.mark.parametrize("rank,where", [(0, "before"), (1, "before"),
                                        (1, "collective")])
def test_a_shard_that_raises_ends_the_call(monkeypatch, rank, where):
    """A shard that raises (before its op's collective, or in it) ends the
    call with its own error within seconds; no shard is left waiting, and
    the next call gives the right lnL."""
    inst = _port49(2)
    text = _ref49_text()
    ref = inst.evaluate(inst.tree_from_newick(text), full=True)
    shard = inst.engines[4].shards[rank]
    if where == "before":
        def broken(*a, **kw):
            raise ShardFault(f"shard {rank} failed")
        monkeypatch.setattr(shard, "_traverse", broken)
    else:
        real = shard.group._allgather

        def broken(a):
            real(a)
            raise ShardFault(f"shard {rank} failed in a collective")
        monkeypatch.setattr(shard.group, "_allgather", broken)
    t0 = time.perf_counter()
    with pytest.raises(ShardFault, match=f"shard {rank} failed"):
        inst.evaluate(inst.tree_from_newick(text), full=True)
    assert time.perf_counter() - t0 < 10.0
    monkeypatch.undo()
    idle = [t for t in threading.enumerate()
            if t.name.startswith("site-shard-")]
    assert idle and all(t.is_alive() for t in idle)
    assert inst.evaluate(inst.tree_from_newick(text), full=True) == ref


def test_shards_stress_the_board_and_the_launch_count():
    """More shards than cores, a short switch interval, many rounds: every
    shard's reduction is the rank-ordered sum each round, and the kernel
    launch count (taken under its lock by every shard) loses no update."""
    from examl_tpu_torch.ops import newview_chunk
    from examl_tpu_torch.parallel.shards import ShardPool
    size, rounds = 2 * (os.cpu_count() or 4) + 1, 200
    pool = ShardPool([CPU] * size, timeout=60)
    parts = np.random.default_rng(3).normal(size=(rounds, size, 3))
    want = [parts[k, 0].copy() for k in range(rounds)]
    for k in range(rounds):
        for r in range(1, size):
            want[k] += parts[k, r]
    clv = torch.zeros((1, 1, 1, 4, 4))
    n0 = newview_chunk.LAUNCHES
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(r):
            for k in range(rounds):
                got = pool.groups[r].allreduce(parts[k, r])
                assert np.array_equal(got, want[k]), (r, k)
                newview_chunk._count(clv, 1)
            return pool.groups[r].collectives
        t0 = time.perf_counter()
        assert pool.run(work) == [rounds] * size
        assert time.perf_counter() - t0 < 120
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert newview_chunk.LAUNCHES - n0 == rounds * size


def test_nonfinite_guard_recomputes_every_shard(monkeypatch):
    """`engine.nonfinite` on 2x1: the guard recomputes the CLVs of every
    shard once on the wave-scan tier, and the lnL is the clean one."""
    from examl_tpu_torch.resilience import faults
    inst = _port49(2)
    text = _ref49_text()
    clean = inst.evaluate(inst.tree_from_newick(text), full=True)
    obs.reset()
    monkeypatch.setenv(faults.ENV_VAR, "engine.nonfinite")
    faults.reset()
    try:
        got = inst.evaluate(inst.tree_from_newick(text), full=True)
    finally:
        monkeypatch.delenv(faults.ENV_VAR)
        faults.reset()
    assert got == pytest.approx(clean, rel=1e-12)
    assert obs.counter("engine.nonfinite_retries") == 1
    assert obs.counter("engine.nonfinite_recovered") == 1
    assert inst.evaluate(inst.tree_from_newick(text), full=True) == clean


def test_counters_count_an_op_once():
    """The instruments of a 2x1 run count, time and trace each engine op
    once, as one card's do; kernel-free counts (engine.FULL_TRAVERSALS
    etc.) too."""
    from examl_tpu_torch.ops import engine as teng
    from examl_tpu_torch.optimize.branch import tree_gradients
    from examl_tpu_torch.search import batchscan
    snaps = []
    for s in (1, 2):
        inst = _port49(s)
        obs.reset()
        plain = [teng.FULL_TRAVERSALS, teng.PARTIAL_TRAVERSALS,
                 teng.GRAD_PASSES]
        tree = inst.tree_from_newick(_ref49_text())
        inst.evaluate(tree, full=True)
        q = tree.nodep[5]
        inst.makenewz(tree, q, q.back, q.z, maxiter=16)
        tree_gradients(inst, tree)
        batchscan.run_plan(inst, tree, _pruned_plan(inst, tree, 5))
        snap = obs.snapshot()
        snaps.append((snap["counters"],
                      {k: v["count"] for k, v in snap["timers"].items()},
                      [a - b for a, b in zip(
                          [teng.FULL_TRAVERSALS, teng.PARTIAL_TRAVERSALS,
                           teng.GRAD_PASSES], plain)]))
    assert snaps[1] == snaps[0]
    assert snaps[0][0]["engine.dispatch_count"] > 0


@pytest.mark.parametrize("writer,reader", [(1, 2), (2, 1)])
def test_checkpoint_crosses_one_card_and_2x1(tmp_path, writer, reader):
    """A checkpoint written on one card restores on 2x1, and the other way
    round: the same topology, lnL rtol 1e-10."""
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    from examl_tpu_torch.search.snapshots import topology_key
    src, dst = _port49(writer), _port49(reader)
    tree = src.tree_from_newick(_ref49_text())
    for i, (p, _) in enumerate(tree.all_branches()):
        p.z[:] = [0.5 + 0.004 * i]
        p.back.z[:] = [0.5 + 0.004 * i]
    src.evaluate(tree, full=True)
    CheckpointManager(str(tmp_path), "run").write(
        "FAST_SPRS", {"impr": True}, src, tree)
    dtree = dst.random_tree(seed=8)
    resume = CheckpointManager(str(tmp_path), "run").restore(dst, dtree)
    assert resume["state"] == "FAST_SPRS"
    assert topology_key(dtree) == topology_key(tree)
    assert dst.evaluate(dtree, full=True) == pytest.approx(
        src.likelihood, rel=1e-10)


# -- select_sharding and the CLI ---------------------------------------------


@pytest.mark.parametrize("spec", [None, "2x1", "4x1", "1x1"])
def test_select_sharding_as_jax(monkeypatch, spec):
    """Eight visible cards: without a mesh a 1-D site mesh over all of
    them, with Sx1 the first S, 1x1 one card, each as the JAX package's
    on its eight virtual devices (the declared specs)."""
    from examl_tpu.parallel import launch as jlaunch
    from examl_tpu.parallel import sharding as jsh
    from examl_tpu_torch.parallel import launch
    monkeypatch.setattr(tsh, "visible_devices", lambda: [CPU] * 8)
    args = argparse.Namespace(mesh=spec, single_device=False)
    ours = launch.select_sharding(args, False)
    theirs = jlaunch.select_sharding(args, False)
    if theirs is None:
        assert ours is None
        return
    assert tsh.declared_specs(ours) == jsh.declared_specs(theirs)
    assert len(ours.site_devices()) == ours.site_shards
    # A run on the CPU, a rank of a process group and a rank of a
    # supervised gang keep one device.
    if spec is None:
        assert launch.select_sharding(args, False, device="cpu") is None
        gang = argparse.Namespace(mesh=None, single_device=False,
                                  _gang=(0, 2, "out"))
        assert launch.select_sharding(gang, False) is None
        args.nprocs = 2
        assert launch.select_sharding(args, False) is None


def test_select_sharding_builds_a_fleet_over_site_shards(monkeypatch):
    """Eight visible cards: --mesh 2x2 is the JAX package's 2x2 fabric
    (the declared specs), and an instance on it is the 2x1 one over tree
    slice 0's two cards, whose batches run through a 2x2 MeshShard."""
    from examl_tpu.parallel import launch as jlaunch
    from examl_tpu.parallel import sharding as jsh
    from examl_tpu_torch.fleet.shard import MeshShard
    from examl_tpu_torch.parallel import launch
    monkeypatch.setattr(tsh, "visible_devices", lambda: [CPU] * 8)
    args = argparse.Namespace(mesh="2x2", single_device=False)
    ours = launch.select_sharding(args, False)
    assert tsh.declared_specs(ours) == jsh.declared_specs(
        jlaunch.select_sharding(args, False))
    inst = PhyloInstance(tbuild(*_seqs(8, 120, 4)), dtype=torch.float64,
                         device="cpu", sharding=ours)
    assert inst.site_shards == 2 and inst.shard_pool.size == 2
    ev = inst.batch_evaluator()
    assert isinstance(ev, MeshShard)
    assert (ev.site_shards, ev.tree_shards) == (2, 2)


def _refusal(main, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        main(argv)
    err = capsys.readouterr().err.strip().splitlines()
    return ei.value.code, err[-1].split("error: ", 1)[-1]


@pytest.mark.parametrize("extra,port_only", [
    (["--mesh", "2x2"], None),                          # T>1, no fleet
    (["--mesh", "2x1", "--single-device"], None),
    (["--mesh", "4x2", "-S", "-N", "4"], None),         # SEV x T>1
    (["--mesh", "2x2", "-N", "4", "--fleet-devices", "0"], None),
    (["--mesh", "2x1", "--nprocs", "2", "--procid", "0", "--coordinator",
      "127.0.0.1:1"], "cannot combine with --nprocs"),
])
def test_cli_mesh_checks(tmp_path, capsys, extra, port_only):
    """Argument-time refusals (exit 2 before the dummy -s path is read):
    the JAX CLI's message where both packages refuse (a fleet over site
    shards is refused only with whole-card lanes, as there), the port's
    own where only the port does (site shards inside a rank of a process
    group)."""
    from examl_tpu_torch.cli.main import main as tmain
    base = ["-s", str(tmp_path / "missing.binary"), "-n", "X",
            "-w", str(tmp_path)]
    tcode, tmsg = _refusal(tmain, base + extra, capsys)
    assert tcode == 2
    if port_only:
        assert port_only in tmsg
        return
    from examl_tpu.cli.main import main as jmain
    jcode, jmsg = _refusal(jmain, base + extra, capsys)
    assert jcode == 2 and tmsg == jmsg


def test_cli_fe_on_2x1_as_one_card(tmp_path, monkeypatch):
    """-f e through the CLI on --mesh 2x1 (two CPU "cards") ends where the
    one-card run ends (rel 1e-10), logs its fabric and each shard's
    window, and a 1x1 mesh logs no sharding."""
    from examl_tpu_torch.cli.main import main
    from tests.test_torch_cli import _inputs
    monkeypatch.setattr(tsh, "visible_devices", lambda: [CPU] * 2)
    aln, trees = _inputs(tmp_path)
    ends, infos = {}, {}
    for tag, extra in (("one", ["--mesh", "1x1"]), ("m21", ["--mesh",
                                                            "2x1"])):
        wd = tmp_path / tag
        assert main(["-s", aln, "-t", trees, "-n", "T", "-w", str(wd),
                     "-f", "e"] + extra, device="cpu") == 0
        rows = (wd / "ExaML_log.T").read_text().split()
        ends[tag] = [float(v) for v in rows[1::2]]
        infos[tag] = (wd / "ExaML_info.T").read_text()
    np.testing.assert_allclose(ends["m21"], ends["one"], rtol=1e-10)
    assert "likelihood fabric 2x1: 2 site shard(s) x 1 tree slice(s) on " \
        "cpu, cpu" in infos["m21"]
    assert re.search(r"site shard 1 on cpu: blocks \d+\.\.\d+",
                     infos["m21"])
    assert "shard" not in infos["one"] and "fabric" not in infos["one"]


def test_bitwise_with_two_gloo_ranks(gloo_ranks):
    """2x1 in one process is two gloo ranks over the same windows, bit for
    bit: per-partition lnL, NR derivatives, makenewz, whole-tree
    gradients and lazy candidates; each shard issued its rank's
    collectives."""
    inst = _port49(2)
    out = _gamma_task(inst)
    ranks = gloo_ranks()
    for r, res in enumerate(ranks):
        for k in ("pp", "d", "nr", "grad", "lazy"):
            assert out[k] == res[k], (r, k)
    shards = inst.engines[4].shards
    assert [e.group.collectives for e in shards] == \
        [res["collectives"] for res in ranks]


# -- on the card ------------------------------------------------------------------


# One gloo rank of the card case; argv: rank, port, this file's path.  The
# file is loaded by its path: the card's machine may have another `tests`.
CARD_RANK = r"""
import importlib.util, json, os, sys
import torch, torch.distributed as dist
path = sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.dirname(path)))
spec = importlib.util.spec_from_file_location("site_axis_case", path)
case = importlib.util.module_from_spec(spec)
spec.loader.exec_module(case)
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
from examl_tpu_torch.parallel.sharding import SiteGroup
_card_run = case._card_run
group = SiteGroup(rank, 2, dist.group.WORLD)
out = _card_run(group=group)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def _card_run(**kw) -> dict:
    """lnL, per-partition lnL, makenewz and the launches of B1 (chunk
    tier) and B2 (whole tier) for one full evaluate each, on cuda:0, f32."""
    from examl_tpu_torch.ops import newview_chunk, newview_whole
    dev = torch.device("cuda", 0)
    names, seqs = _seqs(40, 2048, 4)
    data = tbuild(names, seqs, [TSpec("a", "DNA", "GTR", np.arange(1000)),
                                TSpec("b", "DNA", "GTR",
                                      np.arange(1000, 2048))])
    out = {}
    for tier, mod in (("chunk", newview_chunk), ("whole", newview_whole)):
        inst = PhyloInstance(data, dtype=torch.float32, device=dev,
                             newview=tier, **kw)
        tree = inst.random_tree(seed=3)
        n0 = mod.LAUNCHES
        lnl = inst.evaluate(tree, full=True)
        torch.cuda.synchronize()
        q = tree.nodep[5]
        out[tier] = {"lnl": lnl, "pp": inst.per_partition_lnl.tolist(),
                     "launches": mod.LAUNCHES - n0,
                     "z": inst.makenewz(tree, q, q.back, q.z,
                                        maxiter=16).tolist()}
    return out


@pytest.mark.cuda
def test_cuda_2x1_on_one_card_bitwise_with_two_ranks():
    """2x1 on [cuda:0, cuda:0]: B1 and B2 each launch once a shard for a
    full traversal, and lnL, per-partition lnL and makenewz are two gloo
    ranks' on the card over the same windows, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", CARD_RANK, str(r),
                               str(port), os.path.abspath(__file__)],
                              cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    dev = torch.device("cuda", 0)
    ours = _card_run(sharding=_mesh(2, [dev, dev]))
    ranks = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            res = [json.loads(line[7:]) for line in o.splitlines()
                   if line.startswith("RESULT ")]
            assert p.returncode == 0 and res, e[-3000:]
            ranks.append(res[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for tier in ("chunk", "whole"):
        assert ours[tier]["launches"] == 2, tier
        for res in ranks:
            assert res[tier]["launches"] == 1
            for k in ("lnl", "pp", "z"):
                assert ours[tier][k] == res[tier][k], (tier, k)
