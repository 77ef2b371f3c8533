"""The fleet over site shards in the port (examl_tpu_torch/fleet/shard.py
`SiteLanes` and `MeshShard` with S > 1, over parallel/shards.py), the
counterpart of tests/test_mesh.py, in float64 on the CPU.

A mesh here is the CPU named S*T times (`make_fabric_mesh(S, T, [cpu] *
S*T)`): S site shards of every tree, each an engine set over its block
window on a thread of the instance's pool, and T tree slices of every
fleet batch.  The JAX package's fabric runs on the test conftest's 8
virtual CPU devices.  Trees come from one newick text each, so both
packages score the same trees.

* a `2x2` MeshShard's rows against JAX's `2x2` fabric (rtol 1e-10), bit
  for bit the port's `2x1` evaluate of each job, rel 1e-12 of one card's
  BatchEvaluator; the slice counters and the mesh gauges;
* the parity matrix of tests/test_mesh.py as one case per shape and model
  (GAMMA on `2x1`, `1x2`, `2x2`, `4x2`; `-M` with two partitions and PSR
  on `2x1`, `1x2`, `2x2`), each against JAX's fabric of that shape as
  fleet rows and as the instance's evaluate;
* batched smoothing and weights batches on `2x2` against one card, and
  the FleetDriver's `-N` and `-b` on `2x2` against `1x1`;
* the CLI's `-N 6 --mesh 2x2` against the port's plain `-N 6` and JAX's
  `-N 6 --mesh 2x2`;
* a shard lane that raises in a launch or in smoothing ends the call with
  its own error, and the next batch runs; whole-card lanes over an
  instance of site shards are refused;
* on the card only (`@pytest.mark.cuda`): `2x2` of cuda:0 four times, the
  rows bit for bit `2x1`'s, four B1 launches a batch.

Every path that reduces over the shards runs with the shards' board on a
short timeout (`_short_board`), so a path that reduced off the shards'
threads fails in seconds instead of waiting out the board's 600 s.  JAX
is imported inside the tests that use it (the card's machine runs the
card case with --noconftest and has no JAX).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet import bootstrap, jobs
from examl_tpu_torch.fleet import shard as tshard
from examl_tpu_torch.fleet.driver import FleetDriver
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data as tbuild
from examl_tpu_torch.io.partitions import PartitionSpec as TSpec
from examl_tpu_torch.parallel import sharding as tsh

CPU = torch.device("cpu")
# Seconds a shard waits in a collective in these tests.
BOARD_S = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (the suite runs on several xdist workers), no
    mesh from the environment, both packages on their default smoothing
    route."""
    monkeypatch.delenv("EXAML_MESH", raising=False)
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(ntaxa, nsites, seed):
    """tests/test_mesh.py's `_synth_data` walk, as names and sequences."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < 0.15
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _parts(parts: str, nsites: int) -> list:
    """(name, first, end) of each partition.  At 300 columns one partition
    spans both shards' windows at S = 2, and the two halves of -M lie one
    in each shard's window, so each shard adds 0 to the other's."""
    if parts == "one":
        return [("p", 0, nsites)]
    return [("g1", 0, nsites // 2), ("g2", nsites // 2, nsites)]


def _data(parts="one", ntaxa=12, nsites=300, seed=7, jax=False):
    """The alignment, the port's or (jax=True) JAX's, of the same
    columns."""
    names, seqs = _seqs(ntaxa, nsites, seed)
    if jax:
        from examl_tpu.io.alignment import build_alignment_data
        from examl_tpu.io.partitions import PartitionSpec
        return build_alignment_data(names, seqs, [
            PartitionSpec(n, "DNA", "GTR", np.arange(a, b))
            for n, a, b in _parts(parts, nsites)])
    return tbuild(names, seqs, [TSpec(n, "DNA", "GTR", np.arange(a, b))
                                for n, a, b in _parts(parts, nsites)])


def _fabric(s, t, devices=None):
    return tsh.fabric_sharding(tsh.make_fabric_mesh(
        s, t, devices if devices is not None else [CPU] * (s * t)))


def _short_board(inst):
    """The instance's shards wait BOARD_S in a collective, not 600 s."""
    if inst.shard_pool is not None:
        inst.shard_pool.board.barrier = threading.Barrier(
            inst.shard_pool.size, timeout=BOARD_S)
    return inst


def _port(data, s=1, t=1, **kw):
    sharding = _fabric(s, t) if (s, t) != (1, 1) else None
    return _short_board(PhyloInstance(data, dtype=torch.float64,
                                      device="cpu", sharding=sharding,
                                      **kw))


def _jax(parts, s, t, **kw):
    """JAX's instance of the same data on its (s, t) fabric of the
    conftest's virtual devices."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.parallel.sharding import fabric_sharding, make_fabric_mesh
    return JaxInstance(_data(parts, jax=True), dtype=jnp.float64,
                       block_multiple=s,
                       sharding=fabric_sharding(make_fabric_mesh(s, t)),
                       **kw)


def _texts(data, seeds, **kw):
    """The newick text of each seed's random tree (with its lengths)."""
    inst = PhyloInstance(data, dtype=torch.float64, device="cpu", **kw)
    return [inst.random_tree(seed=s).to_newick(data.taxon_names)
            for s in seeds]


def _rows(inst, texts):
    """The instance's fleet rows [J, M] of the trees: one batch a group
    (either package)."""
    ev = inst.batch_evaluator()
    preps = [ev.prepare(inst.tree_from_newick(t)) for t in texts]
    out = np.empty((len(preps), len(inst.models)))
    for key in dict.fromkeys(p.key for p in preps):
        idx = [i for i, p in enumerate(preps) if p.key == key]
        out[idx] = np.asarray(ev.eval_batch([preps[i] for i in idx]))
    return out


def _evals(inst, texts):
    """Each tree's per-partition lnL by the instance's evaluate (either
    package)."""
    out = []
    for t in texts:
        inst.evaluate(inst.tree_from_newick(t), full=True)
        out.append(np.array(inst.per_partition_lnl, dtype=np.float64))
    return np.array(out)


# -- the 2x2 fabric ----------------------------------------------------------


def test_mesh_2x2_rows_as_jax_2x1_and_one_card():
    """A 2x2 MeshShard: two tree slices of two site lanes each.  Per-job
    per-partition lnL rtol 1e-10 of JAX's 2x2 fabric, bit for bit the
    port's 2x1 evaluate of each tree (the 2x2 instance is the 2x1 one over
    slice 0) and rel 1e-12 of one card's BatchEvaluator; the slice
    counters and the mesh gauges as JAX's test names them."""
    data = _data()
    texts = _texts(data, range(5))
    one = _rows(_port(data), texts)
    obs.reset()
    inst = _port(data, 2, 2)
    ev = inst.batch_evaluator()
    assert isinstance(ev, tshard.MeshShard)
    assert ev.site_shards == 2 and ev.tree_shards == 2
    assert all(isinstance(s, tshard.SiteLanes) and len(s.lanes) == 2
               for s in ev.slices)
    rows = _rows(inst, texts)
    snap = obs.snapshot()
    evals = _evals(_port(data, 2, 1), texts)
    assert np.array_equal(rows, evals)
    assert np.array_equal(_evals(inst, texts), evals)
    np.testing.assert_allclose(rows, one, rtol=1e-12)
    np.testing.assert_allclose(rows, _rows(_jax("one", 2, 2), texts),
                               rtol=1e-10)
    g, c = snap["gauges"], snap["counters"]
    assert g["engine.mesh_site_shards"] == 2
    assert g["engine.mesh_tree_shards"] == 2
    assert g["fleet.mesh_tree_shards"] == 2
    assert c["fleet.mesh_batches"] == 1
    assert c["fleet.mesh_slice_dispatches.t0"] == 1
    assert c["fleet.mesh_slice_dispatches.t1"] == 1
    assert [c["fleet.mesh_slice_jobs.t0"], c["fleet.mesh_slice_jobs.t1"]] \
        == [3, 2]
    # A slice counts its dispatch once, whatever its site shards (a 1x2
    # fabric counts the same).
    assert c["engine.dispatch_count"] == 2
    # Every lane owns its ready flags and its stacked arenas' stream.
    lanes = [lane for s in ev.slices for lane in s.lanes]
    flags = [id(r) for lane in lanes for r in lane._ready.values()]
    assert len(lanes) == 4 and len(flags) == len(set(flags))
    # Slice 0 runs the instance's shard engines; slice 1 copies theirs.
    live = [e.shards for e in inst.engines.values()][0]
    assert [lane.engines[0] for lane in ev.slices[0].lanes] == live
    assert all(isinstance(lane, tshard.DeviceShard)
               for lane in ev.slices[1].lanes)


@pytest.mark.parametrize("model,s,t", [
    ("gamma", 2, 1), ("gamma", 1, 2), ("gamma", 2, 2), ("gamma", 4, 2),
    ("M", 2, 1), ("M", 1, 2), ("M", 2, 2),
    ("psr", 2, 1), ("psr", 1, 2), ("psr", 2, 2)])
def test_parity_matrix_as_jax(model, s, t):
    """tests/test_mesh.py's parity matrix: the port's (s, t) fabric against
    JAX's evaluate, rtol 1e-10, as fleet rows (a MeshShard batch:
    chunk-tier jobs under GAMMA, wave-scan groups under PSR) and as the
    instance's
    evaluate; the rows bit for bit the port's evaluate of each tree.  (The
    JAX fabric's own batch rows are held to its evaluate by
    tests/test_mesh.py, and to the port's rows at 2x2 above.)"""
    parts = "two" if model == "M" else "one"
    kw = {"per_partition_branches": True} if model == "M" else \
        {"rate_model": "PSR"} if model == "psr" else {}
    data = _data(parts)
    texts = _texts(data, range(2), **kw)
    inst = _port(data, s, t, **kw)
    assert isinstance(inst.batch_evaluator(), tshard.MeshShard)
    rows = _rows(inst, texts)
    evals = _evals(inst, texts)
    assert np.array_equal(rows, evals)
    theirs = _evals(_jax(parts, s, t, **kw), texts)
    np.testing.assert_allclose(evals, theirs, rtol=1e-10)
    np.testing.assert_allclose(rows, theirs, rtol=1e-10)


# -- smoothing, weights, the driver ------------------------------------------


def test_smoothing_and_weights_on_2x2_as_one_card():
    """Batched smoothing (its gradient passes reduce over the shards, on
    the shards' threads) and a weights batch on 2x2 against one card:
    d1/d2 rtol 1e-9, every branch moved alike, the weights rows rel
    1e-12."""
    data = _data()
    texts = _texts(data, range(4))
    out = {}
    for name, (s, t) in (("one", (1, 1)), ("mesh", (2, 2))):
        inst = _port(data, s, t)
        ev = inst.batch_evaluator()
        trees = [inst.tree_from_newick(x) for x in texts]
        preps = [ev.prepare(tr) for tr in trees]
        d1, d2 = ev._grad_batch(preps)
        converged = ev.smooth_batch(preps, 2)
        w = [bootstrap.bootstrap_weights(data, k) for k in range(5)]
        out[name] = dict(
            d1=d1, d2=d2, converged=converged,
            z=[[list(p.z) for p, _ in tr.all_branches()] for tr in trees],
            lnl=_rows(inst, [tr.to_newick(data.taxon_names)
                             for tr in trees]),
            weights=ev.eval_weights_batch(
                inst.tree_from_newick(texts[0]), w))
    a, b = out["mesh"], out["one"]
    np.testing.assert_allclose(a["d1"], b["d1"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(a["d2"], b["d2"], rtol=1e-9)
    assert a["converged"] == b["converged"]
    np.testing.assert_allclose(a["z"], b["z"], rtol=1e-9)
    np.testing.assert_allclose(a["lnl"], b["lnl"], rtol=1e-12)
    np.testing.assert_allclose(a["weights"], b["weights"], rtol=1e-12)


def _lnls(done):
    return {j.job_id: j.lnl for j in done}


def test_fleet_driver_n_and_b_on_2x2_as_1x1():
    """-N 6 (two cycles: the second smooths in a batch) and -b 6 through
    the FleetDriver on 2x2 against 1x1: every job done, lnL rel 1e-12."""
    data = _data()
    start = _texts(data, [11])[0]
    out = {}
    for name, (s, t) in (("one", (1, 1)), ("mesh", (2, 2))):
        inst = _port(data, s, t)
        notes = []
        drv = FleetDriver(inst, start_tree=inst.tree_from_newick(start),
                          batch_cap=4, cycles=2, log=notes.append)
        done = drv.run(jobs.make_jobs("start", 6, 5)
                       + jobs.make_jobs("bootstrap", 6, 9))
        assert all(j.done and not j.failed for j in done)
        out[name] = (_lnls(done), notes)
    assert out["mesh"][0].keys() == out["one"][0].keys()
    for k, v in out["one"][0].items():
        assert out["mesh"][0][k] == pytest.approx(v, rel=1e-12), k
    assert any("2x2 likelihood fabric" in n and "t0 cpu+cpu" in n
               for n in out["mesh"][1])


def test_whole_card_lanes_over_site_shards_are_refused():
    """Whole-card lanes need the whole tree's constants on one card; an
    instance over site shards holds windows, so the driver refuses them
    (the fabric's slices are the lanes)."""
    inst = _port(_data(), 2, 1)
    for devices in (0, 2, [CPU, CPU]):
        with pytest.raises(ValueError, match="whole-card fleet lanes over "
                           "an instance of 2 site shards"):
            FleetDriver(inst, devices=devices)
    assert FleetDriver(inst).shards is None
    with pytest.raises(ValueError, match="one lane a shard"):
        from examl_tpu_torch.fleet.batch import BatchEvaluator
        BatchEvaluator(inst)


def test_a_lane_that_fails_its_probe_fails_the_fabric(monkeypatch):
    """A shard lane of slice 1 whose init probe fails fails the MeshShard's
    init, naming the mesh shape and the slice: a fabric cannot run
    without one of its site shards (whole-card lanes degrade instead)."""
    inst = _port(_data(), 2, 1)
    real = tshard._probe
    calls = []

    def probe(device):
        calls.append(device)
        if len(calls) == 4:              # slice 1, site shard 1
            raise RuntimeError("device cpu failed its probe")
        return real(device)
    monkeypatch.setattr(tshard, "_probe", probe)
    with pytest.raises(RuntimeError, match=r"mesh 2x2: tree slice 1 failed "
                       r"at init \(device cpu failed its probe\)"):
        tshard.MeshShard(inst, _fabric(2, 2))


# -- faults ------------------------------------------------------------------


class LaneFault(RuntimeError):
    pass


@pytest.mark.parametrize("where", ["launch", "smooth"])
def test_a_shard_lane_that_raises_ends_the_call(monkeypatch, where):
    """A shard lane of slice 1 that raises in its launch, or shard 1 that
    raises in smoothing's gradient pass (on the shards' threads, its peer
    waiting in the collective), ends the call with its own error within
    seconds; the next batch gives the clean rows."""
    data = _data()
    texts = _texts(data, range(4))
    inst = _port(data, 2, 2)
    ev = inst.batch_evaluator()
    clean = _rows(inst, texts)
    preps = [ev.prepare(inst.tree_from_newick(x)) for x in texts]
    if where == "launch":
        lane = ev.slices[1].lanes[1]

        def broken(*a, **kw):
            raise LaneFault("lane t1 s1 failed")
        monkeypatch.setattr(lane, "_traverse", broken)
        call = lambda: ev.eval_batch(preps)  # noqa: E731
    else:
        shard = inst.engines[4].shards[1]

        def broken(*a, **kw):
            raise LaneFault("shard 1 failed")
        monkeypatch.setattr(shard, "whole_tree_gradients", broken)
        call = lambda: ev.smooth_batch(preps, 1)  # noqa: E731
    t0 = time.perf_counter()
    with pytest.raises(LaneFault, match="failed"):
        call()
    assert time.perf_counter() - t0 < 10.0
    monkeypatch.undo()
    assert np.array_equal(_rows(inst, texts), clean)


# -- the CLI -----------------------------------------------------------------


def _table(path):
    """job id -> lnL of a results table (either package's)."""
    out = {}
    for line in open(path):
        if line.startswith("#"):
            continue
        parts = line.split()
        out[parts[0]] = float(parts[5])
    return out


def test_cli_n6_on_mesh_2x2(tmp_path, monkeypatch):
    """-N 6 --mesh 2x2 (four CPU "cards") against the port's plain -N 6
    (every job's lnL rel 1e-12 in the journal) and against the JAX CLI's
    -N 6 --mesh 2x2 (the results tables within tests/test_mesh.py's
    tolerance); the info file names the fabric and each slice's cards."""
    from examl_tpu.cli.main import main as jmain
    from examl_tpu.io.bytefile import write_bytefile as jwrite
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.io.bytefile import write_bytefile
    from tests.test_torch_shard import _journal
    names, seqs = _seqs(16, 400, 7)
    spec = [TSpec("p", "DNA", "GTR", np.arange(400))]
    aln = str(tmp_path / "a.binary")
    write_bytefile(aln, tbuild(names, seqs, spec))
    monkeypatch.setattr(tsh, "visible_devices", lambda: [CPU] * 4)
    runs = {}
    for tag, extra in (("plain", []), ("m22", ["--mesh", "2x2"])):
        wd = str(tmp_path / tag)
        assert main(["-s", aln, "-n", "X", "-w", wd, "-N", "6"] + extra,
                    device="cpu", dtype=torch.float64) == 0
        runs[tag] = (_journal(wd), _table(os.path.join(wd, "ExaML_fleet.X")),
                     open(os.path.join(wd, "ExaML_info.X")).read())
    assert runs["m22"][0].keys() == runs["plain"][0].keys()
    for k, v in runs["plain"][0].items():
        assert runs["m22"][0][k] == pytest.approx(v, rel=1e-12), k
    info = runs["m22"][2]
    assert "likelihood fabric 2x2: 2 site shard(s) x 2 tree slice(s)" in info
    assert "t0 cpu+cpu, t1 cpu+cpu" in info
    from examl_tpu.io.alignment import build_alignment_data
    from examl_tpu.io.partitions import PartitionSpec
    jaln = str(tmp_path / "j.binary")
    jwrite(jaln, build_alignment_data(names, seqs, [
        PartitionSpec("p", "DNA", "GTR", np.arange(400))]))
    wd = str(tmp_path / "jax")
    assert jmain(["-s", jaln, "-n", "X", "-w", wd, "-N", "6", "--mesh",
                  "2x2"]) == 0
    theirs = _table(os.path.join(wd, "ExaML_fleet.X"))
    ours = runs["m22"][1]
    assert ours.keys() == theirs.keys()
    for j in theirs:
        assert ours[j] == pytest.approx(
            theirs[j], abs=max(2e-4, 2 * abs(theirs[j]) * 2.0 ** -23)), j


@pytest.mark.parametrize("mode", ["bootstrap", "serve"])
def test_cli_b_and_serve_on_mesh_2x2(tmp_path, monkeypatch, mode):
    """-b 5 and --serve (an eval, a start and a bootstrap job) on --mesh
    2x2 against the same run on one card: the same jobs done, lnL rel
    1e-12."""
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.io.bytefile import write_bytefile
    data = _data()
    aln = str(tmp_path / "a.binary")
    write_bytefile(aln, data)
    start = tmp_path / "start.tree"
    start.write_text(_texts(data, [3])[0])
    jobs_file = tmp_path / "jobs.jsonl"
    jobs_file.write_text(
        '{"kind": "eval", "newick": "%s"}\n{"kind": "start"}\n'
        '{"kind": "bootstrap"}\n{"op": "stop"}\n'
        % start.read_text().strip())
    argv = ["-s", aln, "-n", "F", "-t", str(start)] + (
        ["-b", "5", "--fleet-batch", "3"] if mode == "bootstrap" else
        ["--serve", str(jobs_file), "--serve-poll", "0"])
    monkeypatch.setattr(tsh, "visible_devices", lambda: [CPU] * 4)
    tables = {}
    for tag, extra in (("one", []), ("m22", ["--mesh", "2x2"])):
        wd = str(tmp_path / tag)
        assert main(argv + ["-w", wd] + extra, device="cpu",
                    dtype=torch.float64) == 0
        tables[tag] = _table(os.path.join(wd, "ExaML_fleet.F"))
    assert tables["m22"].keys() == tables["one"].keys()
    assert len(tables["one"]) == (5 if mode == "bootstrap" else 3)
    for k, v in tables["one"].items():
        assert tables["m22"][k] == pytest.approx(v, rel=1e-12), k


# -- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_mesh_2x2_shares_the_card_bitwise():
    """2x2 of cuda:0 four times (f32): each batch's rows bit for bit the
    2x1 evaluate of its trees, B1 launched once a lane (four a batch),
    each lane on a stream of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    from examl_tpu_torch.ops import newview_chunk
    dev = torch.device("cuda", 0)
    data = _data("one", 40, 2048, 4)
    texts = _texts(data, range(6))
    inst = PhyloInstance(data, dtype=torch.float32, device=dev,
                         sharding=_fabric(2, 2, [dev] * 4))
    ev = inst.batch_evaluator()
    preps = [ev.prepare(inst.tree_from_newick(x)) for x in texts]
    b1 = newview_chunk.LAUNCHES
    rows = ev.eval_batch(preps)
    assert newview_chunk.LAUNCHES - b1 == 4
    assert np.array_equal(rows, _evals(inst, texts))
    streams = [lane.stream for s in ev.slices for lane in s.lanes]
    assert None not in streams and len({id(x) for x in streams}) == 4
