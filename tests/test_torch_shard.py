"""The fleet's tree axis in the port (examl_tpu_torch/fleet/shard.py, the
fabric records of parallel/sharding.py, the mesh flags of
parallel/launch.py and the CLI) against its own single lane and against
the JAX package (float64 on the CPU).

Lanes are built from Python with an explicit device list: on the CPU
`devices=[cpu] * k`, k lanes that share the host, each with its own
evaluator, constants, ready flags and wave-scan arena.

* lanes against the single lane and the one-at-a-time evaluate, bit for
  bit, under GAMMA and PSR; against the JAX package's
  `FleetDriver(devices=0)` on the test conftest's 8 virtual devices,
  rtol 1e-10; a lane whose init raises degrades the set;
* `MeshShard` on a `1x2` fabric against the plain `BatchEvaluator`, bit
  for bit, with its slice counters and the mesh gauges, and the lease
  records' mesh;
* `parse_mesh_spec`, the device budget, the shape properties,
  `declared_specs` and the bank's `_declared_mesh` equal to JAX's;
* every CLI refusal of the mesh flags, exit code and message as the JAX
  CLI's; the SEV x `1x2` backstop; `-R` of a fleet on two lanes;
* on the card only (`@pytest.mark.cuda`): two lanes and a `1x2` fabric
  that share cuda:0 against one lane, bit for bit.

The JAX package is imported inside the tests that use it (the card's
machine, which runs the card cases with --noconftest, has no JAX).
"""

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet import jobs, lease
from examl_tpu_torch.fleet import shard as tshard
from examl_tpu_torch.fleet.batch import BatchEvaluator
from examl_tpu_torch.fleet.driver import FleetDriver
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data as tbuild
from examl_tpu_torch.io.partitions import PartitionSpec as TSpec
from examl_tpu_torch.parallel import sharding as tsh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (the suite runs on several xdist workers), both
    packages on their default smoothing route."""
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    monkeypatch.delenv("EXAML_MESH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(ntaxa, nsites, seed):
    """tests/conftest.py's correlated_dna walk, as names and sequences."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < 0.15
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _data(ntaxa=8, nsites=120, seed=4):
    names, seqs = _seqs(ntaxa, nsites, seed)
    return tbuild(names, seqs, [TSpec("p", "DNA", "GTR",
                                      np.arange(nsites))])


def _port(data, **kw):
    return PhyloInstance(data, dtype=torch.float64, device=kw.pop(
        "device", "cpu"), **kw)


def _lnls(out):
    return {j.job_id: j.lnl for j in out}


def _flags(ev) -> list:
    """Every Ready of an evaluator's launches (its slices' for a
    MeshShard)."""
    return [r for lane in getattr(ev, "slices", [ev])
            for r in lane._ready.values()]


def _J():
    from examl_tpu.fleet import driver, jobs
    from examl_tpu.instance import PhyloInstance
    from examl_tpu.io.alignment import build_alignment_data
    from examl_tpu.io.partitions import PartitionSpec
    import jax.numpy as jnp
    return SimpleNamespace(**locals())


# -- lanes -------------------------------------------------------------------


def test_lanes_bitwise_as_one_lane_and_alone():
    """Ten start jobs on three lanes at most three a batch (a round of
    three batches, then the tail on the primary): every job's lnL equal to
    the single lane's and to its one-at-a-time evaluate; each lane
    dispatched, on its own ready flags."""
    data = _data()
    anchor_inst = _port(data)
    anchor = {}
    for j in jobs.make_jobs("start", 10, 7):
        anchor[j.job_id] = anchor_inst.evaluate(
            anchor_inst.random_tree(seed=j.seed), full=True)
    single = _lnls(FleetDriver(_port(data), batch_cap=4).run(
        jobs.make_jobs("start", 10, 7)))
    obs.reset()
    drv = FleetDriver(_port(data), batch_cap=3, devices=[CPU] * 3)
    assert drv.shards is not None and len(drv.shards) == 3
    lanes = _lnls(drv.run(jobs.make_jobs("start", 10, 7)))
    assert lanes == single == anchor
    snap = obs.snapshot()
    c, g = snap["counters"], snap["gauges"]
    assert g["fleet.devices"] == 3
    assert [c.get(f"fleet.device_dispatches.d{k}", 0) for k in range(3)] \
        == [2, 1, 1]
    assert [c.get(f"fleet.device_jobs.d{k}", 0) for k in range(3)] \
        == [4, 3, 3]
    flags = [id(r) for s in drv.shards.shards for r in _flags(s)]
    assert len(flags) == len(set(flags))


def test_lanes_bitwise_psr():
    """PSR batches run on the wave-scan tier, each lane on an arena of its
    own: per-job lnL bit for bit across lanes, never the engine's arena."""
    data = _data(6, 90, 2)
    single = _lnls(FleetDriver(_port(data, rate_model="PSR"),
                               batch_cap=3).run(jobs.make_jobs("start", 6,
                                                               5)))
    inst = _port(data, rate_model="PSR")
    (eng,) = inst.engines.values()
    before = eng.clv.clone()
    drv = FleetDriver(inst, batch_cap=3, devices=[CPU, CPU])
    assert _lnls(drv.run(jobs.make_jobs("start", 6, 5))) == single
    assert torch.equal(eng.clv, before)
    ref = _port(data, rate_model="PSR")
    for j in jobs.make_jobs("start", 6, 5):
        assert single[j.job_id] == ref.evaluate(ref.random_tree(j.seed),
                                                full=True)


def test_lanes_against_jax_fleet_over_devices():
    """The port's lanes against the JAX package's FleetDriver(devices=0)
    over the conftest's 8 virtual devices, per job, rtol 1e-10."""
    J = _J()
    names, seqs = _seqs(8, 120, 4)
    jinst = J.PhyloInstance(J.build_alignment_data(names, seqs, [
        J.PartitionSpec("p", "DNA", "GTR", np.arange(120))]),
        dtype=J.jnp.float64)
    jdrv = J.driver.FleetDriver(jinst, batch_cap=4, devices=0)
    assert jdrv.shards is not None and len(jdrv.shards) >= 2
    jout = _lnls(jdrv.run(J.jobs.make_jobs("start", 10, 7)))
    out = _lnls(FleetDriver(_port(_data()), batch_cap=4,
                            devices=[CPU] * 4).run(
        jobs.make_jobs("start", 10, 7)))
    assert out.keys() == jout.keys()
    np.testing.assert_allclose([out[k] for k in sorted(out)],
                               [jout[k] for k in sorted(out)], rtol=1e-10)


def test_lane_init_fault_degrades_the_set(monkeypatch):
    """A device whose lane fails INIT degrades the set (the counter and
    the surviving lanes), never aborts."""
    inst = _port(_data(6, 90, 2))
    primary = inst.batch_evaluator()
    real_init = tshard.DeviceShard.__init__
    calls = []

    def flaky_init(self, inst_, device, index, log=None):
        calls.append(index)
        if index == 2:
            raise RuntimeError("device 2 is toast")
        return real_init(self, inst_, device, index, log=log)

    monkeypatch.setattr(tshard.DeviceShard, "__init__", flaky_init)
    d0 = obs.counter("fleet.device_degraded")
    notes = []
    ss = tshard.ShardSet(inst, primary, devices=[CPU] * 4, log=notes.append)
    assert obs.counter("fleet.device_degraded") == d0 + 1
    assert len(ss) == 3 and calls == [1, 2, 3]
    assert any("degraded at init (device 2 is toast)" in n for n in notes)
    assert ss.shard_for(("weights",), 2) is primary
    assert ss.shard_for(("fast",), 2) is ss.shards[2]


def test_lane_constants_and_streams_are_its_own():
    """A DeviceShard reads every engine constant through `_const` (its
    copies), and its PendingBatch is collected as the plain evaluator's
    rows; on the CPU there is no stream and no event."""
    inst = _port(_data())
    lane = tshard.DeviceShard(inst, CPU, 1)
    (eng,) = inst.engines.values()
    for name in tshard._CONST_NAMES:
        assert (lane._const(eng, name) is None) == (getattr(eng, name)
                                                     is None)
    preps = [lane.prepare(inst.random_tree(s)) for s in (1, 2, 3)]
    pending = lane.launch_eval(preps)
    assert pending.done is None and lane.stream is None
    plain = BatchEvaluator(inst)
    assert np.array_equal(lane.collect(pending), plain.eval_batch(
        [plain.prepare(inst.random_tree(s)) for s in (1, 2, 3)]))


# -- the 1xT fabric ------------------------------------------------------------


def _fabric(s, t, devices=None):
    return tsh.fabric_sharding(tsh.make_fabric_mesh(
        s, t, devices if devices is not None else [CPU] * (s * t)))


def test_mesh_shard_bitwise_with_slice_counters():
    """A 1x2 fabric's MeshShard cuts each batch into two slices of
    ceil(J / 2) jobs: rows bit for bit as the plain BatchEvaluator's,
    the slice counters and the mesh gauges as the JAX package names
    them."""
    data = _data(12, 300, 7)
    plain = _port(data)
    ev1 = plain.batch_evaluator()
    obs.reset()
    inst = _port(data, sharding=_fabric(1, 2))
    ev = inst.batch_evaluator()
    assert isinstance(ev, tshard.MeshShard)
    assert ev.site_shards == 1 and ev.tree_shards == 2
    for n in (5, 1):
        trees = [s for s in range(n)]
        out = ev.eval_batch([ev.prepare(inst.random_tree(s)) for s in trees])
        ref = ev1.eval_batch([ev1.prepare(plain.random_tree(s))
                              for s in trees])
        assert np.array_equal(out, ref)
    snap = obs.snapshot()
    g, c = snap["gauges"], snap["counters"]
    assert g["engine.mesh_site_shards"] == 1
    assert g["engine.mesh_tree_shards"] == 2
    assert g["fleet.mesh_tree_shards"] == 2
    assert c["fleet.mesh_batches"] == 2
    assert c["fleet.mesh_slice_dispatches.t0"] == 2
    assert c["fleet.mesh_slice_dispatches.t1"] == 1
    assert c["fleet.mesh_slice_jobs.t0"] == 3 + 1
    assert c["fleet.mesh_slice_jobs.t1"] == 2
    flags = [id(r) for r in _flags(ev)]
    assert len(flags) == len(set(flags)) == 2


def test_mesh_fleet_and_lease_records_name_the_fabric(tmp_path):
    """The driver on a 1x2 fabric: one mesh lane, results equal to the
    plain fleet, and a leased rank's records carry the mesh shape."""
    data = _data()
    want = _lnls(FleetDriver(_port(data), batch_cap=4).run(
        jobs.make_jobs("start", 6, 3)))
    board = lease.LeaseBoard(str(tmp_path / "leases"), rank=0, ttl_s=30.0)
    notes = []
    drv = FleetDriver(_port(data, sharding=_fabric(1, 2)), batch_cap=4,
                      leases=board, log=notes.append)
    assert board.mesh == "1x2"
    assert board._record("x")["mesh"] == "1x2"
    assert _lnls(drv.run(jobs.make_jobs("start", 6, 3))) == want
    assert any("1x2 likelihood fabric" in n for n in notes)
    assert obs.counter("fleet.mesh_batches") >= 2


def test_mesh_spec_budget_and_shapes_as_jax():
    from examl_tpu.parallel import sharding as jsh
    assert tsh.parse_mesh_spec("2x2") == (2, 2)
    assert tsh.parse_mesh_spec(" 4X1 ") == (4, 1)
    for bad in ("2", "2x2x2", "0x2", "2x-1", "axb"):
        with pytest.raises(ValueError) as te:
            tsh.parse_mesh_spec(bad)
        with pytest.raises(ValueError) as je:
            jsh.parse_mesh_spec(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="needs 16 devices"):
        tsh.make_fabric_mesh(4, 4, [CPU] * 8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        jsh.make_fabric_mesh(4, 4)
    sh = _fabric(2, 2)
    assert sh.is_fabric and sh.site_shards == 2 and sh.tree_shards == 2
    assert sh.num_devices == 2
    one_d = tsh.site_sharding(tsh.make_mesh([CPU] * 8, n_devices=4))
    assert not one_d.is_fabric
    assert one_d.tree_shards == 1 and one_d.num_devices == 4
    # Lanes may share a device: only the Python API builds such a mesh.
    shared = tsh.make_fabric_mesh(1, 2, [CPU, CPU])
    assert list(shared.devices[0]) == [CPU, CPU]


def test_declared_specs_equal_jax():
    """The declared-sharding record is JSON-equal to the JAX package's,
    from a live fabric and device-free, and a 1-D mesh declares no fleet
    leaves."""
    from examl_tpu.parallel import sharding as jsh
    live = tsh.declared_specs(_fabric(2, 2))
    assert live == tsh.declared_fabric_specs(2, 2)
    jlive = jsh.declared_specs(jsh.fabric_sharding(jsh.make_fabric_mesh(2,
                                                                       2)))
    assert json.dumps(live, sort_keys=True) == json.dumps(jlive,
                                                          sort_keys=True)
    for s, t in ((1, 2), (4, 2), (2, 1)):
        assert json.dumps(tsh.declared_fabric_specs(s, t)) == json.dumps(
            jsh.declared_fabric_specs(s, t))
    one_d = tsh.declared_specs(tsh.site_sharding(tsh.make_mesh([CPU] * 4)))
    jone = jsh.declared_specs(jsh.default_site_sharding(4))
    assert one_d == jone and one_d["tree_shards"] == 1
    assert "fleet_jobs" not in one_d["leaf_specs"]


def test_bank_declared_mesh_equals_jax(monkeypatch):
    from examl_tpu.ops.bank import _declared_mesh as jdecl
    from examl_tpu_torch.ops.bank import _declared_mesh as tdecl
    ns = lambda m: argparse.Namespace(mesh=m)  # noqa: E731
    for env in (None, "4x2"):
        if env is None:
            monkeypatch.delenv("EXAML_MESH", raising=False)
        else:
            monkeypatch.setenv("EXAML_MESH", env)
        for spec in (None, "1x1", "bogus", "2x2", "2x1", "1x2"):
            assert tdecl(ns(spec)) == jdecl(ns(spec)), (env, spec)
    monkeypatch.setenv("EXAML_MESH", "4x2")
    assert tdecl(ns(None)) == tsh.declared_fabric_specs(4, 2)
    monkeypatch.delenv("EXAML_MESH")
    assert tdecl(ns(None)) is None and tdecl(ns("1x1")) is None


def test_select_sharding(monkeypatch):
    """None for one card (no mesh, 1x1, --single-device); a mesh the
    visible cards cannot hold raises with the device arithmetic, SxT with
    S > 1 and T > 1 (a fleet over site shards) as any other; over four
    cards 2x2 is the (sites, tree) fabric of the first four."""
    from examl_tpu_torch.parallel import launch
    ns = lambda **kw: argparse.Namespace(**dict(  # noqa: E731
        dict(mesh=None, single_device=False), **kw))
    if torch.cuda.device_count() < 2:
        assert launch.select_sharding(ns()) is None
    assert launch.select_sharding(ns(), device="cpu") is None
    assert launch.select_sharding(ns(mesh="1x1")) is None
    assert launch.select_sharding(ns(mesh="1x2", single_device=True)) is None
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices"):
            launch.select_sharding(ns(mesh="2x2"))
    if torch.cuda.device_count() < 2:
        for spec in ("1x2", "2x1"):
            with pytest.raises(ValueError, match="needs 2 devices"):
                launch.select_sharding(ns(mesh=spec))
    cards = [CPU] * 4
    monkeypatch.setattr(tsh, "visible_devices", lambda: cards)
    sh = launch.select_sharding(ns(mesh="2x2"))
    assert sh.is_fabric and (sh.site_shards, sh.tree_shards) == (2, 2)
    assert [sh.slice_devices(k) for k in (0, 1)] == [cards[:2], cards[:2]]


# -- the CLI --------------------------------------------------------------------


def _refusal(main, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        main(argv)
    err = capsys.readouterr().err.strip().splitlines()
    return ei.value.code, err[-1].split("error: ", 1)[-1]


@pytest.mark.parametrize("extra", [
    ["--mesh", "2"],                                   # malformed spec
    ["--mesh", "2x2", "--single-device", "-N", "4"],
    ["--mesh", "1x2"],                                 # T>1, no fleet mode
    ["--mesh", "2x2", "-S", "-N", "4"],                # SEV x T>1
    ["--mesh", "2x2", "-N", "4", "--fleet-devices", "2"],
    ["-S", "-N", "4"],                                 # names (S=1, T=J)
    ["-N", "4", "--fleet-devices", "-1"],
])
def test_cli_mesh_refusals_as_jax(tmp_path, capsys, extra):
    """Every mesh refusal fires at argument time (exit 2, before the
    dummy -s path is read), with the JAX CLI's message."""
    from examl_tpu.cli.main import main as jmain
    from examl_tpu_torch.cli.main import main as tmain
    base = ["-s", str(tmp_path / "missing.binary"), "-n", "X",
            "-w", str(tmp_path)]
    tcode, tmsg = _refusal(tmain, base + extra, capsys)
    jcode, jmsg = _refusal(jmain, base + extra, capsys)
    assert tcode == jcode == 2
    assert tmsg == jmsg
    if extra == ["-S", "-N", "4"]:
        assert "(S=1, T=J)" in tmsg
    if "-S" in extra and "--mesh" in extra:
        assert "2x2" in tmsg and "-S" in tmsg


def _aln(tmp_path, ntaxa=8, width=200, seed=11):
    from examl_tpu_torch.io.bytefile import write_bytefile
    names, seqs = _seqs(ntaxa, width, seed)
    path = str(tmp_path / "aln.binary")
    write_bytefile(path, tbuild(names, seqs, [TSpec("p", "DNA", "GTR",
                                                    np.arange(width))]))
    return path


def _journal(workdir):
    out = {}
    for line in open(os.path.join(workdir, "ExaML_fleetJournal.X")):
        rec = json.loads(line)
        out[rec["job_id"]] = rec["lnl"]
    return out


def test_cli_mesh_runs_and_refuses_what_the_cards_cannot_hold(tmp_path,
                                                               capsys):
    """--mesh 1x1 is the single-device run; --mesh 1x2 and --mesh 2x1
    without two cards log the device arithmetic and return 1, and so do
    the fleet modes on a mesh with S > 1 (a fleet over site shards: no
    argument-time refusal, as in the JAX CLI)."""
    from examl_tpu_torch.cli.main import main
    aln = _aln(tmp_path)
    runs = {}
    for name, extra in (("plain", []), ("m11", ["--mesh", "1x1"])):
        wd = str(tmp_path / name)
        assert main(["-s", aln, "-n", "X", "-w", wd, "-N", "3"] + extra,
                    device="cpu") == 0
        runs[name] = _journal(wd)
    assert runs["plain"] == runs["m11"]
    wd = str(tmp_path / "refused")
    assert main(["-s", aln, "-n", "X", "-w", wd, "-N", "3", "--mesh",
                 "1x2"], device="cpu") == 1
    info = open(os.path.join(wd, "ExaML_info.X")).read()
    assert "ERROR: mesh 1x2 needs 2 devices" in info
    if torch.cuda.device_count() < 2:
        wd = str(tmp_path / "refused21")
        assert main(["-s", aln, "-n", "X", "-w", wd, "--mesh", "2x1"],
                    device="cpu") == 1
        info = open(os.path.join(wd, "ExaML_info.X")).read()
        assert "ERROR: mesh 2x1 needs 2 devices" in info
    for k, (extra, need) in enumerate((
            (["-N", "3", "--mesh", "2x1"], 2),
            (["--serve", wd + "/jobs.jsonl", "--mesh", "4x1"], 4))):
        if torch.cuda.device_count() >= need:
            continue
        wd_k = str(tmp_path / f"fleet{k}")
        assert main(["-s", aln, "-n", "X", "-w", wd_k] + extra,
                    device="cpu") == 1
        info = open(os.path.join(wd_k, "ExaML_info.X")).read()
        assert f"ERROR: mesh {extra[-1]} needs {need} devices" in info


def test_fleet_restart_on_two_lanes_resumes_bit_for_bit(tmp_path,
                                                        monkeypatch):
    """-N 6 --fleet-batch 2 on two lanes, stopped after its first
    checkpoint (one round: two batches), then -R on two lanes: every job
    as in an uninterrupted one-lane run, bit for bit, and the resumed run
    dispatches only what was pending."""
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.fleet import driver
    aln = _aln(tmp_path)
    argv = ["-s", aln, "-n", "X", "-N", "6", "--fleet-batch", "2"]
    ref = str(tmp_path / "ref")
    assert main(argv + ["-w", ref], device="cpu") == 0
    orig_init = driver.FleetDriver.__init__

    def two_lanes(self, inst, **kw):
        orig_init(self, inst, **dict(kw, devices=[CPU, CPU]))

    monkeypatch.setattr(driver.FleetDriver, "__init__", two_lanes)
    orig_ckpt = driver.FleetDriver._checkpoint

    class Stop(Exception):
        pass

    def stop_after_first(self):
        orig_ckpt(self)
        raise Stop()

    wd = str(tmp_path / "lanes")
    monkeypatch.setattr(driver.FleetDriver, "_checkpoint", stop_after_first)
    with pytest.raises(Stop):
        main(argv + ["-w", wd], device="cpu")
    assert len(_journal(wd)) == 4            # one round of two lanes
    monkeypatch.setattr(driver.FleetDriver, "_checkpoint", orig_ckpt)
    obs_before = []
    orig_round = driver.FleetDriver._dispatch_round

    def count_round(self, assignments):
        obs_before.append(sum(len(b) for _, b in assignments))
        return orig_round(self, assignments)

    monkeypatch.setattr(driver.FleetDriver, "_dispatch_round", count_round)
    assert main(argv + ["-w", wd, "-R"], device="cpu") == 0
    info = open(os.path.join(wd, "ExaML_info.X")).read()
    assert "resumed job table — 4 of 6 jobs already done" in info
    assert obs_before == [2]
    assert _journal(wd) == _journal(ref)


def test_sev_fabric_engine_guard():
    """Callers from Python hit the engines' backstop: SEV pools cannot
    stack per-job arenas along a tree axis, on 1xT as on SxT (each site
    shard's engine raises it); Sx1 composes with -S (a pool region per
    site shard), as 1x1 does, and neither has a batched tier."""
    data = _data(12, 300, 7)
    with pytest.raises(ValueError, match="1x2 fabric"):
        _port(data, save_memory=True, sharding=_fabric(1, 2))
    with pytest.raises(ValueError, match="-S cannot compose with a 2x2 "
                       "fabric"):
        _port(data, save_memory=True, sharding=_fabric(2, 2))
    sharded = _port(data, save_memory=True, sharding=_fabric(2, 1))
    ref = _port(data, save_memory=True)
    assert sharded.evaluate(sharded.random_tree(seed=3), full=True) == \
        pytest.approx(ref.evaluate(ref.random_tree(seed=3), full=True),
                      rel=1e-12)
    assert sharded.batch_evaluator() is None
    inst = _port(data, save_memory=True, sharding=_fabric(1, 1))
    ref = _port(data, save_memory=True)
    assert inst.evaluate(inst.random_tree(seed=3), full=True) == \
        ref.evaluate(ref.random_tree(seed=3), full=True)
    assert inst.batch_evaluator() is None


# -- on the card -----------------------------------------------------------------


def _card_data():
    return _data(40, 2048, 4)


@pytest.mark.cuda
def test_cuda_two_lanes_share_the_card_bitwise():
    """Two lanes on cuda:0 (each its own stream and ready flags, launched
    before either is collected) give every job's lnL as one lane does,
    bit for bit, and launch B1 once per lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    from examl_tpu_torch.ops import newview_chunk
    dev = torch.device("cuda", 0)
    data = _card_data()
    inst = PhyloInstance(data, dtype=torch.float32, device=dev)
    single = _lnls(FleetDriver(inst, batch_cap=4).run(
        jobs.make_jobs("start", 8, 7)))
    inst = PhyloInstance(data, dtype=torch.float32, device=dev)
    drv = FleetDriver(inst, batch_cap=4, devices=[dev, dev])
    b1 = newview_chunk.LAUNCHES
    assert _lnls(drv.run(jobs.make_jobs("start", 8, 7))) == single
    assert newview_chunk.LAUNCHES - b1 == 2
    assert {s.stream for s in drv.shards.shards} != {None}
    assert len({id(s.stream) for s in drv.shards.shards}) == 2


@pytest.mark.cuda
def test_cuda_mesh_1x2_shares_the_card_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    dev = torch.device("cuda", 0)
    data = _card_data()
    plain = PhyloInstance(data, dtype=torch.float32, device=dev)
    ev1 = plain.batch_evaluator()
    inst = PhyloInstance(data, dtype=torch.float32, device=dev,
                         sharding=_fabric(1, 2, [dev, dev]))
    ev = inst.batch_evaluator()
    assert isinstance(ev, tshard.MeshShard)
    trees = range(6)
    assert np.array_equal(
        ev.eval_batch([ev.prepare(inst.random_tree(s)) for s in trees]),
        ev1.eval_batch([ev1.prepare(plain.random_tree(s)) for s in trees]))
