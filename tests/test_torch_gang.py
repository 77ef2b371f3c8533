"""The gang checkpoint (the two-phase commit of
examl_tpu_torch/search/checkpoint.py) and `--launch N`, on the CPU in f64.

* The port of tests/test_gang.py's two-phase cases: stage files are
  invisible to the supervisor's checkpoint glob; a cycle publishes only
  when every rank has staged; a stale attempt's marker never completes a
  cycle; a partial cycle is collected and the restore falls back; the
  `checkpoint.publish` seam fires between staging and the rename;
* a gang checkpoint that the port's managers staged and published
  (gang_size 2) restores in the JAX package's CheckpointManager with lnL
  at rtol 1e-10, and the other way round; `gang_paths`/`gang_ages` equal
  JAX's;
* end to end through the child-command hook, on tests/test_torch_cli.py's
  8-taxon alignment, `-f e`: `--launch 2` as a real gloo gang with rank 1
  killed as it writes the second tree's checkpoint (after the first
  tree's coordinated one): the supervisor blames rank 1 (not rank 0,
  which gloo fails right after), restarts the gang from the published
  cycle, and the run ends at the one-process lnLs (rtol 1e-10; the site
  sums of two ranks add in another order); `--launch-emulate` (two
  independent ranks) publishes its cycles and ends there too.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.resilience import exitcause, faults, heartbeat
from examl_tpu_torch.resilience import supervisor as sup
from examl_tpu_torch.search.checkpoint import CheckpointManager
from tests.test_torch_checkpoint import PARAMS, _jax, _port


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (faults.ENV_VAR, faults.ATTEMPT_VAR, heartbeat.GANG_VAR):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    obs.reset()
    yield
    faults.reset()
    obs.reset()
    torch.set_num_threads(n)


def _gang_pair(tmp_path, run_id="TP"):
    from examl_tpu_torch.transfer import install_model_params
    inst = _port()
    install_model_params(inst, PARAMS)
    tree = inst.random_tree(seed=0)
    inst.evaluate(tree, full=True)
    mgr0 = CheckpointManager(str(tmp_path), run_id, gang_rank=0,
                             gang_size=2, log=lambda m: None)
    mgr1 = CheckpointManager(str(tmp_path), run_id, gang_rank=1,
                             gang_size=2, log=lambda m: None)
    return inst, tree, mgr0, mgr1


def _restore(tmp_path, run_id="TP"):
    inst = _port()
    return CheckpointManager(str(tmp_path), run_id,
                             log=lambda m: None).restore(
        inst, inst.random_tree(seed=9)), inst


def test_stage_files_invisible_to_supervisor_glob(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "XY", gang_rank=0, gang_size=2)
    for p in (mgr._stage_blob(0), mgr._stage_marker(0, 0),
              mgr._stage_marker(0, 1)):
        open(p, "w").write("x")
    assert sup.checkpoint_glob(str(tmp_path), "XY") == []
    assert mgr.latest_path() is None
    open(mgr.path_for(0), "w").write("x")
    assert sup.checkpoint_glob(str(tmp_path), "XY") == [mgr.path_for(0)]
    assert mgr.latest_path() == mgr.path_for(0)


def test_two_phase_publishes_only_when_all_ranks_staged(tmp_path):
    inst, tree, mgr0, mgr1 = _gang_pair(tmp_path)
    mgr0.write("FAST_SPRS", {"mark": 0}, inst, tree)
    assert not os.path.exists(mgr0.path_for(0))      # rank 1 not staged
    assert os.path.exists(mgr0._stage_blob(0))
    assert os.path.exists(mgr0._stage_marker(0, 0))
    mgr1.callback(inst, tree)("FAST_SPRS", {"mark": 0})   # the last rank
    assert os.path.exists(mgr0.path_for(0))          # ... publishes
    assert not glob.glob(mgr0._stage_pattern())      # markers swept
    assert obs.counter("checkpoint.gang_publishes") == 1
    resume, inst2 = _restore(tmp_path)
    assert resume["extras"]["mark"] == 0
    assert inst2.likelihood == inst.likelihood


def test_two_phase_partial_cycle_gc_falls_back(tmp_path):
    inst, tree, mgr0, mgr1 = _gang_pair(tmp_path)
    mgr0.write("FAST_SPRS", {"mark": 0}, inst, tree)
    mgr1.write("FAST_SPRS", {"mark": 0}, inst, tree)   # cycle 0 publishes
    mgr0.write("FAST_SPRS", {"mark": 1}, inst, tree)   # cycle 1: rank 0
    assert not os.path.exists(mgr0.path_for(1))        # only; gang dies
    resume, _ = _restore(tmp_path)
    assert resume["extras"]["mark"] == 0               # complete cycle
    assert obs.counter("checkpoint.partial_cycles_gced") == 1
    assert not glob.glob(mgr0._stage_pattern())        # leftovers gone


def test_two_phase_stale_attempt_markers_never_complete_a_cycle(
        tmp_path, monkeypatch):
    inst, tree, mgr0, mgr1 = _gang_pair(tmp_path)
    mgr1.write("FAST_SPRS", {"mark": 0}, inst, tree)   # attempt-0 marker
    monkeypatch.setenv(faults.ATTEMPT_VAR, "1")        # gang restarted
    mgr0.write("FAST_SPRS", {"mark": 0}, inst, tree)
    assert not os.path.exists(mgr0.path_for(0))        # NOT published
    mgr1b = CheckpointManager(str(tmp_path), "TP", gang_rank=1, gang_size=2)
    mgr1b.write("FAST_SPRS", {"mark": 0}, inst, tree)  # new attempt's rank 1
    assert os.path.exists(mgr0.path_for(0))


def test_checkpoint_publish_fault_seam(tmp_path, monkeypatch):
    inst, tree, mgr0, mgr1 = _gang_pair(tmp_path)
    mgr0.write("FAST_SPRS", {"mark": 0}, inst, tree)
    monkeypatch.setenv(faults.ENV_VAR, "checkpoint.publish:after=1")
    faults.reset()
    with pytest.raises(faults.FaultInjected):
        mgr1.write("FAST_SPRS", {"mark": 0}, inst, tree)
    assert not os.path.exists(mgr0.path_for(0))        # never published
    assert os.path.exists(mgr0._stage_blob(0))         # staged, stranded
    assert obs.counter("faults.fired.checkpoint.publish") == 1
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    resume, _ = _restore(tmp_path)
    assert resume is None                              # GC'd, nothing left
    assert not glob.glob(mgr0._stage_pattern())


def test_restore_gives_back_the_model_bit_for_bit(tmp_path):
    """A model whose frequencies move by an ulp when normalized again (a
    second normalization is not exact) comes back from its checkpoint
    unchanged, eigensystem and all, and so does the next tree's lnL."""
    from examl_tpu_torch.models.gtr import sanitize_freqs
    from examl_tpu_torch.transfer import install_model_params
    rng = np.random.default_rng(5)
    freqs = next(f for f in (rng.dirichlet(np.ones(4) * 3)
                             for _ in range(1000))
                 if not np.array_equal(sanitize_freqs(f),
                                       sanitize_freqs(sanitize_freqs(f))))
    inst = _port()
    install_model_params(inst, [(PARAMS[0][0], freqs, 0.6), PARAMS[1]])
    tree = inst.random_tree(seed=1)
    inst.evaluate(tree, full=True)
    CheckpointManager(str(tmp_path), "B").write("MOD_OPT", {}, inst, tree)
    other = _port()
    CheckpointManager(str(tmp_path), "B").restore(other,
                                                  other.random_tree(seed=2))
    for m, r in zip(inst.models, other.models):
        for field in ("rates", "freqs", "gamma_rates", "eign", "ev", "ei"):
            assert np.array_equal(getattr(m, field), getattr(r, field))
    nxt = (inst.random_tree(seed=3), other.random_tree(seed=3))
    assert inst.evaluate(nxt[0], full=True) == \
        other.evaluate(nxt[1], full=True)


def test_gang_paths_and_ages_equal_jax(tmp_path):
    from examl_tpu.resilience import heartbeat as jhb
    base = str(tmp_path / ".heartbeat.T.json")
    assert heartbeat.gang_paths(base, 3) == jhb.gang_paths(base, 3)
    open(heartbeat.rank_path(base, 1), "w").write("{}")
    ages, jages = heartbeat.gang_ages(base, 3), jhb.gang_ages(base, 3)
    assert ages[0] is None and ages[2] is None and jages[0] is None
    assert abs(ages[1] - jages[1]) < 5.0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gang_checkpoint_restores_across_packages(tmp_path, monkeypatch,
                                                  writer):
    """Two ranks' managers of one package stage and publish a cycle (the
    fingerprint records the gang's world size, EXAML_GANG_RANKS=2); the
    other package's single-process manager restores it: an elastic
    restore, nprocs 2 -> 1."""
    from examl_tpu.models.gtr import build_model as jbuild_model
    from examl_tpu.search import checkpoint as jcheckpoint
    from examl_tpu.search.snapshots import topology_key as jkey
    from examl_tpu_torch.search.snapshots import topology_key
    from examl_tpu_torch.transfer import install_model_params
    monkeypatch.setenv(heartbeat.GANG_VAR, "2")
    if writer == "port":
        inst, tree, mgr0, mgr1 = _gang_pair(tmp_path, "run")
        w_lnl, w_key = inst.likelihood, topology_key(tree)
    else:
        jinst = _jax()
        for gid, (rates, freqs, alpha) in enumerate(PARAMS):
            jinst.models[gid] = jbuild_model(
                jinst.alignment.partitions[gid].datatype,
                np.asarray(freqs), rates=np.asarray(rates), alpha=alpha)
        jinst.push_models()
        tree = jinst.random_tree(seed=0)
        jinst.evaluate(tree, full=True)
        inst, w_lnl, w_key = jinst, jinst.likelihood, jkey(tree)
        mgr0, mgr1 = (jcheckpoint.CheckpointManager(
            str(tmp_path), "run", gang_rank=k, gang_size=2) for k in (0, 1))
    mgr0.write("SLOW_SPRS", {"mark": 3}, inst, tree)
    assert not sup.checkpoint_glob(str(tmp_path), "run")
    mgr1.write("SLOW_SPRS", {"mark": 3}, inst, tree)
    assert len(sup.checkpoint_glob(str(tmp_path), "run")) == 1
    monkeypatch.delenv(heartbeat.GANG_VAR)
    if writer == "port":
        rinst = _jax()
        rtree = rinst.random_tree(seed=8)
        resume = jcheckpoint.CheckpointManager(
            str(tmp_path), "run").restore(rinst, rtree)
        r_key = jkey(rtree)
    else:
        rinst = _port()
        install_model_params(rinst, PARAMS)
        rtree = rinst.random_tree(seed=8)
        resume = CheckpointManager(str(tmp_path), "run").restore(
            rinst, rtree)
        r_key = topology_key(rtree)
    assert resume == {"state": "SLOW_SPRS", "extras": {"mark": 3}}
    assert r_key == w_key
    assert rinst.likelihood == pytest.approx(w_lnl, rel=1e-10)


# -- --launch 2 end to end ----------------------------------------------------


@pytest.mark.parametrize("mode", ["gloo", "emulated"])
def test_launch_gang_restarts_from_the_coordinated_cycle(tmp_path, mode):
    from tests.test_torch_supervisor import CHILD, _final_lnls
    from examl_tpu_torch.cli.main import build_argparser, main
    from tests.test_torch_cli import _inputs
    aln, trees = _inputs(tmp_path)
    assert main(["-s", aln, "-t", trees, "-n", "T", "-w",
                 str(tmp_path / "one"), "-f", "e"], device="cpu") == 0
    out = tmp_path / "gang"
    argv = ["-s", aln, "-t", trees, "-n", "T", "-w", str(out), "-f", "e",
            "--launch", "2", "--supervise-backoff", "0.05",
            "--supervise-stall", "120", "--metrics", str(out / "m.json")]
    if mode == "emulated":
        # Independent ranks (no process group): both run the whole
        # search, stage every cycle, and the cycles publish.
        argv.append("--launch-emulate")
    else:
        argv += ["--inject-fault",
                 "checkpoint.write@rank=1:after=2:signal=KILL"]
    t0 = time.time()
    rc = sup.launch_gang(argv, build_argparser().parse_args(argv),
                         log=lambda m: None, child_cmd=CHILD)
    assert rc == 0 and time.time() - t0 < 300
    snap = json.loads((out / "m.json").read_text())
    att = snap["resilience"]["attempts"]
    np.testing.assert_allclose(_final_lnls(out),
                               _final_lnls(tmp_path / "one"), rtol=1e-10)
    assert not glob.glob(str(out / "*.stage.*"))
    if mode == "emulated":
        assert [a["cause"] for a in att] == [exitcause.CAUSE_OK]
        assert att[0]["rank_exits"] == {"r0": "ok", "r1": "ok"}
        # Whichever rank stages a cycle last publishes it (the snapshot is
        # rank 0's alone; the ledger has both ranks').
        from examl_tpu_torch.obs import ledger
        pubs = [e for e in ledger.read_dir(str(out))
                if e["kind"] == "checkpoint.publish"]
        assert len(pubs) == 2 and all(e["world"] == 2 for e in pubs)
        assert snap["resilience"]["gang"]["emulate"] is True
        return
    assert [a["cause"] for a in att] == [exitcause.CAUSE_OOM_KILL,
                                         exitcause.CAUSE_OK]
    assert att[0]["rank"] == 1 and att[0]["rank_exits"]["r1"] == \
        exitcause.CAUSE_OOM_KILL
    assert att[1]["world"] == 2
    assert snap["counters"]["resilience.gang.rank_deaths"] == 1
    # Lockstep: rank 1 dies writing the second tree's cycle, after the
    # collectives of the second tree, which rank 0 reached only once it
    # had staged the first tree's cycle: that cycle published, and the
    # restarted gang went on from it.
    assert att[1]["resumed"] is True
    assert "restart at tree 1" in (out / "ExaML_info.T").read_text()
