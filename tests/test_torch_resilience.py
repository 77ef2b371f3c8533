"""The port's in-process resilience (examl_tpu_torch/resilience/) against
the JAX package's (examl_tpu/resilience/), on the CPU, with one card case.

* `faults.parse_spec` gives JAX's specs on a table of specs and JAX's
  rejects; every JAX point the port has no seam for yet (the extension
  bank's) is refused with "not yet ported", and the points the
  supervisor, the gang checkpoint and the lease board brought parse as
  JAX's; `after`, `attempt` and sticky points behave as JAX's;
* `exitcause.classify` / `exit_desc` equal JAX's on every code; the
  memory governor's pure math equals JAX's on tests/test_memgov.py's
  tables; `is_oom` takes an allocator OOM and the injected `mem.oom`,
  never a kernel or CUDA runtime error; `evict_engine` drops the layout
  caches;
* the heartbeat (sticky stall, search.kill addressing, the autoflush it
  ticks) and the preemption flag;
* the CLI's fault paths on tests/test_torch_cli.py's 8-taxon alignment
  (f64): `engine.nonfinite` recovers to the uninjected lnL with one retry
  recovered, a second non-finite result raises; `checkpoint.write` keeps
  the last published checkpoint and `-R` ends at the uninterrupted `-f d`
  lnL; a SIGTERM sent to a `-f d` subprocess exits with EXIT_PREEMPTED and
  `-R` ends at the uninterrupted lnL (rtol 1e-10); an unknown point is a
  usage error; `compile.hang` fires at a library's first load in a
  process, and the four points the extension bank brought parse as
  JAX's;
* the fleet: `fleet.job.poison:job=ID` quarantines that job alone, as the
  JAX driver does; `mem.oom` in a batch recovers by halving with every
  job's lnL bit for bit as alone; `mem.pressure:bytes=N` cuts the batch
  into the parts `effective_cap` gives.

This file imports JAX only inside the tests that use it, so its card case
runs where JAX is absent (`--noconftest -m cuda`).
"""

import glob
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet import jobs, quarantine
from examl_tpu_torch.fleet.driver import FleetDriver
from examl_tpu_torch.obs import ledger, programs
from examl_tpu_torch.ops import _build
from examl_tpu_torch.resilience import (exitcause, faults, heartbeat, memgov,
                                        preempt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """One torch thread, an empty fault registry, and no leaked fault,
    heartbeat or restart-count environment."""
    for var in (faults.ENV_VAR, faults.ATTEMPT_VAR, heartbeat.ENV_VAR,
                memgov.ENV_BUDGET_BYTES, memgov.ENV_BUDGET_FRACTION):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    heartbeat.reset()
    memgov.reset()
    obs.reset()
    yield
    faults.reset()
    heartbeat.reset()
    memgov.reset()
    ledger.reset()
    obs.reset()
    torch.set_num_threads(n)


def _jr():
    """The JAX package's resilience modules (imported inside the tests
    that use them: the card's machine has no JAX)."""
    from examl_tpu.resilience import exitcause as je, faults as jf
    from examl_tpu.resilience import memgov as jm
    return je, jf, jm


# -- fault specs -------------------------------------------------------------

SPECS = [
    "engine.dispatch",
    "engine.dispatch:after=3",
    "engine.nonfinite",
    "engine.nonfinite:after=2:attempt=1",
    "engine.nonfinite:attempt=*:after=1",
    "checkpoint.write",
    "checkpoint.write:signal=KILL",
    "search.kill",
    "search.kill:after=3:signal=TERM",
    "search.kill@rank=1:after=10",
    "search.kill:rank=0:hang=7",
    "heartbeat.stall:after=3",
    "fleet.dispatch:raise",
    "fleet.job.poison:job=start2",
    "fleet.results.write:after=2",
    "mem.oom:job=start0",
    "mem.pressure:bytes=4096",
    "engine.dispatch:after=0",
    "search.kill:after=2,engine.dispatch:attempt=*",
    " mem.oom , fleet.dispatch ",
]

REJECTS = [
    "no.such.point",
    "search.kill:frobnicate=1",
    "search.kill@proc=1",
    "search.kill@rank=",
    "fleet.job.poison:job=",
    "mem.pressure:bytes=lots",
    "engine.dispatch,engine.dispatch:after=2",
    "engine.dispatch:after=x",
]


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_equals_jax(text):
    _, jf, _ = _jr()
    ours, theirs = faults.parse_spec(text), jf.parse_spec(text)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert vars(ours[k]) == vars(theirs[k])


@pytest.mark.parametrize("text", REJECTS)
def test_parse_spec_rejects_as_jax(text):
    _, jf, _ = _jr()
    with pytest.raises(ValueError):
        jf.parse_spec(text)
    with pytest.raises(ValueError):
        faults.parse_spec(text)


# The JAX points the port had no seam for before its supervisor, gang
# checkpoint, lease board and extension bank came: each now parses as JAX
# parses it, and the port's point set is JAX's.
LATER_POINTS = ("bank.export.load", "bank.export.write", "bank.worker",
                "checkpoint.publish", "compile.hang", "fleet.job.hang",
                "fleet.lease.reap", "fleet.lease.write")


@pytest.mark.parametrize("point", LATER_POINTS)
def test_unported_points_are_refused(point):
    _, jf, _ = _jr()
    assert point in jf.POINTS and point in faults.POINTS
    for text in (f"{point}:after=2", f"{point}:attempt=*:signal=SEGV",
                 f"{point}@rank=1:hang=5"):
        ours = faults.parse_spec(text)[point]
        assert vars(ours) == vars(jf.parse_spec(text)[point])
    assert not hasattr(faults, "NOT_YET_PORTED")
    assert set(faults.POINTS) == set(jf.POINTS)


def test_compile_hang_fires_at_a_librarys_first_load(tmp_path,
                                                     monkeypatch):
    """`compile.hang` is the seam of a library's first load in a process
    (the JAX engine's first-call compile monitor): armed to raise, the
    first load raises before the library is read; once loaded, a
    library is served without passing the seam again."""
    import shutil
    syms = sorted({f for fns in _build.SIGNATURES.values() for f in fns})
    (tmp_path / "stub.c").write_text("".join(
        f"int {s}(void) {{ return 0; }}\n" for s in syms))
    monkeypatch.setenv(_build.BUILD_DIR_VAR, str(tmp_path / "kernels"))
    path = _build._lib_path("newview_chunk")
    path.parent.mkdir()
    subprocess.run([shutil.which("cc") or shutil.which("gcc"), "-shared",
                    "-fPIC", "-o", str(path), str(tmp_path / "stub.c")],
                   check=True)
    monkeypatch.setenv(faults.ENV_VAR, "compile.hang:raise:after=1")
    faults.reset()
    obs.reset()
    try:
        with pytest.raises(faults.FaultInjected):
            _build.library("newview_chunk")
        lib = _build.library("newview_chunk")     # the spec fired once
        monkeypatch.setenv(faults.ENV_VAR, "compile.hang:raise")
        faults.reset()                            # armed afresh
        assert _build.library("newview_chunk") is lib
        assert obs.snapshot_counters()["faults.fired.compile.hang"] == 1
    finally:
        _build._LIBS.pop(path, None)
        faults.reset()


def _fire_log(mod, monkeypatch, env, attempts, calls):
    """What `fire` / `armed` do over a call sequence under one env."""
    monkeypatch.setenv(mod.ENV_VAR, env)
    mod.reset()
    out = []
    for attempt, (point, job) in zip(attempts, calls):
        monkeypatch.setenv(mod.ATTEMPT_VAR, str(attempt))
        try:
            r = mod.fire(point, job=job) if point != "mem.pressure" else \
                mod.armed(point) is not None
        except mod.FaultInjected:
            r = "raised"
        out.append(r)
    mod.reset()
    return out


@pytest.mark.parametrize("env", [
    "engine.dispatch:after=3", "engine.dispatch:attempt=1",
    "engine.dispatch:attempt=*:after=2", "heartbeat.stall:after=2",
    "fleet.job.poison:job=b:after=2", "mem.pressure:bytes=10",
    "engine.nonfinite:after=2", "mem.oom:job=a"])
def test_after_attempt_and_sticky_match_jax(env, monkeypatch):
    _, jf, _ = _jr()
    point = env.split(":")[0]
    calls = [(point, j) for j in "abababab"]
    attempts = [0, 0, 1, 0, 1, 1, 0, 0]
    assert _fire_log(faults, monkeypatch, env, attempts, calls) == \
        _fire_log(jf, monkeypatch, env, attempts, calls)


# -- exit causes, memory governor --------------------------------------------


def test_exitcause_equals_jax_on_every_code():
    je, _, _ = _jr()
    for rc in [None] + list(range(-70, 260)):
        for hk in (False, True):
            assert exitcause.classify(rc, hang_killed=hk) == \
                je.classify(rc, hang_killed=hk)
        assert exitcause.exit_desc(rc) == je.exit_desc(rc)
        assert exitcause.exit_desc(rc, "x") == je.exit_desc(rc, "x")
    for name in ("EXIT_PREEMPTED", "EXIT_USAGE", "EXIT_ALLOC_OOM",
                 "RETRYABLE", "TIER_SUSPECT"):
        assert getattr(exitcause, name) == getattr(je, name)
    assert preempt.EXIT_PREEMPTED == 75
    assert memgov.MemoryBudgetExhausted.exit_code == 76


def test_memgov_pure_math_equals_jax():
    _, _, jm = _jr()
    for frac in (0.5, 2.0, 0.0, -3.0, 0.05, 1.0, 0.049):
        assert memgov.clamp_fraction(frac) == jm.clamp_fraction(frac)
    cases = [(1000,), (1000, None, "0.5"), (1000, "123", "0.5"), (None,),
             (0,), (1000, None, None, 7), (None, None, None, 7),
             (1000, "50", None, 7000), (1000, "banana"),
             (1000, None, "banana"), (1000, None, "9.0"),
             (80 * 2 ** 30, None, "0.3", 2 ** 33)]
    for c in cases:
        assert memgov.resolve_budget(*c) == jm.resolve_budget(*c)
    for c in [(10 ** 12, 0, None), (100, 50, 200), (150, 50, 200),
              (100, 150, 200), (None, 0, 100), (0, -5, 10)]:
        assert memgov.admit_math(*c) == jm.admit_math(*c)
    for c in ([("a", 3), ("b", 1), ("c", 2)], []):
        assert memgov.eviction_order(c) == jm.eviction_order(c)
    for name in ("DEFAULT_FRACTION", "MIN_FRACTION", "OOM_STRIKE_LIMIT"):
        assert getattr(memgov, name) == getattr(jm, name)


def test_is_oom_takes_allocator_ooms_only():
    assert memgov.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert memgov.is_oom(faults.FaultInjected("injected fault at mem.oom"))
    assert not memgov.is_oom(faults.FaultInjected(
        "injected fault at fleet.dispatch"))
    # A kernel or CUDA runtime error stays a device fault, whatever its
    # text says.
    assert not memgov.is_oom(_build.KernelError("launch: out of memory"))
    assert not memgov.is_oom(RuntimeError("CUDA error: out of memory"))
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        try:
            exc = accel("CUDA error: out of memory")
        except TypeError:
            exc = None
        if exc is not None:
            assert not memgov.is_oom(exc)
    assert quarantine.device_fault(_build.KernelError("out of memory"))
    assert not quarantine.device_fault(torch.cuda.OutOfMemoryError("x"))
    assert not memgov.is_oom(None)


def test_oom_strikes_escalate_and_recover(monkeypatch):
    monkeypatch.setattr(memgov, "OOM_STRIKE_LIMIT", 1)
    exc = faults.FaultInjected("injected fault at mem.oom")
    memgov.oom_event(exc, seam="t")
    memgov.oom_recovered()
    memgov.oom_event(exc, seam="t")
    with pytest.raises(memgov.MemoryBudgetExhausted):
        memgov.oom_event(exc, seam="t")
    assert obs.counter("mem.oom_events") == 3
    assert obs.counter("mem.oom_retries") == 1


def test_budget_knobs_read_once_and_pressure(monkeypatch):
    monkeypatch.setenv(memgov.ENV_BUDGET_BYTES, "1000")
    memgov.configure(memgov.knobs_from_env())
    monkeypatch.delenv(memgov.ENV_BUDGET_BYTES)
    g = {"mem.device.0.limit": 10 ** 6, "mem.device.0.in_use": 10}
    assert memgov.budget_bytes(g) == 1000          # the configured knobs
    assert memgov.budget_bytes(g, memgov.Knobs()) == 900000
    monkeypatch.setenv(faults.ENV_VAR, "mem.pressure:bytes=300")
    faults.reset()
    assert memgov.budget_bytes(g) == 300
    assert memgov.budget_bytes({}, memgov.Knobs()) == 300


def test_evict_engine_drops_the_layout_caches():
    from tests.test_torch_fleet import _port
    inst = _port()
    tree = inst.random_tree(2)
    inst.evaluate(tree, full=True)
    from examl_tpu_torch.optimize.branch import tree_gradients
    tree_gradients(inst, tree)
    (eng,) = inst.engines.values()
    assert eng._sched_cache and eng._grad_structs and eng._outroot is not None
    before = inst.evaluate(tree, full=True)
    assert memgov.evict_engine(eng) >= 3
    assert not eng._sched_cache and not eng._grad_structs
    assert eng._outroot is None and obs.counter("mem.evictions") >= 3
    assert inst.evaluate(tree, full=True) == before   # rebuilt on demand


# -- heartbeat and preemption ------------------------------------------------


def test_heartbeat_stall_is_sticky_and_beats_flush_metrics(tmp_path,
                                                           monkeypatch):
    hb = str(tmp_path / "hb.json")
    mfile = tmp_path / "m.json"
    obs.set_autoflush(str(mfile), interval=0)
    try:
        # Without a heartbeat file a beat still flushes the snapshot.
        obs.inc("search.spr_cycles")
        heartbeat.beat("A")
        snap = json.loads(mfile.read_text())
        assert snap["partial"] is True
        assert snap["counters"]["search.spr_cycles"] == 1
        monkeypatch.setenv(faults.ENV_VAR, "heartbeat.stall:after=3")
        faults.reset()
        heartbeat.install(hb)
        heartbeat.beat("A")
        heartbeat.beat("B")
        assert heartbeat.read(hb)["state"] == "A"      # rate-limited
        for _ in range(5):
            heartbeat.beat("C")
        rec = heartbeat.read(hb)
        assert rec["state"] == "A" and rec["seq"] == 1
        assert rec["pid"] == os.getpid() and "counters" in rec
        # Sticky: fired at the third beat, and on every beat after it.
        assert obs.counter("faults.fired.heartbeat.stall") == 5
    finally:
        obs.set_autoflush(None)
    assert heartbeat.rank_path(hb, 0) == hb
    assert heartbeat.rank_path(hb, 2) == hb + ".p2"
    monkeypatch.setenv(heartbeat.PROCID_VAR, "3")
    assert heartbeat.env_rank() == 3


def test_search_kill_addresses_the_nth_beat(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "search.kill:after=3:signal=TERM")
    faults.reset()
    assert preempt.install()
    try:
        heartbeat.beat("X")
        heartbeat.beat("X")
        heartbeat.phase_beat("PARSE")      # setup beats do not count
        assert preempt.requested() is None
        heartbeat.beat("X")
        assert preempt.requested() == "SIGTERM"
        with pytest.raises(preempt.PreemptCheckpointed):
            preempt.check_after_checkpoint()
        assert obs.counter("resilience.preempt_checkpoints") == 1
    finally:
        preempt.uninstall()
    assert preempt.requested() is None


# -- the CLI's fault paths (8-taxon alignment, f64) -------------------------


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    from tests.test_torch_cli import _inputs
    tmp = tmp_path_factory.mktemp("res_cli")
    return tmp, _inputs(tmp)


def _cli(argv, workdir):
    from examl_tpu_torch.cli.main import main
    return main(argv + ["-n", "T", "-w", str(workdir)], device="cpu")


def _best(workdir) -> float:
    text = open(os.path.join(workdir, "ExaML_info.T")).read()
    return float(text.split("Likelihood of best tree: ")[-1].split()[0])


_CLEAN = {}


def _clean_fd(cli_case) -> float:
    """The uninterrupted `-f d -i 5` run's final lnL."""
    if "fd" not in _CLEAN:
        tmp, (aln, trees) = cli_case
        assert _cli(["-s", aln, "-t", trees, "-i", "5"], tmp / "clean") == 0
        _CLEAN["fd"] = _best(tmp / "clean")
    return _CLEAN["fd"]


def test_uninterrupted_search_reference(cli_case):
    """The uninterrupted `-f d -i 5` run the fault cases resume to."""
    assert math.isfinite(_clean_fd(cli_case))


def test_nonfinite_lnl_recovers_on_the_wave_scan_tier(cli_case):
    tmp, (aln, trees) = cli_case
    base = ["-s", aln, "-t", trees, "-f", "e"]
    assert _cli(base, tmp / "fe_clean") == 0
    out = tmp / "fe_nan"
    assert _cli(base + ["--inject-fault", "engine.nonfinite",
                        "--metrics", str(out / "m.json")], out) == 0
    m = json.loads((out / "m.json").read_text())["counters"]
    assert m["engine.nonfinite_retries"] == 1
    assert m["engine.nonfinite_recovered"] == 1
    assert m["faults.fired.engine.nonfinite"] == 1
    assert "recomputing once on the wave-scan tier" in \
        (out / "ExaML_info.T").read_text()
    got = np.loadtxt(out / "ExaML_log.T")[:, 1]
    want = np.loadtxt(tmp / "fe_clean" / "ExaML_log.T")[:, 1]
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_nonfinite_twice_raises(monkeypatch):
    """`engine.nonfinite:attempt=*:after=1` poisons the first lnL; a
    wave-scan retry that is non-finite too raises instead of searching
    on it."""
    from tests.test_torch_fleet import _port
    inst = _port()
    tree = inst.random_tree(1)
    (eng,) = inst.engines.values()
    monkeypatch.setenv(faults.ENV_VAR, "engine.nonfinite:attempt=*:after=1")
    faults.reset()
    orig = eng.traverse_evaluate

    def scan_poisoned(entries, p, q, z, full=False):
        vals = orig(entries, p, q, z, full=full)
        return vals if full else np.full_like(vals, np.nan)

    monkeypatch.setattr(eng, "traverse_evaluate", scan_poisoned)
    with pytest.raises(FloatingPointError, match="non-finite"):
        inst.evaluate(tree, full=True)
    assert obs.counter("engine.nonfinite_retries") == 1
    assert obs.counter("engine.nonfinite_recovered") == 0
    monkeypatch.setattr(eng, "traverse_evaluate", orig)
    assert math.isfinite(inst.evaluate(tree, full=True))


def _ckpts(workdir):
    return sorted(int(p.split("ckpt_")[1].split(".")[0]) for p in
                  glob.glob(os.path.join(workdir, "*.ckpt_*.json.gz")))


def test_checkpoint_write_fault_keeps_the_last_checkpoint(cli_case):
    tmp, (aln, trees) = cli_case
    out = tmp / "ckfault"
    argv = ["-s", aln, "-t", trees, "-i", "5"]
    with pytest.raises(faults.FaultInjected, match="checkpoint.write"):
        _cli(argv + ["--inject-fault", "checkpoint.write:after=2",
                     "--ledger", str(out / "led")], out)
    assert _ckpts(out) == [0]                   # the published one stays
    assert not glob.glob(os.path.join(out, "*.tmp"))
    evs = ledger.read_events(str(out / "led" / "ledger.merged.jsonl"))
    assert [e["status"] for e in evs if e["kind"] == "run"] == \
        ["start", "end"]
    assert any(e["kind"] == "fault" and e["point"] == "checkpoint.write"
               for e in evs)
    assert _cli(argv + ["-R"], out) == 0
    assert _best(out) == pytest.approx(_clean_fd(cli_case), rel=1e-10)


def test_sigterm_preempts_a_subprocess_and_resumes(cli_case):
    tmp, (aln, trees) = cli_case
    out = tmp / "sigterm"
    argv = ["-s", aln, "-t", trees, "-i", "5", "-n", "T", "-w", str(out)]
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from examl_tpu_torch.cli.main import main; "
            f"sys.exit(main({argv!r}, device='cpu'))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.time() + 120
        while not _ckpts(out) and proc.poll() is None \
                and time.time() < deadline:
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == exitcause.EXIT_PREEMPTED, proc.stderr.read()
    assert exitcause.classify(rc) == exitcause.CAUSE_PREEMPT
    assert "run preempted (SIGTERM)" in (out / "ExaML_info.T").read_text()
    assert _cli(["-s", aln, "-t", trees, "-i", "5", "-R"], out) == 0
    assert _best(out) == pytest.approx(_clean_fd(cli_case), rel=1e-10)


def test_unported_fault_point_is_a_usage_error(cli_case, capsys):
    """Every JAX point is ported now: an unknown point (here a misspelt
    one) is the usage error."""
    tmp, (aln, trees) = cli_case
    with pytest.raises(SystemExit) as ei:
        _cli(["-s", aln, "-t", trees, "--inject-fault", "compile.hangs"],
             tmp / "usage")
    assert ei.value.code == exitcause.EXIT_USAGE
    assert "unknown fault point 'compile.hangs'" in capsys.readouterr().err


# -- the fleet ---------------------------------------------------------------


def _fleet_run(inst, n=5, cap=8, cycles=1, **kw):
    drv = FleetDriver(inst, batch_cap=cap, cycles=cycles,
                      policy=quarantine.JobFaultPolicy(backoff_base=0.01),
                      **kw)
    return {j.job_id: j for j in drv.run(jobs.make_jobs("start", n, 7))}


def test_poison_job_is_quarantined_alone_as_jax(monkeypatch):
    from tests.test_torch_fleet import _J, _jax, _port
    monkeypatch.setenv(faults.ENV_VAR, "fleet.job.poison:job=start2")
    faults.reset()
    out = _fleet_run(_port())
    assert out["start2"].failed and out["start2"].cause == \
        quarantine.CAUSE_POISON
    clean = _port()
    for k in (0, 1, 3, 4):
        j = out[f"start{k}"]
        assert j.done and not j.failed and j.attempts == 0
        assert j.lnl == clean.evaluate(clean.random_tree(seed=j.seed),
                                       full=True)
    assert obs.counter("fleet.quarantined") == 1
    J = _J()
    from examl_tpu.resilience import faults as jf
    jf.reset()
    jq = J.driver.quarantine
    jout = {j.job_id: j for j in J.driver.FleetDriver(
        _jax(), batch_cap=8,
        policy=jq.JobFaultPolicy(backoff_base=0.01)).run(
            J.jobs.make_jobs("start", 5, 7))}
    jf.reset()
    for k, j in out.items():
        jj = jout[k]
        assert (j.done, j.failed, j.cause, j.attempts) == \
            (jj.done, jj.failed, jj.cause, jj.attempts)


def test_mem_oom_recovers_by_halving_bit_for_bit(monkeypatch, tmp_path):
    from tests.test_torch_fleet import _port
    monkeypatch.setenv(faults.ENV_VAR, "mem.oom")
    faults.reset()
    inst = _port()
    inst.evaluate(inst.random_tree(0), full=True)   # a layout to evict
    ledger.enable(str(tmp_path), proc=0)
    out = _fleet_run(inst, n=6)
    ledger.finalize()
    clean = _port()
    for j in out.values():
        assert j.done and not j.failed and j.attempts == 0
        assert j.lnl == clean.evaluate(clean.random_tree(seed=j.seed),
                                       full=True)
    c = obs.snapshot_counters()
    assert c["mem.oom_events"] == 1 and c["mem.oom_retries"] == 1
    assert c["fleet.bisect_dispatches"] >= 2
    kinds = [e["kind"] for e in ledger.read_dir(str(tmp_path))]
    assert c["mem.evictions"] >= 1
    assert "mem.oom" in kinds and "mem.evicted" in kinds


def test_mem_pressure_cuts_the_batch_into_governed_parts(monkeypatch,
                                                         tmp_path):
    """With 1000 bytes in use against a 400-byte budget, effective_cap
    gives int(8 x 400 / 1000) = 3: the batch of 8 runs as stacked tables
    of 3, 3 and 2 jobs, each job's lnL bit for bit as alone."""
    from examl_tpu_torch.fleet import batch as tbatch
    from tests.test_torch_fleet import _port
    monkeypatch.setattr(programs, "host_rss_bytes", lambda: 1000)
    monkeypatch.setattr(programs, "MEM_SAMPLE_S", 0.0)
    monkeypatch.setenv(faults.ENV_VAR, "mem.pressure:bytes=400")
    faults.reset()
    sizes = []
    orig = tbatch.BatchEvaluator._traverse

    def traverse(self, eng, part):
        sizes.append(len(part))
        return orig(self, eng, part)

    monkeypatch.setattr(tbatch.BatchEvaluator, "_traverse", traverse)
    ledger.enable(str(tmp_path), proc=0)
    out = _fleet_run(_port(), n=8)
    ledger.finalize()
    assert sizes == [3, 3, 2]
    shrunk = [e for e in ledger.read_dir(str(tmp_path))
              if e["kind"] == "mem.cap_shrunk"]
    assert shrunk and shrunk[0]["cap"] == 8 and shrunk[0]["effective"] == 3
    assert obs.counter("mem.admission_denials") >= 1
    clean = _port()
    for j in out.values():
        assert j.done and j.lnl == clean.evaluate(
            clean.random_tree(seed=j.seed), full=True)


def test_results_journal_fault_is_survivable(monkeypatch, tmp_path):
    from tests.test_torch_fleet import _port
    monkeypatch.setenv(faults.ENV_VAR, "fleet.results.write:after=2")
    faults.reset()
    journal = quarantine.ResultsJournal(str(tmp_path / "journal"))
    out = _fleet_run(_port(), n=3, journal=journal)
    journal.close()
    assert all(j.done for j in out.values())
    assert len(journal.read()) == 2
    assert obs.counter("fleet.journal_errors") == 1


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_fleet_oom_and_pressure_recover_bit_for_bit(monkeypatch):
    """On the card: an injected OOM and a memory-pressure clamp on a
    batch of six 40-taxon float32 jobs, each job's lnL bit for bit as
    alone, and the governor reading the allocator's counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import build_alignment_data
    from examl_tpu_torch.io.partitions import PartitionSpec
    rng = np.random.default_rng(4)
    names = [f"t{i}" for i in range(40)]
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 2048))
            for _ in names]
    data = build_alignment_data(names, seqs, [
        PartitionSpec("a", "DNA", "GTR", np.arange(2048))])

    def inst():
        return PhyloInstance(data, dtype=torch.float32, device="cuda")

    clean = inst()
    want = {f"start{k}": None for k in range(6)}
    for spec in ("mem.oom", "mem.pressure:bytes=1"):
        monkeypatch.setenv(faults.ENV_VAR, spec)
        monkeypatch.setattr(programs, "MEM_SAMPLE_S", 0.0)
        faults.reset()
        obs.reset()
        out = _fleet_run(inst(), n=6)
        for k, j in out.items():
            assert j.done and not j.failed
            if want[k] is None:
                want[k] = clean.evaluate(clean.random_tree(seed=j.seed),
                                         full=True)
            assert j.lnl == want[k]
        g = obs.registry().snapshot_light()["gauges"]
        assert g["mem.device.0.limit"] > 0 and g["mem.device.0.peak"] > 0
    assert memgov.is_oom(torch.cuda.OutOfMemoryError("x"))
