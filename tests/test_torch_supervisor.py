"""The port's supervisor (examl_tpu_torch/resilience/supervisor.py) against
the JAX package's, on the CPU.

* `backoff_delay`, `classify_stall` and `child_argv` (over the port's flag
  set) give the JAX package's results on the same inputs;
* the degradation ladder: every rung names a tier of NEWVIEW_TIERS and
  stays on kernel B1 (`--newview chunk`), rung 2 is reached within
  `--supervise-retries 1`, `-S` keeps its rung's other flags, an
  allocator OOM halves the memory pin and an `error` exit (a kernel or
  CUDA error) pins nothing;
* a process that runs `Supervisor` over a stub child never imports torch;
  a gang of stub ranks whose rank 1 keeps crashing shrinks to one rank;
* end to end through the child-command hook (the child is the port's CLI
  on the CPU), on tests/test_torch_cli.py's 8-taxon alignment in f64:
  (i) `-f e` with `search.kill` armed for attempt 0 after the first
  tree's checkpoint resumes with `-R` and ends at the unsupervised run's
  lnLs bit for bit; (ii) `heartbeat.stall` with `--supervise-stall 3` is
  hang-killed, and attempt 1 carries rung 1's flags in its argv, the
  ledger and the metrics' attempts blob, and completes at the
  unsupervised lnLs; (iii) SIGTERM to a supervisor process exits 75, and
  a rerun resumes to the unsupervised lnLs; (iv) a usage error is not
  retried.  The faults of (i)-(iii) land at the first tree's end, so
  every resume starts at a tree boundary and the lnLs are bit for bit.

Every wait is a poll with a deadline.  The card runs the same paths in
chip_smoke.py's phase 26.
"""

import gzip
import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from examl_tpu_torch.cli.main import build_argparser
from examl_tpu_torch.constants import NEWVIEW_TIERS
from examl_tpu_torch.obs import ledger
from examl_tpu_torch.resilience import exitcause, faults, heartbeat
from examl_tpu_torch.resilience import supervisor as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240           # seconds, per supervised run

# The child command of the CPU tests: the port's CLI on the CPU (the
# supervisor's default child runs it on the card).
WORKER = ("import sys, torch; torch.set_num_threads(1); "
          "from examl_tpu_torch.cli.main import main; "
          "sys.exit(main(sys.argv[1:], device='cpu'))")
CHILD = [sys.executable, "-c", WORKER]


def _jsup():
    from examl_tpu.resilience import supervisor as jsup
    return jsup


# -- host functions against the JAX package -----------------------------------

BACKOFF = [(2.0, r, key, cap) for r in (-3, 0, 1, 2, 3, 7, 12, 40)
           for key in ("", "run", "T:r1", "ñ") for cap in (60.0, 5.0)]


def test_backoff_delay_equals_jax():
    jsup = _jsup()
    for base, r, key, cap in BACKOFF + [(0.25, 3, "start7", 5.0),
                                        (0.0, 2, "x", 1.0)]:
        assert sup.backoff_delay(base, r, key, cap) == \
            jsup.backoff_delay(base, r, key, cap)


STALLS = [[], [1.0], [400.0], [400.0, 401.0], [400.0, 10.0],
          [400.0, 200.0], [400.0, 151.0], [0.0, 0.0], [301.0, 150.0],
          [299.9, 300.1, 5.0], [1e9, 1e9, 1e9]]


@pytest.mark.parametrize("ages", STALLS)
def test_classify_stall_equals_jax(ages):
    assert sup.classify_stall(ages, 300.0) == \
        _jsup().classify_stall(ages, 300.0)


ARGVS = [
    ["-s", "a.bin", "-n", "T", "--supervise", "--supervise-retries", "2",
     "--supervise-stall", "3", "--supervise-backoff", "0.5", "-f", "e"],
    ["-s", "a.bin", "--launch", "2", "--launch-emulate",
     "--launch-min-ranks", "1", "--newview", "whole", "--batch-scan", "off",
     "--inject-fault", "search.kill@rank=1:after=3"],
    ["--launch=4", "--supervise-stall=9", "-N", "6", "--fleet-job-deadline",
     "2", "--fleet-lease-ttl", "5", "--clv-dtype", "bf16", "-R"],
    ["--supervise", "--metrics", "m.json", "--ledger", "led", "-S",
     "--supervise", "-i", "5"],
    ["--supervise-retries"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_child_argv_equals_jax(argv):
    got = sup.child_argv(argv)
    assert got == _jsup().child_argv(argv)
    assert not any(t.split("=")[0] in sup._SUPERVISOR_FLAGS for t in got)


# -- the ladder ---------------------------------------------------------------


def _supervisor(tmp_path, argv=("-s", "a", "-n", "T"), **kw):
    return sup.Supervisor(list(argv), str(tmp_path), "T", log=lambda m: None,
                          child_cmd=CHILD, **kw)


def test_every_rung_stays_on_kernel_b1():
    ap = build_argparser()
    for rung in sup.DEGRADE_LADDER:
        flags = [t for k, v in rung.items() for t in (k, v)]
        args = ap.parse_args(["-s", "a", "-n", "T"] + flags)
        assert (args.newview or "chunk") in NEWVIEW_TIERS
        assert args.newview in (None, "chunk")        # never leaves B1
    assert sup.DEGRADE_LADDER[-1] == {"--newview": "chunk",
                                      "--batch-scan": "off"}


@pytest.mark.parametrize("retries,levels", [(1, [2, 2]), (2, [1, 2]),
                                            (3, [1, 2, 2])])
def test_escalation_reaches_the_floor_within_the_budget(tmp_path, retries,
                                                        levels):
    s = _supervisor(tmp_path, max_retries=retries)
    seen = []
    for _ in levels:
        s._escalate(exitcause.CAUSE_HANG_KILL)
        seen.append(s.degrade_level)
    assert seen == levels
    argv = s._attempt_argv()
    assert argv[-4:] == ["--newview", "chunk", "--batch-scan", "off"]
    # A kernel or CUDA error in the child exits `error`: retried on the
    # same rung, never "healed" by a quieter route.
    s2 = _supervisor(tmp_path, max_retries=retries)
    s2._escalate(exitcause.CAUSE_ERROR)
    assert s2.degrade_level == 0 and s2._attempt_argv()[-1] == "T"


def test_save_memory_rungs_and_the_memory_pin(tmp_path, monkeypatch):
    monkeypatch.delenv("EXAML_MEM_BUDGET_FRACTION", raising=False)
    s = _supervisor(tmp_path, argv=("-s", "a", "-n", "T", "-S"),
                    max_retries=1)
    s._escalate(exitcause.CAUSE_SIGILL)
    assert s._pins() == {"--batch-scan": "off"}      # -S takes no --newview
    build_argparser().parse_args(s._attempt_argv())
    fractions = []
    for _ in range(6):
        s._escalate(exitcause.CAUSE_ALLOC_OOM)
        fractions.append(float(s._env_pins()["EXAML_MEM_BUDGET_FRACTION"]))
    assert fractions == [0.45, 0.225, 0.1125, 0.05625, 0.05, 0.05]
    assert s.degrade_level == 2                       # OOM pins no rung


def test_checkpoint_glob_is_the_managers_naming(tmp_path):
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path), "XY")
    for n in (0, 3, 11):
        open(mgr.path_for(n), "w").close()
    open(mgr.path_for(5) + ".tmp", "w").close()
    assert sup.checkpoint_glob(str(tmp_path), "XY") == \
        _jsup().checkpoint_glob(str(tmp_path), "XY") == \
        sorted(mgr.path_for(n) for n in (0, 3, 11))
    open(tmp_path / "ExaML_fleetJournal.XY.r1", "w").close()
    assert sup.resume_evidence(str(tmp_path), "XY") == \
        _jsup().resume_evidence(str(tmp_path), "XY")


STUB = r"""
import json, sys
from examl_tpu_torch.resilience import supervisor
s = supervisor.Supervisor(["-n", "T"], sys.argv[1], "T", backoff=0.0,
                          max_retries=1, log=lambda m: None,
                          child_cmd=[sys.executable, "-c",
                                     "import os, signal, sys; "
                                     "sys.argv[-1] == 'T' and os.kill("
                                     "os.getpid(), signal.SIGILL)"])
rc = s.run()
print(json.dumps({"rc": rc, "causes": [a["cause"] for a in s.attempts],
                  "argv": s._last_argv,
                  "loaded": sorted(k for k in sys.modules
                                   if k.split(".")[0] in
                                   ("torch", "jax", "examl_tpu"))}))
"""


def test_supervisor_parent_never_imports_torch(tmp_path):
    """The stub child dies of SIGILL once (its argv ends with the run
    id), then succeeds on the floor rung's argv (one retry: the step
    reaches it at once); the parent loads no torch throughout."""
    res = subprocess.run([sys.executable, "-c", STUB, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "causes": ["sigill", "ok"],
                   "argv": ["-n", "T", "--newview", "chunk", "--batch-scan",
                            "off"], "loaded": []}


def test_a_rank_that_keeps_dying_shrinks_the_gang(tmp_path):
    """Elastic resume over stub ranks (no torch): rank 1 crashes at once
    on every attempt; after two consecutive deaths the gang goes on
    with one rank, which completes."""
    child = ("import os, signal, time; "
             "os.environ['EXAML_PROCID'] == '1' and "
             "os.kill(os.getpid(), signal.SIGSEGV); time.sleep(0.3)")
    g = sup.GangSupervisor(["-n", "T"], str(tmp_path), "T", ranks=2,
                           emulate=True, backoff=0.0, max_retries=3,
                           stall_timeout=0, log=lambda m: None,
                           metrics_file=str(tmp_path / "m.json"),
                           child_cmd=[sys.executable, "-c", child])
    assert g.run() == 0
    snap = json.loads((tmp_path / "m.json").read_text())
    att = snap["resilience"]["attempts"]
    assert [(a["cause"], a["rank"], a["world"]) for a in att] == [
        (exitcause.CAUSE_CRASH, 1, 2), (exitcause.CAUSE_CRASH, 1, 2),
        (exitcause.CAUSE_OK, None, 1)]
    assert snap["counters"]["resilience.gang.elastic_resumes"] == 1
    assert snap["counters"]["resilience.gang.rank_deaths"] == 2
    assert snap["resilience"]["gang"] == {"ranks_initial": 2,
                                          "ranks_final": 1,
                                          "emulate": True, "min_ranks": 1}


# -- end to end through the child-command hook --------------------------------


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The 8-taxon alignment, its two trees, and the unsupervised `-f e`
    run's lnLs and the number of search beats through the first tree."""
    import torch
    from examl_tpu_torch.cli.main import main
    from tests.test_torch_cli import _inputs
    tmp = tmp_path_factory.mktemp("sup")
    aln, trees = _inputs(tmp)
    states = []
    orig = heartbeat.beat

    def counting(state="", payload=None):
        states.append(state)
        return orig(state, payload)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    heartbeat.beat = counting
    try:
        assert main(["-s", aln, "-t", trees, "-n", "T", "-w",
                     str(tmp / "ref"), "-f", "e"], device="cpu") == 0
    finally:
        heartbeat.beat = orig
        torch.set_num_threads(n)
    return {"tmp": tmp, "aln": aln, "trees": trees,
            "lnls": _final_lnls(tmp / "ref"),
            "first_tree_beats": states.index("TREE_EVAL") + 1}


def _final_lnls(workdir):
    """The tree lnLs of the newest checkpoint (JSON floats: exact)."""
    newest = max(glob.glob(os.path.join(workdir, "*.ckpt_*.json.gz")),
                 key=lambda p: int(p.split("ckpt_")[1].split(".")[0]))
    with gzip.open(newest, "rt") as f:
        return json.load(f)["extras"]["lnls"]


def _supervise(argv):
    return sup.supervise(argv, build_argparser().parse_args(argv),
                         log=lambda m: None, child_cmd=CHILD)


def _argv(case, name, *extra):
    out = case["tmp"] / name
    return ["-s", case["aln"], "-t", case["trees"], "-n", "T", "-w",
            str(out), "-f", "e", "--supervise", "--supervise-backoff", "0.05",
            "--metrics", str(out / "m.json")] + list(extra), out


def _attempts(out):
    return json.loads((out / "m.json").read_text())["resilience"]


def test_supervised_kill_resumes_bit_for_bit(case):
    argv, out = _argv(case, "kill", "--inject-fault",
                      f"search.kill:after={case['first_tree_beats']}")
    assert _supervise(argv) == 0
    res = _attempts(out)
    assert [a["cause"] for a in res["attempts"]] == \
        [exitcause.CAUSE_OOM_KILL, exitcause.CAUSE_OK]
    assert [a["resumed"] for a in res["attempts"]] == [False, True]
    assert _final_lnls(out) == case["lnls"]            # bit for bit


def test_stall_is_hang_killed_and_attempt_1_takes_rung_1(case):
    """The beats stop at the first tree's end (its checkpoint written) and
    the next beat hangs: a wedge the stall window ends."""
    k = case["first_tree_beats"]
    argv, out = _argv(case, "stall", "--supervise-stall", "3",
                      "--inject-fault", f"heartbeat.stall:after={k}",
                      "--inject-fault", f"search.kill:after={k + 1}:hang=120")
    t0 = time.time()
    assert _supervise(argv) == 0
    assert time.time() - t0 < CHILD_TIMEOUT
    res = _attempts(out)
    assert [a["cause"] for a in res["attempts"]] == \
        [exitcause.CAUSE_HANG_KILL, exitcause.CAUSE_OK]
    assert res["attempts"][1]["pins"] == {"--newview": "chunk"}
    assert res["attempts"][1]["degrade_level"] == 1
    snap = json.loads((out / "m.json").read_text())
    assert snap["counters"]["resilience.heartbeat_stalls"] == 1
    assert snap["gauges"]["resilience.degrade_level"] == 1
    evs = ledger.read_events(str(out / "ledger.merged.jsonl"))
    spawns = [e for e in evs if e["kind"] == "supervisor.spawn"]
    assert [e["degrade_level"] for e in spawns] == [0, 1]
    assert spawns[1]["pins"] == ["--newview"]
    (restart,) = [e for e in evs if e["kind"] == "supervisor.restart"]
    assert restart["cause"] == exitcause.CAUSE_HANG_KILL
    assert restart["pins"] == ["--newview"] and restart["degrade_level"] == 1
    assert [e["reason"] for e in evs if e["kind"] == "supervisor.kill"] == \
        ["heartbeat-stall"]
    # Attempt 1's argv carried the rung; its run took the chunk tier.
    assert "newview: chunk" in (out / "ExaML_info.T").read_text()
    assert [e["attempt"] for e in evs if e["kind"] == "run"
            and e["status"] == "start"] == ["0", "1"]
    assert _final_lnls(out) == case["lnls"]            # bit for bit


def test_sigterm_to_the_supervisor_exits_75_and_a_rerun_resumes(case):
    """The child holds at the first tree's end (its checkpoint written);
    the supervisor's SIGTERM reaches it there, it exits 75 at that
    checkpoint site, and the rerun resumes at the second tree."""
    k = case["first_tree_beats"]
    argv, out = _argv(case, "term", "--inject-fault",
                      f"search.kill:after={k}:hang=3")
    code = ("import sys; from examl_tpu_torch.cli.main import "
            "build_argparser; from examl_tpu_torch.resilience import "
            f"supervisor; argv = {argv!r}; sys.exit(supervisor.supervise("
            f"argv, build_argparser().parse_args(argv), child_cmd={CHILD!r}))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1",
                                     PYTHONPATH=REPO))
    first_tree = os.path.join(out, "ExaML_binaryCheckpoint.T.ckpt_1.json.gz")
    try:
        deadline = time.time() + CHILD_TIMEOUT
        while not os.path.exists(first_tree) and proc.poll() is None \
                and time.time() < deadline:
            time.sleep(0.05)
        assert proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == exitcause.EXIT_PREEMPTED, proc.stderr.read()
    assert "run preempted (SIGTERM)" in (out / "ExaML_info.T").read_text()
    res = _attempts(out)
    assert [a["cause"] for a in res["attempts"]] == [exitcause.CAUSE_PREEMPT]
    # The rerun (the same command) finds the checkpoint and resumes with
    # -R; the fault is armed for attempt 0, which the rerun's child is.
    rerun = [t for t in argv if not t.startswith("search.kill")
             and t != "--inject-fault"]
    assert _supervise(rerun) == 0
    assert _attempts(out)["attempts"][0]["resumed"] is True
    assert _final_lnls(out) == case["lnls"]            # bit for bit


def test_usage_error_is_not_retried(case):
    # The parent parses without torch; the child refuses the pair.
    argv, out = _argv(case, "usage", "--clv-dtype", "bf16", "--newview",
                      "whole")
    assert _supervise(argv) == exitcause.EXIT_USAGE
    res = _attempts(out)
    assert [a["cause"] for a in res["attempts"]] == [exitcause.CAUSE_USAGE]
    assert faults.parse_spec("checkpoint.publish") and \
        "checkpoint.publish" not in faults.NOT_YET_PORTED
