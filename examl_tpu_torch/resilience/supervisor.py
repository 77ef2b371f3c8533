"""Self-healing run supervisor (`--supervise`, `--launch N`): turns a
lost window into a resumed run.

The port of `examl_tpu/resilience/supervisor.py`.  The supervisor is a
thin parent that never imports torch (the IMPORT CONTRACT of the package
`__init__`): it must never take the card its child needs, and a wedged
kernel launch in the child must not be able to hang the watcher.  It:

* runs the CLI as a KILLABLE child in its own process group (by default
  `python -m examl_tpu_torch.cli.main`, the supervisor flags stripped;
  the command prefix is a constructor argument, so a test can run the
  child on the CPU);
* exports `EXAML_HEARTBEAT_FILE` and watches it: once the run starts
  beating, a stall longer than `--supervise-stall` is a wedge (a kernel
  launch or a collective that never returns) and the whole child process
  group is SIGKILLed; the FIRST beat gets max(4 x stall, 900 s), since
  start-up (imports, the byteFile, the first kernel loads) beats little;
* enforces a fleet batch's declared deadline (`--fleet-job-deadline`,
  declared in the heartbeat) apart from the stall window: a job-stuck
  kill costs the batch's jobs an attempt each, never a run-level retry;
* classifies every death through the shared exit taxonomy
  (`resilience/exitcause.py`) and restarts from the newest checkpoint
  (`-R` once one exists) with capped retries, jittered exponential
  backoff and an ESCALATING degradation ladder (`DEGRADE_LADDER`);
* treats EXIT_PREEMPTED (75) as resumable: restarted at once, no retry
  consumed (a preemption storm is capped separately);
* forwards its own SIGTERM/SIGINT to the child as SIGTERM, so preempting
  the supervisor preempts the run gracefully end to end;
* pins `EXAML_MEM_BUDGET_FRACTION` down (halving, floor 0.05) after an
  alloc-oom exit (EXIT_ALLOC_OOM, 76): the working set is suspect, not
  the tier;
* merges its `resilience.*` counters and its `attempts` record into the
  child's `--metrics` snapshot, and writes its own ledger stream
  (`ledger.psup.jsonl`) beside the children's, merged at the end.

`EXAML_RESTART_COUNT` is exported to each attempt, so a fault spec
(`resilience/faults.py`, `attempt=K`) can target one attempt: crash
once, then recover.

THE LADDER.  The JAX package pins environment switches (its whole-tree
Pallas kernel off, then its universal interpreter, then its scan tier).
The port's routes are CLI flags, and it has no universal interpreter.
So rung 1 appends `--newview chunk` (B2 -> B1, the counterpart of
leaving the whole-tree kernel), rung 2 also `--batch-scan off` (the
sequential SPR scan), and rung 3, the floor, leaves the kernels:
`--newview scan --batch-scan off --grad-smooth off` runs every traversal
on the wave-scan tier of torch ops and loads no CUDA library (the
counterpart of the JAX last rung's EXAML_FAST_TRAVERSAL=0,
EXAML_BATCH_SCAN=0, EXAML_BATCH_THOROUGH=0, EXAML_GRAD_SMOOTH=0).  A
fault in B1 itself (a launch that wedges the card, a library whose load
crashes the process) thus ends on rung 3 instead of retrying B1 until
the retries run out.  Under `-S` (which takes no `--newview`) a rung
keeps its other flags.

`--launch N` (GangSupervisor, below) extends the contract to several
processes: the supervisor spawns all N ranks, watches the per-rank
heartbeats, tells a rank death, a collective wedge and a straggler
apart, and restarts the WHOLE gang from the newest coordinated (two-phase)
checkpoint, shrinking the world when one rank keeps dying.  A fleet mode
(-b/-N/--serve) makes the ranks leased instead: each restarts alone.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from examl_tpu_torch.obs import ledger as _ledger
from examl_tpu_torch.resilience import exitcause, heartbeat

# Degradation ladder, in escalation order: CLI flags appended to the
# child's argv (a key starting with "--" is a flag, any other key an
# environment variable).  Rungs 1-2 run full traversals on kernel B1, the
# last runs no kernel.
DEGRADE_LADDER = (
    {},
    {"--newview": "chunk"},
    {"--newview": "chunk", "--batch-scan": "off"},
    {"--newview": "scan", "--batch-scan": "off", "--grad-smooth": "off"},
)

DEFAULT_RETRIES = 3
DEFAULT_STALL = 300.0
POLL_S = 0.25

# The child's command without its arguments: the port's CLI, on the card.
CHILD_CMD = (sys.executable, "-m", "examl_tpu_torch.cli.main")

# Supervisor flags stripped from the child's argv, with the number of
# values each takes (argparse's two-token form; "--flag=value" is also
# handled by prefix match).
_SUPERVISOR_FLAGS = {"--supervise": 0, "--supervise-retries": 1,
                     "--supervise-stall": 1, "--supervise-backoff": 1,
                     "--launch": 1, "--launch-emulate": 0,
                     "--launch-min-ranks": 1}

# Elastic resume: after the SAME rank has caused this many CONSECUTIVE
# failed attempts, the gang degrades to N-1 ranks instead of burning the
# retry budget on a slot that keeps dying (site windows re-derive from
# the byteFile at parse time; checkpoint state is topology and model, so
# a smaller world resumes the same search).
ELASTIC_CONSECUTIVE_DEATHS = 2

# Gang causes that count as a RANK DEATH (a process died), as opposed to
# a watcher's stall verdict.
_RANK_DEATH_CAUSES = frozenset({
    exitcause.CAUSE_CRASH, exitcause.CAUSE_OOM_KILL,
    exitcause.CAUSE_SIGILL, exitcause.CAUSE_ERROR,
    exitcause.CAUSE_TERMINATED})


def backoff_delay(base: float, retry: int, key: str = "",
                  cap: float = 60.0) -> float:
    """Exponential restart backoff with deterministic jitter.

    N gang ranks, or a fleet's retrying jobs, all sleeping the same
    `base * 2**k` ladder would synchronize into restart storms.  The
    jitter fraction in [0.5, 1.0) is drawn from a blake2b hash of (key,
    retry), so one run's delays are reproducible (a resumed supervisor
    re-derives the same schedule) while distinct keys decorrelate.  The
    cap bounds both the raw exponential and the jittered result."""
    raw = min(cap, base * (2 ** max(0, int(retry) - 1)))
    h = int.from_bytes(hashlib.blake2b(f"{key}:{retry}".encode(),
                                       digest_size=8).digest(), "big")
    return min(cap, raw * (0.5 + 0.5 * h / 2.0 ** 64))


def classify_stall(ages: List[float], stall: float) -> Optional[str]:
    """The gang watcher's stall verdict from the LIVE ranks' beat ages.

    * every rank stale -> collective wedge (every rank is blocked in a
      collective or a launch at once);
    * one rank stale while the freshest is actively beating (age <=
      stall/2) -> single-rank straggler;
    * one rank stale while the others are merely aging -> keep watching:
      a collective wedge reaches ranks an allreduce apart, and deciding
      early would read its first victim as a straggler and skip the
      ladder.
    """
    if not ages:
        return None
    stale = [a > stall for a in ages]
    if all(stale):
        return exitcause.CAUSE_COLLECTIVE_WEDGE
    if any(stale) and min(ages) <= stall / 2.0:
        return exitcause.CAUSE_STRAGGLER
    return None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_argv(argv: List[str]) -> List[str]:
    """The supervised child's argument list: the original CLI argv minus
    the supervisor-only flags (`--inject-fault` passes THROUGH: the child
    arms the registry, and attempt gating keeps retries clean)."""
    out: List[str] = []
    skip = 0
    for tok in argv:
        if skip:
            skip -= 1
            continue
        flag = tok.split("=", 1)[0]
        if flag in _SUPERVISOR_FLAGS:
            if "=" not in tok:
                skip = _SUPERVISOR_FLAGS[flag]
            continue
        out.append(tok)
    return out


def checkpoint_glob(workdir: str, run_id: str) -> List[str]:
    """Published checkpoint files of (workdir, run_id): the naming
    CheckpointManager publishes (search/checkpoint.py imports torch, so
    the pattern is repeated here; a test holds the two together).  Stage
    files of an unfinished gang cycle never match."""
    return sorted(glob.glob(os.path.join(
        workdir, f"ExaML_binaryCheckpoint.{run_id}.ckpt_*.json.gz")))


def resume_evidence(workdir: str, run_id: str) -> List[str]:
    """Everything a retry can resume FROM: published checkpoints plus
    the fleet's results journal(s) (fleet/quarantine.py: written per
    finished job, so one can exist before the first checkpoint; leased
    ranks write one journal each, `.r<k>`)."""
    return checkpoint_glob(workdir, run_id) + sorted(set(
        glob.glob(os.path.join(workdir, f"ExaML_fleetJournal.{run_id}"))
        + glob.glob(os.path.join(
            workdir, f"ExaML_fleetJournal.{run_id}.r*"))))


def _repo_env() -> Dict[str, str]:
    """The parent's environment with this checkout first on PYTHONPATH,
    so a child started from any directory imports the same package."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if repo not in pp:
        env["PYTHONPATH"] = os.pathsep.join([repo] + pp)
    return env


class Supervisor:
    def __init__(self, argv: List[str], workdir: str, run_id: str,
                 max_retries: int = DEFAULT_RETRIES,
                 stall_timeout: float = DEFAULT_STALL,
                 backoff: float = 2.0,
                 metrics_file: Optional[str] = None,
                 ledger_dir: Optional[str] = None,
                 log=print, child_cmd: Optional[List[str]] = None):
        self.base_argv = child_argv(argv)
        self.child_cmd = list(child_cmd or CHILD_CMD)
        self.workdir = workdir
        self.run_id = run_id
        self.max_retries = max_retries
        self.stall_timeout = stall_timeout
        self.backoff = backoff
        self.metrics_file = metrics_file
        self.log = lambda msg: log(f"supervise: {msg}")
        os.makedirs(workdir, exist_ok=True)
        # The supervisor's OWN ledger stream (`ledger.psup.jsonl`, in the
        # children's directory, never in their rank files), so its kill
        # and restart decisions land on the children's merged timeline.
        self.ledger_dir = _ledger.default_dir(ledger_dir, metrics_file)
        if self.ledger_dir:
            _ledger.enable(self.ledger_dir, proc="sup")
        self.hb_path = os.path.join(workdir, f".heartbeat.{run_id}.json")
        # Counters merged into the metrics snapshot at the end (this
        # parent keeps its own dict, outside the obs registry).
        self.counters: Dict[str, float] = {}
        self.attempts: List[dict] = []
        self.degrade_level = 0
        self._preempt_signal: Optional[str] = None
        self._child: Optional[subprocess.Popen] = None
        self._last_argv: List[str] = []
        # Fleet job-level fault domain: per-job hang-attempt counts over
        # the fleet-job-stuck kills, exported to every retry as
        # EXAML_FLEET_HANG_ATTEMPTS so the driver quarantines a job that
        # keeps blowing its deadline.
        self._hang_attempts: Dict[str, int] = {}
        self._last_stuck_jobs: List[str] = []
        self._job_stuck_kills = 0
        # Memory fault domain: an alloc-oom exit pins the budget fraction
        # DOWN for every later attempt, halving toward the floor.
        self._mem_fraction_pin: Optional[float] = None

    # -- bookkeeping --------------------------------------------------------

    def _inc(self, name: str, v: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def _pins(self) -> Dict[str, str]:
        """The current rung's flags and the memory pin, by name."""
        pins = dict(DEGRADE_LADDER[min(self.degrade_level,
                                       len(DEGRADE_LADDER) - 1)])
        if "-S" in self.base_argv:
            # -S runs every traversal on the pooled tier, which takes no
            # --newview (the CLI refuses the pair): the rung keeps only
            # its other flags.
            pins.pop("--newview", None)
        if self._mem_fraction_pin is not None:
            pins["EXAML_MEM_BUDGET_FRACTION"] = \
                f"{self._mem_fraction_pin:.4g}"
        return pins

    def _flag_pins(self) -> List[str]:
        return [tok for k, v in self._pins().items() if k.startswith("--")
                for tok in (k, v)]

    def _env_pins(self) -> Dict[str, str]:
        return {k: v for k, v in self._pins().items()
                if not k.startswith("--")}

    def _attempt_argv(self) -> List[str]:
        argv = list(self.base_argv)
        if "-R" not in argv and resume_evidence(self.workdir,
                                                self.run_id):
            argv.append("-R")
        return argv + self._flag_pins()

    def _escalate(self, cause: str) -> None:
        """The one retry policy both supervision loops share."""
        if cause == exitcause.CAUSE_ALLOC_OOM:
            # The child diagnosed an allocator OOM itself: the tier is
            # fine, its working set is not.  Halve the budget fraction
            # (0.90 is memgov's default, 0.05 its floor).
            cur = self._mem_fraction_pin
            if cur is None:
                try:
                    cur = float(os.environ.get(
                        "EXAML_MEM_BUDGET_FRACTION") or 0.90)
                except ValueError:
                    cur = 0.90
            self._mem_fraction_pin = max(0.05, cur / 2.0)
            self._inc("resilience.mem_budget_pins")
            _ledger.event("supervisor.mem_budget_pin",
                          fraction=self._mem_fraction_pin)
            return
        if cause in exitcause.TIER_SUSPECT:
            # The step reaches the ladder's floor within the retry
            # budget: fewer retries than rungs skip intermediate rungs
            # rather than die with the floor untried.
            floor = len(DEGRADE_LADDER) - 1
            step = -(-floor // max(1, self.max_retries))   # ceil div
            self.degrade_level = min(self.degrade_level + step, floor)

    def _retry_delay(self, retries: int) -> float:
        return backoff_delay(self.backoff, retries, key=self.run_id)

    @staticmethod
    def _exhausted_rc(rc: Optional[int]) -> int:
        """Final exit status when the retry budget is spent: a signal
        death surfaces as the conventional 128+signum."""
        if rc is None:
            return 1
        return 128 - rc if rc < 0 else (rc or 1)

    def _base_env(self, attempt: int) -> Dict[str, str]:
        env = _repo_env()
        env[heartbeat.ENV_VAR] = self.hb_path
        env["EXAML_RESTART_COUNT"] = str(attempt)
        if self._hang_attempts:
            # Fleet job-stuck evidence rides into the retry: the driver
            # bumps these jobs' attempts and quarantines any past its cap
            # (fleet/quarantine.py parses this).
            env["EXAML_FLEET_HANG_ATTEMPTS"] = ",".join(
                f"{jid}={n}" for jid, n in sorted(
                    self._hang_attempts.items()))
        return env

    def _popen(self, argv: List[str], env: Dict[str, str],
               **fields) -> subprocess.Popen:
        child = subprocess.Popen(self.child_cmd + argv, env=env,
                                 start_new_session=True)
        _ledger.event("supervisor.spawn", pid=child.pid, **fields)
        return child

    # -- signal forwarding --------------------------------------------------

    def _live_children(self) -> List[subprocess.Popen]:
        """Children a preemption is forwarded to (the gang supervisor
        overrides this with its rank list)."""
        return [self._child] if self._child is not None else []

    def _signal_children(self, sig) -> None:
        for child in self._live_children():
            if child is not None and child.poll() is None:
                try:
                    os.killpg(child.pid, sig)
                except (OSError, ProcessLookupError):
                    pass

    def _install_signals(self):
        def handler(signum, frame):
            self._preempt_signal = signal.Signals(signum).name
            # Graceful: the children checkpoint and exit resumable.
            self._signal_children(signal.SIGTERM)

        try:
            return (signal.signal(signal.SIGTERM, handler),
                    signal.signal(signal.SIGINT, handler))
        except ValueError:                  # not the main thread (tests)
            return None

    def _restore_signals(self, prior) -> None:
        if prior is not None:
            signal.signal(signal.SIGTERM, prior[0])
            signal.signal(signal.SIGINT, prior[1])

    # -- one attempt --------------------------------------------------------

    def _spawn(self, restarts_total: int) -> subprocess.Popen:
        env = self._base_env(restarts_total)
        env.update(self._env_pins())
        argv = self._last_argv = self._attempt_argv()
        pins = self._pins()
        self.log(f"attempt {restarts_total}: starting "
                 + ("(resume -R) " if "-R" in argv else "")
                 + (f"[degradation level {self.degrade_level}, pins "
                    f"{pins}] " if pins else "")
                 + " ".join(argv))
        try:
            os.unlink(self.hb_path)         # stale beats must not mask
        except OSError:                     # a child that never starts
            pass
        return self._popen(argv, env, attempt=restarts_total,
                           degrade_level=self.degrade_level,
                           pins=sorted(pins))

    def _kill_group(self, child: subprocess.Popen) -> None:
        """SIGKILL the child's whole process group: any helper it started
        must die with it, or the retry races it for the card."""
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            try:
                child.kill()
            except OSError:
                pass
        child.wait()

    def _fleet_deadline(self, path: str):
        """(deadline, jobs) that the last beat at `path` declares for its
        in-flight fleet batch, or (None, [])."""
        fl = (heartbeat.read(path) or {}).get("fleet") or {}
        if fl.get("jobs") and fl.get("deadline"):
            try:
                return float(fl["deadline"]), [str(j) for j in fl["jobs"]]
            except (TypeError, ValueError):
                pass
        return None, []

    def _watch(self, child: subprocess.Popen) -> str:
        """Wait for exit, a blown fleet deadline or a heartbeat stall;
        returns the exit cause."""
        spawned = time.time()
        first_beat_deadline = max(4.0 * self.stall_timeout, 900.0)
        while True:
            rc = child.poll()
            if rc is not None:
                return exitcause.classify(rc)
            hb_age = heartbeat.age(self.hb_path)
            # A batch's declared deadline is enforced apart from the
            # stall window: the kill lands when the DEADLINE expires, and
            # it works under --supervise-stall 0.  A finished batch clears
            # the declaration, so a beat without one never triggers it.
            deadline, jobs = (self._fleet_deadline(self.hb_path)
                              if hb_age is not None else (None, []))
            if deadline is not None and time.time() > deadline:
                self._last_stuck_jobs = jobs
                self.log(
                    "fleet batch exceeded its per-job deadline (jobs "
                    f"{','.join(jobs)}; beat age {hb_age:.0f}s); killing "
                    "the child process group (job-level fault domain: no "
                    "run-level retry consumed)")
                self._inc("resilience.fleet_job_stuck_kills")
                _ledger.event("supervisor.kill", reason="fleet-job-stuck",
                              jobs=",".join(jobs),
                              beat_age_s=round(hb_age, 1))
                self._kill_group(child)
                return exitcause.CAUSE_FLEET_JOB_STUCK
            if self.stall_timeout:
                stalled = (hb_age > self.stall_timeout
                           if hb_age is not None else
                           time.time() - spawned > first_beat_deadline)
                if stalled and deadline is None:
                    # The run stopped beating (or never started): kill
                    # the whole group and classify it ourselves, since
                    # our SIGKILL must not read as an OOM kill.  A
                    # declared batch with a live deadline may outlast the
                    # stall window: the deadline verdict above decides.
                    last = heartbeat.read(self.hb_path) or {}
                    self.log(
                        "heartbeat stalled ("
                        + (f"{hb_age:.0f}s > {self.stall_timeout:.0f}s"
                           if hb_age is not None else
                           f"no first beat within {first_beat_deadline:.0f}s")
                        + f"; last state {last.get('state')!r} seq "
                        f"{last.get('seq')}); killing the child process "
                        "group")
                    self._inc("resilience.heartbeat_stalls")
                    _ledger.event("supervisor.kill",
                                  reason="heartbeat-stall",
                                  beat_age_s=(round(hb_age, 1)
                                              if hb_age is not None
                                              else None),
                                  last_state=last.get("state"))
                    self._kill_group(child)
                    return exitcause.CAUSE_HANG_KILL
            time.sleep(POLL_S)

    # -- the supervision loop -----------------------------------------------

    def run(self) -> int:
        prior = self._install_signals()
        retries = 0
        preempts = 0
        restarts_total = 0
        rc = 1
        try:
            while True:
                if self._preempt_signal is not None:
                    # Preempted between children (in the backoff sleep or
                    # before the first spawn): exit resumable now.
                    self.log(f"supervisor preempted "
                             f"({self._preempt_signal}) between "
                             "attempts; not restarting")
                    self._inc("resilience.preempts")
                    return exitcause.EXIT_PREEMPTED
                t0 = time.time()
                self._child = child = self._spawn(restarts_total)
                cause = self._watch(child)
                self._child = None
                rc = child.returncode
                rec = {
                    "attempt": restarts_total, "cause": cause,
                    "returncode": rc, "seconds": round(time.time() - t0, 2),
                    "pins": self._pins(),
                    "degrade_level": self.degrade_level,
                    "resumed": "-R" in self._last_argv}
                if cause != exitcause.CAUSE_OK:
                    rec["partial_counters"] = self._partial_counters(t0)
                self.attempts.append(rec)
                desc = exitcause.exit_desc(rc, none_desc="(hang-killed)")

                if cause == exitcause.CAUSE_OK:
                    self.log(f"run completed after {restarts_total} "
                             "restart(s)")
                    _ledger.event("supervisor.done",
                                  restarts=restarts_total)
                    return 0
                if self._preempt_signal is not None:
                    # WE were preempted: the child checkpointed (or
                    # died); exit resumable ourselves.
                    self.log(f"supervisor preempted ({self._preempt_signal})"
                             f"; child exited {desc}; not restarting")
                    self._inc("resilience.preempts")
                    return exitcause.EXIT_PREEMPTED
                if cause == exitcause.CAUSE_PREEMPT:
                    # The CHILD was preempted, we were not: resume at
                    # once, no retry consumed.
                    preempts += 1
                    self._inc("resilience.preempts")
                    if preempts > max(10, 5 * self.max_retries):
                        self.log("preemption storm: giving up")
                        return exitcause.EXIT_PREEMPTED
                    restarts_total += 1
                    self._inc("resilience.restarts")
                    _ledger.event("supervisor.restart", cause="preempt",
                                  retry_consumed=False)
                    self.log(f"child preempted {desc}; resuming "
                             "(no retry consumed)")
                    continue
                if cause == exitcause.CAUSE_FLEET_JOB_STUCK:
                    # JOB-level fault domain: the batch's jobs pay (the
                    # restarted driver bumps their attempts and
                    # quarantines repeat offenders), the run does not: no
                    # retry consumed, no rung.  A storm beyond what the
                    # per-job caps can produce means something else is
                    # wrong.
                    self._job_stuck_kills += 1
                    for jid in self._last_stuck_jobs:
                        self._hang_attempts[jid] = \
                            self._hang_attempts.get(jid, 0) + 1
                    if self._job_stuck_kills > max(10,
                                                   5 * self.max_retries):
                        self.log("fleet job-stuck kill storm: giving up")
                        return self._exhausted_rc(rc)
                    restarts_total += 1
                    self._inc("resilience.restarts")
                    _ledger.event("supervisor.restart",
                                  cause="fleet-job-stuck",
                                  retry_consumed=False,
                                  hang_attempts=dict(self._hang_attempts))
                    self.log(
                        "fleet job(s) " + ",".join(self._last_stuck_jobs)
                        + " blew their deadline; resuming with "
                        f"hang-attempt record {self._hang_attempts} "
                        "(no retry consumed, no tier pin)")
                    continue
                if cause == exitcause.CAUSE_USAGE:
                    self.log(f"usage error {desc}: not retryable")
                    return rc
                # Failure: classify, maybe degrade, retry with backoff.
                retries += 1
                self._inc("resilience.restarts")
                self._inc(f"resilience.exits.{cause.replace('-', '_')}")
                if retries > self.max_retries:
                    self.log(f"child failed ({cause} {desc}); retry "
                             f"budget exhausted after {self.max_retries}")
                    return self._exhausted_rc(rc)
                self._escalate(cause)
                delay = self._retry_delay(retries)
                have_ckpt = bool(checkpoint_glob(self.workdir,
                                                 self.run_id))
                _ledger.event("supervisor.restart", cause=cause,
                              retry=retries, resumed=have_ckpt,
                              delay_s=round(delay, 2),
                              degrade_level=self.degrade_level,
                              pins=sorted(self._pins()))
                self.log(
                    f"child failed ({cause} {desc}); retry "
                    f"{retries}/{self.max_retries} in {delay:.1f}s "
                    + ("from newest checkpoint"
                       if have_ckpt else "from scratch (no checkpoint)")
                    + (f", degradation level {self.degrade_level} "
                       f"pins {self._pins()}"
                       if self._pins() else ""))
                time.sleep(delay)
                restarts_total += 1
        finally:
            child = self._child
            if child is not None and child.poll() is None:
                self._kill_group(child)
            self._restore_signals(prior)
            self._merge_metrics()
            self._finalize_ledger()

    # -- metrics ------------------------------------------------------------

    def _finalize_ledger(self) -> None:
        """Close the supervisor's ledger stream and merge the directory
        into one ordered timeline (the children have exited, so their
        rank files, a SIGKILLed attempt's torn one included, are as
        complete as they will ever be)."""
        if self.ledger_dir:
            merged = _ledger.finalize()
            if merged:
                self.log(f"run ledger (merged) -> {merged}")

    def _partial_counters(self, since: float) -> Optional[dict]:
        """The killed attempt's last-known counters: a SIGKILLed child
        never writes its exit snapshot, but the heartbeat-ticked flush
        leaves a `"partial": true` one.  Read it before the next attempt
        overwrites the file; a flush stamped before `since` (the
        attempt's start) belongs to an earlier attempt."""
        if not self.metrics_file:
            return None
        try:
            with open(self.metrics_file) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            return None
        if not snap.get("partial"):
            return None               # a full exit snapshot: not a kill
        if snap.get("flushed_at", 0) < since:
            return None               # stale: an earlier attempt's flush
        return snap.get("counters") or {}

    def _resilience_blob(self) -> dict:
        blob = {"attempts": self.attempts,
                "final_pins": self._pins(),
                "degrade_level": self.degrade_level,
                "heartbeat_file": self.hb_path}
        if self._hang_attempts:
            blob["fleet_hang_attempts"] = dict(self._hang_attempts)
        return blob

    def _merge_metrics(self) -> None:
        """Fold the supervisor's evidence into the child's --metrics
        snapshot (the child rewrites the file at every exit, so the LAST
        attempt's registry is on disk; the supervisor's counters span
        every attempt).  Without --metrics, the log lines are the
        record."""
        if not self.metrics_file:
            return
        snap: dict = {}
        try:
            with open(self.metrics_file) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            snap = {}
        snap.setdefault("counters", {}).update(self.counters)
        snap.setdefault("gauges", {})["resilience.degrade_level"] = \
            self.degrade_level
        snap["resilience"] = self._resilience_blob()
        try:
            with open(self.metrics_file, "w") as f:
                json.dump(snap, f, indent=2, sort_keys=True, default=str)
            self.log(f"metrics snapshot (merged) -> {self.metrics_file}")
        except OSError as exc:
            self.log(f"metrics merge failed ({exc})")


class GangSupervisor(Supervisor):
    """Rank-level failure domains for multi-process runs (`--launch N`).

    A site-parallel run is LOCKSTEP: every rank runs the search in unison
    and meets its peers in every site sum, so one dead or wedged rank
    stalls the gang and the only recovery unit is the gang.  The gang
    supervisor therefore:

    * spawns all N ranks itself, each a killable process group with
      `EXAML_PROCID=<k>` / `EXAML_GANG_RANKS=<N>` exported, plus
      `--coordinator 127.0.0.1:<free port> --nprocs N --procid K` (the
      port's gloo group; every rank on `cuda:(K mod device_count)`); the
      EMULATED mode (`--launch-emulate`) spawns N independent
      single-process ranks that follow the same rank contract;
    * reads the per-rank heartbeat files (`.p<k>` suffixes) and tells
      the failure domains apart: RANK DEATH, COLLECTIVE WEDGE (every live
      rank stale) and STRAGGLER (one rank stale while its peers beat), by
      `classify_stall`;
    * on any failure kills the WHOLE gang, blames the FIRST rank to fail
      (when gloo fails a dead rank's peers at once, they exit with
      `error` right after it: of the ranks found dead at one poll, one
      that died otherwise is the first), and restarts the gang from the
      newest coordinated checkpoint (search/checkpoint.py's two-phase
      publish) with the single-child supervisor's backoff, retries and
      ladder, gang-wide;
    * ELASTIC RESUME: a rank that causes ELASTIC_CONSECUTIVE_DEATHS
      failed attempts in a row shrinks the gang to N-1 ranks (down to
      `--launch-min-ranks`).

    A fleet mode makes the gang LEASED (`_run_fleet`): the ranks are not
    in lockstep, so a rank restarts alone.
    """

    def __init__(self, argv: List[str], workdir: str, run_id: str,
                 ranks: int, emulate: bool = False, min_ranks: int = 1,
                 fleet: bool = False, **kwargs):
        super().__init__(argv, workdir, run_id, **kwargs)
        self.world = max(1, int(ranks))
        self._max_world = self.world
        self.emulate = bool(emulate)
        self.min_ranks = max(1, int(min_ranks))
        self.fleet = bool(fleet)
        self._children: List[subprocess.Popen] = []
        self._death_streak = 0
        self._last_dead_rank: Optional[int] = None
        self._rank0_done_t: Optional[float] = None

    # -- plumbing -----------------------------------------------------------

    def _live_children(self) -> List[subprocess.Popen]:
        return list(self._children)

    def _kill_gang(self) -> None:
        for child in self._children:
            if child.poll() is None:
                self._kill_group(child)

    def _drain_gang(self, timeout: float = 30.0) -> None:
        """Graceful teardown (preemption): SIGTERM every live rank so each
        checkpoints, then SIGKILL whatever outlives the grace."""
        self._signal_children(signal.SIGTERM)
        deadline = time.time() + timeout
        while time.time() < deadline and any(
                c.poll() is None for c in self._children):
            time.sleep(POLL_S)
        self._kill_gang()

    def _rank_env(self, k: int, attempt: int) -> Dict[str, str]:
        env = self._base_env(attempt)
        env[heartbeat.PROCID_VAR] = str(k)
        env[heartbeat.GANG_VAR] = str(self.world)
        return env

    def _spawn_gang(self, restarts_total: int) -> List[subprocess.Popen]:
        argv = self._last_argv = self._attempt_argv()
        pins = self._pins()
        port = None if self.emulate else _free_port()
        self.log(f"attempt {restarts_total}: starting gang of "
                 f"{self.world} rank(s) "
                 + ("(emulated, no process group) " if self.emulate else
                    f"(coordinator 127.0.0.1:{port}) ")
                 + ("(resume -R) " if "-R" in argv else "")
                 + (f"[degradation level {self.degrade_level}, pins "
                    f"{pins}] " if pins else "")
                 + " ".join(argv))
        # Stale beats (ranks beyond a shrunken world included) must not
        # mask a rank that never starts.
        for path in heartbeat.gang_paths(self.hb_path, self._max_world):
            try:
                os.unlink(path)
            except OSError:
                pass
        children = []
        for k in range(self.world):
            env = self._rank_env(k, restarts_total)
            env.update(self._env_pins())
            rank_argv = list(argv)
            if not self.emulate:
                rank_argv += ["--coordinator", f"127.0.0.1:{port}",
                              "--nprocs", str(self.world),
                              "--procid", str(k)]
            children.append(self._popen(
                rank_argv, env, attempt=restarts_total, rank=k,
                world=self.world, degrade_level=self.degrade_level,
                pins=sorted(pins)))
        self._children = children
        return children

    # -- the gang watcher ---------------------------------------------------

    def _watch_gang(self) -> Tuple[str, Optional[int], Dict[str, str]]:
        """Wait for gang completion, the first rank failure, or a stall
        verdict; returns (cause, guilty rank or None, per-rank exits)."""
        children = self._children
        spawned = time.time()
        first_beat_deadline = max(4.0 * self.stall_timeout, 900.0) \
            if self.stall_timeout else float("inf")
        grace = self.stall_timeout or 300.0
        done: Dict[int, str] = {}

        def exits(guilty: Optional[int], cause: str) -> Dict[str, str]:
            out = {}
            for k, ch in enumerate(children):
                if k == guilty:
                    out[f"r{k}"] = cause
                elif k in done:
                    out[f"r{k}"] = done[k]
                elif ch.poll() is None:
                    out[f"r{k}"] = "gang-killed"
                else:
                    out[f"r{k}"] = exitcause.classify(ch.returncode)
            return out

        while True:
            failed = []
            for k, ch in enumerate(children):
                if k in done:
                    continue
                rc = ch.poll()
                if rc is None:
                    continue
                cause = exitcause.classify(rc)
                if cause == exitcause.CAUSE_OK:
                    done[k] = exitcause.CAUSE_OK
                    continue
                if done.get(0) == exitcause.CAUSE_OK:
                    # Rank 0 already completed the run: a peer dying in
                    # teardown cannot un-finish it.
                    self.log(f"rank {k} exited {cause} "
                             f"{exitcause.exit_desc(rc)} after rank 0 "
                             "completed; ignoring")
                    done[k] = cause
                    continue
                failed.append((k, cause, rc))
            if failed:
                # The first rank to fail: gloo fails its peers at once,
                # and they exit with `error` just after it.
                k, cause, rc = next(
                    (f for f in failed if f[1] != exitcause.CAUSE_ERROR),
                    failed[0])
                self.log(f"rank {k} died: {cause} "
                         f"{exitcause.exit_desc(rc)}; killing the gang "
                         "(lockstep: partial survival is useless)")
                _ledger.event("supervisor.kill", reason="rank-death",
                              rank=k, cause=cause, returncode=rc)
                return cause, k, exits(k, cause)
            if len(done) == len(children):
                return exitcause.CAUSE_OK, None, exits(None, "")
            if done.get(0) == exitcause.CAUSE_OK:
                # The primary finished; lockstep peers exit within an
                # allreduce of it.  Give them a grace window, then sweep.
                if self._rank0_done_t is None:
                    self._rank0_done_t = time.time()
                if time.time() - self._rank0_done_t > grace:
                    self.log("rank 0 completed; sweeping "
                             f"{len(children) - len(done)} lingering "
                             "peer(s) after the grace window")
                    ex = exits(None, "")
                    self._kill_gang()
                    return exitcause.CAUSE_OK, None, ex
            elif self.stall_timeout:
                live = [k for k in range(len(children)) if k not in done]
                ages = []
                waiting_first_beat = False
                for k in live:
                    a = heartbeat.age(heartbeat.rank_path(self.hb_path, k))
                    if a is None:
                        # Never beaten: within the first-beat deadline its
                        # liveness is UNKNOWN (setup, or its peers wait
                        # on it), so no verdict yet; past it, maximally
                        # stale.
                        elapsed = time.time() - spawned
                        if elapsed <= first_beat_deadline:
                            waiting_first_beat = True
                            break
                        a = elapsed
                    ages.append(a)
                if waiting_first_beat:
                    time.sleep(POLL_S)
                    continue
                verdict = classify_stall(ages, self.stall_timeout)
                if verdict is not None:
                    guilty = live[max(range(len(ages)),
                                      key=ages.__getitem__)]
                    self.log(
                        f"{verdict}: rank beat ages "
                        + ", ".join(f"r{k}={a:.0f}s"
                                    for k, a in zip(live, ages))
                        + f" against a {self.stall_timeout:.0f}s stall "
                        "window; killing the gang")
                    self._inc("resilience.heartbeat_stalls")
                    _ledger.event("supervisor.kill", reason=verdict,
                                  rank=guilty,
                                  beat_ages_s=[round(a, 1) for a in ages])
                    # Snapshot the exits BEFORE our kill: running peers
                    # read "gang-killed", not our SIGKILL.
                    ex = exits(guilty, verdict)
                    self._kill_gang()
                    return verdict, guilty, ex
            time.sleep(POLL_S)

    # -- the leased fleet gang (ranks that are not in lockstep) -------------

    def _spawn_fleet_rank(self, k: int, attempt: int) -> subprocess.Popen:
        """One fleet rank, by the environment contract only: fleet ranks
        never join a process group (their jobs are independent), so even
        a non-emulated launch spawns plain single-process ranks.  No
        rung: a fleet rank's death indicts its environment, not the
        tier."""
        argv = self._last_argv = self._attempt_argv()
        env = self._rank_env(k, attempt)
        try:
            os.unlink(heartbeat.rank_path(self.hb_path, k))
        except OSError:
            pass
        self.log(f"fleet rank {k}: starting (attempt {attempt}) "
                 + ("(resume -R) " if "-R" in argv else "")
                 + " ".join(argv))
        return self._popen(argv, env, attempt=attempt, rank=k,
                           world=self.world)

    def _run_fleet(self) -> int:
        """The leased-gang loop: a dead rank costs ONLY its in-flight
        leases.  It restarts alone (cause `fleet-rank-death`: no gang
        kill, no rung, no run-level retry), its expired leases are reaped
        by the other ranks, and a rank that keeps dying is ABANDONED
        while the rest serve on."""
        prior = self._install_signals()
        respawn_cap = max(5, 3 * self.max_retries)
        children: Dict[int, subprocess.Popen] = {}
        respawns: Dict[int, int] = {k: 0 for k in range(self.world)}
        spawn_at: Dict[int, float] = {}
        spawned_t: Dict[int, float] = {}
        done: Dict[int, int] = {}
        abandoned: set = set()
        first_beat_deadline = (max(4.0 * self.stall_timeout, 900.0)
                               if self.stall_timeout else float("inf"))
        last_rc = 1

        def rank_died(k: int, cause: str, rc) -> None:
            nonlocal last_rc
            last_rc = rc if rc is not None else 1
            self._inc("resilience.gang.fleet_rank_deaths")
            self._inc("resilience.restarts")
            self._inc(f"resilience.gang.rank_exits.r{k}."
                      f"{cause.replace('-', '_')}")
            self.attempts.append({
                "rank": k, "cause": exitcause.CAUSE_FLEET_RANK_DEATH,
                "rank_cause": cause, "returncode": rc,
                "respawn": respawns[k],
                "seconds": round(time.time() - spawned_t.get(k, 0.0), 2)})
            respawns[k] += 1
            if respawns[k] > respawn_cap:
                abandoned.add(k)
                self._inc("resilience.gang.rank_abandoned")
                _ledger.event("supervisor.rank_abandoned", rank=k,
                              respawns=respawns[k] - 1)
                self.log(f"fleet rank {k} died {respawns[k] - 1} time(s); "
                         "ABANDONING the rank slot (its leases expire; "
                         "peers absorb the queue)")
                return
            delay = backoff_delay(self.backoff, respawns[k],
                                  key=f"{self.run_id}:r{k}")
            spawn_at[k] = time.time() + delay
            _ledger.event("supervisor.restart",
                          cause=exitcause.CAUSE_FLEET_RANK_DEATH,
                          rank=k, rank_cause=cause, retry_consumed=False,
                          delay_s=round(delay, 2))
            self.log(
                f"fleet rank {k} died ({cause} "
                f"{exitcause.exit_desc(rc, none_desc='(killed)')}); "
                f"restarting ONLY this rank in {delay:.1f}s "
                "(fleet-rank-death: its in-flight leases expire and the "
                "other ranks reap them)")

        try:
            for k in range(self.world):
                children[k] = self._spawn_fleet_rank(k, 0)
                spawned_t[k] = time.time()
            while True:
                self._children = [ch for k, ch in sorted(children.items())
                                  if k not in done]
                if self._preempt_signal is not None:
                    self.log(f"supervisor preempted "
                             f"({self._preempt_signal}); draining the "
                             "fleet gang")
                    self._inc("resilience.preempts")
                    self._drain_gang()
                    return exitcause.EXIT_PREEMPTED
                for k in sorted(children):
                    if k in done or k in abandoned:
                        continue
                    ch = children[k]
                    if k in spawn_at:
                        if time.time() >= spawn_at[k]:  # backoff over
                            del spawn_at[k]
                            children[k] = self._spawn_fleet_rank(
                                k, respawns[k])
                            spawned_t[k] = time.time()
                        continue
                    rc = ch.poll()
                    if rc is not None:
                        cause = exitcause.classify(rc)
                        if cause == exitcause.CAUSE_OK:
                            done[k] = 0
                            self.log(f"fleet rank {k}: queue drained, "
                                     "exited cleanly")
                            continue
                        _ledger.event("supervisor.kill",
                                      reason="fleet-rank-death", rank=k,
                                      cause=cause, returncode=rc)
                        rank_died(k, cause, rc)
                        continue
                    # Per-rank liveness: a stalled or job-stuck rank is
                    # killed ALONE (nothing waits on it) and restarted
                    # through the same rank-death path.
                    hb_age = heartbeat.age(
                        heartbeat.rank_path(self.hb_path, k))
                    deadline, jobs = self._fleet_deadline(
                        heartbeat.rank_path(self.hb_path, k))
                    if deadline is not None and time.time() > deadline:
                        for jid in jobs:
                            self._hang_attempts[jid] = \
                                self._hang_attempts.get(jid, 0) + 1
                        self._inc("resilience.fleet_job_stuck_kills")
                        _ledger.event("supervisor.kill",
                                      reason="fleet-job-stuck", rank=k,
                                      jobs=",".join(jobs))
                        self.log(f"fleet rank {k}: batch blew its per-job "
                                 f"deadline (jobs {','.join(jobs)}); "
                                 "killing and restarting the rank (the "
                                 "jobs pay attempts, the run nothing)")
                        self._kill_group(ch)
                        rank_died(k, exitcause.CAUSE_FLEET_JOB_STUCK,
                                  ch.returncode)
                        continue
                    if self.stall_timeout:
                        stalled = (hb_age > self.stall_timeout
                                   if hb_age is not None else
                                   time.time() - spawned_t[k]
                                   > first_beat_deadline)
                        if stalled and deadline is None:
                            self._inc("resilience.heartbeat_stalls")
                            _ledger.event(
                                "supervisor.kill", reason="heartbeat-stall",
                                rank=k, beat_age_s=(round(hb_age, 1)
                                                    if hb_age is not None
                                                    else None))
                            self.log(f"fleet rank {k}: heartbeat stalled; "
                                     "killing and restarting the rank")
                            self._kill_group(ch)
                            rank_died(k, exitcause.CAUSE_HANG_KILL,
                                      ch.returncode)
                            continue
                if len(done) + len(abandoned) >= self.world:
                    break
                time.sleep(POLL_S)
            if done:
                self.log(f"fleet gang completed: {len(done)} rank(s) "
                         "drained the queue"
                         + (f", {len(abandoned)} abandoned"
                            if abandoned else ""))
                _ledger.event("supervisor.done", world=self.world,
                              ranks_ok=len(done),
                              ranks_abandoned=len(abandoned))
                return 0
            self.log("every fleet rank was abandoned; giving up")
            return self._exhausted_rc(last_rc)
        finally:
            self._children = list(children.values())
            self._kill_gang()
            self._restore_signals(prior)
            self._merge_metrics()
            self._finalize_ledger()

    # -- the gang supervision loop ------------------------------------------

    def run(self) -> int:
        if self.fleet:
            return self._run_fleet()
        prior = self._install_signals()
        retries = 0
        preempts = 0
        restarts_total = 0
        try:
            while True:
                if self._preempt_signal is not None:
                    self.log(f"supervisor preempted "
                             f"({self._preempt_signal}) between "
                             "attempts; not restarting")
                    self._inc("resilience.preempts")
                    return exitcause.EXIT_PREEMPTED
                self._rank0_done_t = None
                t0 = time.time()
                self._spawn_gang(restarts_total)
                cause, rank, rank_exits = self._watch_gang()
                if cause == exitcause.CAUSE_PREEMPT:
                    self._drain_gang()       # peers checkpoint, then die
                elif cause != exitcause.CAUSE_OK:
                    self._kill_gang()
                rc = (self._children[rank].returncode
                      if rank is not None
                      else self._children[0].returncode)
                rec = {
                    "attempt": restarts_total, "cause": cause,
                    "rank": rank, "rank_exits": rank_exits,
                    "world": self.world, "returncode": rc,
                    "seconds": round(time.time() - t0, 2),
                    "pins": self._pins(),
                    "degrade_level": self.degrade_level,
                    "resumed": "-R" in self._last_argv}
                if cause != exitcause.CAUSE_OK:
                    rec["partial_counters"] = self._partial_counters(t0)
                self.attempts.append(rec)
                desc = exitcause.exit_desc(rc, none_desc="(gang-killed)")

                if cause == exitcause.CAUSE_OK:
                    self.log(f"gang run completed after {restarts_total} "
                             "restart(s)")
                    _ledger.event("supervisor.done",
                                  restarts=restarts_total,
                                  world=self.world)
                    return 0
                if self._preempt_signal is not None:
                    self.log(f"supervisor preempted "
                             f"({self._preempt_signal}); gang exited "
                             f"{desc}; not restarting")
                    self._inc("resilience.preempts")
                    return exitcause.EXIT_PREEMPTED
                if cause == exitcause.CAUSE_PREEMPT:
                    preempts += 1
                    self._inc("resilience.preempts")
                    if preempts > max(10, 5 * self.max_retries):
                        self.log("preemption storm: giving up")
                        return exitcause.EXIT_PREEMPTED
                    restarts_total += 1
                    self._inc("resilience.restarts")
                    _ledger.event("supervisor.restart", cause="preempt",
                                  rank=rank, retry_consumed=False)
                    self.log(f"rank {rank} preempted {desc}; resuming "
                             "the gang (no retry consumed)")
                    continue
                if cause == exitcause.CAUSE_USAGE:
                    self.log(f"usage error {desc}: not retryable")
                    return rc
                # Gang failure: count the domain, maybe shrink, retry.
                retries += 1
                self._inc("resilience.restarts")
                self._inc(f"resilience.exits.{cause.replace('-', '_')}")
                if rank is not None:
                    self._inc("resilience.gang.rank_exits."
                              f"r{rank}.{cause.replace('-', '_')}")
                if cause == exitcause.CAUSE_COLLECTIVE_WEDGE:
                    self._inc("resilience.gang.collective_wedges")
                elif cause == exitcause.CAUSE_STRAGGLER:
                    self._inc("resilience.gang.straggler_kills")
                elif cause in _RANK_DEATH_CAUSES:
                    self._inc("resilience.gang.rank_deaths")
                # Elastic resume: the streak follows one rank dying on
                # consecutive attempts; any other outcome resets it.
                if cause in _RANK_DEATH_CAUSES and rank is not None:
                    if rank == self._last_dead_rank:
                        self._death_streak += 1
                    else:
                        self._last_dead_rank = rank
                        self._death_streak = 1
                else:
                    self._last_dead_rank = None
                    self._death_streak = 0
                if (self._death_streak >= ELASTIC_CONSECUTIVE_DEATHS
                        and self.world > self.min_ranks):
                    self.world -= 1
                    self._inc("resilience.gang.elastic_resumes")
                    _ledger.event("supervisor.elastic_resume",
                                  dead_rank=rank, world=self.world)
                    self.log(
                        f"elastic resume: rank {rank} died "
                        f"{self._death_streak} consecutive time(s); "
                        f"degrading the gang to {self.world} rank(s) "
                        "(site windows re-derive at parse time; "
                        "checkpoint state is world-size independent)")
                    self._last_dead_rank = None
                    self._death_streak = 0
                if retries > self.max_retries:
                    self.log(f"gang failed ({cause} {desc}); retry "
                             f"budget exhausted after {self.max_retries}")
                    return self._exhausted_rc(rc)
                self._escalate(cause)
                delay = self._retry_delay(retries)
                have_ckpt = bool(checkpoint_glob(self.workdir,
                                                 self.run_id))
                _ledger.event("supervisor.restart", cause=cause,
                              rank=rank, retry=retries,
                              resumed=have_ckpt, world=self.world,
                              delay_s=round(delay, 2),
                              degrade_level=self.degrade_level,
                              pins=sorted(self._pins()))
                self.log(
                    f"gang failed ({cause} {desc}); retry "
                    f"{retries}/{self.max_retries} in {delay:.1f}s "
                    + ("from newest coordinated checkpoint"
                       if have_ckpt else "from scratch (no checkpoint)")
                    + (f", degradation level {self.degrade_level} "
                       f"pins {self._pins()}"
                       if self._pins() else ""))
                time.sleep(delay)
                restarts_total += 1
        finally:
            self._kill_gang()
            self._restore_signals(prior)
            self._merge_metrics()
            self._finalize_ledger()

    def _resilience_blob(self) -> dict:
        blob = super()._resilience_blob()
        blob["gang"] = {"ranks_initial": self._max_world,
                        "ranks_final": self.world,
                        "emulate": self.emulate,
                        "min_ranks": self.min_ranks}
        return blob


def _common(args) -> dict:
    return dict(workdir=getattr(args, "workdir", ".") or ".",
                run_id=args.run_id,
                max_retries=getattr(args, "supervise_retries",
                                    DEFAULT_RETRIES),
                stall_timeout=getattr(args, "supervise_stall",
                                      DEFAULT_STALL),
                backoff=getattr(args, "supervise_backoff", 2.0),
                metrics_file=getattr(args, "metrics_file", None),
                ledger_dir=getattr(args, "ledger_dir", None))


def launch_gang(argv: List[str], args, log=print,
                child_cmd: Optional[List[str]] = None) -> int:
    """CLI entry of `--launch N`: spawn and supervise the whole gang.
    Fleet modes (-b/-N/--serve) get the leased-rank policy: a rank death
    restarts only that rank (`fleet-rank-death`)."""
    fleet = bool(getattr(args, "bootstrap", 0)
                 or getattr(args, "multi_start", 0)
                 or getattr(args, "serve", None))
    sup = GangSupervisor(
        argv, ranks=getattr(args, "launch", 1) or 1,
        emulate=getattr(args, "launch_emulate", False),
        min_ranks=getattr(args, "launch_min_ranks", 1), fleet=fleet,
        log=log, child_cmd=child_cmd, **_common(args))
    return sup.run()


def supervise(argv: List[str], args, log=print,
              child_cmd: Optional[List[str]] = None) -> int:
    """CLI entry of `--supervise`: run `argv` (the full original command
    line) under supervision.  `args` is the parsed namespace; only the
    supervisor and file-placement flags are read here."""
    return Supervisor(argv, log=log, child_cmd=child_cmd,
                      **_common(args)).run()
