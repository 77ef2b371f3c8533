"""Shared worker/child exit classification (stdlib-only by contract).

The port of `examl_tpu/resilience/exitcause.py`, verbatim: one taxonomy
for every process that watches another process die (a supervisor, a
test driving the CLI in a subprocess), and the exit codes the CLI
returns (`EXIT_PREEMPTED`, `EXIT_ALLOC_OOM`).

Two layers:

* `exit_desc(rc)` — the human-readable suffix used in logs/artifacts:
  "(signal SIGILL)" / "(returncode 3)".  Negative returncodes name
  their signal so a SIGILL from a mis-featured kernel reads differently
  from an OOM SIGKILL or a hang-kill.
* `classify(rc, hang_killed=...)` — the machine-readable cause a
  supervisor's retry/degradation policy branches on.
"""

from __future__ import annotations

import signal
from typing import Optional

# Clean "I was preempted and checkpointed" exit code: BSD EX_TEMPFAIL,
# the conventional "transient failure, retry me" status.  The supervisor
# treats it as resumable without consuming a retry; schedulers that
# understand sysexits do the right thing too.
EXIT_PREEMPTED = 75

# Argparse's usage-error status: retrying an invalid command line can
# never succeed, so the supervisor gives up immediately.
EXIT_USAGE = 2

# Device-allocator OOM the child classified ITSELF (memgov caught a
# RESOURCE_EXHAUSTED that survived evict+shrink retries and exited
# cleanly with this status).  Distinct from the OS oom-kill below: the
# kernel's SIGKILL carries no self-diagnosis, while this code means
# "HBM budget too high" — the supervisor's restart pins the budget
# fraction down instead of escalating the tier ladder.
EXIT_ALLOC_OOM = 76

# classify() causes, in rough severity order.
CAUSE_OK = "ok"
CAUSE_PREEMPT = "preempt"          # clean SIGTERM/SIGINT checkpoint+exit
CAUSE_HANG_KILL = "hang-kill"      # the watcher killed it (stall/deadline)
# Gang-watcher verdicts (never produced by classify(rc) — like
# hang-kill they are the WATCHER's judgement, which outranks the raw
# signal of the SIGKILL it sent):
CAUSE_COLLECTIVE_WEDGE = "collective-wedge"  # ALL ranks' beats went
                                   # stale together: a wedged collective
                                   # (psum/allreduce) or program hang
                                   # every rank is blocked inside
CAUSE_STRAGGLER = "straggler-stall"  # ONE rank stopped beating while
                                   # its peers stayed fresh: a rank-local
                                   # stall (lockstep means the fresh
                                   # peers are already blocked on it)
CAUSE_FLEET_RANK_DEATH = "fleet-rank-death"  # a LEASED fleet gang rank
                                   # died: fleet gangs are NOT lockstep
                                   # (jobs are independent, held under
                                   # per-rank leases), so the watcher
                                   # restarts ONLY that rank — no
                                   # gang-wide kill, no tier pin, no
                                   # run-level retry; the dead rank's
                                   # leases expire and peers reap them
CAUSE_FLEET_JOB_STUCK = "fleet-job-stuck"  # the fleet heartbeat named an
                                   # in-flight batch whose per-job
                                   # deadline expired: a JOB-level fault
                                   # domain — the supervisor kills the
                                   # attempt, records the suspect jobs,
                                   # and resumes WITHOUT consuming a
                                   # run-level retry or pinning a tier
CAUSE_OOM_KILL = "oom-kill"        # external SIGKILL: the kernel OOM
                                   # killer is the usual sender when the
                                   # watcher did not kill it itself
CAUSE_ALLOC_OOM = "alloc-oom"      # device-allocator RESOURCE_EXHAUSTED
                                   # the child diagnosed itself
                                   # (EXIT_ALLOC_OOM): retryable with a
                                   # LOWER memory budget pin, NOT a tier
                                   # suspect — the program tier is fine,
                                   # its working set is not
CAUSE_SIGILL = "sigill"            # mis-featured kernel / cache poisoning
CAUSE_CRASH = "crash"              # SIGSEGV/SIGBUS/SIGABRT/SIGFPE
CAUSE_TERMINATED = "terminated"    # SIGTERM that did NOT checkpoint
CAUSE_USAGE = "usage"              # argparse error: never retryable
CAUSE_ERROR = "error"              # plain nonzero exit (raised exception)
CAUSE_RUNNING = "running"

# Causes a supervisor may retry.  "usage" and "ok" are final; "preempt"
# is resumable but handled on a separate (non-retry-budget) path.
RETRYABLE = frozenset({CAUSE_HANG_KILL, CAUSE_OOM_KILL, CAUSE_SIGILL,
                       CAUSE_CRASH, CAUSE_TERMINATED, CAUSE_ERROR,
                       CAUSE_COLLECTIVE_WEDGE, CAUSE_STRAGGLER,
                       CAUSE_ALLOC_OOM})

# Causes that indicate the *program tier* (not the environment) may be
# at fault — these escalate the supervisor's degradation ladder
# (pallas→chunk→scan), mirroring the bank's `_is_wedge` rule that only
# deadline kills and deaths-by-signal justify routing around a family.
# A collective wedge is the program-wedge class by definition; a
# single-rank straggler is presumed environmental (one slow/blocked
# host) and retries on the same tier.
TIER_SUSPECT = frozenset({CAUSE_HANG_KILL, CAUSE_SIGILL, CAUSE_CRASH,
                          CAUSE_OOM_KILL, CAUSE_COLLECTIVE_WEDGE})

def exit_desc(rc: Optional[int], none_desc: str = "(still running)") -> str:
    """Human-readable exit cause for a Popen returncode.

    `none_desc` covers the rc-is-None case, which different watchers
    read differently: the bank polls (None = still running) while the
    bench names it after the action it just took (None = hang-killed).
    """
    if rc is None:
        return none_desc
    if rc < 0:
        try:
            return f"(signal {signal.Signals(-rc).name})"
        except ValueError:
            return f"(signal {-rc})"
    return f"(returncode {rc})"


def classify(rc: Optional[int], hang_killed: bool = False) -> str:
    """Map a child's returncode to a retry-policy cause.

    `hang_killed=True` means the WATCHER killed the child (heartbeat
    stall, compile deadline) — that verdict outranks the raw signal,
    because a SIGKILL we sent must not read as an OOM kill.
    """
    if hang_killed:
        return CAUSE_HANG_KILL
    if rc is None:
        return CAUSE_RUNNING
    if rc == 0:
        return CAUSE_OK
    if rc == EXIT_PREEMPTED:
        return CAUSE_PREEMPT
    if rc == EXIT_USAGE:
        return CAUSE_USAGE
    if rc == EXIT_ALLOC_OOM:
        return CAUSE_ALLOC_OOM
    if rc < 0:
        sig = -rc
        if sig == signal.SIGILL:
            return CAUSE_SIGILL
        if sig == signal.SIGKILL:
            return CAUSE_OOM_KILL
        if sig == signal.SIGTERM or sig == signal.SIGINT:
            return CAUSE_TERMINATED
        # Everything else (SEGV/BUS/ABRT/FPE and any exotic signal): the
        # process died involuntarily — a crash for retry purposes.
        return CAUSE_CRASH
    return CAUSE_ERROR
