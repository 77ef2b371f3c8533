"""Preemption safety: SIGTERM/SIGINT -> flag -> emergency checkpoint ->
clean resumable exit.

The port of `examl_tpu/resilience/preempt.py`.  A preemptible card gets
a SIGTERM and a short grace window.  The signal only sets a flag; the
run's checkpoint-callback cadence (the one place where instance and
tree state is coherent enough to serialize — reference
`searchAlgo.c:1102-1146` writes at the same sites) notices it after
its next write, and the process exits with EXIT_PREEMPTED (75,
EX_TEMPFAIL), which a supervisor treats as resumable and batch
schedulers that understand sysexits retry.  Nothing is written from the
handler.

A SECOND SIGTERM/SIGINT restores default disposition and re-raises, so
an operator mashing Ctrl-C still gets an immediate (unclean) exit.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional

from examl_tpu_torch.resilience.exitcause import EXIT_PREEMPTED  # noqa: F401

_STATE = {"requested": None, "prior": None}


class PreemptCheckpointed(Exception):
    """Raised at a checkpoint site after the emergency write; the CLI
    converts it into EXIT_PREEMPTED."""

    def __init__(self, signame: str):
        super().__init__(f"preempted by {signame}; emergency checkpoint "
                         "written")
        self.signame = signame


def requested() -> Optional[str]:
    """Name of the preemption signal received, or None."""
    return _STATE["requested"]


def install(log: Optional[Callable[[str], None]] = None) -> bool:
    """Install the SIGTERM/SIGINT flag handlers.  Returns False (no-op)
    off the main thread — `signal.signal` is main-thread-only, and the
    process group and the fleet's serve loop may run other threads."""
    if threading.current_thread() is not threading.main_thread():
        return False
    _STATE["requested"] = None

    def handler(signum, frame):
        name = signal.Signals(signum).name
        if _STATE["requested"] is not None:
            # Second signal: the operator means NOW.
            signal.signal(signum, signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        _STATE["requested"] = name
        if log is not None:
            try:
                log(f"EXAML: received {name}: will write an emergency "
                    "checkpoint at the next checkpoint site and exit "
                    f"resumable (code {EXIT_PREEMPTED}); repeat the "
                    "signal to exit immediately")
            except Exception:         # noqa: BLE001 — never die in a handler
                pass

    _STATE["prior"] = (signal.signal(signal.SIGTERM, handler),
                       signal.signal(signal.SIGINT, handler))
    return True


def uninstall() -> None:
    """Restore prior signal dispositions and clear the flag (the CLI's
    try/finally — callers may invoke main() repeatedly in one
    process)."""
    prior = _STATE["prior"]
    if prior is not None:
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, prior[0])
            signal.signal(signal.SIGINT, prior[1])
        _STATE["prior"] = None
    _STATE["requested"] = None


def check_after_checkpoint(log: Optional[Callable[[str], None]] = None
                           ) -> None:
    """Call IMMEDIATELY AFTER a successful checkpoint write: raises
    PreemptCheckpointed when a preemption signal is pending, so the
    checkpoint just written becomes the resume point."""
    name = _STATE["requested"]
    if name is None:
        return
    try:
        from examl_tpu_torch import obs
        obs.inc("resilience.preempt_checkpoints")
    except Exception:                 # noqa: BLE001
        pass
    if log is not None:
        log(f"EXAML: {name} honored: emergency checkpoint written; "
            f"exiting resumable (code {EXIT_PREEMPTED})")
    raise PreemptCheckpointed(name)
