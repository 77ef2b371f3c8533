"""Deterministic fault injection (stdlib-only by contract).

The port of `examl_tpu/resilience/faults.py`: the same spec grammar, hit
counting, attempt gating and sticky points.  Every recovery path of the
port — checkpoint fallback, non-finite retry, preemption, the fleet's
job quarantine and OOM halving — is testable on the CPU without waiting
for the card to misbehave: arming a point makes its seam fail exactly
the way the observed failure mode does.

Arming (comma-separated specs, via `EXAML_FAULTS` or `--inject-fault`):

    point[@rank=R][:job=ID][:after=N][:attempt=K][:bytes=N][:signal=NAME][:hang[=SECS]][:raise]

* `@rank=R`   — fire only in the process whose rank (`EXAML_PROCID`)
  equals R.  Non-target ranks never tick the point's hit counter, so
  `after=N` keeps addressing "the Nth iteration of rank R".  Also
  accepted as a `:rank=R` field.
* `after=N`   — fire on the Nth check of the point (default 1).
* `attempt=K` — fire only when `EXAML_RESTART_COUNT` == K (default 0,
  i.e. only a supervisor's FIRST attempt; `attempt=*` fires on every
  attempt).
* `signal=NAME` / `hang[=SECS]` / `raise` override the point's default
  action: signal self (KILL/TERM/ILL/SEGV/...), sleep, or raise
  `FaultInjected`.

Points the port has (seam -> default action):

    engine.dispatch    instance.evaluate, before dispatch     -> raise
    engine.nonfinite   instance.evaluate, poisons lnL to NaN  -> flag
    checkpoint.write   CheckpointManager.write, pre-publish   -> raise
    checkpoint.publish gang checkpoint, staged -> publish     -> raise
    search.kill        heartbeat.beat (per search iteration)  -> signal KILL
    heartbeat.stall    heartbeat.beat, sticky beat suppressor -> flag
    fleet.dispatch     fleet driver, before a batch dispatch  -> raise
    fleet.job.poison   fleet dispatch, poisons ONE job's lnL  -> flag (sticky)
    fleet.job.hang     fleet dispatch while job ID is batched -> hang
    fleet.results.write  fleet results-journal append         -> raise
    fleet.lease.write  lease-board publish (stage/fsync)      -> raise
    fleet.lease.reap   expired-lease reap steal               -> raise
    mem.oom            fleet dispatch, synthetic OOM          -> raise
    mem.pressure       memgov budget clamp (bytes=N)          -> flag (sticky)

The JAX package's other points (NOT_YET_PORTED) name seams the port
does not have yet; arming one fails at parse time, never silently.

`flag` points have no side effect here — `fire()` returns True and the
seam implements the failure (NaN substitution, beat suppression).

JOB-TARGETED points take a `job=ID` field: the seam passes the job id
it is about to dispatch, and the spec is inert — hit counter untouched,
like `@rank` — for every other job, so `after=N` addresses "the Nth
dispatch CONTAINING job ID".  `fleet.job.poison` is sticky: a poison job
stays poison on every retry, which is exactly what the per-job
retry/quarantine ladder must converge against.
"""

from __future__ import annotations

import os
import signal as _signal
import time
from dataclasses import dataclass
from typing import Dict, Optional

ENV_VAR = "EXAML_FAULTS"
ATTEMPT_VAR = "EXAML_RESTART_COUNT"

POINTS = {
    "engine.dispatch": "raise at the engine dispatch boundary",
    "engine.nonfinite": "poison the dispatched log-likelihood with NaN",
    "checkpoint.write": "fail a checkpoint write before publish",
    "checkpoint.publish": "fail/kill between a fully-staged gang "
                          "checkpoint cycle and its publish rename",
    "search.kill": "signal self at the Nth search-loop heartbeat",
    "heartbeat.stall": "stop emitting heartbeats (sticky)",
    "fleet.dispatch": "raise at the fleet batched-dispatch boundary",
    "fleet.job.poison": "poison one fleet job's lnL to NaN (job=ID; "
                        "sticky — a poison job stays poison on retry)",
    "fleet.job.hang": "hang the fleet dispatch while job ID is batched",
    "fleet.results.write": "fail a fleet results-journal append",
    "fleet.lease.write": "fail a job-lease publish (stage/fsync seam)",
    "fleet.lease.reap": "fail an expired-lease reap steal mid-flight",
    "mem.oom": "raise a synthetic out-of-memory error at a dispatch seam",
    "mem.pressure": "clamp the memory governor's budget to N bytes "
                    "(bytes=N; sticky — pressure persists once applied)",
}

# The JAX package's points whose seams the port does not have yet, with
# the work that brings each (ROADMAP A10c).
NOT_YET_PORTED = {
    "compile.hang": "the extension bank (ops/bank.py)",
    "bank.worker": "the extension bank (ops/bank.py)",
    "bank.export.write": "the extension bank (ops/export_bank.py)",
    "bank.export.load": "the extension bank (ops/export_bank.py)",
}

_DEFAULT_ACTION = {
    "search.kill": ("signal", "KILL"),
    "engine.nonfinite": ("flag", None),
    "heartbeat.stall": ("flag", None),
    "fleet.job.poison": ("flag", None),
    "fleet.job.hang": ("hang", 3600.0),
    "mem.pressure": ("flag", None),
}

_STICKY = frozenset({"heartbeat.stall", "fleet.job.poison",
                     "mem.pressure"})


class FaultInjected(RuntimeError):
    """Raised by `raise`-action injection points."""


@dataclass
class FaultSpec:
    point: str
    after: int = 1
    attempt: Optional[int] = 0          # None = every attempt ("*")
    action: str = "raise"               # raise | signal | hang | flag
    arg: object = None                  # signal name / hang seconds
    rank: Optional[int] = None          # None = every rank
    job: Optional[str] = None           # None = every job (fleet.job.*)


def parse_spec(text: str) -> Dict[str, FaultSpec]:
    """Parse an EXAML_FAULTS value into {point: FaultSpec}.

    Unknown points raise ValueError — a typo'd injection that silently
    never fires would make a chaos test pass vacuously — and so do the
    JAX package's points the port has no seam for yet.
    """
    specs: Dict[str, FaultSpec] = {}
    for item in (text or "").split(","):
        item = item.strip()
        if not item:
            continue
        fields = item.split(":")
        point, _, ranktag = fields[0].partition("@")
        if point in NOT_YET_PORTED:
            raise ValueError(
                f"fault point {point!r} is not yet ported: the port has "
                f"no seam for it until {NOT_YET_PORTED[point]} is ported "
                "(known: " + ", ".join(sorted(POINTS)) + ")")
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (known: "
                + ", ".join(sorted(POINTS)) + ")")
        action, arg = _DEFAULT_ACTION.get(point, ("raise", None))
        spec = FaultSpec(point=point, action=action, arg=arg)
        if ranktag:
            key, _, val = ranktag.partition("=")
            if key != "rank" or not val:
                raise ValueError(
                    f"bad rank qualifier {ranktag!r} in {item!r} "
                    "(expected point@rank=R)")
            spec.rank = int(val)
        for f in fields[1:]:
            key, _, val = f.partition("=")
            if key == "after":
                spec.after = max(1, int(val))
            elif key == "attempt":
                spec.attempt = None if val == "*" else int(val)
            elif key == "signal":
                spec.action, spec.arg = "signal", (val or "KILL").upper()
            elif key == "hang":
                spec.action = "hang"
                spec.arg = float(val) if val else 3600.0
            elif key == "raise":
                spec.action, spec.arg = "raise", None
            elif key == "rank":
                spec.rank = int(val)
            elif key == "job":
                if not val:
                    raise ValueError(
                        f"empty job qualifier in {item!r} "
                        "(expected point:job=ID)")
                spec.job = val
            elif key == "bytes":
                # Value-carrying flag field (mem.pressure): the seam
                # reads spec.arg as the clamped budget in bytes.
                try:
                    spec.arg = int(val)
                except ValueError:
                    raise ValueError(
                        f"bad bytes qualifier {f!r} in {item!r} "
                        "(expected point:bytes=N)") from None
            else:
                raise ValueError(f"unknown fault field {f!r} in {item!r}")
        if point in specs:
            # One spec per point: silently keeping only the last would
            # make e.g. "search.kill@rank=0,search.kill@rank=1" arm a
            # DIFFERENT chaos scenario than written.  (To hit every
            # rank, omit the rank qualifier.)
            raise ValueError(
                f"duplicate spec for fault point {point!r}: only one "
                "spec per point may be armed")
        specs[point] = spec
    return specs


# Process state: specs are re-parsed whenever the env text changes (the
# CLI merges --inject-fault into EXAML_FAULTS; tests monkeypatch it),
# hit counters persist for the life of the process, sticky points stay
# fired once triggered.
_STATE = {"raw": None, "specs": {}, "hits": {}, "fired": set()}


def reset() -> None:
    """Clear hit counters and sticky state (one CLI run = one fault
    record; tests invoking main() repeatedly must not inherit counts)."""
    _STATE.update(raw=None, specs={}, hits={}, fired=set())


def _specs() -> Dict[str, FaultSpec]:
    raw = os.environ.get(ENV_VAR, "")
    if raw != _STATE["raw"]:
        _STATE["raw"] = raw
        try:
            _STATE["specs"] = parse_spec(raw)
        except ValueError as exc:
            # An unparseable env must be loud but not fatal mid-seam.
            import sys
            sys.stderr.write(f"EXAML: ignoring {ENV_VAR}: {exc}\n")
            _STATE["specs"] = {}
    return _STATE["specs"]


def arm(spec_text: str) -> None:
    """Append spec(s) to the environment registry (validates eagerly, so
    `--inject-fault typo.point` fails at argument time, not mid-run)."""
    parse_spec(spec_text)
    prior = os.environ.get(ENV_VAR, "")
    os.environ[ENV_VAR] = (prior + "," if prior else "") + spec_text


def _attempt() -> int:
    try:
        return int(os.environ.get(ATTEMPT_VAR, "0") or 0)
    except ValueError:
        return 0


def _rank() -> int:
    """This process's rank — one parser for EXAML_PROCID:
    resilience/heartbeat.py owns it (lazy import; heartbeat imports
    this module at load time)."""
    from examl_tpu_torch.resilience import heartbeat
    return heartbeat.env_rank()


def armed(point: str, job: Optional[str] = None) -> Optional[FaultSpec]:
    """Check (and count) one hit of `point`; the spec when THIS hit
    fires, else None.  Sticky points keep firing once triggered.
    `job` is the fleet job id the calling seam is dispatching — a
    job-qualified spec is inert (no hit tick) for every other job."""
    spec = _specs().get(point)
    if spec is None:
        return None
    if spec.rank is not None and _rank() != spec.rank:
        # Rank-targeted spec in a non-target rank: inert, and it must
        # not tick the hit counter — `after=N` addresses rank R's own
        # iteration clock.
        return None
    if spec.job is not None and job != spec.job:
        # Job-targeted spec checked for a different job (or from a
        # seam with no job in hand): inert, counter untouched —
        # `after=N` addresses dispatches CONTAINING the target job.
        return None
    if spec.attempt is not None and _attempt() != spec.attempt:
        return None
    if point in _STATE["fired"] and point in _STICKY:
        return spec
    hits = _STATE["hits"].get(point, 0) + 1
    _STATE["hits"][point] = hits
    if hits != spec.after:
        return None
    _STATE["fired"].add(point)
    return spec


def fire(point: str, job: Optional[str] = None) -> bool:
    """Check `point` and perform its action.  Returns False when not
    armed; True for `flag` points (the seam implements the failure);
    raises / signals / hangs otherwise."""
    spec = armed(point, job=job)
    if spec is None:
        return False
    try:                              # count fired faults when obs exists
        from examl_tpu_torch import obs
        obs.inc(f"faults.fired.{point}")
        obs.ledger_event("fault", point=point, action=spec.action,
                         job=job if spec.job is not None else None)
        obs.log(f"EXAML: fault injection: {point} fired "
                f"(action {spec.action})")
    except Exception:                 # noqa: BLE001 — stdlib-only callers
        pass
    if spec.action == "flag":
        return True
    if spec.action == "hang":
        time.sleep(float(spec.arg or 3600.0))
        return True
    if spec.action == "signal":
        name = str(spec.arg or "KILL")
        sig = getattr(_signal, "SIG" + name, None) \
            if not name.startswith("SIG") else getattr(_signal, name, None)
        if sig is None:
            raise ValueError(f"unknown signal {name!r} for fault {point}")
        os.kill(os.getpid(), int(sig))
        # A non-fatal signal (TERM with a handler installed) returns:
        # the seam continues and the handler's flag does the rest.
        return True
    raise FaultInjected(f"injected fault at {point}")
