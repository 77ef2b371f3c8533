"""Search-loop heartbeat: the liveness signal of a running search.

The port of `examl_tpu/resilience/heartbeat.py`.  A wedged kernel launch
or collective hangs the main thread with no Python-level recourse, and
only an outside watcher can act.  The search loop therefore calls
`beat()` on every iteration (SPR slot, optimizer round, evaluated tree),
and the long HOST-SIDE setup phases call `phase_beat()` (PARSE/PACK/
SCHEDULE — tree build loops, alignment packing, layout assembly) so a
legitimate large setup never reads as a wedge.  When
`EXAML_HEARTBEAT_FILE` is set each rate-limited beat atomically
publishes a small JSON record: timestamp, pid, sequence number, loop
state, and a snapshot of the obs registry's counters — so a stall is
not just detectable but *attributable*.  Every beat also ticks the
`--metrics` autoflush, with or without a heartbeat file.

The `search.kill` and `heartbeat.stall` fault points live here: beats
are the search loop's iteration clock, so `after=N` addresses "the Nth
search iteration" for chaos tests.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from examl_tpu_torch.resilience import faults

ENV_VAR = "EXAML_HEARTBEAT_FILE"

# Rank contract (the JAX package's gang supervisor exports these; the
# port's CLI exports EXAML_PROCID for the ranks of a site-parallel
# run): EXAML_GANG_RANKS=N is the world size and EXAML_PROCID the rank.
# Rank 0 beats into the base path a watcher reads; rank k>0 into
# `<base>.p<k>` (`rank_path`), so a watcher can tell a single straggler
# from a collective wedge.
PROCID_VAR = "EXAML_PROCID"
GANG_VAR = "EXAML_GANG_RANKS"

# Minimum seconds between file writes.  Beats are called per SPR slot
# (possibly hundreds/second on small trees); the file is for stall
# detection on the tens-of-seconds scale, so 0.5 s of write cadence
# costs nothing and bounds the I/O.
MIN_INTERVAL = 0.5

_STATE = {"path": None, "installed": False, "last": 0.0, "seq": 0,
          "stalled": False, "last_state": None}


def install(path: Optional[str] = None) -> Optional[str]:
    """Point beats at `path` (default: $EXAML_HEARTBEAT_FILE).  Returns
    the active path, or None when heartbeats stay disabled."""
    path = path or os.environ.get(ENV_VAR) or None
    _STATE.update(path=path, installed=True, last=0.0, seq=0,
                  stalled=False, last_state=None)
    return path


def reset() -> None:
    """Disable + clear (one CLI run = one heartbeat stream)."""
    _STATE.update(path=None, installed=False, last=0.0, seq=0,
                  stalled=False, last_state=None)


def beat(state: str = "", payload: Optional[dict] = None) -> None:
    """One search-loop iteration happened.  Cheap no-op when no
    heartbeat file is configured — except for the fault points, which
    must tick even unsupervised so chaos tests can address "the Nth
    iteration" without also requiring a supervisor.

    `payload` merges extra top-level fields into the published record
    and FORCES the publish past the rate limit (the fleet driver
    declares the in-flight batch's job ids with it), so a payload is
    never skipped or reordered by the rate limiter."""
    # search.kill: a signal action never returns (SIGKILL) or sets the
    # preemption flag (TERM/INT with the handler installed).
    faults.fire("search.kill")
    if faults.fire("heartbeat.stall"):
        _STATE["stalled"] = True
    _publish(state, payload)


def phase_beat(state: str = "", payload: Optional[dict] = None) -> None:
    """Liveness from long HOST-SIDE setup phases (PARSE/PACK/SCHEDULE)
    and from fleet bookkeeping beats (retry-backoff waits, the
    in-flight-declaration clear after a batch): a legitimate large tree
    build or layout assembly must not read as a dispatch wedge.

    Publishes exactly like `beat()` (same file, same rate limit, same
    stall-injection suppression, same payload force-publish) but does
    NOT tick the `search.kill` / `heartbeat.stall` fault points —
    those count SEARCH iterations (one per fleet batch), and
    setup-phase liveness must not shift the `after=N` addressing chaos
    tests rely on."""
    _publish(state, payload)


def _publish(state: str, payload: Optional[dict] = None) -> None:
    # Loop-state transitions are ledger events (independent of the
    # heartbeat file and its rate limit): the merged timeline shows
    # FAST_SPRS -> SLOW_SPRS -> MOD_OPT with timestamps even for runs
    # nobody supervised.
    if state and state != _STATE["last_state"]:
        _STATE["last_state"] = state
        try:
            from examl_tpu_torch import obs
            obs.ledger_event("search.state", state=state)
        except Exception:             # noqa: BLE001
            pass
    if _STATE["stalled"]:
        return
    # Piggybacked periodic --metrics flush: the beat cadence is the
    # liveness clock, so a killed process's snapshot is at most one
    # flush interval stale (collector-free — see snapshot_light).
    # Ticked BEFORE the heartbeat-file gate: an unsupervised run with
    # --metrics but no EXAML_HEARTBEAT_FILE must flush too.
    try:
        from examl_tpu_torch import obs
        obs.maybe_autoflush()
    except Exception:                 # noqa: BLE001
        pass
    if not _STATE["installed"]:
        install()
    path = _STATE["path"]
    if path is None:
        return
    now = time.time()
    _STATE["seq"] += 1
    if payload is None and now - _STATE["last"] < MIN_INTERVAL:
        return
    _STATE["last"] = now
    try:
        from examl_tpu_torch import obs
        counters = obs.snapshot_counters()
        obs.inc("resilience.heartbeats")
    except Exception:                 # noqa: BLE001
        counters = {}
    record = {"t": now, "pid": os.getpid(), "seq": _STATE["seq"],
              "state": state, "counters": counters}
    if payload:
        record.update(payload)
    # Atomic publish contract: write the full record to a pid-suffixed
    # tmp and rename.  A watcher polls these files from another process
    # — a plain in-place write would hand it torn JSON under exactly the
    # load a stall decision matters most.
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(record, f)
        # Atomicity-only publish: a beat is superseded within seconds and
        # a lost one reads as one stall tick; fsync per beat would put
        # disk latency on the loop clock.
        os.replace(tmp, path)         # readers never see a partial record
    except OSError:
        # A full/readonly disk must not kill the search it monitors.
        try:
            os.unlink(tmp)
        except OSError:
            pass


def read(path: str) -> Optional[dict]:
    """The last published heartbeat record, or None (no file yet, or a
    transiently unreadable one — callers key stall decisions off file
    AGE, so a None here is simply 'no evidence')."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def age(path: str) -> Optional[float]:
    """Seconds since the last heartbeat PUBLISH (file mtime — immune to
    clock skew in the payload), or None when no heartbeat exists yet."""
    try:
        return max(0.0, time.time() - os.stat(path).st_mtime)
    except OSError:
        return None


# -- rank aggregation (stdlib-only: a torch-free watcher reads these;
# parallel/launch.install_heartbeat uses the same naming) ---------------


def env_rank() -> int:
    """This process's gang rank (`EXAML_PROCID`; 0 when unset)."""
    try:
        return int(os.environ.get(PROCID_VAR, "0") or 0)
    except ValueError:
        return 0


def env_gang_size() -> Optional[int]:
    """The gang's world size (`EXAML_GANG_RANKS`), or None when no
    launcher exported it."""
    try:
        n = int(os.environ.get(GANG_VAR, "") or 0)
    except ValueError:
        return None
    return n if n > 0 else None


def rank_path(base: str, rank: int) -> str:
    """Rank `rank`'s heartbeat file for a watcher of `base` (rank 0
    keeps the base path; peers suffix `.p<rank>`)."""
    return base if rank == 0 else f"{base}.p{rank}"


def gang_paths(base: str, nranks: int) -> list:
    return [rank_path(base, k) for k in range(nranks)]


def gang_ages(base: str, nranks: int) -> list:
    """Per-rank beat ages for the gang watcher (None = that rank has
    never published a beat)."""
    return [age(p) for p in gang_paths(base, nranks)]
