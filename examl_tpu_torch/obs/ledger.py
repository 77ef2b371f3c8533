"""Run ledger: an append-only per-rank JSONL event stream.

The port of `examl_tpu/obs/ledger.py`, the same files, record keys and
merge, so the JAX package's `read_events` / `merge` and the report tools
read the port's ledgers (and a later supervisor merges them).  Events
are emitted from the real seams — CLI phases and the run's start and
end, fault firings, checkpoint publishes, memory-governor decisions,
fleet jobs and batches — one JSON object per line, flushed per event so
a SIGKILLed process's last decision is on disk.

Contract (mirrors obs/trace.py, same procid suffix convention as the
heartbeat/trace files):

* one file per process: `ledger.p<procid>.jsonl` (a supervisor writes
  `ledger.psup.jsonl` — it shares the directory with its rank-0 child
  and must never clobber its stream);
* every record carries a per-process monotone `seq` and an epoch-µs
  `ts`, so the exit-time MERGE — every rank re-merges, the last one
  out completing `ledger.merged.jsonl`, ordered by (ts, proc, seq) — is
  one totally ordered timeline;
* stdlib-only BY CONTRACT: a supervisor and the report tools read and
  write ledgers with no torch anywhere on the import path;
* readers tolerate crash-truncated files (a torn final line is skipped,
  like obs.trace.read_events) — a killed rank's ledger must merge, not
  poison the timeline.

Off unless enabled (`--ledger DIR`, auto-on next to `--metrics`, or
`EXAML_LEDGER_DIR`, checked lazily so subprocesses join the timeline
for free).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import List, Optional, Union

ENV_VAR = "EXAML_LEDGER_DIR"
MERGED_NAME = "ledger.merged.jsonl"

_lock = threading.Lock()
_STATE = {"f": None, "path": None, "dir": None, "proc": None, "seq": 0,
          "env_checked": False}


def _now_us() -> int:
    return time.time_ns() // 1000


def _default_proc() -> Union[int, str]:
    """The rank of the port's process group when one is up, else
    EXAML_PROCID, else 0 (obs/trace.py's resolver)."""
    from examl_tpu_torch.obs.trace import _default_procid
    return _default_procid()


def file_name(proc: Union[int, str]) -> str:
    return f"ledger.p{proc}.jsonl"


def default_dir(ledger_dir: Optional[str],
                metrics_file: Optional[str]) -> Optional[str]:
    """The ONE ledger-placement rule, shared by the CLI and a supervisor
    (which must derive the same directory to write its own
    `ledger.psup.jsonl` and run the final merge): an explicit --ledger
    DIR wins; otherwise the ledger lands next to the --metrics file —
    a run that asked for metrics gets the timeline artifact with it."""
    if ledger_dir:
        return ledger_dir
    if metrics_file:
        return os.path.dirname(os.path.abspath(metrics_file)) or "."
    return None


def enable(ledger_dir: str,
           proc: Optional[Union[int, str]] = None) -> Optional[str]:
    """Open this process's ledger file under `ledger_dir` (append mode:
    a supervised retry in the same rank slot extends the stream rather
    than erasing the failed attempt's evidence).  Idempotent; returns
    the path, or None when the directory cannot be created."""
    with _lock:
        _STATE["env_checked"] = True
        if _STATE["f"] is not None:
            return _STATE["path"]
        if proc is None:
            proc = _default_proc()
        try:
            os.makedirs(ledger_dir, exist_ok=True)
            path = os.path.join(ledger_dir, file_name(proc))
            f = open(path, "a")
        except OSError:
            return None
        _STATE.update(f=f, path=path, dir=ledger_dir, proc=proc)
        atexit.register(finalize)
        return path


def enabled() -> bool:
    return _STATE["f"] is not None


def reset() -> None:
    """Close without merging and forget the env check (tests; one
    in-process CLI run must not inherit a previous run's stream)."""
    with _lock:
        f = _STATE["f"]
        _STATE.update(f=None, path=None, dir=None, proc=None, seq=0,
                      env_checked=False)
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


def active_dir() -> Optional[str]:
    return _STATE["dir"]


def _maybe_env_enable() -> bool:
    if _STATE["env_checked"]:
        return _STATE["f"] is not None
    with _lock:
        _STATE["env_checked"] = True
    env = os.environ.get(ENV_VAR)
    if env:
        enable(env)
    return _STATE["f"] is not None


def event(kind: str, **fields) -> None:
    """Append one event; no-op unless enabled (or EXAML_LEDGER_DIR is
    set).  Never raises — a full disk must not kill the run."""
    if _STATE["f"] is None and not _maybe_env_enable():
        return
    with _lock:
        f = _STATE["f"]
        if f is None or f.closed:
            return
        _STATE["seq"] += 1
        rec = {"ts": _now_us(), "seq": _STATE["seq"],
               "proc": _STATE["proc"], "pid": os.getpid(), "kind": kind}
        rec.update(fields)
        try:
            f.write(json.dumps(rec, separators=(",", ":"),
                               default=str) + "\n")
            f.flush()                 # crash-robust: the last event lands
        except (OSError, ValueError):
            pass


def finalize() -> Optional[str]:
    """Close this process's ledger and merge the directory into one
    ordered timeline.  EVERY rank merges (merge() is idempotent and
    publishes via atomic rename), so in an unsupervised multi-rank run
    the last rank to exit rewrites `ledger.merged.jsonl` with every
    peer's final events — a rank-0-only merge would race the peers'
    tails.  Returns the merged path."""
    with _lock:
        f = _STATE["f"]
        d = _STATE["dir"]
        _STATE.update(f=None, path=None, dir=None, proc=None, seq=0)
    if f is None:
        return None
    try:
        f.close()
    except OSError:
        pass
    if d is not None:
        return merge(d)
    return None


def read_events(path: str) -> List[dict]:
    """Parse one ledger file, tolerating a torn final line (the
    crash-truncation artifact of a SIGKILLed writer)."""
    events: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue          # torn final line of a killed writer
                if isinstance(ev, dict):
                    events.append(ev)
    except OSError:
        pass
    return events


def read_dir(ledger_dir: str) -> List[dict]:
    """Every per-process ledger in `ledger_dir`, merged IN MEMORY and
    totally ordered by (ts, proc, seq) — for viewers/report tools that
    must not write into a run's (possibly read-only, archived)
    artifact directory."""
    try:
        names = sorted(n for n in os.listdir(ledger_dir)
                       if n.startswith("ledger.p")
                       and n.endswith(".jsonl"))
    except OSError:
        return []
    events: List[dict] = []
    for name in names:
        events.extend(read_events(os.path.join(ledger_dir, name)))
    events.sort(key=lambda ev: (ev.get("ts", 0), str(ev.get("proc")),
                                ev.get("seq", 0)))
    return events


def merge(ledger_dir: str) -> Optional[str]:
    """Merge every per-process ledger in `ledger_dir` into
    `ledger.merged.jsonl`, totally ordered by (ts, proc, seq) — one
    timeline for every rank.  Best-effort and idempotent (re-merging
    after more events re-sorts the union)."""
    events = read_dir(ledger_dir)
    if not events:
        return None
    out = os.path.join(ledger_dir, MERGED_NAME)
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, separators=(",", ":"),
                                   default=str) + "\n")
        # Derived artifact: the merged view re-merges from the per-rank
        # streams at any time (read_dir), so a torn merge costs a
        # re-merge, not evidence.
        os.replace(tmp, out)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return out
