"""examl_tpu_torch.obs — the port's runtime observability.

The port of `examl_tpu/obs/`, the same names, file formats and counter
names, so the JAX package's readers and `tools/run_report.py` read the
port's artifacts.  Dependency-free pieces (no torch, no numpy at import):

* a process-wide **metrics registry** (`obs.metrics`): counters, gauges,
  timers with log-bucketed latency histograms (`obs.hist`) — always on,
  dict-update cheap — plus a heartbeat-ticked periodic snapshot flush
  so a killed process leaves its last-known counters behind;
* a **span tracer** (`obs.trace`): spans that record only while
  someone traces the process (`--trace-events`, `--profile`, or any
  torch.profiler session), kept in memory for readers, each with a
  `torch.profiler` twin of its name on the profiler's clock, and, under
  `--trace-events`, Chrome-trace/Perfetto-compatible per-process JSONL
  files;
* a **run ledger** (`obs.ledger`): append-only per-rank JSONL event
  stream (phases, faults, checkpoint publishes, memory-governor and
  fleet decisions), merged into one ordered timeline at exit;
* the shared **traffic model** (`obs.traffic`);
* the **program observatory** (`obs.programs`): one row per CUDA
  extension instance, and device-memory gauges.

This module is the flat facade the rest of the port imports:

    from examl_tpu_torch import obs
    obs.inc("engine.dispatch_count")
    with obs.device_span("engine:traverse", args={"entries": n}):
        ...
    with obs.device_span("engine:operands") as sp:
        ...
        if sp:                        # counts only where a span records
            sp.note(p_bytes=nbytes)

A thread may be made quiet (`set_quiet`): the facade's counters, gauges,
timers, spans and ledger events are then no-ops on it.  The site shards
of one process (parallel/shards.py) run an engine op on S threads, and
every shard but rank 0 runs quiet, so an op is counted, timed and traced
once, as on one card.  A kernel wrapper's launch count goes to the
registry itself (`registry().inc`) and counts every launch.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

from examl_tpu_torch.obs import ledger as _ledger
from examl_tpu_torch.obs import metrics as _metrics
from examl_tpu_torch.obs import trace as _trace
from examl_tpu_torch.obs import traffic  # noqa: F401  (shared roofline model)
from examl_tpu_torch.obs.ledger import (  # noqa: F401
    enable as enable_ledger, enabled as ledger_enabled,
    finalize as finalize_ledger, merge as merge_ledger,
    read_events as read_ledger)
from examl_tpu_torch.obs.metrics import (  # noqa: F401
    maybe_autoflush, set_autoflush)
from examl_tpu_torch.obs.trace import (  # noqa: F401
    enable as enable_tracing, enabled as tracing_enabled,
    finalize as finalize_tracing, merge_summary, read_events,
    set_annotations)

# -- quiet threads ------------------------------------------------------------

class _ThreadFlags(threading.local):
    quiet = False      # a class default: reading it raises nothing


_thread = _ThreadFlags()


def set_quiet(on: bool) -> None:
    """Turn this thread's instruments off (on=True) or back on."""
    _thread.quiet = bool(on)


def quiet() -> bool:
    return _thread.quiet


def span(name: str, cat: str = "host", args: Optional[dict] = None):
    s = _trace.span(name, cat, args)
    return _trace._NULL if s is not _trace._NULL and quiet() else s


def device_span(name: str, args: Optional[dict] = None):
    s = _trace.device_span(name, args)
    return _trace._NULL if s is not _trace._NULL and quiet() else s


def instant(name: str, args: Optional[dict] = None) -> None:
    if not quiet():
        _trace.instant(name, args)


def ledger_event(kind: str, **fields) -> None:
    if not quiet():
        _ledger.event(kind, **fields)

# -- metrics facade ---------------------------------------------------------


def registry() -> _metrics.MetricsRegistry:
    return _metrics.registry()


def inc(name: str, value: float = 1) -> None:
    if not quiet():
        _metrics.registry().inc(name, value)


def counter(name: str) -> float:
    return _metrics.registry().counter(name)


def gauge(name: str, value: float) -> None:
    if not quiet():
        _metrics.registry().gauge(name, value)


def observe(name: str, seconds: float) -> None:
    if not quiet():
        _metrics.registry().observe(name, seconds)


def timer(name: str):
    return _trace._NULL if quiet() else _metrics.registry().timer(name)


def add_collector(fn: Callable[[], bool]) -> None:
    _metrics.registry().add_collector(fn)


def snapshot() -> dict:
    snap = _metrics.registry().snapshot()
    # The program observatory's registry rows ride in every snapshot so
    # tools/run_report.py can render the Programs table from the same
    # artifact that carries the gauges.
    from examl_tpu_torch.obs import programs as _programs
    rows = _programs.table()
    if rows:
        snap["programs"] = rows
    return snap


def snapshot_counters() -> dict:
    """Counters only, no collectors — safe on hot loops (heartbeat)."""
    return _metrics.registry().snapshot_counters()


def reset() -> None:
    _metrics.registry().reset()


# -- operator log sink ------------------------------------------------------
# Runtime components that must reach the operator (fault firings, the
# non-finite retry) write through here: always stderr, plus whatever
# sink the CLI installed (the ExaML_info file).

_log_sink: Optional[Callable[[str], None]] = None


def set_log_sink(fn: Optional[Callable[[str], None]]) -> None:
    global _log_sink
    _log_sink = fn


def log(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sink = _log_sink
    if sink is not None:
        try:
            sink(msg)
        except Exception:
            pass
