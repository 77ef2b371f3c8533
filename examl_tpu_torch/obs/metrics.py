"""Process-wide metrics registry: counters, gauges, timers.

The port of `examl_tpu/obs/metrics.py`, the same registry and snapshot
layout.  Everything here is stdlib-only and always on — a counter
increment is a dict update under a lock, computed from host values the
caller already holds, never from a device read — while the expensive
instruments (trace events, device-memory gauges) stay behind explicit
opt-ins (`obs.trace`, snapshot collectors).

Naming convention (dotted, lowercase; the names the port records):

  engine.dispatch_count        engine entry points called (traversals,
                               evaluations, derivatives, scans)
  engine.traversal_entries     newview entries submitted
  engine.traffic_bytes         modeled bytes moved by traversals
                               (obs/traffic.py, from the launch table
                               and entry counts on the host)
  engine.sched_cache.hit/miss/evictions   topology-keyed layout cache
  engine.instances             engines built
  engine.compile_count, engine.compile_seconds[.family]   CUDA
                               extension builds (ops/_build.py)
  engine.nonfinite_retries/.nonfinite_recovered   NaN-lnL wave-scan
                               retries (instance.evaluate)
  host_schedule                timer: host-side layout building
  resilience.heartbeats        published search-loop liveness beats
  resilience.preempt_checkpoints   emergency checkpoints before exit 75
  checkpoint.corrupt_skipped   unreadable checkpoints skipped at restore
  faults.fired.<point>         injected faults that fired
  mem.*                        memory governor (resilience/memgov.py)
  search.spr_cycles, search.fast_cycles, search.thorough_cycles,
  search.scan_dispatches, search.scan_candidates, search.model_opt_rounds
  optimize.grad_smooth_sweeps, optimize.grad_smooth_unconverged
  fleet.*                      fleet jobs, batches and failures
  phase.<name>                 CLI wall-clock phases (timers)

Counters accept float increments (compile_seconds accumulates wall
seconds); timers record count/total/min/max of observed durations PLUS
a log-bucketed latency histogram (obs/hist.py), so every snapshot
carries p50/p95/p99 per timer.  Snapshot collectors let owners of live
state (engines) publish gauges lazily — they run only when `snapshot()`
is taken, so per-call cost is zero, and they hold weak references so a
registry never keeps a CLV arena alive.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional

from examl_tpu_torch.obs import hist as _hist


class TimerStat:
    __slots__ = ("count", "total", "min", "max", "hist")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.hist = _hist.Histogram()

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = seconds if self.min is None else min(self.min, seconds)
        self.max = seconds if self.max is None else max(self.max, seconds)
        self.hist.observe(seconds)

    def as_dict(self) -> dict:
        d = {"count": self.count, "total_s": self.total,
             "min_s": self.min, "max_s": self.max}
        # Quantiles + the raw sparse buckets: the buckets are what lets
        # two snapshots MERGE exactly (a supervisor's attempt merging) —
        # merged quantiles recompute from summed buckets, never from
        # quantiles.
        d.update(self.hist.quantiles())
        d["buckets"] = self.hist.to_dict()
        return d


class _TimerContext:
    """Context manager that observes its own wall duration into a timer;
    exposes `.elapsed` (seconds) after exit so callers can reuse the one
    measurement instead of re-bracketing with perf_counter."""

    __slots__ = ("_registry", "_name", "_t0", "elapsed")

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self._registry = registry
        self._name = name
        self.elapsed = 0.0

    def __enter__(self) -> "_TimerContext":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
        self._registry.observe(self._name, self.elapsed)


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, TimerStat] = {}
        self._collectors: list = []

    # -- counters / gauges / timers ----------------------------------------

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            stat = self._timers.get(name)
            if stat is None:
                stat = self._timers[name] = TimerStat()
            stat.observe(seconds)

    def timer(self, name: str) -> _TimerContext:
        return _TimerContext(self, name)

    # -- collectors ---------------------------------------------------------

    def add_collector(self, fn: Callable[[], bool]) -> None:
        """Register a zero-arg callable run at every snapshot().  It may
        set gauges; returning False (or raising) unregisters it — the
        idiom for weakref-bound owners that have been collected."""
        with self._lock:
            self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                if fn() is False:
                    dead.append(fn)
            except Exception:
                dead.append(fn)
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]

    # -- snapshot / reset ---------------------------------------------------

    def snapshot(self) -> dict:
        self._run_collectors()
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {n: t.as_dict() for n, t in self._timers.items()},
            }

    def snapshot_counters(self) -> Dict[str, float]:
        """Counters only, WITHOUT running collectors: the cheap form for
        high-frequency consumers (the resilience heartbeat embeds this
        in every published beat — collectors may touch device state and
        must not run on the search loop's iteration clock)."""
        with self._lock:
            return dict(self._counters)

    def snapshot_light(self) -> dict:
        """Full snapshot shape WITHOUT running collectors: counters,
        last-set gauges, timers.  The periodic-flush form — safe on the
        search loop's clock for the same reason as snapshot_counters
        (collectors may touch device state)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {n: t.as_dict() for n, t in self._timers.items()},
            }

    def reset(self) -> None:
        """Clear counters/gauges/timers (collectors stay registered —
        their owners are still live)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# -- periodic snapshot flush -------------------------------------------------
# A `--metrics` snapshot written only at exit leaves nothing behind a
# SIGKILLed or hang-killed process, so a supervisor would have no
# last-known counters to merge for the killed attempt.  The CLI arms
# this and the resilience heartbeat ticks it on every published beat:
# a cheap collector-free snapshot lands on disk on a rate-limited
# cadence (atomic tmp+rename, so the supervisor never reads torn JSON),
# marked `"partial": true` so consumers can tell a mid-run flush from
# the final at-exit snapshot that overwrites it.

DEFAULT_FLUSH_INTERVAL_S = 5.0

_FLUSH = {"path": None, "interval": DEFAULT_FLUSH_INTERVAL_S, "last": 0.0}


def set_autoflush(path: Optional[str],
                  interval: float = DEFAULT_FLUSH_INTERVAL_S) -> None:
    """Arm (or, with None, disarm) the periodic snapshot flush, at most
    one every `interval` seconds (tests pin it to 0 so a run killed
    seconds in still leaves counter-bearing evidence)."""
    _FLUSH.update(path=path, interval=float(interval), last=0.0)


def maybe_autoflush(force: bool = False) -> bool:
    """Write the collector-free snapshot if armed and the cadence is
    due; returns True when a flush happened.  Never raises: a full or
    read-only disk must not kill the run it observes."""
    path = _FLUSH["path"]
    if path is None:
        return False
    now = time.time()
    if not force and now - _FLUSH["last"] < _FLUSH["interval"]:
        return False
    _FLUSH["last"] = now
    snap = _REGISTRY.snapshot_light()
    snap["partial"] = True
    snap["flushed_at"] = now
    try:
        # Collector-free by design, but the program table is plain
        # host data — a killed run's last flush should still name the
        # extensions it had built (obs/programs.py).
        from examl_tpu_torch.obs import programs as _programs
        rows = _programs.table()
        if rows:
            snap["programs"] = rows
    except Exception:                        # noqa: BLE001 — never-raise
        pass
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(snap, f, sort_keys=True, default=str)
        # Best-effort mid-run flush on the heartbeat clock (never-raise
        # contract); the exit snapshot overwrites it, and a lost flush
        # costs one cadence of counters.
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    return True
