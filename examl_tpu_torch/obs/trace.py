"""Span tracer: an in-memory span recorder on the profiler's clock, and
Chrome-trace / Perfetto-compatible JSONL event files.

The port of `examl_tpu/obs/trace.py`: the same files, layout and
readers, so the JAX package's `read_events` / `merge_summary` and
`tools/run_report.py` read the port's traces.

A span records only while someone traces the process: the trace file is
open (`enable(dir, procid)`, which the CLI's `--trace-events` calls),
annotations are on (`set_annotations`, the CLI's `--profile`), or a
torch.profiler session is active (`torch._C._autograd._profiler_enabled()`).
Otherwise `span()` / `device_span()` return the shared no-op `_NULL`
after that one check.

* **The recorder** keeps every recorded span in memory (`Recorder`): its
  name, start and end stamps, thread, the index of its parent span on
  the same thread, the index of its root span (so the spans of one probe
  or one prune share a root) and its `args`, the counts taken at that
  boundary (`note()` adds those known only inside the span).  The buffer
  has a fixed number of slots, allocated at the first span; a full
  buffer counts the spans it drops.  Nothing is written per span:
  readers take `recorded()` and `self_time()`.
* **One clock with the profiler**: while a profiler session is active
  every span, host or device, enters a `record_function` twin of its
  name, so the profiler's trace holds the program's spans.  The recorder
  stamps with `time.time_ns()` just inside the twin: the trace file's
  clock and the epoch clock of the profiler's events.
* **The trace file** (`--trace-events`) stays the crash sink: spans are
  B/E *pairs*, flushed per event, so a process that dies or wedges
  inside a span leaves an unmatched "B" naming it as the file's last
  line; one file per process, named by procid (`trace.p<procid>.jsonl`),
  so the ranks of a site-parallel run never interleave writers; process
  0 merges a cross-process `summary.json` at exit.  The file is a
  streaming Chrome-trace JSON array: a `[` header, one event object per
  line each terminated by a comma, closed with a metadata event + `]` at
  finalize.  Perfetto and chrome://tracing load both the finalized file
  and a crash-truncated one.  Timestamps are epoch microseconds, so
  traces from different processes of one job line up on a shared axis.

Nothing here reads a tensor or imports torch: a span costs host time
only, and the profiler check binds to torch once torch is imported.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import List, NamedTuple, Optional, Sequence


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def note(self, **counts) -> None:
        pass


_NULL = _NullContext()

_lock = threading.Lock()
_writer: Optional["TraceWriter"] = None
_annotate = False
# Recording without a profiler session: the trace file is open or
# annotations are on.
_forced = False


def _now_us() -> int:
    return time.time_ns() // 1000


def _profiler_check() -> bool:
    """Whether a torch.profiler session is active.  Until torch is
    imported there is none; then `_profiling` binds to torch's own check
    (about 70 ns a call)."""
    global _profiling
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _profiling = torch._C._autograd._profiler_enabled
    return _profiling()


_profiling = _profiler_check
_twin_type = None


def _twin(name: str):
    """The profiler's record_function scope of `name`: the C++ fast scope
    where torch has one (its stamps sit within a microsecond or two of
    the recorder's), else `torch.profiler.record_function`."""
    global _twin_type
    if _twin_type is None:
        import torch
        _twin_type = getattr(torch._C._profiler, "_RecordFunctionFast",
                             torch.profiler.record_function)
    return _twin_type(name)


class TraceWriter:
    def __init__(self, path: str, procid: int) -> None:
        self.path = path
        self.procid = procid
        self._lock = threading.Lock()
        self._tids: dict = {}
        self._f = open(path, "w")
        self._f.write("[\n")
        self.event({"ph": "M", "name": "process_name", "pid": procid,
                    "tid": 0, "ts": _now_us(),
                    "args": {"name": f"examl-tpu proc {procid}"}})

    def tid(self) -> int:
        ident = threading.get_ident()
        t = self._tids.get(ident)
        if t is None:
            with self._lock:
                t = self._tids.setdefault(ident, len(self._tids))
        return t

    def event(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + ",\n")
            self._f.flush()           # crash-robust: the last span survives

    def close(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            # Final metadata event carries no trailing comma so the file
            # closes as strictly valid JSON.
            self._f.write(json.dumps(
                {"ph": "M", "name": "trace_shutdown", "pid": self.procid,
                 "tid": 0, "ts": _now_us(), "args": {}},
                separators=(",", ":")) + "\n]\n")
            self._f.close()


# -- the in-memory recorder -------------------------------------------------

CAPACITY = 1 << 16


class Span(NamedTuple):
    """One recorded span; stamps are epoch ns (`time.time_ns()`)."""
    index: int
    name: str
    start: int
    end: int
    thread: int
    parent: int                  # enclosing span on the thread, -1 at a root
    root: int                    # outermost enclosing span (itself at a root)
    args: Optional[dict]

    @property
    def duration(self) -> int:
        return self.end - self.start


class Recorder:
    """`capacity` span slots, one list per field, filled in order.  A span
    takes its slot when it opens and stamps its end when it closes; once
    every slot is taken, further spans are counted in `dropped` and not
    kept (their children attach to the nearest kept ancestor)."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        self.capacity = capacity
        self._name: list = [None] * capacity
        self._start = [0] * capacity
        self._end = [0] * capacity
        self._thread = [0] * capacity
        self._parent = [-1] * capacity
        self._root = [-1] * capacity
        self._args: list = [None] * capacity
        self._lock = threading.Lock()
        self._local = threading.local()     # each thread's open spans
        self.n = 0
        self.dropped = 0

    def open(self, name: str, args: Optional[dict]) -> int:
        """Take a slot for a span about to start (`stamp` sets its
        start); returns its index, -1 when the buffer is full."""
        with self._lock:
            i = self.n
            if i >= self.capacity:
                self.dropped += 1
                return -1
            self.n = i + 1
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else -1
        self._name[i] = name
        self._thread[i] = threading.get_ident()
        self._parent[i] = parent
        self._root[i] = self._root[parent] if parent >= 0 else i
        self._args[i] = args
        stack.append(i)
        return i

    def stamp(self, i: int, t: int) -> None:
        if i >= 0:
            self._start[i] = t

    def close(self, i: int, t: int, args: Optional[dict]) -> None:
        if i < 0:
            return
        self._end[i] = t
        self._args[i] = args
        stack = self._local.stack
        if stack[-1] == i:
            stack.pop()
        else:                               # closed out of order
            stack.remove(i)

    def spans(self) -> List[Span]:
        """Every closed span, in the order they opened."""
        return [Span(i, self._name[i], self._start[i], self._end[i],
                     self._thread[i], self._parent[i], self._root[i],
                     self._args[i])
                for i in range(min(self.n, self.capacity)) if self._end[i]]


_recorder: Optional[Recorder] = None


def recorder() -> Recorder:
    """This process's recorder, made at its first span."""
    global _recorder
    with _lock:
        if _recorder is None:
            _recorder = Recorder()
        return _recorder


def recorded() -> List[Span]:
    """The spans recorded so far, closed ones only, in opening order."""
    r = _recorder
    return r.spans() if r is not None else []


def dropped() -> int:
    """Spans not kept because the buffer was full."""
    r = _recorder
    return r.dropped if r is not None else 0


def reset_recorder(capacity: Optional[int] = None) -> None:
    """Forget every recorded span; the next buffer has `capacity` slots
    (CAPACITY by default, allocated at the next span).  Spans open now
    close into the buffer they opened in."""
    global _recorder
    with _lock:
        _recorder = None if capacity is None else Recorder(capacity)


def self_time(spans: Sequence[Span], span: Span) -> int:
    """`span`'s duration in ns less the part of it that its child spans
    (those in `spans` whose parent it is) cover."""
    covered, reach = 0, span.start
    for s, e in sorted((c.start, c.end) for c in spans
                       if c.parent == span.index):
        s, e = max(s, reach), min(e, span.end)
        if e > s:
            covered += e - s
            reach = e
    return span.duration - covered


class _Span:
    """A recorded span: the profiler twin (while a session is active),
    the recorder's slot and, with the trace file open, its B/E pair."""

    __slots__ = ("name", "cat", "args", "_rec", "_i", "_tw")

    def __init__(self, name: str, cat: str, args: Optional[dict]):
        self.name = name
        self.cat = cat
        self.args = args

    def note(self, **counts) -> None:
        """Add counts taken inside the span to its args."""
        self.args = counts if self.args is None else {**self.args, **counts}

    # The recorder's stamps are the innermost step on either side, and
    # the twin's the next: a span's duration leaves out the recorder's own
    # bookkeeping and the trace file's writes, and the twin's stamps lie
    # within a few microseconds of the recorder's.

    def __enter__(self):
        rec = self._rec = _recorder or recorder()
        i = self._i = rec.open(self.name, self.args)
        w = _writer
        if w is not None:
            ev = {"ph": "B", "name": self.name, "cat": self.cat,
                  "pid": w.procid, "tid": w.tid(), "ts": _now_us()}
            if self.args:
                ev["args"] = self.args
            w.event(ev)
        tw = None
        if _profiling():
            tw = _twin(self.name)
            tw.__enter__()
        self._tw = tw
        rec.stamp(i, time.time_ns())
        return self

    def __exit__(self, *exc):
        t = time.time_ns()
        if self._tw is not None:
            self._tw.__exit__(*exc)
        self._rec.close(self._i, t, self.args)
        w = _writer
        if w is not None:
            ev = {"ph": "E", "name": self.name, "cat": self.cat,
                  "pid": w.procid, "tid": w.tid(), "ts": _now_us()}
            if self.args:
                ev["args"] = self.args
            w.event(ev)
        return False


def _default_procid() -> int:
    """The rank of the port's process group when one is up
    (parallel/launch.py joins it), else EXAML_PROCID, else 0.  Two ranks
    may share one card, so the procid never comes from the device."""
    # Only a group that is already up counts: tracing setup never
    # imports torch on its own.
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and \
                dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    env = os.environ.get("EXAML_PROCID")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return 0


def _refresh_forced() -> None:
    global _forced
    _forced = _writer is not None or _annotate


def enable(trace_dir: str, procid: Optional[int] = None) -> str:
    """Open this process's trace file under `trace_dir`; returns its
    path.  Idempotent: re-enabling returns the existing file."""
    global _writer
    with _lock:
        if _writer is not None:
            return _writer.path
        if procid is None:
            procid = _default_procid()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace.p{procid}.jsonl")
        _writer = TraceWriter(path, procid)
        _refresh_forced()
        atexit.register(finalize)
        return path


def enabled() -> bool:
    return _writer is not None


def set_annotations(on: bool) -> None:
    """Record spans without the JSONL writer (the CLI sets this under
    --profile, whose torch.profiler session then gets every span as a
    named scope)."""
    global _annotate
    _annotate = on
    _refresh_forced()


def span(name: str, cat: str = "host", args: Optional[dict] = None):
    """A host-side span context manager; no-op unless someone traces."""
    if not (_forced or _profiling()):
        return _NULL
    return _Span(name, cat, args)


def device_span(name: str, args: Optional[dict] = None):
    """A span around a device dispatch (category "dispatch" in the trace
    file); no-op unless someone traces."""
    if not (_forced or _profiling()):
        return _NULL
    return _Span(name, "dispatch", args)


def instant(name: str, args: Optional[dict] = None) -> None:
    """A zero-duration marker event."""
    if _writer is None:
        return
    ev = {"ph": "i", "s": "p", "name": name, "cat": "event",
          "pid": _writer.procid, "tid": _writer.tid(), "ts": _now_us()}
    if args:
        ev["args"] = args
    _writer.event(ev)


def read_events(path: str) -> list:
    """Parse a trace file (finalized or crash-truncated) into a list of
    event dicts — the shared reader for the summary merge and the tests."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if not line or line in ("[", "]"):
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue              # torn final line of a crashed writer
    return events


def merge_summary(trace_dir: str) -> Optional[str]:
    """Merge every per-process trace file in `trace_dir` into
    summary.json: per-file event counts plus aggregate span wall time by
    name.  Best-effort — files from still-running processes are summed
    as far as they have been written."""
    try:
        names = sorted(n for n in os.listdir(trace_dir)
                       if n.startswith("trace.p") and n.endswith(".jsonl"))
    except OSError:
        return None
    files = {}
    spans: dict = {}
    for name in names:
        events = read_events(os.path.join(trace_dir, name))
        files[name] = {"events": len(events)}
        open_spans: dict = {}
        for ev in events:
            key = (ev.get("pid"), ev.get("tid"), ev.get("name"))
            if ev.get("ph") == "B":
                open_spans.setdefault(key, []).append(ev.get("ts", 0))
            elif ev.get("ph") == "E" and open_spans.get(key):
                t0 = open_spans[key].pop()
                agg = spans.setdefault(
                    ev.get("name"), {"count": 0, "total_us": 0})
                agg["count"] += 1
                agg["total_us"] += max(0, ev.get("ts", t0) - t0)
        for key, starts in open_spans.items():
            if starts:
                agg = spans.setdefault(key[2], {"count": 0, "total_us": 0})
                agg["unfinished"] = agg.get("unfinished", 0) + len(starts)
    # Top spans by wall time — but unfinished spans (the evidence of a
    # wedge this file exists to preserve) are ALWAYS included, even with
    # zero completed time.
    top = dict(sorted(spans.items(),
                      key=lambda kv: -kv[1].get("total_us", 0))[:50])
    top.update({n: s for n, s in spans.items() if s.get("unfinished")})
    out = os.path.join(trace_dir, "summary.json")
    try:
        with open(out, "w") as f:
            json.dump({"files": files, "spans": top}, f, indent=2,
                      sort_keys=True)
    except OSError:
        return None
    return out


def finalize() -> None:
    """Close this process's trace file; process 0 merges the summary."""
    global _writer
    with _lock:
        w = _writer
        _writer = None
        _refresh_forced()
    if w is None:
        return
    w.close()
    if w.procid == 0:
        merge_summary(os.path.dirname(w.path) or ".")
