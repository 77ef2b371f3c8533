"""Span tracer: Chrome-trace / Perfetto-compatible JSONL event files.

The port of `examl_tpu/obs/trace.py`: the same files, layout and
readers, so the JAX package's `read_events` / `merge_summary` and
`tools/run_report.py` read the port's traces.

Off by default and zero-cost when off: `span()` returns a shared no-op
context unless tracing was enabled (by `enable(dir, procid)`, which the
CLI's `--trace-events` calls).

* spans are B/E *pairs*, flushed per event — a process that dies or
  wedges inside a span leaves an unmatched "B" naming it as the file's
  last line;
* one file per process, named by procid (`trace.p<procid>.jsonl`), so
  the ranks of a site-parallel run never interleave writers; process 0
  merges a cross-process `summary.json` at exit;
* the file is a streaming Chrome-trace JSON array: a `[` header, one
  event object per line each terminated by a comma, closed with a
  metadata event + `]` at finalize.  Perfetto and chrome://tracing load
  both the finalized file and a crash-truncated one (the format is
  specified to tolerate a missing terminator).

Timestamps are epoch microseconds (`time.time_ns() // 1000`) so traces
from different processes of one job line up on a shared axis.

`device_span()` additionally enters a `torch.profiler.record_function`
scope (when annotations are on: tracing enabled or `--profile` active)
so host spans line up with the kernels in a torch.profiler trace.
Nothing here reads a tensor: a span costs host time only.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Optional


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()

_lock = threading.Lock()
_writer: Optional["TraceWriter"] = None
_annotate = False


def _now_us() -> int:
    return time.time_ns() // 1000


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


class _Span:
    __slots__ = ("_name", "_cat", "_args", "_writer")

    def __init__(self, writer: TraceWriter, name: str, cat: str, args):
        self._writer = writer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        w = self._writer
        ev = {"ph": "B", "name": self._name, "cat": self._cat,
              "pid": w.procid, "tid": w.tid(), "ts": _now_us()}
        if self._args:
            ev["args"] = self._args
        w.event(ev)
        return self

    def __exit__(self, *exc):
        w = self._writer
        w.event({"ph": "E", "name": self._name, "cat": self._cat,
                 "pid": w.procid, "tid": w.tid(), "ts": _now_us()})
        return False


class _DeviceSpan(_Span):
    """Host span + torch.profiler.record_function scope, so the host
    trace and a torch.profiler trace share span names."""

    __slots__ = ("_tm",)

    def __enter__(self):
        self._tm = None
        if _annotate:
            try:
                import torch
                self._tm = torch.profiler.record_function(self._name)
                self._tm.__enter__()
            except Exception:
                self._tm = None
        if self._writer is not None:
            super().__enter__()
        return self

    def __exit__(self, *exc):
        if self._writer is not None:
            super().__exit__(*exc)
        if self._tm is not None:
            try:
                self._tm.__exit__(*exc)
            except Exception:
                pass
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


def enable(trace_dir: str, procid: Optional[int] = None) -> str:
    """Open this process's trace file under `trace_dir`; returns its
    path.  Idempotent: re-enabling returns the existing file."""
    global _writer, _annotate
    with _lock:
        if _writer is not None:
            return _writer.path
        if procid is None:
            procid = _default_procid()
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"trace.p{procid}.jsonl")
        _writer = TraceWriter(path, procid)
        _annotate = True
        atexit.register(finalize)
        return path


def enabled() -> bool:
    return _writer is not None


def set_annotations(on: bool) -> None:
    """Turn record_function scopes on/off independently of the JSONL
    writer (the CLI sets this under --profile so a torch.profiler trace
    gets named scopes even without --trace-events)."""
    global _annotate
    _annotate = on


def span(name: str, cat: str = "host", args: Optional[dict] = None):
    """A host-side span context manager; no-op unless tracing is on."""
    if _writer is None:
        return _NULL
    return _Span(_writer, name, cat, args)


def device_span(name: str, args: Optional[dict] = None):
    """A span around a device dispatch: host trace event +
    record_function (annotations may be on without the JSONL writer,
    under --profile)."""
    if _writer is None and not _annotate:
        return _NULL
    return _DeviceSpan(_writer, name, "dispatch", args)


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
    if w is None:
        return
    w.close()
    if w.procid == 0:
        merge_summary(os.path.dirname(w.path) or ".")
