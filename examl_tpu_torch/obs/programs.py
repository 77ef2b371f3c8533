"""Program observatory: one row per CUDA extension the run loaded.

The port of `examl_tpu/obs/programs.py`.  The JAX package's "programs"
are XLA executables; the port's are the CUDA extensions `ops/_build.py`
builds with nvcc (or finds built) and loads: one registry row per
extension and kernel instance, with its family (the extension's name),
key (the instance: the kernel entry point ptxas compiled), source
(`built` or `cached`), build seconds, and — wherever the build's ptxas
log gives them — the instance's registers, stack frame and spill bytes.

XLA's cost and memory analyses have no counterpart for a hand-written
kernel: every row counts them as missing fields
(`program.analysis_missing.<field>`, the rung the JAX package counts when
a backend returns no analysis) rather than carrying a made-up figure.

Three consumers, all fed from the one registry:

* the table embedded in every `--metrics` snapshot (obs.snapshot) —
  `tools/run_report.py` renders it as the "Programs" table;
* a `programs.p<procid>.jsonl` stream next to the run ledger (same
  per-rank suffix, append + flush-per-row; the JAX package's
  `read_stream` / `read_dir` read it) so a SIGKILLed process leaves its
  evidence behind;
* `program.*` gauges.

Live device-memory telemetry rides the same module: `sample_memory()`
reads `torch.cuda.memory_stats` / `mem_get_info` (at most one sample
every MEM_SAMPLE_S seconds) into `mem.device.<k>.{in_use,peak,limit}`
gauges, and on the CPU the host resident set into `mem.host.rss`.  It never
touches a card the process has not initialized, and reads allocator
counters only: no synchronization.

stdlib-only at import: torch is consulted only when the process has
already imported it.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from typing import Dict, List, Optional

from examl_tpu_torch.obs import ledger as _ledger
from examl_tpu_torch.obs import metrics as _metrics

# XLA's analyses, which no CUDA extension has: counted missing per row.
MISSING_ANALYSES = ("cost_analysis", "memory_analysis")

_lock = threading.Lock()
_STATE: Dict[str, object] = {
    "rows": {},            # (family, key) -> row dict, insertion-ordered
    "families": set(),     # families with a row
    "stream": None,        # open programs.p<proc>.jsonl handle
    "stream_dir": None,
    "mem_last": None,      # monotonic of the last memory sample
    "collector": False,
}


# Least seconds between two memory samples (0 samples every call).
MEM_SAMPLE_S = 5.0


def reset() -> None:
    """Forget rows and close the stream (one in-process run must not
    inherit a previous run's table)."""
    with _lock:
        f = _STATE["stream"]
        _STATE.update(rows={}, families=set(), stream=None,
                      stream_dir=None, mem_last=None)
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


def _missing(field: str, row: dict) -> None:
    _metrics.registry().inc(f"program.analysis_missing.{field}")
    row.setdefault("missing", []).append(field)


# -- ptxas resource report ---------------------------------------------------

_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for)"
                    r" '?([\w$.]+)'?")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(log: str) -> Dict[str, dict]:
    """{entry function: {"registers", "stack_bytes", "spill_stores",
    "spill_loads"}} from an `nvcc -Xptxas -v` log (fields the log does
    not give are absent)."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


# -- the registry ------------------------------------------------------------


def record(family: str, key, source: str, compile_s: float,
           fields: Optional[dict] = None) -> Optional[dict]:
    """One registry row per (family, key).  Never raises; returns the
    row (None when recording failed, counted)."""
    try:
        return _record(family, key, source, compile_s, fields or {})
    except Exception:                        # noqa: BLE001 — observability
        _metrics.registry().inc("program.analysis_missing.record")
        return None


def _record(family, key, source, compile_s, fields):
    reg = _metrics.registry()
    row = {"ts": round(time.time(), 3), "family": family,
           "key": str(key)[:200], "source": source,
           "compile_s": round(float(compile_s), 4)}
    row.update(fields)
    for field in MISSING_ANALYSES:
        _missing(field, row)
    with _lock:
        rows = _STATE["rows"]
        rows[(family, row["key"])] = row
        _STATE["families"].add(family)
        n = len(rows)
    reg.inc(f"program.records.{source}")
    reg.gauge("program.count", n)
    if row.get("registers") is not None:
        reg.gauge(f"program.registers.{family}.{row['key']}",
                  row["registers"])
    if row.get("spill_stores") is not None:
        reg.gauge(f"program.spill_bytes.{family}.{row['key']}",
                  row["spill_stores"] + row.get("spill_loads", 0))
    _stream_write(row)
    _ensure_collector()
    return row


def record_extension(name: str, source: str, build_s: float,
                     log: str) -> List[dict]:
    """The rows of one loaded extension: one per kernel instance its
    ptxas log names (with that instance's registers and spills), or one
    row for the whole library when the log names none."""
    instances = parse_ptxas(log)
    if not instances:
        row = record(name, name, source, build_s)
        return [row] if row else []
    rows = []
    for fn, fields in instances.items():
        row = record(name, fn, source, build_s, fields)
        if row:
            rows.append(row)
    return rows


def has_family(family: str) -> bool:
    return family in _STATE["families"]


def table() -> List[dict]:
    """Every registry row (copies), oldest first — the list embedded
    under "programs" in metrics snapshots."""
    with _lock:
        return [dict(r) for r in _STATE["rows"].values()]


# -- live device-memory telemetry --------------------------------------------


def host_rss_bytes() -> Optional[int]:
    """This process's resident set size from `/proc/self/statm` (field
    1 x page size); None where that file does not exist."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:                            # noqa: BLE001 — non-Linux
        return None


def _cuda():
    """torch.cuda when the process has imported torch and initialized a
    card, else None (sampling never initializes one)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda
    except Exception:                            # noqa: BLE001
        pass
    return None


def sample_memory(devices=None, force: bool = False) -> bool:
    """Allocator counters -> `mem.device.<k>.{in_use,peak,limit}`
    gauges (in_use/peak: the caching allocator's allocated bytes, current
    and peak; limit: the card's total memory), rate-limited by
    MEM_SAMPLE_S.  Without an initialized
    card the host resident set lands in `mem.host.rss`; only when even
    that is missing does `program.analysis_missing.memory_stats` count
    an absent sample.  `devices` are card indices or torch devices (the
    fleet passes its lanes'; default: every card; a CPU device samples
    the host).  Returns True when a sample was taken."""
    now = time.monotonic()
    with _lock:
        last = _STATE["mem_last"]
        if not force and last is not None and now - last < MEM_SAMPLE_S:
            return False
        _STATE["mem_last"] = now
    reg = _metrics.registry()
    cuda = _cuda()
    cards = None if devices is None else sorted(
        {d if isinstance(d, int) else (d.index or 0) for d in devices
         if isinstance(d, int) or d.type == "cuda"})
    try:
        if cuda is None or cards == []:
            rss = host_rss_bytes()
            if rss is None:
                reg.inc("program.analysis_missing.memory_stats")
            else:
                reg.gauge("mem.host.rss", int(rss))
            return True
        for k in (range(cuda.device_count()) if cards is None else cards):
            stats = cuda.memory_stats(k)
            _, total = cuda.mem_get_info(k)
            reg.gauge(f"mem.device.{k}.in_use",
                      int(stats.get("allocated_bytes.all.current", 0)))
            reg.gauge(f"mem.device.{k}.peak",
                      int(stats.get("allocated_bytes.all.peak", 0)))
            reg.gauge(f"mem.device.{k}.limit", int(total))
    except Exception:                        # noqa: BLE001 — telemetry
        reg.inc("program.analysis_missing.memory_stats")
        return False
    return True


def _ensure_collector() -> None:
    """Every metrics snapshot carries a fresh memory sample (snapshot
    collectors are the designed place for device gauges;
    `snapshot_light` flushes skip them by contract)."""
    if _STATE["collector"]:
        return
    _STATE["collector"] = True

    def _collect() -> bool:
        sample_memory(force=True)
        return True

    _metrics.registry().add_collector(_collect)


# -- the programs.p<procid>.jsonl stream -------------------------------------


def stream_name(proc) -> str:
    return f"programs.p{proc}.jsonl"


def _stream_write(row: dict) -> None:
    d = _ledger.active_dir() or os.environ.get(_ledger.ENV_VAR)
    if not d:
        return
    with _lock:
        f = _STATE["stream"]
        if f is None or _STATE["stream_dir"] != d:
            try:
                os.makedirs(d, exist_ok=True)
                f = open(os.path.join(
                    d, stream_name(_ledger._default_proc())), "a")
            except OSError:
                return
            _STATE.update(stream=f, stream_dir=d)
        try:
            f.write(json.dumps(row, separators=(",", ":"),
                               default=str) + "\n")
            f.flush()             # crash-robust: the last row lands
        except (OSError, ValueError):
            pass
