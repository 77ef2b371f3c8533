"""Ahead-of-time banking of the run's CUDA libraries (`--bank`).

The port of `examl_tpu/ops/bank.py`.  The JAX package's programs compile
at first dispatch, and a compile that never returns wedges the run; its
bank compiles every program family first, in killable subprocess
workers with a hard deadline.  The port's programs are the nvcc-built
libraries of `ops/_build.py` (`newview_chunk`, kernel B1;
`newview_whole`, kernel B2); everything else it runs on the card is
torch ops, which compile nothing.  So:

* `enumerate_families()` gives, from the run's config alone, the
  libraries the run will load: `newview_chunk` unless PSR, `-S` or
  `--newview scan`, and also `newview_whole` with `--newview whole`
  (the fallback target banks before what can degrade onto it).
* `run_bank()` builds them in killable worker processes, one per family,
  all at once: `python -m examl_tpu_torch.ops.bank --worker FAMILY`,
  started in a process group of its own, fires the `bank.worker` fault
  seam, then loads the library through `_build.library` (the
  `compile.hang` seam, then nvcc as the worker's child, in the worker's
  group).  A family past `--compile-timeout` has its worker's whole
  group killed and is DEGRADED: the run is pinned to the next route down
  by setting the CLI flag on `args` before any engine is built
  (`FALLBACK_FLAG`, the port's form of the JAX `FALLBACK_ENV`):
  `newview_whole` -> `--newview chunk`, `newview_chunk` ->
  `--newview scan`.  A worker killed by a signal inside its family is a
  wedge too; a build that fails (nvcc's error, an import error) is not:
  the main process then builds it itself and the run fails loudly, as
  without `--bank`.
* A degradation is never silent: an ERROR line in ExaML_info names the
  family and the route the run lost, `bank.fallbacks` counts it, and the
  per-host manifest records it.
* The manifest, `bank_manifest.json` in the build directory (shared with
  ops/export_bank.py's entries), records every family's verdict with the
  host's card name, driver, nvcc version and the library's source hash;
  `load_manifest` / `manifest_degraded_families` read it back.
* `warm_instance()` then loads each banked library in the main process,
  so the run's first launches build nothing.

CORE_FAMILIES: the JAX package's scan-tier programs, which have no route
to degrade onto, have no counterpart here: the port's wave-scan tier is
torch ops and builds nothing, so every family the port banks has a
route below it.

Worker protocol (the JAX package's): a `##start <family>` line, one JSON
result line (`{"family", "ok", "seconds", "built"}` or an `error`), then
`{"family": "__metrics__", "snapshot": ...}` with the worker's counters,
whose `engine.compile*` entries land in the parent under `bank.`.

stdlib-only at import, like ops/_build.py: the workers start without
torch.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from examl_tpu_torch import obs
from examl_tpu_torch.ops import _build, export_bank
from examl_tpu_torch.resilience import faults
from examl_tpu_torch.resilience.exitcause import exit_desc

# No family of the port lacks a route below it (see the module text).
CORE_FAMILIES = ()

# family -> (CLI flag set on degradation, its value, what the run loses).
FALLBACK_FLAG = {
    "newview_whole": ("--newview", "chunk",
                      "kernel B2 (one launch per full traversal); full "
                      "traversals run kernel B1"),
    "newview_chunk": ("--newview", "scan",
                      "kernel B1; every traversal runs on the wave-scan "
                      "tier (torch ops, no kernel)"),
}

# Seconds a worker may stay silent before its first ##start, beyond the
# deadline (interpreter start-up).
SILENT_GRACE_S = 60.0

# The run's degraded families (family -> verdict).
_DEGRADED: Dict[str, str] = {}


def reset() -> None:
    """Forget the previous run's verdicts (one run = one bank record)."""
    _DEGRADED.clear()


def degraded() -> Dict[str, str]:
    return dict(_DEGRADED)


def enumerate_families(mode: str = "d", psr: bool = False,
                       save_memory: bool = False,
                       newview: Optional[str] = None) -> List[str]:
    """The CUDA libraries a run with this config loads, the fallback
    target first.  `mode` (the -f algorithm) does not change them: every
    mode, the fleet's included, runs its full traversals on the one
    tier."""
    del mode
    if psr or save_memory or newview == "scan":
        return []
    return ["newview_chunk"] + (["newview_whole"]
                                if newview == "whole" else [])


# ---------------------------------------------------------------------------
# the worker


def _worker(family: str) -> None:
    _build.NVCC_OWN_GROUP = False       # nvcc dies with this worker's group
    print(f"##start {family}", flush=True)
    faults.fire("bank.worker")
    t0 = time.perf_counter()
    try:
        _build.library(family)
        built = obs.snapshot_counters().get("engine.compile_count", 0)
        print(json.dumps({"family": family, "ok": True,
                          "seconds": round(time.perf_counter() - t0, 3),
                          "built": bool(built)}), flush=True)
    except Exception as exc:                  # noqa: BLE001
        print(json.dumps({"family": family, "ok": False,
                          "error": f"{type(exc).__name__}: {exc}"[:4000]}),
              flush=True)
    print(json.dumps({"family": "__metrics__", "snapshot": obs.snapshot()},
                     default=str), flush=True)


# ---------------------------------------------------------------------------
# the parent


class _Worker:
    """One killable build worker (a process group of its own) and a
    reader thread that notes when its family started and collects its
    result lines."""

    def __init__(self, family: str, env: dict):
        self.family = family
        self.result: Optional[dict] = None
        self.snapshot: Optional[dict] = None
        self.started: Optional[float] = None
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "examl_tpu_torch.ops.bank", "--worker",
             family], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, start_new_session=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if line.startswith("##start "):
                self.started = time.monotonic()
            elif line.startswith("{"):
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if d.get("family") == "__metrics__":
                    self.snapshot = d.get("snapshot")
                elif d.get("family") == self.family:
                    self.result = d
        self.proc.stdout.close()

    def overdue(self, timeout: float) -> bool:
        t = self.started
        if t is None:
            return time.monotonic() - self.t0 > timeout + SILENT_GRACE_S
        return time.monotonic() - t > timeout

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except OSError:
            pass
        self.proc.wait()
        self.thread.join(timeout=5)


def _worker_env() -> dict:
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if repo not in pp:
        env["PYTHONPATH"] = os.pathsep.join([repo] + pp)
    # The worker's evidence travels in its result lines, not in the run's
    # ledger or heartbeat.
    for var in ("EXAML_LEDGER_DIR", "EXAML_HEARTBEAT_FILE"):
        env.pop(var, None)
    return env


def _verdict(w: _Worker, timed_out: bool, timeout: float) -> dict:
    if timed_out:
        if w.started is None:
            obs.inc("bank.worker_wedges")
            return {"status": "error",
                    "error": "worker silent past the deadline (killed)"}
        return {"status": "timeout", "seconds": timeout}
    r = w.result
    if r is not None and r.get("ok"):
        return {"status": "banked", "seconds": r.get("seconds"),
                "built": r.get("built", False)}
    if r is not None:
        return {"status": "error", "error": r.get("error")}
    return {"status": "error",
            "error": "worker died mid-build " + exit_desc(w.proc.returncode)}


def run_bank(args, log=lambda msg: None,
             timeout: Optional[float] = None) -> Dict[str, dict]:
    """Build every library the run described by `args` (the CLI
    namespace) loads, each in a killable worker with a deadline of
    `timeout` seconds (default: args.compile_timeout); pin degraded
    families' fallback flags on `args`; write the manifest.  Returns
    {family: {"status": banked|timeout|error, ...}}."""
    reset()
    timeout = float(timeout if timeout is not None else
                    getattr(args, "compile_timeout", None)
                    or _build.DEFAULT_COMPILE_TIMEOUT)
    families = enumerate_families(
        getattr(args, "mode", "d"), psr=getattr(args, "model", "GAMMA")
        == "PSR", save_memory=getattr(args, "save_memory", False),
        newview=getattr(args, "newview", None))
    obs.inc("bank.families", len(families))
    if not families:
        log("bank: this run loads no CUDA library (PSR, -S or --newview "
            "scan: every traversal on the wave-scan tier)")
        return {}
    log(f"banking {len(families)} CUDA libraries in {len(families)} "
        f"worker(s), {timeout:g} s deadline each: " + ", ".join(families)
        + f" (build directory {_build.build_dir()})")
    t_bank = time.perf_counter()
    env = _worker_env()
    live = [_Worker(f, env) for f in families]
    report: Dict[str, dict] = {}
    try:
        while live:
            time.sleep(0.1)
            still = []
            for w in live:
                if w.proc.poll() is None:
                    if not w.overdue(timeout):
                        still.append(w)
                        continue
                    w.kill()
                    report[w.family] = _verdict(w, True, timeout)
                    continue
                w.thread.join(timeout=5)
                report[w.family] = _verdict(w, False, timeout)
                for name, v in ((w.snapshot or {}).get("counters")
                                or {}).items():
                    if name.startswith("engine.compile") or \
                            name.startswith("bank.export"):
                        obs.inc(name if name.startswith("bank.")
                                else "bank." + name, v)
            live = still
    finally:
        for w in live:
            w.kill()
    obs.observe("bank.wall_seconds", time.perf_counter() - t_bank)
    for fam in families:
        r = report[fam]
        st = r["status"]
        if st == "banked":
            obs.inc("bank.banked")
            obs.observe(f"bank.compile.{fam}", float(r["seconds"]))
            log(f"bank: {fam} {'built' if r['built'] else 'found built'} "
                f"in {r['seconds']:.1f} s")
        elif st == "timeout":
            obs.inc("bank.timeouts")
            log(f"bank: {fam} exceeded the {timeout:g} s build deadline; "
                "its worker's process group was killed")
        else:
            obs.inc("bank.errors")
            log(f"bank: {fam} FAILED ({r.get('error')})")
    _apply_degradations(report, args, log)
    _save_manifest(report, log)
    return report


def _is_wedge(r: dict) -> bool:
    """A verdict that routes the run around the family: the deadline's
    kill, or a worker killed by a signal inside its family.  A plain
    failure (nvcc's error, an exception) is not: it surfaces when the
    main process loads the library."""
    if r.get("status") == "timeout":
        return True
    return r.get("status") == "error" and "(signal " in (r.get("error")
                                                         or "")


def _apply_degradations(report: Dict[str, dict], args, log) -> None:
    """Pin the fallback flag of every wedged family on `args`, B2's
    first, so that a wedged B1 leaves the run on the scan tier."""
    for fam in ("newview_whole", "newview_chunk"):
        r = report.get(fam)
        if r is None or not _is_wedge(r):
            continue
        flag, value, cost = FALLBACK_FLAG[fam]
        _DEGRADED[fam] = r["status"]
        setattr(args, flag.lstrip("-").replace("-", "_"), value)
        r["fallback"] = f"{flag} {value}"
        obs.inc("bank.fallbacks")
        obs.ledger_event("bank.degraded", family=fam, status=r["status"],
                         fallback=r["fallback"])
        log(f"ERROR: bank: CUDA library '{fam}' {r['status']} "
            f"({r.get('error') or 'past the build deadline'}): the run is "
            f"pinned to {flag} {value} and loses {cost}")


def _save_manifest(report: Dict[str, dict], log) -> None:
    """Merge this run's verdicts into the build directory's manifest,
    each stamped with the host and the library's source hash (a config
    that does not load some family keeps a prior verdict for it)."""
    stamps = export_bank.host_stamps()
    now = time.time()
    try:
        with export_bank.updating_manifest(_build.build_dir()) as doc:
            fams = doc.setdefault("families", {})
            for fam, r in report.items():
                fams[fam] = dict(r, **stamps, updated=now,
                                 source=_build.source_hash(fam))
        log(f"bank manifest -> "
            f"{export_bank.manifest_path(_build.build_dir())}")
    except OSError as exc:
        log(f"bank manifest not written ({exc})")


def load_manifest(build_dir=None) -> Optional[dict]:
    """The build directory's manifest (default: the current one), or
    None."""
    doc = export_bank.read_manifest(build_dir or _build.build_dir())
    return doc or None


def manifest_degraded_families(manifest: Optional[dict]) -> set:
    """Families a previous bank on this host recorded as wedged."""
    if not manifest:
        return set()
    return {f for f, r in (manifest.get("families") or {}).items()
            if _is_wedge(r)}


def warm_instance(report: Dict[str, dict], log) -> None:
    """Load every banked library in the main process, inside the bank
    phase, so that the run's first launches build nothing."""
    for fam, r in report.items():
        if r.get("status") == "banked":
            with obs.timer(f"bank.warm.{fam}"):
                _build.library(fam)
            log(f"bank: {fam} loaded")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--worker":
        _worker(argv[1])
        return 0
    sys.stderr.write("usage: python -m examl_tpu_torch.ops.bank --worker "
                     "<family>\n")
    return 2


if __name__ == "__main__":
    sys.exit(main())
