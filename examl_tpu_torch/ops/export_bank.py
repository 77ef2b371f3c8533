"""The built-library bank: every CUDA library with its manifest entry.

The port of `examl_tpu/ops/export_bank.py`.  The JAX package serializes
compiled executables so a cold or restarted process loads programs
instead of compiling them.  The port's programs are the nvcc-built
libraries of `ops/_build.py`, already files on disk: its "export" is the
built `.so` plus its entry in the build directory's `bank_manifest.json`
(the same file `ops/bank.py` writes its verdicts to), which stamps

* a content digest (sha256) and the size, so a truncated or corrupt
  library is told apart from the one the build wrote;
* the host it was built on: the card's name and driver version (as
  `nvidia-smi` reports them; empty where there is none), the nvcc
  version, and the hash of the sources and flags the file name carries;
* this bank's ABI ordinal (`EXPORT_ABI`).

`EXAML_EXPORT_BANK` keeps the JAX values:

* `off` (the default): a library is loaded by its hashed name, as before
  the bank existed;
* `on`: every library is verified against its entry before
  `ctypes.CDLL` loads it.  A library with no entry, a stamp that does not
  match this host (`rejected.<abi|host|nvcc|source>`), a wrong digest
  (`rejected.digest`) or a file the loader refuses (`corrupt`) is
  QUARANTINED (renamed aside with `.quarantined`, its entry dropped,
  counted `bank.export.quarantined`) and rebuilt; a verified library
  counts `bank.export.hits`;
* `require`: the zero-build cold start gate: where a library would have
  to be built, `ExportBankRequired` is raised instead.

Every build publishes its library and entry through `publish`: the
`bank.export.write` fault seam, then fsync of the staged file, the
rename into place and the entry (the manifest is rewritten staged,
fsynced and renamed under an advisory lock).  A fault there costs only
the entry: the library still lands, and the run goes on.  `verify` fires
`bank.export.load` before it reads; a fault there falls through to a
rebuild.

stdlib-only: the CLI's front validates `EXAML_EXPORT_BANK` through this
module, and a supervising parent never imports torch.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

from examl_tpu_torch import obs
from examl_tpu_torch.resilience import faults

ENV_VAR = "EXAML_EXPORT_BANK"
MANIFEST_NAME = "bank_manifest.json"
QUARANTINE_SUFFIX = ".quarantined"

# Bump when the manifest entry's layout or the libraries' C interface
# convention changes: an old entry must REJECT (rejected.abi), never load
# into a wrong calling convention.
EXPORT_ABI = 1

# Host stamps, read once per process.
_HOST: Dict[str, str] = {}


class ExportBankRequired(RuntimeError):
    """EXAML_EXPORT_BANK=require and a library could not be served from
    the bank: it would have to be built."""


def mode() -> str:
    """"off" | "on" | "require" from EXAML_EXPORT_BANK; a ValueError on
    any other value (a misspelled opt-in would run every restart with
    unverified libraries while the operator believes otherwise)."""
    v = (os.environ.get(ENV_VAR) or "").strip().lower()
    if v in ("", "0", "off", "no"):
        return "off"
    if v in ("1", "on", "yes"):
        return "on"
    if v == "require":
        return "require"
    raise ValueError(f"{ENV_VAR}={v!r}: expected off/on/require")


# ---------------------------------------------------------------------------
# the manifest (shared with ops/bank.py)


def manifest_path(build_dir) -> Path:
    return Path(build_dir) / MANIFEST_NAME


def read_manifest(build_dir) -> dict:
    """The build directory's manifest, or {} when it is absent or torn."""
    try:
        with open(manifest_path(build_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    return doc if isinstance(doc, dict) else {}


@contextlib.contextmanager
def updating_manifest(build_dir):
    """Read-modify-write of the manifest under an advisory flock (bank
    workers, leased ranks and gang ranks share one build directory):
    yields the document as a dict; on exit it is written to a staged
    file, fsynced and renamed over the manifest, so a crash never
    publishes a torn manifest."""
    import fcntl
    path = manifest_path(build_dir)
    os.makedirs(path.parent, exist_ok=True)
    fd = os.open(str(path) + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        doc = read_manifest(build_dir)
        doc.setdefault("version", 1)
        yield doc
        doc["updated"] = time.time()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        os.close(fd)                 # releases the flock


def _drop_entry(path: Path) -> None:
    try:
        with updating_manifest(path.parent) as doc:
            (doc.get("exports") or {}).pop(path.name, None)
    except OSError as exc:
        obs.log(f"EXAML: export bank: manifest update failed ({exc})")


# ---------------------------------------------------------------------------
# host stamps


def _run(cmd) -> str:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout if res.returncode == 0 else ""


def host_stamps() -> Dict[str, str]:
    """{"card", "driver", "nvcc"} of this host, read once per process:
    the first card's name and driver version from nvidia-smi (no CUDA
    context is made), the nvcc release line; "" for what is absent."""
    if not _HOST:
        smi = shutil.which("nvidia-smi")
        line = (_run([smi, "--query-gpu=name,driver_version",
                      "--format=csv,noheader"]) if smi else "")
        card, _, driver = (line.splitlines() or [""])[0].rpartition(",")
        from examl_tpu_torch.ops._build import nvcc_path
        try:
            out = _run([nvcc_path(), "--version"])
        except RuntimeError:
            out = ""
        release = [x for x in out.splitlines() if "release" in x]
        _HOST.update(card=card.strip(), driver=driver.strip(),
                     nvcc=(release or [""])[-1].strip())
    return dict(_HOST)


def host_meta(source: str) -> dict:
    """The stamp every entry carries and every verified load must match:
    the ABI ordinal, the host stamps and the source hash."""
    return dict(host_stamps(), abi=EXPORT_ABI, source=source)


def _reject_reason(entry: dict, meta: dict) -> Optional[str]:
    """The first stamp of `entry` that does not match this process."""
    if entry.get("abi") != meta["abi"]:
        return "abi"
    if entry.get("card") != meta["card"] or \
            entry.get("driver") != meta["driver"]:
        return "host"
    if entry.get("nvcc") != meta["nvcc"]:
        return "nvcc"
    if entry.get("source") != meta["source"]:
        return "source"
    return None


def digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# publish / verify / quarantine


def publish(name: str, staged: Path, path: Path, source: str) -> bool:
    """Move the freshly built library `staged` to `path` and record its
    entry: the `bank.export.write` seam, fsync, rename, entry.  Returns
    False when the entry could not be written (counted
    `bank.export.write_errors`): the library is in place all the same."""
    t0 = time.perf_counter()
    try:
        faults.fire("bank.export.write")
        with open(staged, "rb") as f:
            os.fsync(f.fileno())
        entry = dict(host_meta(source), family=name, file=path.name,
                     digest=digest(staged), size=staged.stat().st_size,
                     created=time.time())
        os.replace(staged, path)
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        with updating_manifest(path.parent) as doc:
            doc.setdefault("exports", {})[path.name] = entry
    except Exception as exc:                 # noqa: BLE001 — incl. faults
        if staged.exists():
            os.replace(staged, path)
        obs.inc("bank.export.write_errors")
        obs.ledger_event("export", status="write_error", family=name,
                         file=path.name,
                         error=f"{type(exc).__name__}: {exc}"[:200])
        obs.log(f"EXAML: export bank: the entry of '{name}' was not "
                f"written ({type(exc).__name__}: {exc}); the library is in "
                "place, unverifiable until its next build")
        return False
    obs.inc("bank.export.writes")
    obs.observe("bank.export_write_seconds", time.perf_counter() - t0)
    obs.ledger_event("export", status="written", family=name,
                     file=path.name, bytes=entry["size"])
    return True


def quarantine(name: str, path: Path, reason: str) -> None:
    """Rename a rejected library aside (kept for a post-mortem) and drop
    its entry, so it cannot fail every later start."""
    try:
        if path.exists():
            os.replace(path, str(path) + QUARANTINE_SUFFIX)
    except OSError:
        pass
    _drop_entry(path)
    obs.inc("bank.export.quarantined")
    obs.ledger_event("export", status="quarantined", family=name,
                     file=path.name, reason=reason)
    obs.log(f"EXAML: export bank: library '{name}' ({path.name}) rejected "
            f"({reason}) and quarantined; it is rebuilt")


def _reject(name: str, path: Path, reason: str) -> bool:
    obs.inc(f"bank.export.rejected.{reason}")
    obs.ledger_event("export", status="rejected", family=name,
                     file=path.name, reason=reason)
    quarantine(name, path, reason)
    return False


def verify(name: str, path: Path, source: str) -> bool:
    """True when the library at `path` matches its manifest entry (a
    hit); otherwise it is quarantined and False says it must be rebuilt.
    Never raises: a fault at `bank.export.load` (or any read error) is a
    fall-through to the rebuild, counted `bank.export.rejected.error`."""
    try:
        faults.fire("bank.export.load")
        entry = (read_manifest(path.parent).get("exports") or {}).get(
            path.name)
        if entry is None:
            obs.inc("bank.export.misses")
            return _reject(name, path, "unrecorded")
        reason = _reject_reason(entry, host_meta(source))
        if reason is not None:
            return _reject(name, path, reason)
        if path.stat().st_size != entry.get("size") or \
                digest(path) != entry.get("digest"):
            # Truncated writes and flipped bytes both land here.
            return _reject(name, path, "digest")
    except Exception as exc:                 # noqa: BLE001 — incl. faults
        obs.inc("bank.export.rejected.error")
        obs.ledger_event("export", status="rejected", family=name,
                         file=path.name, reason="error",
                         error=f"{type(exc).__name__}: {exc}"[:200])
        return False
    obs.inc("bank.export.hits")
    obs.ledger_event("export", status="hit", family=name, file=path.name)
    return True


def corrupt(name: str, path: Path, exc: BaseException) -> None:
    """A verified (or unverified) library the loader refused."""
    obs.inc("bank.export.corrupt")
    obs.ledger_event("export", status="rejected", family=name,
                     file=path.name, reason="corrupt",
                     error=f"{type(exc).__name__}: {exc}"[:200])
    quarantine(name, path, "corrupt")
