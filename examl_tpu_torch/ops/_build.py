"""Build the port's CUDA kernels with nvcc at first use and load them.

Each source `examl_tpu_torch/csrc/<name>.cu` becomes one shared library
with a plain C interface, `build/torch_kernels/lib<name>-<hash>.so`, loaded
with ctypes.  The hash covers the source, the headers beside it and the
compiler flags, so an unchanged tree never rebuilds.  `EXAML_BUILD_DIR`
moves the build directory (the JAX package's EXAML_COMPILE_CACHE), so a
test or a cold-start check can use a cold or damaged directory without
touching the real one.  `build_all` starts one nvcc per missing library,
all at once, and waits for them, with an optional deadline past which
every nvcc still running is killed with its process group.  A build
holds the library's lock file in the build directory: processes that
share the directory (the ranks of a gang, leased fleet ranks, bank
workers) build each library once, and the others wait, then load it.

Only sources in the repository and the CUDA toolkit's headers are used.

The first load of each library in a process is the `compile.hang` fault
seam (the JAX engine's first-call compile monitor), watched by a thread
that warns once it has taken longer than `EXAML_COMPILE_TIMEOUT` seconds
(the CLI's --compile-timeout; `engine.watchdog_barks`): an in-process
build is only warned about, a `--bank` worker's is killed
(ops/bank.py).  Every build is published with its manifest entry, and
`EXAML_EXPORT_BANK=on|require` verifies a library against it before it
is loaded (ops/export_bank.py).

Each library a process loads is one family of the program observatory
(obs/programs.py: one row per kernel instance, from the ptxas log) and
one `extension.load` ledger event, and a build counts as
`engine.compile_count` / `engine.compile_seconds`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from examl_tpu_torch import obs
from examl_tpu_torch.obs import programs
from examl_tpu_torch.ops import export_bank
from examl_tpu_torch.resilience import faults

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "torch_kernels"   # the default
BUILD_DIR_VAR = "EXAML_BUILD_DIR"
TIMEOUT_VAR = "EXAML_COMPILE_TIMEOUT"
DEFAULT_COMPILE_TIMEOUT = 180.0
# nvcc runs in a process group of its own, killed as one at a deadline;
# a bank worker (ops/bank.py) clears this so that nvcc shares the
# worker's group, which the bank kills as one.
NVCC_OWN_GROUP = True
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of every exported function, by library.
SIGNATURES = {
    "newview_chunk": {
        "examl_newview_chunks_f32": ([_P] * 11 + [_I] * 7
                                     + [_D, _D, _P, _IP], _I),
        "examl_newview_chunks_f64": ([_P] * 11 + [_I] * 7
                                     + [_D, _D, _P, _IP], _I),
        "examl_newview_chunks_bf16": ([_P] * 11 + [_I] * 7
                                      + [_D, _D, _P, _IP], _I),
        "examl_newview_flow_f32": ([_P] * 14 + [_I] * 10
                                   + [_D, _D, _P, _IP], _I),
        "examl_newview_flow_f64": ([_P] * 14 + [_I] * 10
                                   + [_D, _D, _P, _IP], _I),
        "examl_newview_flow_bf16": ([_P] * 14 + [_I] * 10
                                    + [_D, _D, _P, _IP], _I),
        "examl_newview_chunk_config": ([_I] * 6 + [_IP], _I),
        "examl_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "newview_whole": {
        "examl_newview_whole_f32": ([_P] * 10 + [_I] * 7
                                    + [_D, _D, _P, _IP], _I),
        "examl_newview_whole_f64": ([_P] * 10 + [_I] * 7
                                    + [_D, _D, _P, _IP], _I),
    },
}

# Loaded libraries by path (a relocated build directory loads its own).
_LIBS: Dict[Path, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel that did not build, or a launch that returned a CUDA
    error: a fault of the kernel or of the card, never of the job that
    ran it (the fleet re-raises it instead of quarantining jobs)."""


def build_dir() -> Path:
    """The build directory: $EXAML_BUILD_DIR, else BUILD_DIR."""
    d = os.environ.get(BUILD_DIR_VAR)
    return Path(d).resolve() if d else BUILD_DIR


def compile_timeout() -> float:
    """Seconds before a first load is warned about ($EXAML_COMPILE_TIMEOUT,
    the CLI's --compile-timeout; 180 by default)."""
    try:
        return float(os.environ.get(TIMEOUT_VAR) or DEFAULT_COMPILE_TIMEOUT)
    except ValueError:
        return DEFAULT_COMPILE_TIMEOUT


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


@functools.lru_cache(maxsize=None)
def source_hash(name: str) -> str:
    """sha256 of the source, the headers beside it and the flags (read
    once per process: `library` looks a loaded library up at every
    launch)."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{source_hash(name)[:16]}.so"


@contextlib.contextmanager
def build_lock(path: Path, end: Optional[float] = None):
    """Hold the lock file of the library at `path` (an advisory flock,
    released when the holder exits or dies); wait for it until the
    monotonic time `end`, then raise KernelError."""
    import fcntl
    path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(str(path.with_suffix(".lock")), os.O_CREAT | os.O_RDWR,
                 0o644)
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if end is not None and time.monotonic() > end:
                    raise KernelError(
                        f"{path.name}: another process held its build "
                        "lock past the deadline") from None
                time.sleep(0.05)
        yield
    finally:
        os.close(fd)


def _kill(proc: subprocess.Popen) -> None:
    try:
        if NVCC_OWN_GROUP:
            os.killpg(proc.pid, signal.SIGKILL)
        else:
            proc.kill()
    except OSError:
        pass
    proc.wait()


def build_all(names: Optional[List[str]] = None,
              timeout: Optional[float] = None,
              force: bool = False) -> Dict[str, Path]:
    """Compile every missing library in parallel (every named one with
    `force`); return name -> path.  The compiler's resource report
    (-Xptxas -v) lands in a .log file beside each library.  Each build
    holds its library's lock; a library another process built while this
    one waited is not built again.  With `timeout` (seconds), an nvcc
    still running at the deadline is killed with its process group, and
    so is every other one of this call: KernelError names the libraries
    and the seconds."""
    return _build(names, timeout, force)[0]


def _build(names, timeout, force):
    """build_all's work: (name -> path, the names this call built)."""
    names = sources() if names is None else names
    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if force or not paths[n].exists()]
    if not todo:
        return paths, []
    nvcc = nvcc_path()
    end = None if timeout is None else time.monotonic() + timeout
    procs = {}
    with contextlib.ExitStack() as locks:
        try:
            for n in todo:
                locks.enter_context(build_lock(paths[n], end))
                if paths[n].exists() and not force:
                    continue            # built while this process waited
                tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
                with open(paths[n].with_suffix(".log"), "w") as log:
                    procs[n] = (subprocess.Popen(
                        [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                        stdout=log, stderr=subprocess.STDOUT,
                        start_new_session=NVCC_OWN_GROUP), tmp)
            failed = []
            for n, (proc, tmp) in procs.items():
                left = None if end is None else max(0.0,
                                                    end - time.monotonic())
                try:
                    rc = proc.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    late = [m for m, (p, _) in procs.items()
                            if p.poll() is None]
                    raise KernelError(
                        f"nvcc for {late} outlived the {timeout:g} s build "
                        "deadline: killed") from None
                if rc != 0:
                    failed.append(n)
                    continue
                export_bank.publish(n, tmp, paths[n], source_hash(n))
        finally:
            for proc, tmp in procs.values():
                if proc.poll() is None:
                    _kill(proc)
                if tmp.exists():
                    tmp.unlink()
    if failed:
        msgs = "\n".join(f"--- {n} ---\n"
                         + paths[n].with_suffix(".log").read_text()
                         for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{msgs}")
    return paths, list(procs)


def await_build(name: str, timeout: Optional[float] = None) -> Path:
    """Wait until no process holds the build lock of `name`'s library,
    and return its path (built or not)."""
    path = _lib_path(name)
    end = None if timeout is None else time.monotonic() + timeout
    with build_lock(path, end):
        return path


def build_log(name: str) -> str:
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


@contextlib.contextmanager
def _first_load(name: str):
    """The first load of a library in a process: the `compile.hang` fault
    seam, watched by a thread that warns once it has taken longer than
    `compile_timeout()` seconds (the JAX engine's watchdog bark)."""
    limit = compile_timeout()
    done = threading.Event()

    def bark():
        if not done.wait(limit):
            obs.inc("engine.watchdog_barks")
            obs.log(f"EXAML: loading CUDA library '{name}' (its nvcc build "
                    f"included) has taken >{limit:.0f}s — if it never "
                    "returns, rerun with --bank (a killable build with a "
                    "deadline, which degrades to the next route down) or "
                    "with --newview scan (no kernel)")

    threading.Thread(target=bark, daemon=True).start()
    try:
        faults.fire("compile.hang")
        yield
    finally:
        done.set()


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def _build_one(name: str, mode: str, why: str,
               force: bool = True) -> Optional[float]:
    """Build `name`'s library in this process (counted, ledgered; without
    `force`, only when no other process built it meanwhile); the seconds
    the build took, None when there was none.  Under
    EXAML_EXPORT_BANK=require, raise instead."""
    if mode == "require":
        raise export_bank.ExportBankRequired(
            f"{export_bank.ENV_VAR}=require: CUDA library '{name}' would "
            f"have to be built ({why}) in {build_dir()}")
    t0 = time.perf_counter()
    obs.ledger_event("compile", family=name, status="start")
    with obs.span(f"compile:{name}", cat="compile"):
        built = _build([name], None, force)[1]
    dt = time.perf_counter() - t0
    if not built:
        obs.ledger_event("compile", family=name, status="end",
                         seconds=round(dt, 3), built_elsewhere=True)
        return None
    obs.ledger_event("compile", family=name, status="end",
                     seconds=round(dt, 3))
    obs.inc("engine.compile_count")
    obs.inc("engine.compile_seconds", dt)
    obs.inc(f"engine.compile_seconds.{name}", dt)
    obs.observe(f"engine.compile_seconds.{name}", dt)
    return dt


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed (and,
    under EXAML_EXPORT_BANK=on|require, verified first)."""
    path = _lib_path(name)
    lib = _LIBS.get(path)
    if lib is not None:
        if not programs.has_family(name):
            programs.record_extension(name, "cached", 0.0, build_log(name))
        return lib
    t0 = time.perf_counter()
    with _first_load(name):
        mode = export_bank.mode()
        built = None
        with build_lock(path):
            present = path.exists()
        if present and mode != "off" and \
                not export_bank.verify(name, path, source_hash(name)):
            built = _build_one(name, mode, "its bank entry was rejected")
        elif not present:
            built = _build_one(name, mode, "none is built", force=False)
        try:
            lib = _bind(name, path)
        except (OSError, AttributeError) as exc:
            if mode == "off":
                raise KernelError(f"{path} does not load: {exc}") from exc
            export_bank.corrupt(name, path, exc)
            built = _build_one(name, mode, "the loader refused it")
            lib = _bind(name, path)
    programs.record_extension(name, "built" if built is not None
                              else "cached", built or 0.0, build_log(name))
    _LIBS[path] = lib
    # One event per library a process loads, built or not: a restarted
    # run's recovery time splits on it.
    obs.ledger_event("extension.load", family=name,
                     built=built is not None,
                     seconds=round(time.perf_counter() - t0, 4))
    return lib


def error_string(err: int) -> str:
    msg = library("newview_chunk").examl_cuda_error_string(int(err))
    return msg.decode() if msg else "unknown error"
