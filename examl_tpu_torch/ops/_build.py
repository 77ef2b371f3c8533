"""Build the port's CUDA kernels with nvcc at first use and load them.

Each source `examl_tpu_torch/csrc/<name>.cu` becomes one shared library
with a plain C interface, `build/torch_kernels/lib<name>-<hash>.so`, loaded
with ctypes.  The hash covers the source, the headers beside it and the
compiler flags, so an unchanged tree never rebuilds.  `build_all` starts
one nvcc per missing library, all at once, and waits for them.

Only sources in the repository and the CUDA toolkit's headers are used.

Each library a process loads is one family of the program observatory
(obs/programs.py: one row per kernel instance, from the ptxas log) and
one `extension.load` ledger event, and a build counts as
`engine.compile_count` / `engine.compile_seconds`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

from examl_tpu_torch import obs
from examl_tpu_torch.obs import programs

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "torch_kernels"
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

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel that did not build, or a launch that returned a CUDA
    error: a fault of the kernel or of the card, never of the job that
    ran it (the fleet re-raises it instead of quarantining jobs)."""


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


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every missing library in parallel; return name -> path.
    The compiler's resource report (-Xptxas -v) lands in a .log file
    beside each library."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    nvcc = nvcc_path() if todo else None
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(n)
            continue
        os.replace(tmp, paths[n])
    if failed:
        msgs = "\n".join(f"--- {n} ---\n"
                         + paths[n].with_suffix(".log").read_text()
                         for n in failed)
        raise KernelError(f"nvcc failed for {failed}:\n{msgs}")
    return paths


def build_log(name: str) -> str:
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        if not programs.has_family(name):
            programs.record_extension(name, "cached", 0.0, build_log(name))
        return lib
    cached = _lib_path(name).exists()
    t0 = time.perf_counter()
    if not cached:
        obs.ledger_event("compile", family=name, status="start")
    with obs.span(f"compile:{name}", cat="compile"):
        path = build_all([name])[name]
    dt = time.perf_counter() - t0
    if not cached:
        obs.ledger_event("compile", family=name, status="end",
                         seconds=round(dt, 3))
        obs.inc("engine.compile_count")
        obs.inc("engine.compile_seconds", dt)
        obs.inc(f"engine.compile_seconds.{name}", dt)
        obs.observe(f"engine.compile_seconds.{name}", dt)
    programs.record_extension(name, "cached" if cached else "built",
                              0.0 if cached else dt, build_log(name))
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _LIBS[name] = lib
    # One event per library a process loads, built or not: a restarted
    # run's recovery time splits on it.
    obs.ledger_event("extension.load", family=name, built=not cached,
                     seconds=round(time.perf_counter() - t0, 4))
    return lib


def error_string(err: int) -> str:
    msg = library("newview_chunk").examl_cuda_error_string(int(err))
    return msg.decode() if msg else "unknown error"
