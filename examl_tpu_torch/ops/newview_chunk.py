"""Newview chunk kernel B1: its operands, its CUDA launch and its plain
PyTorch version.

A full traversal on the chunk tier is the launch table of the bounded
fast-path layout (ops/fastpath.py): rows `(kind, base, slot, real)`, in
order.  Each row is one chunk of `real` independent newview entries of
one tip case, `kind` 0 = tip/tip, 1 = tip/inner (the tip is always the
left child), 2 = inner/inner; entry w reads packed slot `slot + w` and
writes arena row `base + w`:

  child:   x = table[code] tiled over the R rates (tip), or the arena row
           lidx / ridx of the slot (inner node, with its scaler)
  apply:   y[r, a] = sum_k P[slot, side, part(b), r, a, k] * x[r, k]
  v = yl * yr;  where max |v| < 2^-E: v *= 2^E, scaler += 1
  scaler = scaler(left) + scaler(right) + that increment

The operands of a traversal are its P matrices `[P, 2, M, R, K, K]` over
every packed slot, built by one batched `kernels.p_matrices_wave`
(`chunk_operands`, the call `newview_whole.whole_operands` makes), and
`block_part` maps each block of 128 sites to its partition.  The kernel
also reads the tip products `u = tip_products(pmat, table)`
`[P, 2, M, C, R, K]`, u[s, side, m, c, r, a] = sum_k P[s, side, m, r, a, k]
* table[c, k]: a tip child's y for every code, built once per traversal
(the JAX package's `_ump`), so the kernel looks a tip child's y up
instead of contracting it.  A chunk reads its slots' slices.

`chunk_apply` runs a traversal's launch table through the CUDA kernel
(`csrc/newview_chunk.cu`, one host call launching every chunk) for a CUDA
arena, after building u, and through the plain version for a CPU arena.
The plain version contracts a tip's indicator vector with P as it does an
inner child, so holding the kernel against it also holds u.  On a CUDA
tensor it launches or raises; nothing falls back.  `LAUNCHES` counts kernel
launches (and nothing else), so a run can show that its path went
through the kernel; `LAUNCHES_BY_K` counts the same launches by state
count and `LAUNCHES_BY_DTYPE` by the arena's storage dtype.

The arena may store bfloat16 with float32 compute (the engine's
`clv_dtype`, the JAX package's EXAML_CLV_DTYPE=bf16): P, the tip
products, the arithmetic and the rescale decision stay float32, child
rows are upcast after the load and each output is rounded to nearest even
once, after the rescale.  The plain version does the same with `.to`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from examl_tpu_torch.ops import kernels

LAUNCHES = 0
LAUNCHES_BY_K: dict = {}     # the same launches by state count K
LAUNCHES_BY_DTYPE: dict = {}  # ... and by storage dtype ("bfloat16", ...)

# (R, K) instantiated in csrc/newview_chunk.cu: GAMMA's four rates over
# binary, DNA and amino-acid states, each for every storage dtype below.
_SUPPORTED_RK = ((4, 2), (4, 4), (4, 20))
# Storage dtype -> (compute dtype, C entry point).
_STORAGE = {torch.float32: (torch.float32, "examl_newview_chunks_f32"),
            torch.float64: (torch.float64, "examl_newview_chunks_f64"),
            torch.bfloat16: (torch.float32, "examl_newview_chunks_bf16")}


def supported(R: int, K: int, storage=None) -> bool:
    """Whether the CUDA kernel has an instance for R rates x K states with
    CLVs stored in `storage` (float32, float64, or bfloat16 with float32
    compute; None asks for the float32 instance)."""
    return (R, K) in _SUPPORTED_RK and (storage is None
                                        or storage in _STORAGE)


def chunk_operands(models: kernels.DeviceModels, zl: torch.Tensor,
                   zr: torch.Tensor) -> torch.Tensor:
    """Every P matrix of a traversal's packed slots, P[s, side, m, r, a, k]
    [P, 2, M, R, K, K], from one batched p_matrices_wave over the packed
    branch vectors zl, zr [P, C] (left and right interleaved per slot)."""
    P = zl.shape[0]
    p = kernels.p_matrices_wave(models, torch.stack([zl, zr], dim=1).reshape(
        2 * P, zl.shape[1]))                               # [2P,M,R,K,K]
    return p.reshape((P, 2) + tuple(p.shape[1:])).contiguous()


def tip_products(pmat: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """u[s, side, m, c, r, a] = sum_k P[s, side, m, r, a, k] * table[c, k]
    [P, 2, M, C, R, K]: every tip child's y by code, from one batched
    einsum over a traversal's P (`chunk_operands` or `whole_operands`) and
    the [C, K] tip table."""
    return torch.einsum("psmrak,ck->psmcra", pmat, table).contiguous()


def chunk_apply(clv, scaler, codes, table, block_part, launch, lidx, ridx,
                lcode, rcode, pmat, scale_exp: int):
    """Run a traversal's launch table on the arena in place (see module
    docstring).

    clv [rows, B, lane, R, K]; scaler [rows, B, lane] int32; codes
    [ntips, B, lane] uint8; table [C, K]; block_part [B] int32; launch
    [n, 4] int32 host array (kind, base, slot, real); lidx/ridx (arena
    rows) and lcode/rcode (tip indices) [P] int32; pmat [P, 2, M, R, K, K].
    """
    if clv.device.type == "cpu":
        return chunk_apply_plain(clv, scaler, codes, table, block_part,
                                 launch, lidx, ridx, lcode, rcode, pmat,
                                 scale_exp)
    return chunk_apply_cuda(clv, scaler, codes, tip_products(pmat, table),
                            block_part, launch, lidx, ridx, lcode, rcode,
                            pmat, scale_exp)


def apply_chunk_plain(clv, scaler, codes, table, block_part, kind: int,
                      base: int, slot: int, width: int, lidx, ridx, lcode,
                      rcode, pmat, scale_exp: int):
    """One chunk in torch ops: slots slot..slot+width-1 write rows
    base..base+width-1 (any device, any K)."""
    rows, B, L, R, K = clv.shape
    bp = block_part.long()
    s = slice(slot, slot + width)

    def child(side, tip, idx, code):
        p = pmat[s, side][:, bp]                              # [W,B,R,K,K]
        if tip:
            x = table[codes[code[s].long()].long()]           # [W,B,L,K]
            x = x.unsqueeze(-2).expand(width, B, L, R, K)
            sc = 0
        else:
            row = idx[s].long()
            x = clv[row].to(pmat.dtype)
            sc = scaler[row]
        return torch.einsum("wbrak,wblrk->wblra", p, x), sc

    yl, sl = child(0, kind <= 1, lidx, lcode)
    yr, sr = child(1, kind == 0, ridx, rcode)
    v, inc = kernels.rescale(yl * yr, scale_exp)
    clv[base:base + width] = v.to(clv.dtype)
    scaler[base:base + width] = sl + sr + inc
    return clv, scaler


def chunk_apply_plain(clv, scaler, codes, table, block_part, launch, lidx,
                      ridx, lcode, rcode, pmat, scale_exp: int):
    """The plain PyTorch version of kernel B1 over a launch table: one
    gather, compute and scatter per chunk at its real width."""
    for kind, base, slot, real in np.asarray(launch).tolist():
        apply_chunk_plain(clv, scaler, codes, table, block_part, kind, base,
                          slot, real, lidx, ridx, lcode, rcode, pmat,
                          scale_exp)
    return clv, scaler


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_launch(launch, rows: int, slots: int) -> np.ndarray:
    """The launch table as a contiguous int32 [n, 4] host array, each row
    a known kind with 1 <= real, its rows inside the arena and its slots
    inside the packed arrays."""
    launch = np.ascontiguousarray(launch, dtype=np.int32)
    if launch.ndim != 2 or launch.shape[1] != 4:
        raise ValueError(f"launch table has shape {launch.shape}, expected "
                         "[n, 4]")
    kind, base, slot, real = launch.T.astype(np.int64)
    bad = ((kind < 0) | (kind > 2) | (real < 1) | (base < 0)
           | (base + real > rows) | (slot < 0) | (slot + real > slots))
    if bad.any():
        raise ValueError(f"launch table row {int(np.flatnonzero(bad)[0])} "
                         f"{launch[bad][0].tolist()} is outside an arena of "
                         f"{rows} rows and {slots} packed slots")
    return launch


def chunk_apply_cuda(clv, scaler, codes, u, block_part, launch, lidx,
                     ridx, lcode, rcode, pmat, scale_exp: int):
    """Launch kernel B1 once per launch-table row on the current stream,
    from one host call (no synchronisation).  Takes `chunk_apply`'s
    operands with the tip products u [P, 2, M, C, R, K] in place of the
    table.  pmat and u are in the compute dtype of the arena's storage
    dtype (float32 for a bfloat16 arena).  Every operand is checked once
    per traversal."""
    global LAUNCHES
    from examl_tpu_torch.ops import _build

    rows, B, L, R, K = clv.shape
    dev = clv.device
    if dev.type != "cuda":
        raise ValueError(f"chunk_apply_cuda needs CUDA tensors, got {dev}")
    if clv.dtype not in _STORAGE:
        raise TypeError(f"arena dtype {clv.dtype} is not float32, float64 "
                        "or bfloat16")
    compute, entry = _STORAGE[clv.dtype]
    if not supported(R, K, clv.dtype):
        raise ValueError(f"(R, K) = {(R, K)} has no kernel instance")
    if u.dim() != 6:
        raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                         "[P, 2, M, C, R, K]")
    P = lidx.shape[0]
    C = u.shape[3]
    M = pmat.shape[2]
    _check(clv, "clv", clv.dtype, (rows, B, L, R, K), dev)
    _check(scaler, "scaler", torch.int32, (rows, B, L), dev)
    _check(codes, "codes", torch.uint8, (codes.shape[0], B, L), dev)
    _check(block_part, "block_part", torch.int32, (B,), dev)
    for name, t in (("lidx", lidx), ("ridx", ridx), ("lcode", lcode),
                    ("rcode", rcode)):
        _check(t, name, torch.int32, (P,), dev)
    _check(pmat, "pmat", compute, (P, 2, M, R, K, K), dev)
    _check(u, "u", compute, (P, 2, M, C, R, K), dev)
    for name, t in (("clv", clv), ("scaler", scaler), ("codes", codes),
                    ("pmat", pmat), ("u", u)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} base address is not 16-byte aligned")
    launch = check_launch(launch, rows, P)
    if launch.shape[0] == 0:
        return clv, scaler
    lib = _build.library("newview_chunk")
    fn = getattr(lib, entry)
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(clv.data_ptr(), scaler.data_ptr(), codes.data_ptr(),
                 u.data_ptr(), block_part.data_ptr(), lidx.data_ptr(),
                 ridx.data_ptr(), lcode.data_ptr(), rcode.data_ptr(),
                 pmat.data_ptr(), launch.ctypes.data, launch.shape[0], B, L,
                 M, C, R, K, ctypes.c_double(2.0 ** (-scale_exp)),
                 ctypes.c_double(2.0 ** scale_exp), stream,
                 ctypes.byref(launched))
    LAUNCHES += launched.value
    LAUNCHES_BY_K[K] = LAUNCHES_BY_K.get(K, 0) + launched.value
    name = str(clv.dtype).removeprefix("torch.")
    LAUNCHES_BY_DTYPE[name] = LAUNCHES_BY_DTYPE.get(name, 0) + launched.value
    if err != 0:
        raise RuntimeError(f"newview_chunk kernel launch failed: CUDA "
                           f"error {err} ({_build.error_string(err)})")
    return clv, scaler
