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
(`csrc/newview_chunk.cu`) for a CUDA arena, after building u, and through
the plain version for a CPU arena.  On the card the whole table is one
dataflow launch: persistent CTAs claim tiles in table order and a tile
waits only for its inner children's tiles over the same sites, through
per (arena row, tile) ready flags (`Ready`, owned by the engine beside its
arena) stamped with the traversal's epoch; the caller passes the table's
`Dataflow`: each row's first entry and every packed slot's wait bits, from
`fastpath.dataflow_table` (the engine's from its cached structure).
Instances listed in `ROUTE` as "chunks" launch once per table row
instead, in order.
The plain version contracts a tip's indicator vector with P as it does an
inner child, so holding the kernel against it also holds u.  On a CUDA
tensor it launches or raises; nothing falls back.  `LAUNCHES` counts kernel
launches (and nothing else), so a run can show that its path went
through the kernel; `LAUNCHES_BY_K` counts the same launches by state
count, `LAUNCHES_BY_DTYPE` by the arena's storage dtype, and the metrics
counter `kernel.newview_chunk.launches` in a process's snapshot.  The
site shards of one process launch from threads of their own
(parallel/shards.py): the counts take a lock and count every shard's
launches.

The arena may store bfloat16 with float32 compute (the engine's
`clv_dtype`, the JAX package's EXAML_CLV_DTYPE=bf16): P, the tip
products, the arithmetic and the rescale decision stay float32, child
rows are upcast after the load and each output is rounded to nearest even
once, after the rescale.  The plain version does the same with `.to`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.ops import kernels

LAUNCHES = 0
LAUNCHES_BY_K: dict = {}     # the same launches by state count K
LAUNCHES_BY_DTYPE: dict = {}  # ... and by storage dtype ("bfloat16", ...)
_COUNT_LOCK = threading.Lock()

# (R, K) instantiated in csrc/newview_chunk.cu: GAMMA's four rates over
# binary, DNA and amino-acid states, each for every storage dtype below.
_SUPPORTED_RK = ((4, 2), (4, 4), (4, 20))
# Storage dtype -> (compute dtype, C entry-point suffix, storage code of
# examl_newview_chunk_config).
_STORAGE = {torch.float32: (torch.float32, "f32", 0),
            torch.float64: (torch.float64, "f64", 1),
            torch.bfloat16: (torch.float32, "bf16", 2)}
# How each instance (K, storage dtype) runs a launch table on the card:
# "flow", one dataflow launch per table, or "chunks", one launch per row,
# whichever was faster per real-width traversal on the H100 (chip_smoke.py
# times both in turns).  bfloat16 at K = 20 keeps its per-chunk launches:
# there the dataflow kernel, sized for the inner/inner body (168 registers,
# one CTA an SM), ran the tip/tip and tip/inner tiles slower than the
# per-chunk kernels, whose tip/tip instance holds two CTAs an SM.
ROUTE = {(K, dt): "flow" for K in (2, 4, 20) for dt in _STORAGE}
ROUTE[(20, torch.bfloat16)] = "chunks"


def table_launches(K: int, storage, rows: int) -> int:
    """Kernel launches of one launch table of `rows` rows on the instance
    (K, storage dtype): one on the dataflow route, one a row per chunk."""
    return 1 if ROUTE[(K, storage)] == "flow" else rows


class Ready:
    """The ready flags of one arena's dataflow launches: int32 [rows, NT]
    (arena row, tile of an entry), the epoch of the last traversal (a
    tile is ready once its flag holds the current epoch, so the flags are
    never cleared, only when the epoch would wrap) and the launch's claim
    counter.  Owned by the engine beside its arena; reallocated (zeros, a
    new epoch count) when the arena's rows or the tiles per entry
    change."""

    def __init__(self):
        self.flags: Optional[torch.Tensor] = None
        self.counter: Optional[torch.Tensor] = None
        self.epoch = 0

    def next_epoch(self, rows: int, nt: int, device) -> int:
        f = self.flags
        if f is None or tuple(f.shape) != (rows, nt) or f.device != device:
            self.flags = torch.zeros((rows, nt), dtype=torch.int32,
                                     device=device)
            self.counter = torch.zeros(1, dtype=torch.int32, device=device)
            self.epoch = 0
        if self.epoch == 2 ** 31 - 1:
            self.flags.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


class Dataflow(NamedTuple):
    """A dataflow launch's operands beside chunk_apply's: `rows` and
    `wait` of `fastpath.dataflow_table` on the arena's device, and the
    arena's `Ready` flags."""
    rows: torch.Tensor
    wait: torch.Tensor
    ready: Ready


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
    matmul over a traversal's P (`chunk_operands` or `whole_operands`) and
    the [C, K] tip table, table @ P[s, side, m]^T as [C, R*K], which is
    u's layout (the einsum "psmrak,ck->psmcra" gives the same values but
    permutes its product in a second pass)."""
    P, _, M, R, K, _ = pmat.shape
    return torch.matmul(table, pmat.reshape(-1, R * K, K).transpose(1, 2)
                        ).reshape(P, 2, M, table.shape[0], R, K)


def chunk_apply(clv, scaler, codes, table, block_part, launch, lidx, ridx,
                lcode, rcode, pmat, scale_exp: int,
                flow: Optional[Dataflow] = None, u=None):
    """Run a traversal's launch table on the arena in place (see module
    docstring).

    clv [rows, B, lane, R, K]; scaler [rows, B, lane] int32; codes
    [ntips, B, lane] uint8; table [C, K]; block_part [B] int32; launch
    [n, 4] int32 host array (kind, base, slot, real); lidx/ridx (arena
    rows) and lcode/rcode (tip indices) [P] int32; pmat [P, 2, M, R, K, K];
    flow the table's Dataflow with the arena's Ready flags, which the
    dataflow route needs (the engine passes its cached structure's).  The
    plain version and the per-chunk route read no flow.  u: the tip
    products of pmat where the caller built them (the card's route reads
    them; by default `tip_products(pmat, table)`).
    """
    with obs.device_span("newview:chunk_apply",
                         args={"rows": int(len(launch))}):
        if clv.device.type == "cpu":
            return chunk_apply_plain(clv, scaler, codes, table, block_part,
                                     launch, lidx, ridx, lcode, rcode, pmat,
                                     scale_exp)
        return chunk_apply_cuda(clv, scaler, codes,
                                tip_products(pmat, table) if u is None
                                else u, block_part, launch, lidx, ridx,
                                lcode, rcode, pmat, scale_exp, flow)


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


def check_launch(launch, rows: Optional[int], slots: int) -> np.ndarray:
    """The launch table as a contiguous int32 [n, 4] host array, each row
    a known kind with 1 <= real, its rows inside the arena (`rows`, None
    for unknown) and its slots inside the packed arrays, no arena row
    written twice (the dataflow launch could not order the writes;
    `fastpath.dataflow_table` also refuses a read of a row that the same
    or a later table row writes)."""
    launch = np.ascontiguousarray(launch, dtype=np.int32)
    if launch.ndim != 2 or launch.shape[1] != 4:
        raise ValueError(f"launch table has shape {launch.shape}, expected "
                         "[n, 4]")
    kind, base, slot, real = launch.T.astype(np.int64)
    bad = ((kind < 0) | (kind > 2) | (real < 1) | (base < 0)
           | (slot < 0) | (slot + real > slots))
    if rows is not None:
        bad |= base + real > rows
    if bad.any():
        raise ValueError(f"launch table row {int(np.flatnonzero(bad)[0])} "
                         f"{launch[bad][0].tolist()} is outside an arena of "
                         f"{rows} rows and {slots} packed slots")
    order = np.argsort(base, kind="stable")
    end = base[order] + real[order]
    clash = np.flatnonzero(base[order][1:] < np.maximum.accumulate(end)[:-1])
    if clash.size:
        i = int(max(order[clash[0]], order[clash[0] + 1]))
        raise ValueError(f"launch table row {i} {launch[i].tolist()} writes "
                         "a row an other table row writes")
    return launch


def _flow_tiles(storage_code: int, R: int, K: int, B: int, L: int,
                C: int) -> int:
    """Tiles per entry of an instance's dataflow kernel: its B x (L / tile
    sites) units in tiles of its units per tile (examl_newview_chunk_config,
    kind 3)."""
    from examl_tpu_torch.ops import _build
    out = (ctypes.c_int * 7)()
    _raise_on(_build.library("newview_chunk").examl_newview_chunk_config(
        storage_code, R, K, 3, L, C, out), "configuration")
    return -(-B * (L // out[4]) // out[6])


def chunk_apply_cuda(clv, scaler, codes, u, block_part, launch, lidx,
                     ridx, lcode, rcode, pmat, scale_exp: int,
                     flow: Optional[Dataflow] = None):
    """Run kernel B1 over a launch table on the current stream (no
    synchronisation), by the instance's ROUTE: one dataflow launch, or one
    launch per table row from one host call.  Takes `chunk_apply`'s
    operands with the tip products u [P, 2, M, C, R, K] in place of the
    table.  pmat and u are in the compute dtype of the arena's storage
    dtype (float32 for a bfloat16 arena).  Every operand is checked once
    per traversal."""
    rows, B, L, R, K = clv.shape
    dev = clv.device
    if dev.type != "cuda":
        raise ValueError(f"chunk_apply_cuda needs CUDA tensors, got {dev}")
    if clv.dtype not in _STORAGE:
        raise TypeError(f"arena dtype {clv.dtype} is not float32, float64 "
                        "or bfloat16")
    compute = _STORAGE[clv.dtype][0]
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
    if ROUTE[(K, clv.dtype)] == "flow":
        if flow is None:
            raise ValueError("the dataflow route needs the launch table's "
                             "Dataflow (fastpath.dataflow_table)")
        _launch_flow(clv, scaler, codes, u, block_part, launch, lidx, ridx,
                     lcode, rcode, pmat, scale_exp, flow)
    else:
        _launch_chunks(clv, scaler, codes, u, block_part, launch, lidx, ridx,
                       lcode, rcode, pmat, scale_exp)
    return clv, scaler


def _count(clv, launched: int) -> None:
    global LAUNCHES
    K = clv.shape[-1]
    name = str(clv.dtype).removeprefix("torch.")
    with _COUNT_LOCK:
        LAUNCHES += launched
        LAUNCHES_BY_K[K] = LAUNCHES_BY_K.get(K, 0) + launched
        LAUNCHES_BY_DTYPE[name] = LAUNCHES_BY_DTYPE.get(name, 0) + launched
    # The same count in the metrics registry: a process's --metrics
    # snapshot (a supervised child's) carries its launches, a quiet
    # shard's too.
    obs.registry().inc("kernel.newview_chunk.launches", launched)


def _raise_on(err: int, what: str) -> None:
    from examl_tpu_torch.ops import _build
    if err != 0:
        raise _build.KernelError(f"newview_chunk {what} failed: CUDA error "
                                 f"{err} ({_build.error_string(err)})")


def _launch_chunks(clv, scaler, codes, u, block_part, launch, lidx, ridx,
                   lcode, rcode, pmat, scale_exp: int) -> int:
    """One launch per row of a checked table, in order, from one host
    call (chunk_apply_cuda's operands, already checked)."""
    from examl_tpu_torch.ops import _build
    _, B, L, R, K = clv.shape
    fn = getattr(_build.library("newview_chunk"),
                 "examl_newview_chunks_" + _STORAGE[clv.dtype][1])
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(clv.device).cuda_stream
    with torch.cuda.device(clv.device):
        err = fn(clv.data_ptr(), scaler.data_ptr(), codes.data_ptr(),
                 u.data_ptr(), block_part.data_ptr(), lidx.data_ptr(),
                 ridx.data_ptr(), lcode.data_ptr(), rcode.data_ptr(),
                 pmat.data_ptr(), launch.ctypes.data, launch.shape[0], B, L,
                 pmat.shape[2], u.shape[3], R, K,
                 ctypes.c_double(2.0 ** (-scale_exp)),
                 ctypes.c_double(2.0 ** scale_exp), stream,
                 ctypes.byref(launched))
    _count(clv, launched.value)
    _raise_on(err, "kernel launch")
    return launched.value


def _launch_flow(clv, scaler, codes, u, block_part, launch, lidx, ridx,
                 lcode, rcode, pmat, scale_exp: int, flow: Dataflow) -> int:
    """The dataflow launch of a checked table (chunk_apply_cuda's
    operands, already checked): the flow's rows and wait bits checked
    against the table, a new epoch of its Ready flags, one launch."""
    from examl_tpu_torch.ops import _build
    rows, B, L, R, K = clv.shape
    dev = clv.device
    n, P = launch.shape[0], lidx.shape[0]
    _check(flow.rows, "flow rows", torch.int32, (n + 1, 4), dev)
    _check(flow.wait, "flow wait", torch.int32, (P,), dev)
    storage = _STORAGE[clv.dtype]
    nt = _flow_tiles(storage[2], R, K, B, L, u.shape[3])
    epoch = flow.ready.next_epoch(rows, nt, dev)
    fn = getattr(_build.library("newview_chunk"),
                 "examl_newview_flow_" + storage[1])
    launched = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(clv.data_ptr(), scaler.data_ptr(), codes.data_ptr(),
                 u.data_ptr(), block_part.data_ptr(), lidx.data_ptr(),
                 ridx.data_ptr(), lcode.data_ptr(), rcode.data_ptr(),
                 pmat.data_ptr(), flow.rows.data_ptr(), flow.wait.data_ptr(),
                 flow.ready.flags.data_ptr(), flow.ready.counter.data_ptr(),
                 n, int(launch[:, 3].sum()), nt, epoch, B, L, pmat.shape[2],
                 u.shape[3], R, K, ctypes.c_double(2.0 ** (-scale_exp)),
                 ctypes.c_double(2.0 ** scale_exp), stream,
                 ctypes.byref(launched))
    _count(clv, launched.value)
    _raise_on(err, "dataflow launch")
    return launched.value
