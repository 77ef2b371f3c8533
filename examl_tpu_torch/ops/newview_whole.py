"""Whole-traversal kernel B2: its flat schedule, its CUDA launch and its
plain PyTorch version.

One full traversal in one launch.  `build_flat` orders the entries by
dependency wave and gives entry i arena row i; every child of a wave was
written by an earlier wave.  Entry e:

  child:   x = table[code] tiled over the R rates (tip), or arena row
           l_row / r_row (inner node, with its scaler)
  apply:   y[r, a] = sum_k P[e, side, part(b), r, a, k] * x[r, k]
  v = yl * yr;  where max |v| < 2^-E: v *= 2^E, scaler += 1
  scaler = scaler(left) + scaler(right) + that increment; write row w_row.

The operands of a traversal are its P matrices `[E, 2, M, R, K, K]`, built
by one batched `kernels.p_matrices_wave` over the 2E branch vectors
(`whole_operands`, the chunk tier's build); `block_part` maps each block
of 128 sites to its partition.  Waves are `wave_start[w] ..
wave_start[w+1]`, from the schedule's `sync` flags.

`whole_apply` launches the CUDA kernel (`csrc/newview_whole.cu`, one
cooperative grid with a grid barrier per wave) for a CUDA arena and takes
the plain version (a loop over waves in torch ops) for a CPU arena.  For
a tip child the kernel reads `tip_operand(pmat, table)`: at K >= 16 the
tip products `newview_chunk.tip_products` `[E, 2, M, C, R, K]`, built
once per traversal, whose rows are a tip's y; at K <= 4 the [C, K] table,
whose rows the kernel contracts with P as the plain version does.  On a
CUDA tensor it launches or raises; nothing falls back.  `LAUNCHES` counts
kernel launches and nothing else (`LAUNCHES_BY_K` the same by state
count, the metrics counter `kernel.newview_whole.launches` in a process's
snapshot); `LAST_GRID` is the cooperative grid of the last launch, in
blocks.

The grid is sized to the whole card's occupancy, and its blocks wait for
each other at every wave's grid barrier, so two such grids can never be
resident at once.  The site shards of one process (parallel/shards.py)
may share a card and launch from streams of their own, so B2's launches
on one card are chained: each waits on an event of the card's previous
B2 launch (`_after_previous`), whatever its stream.  The counts take a
lock and count every shard's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.ops import kernels
from examl_tpu_torch.ops.newview_chunk import (_check, chunk_operands,
                                               tip_products)
from examl_tpu_torch.tree.topology import Tree, TraversalEntry
from examl_tpu_torch.utils import z_slots

LAUNCHES = 0
LAUNCHES_BY_K: dict = {}     # the same launches by state count K
LAST_GRID = 0
# The event of each card's last B2 launch, and the lock that orders the
# launches of several threads on one card (`_after_previous`).
_LAST_ON_CARD: dict = {}
_CARD_LOCK = threading.Lock()

# (R, K) instantiated in csrc/newview_whole.cu: GAMMA's four rates over
# binary, DNA and amino-acid states.
_SUPPORTED_RK = ((4, 2), (4, 4), (4, 20))
# State counts from which the CUDA kernel runs its blocked body and takes a
# tip child's y from the tip products (kBlocked in csrc/newview_tile.cuh).
_BLOCKED_K = 16


def supported(R: int, K: int, storage=None) -> bool:
    """Whether the CUDA kernel has an instance for R rates x K states with
    CLVs stored in `storage` (float32 or float64, the compute dtype; None
    asks for the float32 instance)."""
    return (R, K) in _SUPPORTED_RK and storage in (None, torch.float32,
                                                   torch.float64)


def tip_operand(pmat: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """What the CUDA kernel reads for a tip child: the tip products
    [E, 2, M, C, R, K] at K >= 16, else the [C, K] table itself."""
    if table.shape[1] >= _BLOCKED_K:
        return tip_products(pmat, table)
    return table


class FlatSchedule(NamedTuple):
    """Wave-ordered per-entry metadata (host arrays)."""
    e_real: int                 # entry count
    meta: np.ndarray            # [E, 8] int32: l_tip r_tip l_row r_row
                                #                w_row sync pad pad
    l_code: np.ndarray          # [E] tip index of left child (or 0)
    r_code: np.ndarray
    zl: np.ndarray              # [E, C]
    zr: np.ndarray
    row_of: Dict[int, int]


def build_flat(entries: List[TraversalEntry], ntips: int,
               num_slots: int) -> FlatSchedule:
    """Wave-order entries; parents take consecutive arena rows from 0
    (same row-layout discipline as the chunked fast path)."""
    waves = Tree.schedule_waves(entries)
    flat: List[TraversalEntry] = []
    sync_flags: List[int] = []
    for wave in waves:
        for i, e in enumerate(wave):
            flat.append(e)
            sync_flags.append(1 if i == 0 else 0)
    E = len(flat)
    row_of: Dict[int, int] = {e.parent: i for i, e in enumerate(flat)}

    def child(num: int) -> Tuple[int, int, int]:
        if num <= ntips:
            return 1, 0, num - 1
        return 0, row_of[num], 0

    meta = np.zeros((E, 8), np.int32)
    l_code = np.zeros(E, np.int32)
    r_code = np.zeros(E, np.int32)
    zl = np.ones((E, num_slots))
    zr = np.ones((E, num_slots))
    for i, e in enumerate(flat):
        lt, lr, lc = child(e.left)
        rt, rr, rc = child(e.right)
        meta[i, :6] = (lt, rt, lr, rr, i, sync_flags[i])
        l_code[i], r_code[i] = lc, rc
        zl[i] = z_slots(e.zl, num_slots)
        zr[i] = z_slots(e.zr, num_slots)
    return FlatSchedule(e_real=E, meta=meta, l_code=l_code, r_code=r_code,
                        zl=zl, zr=zr, row_of=row_of)


class WholeStructure(NamedTuple):
    """The cacheable half of a whole-traversal schedule, a function of
    topology + traversal root only: the kernel's index arrays on the
    device, the node -> row map and the flat-entry index of every
    schedule entry (so `refresh_z` can permute a new traversal's branch
    vectors without rebuilding)."""
    meta: torch.Tensor          # [E, 8] int32
    l_code: torch.Tensor        # [E] int32
    r_code: torch.Tensor        # [E] int32
    wave_start: torch.Tensor    # [nwaves + 1] int32
    row_of: np.ndarray          # [2*ntips-1] node number -> row (-1 tips)
    src: np.ndarray             # [E] flat-entry index of schedule entry i


def wave_bounds(meta: np.ndarray) -> np.ndarray:
    """wave_start [nwaves + 1]: each wave's first entry (its `sync` flag)
    and the entry count."""
    starts = np.flatnonzero(meta[:, 5] == 1)
    return np.append(starts, meta.shape[0]).astype(np.int32)


def build_structure(flat, ntips: int, num_slots: int,
                    device) -> WholeStructure:
    """The flat schedule of a FlatTraversal, its index arrays placed on
    `device` in one transfer."""
    sched = build_flat(flat.to_entries(), ntips, num_slots)
    E = sched.e_real
    row_of = np.full(2 * ntips - 1, -1, dtype=np.int64)
    for num, row in sched.row_of.items():
        row_of[num] = row
    src = np.empty(E, dtype=np.int64)
    src[row_of[flat.parent]] = np.arange(flat.n)
    waves = wave_bounds(sched.meta)
    packed = torch.from_numpy(np.concatenate([
        sched.meta.reshape(-1), sched.l_code, sched.r_code,
        waves])).to(device)
    return WholeStructure(
        meta=packed[:8 * E].view(E, 8),
        l_code=packed[8 * E:9 * E], r_code=packed[9 * E:10 * E],
        wave_start=packed[10 * E:], row_of=row_of, src=src)


def refresh_z(st: WholeStructure, flat, num_slots: int):
    """The traversal's branch vectors in schedule order: (zl, zr)
    [E, num_slots] float64 host arrays."""
    zl, zr = flat.zl, flat.zr
    if zl.shape[1] != num_slots:
        zl = np.stack([z_slots(z, num_slots) for z in zl])
        zr = np.stack([z_slots(z, num_slots) for z in zr])
    return zl[st.src], zr[st.src]


def whole_operands(models: kernels.DeviceModels, zl: np.ndarray,
                   zr: np.ndarray, dtype, device) -> torch.Tensor:
    """Every P matrix of a traversal, P[e, side, m, r, a, k]
    [E, 2, M, R, K, K]: the schedule's branch vectors uploaded, then the
    chunk tier's batched build (`newview_chunk.chunk_operands`)."""
    z = torch.from_numpy(np.stack([zl, zr])).to(device=device, dtype=dtype)
    return chunk_operands(models, z[0], z[1])


def whole_apply(clv, scaler, codes, table, block_part, meta, l_code,
                r_code, wave_start, pmat, scale_exp: int):
    """Run one whole traversal on the arena in place (see module
    docstring).

    clv [rows, B, lane, R, K]; scaler [rows, B, lane] int32; codes
    [ntips, B, lane] uint8; table [C, K]; block_part [B] int32; meta
    [E, 8], l_code / r_code [E] and wave_start [nwaves + 1] int32; pmat
    [E, 2, M, R, K, K]."""
    with obs.device_span("newview:whole_apply",
                         args={"entries": int(len(meta))}):
        if clv.device.type == "cpu":
            return whole_apply_plain(clv, scaler, codes, table, block_part,
                                     meta, l_code, r_code, wave_start, pmat,
                                     scale_exp)
        return whole_apply_cuda(clv, scaler, codes, tip_operand(pmat, table),
                                block_part, meta, l_code, r_code, wave_start,
                                pmat, scale_exp)


def whole_apply_plain(clv, scaler, codes, table, block_part, meta, l_code,
                      r_code, wave_start, pmat, scale_exp: int):
    """The plain PyTorch version of kernel B2 (any device, any K): one
    gather, compute and scatter per wave."""
    rows, B, L, R, K = clv.shape
    bp = block_part.long()
    bounds = wave_start.tolist()
    for e0, e1 in zip(bounds[:-1], bounds[1:]):
        m = meta[e0:e1].long()
        W = e1 - e0

        def child(side, code):
            is_tip = m[:, side].bool()
            row = m[:, 2 + side]
            x_tip = table[codes[code[e0:e1].long()].long()]    # [W,B,L,K]
            x_tip = x_tip.unsqueeze(-2).expand(W, B, L, R, K)
            x = torch.where(is_tip.view(W, 1, 1, 1, 1), x_tip,
                            clv[row].to(table.dtype))
            sc = torch.where(is_tip.view(W, 1, 1), 0, scaler[row])
            p = pmat[e0:e1, side][:, bp]                        # [W,B,R,K,K]
            return torch.einsum("wbrak,wblrk->wblra", p, x), sc

        yl, sl = child(0, l_code)
        yr, sr = child(1, r_code)
        v, inc = kernels.rescale(yl * yr, scale_exp)
        out = m[:, 4]
        clv[out] = v.to(clv.dtype)
        scaler[out] = (sl + sr + inc).to(torch.int32)
    return clv, scaler


def whole_apply_cuda(clv, scaler, codes, tips, block_part, meta, l_code,
                     r_code, wave_start, pmat, scale_exp: int):
    """Launch kernel B2 cooperatively on the current stream (no
    synchronisation).  Takes `whole_apply`'s operands with
    `tip_operand(pmat, table)` in place of the table."""
    global LAUNCHES, LAST_GRID
    from examl_tpu_torch.ops import _build

    rows, B, L, R, K = clv.shape
    dev = clv.device
    if dev.type != "cuda":
        raise ValueError(f"whole_apply_cuda needs CUDA tensors, got {dev}")
    if clv.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"arena dtype {clv.dtype} is not float32/float64")
    if not supported(R, K):
        raise ValueError(f"(R, K) = {(R, K)} has no kernel instance")
    E = meta.shape[0]
    nwaves = wave_start.shape[0] - 1
    M = pmat.shape[2]
    blocked = K >= _BLOCKED_K
    if tips.dim() != (6 if blocked else 2):
        raise ValueError(f"tips has shape {tuple(tips.shape)}, expected "
                         + ("[E, 2, M, C, R, K]" if blocked else "[C, K]"))
    C = tips.shape[3] if blocked else tips.shape[0]
    if E > rows:
        raise ValueError(f"{E} entries write rows beyond an arena of "
                         f"{rows} rows")
    _check(clv, "clv", clv.dtype, (rows, B, L, R, K), dev)
    _check(scaler, "scaler", torch.int32, (rows, B, L), dev)
    _check(codes, "codes", torch.uint8, (codes.shape[0], B, L), dev)
    _check(tips, "tips", clv.dtype,
           (E, 2, M, C, R, K) if blocked else (C, K), dev)
    _check(block_part, "block_part", torch.int32, (B,), dev)
    _check(meta, "meta", torch.int32, (E, 8), dev)
    _check(l_code, "l_code", torch.int32, (E,), dev)
    _check(r_code, "r_code", torch.int32, (E,), dev)
    _check(wave_start, "wave_start", torch.int32, (nwaves + 1,), dev)
    _check(pmat, "pmat", clv.dtype, (E, 2, M, R, K, K), dev)
    aligned = (("clv", clv), ("scaler", scaler), ("codes", codes),
               ("pmat", pmat)) + ((("tips", tips),) if blocked else ())
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} base address is not 16-byte aligned")
    if E == 0:
        return clv, scaler
    lib = _build.library("newview_whole")
    fn = (lib.examl_newview_whole_f32 if clv.dtype == torch.float32
          else lib.examl_newview_whole_f64)
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev)
    with _CARD_LOCK, torch.cuda.device(dev):
        _after_previous(stream)
        err = fn(clv.data_ptr(), scaler.data_ptr(), codes.data_ptr(),
                 tips.data_ptr(), block_part.data_ptr(),
                 meta.data_ptr(), l_code.data_ptr(), r_code.data_ptr(),
                 wave_start.data_ptr(), pmat.data_ptr(), nwaves, B, L, M,
                 C, R, K, ctypes.c_double(2.0 ** (-scale_exp)),
                 ctypes.c_double(2.0 ** scale_exp), stream.cuda_stream,
                 ctypes.byref(grid))
        if err == 0:
            _LAST_ON_CARD[stream.device_index] = stream.record_event()
            LAUNCHES += 1
            LAUNCHES_BY_K[K] = LAUNCHES_BY_K.get(K, 0) + 1
            LAST_GRID = grid.value
    if err != 0:
        raise _build.KernelError(
            f"newview_whole cooperative launch failed: CUDA error {err} "
            f"({_build.error_string(err)})")
    obs.registry().inc("kernel.newview_whole.launches")
    return clv, scaler


def _after_previous(stream) -> None:
    """Make `stream` wait for the last B2 launch on its card (held under
    _CARD_LOCK, so the chain is in launch order)."""
    prev = _LAST_ON_CARD.get(stream.device_index)
    if prev is not None:
        stream.wait_event(prev)
