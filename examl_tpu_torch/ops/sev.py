"""SEV memory saving (`-S`): block-granular CLV pool with gap sharing.

The port of `examl_tpu/ops/sev.py`, single-device form.  Reference design
(`-S`): per-node gap bit-vectors, CLVs allocated only for non-gap sites,
and one shared `gapColumn` CLV per node for all-gap sites
(`axml.c:2152-2171`, `newviewGenericSpecial.c:139-160`; the 70 GB -> 19 GB
claim `axml.c:874-876`).

The saving is expressed as indirection at 128-site block granularity
instead of per-site compaction.  A (node row, block) cell whose subtree is
all gap in that block is not stored: reads map it to one shared constant
all-ones cell (an all-gap subtree's CLV is exactly 1: P(z) rows sum to 1,
and products of ones stay ones, never rescaled); writes map it to a
scratch cell.  Real cells live in a flat pool `[S, lane, R, K]` on the
engine's device that grows on demand; the host tracks per-node gap
bitsets (AND of the children's, updated with every traversal it builds,
the reference's in-kernel `x3_gap = x1_gap & x2_gap`) and a free list, so
topology changes reallocate only the recomputed nodes' cells.  The
scaler stays dense (`[rows, B, lane]` int32, a 64th of a CLV row's bytes
in f32 GAMMA DNA).

Zero-weight padding blocks are all gap for every tip, so SEV also stops
paying for lane padding.  A block with any non-gap site is stored whole:
the reference compacts per site, so its ratio is better on alignments
whose gaps do not align to 128-column runs.

The host bookkeeping is the JAX package's, line for line, so the same
traversal sequence allocates the same cell ids in the same order in both
packages.  Cell ids are kept per device range (`free[d]`, `next_cell[d]`)
with one range here; a sharded pool gives each device its own range of
the block axis and its own pool region (the JAX module's design notes).

In a site-parallel run each rank's pool covers its own block window: the
engine hands it the window's tip codes, so its gap bits and cells are
the window's.  The site shards of one process (parallel/shards.py) are
the JAX package's per-device pool regions: each shard's pool is the
region of its card, with the region's cell ids, and the shards agree
one region capacity on every sync (`cap_reduce`: the largest shard's
need, one collective each sync), as the JAX package's `cap_reduce` and
its uniform regions do (`examl_tpu/ops/engine.py:296-325`,
`examl_tpu/ops/sev.py:84-125`).  Its dirty flag needs no agreement
here: each shard uploads its own slot maps.  Ranks in processes keep
pools of their own sizes (no collective per traversal over gloo).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from examl_tpu_torch.tree.topology import TraversalEntry
from examl_tpu_torch.utils import next_pow2

ONES_CELL = 0      # shared constant all-ones cell (read target of gap cells)
SCRATCH_CELL = 1   # write target of gap cells; content never read
FIRST_DATA_CELL = 2


class SevState:
    """Host bookkeeping + device tensors for one engine's CLV pool."""

    def __init__(self, tip_codes: np.ndarray, undetermined_code: int,
                 num_rows: int, B: int, lane: int, R: int, K: int,
                 dtype: torch.dtype, device, cap_reduce=None):
        """cap_reduce(cells) -> the cell count every region of the pool
        must hold (a site shard's: the largest over the shards); called
        on every sync."""
        self.B, self.lane, self.R, self.K = B, lane, R, K
        self._cap_reduce = cap_reduce
        self.dtype = dtype
        self.device = device
        # One device range; the per-range lists are what a sharded pool
        # extends.
        self.ndev = 1
        self.B_local = B
        ntips = tip_codes.shape[0]
        codes = tip_codes.reshape(ntips, B, lane)
        self.tip_gap = (codes == undetermined_code).all(axis=2)  # [ntips, B]
        self.ntips = ntips
        self.num_rows = num_rows
        self.node_gap = np.ones((num_rows, B), dtype=bool)
        self.cell_of = np.full((num_rows, B), -1, dtype=np.int64)
        self.free: List[List[int]] = [[] for _ in range(self.ndev)]
        self.next_cell: List[int] = [FIRST_DATA_CELL] * self.ndev
        self.scan_base = num_rows             # the scan region's first row
        self.scan_cap = 0                     # and its rows
        self.cap = 0                          # pool capacity in cells
        self.pool = None                      # device [cap, lane, R, K]
        self.slot_read = None                 # device [num_rows, B] int64
        self.slot_write = None
        self.dirty = True

    # -- gap bookkeeping ----------------------------------------------------

    def _gap_of(self, num: int) -> np.ndarray:
        if num <= self.ntips:
            return self.tip_gap[num - 1]
        return self.node_gap[num - self.ntips - 1]

    def update_for_entries(self, entries: List[TraversalEntry]) -> None:
        """Refresh gap bits + cell allocations for nodes about to be
        recomputed (post-order, so children update before parents)."""
        Bl = self.B_local
        for e in entries:
            row = e.parent - self.ntips - 1
            g = self._gap_of(e.left) & self._gap_of(e.right)
            need = ~g
            have = self.cell_of[row] >= 0
            if not np.array_equal(need, have):
                self.dirty = True
                for d in range(self.ndev):
                    sl = slice(d * Bl, (d + 1) * Bl)
                    co = self.cell_of[row, sl]
                    drop = have[sl] & ~need[sl]
                    if drop.any():
                        self.free[d].extend(int(c) for c in co[drop])
                        co[drop] = -1
                    grow = need[sl] & ~have[sl]
                    n = int(grow.sum())
                    if n:
                        co[grow] = self._alloc(n, d)
            self.node_gap[row] = g

    def _alloc(self, n: int, d: int = 0) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        free = self.free[d]
        take = min(n, len(free))
        for i in range(take):
            out[i] = free.pop()
        for i in range(take, n):
            out[i] = self.next_cell[d]
            self.next_cell[d] += 1
        return out

    # -- batched-scan scratch region ----------------------------------------

    def ensure_scan_rows(self, n: int) -> int:
        """Carve a dense scan region of >= n rows (a power of two, like the
        dense arena's region) out of the pool: scan rows get a real cell
        for every block — uppass CLVs mix the whole far side of the tree,
        so they have no gap structure to exploit — appended below the node
        rows in the slot maps.  Returns the region's base row."""
        if n > self.scan_cap:
            grow = next_pow2(n) - self.scan_cap
            self.node_gap = np.concatenate(
                [self.node_gap, np.zeros((grow, self.B), dtype=bool)])
            new_cells = np.empty((grow, self.B), dtype=np.int64)
            Bl = self.B_local
            for d in range(self.ndev):
                new_cells[:, d * Bl:(d + 1) * Bl] = self._alloc(
                    grow * Bl, d).reshape(grow, Bl)
            self.cell_of = np.concatenate([self.cell_of, new_cells])
            self.num_rows += grow
            self.scan_cap += grow
            self.dirty = True
        self.sync()
        return self.scan_base

    # -- device sync ---------------------------------------------------------

    def sync(self) -> None:
        """Grow the pool if needed (to max(64, 1.3 x cells + 8): the cells
        already held are copied into the new pool, so cell ids stay
        valid) and re-upload the slot maps if they changed.  A site
        shard's cell count is first agreed over the shards."""
        max_next = max(self.next_cell)
        if self._cap_reduce is not None:
            max_next = self._cap_reduce(max_next)
        if self.pool is None or max_next > self.cap:
            new_cap = max(64, int(max_next * 1.3) + 8)
            new_pool = torch.zeros((new_cap, self.lane, self.R, self.K),
                                   dtype=self.dtype, device=self.device)
            new_pool[ONES_CELL] = 1.0
            if self.pool is not None:
                new_pool[:self.cap] = self.pool
            self.pool = new_pool
            self.cap = new_cap
        if self.dirty:
            self.slot_read = torch.as_tensor(
                np.where(self.cell_of >= 0, self.cell_of, ONES_CELL),
                device=self.device)
            self.slot_write = torch.as_tensor(
                np.where(self.cell_of >= 0, self.cell_of, SCRATCH_CELL),
                device=self.device)
            self.dirty = False

    # -- reporting ------------------------------------------------------------

    def stats(self) -> dict:
        allocated = (sum(self.next_cell)
                     - self.ndev * FIRST_DATA_CELL
                     - sum(len(f) for f in self.free))
        dense = self.num_rows * self.B
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return {
            "allocated_cells": int(allocated),
            "dense_cells": int(dense),
            "cell_bytes": int(self.lane * self.R * self.K * itemsize),
            "saving_ratio": 1.0 - allocated / max(dense, 1),
        }
