"""The site axis over ranks: block windows and the reductions over them.

The port of the 1-D site axis of `examl_tpu/parallel/sharding.py`.  The
reference's one parallel strategy (ExaML `partitionAssignment.c` +
`communication.c`) gives every rank the whole tree and model and a
disjoint slice of the alignment sites; every quantity that is a sum over
sites then becomes one `MPI_Allreduce` (`evaluateGenericSpecial.c:
968-973`, `makenewzGenericSpecial.c:1241-1248`).  The JAX package shards
the packed block axis over a `Mesh` axis named SITE_AXIS and lets XLA
insert those all-reduces under each segment sum.  A PyTorch program has
no compiler that partitions it, so the port runs one process per rank:
rank r holds the contiguous block window `window(B)` of every bucket
(parallel/packing.py: `pack_partitions_local`, `window_of`) and the
engine reduces each site sum once, through the rank's `SiteGroup`.

The reductions run on host float64 arrays over gloo: every reduction
point already reads its result back to the host (lnL [M], NR d1/d2
[N, C], candidate lnLs [N]), and gloo lets two ranks share one card.  An
`allreduce` is an allgather followed by a sum in rank order on every
rank, so each rank gets the same bits, whatever the world size and
whatever order the transport combines in: every host decision taken
from a reduced value (a Newton-Raphson exit, Brent's next probe, an SPR
acceptance) is taken alike on every rank.  `SINGLE`, the world of one,
returns its inputs unchanged, so a single-process run pays nothing.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SITE_AXIS = "sites"


def block_window(num_blocks: int, rank: int, size: int) -> Tuple[int, int]:
    """Blocks [b0, b1) of rank `rank` of `size` when `num_blocks` blocks
    split contiguously and evenly (the packing pads the block count to a
    multiple of the world size)."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside [0, {size})")
    if num_blocks % size:
        raise ValueError(
            f"{num_blocks} blocks do not divide over {size} ranks; pack "
            f"with block_multiple a multiple of {size}")
    return rank * num_blocks // size, (rank + 1) * num_blocks // size


class SiteGroup:
    """This rank's place on the site axis and its collectives.

    `process_group` is a `torch.distributed` group with the gloo backend
    (parallel/launch.py makes it); None only for the world of one.
    `collectives` counts the collectives this rank issued: every rank of
    a run must issue the same number, in the same order."""

    def __init__(self, rank: int = 0, size: int = 1, process_group=None):
        if size > 1 and process_group is None:
            raise ValueError("a group of more than one rank needs a "
                             "process group")
        self.rank = rank
        self.size = size
        self.process_group = process_group
        self.collectives = 0

    def window(self, num_blocks: int) -> Tuple[int, int]:
        return block_window(num_blocks, self.rank, self.size)

    def _allgather(self, a: np.ndarray) -> List[np.ndarray]:
        """Every rank's `a` (same shape and dtype on every rank), in rank
        order."""
        import torch
        import torch.distributed as dist
        self.collectives += 1
        t = torch.from_numpy(np.ascontiguousarray(a))
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.process_group)
        return [o.numpy() for o in out]

    def allreduce(self, a: np.ndarray) -> np.ndarray:
        """The float64 sum of `a` over ranks, summed in rank order, so
        every rank gets the same bits."""
        if self.size == 1:
            return a
        parts = self._allgather(np.asarray(a, dtype=np.float64))
        out = parts[0].copy()
        for p in parts[1:]:
            out += p
        return out

    def allgather_blocks(self, a: np.ndarray) -> np.ndarray:
        """Every rank's block window of `a` (blocks on axis 0), tiled in
        rank order: the global array."""
        if self.size == 1:
            return a
        return np.concatenate(self._allgather(np.asarray(a)), axis=0)


# The world of one: a single-process run.
SINGLE = SiteGroup()
