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
In one process the same windows run as site shards, one engine set a
card, each on a thread of its own (parallel/shards.py), and their
`ThreadSiteGroup`s meet on a shared board instead of gloo.

The reductions run on host float64 arrays over gloo: every reduction
point already reads its result back to the host (lnL [M], NR d1/d2
[N, C], candidate lnLs [N]), and gloo lets two ranks share one card.  An
`allreduce` is an allgather followed by a sum in rank order on every
rank, so each rank gets the same bits, whatever the world size and
whatever order the transport combines in: every host decision taken
from a reduced value (a Newton-Raphson exit, Brent's next probe, an SPR
acceptance) is taken alike on every rank.  `SINGLE`, the world of one,
returns its inputs unchanged, so a single-process run pays nothing.

Below the groups: the (sites, tree) fabric's records, the declared
layouts the JAX package's `--mesh SxT` builds; the port runs the site
axis in parallel/shards.py and the tree axis, over the site shards of
each slice, in fleet/shard.py.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

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

    def allmax(self, value: int) -> int:
        """The largest of every rank's integer `value`."""
        if self.size == 1:
            return value
        return int(max(p[0] for p in self._allgather(
            np.asarray([value], dtype=np.int64))))

    def allgather_blocks(self, a: np.ndarray) -> np.ndarray:
        """Every rank's block window of `a` (blocks on axis 0), tiled in
        rank order: the global array."""
        if self.size == 1:
            return a
        return np.concatenate(self._allgather(np.asarray(a)), axis=0)


# The world of one: a single-process run.
SINGLE = SiteGroup()


class ShardBoard:
    """The exchange of the site shards of one process: a slot per rank
    and a barrier.  A shard that raises aborts the barrier, so every peer
    waiting in a collective raises `threading.BrokenBarrierError` at
    once; a peer that never comes breaks it after `timeout` seconds."""

    def __init__(self, size: int, timeout: Optional[float] = None):
        self.slots: List[Optional[np.ndarray]] = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)

    def exchange(self, rank: int, a: np.ndarray) -> List[np.ndarray]:
        """Every rank's `a`, in rank order.  The second wait keeps a slot
        until every rank has read the board."""
        self.slots[rank] = a
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts

    def abort(self) -> None:
        self.barrier.abort()

    def reset(self) -> None:
        """Make an aborted board usable again (every shard has returned)."""
        self.barrier.reset()
        self.slots = [None] * len(self.slots)


class ThreadSiteGroup(SiteGroup):
    """A site shard's place on the axis when the shards are threads of
    one process: `SiteGroup`'s interface and arithmetic (an allgather,
    then the sum in rank order on every shard), over a `ShardBoard`.  So
    an `Sx1` instance reduces to the same bits as S gloo ranks over the
    same windows."""

    def __init__(self, rank: int, size: int, board: ShardBoard):
        super().__init__(rank, 1)
        self.size = size
        self.board = board

    def _allgather(self, a: np.ndarray) -> List[np.ndarray]:
        self.collectives += 1
        return self.board.exchange(self.rank, np.array(a, copy=True))


# -- the (sites, tree) fabric ------------------------------------------------
#
# The JAX package declares a 2-D `jax.sharding.Mesh` over (sites, tree):
# each tree slice of S devices holds the whole model and its site shards,
# and the fleet's stacked per-job leaves are partitioned over the T tree
# slices.  The port keeps the mesh as a plain record (an S x T array of
# torch devices and the axis names) and runs each axis itself.  The
# site axis: one engine set per card of tree slice 0, a thread each,
# over its block window, the site sums reduced through
# `ThreadSiteGroup`s (parallel/shards.py).  The tree axis:
# `fleet/shard.py: MeshShard` cuts each batch's jobs into T slices, one
# launch table each on every card of its slice (`slice_devices`), a
# lane per site shard whose rows the slice sums in rank order.

TREE_AXIS = "tree"


class PartitionSpec(tuple):
    """The JAX package's `PartitionSpec` as a declaration only: a tuple of
    axis names (None for an unsharded dimension) whose str() is
    `jax.sharding.PartitionSpec`'s, so the declared-specs record is the
    JAX package's, string for string."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


class Mesh:
    """A device mesh: `devices`, an array of torch devices of one shape per
    axis (S x T for the fabric, S for the 1-D site mesh), and the axis
    names.  A device may stand more than once (site shards or lanes that
    share a card; only the Python API builds such a mesh)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array for "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


class SiteSharding:
    """The layout of every engine tensor over a mesh, as the JAX
    package's `SiteSharding` declares it: the CLV arena and the scaler
    with blocks on axis 1, weights and block_part with blocks on axis 0,
    models replicated.  The specs never name the tree axis: each tree
    slice holds the engine state whole (for S = 1, on its one device)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.clv = P(None, SITE_AXIS)
        self.scaler = P(None, SITE_AXIS)
        self.sites = P(SITE_AXIS)
        self.blocks = P(SITE_AXIS)
        self.replicated = P()

    @property
    def num_devices(self) -> int:
        """The site-axis extent: the divisor of the packed block axis.
        The tree axis does not split blocks."""
        return int(self.mesh.shape[SITE_AXIS])

    @property
    def site_shards(self) -> int:
        return self.num_devices

    @property
    def tree_shards(self) -> int:
        return int(self.mesh.shape.get(TREE_AXIS, 1))

    @property
    def is_fabric(self) -> bool:
        """True when the mesh carries the tree axis (even T = 1)."""
        return TREE_AXIS in self.mesh.axis_names

    def site_devices(self) -> list:
        """The device of each site shard (of tree slice 0)."""
        return self.slice_devices(0)

    def slice_devices(self, k: int) -> list:
        """The device of each site shard of tree slice k
        (`mesh.devices[:, k]`; the site devices on a 1-D mesh, k = 0)."""
        if not 0 <= k < self.tree_shards:
            raise ValueError(f"tree slice {k} outside [0, "
                             f"{self.tree_shards})")
        if not self.is_fabric:
            return list(self.mesh.devices)
        return list(self.mesh.devices[:, k])


def visible_devices() -> list:
    """Every visible card, `cuda:0 .. cuda:n-1` (none without CUDA)."""
    import torch
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", k)
            for k in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the site axis (default: every visible card)."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (SITE_AXIS,))


def site_sharding(mesh: Mesh) -> SiteSharding:
    return SiteSharding(mesh)


def default_site_sharding(n_devices: Optional[int] = None) -> SiteSharding:
    return site_sharding(make_mesh(n_devices=n_devices))


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """`--mesh SxT` / `EXAML_MESH=SxT` -> (site_shards, tree_shards).
    Accepts 'x' or 'X' as the separator; both axes must be positive."""
    text = str(spec).strip().lower()
    parts = text.split("x")
    if len(parts) != 2:
        raise ValueError(
            f"mesh spec {spec!r} is not SxT (e.g. 2x2: 2 site shards "
            "x 2 tree shards)")
    try:
        s, t = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"mesh spec {spec!r}: both axes must be integers")
    if s < 1 or t < 1:
        raise ValueError(f"mesh spec {spec!r}: both axes must be >= 1")
    return s, t


def make_fabric_mesh(site_shards: int, tree_shards: int,
                     devices: Optional[Sequence] = None) -> Mesh:
    """The 2-D (sites, tree) mesh: S*T devices (default: the visible
    cards) reshaped with the site axis outermost.  An explicit `devices`
    list may name one card more than once (lanes that share it)."""
    if devices is None:
        devices = visible_devices()
    devices = list(devices)
    need = site_shards * tree_shards
    if need > len(devices):
        raise ValueError(
            f"mesh {site_shards}x{tree_shards} needs {need} devices; "
            f"only {len(devices)} visible (pass the devices from Python, "
            "or shrink the mesh)")
    arr = np.empty(need, dtype=object)
    arr[:] = devices[:need]
    return Mesh(arr.reshape(site_shards, tree_shards),
                (SITE_AXIS, TREE_AXIS))


def fabric_sharding(mesh: Mesh) -> SiteSharding:
    """Engine-tensor layouts over the fabric: `site_sharding`'s specs
    (the tree axis replicates the engine state), declared on the 2-D
    mesh."""
    return site_sharding(mesh)


def declared_specs(sharding: SiteSharding) -> dict:
    """The mesh's declared-sharding record for `bank_manifest.json`: axis
    names, mesh shape and per-leaf PartitionSpecs, JSON-ready and equal
    to the JAX package's for the same mesh."""
    leaf_specs = {
        "clv": str(sharding.clv),
        "scaler": str(sharding.scaler),
        "sites": str(sharding.sites),
        "blocks": str(sharding.blocks),
        "replicated": str(sharding.replicated),
    }
    if sharding.is_fabric:
        leaf_specs["fleet_jobs"] = str(P(TREE_AXIS))
        leaf_specs["fleet_clv"] = str(P(TREE_AXIS, None, SITE_AXIS))
    return {
        "axis_names": list(sharding.mesh.axis_names),
        "mesh_shape": [int(d) for d in sharding.mesh.devices.shape],
        "site_shards": sharding.site_shards,
        "tree_shards": sharding.tree_shards,
        "leaf_specs": leaf_specs,
    }


def declared_fabric_specs(site_shards: int, tree_shards: int) -> dict:
    """`declared_specs` of an (S, T) fabric without building the mesh
    (the bank stamps its manifest before any device is touched)."""
    return {
        "axis_names": [SITE_AXIS, TREE_AXIS],
        "mesh_shape": [int(site_shards), int(tree_shards)],
        "site_shards": int(site_shards),
        "tree_shards": int(tree_shards),
        "leaf_specs": {
            "clv": str(P(None, SITE_AXIS)),
            "scaler": str(P(None, SITE_AXIS)),
            "sites": str(P(SITE_AXIS)),
            "blocks": str(P(SITE_AXIS)),
            "replicated": str(P()),
            "fleet_jobs": str(P(TREE_AXIS)),
            "fleet_clv": str(P(TREE_AXIS, None, SITE_AXIS)),
        },
    }
