"""Site packing: partitions -> lane-aligned blocks for the TPU site axis.

This is the TPU-native replacement for the reference's load balancer
("Kassian's algorithm", ExaML `partitionAssignment.c:156-450`): instead of
assigning (partition, offset, width) chunks to MPI ranks, each partition's
pattern columns are padded with zero-weight sites to a multiple of the lane
width (the MIC backend's zero-weight `VECTOR_PADDING` trick, ExaML
`axml.c:2060-2073`, generalized), concatenated into one flat site axis, and
the resulting 128-site blocks are sharded uniformly over the device mesh.
Because every block belongs to exactly one partition, per-block P-matrix
gathers stay cheap and per-partition reductions are segment sums.

Partitions of different state counts (DNA=4 vs AA=20) go into separate
buckets, each compiled as its own device program — the same per-data-type
split the reference balancer performs (`partitionAssignment.c:398-450`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from examl_tpu_torch.constants import TPU_LANE
from examl_tpu_torch.io.alignment import PartitionData
from examl_tpu_torch.resilience import heartbeat


@dataclass
class PackedBucket:
    """All partitions of one state count packed into a flat padded site axis.

    A bucket is either GLOBAL (arrays cover the whole packed axis;
    `block_offset` 0, `global_blocks` None) or a LOCAL WINDOW of the
    global axis (multi-host selective loading: arrays cover only this
    process's contiguous block range; `num_blocks` still reports the
    GLOBAL count because every jitted program is shaped globally —
    reference analogue: each MPI rank's `partitionData` holds only its
    site slice, `byteFile.c:278-382`)."""
    states: int
    lane: int
    tip_codes: np.ndarray       # [ntaxa, S_local] uint8 (padding = undet code)
    weights: np.ndarray         # [S_local] float64, 0.0 on padding sites
    site_part: np.ndarray       # [S_local] int32 local partition id
    block_part: np.ndarray      # [B_local] int32 local partition id per block
    part_ids: List[int]         # local id -> global partition index
    part_offsets: np.ndarray    # [M] start of each partition's padded range
    part_widths: np.ndarray     # [M] true (unpadded) pattern counts
    block_offset: int = 0       # first local block's GLOBAL block index
    global_blocks: int | None = None   # None = this bucket IS global

    @property
    def num_sites(self) -> int:
        """GLOBAL padded site-axis length (jit program shapes)."""
        return self.num_blocks * self.lane

    @property
    def local_num_sites(self) -> int:
        return self.tip_codes.shape[1]

    @property
    def num_blocks(self) -> int:
        """GLOBAL block count (jit program shapes)."""
        if self.global_blocks is not None:
            return self.global_blocks
        return self.local_num_sites // self.lane

    @property
    def local_num_blocks(self) -> int:
        return self.local_num_sites // self.lane

    @property
    def is_local(self) -> bool:
        return self.global_blocks is not None

    @property
    def num_parts(self) -> int:
        return len(self.part_ids)

    def site_indices(self, local_part: int) -> np.ndarray:
        """GLOBAL padded-axis indices of partition's true patterns (only
        meaningful on a global bucket)."""
        o = int(self.part_offsets[local_part])
        w = int(self.part_widths[local_part])
        return np.arange(o, o + w)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass
class BucketLayout:
    """The pure ARITHMETIC of one bucket's packed site axis, computable
    from (global id, states, width) triples alone — no pattern data.

    This is what lets a multi-process run seek-read only its own site
    columns from a byteFile (reference `byteFile.c:278-382` readMyData /
    seekPos :31-83): the padded layout, hence every process's block
    range and its pre-image in per-partition pattern columns, is a
    function of the header metadata only."""
    states: int
    lane: int
    gids: List[int]             # local index -> global partition index
    offsets: np.ndarray         # [M] padded-axis start of each partition
    padded: np.ndarray          # [M] padded width of each partition
    widths: np.ndarray          # [M] true pattern counts
    total: int                  # padded site-axis length (incl. tail pad)

    @property
    def num_blocks(self) -> int:
        return self.total // self.lane

    def process_columns(self, procid: int, nprocs: int
                        ) -> List[Tuple[int, int, int]]:
        """(global partition id, col_lo, col_hi) of the TRUE pattern
        columns process `procid` of `nprocs` owns, assuming the block
        axis shards contiguously and evenly over processes (the 1-D
        sites mesh lists each process's devices contiguously, so a
        process's shard union is one contiguous block range).  Build
        the layout with block_multiple divisible by nprocs."""
        B = self.num_blocks
        if B % nprocs:
            raise ValueError(
                f"{B} blocks do not divide over {nprocs} processes; "
                f"pack with block_multiple a multiple of nprocs")
        s0 = (procid * B // nprocs) * self.lane
        s1 = ((procid + 1) * B // nprocs) * self.lane
        out: List[Tuple[int, int, int]] = []
        for li, gid in enumerate(self.gids):
            off = int(self.offsets[li])
            w = int(self.widths[li])
            lo = max(s0, off) - off
            hi = min(s1, off + w) - off
            if hi > lo:
                out.append((gid, lo, hi))
        return out


def pack_layout(specs: Sequence[Tuple[int, int, int]],
                lane: int = TPU_LANE,
                block_multiple: int = 1) -> Dict[int, BucketLayout]:
    """Bucket (gid, states, width) triples by state count and lay out each
    bucket's padded site axis — the metadata-only core of
    pack_partitions, shared with the selective byteFile reader."""
    by_states: Dict[int, List[Tuple[int, int]]] = {}
    for gid, states, width in specs:
        by_states.setdefault(states, []).append((gid, width))
    layouts: Dict[int, BucketLayout] = {}
    for states, group in sorted(by_states.items()):
        padded = np.array([_round_up(max(w, 1), lane) for _, w in group],
                          dtype=np.int64)
        total = _round_up(int(padded.sum()), lane * block_multiple)
        offsets = np.concatenate(([0], np.cumsum(padded)[:-1]))
        layouts[states] = BucketLayout(
            states=states, lane=lane, gids=[g for g, _ in group],
            offsets=offsets, padded=padded,
            widths=np.array([w for _, w in group], dtype=np.int64),
            total=total)
    return layouts


def pack_partitions(partitions: Sequence[PartitionData],
                    lane: int = TPU_LANE,
                    block_multiple: int = 1) -> Dict[int, PackedBucket]:
    """Group partitions by state count and pack each group.

    block_multiple: total block count is rounded up to a multiple of this
    (set to the mesh's site-axis size so sharding divides evenly).
    """
    by_states: Dict[int, List[Tuple[int, PartitionData]]] = {}
    for gid, part in enumerate(partitions):
        by_states.setdefault(part.states, []).append((gid, part))

    layouts = pack_layout(
        [(gid, part.states, part.width)
         for gid, part in enumerate(partitions)],
        lane=lane, block_multiple=block_multiple)

    buckets: Dict[int, PackedBucket] = {}
    for states, group in sorted(by_states.items()):
        # Liveness per bucket: packing a large alignment is host work a
        # stall detector must not read as a wedge.
        heartbeat.phase_beat("PACK")
        ntaxa = group[0][1].patterns.shape[0]
        undet = group[0][1].datatype.undetermined_code
        lay = layouts[states]
        padded = [int(x) for x in lay.padded]
        total = lay.total

        tip_codes = np.full((ntaxa, total), undet, dtype=np.uint8)
        weights = np.zeros(total, dtype=np.float64)
        site_part = np.zeros(total, dtype=np.int32)
        offsets = np.zeros(len(group), dtype=np.int64)
        widths = np.zeros(len(group), dtype=np.int64)

        off = 0
        for li, ((gid, part), pw) in enumerate(zip(group, padded)):
            w = part.width
            tip_codes[:, off:off + w] = part.patterns
            weights[off:off + w] = part.weights
            site_part[off:off + pw] = li
            offsets[li] = off
            widths[li] = w
            off += pw
        # Trailing alignment blocks keep partition id of the last partition.
        site_part[off:] = len(group) - 1

        block_part = site_part.reshape(-1, lane)[:, 0].copy()
        buckets[states] = PackedBucket(
            states=states, lane=lane, tip_codes=tip_codes, weights=weights,
            site_part=site_part, block_part=block_part,
            part_ids=[gid for gid, _ in group],
            part_offsets=offsets, part_widths=widths)
    return buckets


def pack_partitions_local(partitions: Sequence[PartitionData],
                          procid: int, nprocs: int,
                          lane: int = TPU_LANE,
                          block_multiple: int = 1
                          ) -> Dict[int, PackedBucket]:
    """Pack SLICED partitions (from `read_bytefile_for_process`) into the
    LOCAL WINDOW of the global packed axis this process owns.

    Each partition's `global_width`/`global_col_offset` (set by the
    selective reader) recover the global layout, so the local arrays are
    positioned exactly where `pack_partitions` on the full alignment
    would put them — the per-rank half of the reference's
    `partitionAssignment` + `readMyData` pipeline.  `block_multiple`
    must match the global packing and be divisible by nprocs."""
    specs = []
    for gid, part in enumerate(partitions):
        gw = part.global_width if part.global_width is not None else part.width
        specs.append((gid, part.states, gw))
    layouts = pack_layout(specs, lane=lane, block_multiple=block_multiple)

    by_states: Dict[int, List[Tuple[int, PartitionData]]] = {}
    for gid, part in enumerate(partitions):
        by_states.setdefault(part.states, []).append((gid, part))

    buckets: Dict[int, PackedBucket] = {}
    for states, group in sorted(by_states.items()):
        heartbeat.phase_beat("PACK")
        lay = layouts[states]
        B = lay.num_blocks
        if B % nprocs:
            raise ValueError(
                f"{B} blocks do not divide over {nprocs} processes; "
                f"pack with block_multiple a multiple of nprocs")
        b0 = procid * B // nprocs
        b1 = (procid + 1) * B // nprocs
        s0, s1 = b0 * lane, b1 * lane
        total = s1 - s0
        ntaxa = group[0][1].patterns.shape[0]
        undet = group[0][1].datatype.undetermined_code

        tip_codes = np.full((ntaxa, total), undet, dtype=np.uint8)
        weights = np.zeros(total, dtype=np.float64)
        site_part = np.zeros(total, dtype=np.int32)

        for li, (gid, part) in enumerate(group):
            off_g = int(lay.offsets[li])
            w_g = int(lay.widths[li])
            pw_g = int(lay.padded[li])
            # padded-range intersection -> local partition id for blocks
            plo = max(s0, off_g)
            phi = min(s1, off_g + pw_g)
            if phi > plo:
                site_part[plo - s0:phi - s0] = li
            # true-column intersection -> this process's slice of the data
            lo = max(s0, off_g) - off_g
            hi = min(s1, off_g + w_g) - off_g
            if hi <= lo:
                if part.width:
                    raise ValueError(
                        f"partition {gid}: slice has {part.width} columns "
                        f"but process {procid} owns none — sliced read "
                        f"and packing disagree (block_multiple mismatch?)")
                continue
            if part.global_col_offset != lo or part.width != hi - lo:
                raise ValueError(
                    f"partition {gid}: slice [{part.global_col_offset},"
                    f"{part.global_col_offset + part.width}) does not "
                    f"match process window [{lo},{hi})")
            dest = off_g + lo - s0
            tip_codes[:, dest:dest + hi - lo] = part.patterns
            weights[dest:dest + hi - lo] = part.weights
        # Trailing alignment blocks keep the last partition's id, like
        # the global packer.
        last_cover = min(s1, int(lay.offsets[-1]) + int(lay.padded[-1]))
        if last_cover < s1:
            site_part[max(last_cover - s0, 0):] = len(group) - 1

        block_part = site_part.reshape(-1, lane)[:, 0].copy()
        buckets[states] = PackedBucket(
            states=states, lane=lane, tip_codes=tip_codes, weights=weights,
            site_part=site_part, block_part=block_part,
            part_ids=[gid for gid, _ in group],
            part_offsets=lay.offsets, part_widths=lay.widths,
            block_offset=b0, global_blocks=B)
    return buckets


def window_of(bucket: PackedBucket, procid: int, nprocs: int
              ) -> PackedBucket:
    """Block window `procid` of `nprocs` cut out of a GLOBAL bucket: the
    same local bucket `pack_partitions_local` packs from that process's
    sliced read (a multi-process run that read the whole file, e.g. for
    AUTO's global sample sizes, keeps only its window)."""
    if bucket.is_local:
        raise ValueError("window_of needs a global bucket")
    from examl_tpu_torch.parallel.sharding import block_window
    B = bucket.num_blocks
    b0, b1 = block_window(B, procid, nprocs)
    s0, s1 = b0 * bucket.lane, b1 * bucket.lane
    return PackedBucket(
        states=bucket.states, lane=bucket.lane,
        tip_codes=bucket.tip_codes[:, s0:s1].copy(),
        weights=bucket.weights[s0:s1].copy(),
        site_part=bucket.site_part[s0:s1].copy(),
        block_part=bucket.block_part[b0:b1].copy(),
        part_ids=list(bucket.part_ids),
        part_offsets=bucket.part_offsets, part_widths=bucket.part_widths,
        block_offset=b0, global_blocks=B)
