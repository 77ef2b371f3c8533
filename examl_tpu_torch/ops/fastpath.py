"""Fast full-traversal path: case-split wave chunks over a bounded layout.

The port of `examl_tpu/ops/fastpath.py`.  The host half — width
bucketing, chunk coalescing, scan-group segmentation, arena row
assignment (`_plan_layout`, `_finish_layout`, `_pack_structure`,
`refresh_z`) — is copied verbatim, so both packages produce the identical
chunk layout and the identical wave-ordered arena row map.

What the card executes is not that layout but its launch table
(`launch_table`): one row `(kind, base, slot, real)` per chunk that has
real entries, in execution order.  A real chunk's entries sit in packed
slots `slot .. slot+real-1` and write rows `base .. base+real-1`; its
width-padding slots, the scanned tail's pad chunks and the scan groups'
replay steps get no launch.  Skipping them changes no row of `row_of`:
in the padded layout every such row is last written by the chunk that
owns it, or by that chunk's replay step from unchanged inputs (so with
identical values); the other writes land in the slack region (pad
chunks write from row n) or on rows that their owner, or its replay,
writes afterwards, and nothing reads a row before its owner wrote it.
The ladder, the pads and the replays exist for XLA, where a few fixed
shapes keep the compile cache warm; a CUDA launch takes its width at run
time.  The engine runs a traversal as one batched operand build and one
call of kernel B1 over the launch table (`ops/newview_chunk.py`): on the
card its hand-written CUDA kernel, on the CPU its plain PyTorch version.
Within a chunk no entry reads a row the chunk writes (the layout's
promise, tested on the host for every slot, padding included), and every
inner child a chunk reads is written by an earlier chunk of the table or
not at all: so the card runs the table as one dataflow launch in which a
tile waits only for its children's tiles (`dataflow_table` gives the
wait bits), or as launches ordered on one stream.

Layout notes (from the JAX package): waves of independent entries are
split by tip case (kind 0 = tip-tip, 1 = tip-inner with the tip left,
2 = inner-inner); parents of one chunk occupy contiguous rows of a
wave-ordered arena; chunk widths quantize to a geometric ladder
(`MIN_WIDTH`..`CHUNK_CAP`); small same-kind chunks of adjacent waves
coalesce when no merged entry reads a row the merged chunk writes; and
runs of identical step shapes form scan groups padded by replaying their
idempotent final step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from examl_tpu_torch.ops import newview_chunk
from examl_tpu_torch.utils import bucket_len, next_pow2, z_slots

# -- bounded-layout constants ----------------------------------------------
# The ladder alphabet is {MIN_WIDTH, 2*MIN_WIDTH, ..., CHUNK_CAP}: small and
# fixed, so two topologies of similar shape produce the SAME profile.

MIN_WIDTH = 8        # width floor
CHUNK_CAP = 1024     # width cap; wider chunks split
TAIL_WIDTH = 64      # waves whose chunks all bucket <= this join the
                     # scanned tail
MIN_SCAN = 4         # shorter runs stay unrolled (replay padding would
                     # dominate them)


def slack_rows(ntips: int) -> int:
    """Arena slack rows the bounded layout needs: headroom for padded
    chunk writes past the real rows AND the dedicated pad region the
    scanned tail's width-MIN_WIDTH padding sub-chunks write (base = n).
    Every build still asserts max_write against the arena."""
    floor = 2 * MIN_WIDTH
    return min(max(64, floor), max(next_pow2(ntips), floor))


class FastChunk(NamedTuple):
    """One chunk of the bounded layout in execution order (host ints):
    `width` packed slots from `slot`, writing rows from `base`; kind 0 =
    tip-tip, 1 = tip-inner (tip left), 2 = inner-inner."""
    kind: int
    width: int
    base: int
    slot: int


class FastStructure(NamedTuple):
    """The immutable half of a fast-path schedule: a function of topology
    + traversal root only, cacheable across branch-length-only
    traversals.  The packed per-slot child/code arrays are device
    tensors; `base` and `launch` stay on the host (`launch`, what the card
    executes, is read by the kernel's host loop; see the module
    docstring).  The per-call half (packed zl/zr) is rebuilt by
    `refresh_z` through the stored entry->slot map."""
    profile: Tuple[tuple, ...]  # bucketed segment tuple
    base: np.ndarray            # [n_chunks] int32: first arena row written
    launch: np.ndarray          # [n_launches, 4] int32: kind, base, slot,
                                #     real width of each chunk with real
                                #     entries, in execution order
    lidx: torch.Tensor          # [P] int32 packed left-child arena rows
    ridx: torch.Tensor          # [P]
    lcode: torch.Tensor         # [P] packed 0-based tip indices
    rcode: torch.Tensor         # [P]
    flow_rows: torch.Tensor     # [n_launches + 1, 4] int32: dataflow_table
    wait: torch.Tensor          # [P] int32: dataflow_table's wait bits
    row_of: np.ndarray          # [2*ntips-1] node number -> row (-1 tips)
    z_src: np.ndarray           # [P] flat-entry index per slot (-1 pad;
                                #     replay slots repeat their source)
    z_swap: np.ndarray          # [P] slot's children were canonicalized
    num_rows: int
    max_write: int


# -- profile helpers ---------------------------------------------------------


def iter_profile_chunks(profile):
    """Yield (kind, width) for every chunk in execution order, scan
    groups expanded step-major (incl. replay steps)."""
    for seg in profile:
        if seg[0] == "u":
            yield seg[1], seg[2]
        else:
            _, glen, subs = seg
            for _ in range(glen):
                for k, w in subs:
                    yield k, w


def profile_stats(profile) -> Tuple[int, int, int]:
    """(unrolled_blocks, scan_groups, total_chunks) of a profile —
    unrolled_blocks + scan_groups is the program's operation count (the
    launch-latency floor per traversal); total_chunks counts every
    chunk incl. scan steps (the raw work-unit count)."""
    un = sum(1 for s in profile if s[0] == "u")
    sc = sum(1 for s in profile if s[0] == "s")
    total = sum(1 for _ in iter_profile_chunks(profile))
    return un, sc, total


def profile_slots(profile) -> int:
    """Total packed slot count P of a profile."""
    return sum(w for _, w in iter_profile_chunks(profile))


# -- layout planning ---------------------------------------------------------


class _Chunk:
    """Planner-internal chunk record (host only)."""

    __slots__ = ("kind", "W", "spans", "real", "pad", "replay_of",
                 "base", "slot")

    def __init__(self, kind, W, spans, pad=False, replay_of=None):
        self.kind = kind
        self.W = W
        self.spans = spans          # [(lo, hi)] into sorted-entry order
        self.real = sum(hi - lo for lo, hi in spans)
        self.pad = pad              # writes only slack rows
        self.replay_of = replay_of  # index into the final chunk list
        self.base = -1
        self.slot = -1


class _Layout(NamedTuple):
    profile: Tuple[tuple, ...]
    chunks: List[_Chunk]        # final execution order (incl. pads/replays)
    P: int                      # total packed slots
    max_write: int


def _bucket_w(s: int, mw: int) -> int:
    return max(mw, next_pow2(s))


def _plan_layout(kinds: np.ndarray, sizes: np.ndarray, gwave: np.ndarray,
                 starts: np.ndarray, child_key: np.ndarray,
                 n: int) -> _Layout:
    """Plan the chunk/segment layout from the (wave, kind)-sorted group
    table.  `child_key[g]` is the max (wave*3+kind) sort key over group
    g's inner children's defining entries (-1 when all children are
    tips/external) — the vectorized dependency oracle for coalescing."""
    G = len(kinds)
    mw, cap, tailw = MIN_WIDTH, CHUNK_CAP, TAIL_WIDTH

    # -- 1. coalescing: merge a small group into the newest earlier
    # same-kind group when every inner child of the candidate was
    # computed strictly before the target's position (original sort
    # keys upper-bound post-merge positions, so the check is
    # conservative-safe) and the merged chunk stays small.
    class _Rec:
        __slots__ = ("kind", "wave", "size", "spans", "key")

        def __init__(self, g):
            self.kind = int(kinds[g])
            self.wave = int(gwave[g])
            self.size = int(sizes[g])
            self.spans = [(int(starts[g]), int(starts[g] + sizes[g]))]
            self.key = self.wave * 3 + self.kind

    recs: List[_Rec] = []
    open_of: Dict[int, _Rec] = {}
    for g in range(G):
        k = int(kinds[g])
        t = open_of.get(k)
        if (t is not None and t.size + int(sizes[g]) <= tailw
                and int(child_key[g]) < t.key):
            t.size += int(sizes[g])
            t.spans.append((int(starts[g]), int(starts[g] + sizes[g])))
            continue
        r = _Rec(g)
        recs.append(r)
        open_of[k] = r

    # -- 2. per-wave emission: head waves cap-split into ladder pieces,
    # tail waves normalize to a per-wave signature with width-mw padding
    # sub-chunks for absent (previously seen) kinds.
    by_wave: Dict[int, List[_Rec]] = {}
    for r in recs:
        by_wave.setdefault(r.wave, []).append(r)

    def split_spans(spans, take):
        """Cut `take` entries off the front of a span list."""
        out, rest = [], []
        need = take
        for lo, hi in spans:
            if need <= 0:
                rest.append((lo, hi))
            elif hi - lo <= need:
                out.append((lo, hi))
                need -= hi - lo
            else:
                out.append((lo, lo + need))
                rest.append((lo + need, hi))
                need = 0
        return out, rest

    stream: List[tuple] = []    # ("h", [chunk]) | ("t", sig, [chunks])
    seen = set()
    for wave in sorted(by_wave):
        wrecs = sorted(by_wave[wave], key=lambda r: r.kind)
        tail = all(_bucket_w(r.size, mw) <= tailw for r in wrecs)
        if tail:
            step = []
            have = {r.kind: r for r in wrecs}
            for k in (0, 1, 2):
                r = have.get(k)
                if r is not None:
                    step.append(_Chunk(k, _bucket_w(r.size, mw), r.spans))
                elif k in (1, 2) and k in seen:
                    step.append(_Chunk(k, mw, [], pad=True))
            seen.update(have)
            sig = tuple((c.kind, c.W) for c in step)
            stream.append(("t", sig, step))
        else:
            out = []
            for r in wrecs:
                seen.add(r.kind)
                spans, size = r.spans, r.size
                while size > cap:
                    head, spans = split_spans(spans, cap)
                    out.append(_Chunk(r.kind, cap, head))
                    size -= cap
                out.append(_Chunk(r.kind, _bucket_w(size, mw), spans))
            stream.append(("h", out))

    # -- 3. segmentation: maximal runs of an identical step shape become
    # one scan group; scan lengths bucket geometrically with replay
    # padding (idempotent re-execution of the final step).
    profile: List[tuple] = []
    chunks: List[_Chunk] = []

    def emit_run(sig, steps):
        glen = len(steps)
        if glen < MIN_SCAN:
            for step in steps:
                for c in step:
                    if not c.pad:       # unrolled pads are pure waste
                        profile.append(("u", c.kind, c.W))
                        chunks.append(c)
            return
        blen = bucket_len(glen)
        profile.append(("s", blen, sig))
        for step in steps:
            chunks.extend(step)
        ns = len(sig)
        last = len(chunks) - ns
        for _ in range(blen - glen):
            for j in range(ns):
                src = last + j
                chunks.append(_Chunk(chunks[src].kind, chunks[src].W,
                                     chunks[src].spans,
                                     pad=chunks[src].pad,
                                     replay_of=src))

    run_sig: Optional[tuple] = None
    run_steps: List[List[_Chunk]] = []

    def flush():
        nonlocal run_sig, run_steps
        if run_steps:
            emit_run(run_sig, run_steps)
        run_sig, run_steps = None, []

    for item in stream:
        if item[0] == "h":
            for c in item[1]:
                sig = ((c.kind, c.W),)
                if sig != run_sig:
                    flush()
                    run_sig = sig
                run_steps.append([c])
        else:
            _, sig, step = item
            if sig != run_sig:
                flush()
                run_sig = sig
            run_steps.append(step)
    flush()

    return _finish_layout(tuple(profile), chunks, n)


def _finish_layout(profile, chunks, n: int) -> _Layout:
    """Assign arena rows (final emission order; pads write the slack
    region at row n, replays rewrite their source rows) and packed slot
    offsets; compute max_write for the engine's arena-capacity check."""
    row = 0
    slot = 0
    max_write = 0
    for c in chunks:
        c.slot = slot
        slot += c.W
        if c.replay_of is not None:
            c.base = chunks[c.replay_of].base
        elif c.pad:
            c.base = n
        else:
            c.base = row
            row += c.real
        max_write = max(max_write, c.base + c.W)
    assert row == n, (row, n)
    return _Layout(profile=profile, chunks=chunks, P=slot,
                   max_write=max_write)


def launch_table(layout: _Layout) -> np.ndarray:
    """The launch table of a layout: (kind, base, slot, real) of every
    chunk with real entries, in execution order; pad chunks and replay
    steps get no row (see the module docstring)."""
    rows = [(c.kind, c.base, c.slot, c.real) for c in layout.chunks
            if not c.pad and c.replay_of is None]
    return np.asarray(rows, np.int32).reshape(-1, 4)


def dataflow_table(launch: np.ndarray, lidx: np.ndarray,
                   ridx: np.ndarray):
    """What kernel B1's dataflow launch reads beside a launch table: `rows`
    [n + 1, 4] int32, each row (kind, base, slot, first) with `first` the
    row's first entry in table order (prefix sums of `real`, from which
    the kernel decodes its claims), and a last row (0, 0, 0, entries);
    `wait` [P] int32 per packed slot, bit 0 set when the slot's left child
    is an inner row that a row of the table writes (kind 2), bit 1 the
    same for its right child (kinds 1 and 2).  The table is checked first
    (newview_chunk.check_launch: no row written twice); a table row that
    reads a row the same or a later table row writes cannot be ordered by
    the dataflow and is refused.  One writer map (arena row -> table row)
    serves the refusal and the wait bits, per entry in numpy."""
    lidx, ridx = np.asarray(lidx, np.int64), np.asarray(ridx, np.int64)
    launch = newview_chunk.check_launch(launch, None, lidx.shape[0])
    n = launch.shape[0]
    kind, base, slot, real = launch.T.astype(np.int64)
    first = np.zeros(n + 1, np.int64)
    np.cumsum(real, out=first[1:])
    rows = np.zeros((n + 1, 4), np.int32)
    rows[:n, :3] = launch[:, :3]
    rows[:, 3] = first
    # Entry e in table order: its table row, the arena row it writes, its
    # packed slot.
    row_e = np.repeat(np.arange(n), real)
    off = np.arange(first[-1]) - np.repeat(first[:-1], real)
    slot_e = np.repeat(slot, real) + off
    target = np.repeat(base, real) + off
    writer = np.full(int(target.max()) + 1 if n else 0, n, np.int64)
    writer[target] = row_e
    kind_e = np.repeat(kind, real)
    bits = np.zeros(row_e.shape[0], np.int32)
    late = np.zeros(row_e.shape[0], bool)
    for bit, child, reads in ((1, lidx, kind_e == 2), (2, ridx, kind_e >= 1)):
        c = child[slot_e]
        inside = reads & (c >= 0) & (c < writer.shape[0])
        w = np.where(inside, writer[np.where(inside, c, 0)], n)
        late |= (w >= row_e) & (w < n)
        bits |= bit * (w < n).astype(np.int32)
    if late.any():
        i = int(row_e[late].min())
        raise ValueError(f"launch table row {i} {launch[i].tolist()} reads "
                         "a row that it or a later table row writes")
    wait = np.zeros(lidx.shape[0], np.int32)
    wait[slot_e] = bits
    return rows, wait


def dataflow(launch, lidx, ridx, device) -> newview_chunk.Dataflow:
    """The Dataflow of a launch table built outside the engine (whose
    structures carry theirs): dataflow_table over host child arrays (or
    tensors, copied to the host), placed on `device`, with ready flags of
    its own."""
    lidx = lidx.cpu().numpy() if torch.is_tensor(lidx) else lidx
    ridx = ridx.cpu().numpy() if torch.is_tensor(ridx) else ridx
    rows, wait = dataflow_table(launch, lidx, ridx)
    return newview_chunk.Dataflow(torch.from_numpy(rows).to(device),
                                  torch.from_numpy(wait).to(device),
                                  newview_chunk.Ready())


def _layout_from_arrays(wave_id, el, er, lt, rt, child_nodes_key, n):
    """Shared planner front-end: group the (wave, kind)-sorted entries
    and plan.  Returns (layout, order, skey-derived group table pieces)
    where `order` is the (wave, kind) stable sort permutation."""
    if n == 0:
        return (_Layout(profile=(), chunks=[], P=0, max_write=0),
                np.empty(0, np.int64))
    kind = 2 - (lt.astype(np.int64) + rt.astype(np.int64))
    skey_all = wave_id * 3 + kind
    order = np.argsort(skey_all, kind="stable")
    skey = skey_all[order]
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]])
    sizes = np.diff(np.r_[starts, n])
    kinds = (skey[starts] % 3).astype(np.int64)
    gwave = (skey[starts] // 3).astype(np.int64)
    # Dependency oracle: per sorted entry, the max sort key over its
    # inner children's defining entries (tips/external -> -1), reduced
    # per group.
    ck = np.maximum(child_nodes_key[el[order]],
                    child_nodes_key[er[order]])
    child_key = (np.maximum.reduceat(ck, starts) if n
                 else np.empty(0, np.int64))
    layout = _plan_layout(kinds, sizes, gwave, starts, child_key, n)
    return layout, order


def _pack_structure(layout: _Layout, order, el, er, lt, rt, swap, parent,
                    row_map_size: int):
    """Fill the packed per-slot arrays from a layout: a scatter per real
    chunk span (vectorized over entries), then slot-window copies for
    the replay chunks.  Returns host arrays."""
    n = order.shape[0]
    P = layout.P
    # Final entry order: concatenation of real-chunk spans (emission
    # order) — rows 0..n-1 in exactly this order.
    spans = [(lo, hi) for c in layout.chunks if c.replay_of is None
             for (lo, hi) in c.spans]
    if spans:
        pos = np.concatenate([np.arange(lo, hi) for lo, hi in spans])
    else:
        pos = np.empty(0, np.int64)
    assert pos.shape[0] == n
    final = order[pos]                  # indices into the ORIGINAL entries
    row_of = np.full(row_map_size, -1, dtype=np.int64)
    row_of[parent[final]] = np.arange(n)
    # Destination slot of each final-order entry.
    dst = np.empty(n, np.int64)
    off = 0
    for c in layout.chunks:
        if c.replay_of is not None:
            continue
        dst[off:off + c.real] = c.slot + np.arange(c.real)
        off += c.real
    el_f = el[final]
    er_f = er[final]
    lt_f = lt[final] | rt[final]        # post-swap: left is tip (kind 0/1)
    rt_f = lt[final] & rt[final]        # post-swap: right is tip (kind 0)
    # Every inner child must be defined by some entry in the traversal:
    # a -1 row would silently gather the scratch row (the loud
    # replacement for the old per-entry builder's KeyError on partial
    # entry lists, which the fast builders do not support).
    if (((~lt_f) & (row_of[el_f] < 0))
            | ((~rt_f) & (row_of[er_f] < 0))).any():
        raise KeyError("traversal entries reference inner children no "
                       "entry computes (partial entry lists are not "
                       "supported by the fast-path schedule builders)")
    lidx = np.zeros(P, np.int32)
    ridx = np.zeros(P, np.int32)
    lcode = np.zeros(P, np.int32)
    rcode = np.zeros(P, np.int32)
    z_src = np.full(P, -1, np.int64)
    z_swap = np.zeros(P, bool)
    lidx[dst] = np.where(lt_f, 0, row_of[el_f])
    ridx[dst] = np.where(rt_f, 0, row_of[er_f])
    lcode[dst] = np.where(lt_f, el_f - 1, 0)
    rcode[dst] = np.where(rt_f, er_f - 1, 0)
    z_src[dst] = final
    z_swap[dst] = swap[final]
    for c in layout.chunks:             # replay steps copy their source
        if c.replay_of is None:
            continue
        s = layout.chunks[c.replay_of].slot
        for arr in (lidx, ridx, lcode, rcode, z_src, z_swap):
            arr[c.slot:c.slot + c.W] = arr[s:s + c.W]
    base = np.asarray([c.base for c in layout.chunks], np.int32)
    return row_of, base, lidx, ridx, lcode, rcode, z_src, z_swap, dst


def structure_arrays(flat, ntips: int):
    """Host arrays of the bounded layout for a FlatTraversal: (layout,
    row_of, base, lidx, ridx, lcode, rcode, z_src, z_swap).  Vectorized
    numpy sort/scatter over the whole traversal."""
    n = flat.n
    left = flat.left
    right = flat.right
    wave_id = np.repeat(np.arange(flat.wave_sizes.shape[0], dtype=np.int64),
                        flat.wave_sizes)
    lt = left <= ntips
    rt = right <= ntips
    swap = (~lt) & rt                     # canonicalize: tip child left
    el = np.where(swap, right, left)
    er = np.where(swap, left, right)
    kind = 2 - ((left <= ntips).astype(np.int64)
                + (right <= ntips).astype(np.int64))
    node_key = np.full(2 * ntips - 1, -1, dtype=np.int64)
    node_key[flat.parent] = wave_id * 3 + kind
    layout, order = _layout_from_arrays(
        wave_id, el, er, lt, rt, node_key, n)
    (row_of, base, lidx, ridx, lcode, rcode, z_src, z_swap,
     _dst) = _pack_structure(layout, order, el, er, lt, rt, swap,
                             flat.parent, 2 * ntips - 1)
    return layout, row_of, base, lidx, ridx, lcode, rcode, z_src, z_swap


def build_structure(flat, ntips: int, device) -> FastStructure:
    """The bounded chunk layout of a FlatTraversal, with the packed
    child/code arrays placed on `device` in one transfer."""
    (layout, row_of, base, lidx, ridx, lcode, rcode, z_src,
     z_swap) = structure_arrays(flat, ntips)
    launch = launch_table(layout)
    flow_rows, wait = dataflow_table(launch, lidx, ridx)
    packed = torch.from_numpy(np.stack([lidx, ridx, lcode, rcode,
                                        wait])).to(device)
    return FastStructure(profile=layout.profile, base=base, launch=launch,
                         lidx=packed[0], ridx=packed[1], lcode=packed[2],
                         rcode=packed[3],
                         flow_rows=torch.from_numpy(flow_rows).to(device),
                         wait=packed[4], row_of=row_of, z_src=z_src,
                         z_swap=z_swap, num_rows=flat.n,
                         max_write=layout.max_write)


def refresh_z(st: FastStructure, flat, num_slots: int, dtype, device):
    """The dynamic half of a cached schedule: the traversal's branch
    vectors permuted into packed chunk-slot order (canonical swap
    applied; padding slots at z=1, replay slots repeating their source
    entry's z).  Returns (zl, zr) [P, num_slots] tensors on `device`."""
    zl, zr = refresh_z_host(st, flat, num_slots)
    z = torch.from_numpy(np.stack([zl, zr])).to(device=device, dtype=dtype)
    return z[0], z[1]


def refresh_z_host(st, flat, num_slots: int):
    """refresh_z's (zl, zr) as float64 host arrays, for a FastStructure or
    a JobTable."""
    zl_f = flat.zl
    zr_f = flat.zr
    if zl_f.shape[1] != num_slots:
        zl_f = np.stack([z_slots(z, num_slots) for z in zl_f])
        zr_f = np.stack([z_slots(z, num_slots) for z in zr_f])
    P = st.z_src.shape[0]
    ok = st.z_src >= 0
    src = st.z_src[ok]
    sw = st.z_swap[ok, None]
    zl = np.ones((P, num_slots))
    zr = np.ones((P, num_slots))
    zl[ok] = np.where(sw, zr_f[src], zl_f[src])
    zr[ok] = np.where(sw, zl_f[src], zr_f[src])
    return zl, zr


# -- many jobs' tables over one stacked arena (the fleet, fleet/batch.py) ----


class JobTable(NamedTuple):
    """One job's launch table and packed child arrays on the host, before
    any upload (build_structure's arrays): the unit `stack_tables`
    stacks.  `refresh_z_host` reads its z_src / z_swap."""
    launch: np.ndarray          # [n, 4] int32 (kind, base, slot, real)
    lidx: np.ndarray            # [P] int32 packed left-child arena rows
    ridx: np.ndarray
    lcode: np.ndarray           # [P] int32 packed 0-based tip indices
    rcode: np.ndarray
    row_of: np.ndarray          # [2*ntips-1] node number -> row (-1 tips)
    z_src: np.ndarray
    z_swap: np.ndarray
    max_write: int


def job_table(flat, ntips: int) -> JobTable:
    """The bounded layout's launch table of a FlatTraversal, on the host."""
    (layout, row_of, _base, lidx, ridx, lcode, rcode, z_src,
     z_swap) = structure_arrays(flat, ntips)
    return JobTable(launch_table(layout), lidx, ridx, lcode, rcode, row_of,
                    z_src, z_swap, layout.max_write)


class StackedTable(NamedTuple):
    """J jobs' launch tables as one table over a stacked arena of
    `rows_per_job` rows a job (job j's rows from j * rows_per_job) and
    their packed slots end to end (job j's from `slot0[j]`): the launch
    table on the host, the packed child arrays and the dataflow table on
    the device."""
    launch: np.ndarray          # [n, 4] int32
    lidx: torch.Tensor          # [P] int32, stacked arena rows
    ridx: torch.Tensor
    lcode: torch.Tensor
    rcode: torch.Tensor
    flow_rows: torch.Tensor     # [n + 1, 4] int32 (dataflow_table)
    wait: torch.Tensor          # [P] int32
    slot0: np.ndarray           # [J + 1] first packed slot of each job


def upload(array, device, dtype=None) -> torch.Tensor:
    """A host array on `device` (then in `dtype`) without a host sync: on
    a card through pinned memory and an asynchronous copy on the current
    stream (a copy from pageable memory waits for everything queued on
    the stream), so a fleet lane enqueues a whole batch before any of it
    runs.  The caching host allocator keeps the pinned buffer until the
    copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def stack_tables(tables, rows_per_job: int, device) -> StackedTable:
    """One launch table for J jobs' tables over a stacked arena: job j's
    rows keep their order, `base` moves by j * rows_per_job and `slot` by
    the earlier jobs' slot counts; a packed child index moves by j *
    rows_per_job only where it names an inner child (the left child of
    kind 2, the right child of kinds 1 and 2: the rows dataflow_table's
    wait bits read), tip codes index the one shared tip array.  The
    dataflow table is built once over the stacked arrays, so its claim
    order, its prefix sums and its checks (no row written twice, no row
    read before an earlier table row wrote it) hold for the whole
    batch.  The packed arrays go to the device in one transfer, with no
    host sync (`upload`)."""
    launches, packed = [], []
    slot0 = [0]
    for j, t in enumerate(tables):
        if t.max_write > rows_per_job - 1:
            raise ValueError(f"job {j}'s chunk layout writes row "
                             f"{t.max_write} of a {rows_per_job}-row arena")
        off = j * rows_per_job
        P = t.lidx.shape[0]
        kind, base, slot, real = t.launch.T.astype(np.int64)
        slot_kind = np.full(P, -1, np.int64)
        slot_kind[np.repeat(slot, real) + np.arange(real.sum())
                  - np.repeat(np.cumsum(real) - real, real)] = \
            np.repeat(kind, real)
        launches.append(np.stack([kind, base + off, slot + slot0[-1], real],
                                 axis=1))
        packed.append(np.stack([
            t.lidx + np.where(slot_kind == 2, off, 0),
            t.ridx + np.where(slot_kind >= 1, off, 0), t.lcode, t.rcode]))
        slot0.append(slot0[-1] + P)
    launch = np.concatenate(launches).astype(np.int32).reshape(-1, 4)
    lidx, ridx, lcode, rcode = np.concatenate(packed, axis=1)
    flow_rows, wait = dataflow_table(launch, lidx, ridx)
    dev = upload(np.stack([lidx, ridx, lcode, rcode, wait]).astype(
        np.int32), device)
    return StackedTable(launch=launch, lidx=dev[0], ridx=dev[1],
                        lcode=dev[2], rcode=dev[3],
                        flow_rows=upload(flow_rows, device),
                        wait=dev[4], slot0=np.asarray(slot0, np.int64))


# -- harness view ------------------------------------------------------------


def iter_chunks(profile, base):
    """Every chunk of the bounded layout as a FastChunk, in the order the
    JAX package's segment program runs them: unrolled segments, then scan
    groups step-major with their replay steps, pads included."""
    off = 0
    for cidx, (kind, W) in enumerate(iter_profile_chunks(profile)):
        yield FastChunk(kind, W, int(base[cidx]), off)
        off += W
