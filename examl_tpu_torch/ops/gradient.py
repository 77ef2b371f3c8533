"""One-pass analytic branch gradients: all 2n-3 edge derivatives of a
tree from one post-order and one pre-order pass.

ExaML's `smoothTree`/`treeEvaluate` (reference `searchAlgo.c:127-436`)
run one Newton solve per branch: O(n) sequential sumtable + derivative
round trips per smoothing sweep.  Ji et al. (arXiv:2303.04390) show that
every branch gradient follows from one post-order plus one pre-order
linear pass (BEAGLE 4.1 ships the same edge-derivative machinery).  The
port of `examl_tpu/ops/gradient.py`:

* The POST-ORDER partials are the engine's ordinary full traversal: the
  CLV arena after `run_traversal(flat, full=True)`, on any tier.
* The PRE-ORDER ("outroot") pass is the same wave schedule walked in
  reverse wave order (`GradStructure` packs `FlatTraversal`'s waves
  backwards into the wave-scan tier's [L, W] shape): each post-order entry
  (v <- l, r) emits the root-directed complements of its two children,
  out(l) = (P(z_up(v)) out(v)) * (P(zr) D(r)) and symmetrically for r
  (`kernels.outroot_wave`), into a second arena indexed by node number.
  The recursion starts at the traversal's root edge (p, q): out(p) = D(q)
  and out(q) = D(p), copied from the CLV arena.
* The EDGE-DERIVATIVE contraction then runs for every edge: for edge
  (v, c) with branch z, `kernels.sumtable(out(c), D(c))` followed by
  `kernels.nr_derivatives(st, z)` gives (dlnL/dlz, d2lnL/dlz2), the
  arithmetic of the per-branch Newton path, batched over edges in chunks
  of GRAD_CHUNK so that the transient is one chunk of sumtables.

Per-site CLV rescaling cancels in every dsite/lsite ratio the derivatives
are built from, so the outroot pass rescales values but keeps no counts.

The JAX package pads the step count (`bucket_len`) and the edge chunks
(to a power of two) to keep its family of compiled programs small; the
port walks only the real steps and edges.  The edge order and every
value are the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from examl_tpu_torch.constants import ZMAX, ZMIN
from examl_tpu_torch.ops import kernels
from examl_tpu_torch.utils import next_pow2, z_slots

# Edges per edge-derivative chunk: one chunk of sumtables
# [GRAD_CHUNK, B, lane, R, K] is the pass's largest transient beyond the
# outroot arena.
GRAD_CHUNK = 32


class GradStructure:
    """The topology + root half of a gradient plan (cacheable per
    `FlatTraversal.topo_key`, like the engine's layout cache): the
    reversed wave packing, the per-entry upper-branch source map, and the
    edge table.  Branch lengths and CLV gather indices are refreshed per
    pass by `grad_arrays` (z moves every sweep; the row map follows the
    engine's tier)."""

    __slots__ = ("n", "ntips", "n_edges", "n_steps", "wave_w", "scratch",
                 "roots", "pk", "pk_pad", "up_row", "lrow", "rrow",
                 "zu_src", "zu_side", "edge_node", "edge_x_row",
                 "edge_z_src", "edge_z_side")

    def __init__(self, flat, wave_cap: int):
        n = flat.n
        ntips = flat.ntips
        parent = np.asarray(flat.parent, dtype=np.int64)
        left = np.asarray(flat.left, dtype=np.int64)
        right = np.asarray(flat.right, dtype=np.int64)
        self.n = n
        self.ntips = ntips
        self.scratch = 2 * ntips - 2          # outroot arena scratch row
        # Root-edge endpoints: the two nodes no entry computes as a child
        # (the traversal is rooted at the edge between them).
        mask = np.ones(2 * ntips - 1, dtype=bool)
        mask[0] = False
        mask[left] = False
        mask[right] = False
        roots = np.flatnonzero(mask)
        assert roots.shape[0] == 2, roots
        self.roots = (int(roots[0]), int(roots[1]))
        # Branch above each entry's parent node: the (entry, side) whose
        # zl/zr defines it; root-adjacent entries (-1) read the root z.
        src_e = np.full(2 * ntips - 1, -1, dtype=np.int64)
        src_s = np.zeros(2 * ntips - 1, dtype=np.int64)
        src_e[left] = np.arange(n)
        src_s[left] = 0
        src_e[right] = np.arange(n)
        src_s[right] = 1
        self.zu_src = src_e[parent]
        self.zu_side = src_s[parent]
        # Reverse wave packing into [L, W]: post-order waves walked
        # backwards, each split into <= W-wide steps (entries of one wave
        # are independent in the pre-order direction too: a same-wave
        # entry can never have written the outroot row another reads).
        sizes = np.asarray(flat.wave_sizes, dtype=np.int64)
        W = min(next_pow2(int(sizes.max())), wave_cap) if n else 1
        offs = np.concatenate([[0], np.cumsum(sizes)])
        steps = []
        for w in range(len(sizes) - 1, -1, -1):
            lo, hi = int(offs[w]), int(offs[w + 1])
            for s in range(lo, hi, W):
                steps.append(np.arange(s, min(s + W, hi), dtype=np.int64))
        L = max(len(steps), 1)
        pk = np.full((L, W), -1, dtype=np.int64)
        for i, st in enumerate(steps):
            pk[i, :st.shape[0]] = st
        self.pk = pk
        self.pk_pad = pk < 0
        self.n_steps = L
        self.wave_w = W
        pke = np.where(self.pk_pad, 0, pk)
        self.up_row = np.where(self.pk_pad, self.scratch, parent[pke] - 1)
        self.lrow = np.where(self.pk_pad, self.scratch, left[pke] - 1)
        self.rrow = np.where(self.pk_pad, self.scratch, right[pke] - 1)
        # Edge table: edge 0 is the root edge (its complement partial is
        # the initialized out[p-1] = D(q)); edges 1+2i / 2+2i are entry
        # i's left / right child edges.  E = 2n+1 = 2*ntips-3.
        E = 2 * n + 1
        self.n_edges = E
        edge_node = np.empty(E, dtype=np.int64)
        edge_node[0] = self.roots[0]
        edge_node[1::2] = left
        edge_node[2::2] = right
        self.edge_node = edge_node
        self.edge_x_row = edge_node - 1
        ez_src = np.empty(E, dtype=np.int64)
        ez_src[0] = -1
        ez_src[1::2] = np.arange(n)
        ez_src[2::2] = np.arange(n)
        ez_side = np.zeros(E, dtype=np.int64)
        ez_side[2::2] = 1
        self.edge_z_src = ez_src
        self.edge_z_side = ez_side


def build_structure(flat, wave_cap: int) -> GradStructure:
    return GradStructure(flat, wave_cap)


def _entry_z(flat, num_slots: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-entry branch vectors widened to the engine's slot count (the
    normalization of fastpath.refresh_z)."""
    zl, zr = flat.zl, flat.zr
    if zl.shape[1] != num_slots:
        zl = np.stack([z_slots(z, num_slots) for z in zl])
        zr = np.stack([z_slots(z, num_slots) for z in zr])
    return zl, zr


def grad_arrays(gs: GradStructure, flat, row_map: np.ndarray,
                num_slots: int, root_z):
    """The per-pass half: CLV gather indices resolved through the
    engine's CURRENT row map and branch vectors re-read from the (freshly
    smoothed) traversal.  Pure numpy indexing.

    Returns (pre, ex_rows, ey_gidx, ez): `pre` the OutrootTraversal
    fields as numpy arrays (up_row, lrow, rrow, left, right, zu, zl, zr),
    then per edge the outroot row [E], the gather index of the edge's
    lower node [E] and the branch vector [E, C]."""
    ntips = gs.ntips
    zl, zr = _entry_z(flat, num_slots)
    rz = np.asarray(z_slots(root_z, num_slots), dtype=np.float64)
    src = np.where(gs.zu_src < 0, 0, gs.zu_src)
    zu = np.where((gs.zu_side == 0)[:, None], zl[src], zr[src])
    zu = np.where((gs.zu_src < 0)[:, None], rz[None, :], zu)  # root edge

    def gidx(nodes):
        r = row_map[nodes]
        return np.where(nodes <= ntips, nodes - 1, ntips + r)

    pke = np.where(gs.pk_pad, 0, gs.pk)
    lnode = np.asarray(flat.left, dtype=np.int64)[pke]
    rnode = np.asarray(flat.right, dtype=np.int64)[pke]
    lg = np.where(gs.pk_pad, 0, gidx(lnode))
    rg = np.where(gs.pk_pad, 0, gidx(rnode))

    def pkz(zarr):
        out = np.ones(gs.pk.shape + (num_slots,), dtype=np.float64)
        out[~gs.pk_pad] = zarr[gs.pk[~gs.pk_pad]]
        return out

    pre = (gs.up_row, gs.lrow, gs.rrow, lg, rg, pkz(zu), pkz(zl), pkz(zr))
    ey = gidx(gs.edge_node)
    ezs = np.where(gs.edge_z_src < 0, 0, gs.edge_z_src)
    ez = np.where((gs.edge_z_side == 0)[:, None], zl[ezs], zr[ezs])
    ez = np.where((gs.edge_z_src < 0)[:, None], rz[None, :], ez)
    return pre, gs.edge_x_row, ey, ez


def edge_gradients(models, block_part, weights, tips, clv, scaler, out,
                   ex_rows, ey_gidx, ez, num_slots: int, ntips: int,
                   site_rates=None):
    """(d1, d2) [E, C] (float64, on the device) for every edge: a loop
    over chunks of GRAD_CHUNK edges, each one batched sumtable + derivative
    contraction (the per-branch Newton path's `sumtable` /
    `nr_derivatives` arithmetic)."""
    d1s, d2s = [], []
    for s in range(0, ex_rows.shape[0], GRAD_CHUNK):
        x = out[ex_rows[s:s + GRAD_CHUNK]]           # [T, B, lane, R, K]
        y, _ = kernels.gather_child(tips, clv, scaler,
                                    ey_gidx[s:s + GRAD_CHUNK], ntips)
        st = kernels.sumtable(models, block_part, x, y)
        d1, d2 = kernels.nr_derivatives(models, block_part, weights, st,
                                        ez[s:s + GRAD_CHUNK], num_slots,
                                        site_rates)
        d1s.append(d1)
        d2s.append(d2)
    return torch.cat(d1s), torch.cat(d2s)


def newton_step(z: np.ndarray, d1: np.ndarray, d2: np.ndarray
                ) -> np.ndarray:
    """One batched full-Newton update over all branches [E, C]: the
    single-iteration body of the reference NR loop
    (`makenewzGenericSpecial.c:1133-1349`) vectorized over edges — the
    bad-curvature shortening move (z <- 0.37 z + 0.63), the 0.25 z + 0.75
    step cap, the exp(min(-d1/d2, 100)) multiplicative step.  Where the
    curvature is unusable (d2 >= 0) the shortening move is the
    safeguarded direction the reference takes.  Damping is the callers'
    job (optimize/branch.py's per-branch step scale)."""
    z = np.clip(z, ZMIN, ZMAX)
    bad = (d2 >= 0.0) & (z < ZMAX)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        tantmp = np.where(d2 < 0.0, -d1 / np.where(d2 < 0.0, d2, 1.0),
                          np.inf)
        cap = 0.25 * z + 0.75
        znr = np.where(tantmp < 100.0,
                       np.maximum(z * np.exp(np.minimum(tantmp, 100.0)),
                                  ZMIN),
                       cap)
    znr = np.minimum(np.minimum(znr, cap), ZMAX)
    return np.where(bad, 0.37 * z + 0.63, znr)
