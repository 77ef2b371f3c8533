"""Plain PyTorch kernels of the likelihood engine (GAMMA and PSR models).

The torch counterpart of `examl_tpu/ops/kernels.py`: one kernel set over a
packed site axis laid out as [B blocks x lane], with per-partition P
matrices gathered per block.  The arithmetic, index conventions and
rescaling scheme are those of the JAX package, so a test can compare
arena rows and scalers directly:

  b block, l lane, r rate category, j eigen index, a/k state, m partition,
  w traversal entry, c branch slot (per-partition branch lengths).

CLV scaling follows the reference (`newviewGenericSpecial.c:604-616`):
when every entry of a site's CLV drops below 2^-E the site is multiplied
by 2^E and an integer per-(node, site) scaler increments; lnL adds
scaler * log(2^-E).  E is 256 for float64 and 32 for float32
(`config.scale_exponent`).

Under the PSR (CAT) model every site carries its own rate multiplier
(`site_rates` [B, lane, R], R = 1 except inside the rate-grid scan), so
the transition matrix differs per site and is applied in factorized form
(`psr_decay`, `apply_p_factorized`) instead of being built.  Every kernel
that takes `site_rates=None` runs the GAMMA form.

Root likelihoods and branch derivatives are summed over sites in float64
whatever the compute dtype, as the JAX package does whenever x64 is live.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from examl_tpu_torch.constants import ZMAX, ZMIN

ACC = torch.float64      # accumulator dtype of the site sums


class DeviceModels(NamedTuple):
    """Stacked per-partition model tensors for one state-count bucket
    (rate-category axis kept so every partition shares one kernel set)."""
    eign: torch.Tensor         # [M, R, K] negated eigenvalues, [..., 0] == 0
    ev: torch.Tensor           # [M, R, K, K] right eigenvectors (columns)
    ei: torch.Tensor           # [M, R, K, K] left eigenvectors (rows)
    freqs: torch.Tensor        # [M, R, K]
    gamma_rates: torch.Tensor  # [M, R]
    rate_weights: torch.Tensor  # [M, R] category weights (1/R for GAMMA)
    part_branch: torch.Tensor  # [M] int64 branch slot per partition


class Traversal(NamedTuple):
    """Wave-scheduled traversal descriptor [L, W] (host-built).

    `parent` indexes arena rows; `left`/`right` are gather indices (tips
    by code slot, inner nodes by ntips + arena row, see `gather_child`).
    Padding entries point children at index 0 and the parent at the
    scratch row."""
    parent: torch.Tensor       # [L, W] int64
    left: torch.Tensor         # [L, W] int64
    right: torch.Tensor        # [L, W] int64
    zl: torch.Tensor           # [L, W, C]
    zr: torch.Tensor           # [L, W, C]


class TipState(NamedTuple):
    """Tip data: packed codes + indicator lookup table (what kernels B1 and
    B2 read), and the codes' indicator vectors, table[codes], which the
    torch ops gather by tip row as they gather arena rows: a per-site
    lookup of 16-byte table rows is far slower on the card (PERF.md §6).
    The vectors take K values per tip and site, a quarter of an inner
    node's CLV row under GAMMA."""
    codes: torch.Tensor        # [ntips, B, lane] uint8 state codes
    table: torch.Tensor        # [num_codes, K] 0/1 indicator vectors
    vectors: torch.Tensor      # [ntips, B, lane, K] table[codes]


def tip_state(codes: torch.Tensor, table: torch.Tensor) -> TipState:
    return TipState(codes=codes, table=table, vectors=table[codes.long()])


def scale_constants(scale_exp: int):
    """(minlik, two_e, log_min) for exponent E: 2^-E, 2^E, -E log 2."""
    e = scale_exp
    return 2.0 ** (-e), 2.0 ** e, -e * math.log(2.0)


class DenseArena(NamedTuple):
    """Inner CLVs in a dense arena [rows, B, lane, R, K]: row r is clv[r]."""
    clv: torch.Tensor

    @property
    def rows(self) -> int:
        return self.clv.shape[0]

    @property
    def ncat(self) -> int:
        return self.clv.shape[3]

    def read(self, rows: torch.Tensor) -> torch.Tensor:
        return self.clv[rows]

    def write(self, rows: torch.Tensor, v: torch.Tensor) -> None:
        self.clv[rows] = v.to(self.clv.dtype)


class CellPool(NamedTuple):
    """Inner CLVs in an SEV block-cell pool (`-S`, ops/sev.py): row r's
    block b lives in cell slot_read[r, b] of pool [S, lane, R, K] when
    read, slot_write[r, b] when written.  All-gap (row, block) cells read
    the shared constant all-ones cell 0 — the form of the reference's one
    shared `gapColumn` CLV per node (`newviewGenericSpecial.c:139-160`) —
    and write the scratch cell 1, whose content is never read."""
    pool: torch.Tensor          # [S, lane, R, K]
    slot_read: torch.Tensor     # [rows, B] int64
    slot_write: torch.Tensor    # [rows, B] int64

    @property
    def rows(self) -> int:
        return self.slot_read.shape[0]

    @property
    def ncat(self) -> int:
        return self.pool.shape[2]

    def read(self, rows: torch.Tensor) -> torch.Tensor:
        return self.pool[self.slot_read[rows]]

    def write(self, rows: torch.Tensor, v: torch.Tensor) -> None:
        self.pool[self.slot_write[rows]] = v.to(self.pool.dtype)


def _child_index(idx: torch.Tensor, ntips: int, rows: int):
    """(is_tip, tip index, inner arena row) of gather indices idx [...]."""
    return (idx < ntips, idx.clamp(0, ntips - 1),
            (idx - ntips).clamp(0, rows - 1))


def _gather(tips: TipState, store, is_tip: torch.Tensor,
            tip_idx: torch.Tensor, inner_idx: torch.Tensor) -> torch.Tensor:
    """Child CLVs [..., B, lane, R, K]: tips expanded from their codes
    through the indicator table, inner nodes read from the store (a
    DenseArena or a CellPool)."""
    R = store.ncat
    tip_clv = tips.vectors[tip_idx]                      # [..., B, lane, K]
    tip_clv = tip_clv.unsqueeze(-2).expand(
        tip_clv.shape[:-1] + (R, tip_clv.shape[-1]))
    inner_clv = store.read(inner_idx).to(tips.table.dtype)
    return torch.where(is_tip[..., None, None, None, None], tip_clv,
                       inner_clv)


def gather_from(tips: TipState, store, scaler: torch.Tensor,
                idx: torch.Tensor, ntips: int):
    """CLV + scaler of child nodes given gather indices idx [...].

    Tips (idx < ntips) materialize their indicator vectors from the code
    table (scaler 0); inner nodes read row idx - ntips of the store."""
    idx = torch.as_tensor(idx, dtype=torch.int64, device=scaler.device)
    is_tip, tip_idx, inner_idx = _child_index(idx, ntips, store.rows)
    x = _gather(tips, store, is_tip, tip_idx, inner_idx)
    sc = scaler[inner_idx].masked_fill(is_tip[..., None, None], 0)
    return x, sc


def gather_child(tips: TipState, clv: torch.Tensor, scaler: torch.Tensor,
                 idx: torch.Tensor, ntips: int):
    """`gather_from` a dense arena clv [rows, B, lane, R, K]."""
    return gather_from(tips, DenseArena(clv), scaler, idx, ntips)


def gather_child_pooled(tips: TipState, pool: torch.Tensor,
                        slot_read: torch.Tensor, scaler: torch.Tensor,
                        idx: torch.Tensor, ntips: int):
    """`gather_from` an SEV pool [S, lane, R, K] through its read slot map
    [rows, B] (all-gap cells read the constant all-ones cell)."""
    return gather_from(tips, CellPool(pool, slot_read, slot_read), scaler,
                       idx, ntips)


def branch_decay(models: DeviceModels, z: torch.Tensor) -> torch.Tensor:
    """d[..., m, r, j] = exp(eign_rj * rate_r * log z_m), the eigenvalue
    decay (z: [..., C] per-branch-slot values; each partition selects its
    slot)."""
    lz = torch.log(z[..., models.part_branch])                # [..., M]
    return torch.exp(models.eign * models.gamma_rates[:, :, None]
                     * lz[..., :, None, None])                # [..., M, R, K]


def p_matrices(models: DeviceModels, z: torch.Tensor) -> torch.Tensor:
    """P[m, r, a, k] = sum_j ev[r,a,j] d[r,j] ei[r,j,k] per partition."""
    d = branch_decay(models, z)
    return torch.einsum("mraj,mrjk->mrak", models.ev * d[:, :, None, :],
                        models.ei)


def p_matrices_wave(models: DeviceModels, z: torch.Tensor) -> torch.Tensor:
    """P[w, m, r, a, k] for one wave of branch vectors z [W, C]."""
    lz = torch.log(z[:, models.part_branch])                  # [W, M]
    d = torch.exp(models.eign[None] * models.gamma_rates[None, :, :, None]
                  * lz[:, :, None, None])                     # [W, M, R, K]
    # A broadcast matmul: one 4x4 product per (w, m, r), so a slot's P does
    # not depend on how many slots are built with it.
    return torch.matmul(models.ev[None] * d[:, :, :, None, :], models.ei)


def apply_p(pmat: torch.Tensor, block_part: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """y[b,l,r,a] = sum_k P[part(b),r,a,k] * x[b,l,r,k]."""
    return torch.einsum("brak,blrk->blra", pmat[block_part], x)


def psr_decay(models: DeviceModels, block_part: torch.Tensor,
              site_rates: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-site eigenvalue decay d[..., b, l, r, j] = exp(eign_j *
    rate_blr * log z): the PSR analogue of `branch_decay` (reference
    per-site `patrat`/`rateCategory`, `optimizeModel.c:1792-2507`).
    site_rates [B, lane, R] (R = 1 in normal PSR compute, R = G in the
    rate-grid scan); z [..., C].  PSR models are single-category: the
    category-0 eigensystem serves every site."""
    zb = z[..., models.part_branch][..., block_part]          # [..., B]
    lz = torch.log(zb)
    eb = models.eign[block_part][:, 0, :]                     # [B, K]
    return torch.exp(eb[:, None, None, :] * site_rates[:, :, :, None]
                     * lz[..., :, None, None, None])          # [..., B,l,R,K]


def apply_p_factorized(models: DeviceModels, block_part: torch.Tensor,
                       d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = EV . (d * (EI . x)) with the per-site decay d [..., B, lane, R,
    K]: P(z, r_site) applied without building per-site matrices."""
    eib = models.ei[block_part][:, 0]                         # [B, K, K]
    evb = models.ev[block_part][:, 0]
    u = torch.einsum("bjk,...blrk->...blrj", eib, x)
    u = u * d
    return torch.einsum("baj,...blrj->...blra", evb, u)


def rescale(v: torch.Tensor, scale_exp: int, state_dims=(-2, -1)):
    """Multiply sites whose max |v| falls below 2^-E by 2^E; returns
    (v, increment) with the increment an int32 0/1 per site."""
    minlik, two_e, _ = scale_constants(scale_exp)
    needs = v.abs().amax(dim=state_dims) < minlik
    shape = needs.shape + (1,) * len(state_dims)
    v = torch.where(needs.reshape(shape), v * two_e, v)
    return v, needs.to(torch.int32)


class Transport:
    """P(z) applied to the entries of every step of a traversal, with the
    operands that do not change between steps built once.

    z [L, N, C]: L steps of N entries; `transport(step, x)` applies
    P(z[step, n]) to x[n] for x [N, B, lane, R, K].  Under GAMMA the P
    matrices of every step are built at once (one broadcast matmul per
    slot, as `p_matrices_wave`); under PSR (site_rates given) the
    per-block eigensystem, eign x rate per site and log z of every step
    are taken once, and a step costs the decay and the two factorized
    contractions of `psr_decay` / `apply_p_factorized`, in their order of
    operations."""

    def __init__(self, models: DeviceModels, block_part: torch.Tensor,
                 z: torch.Tensor, site_rates=None):
        self.block_part = block_part
        self.psr = site_rates is not None
        if not self.psr:
            L, N, C = z.shape
            p = p_matrices_wave(models, z.reshape(L * N, C))
            self.p = p.reshape((L, N) + p.shape[1:])      # [L,N,M,R,K,K]
            return
        eb = models.eign[block_part][:, 0, :]             # [B, K]
        self.rate_eign = eb[:, None, None, :] * site_rates[:, :, :, None]
        self.lz = torch.log(z[..., models.part_branch][..., block_part])
        self.ei = models.ei[block_part][:, 0]             # [B, K, K]
        self.ev = models.ev[block_part][:, 0]

    def __call__(self, step: int, x: torch.Tensor) -> torch.Tensor:
        if not self.psr:
            return torch.einsum("wbrak,wblrk->wblra",
                                self.p[step][:, self.block_part], x)
        d = torch.exp(self.rate_eign
                      * self.lz[step][:, :, None, None, None])  # [N,B,l,R,K]
        u = torch.einsum("bjk,...blrk->...blrj", self.ei, x) * d
        return torch.einsum("baj,...blrj->...blra", self.ev, u)


def _combine(y: torch.Tensor, scale_exp: int):
    """Parent CLVs from the transported children y = [left; right]."""
    W = y.shape[0] // 2
    return rescale(y[:W] * y[W:], scale_exp)


def newview_wave(models: DeviceModels, block_part: torch.Tensor,
                 xl: torch.Tensor, xr: torch.Tensor,
                 zl: torch.Tensor, zr: torch.Tensor, scale_exp: int,
                 site_rates=None):
    """Combine child CLVs into parent CLVs for one wave of W entries.

    xl, xr: [W, B, lane, R, K]; zl, zr: [W, C].  Returns (clv [W,B,lane,
    R,K], scale_inc [W,B,lane]).  Reference `newviewGAMMA_FLEX`
    (`newviewGenericSpecial.c:430-682`), or the CAT kernels when
    site_rates is given, batched over independent entries (both children
    in one batch, as `traverse` runs them).
    """
    transport = Transport(models, block_part, torch.cat([zl, zr])[None],
                          site_rates)
    return _combine(transport(0, torch.cat([xl, xr])), scale_exp)


def traverse_store(models: DeviceModels, block_part: torch.Tensor,
                   tips: TipState, store, scaler: torch.Tensor,
                   tv: Traversal, scale_exp: int, ntips: int,
                   site_rates=None) -> None:
    """Execute a wave-scheduled traversal in place over a CLV store (a
    DenseArena or a CellPool): a loop over waves, each one gather of both
    children, one batched newview, and one scatter.  Index tensors and
    the transport operands of every step are prepared once, before the
    loop.

    Padding entries write the scratch row (duplicate scatter indices
    there only; its value is never read), as do a pool's all-gap cells
    (the scratch cell).  Reference `newviewIterative`
    (`newviewGenericSpecial.c:917-1515`)."""
    W = tv.parent.shape[1]
    is_tip, tip_idx, inner_idx = _child_index(
        torch.cat([tv.left, tv.right], dim=1), ntips, store.rows)
    transport = Transport(models, block_part,
                          torch.cat([tv.zl, tv.zr], dim=1), site_rates)
    for step in range(tv.parent.shape[0]):
        x = _gather(tips, store, is_tip[step], tip_idx[step],
                    inner_idx[step])
        sc = scaler[inner_idx[step]].masked_fill(
            is_tip[step][:, None, None], 0)
        v, inc = _combine(transport(step, x), scale_exp)
        parent = tv.parent[step]
        store.write(parent, v)
        scaler[parent] = sc[:W] + sc[W:] + inc


def traverse(models: DeviceModels, block_part: torch.Tensor, tips: TipState,
             clv: torch.Tensor, scaler: torch.Tensor, tv: Traversal,
             scale_exp: int, ntips: int, site_rates=None):
    """`traverse_store` on a dense arena clv; returns (clv, scaler)."""
    traverse_store(models, block_part, tips, DenseArena(clv), scaler, tv,
                   scale_exp, ntips, site_rates)
    return clv, scaler


def traverse_pooled(models: DeviceModels, block_part: torch.Tensor,
                    tips: TipState, pool: torch.Tensor,
                    slot_read: torch.Tensor, slot_write: torch.Tensor,
                    scaler: torch.Tensor, tv: Traversal, scale_exp: int,
                    ntips: int, site_rates=None):
    """SEV traversal: `traverse_store` on a block-cell pool, all-gap
    subtrees costing one shared cell of memory — the reference's `-S`
    design (`axml.c:2152-2171`, `_GAPPED_SAVE` kernels) as pool
    indirection.  Returns (pool, scaler)."""
    traverse_store(models, block_part, tips,
                   CellPool(pool, slot_read, slot_write), scaler, tv,
                   scale_exp, ntips, site_rates)
    return pool, scaler


class OutrootTraversal(NamedTuple):
    """Pre-order traversal descriptor [L, W] (host-built by
    ops/gradient.py): the post-order wave schedule walked in reverse wave
    order, each entry emitting the root-directed (outroot) partials of its
    two children.  `up_row`/`lrow`/`rrow` index the outroot arena (node
    number - 1; every node has a row, the last row is scratch);
    `left`/`right` are gather indices against the post-order CLV arena
    (`gather_child`'s convention).  `zu` is the branch above the entry's
    parent node (the root edge's z for the two root-adjacent entries).
    Padding entries read and write the scratch row."""
    up_row: torch.Tensor       # [L, W] int64
    lrow: torch.Tensor         # [L, W] int64
    rrow: torch.Tensor         # [L, W] int64
    left: torch.Tensor         # [L, W] int64
    right: torch.Tensor        # [L, W] int64
    zu: torch.Tensor           # [L, W, C]
    zl: torch.Tensor           # [L, W, C]
    zr: torch.Tensor           # [L, W, C]


def _sibling(yu: torch.Tensor, y: torch.Tensor, scale_exp: int):
    """(out_l, out_r) from the transported parent partial yu and the
    transported children y = [left; right], rescaled without counts."""
    W = yu.shape[0]
    return (rescale(yu * y[W:], scale_exp)[0],
            rescale(yu * y[:W], scale_exp)[0])


def outroot_wave(models: DeviceModels, block_part: torch.Tensor,
                 xu: torch.Tensor, xl: torch.Tensor, xr: torch.Tensor,
                 zu: torch.Tensor, zl: torch.Tensor, zr: torch.Tensor,
                 scale_exp: int, site_rates=None):
    """Sibling combine for one wave of W pre-order entries.

    xu: the parent's outroot partial [W, B, lane, R, K] (the complement of
    the parent's subtree, at the far end of the parent's upper branch);
    xl, xr: the children's post-order CLVs.  Returns (out_l, out_r) with
    out_l = (P(zu) xu) * (P(zr) xr), the complement of the left child's
    subtree located at the parent, and out_r symmetrically (Ji et al.
    2303.04390's pre-order recursion).

    Values are rescaled with newview's threshold and multiplier but no
    counts are kept: every consumer is a dsite/lsite ratio in which
    per-site scale factors cancel."""
    yu = Transport(models, block_part, zu[None], site_rates)(0, xu)
    y = Transport(models, block_part, torch.cat([zl, zr])[None],
                  site_rates)(0, torch.cat([xl, xr]))
    return _sibling(yu, y, scale_exp)


def outroot_pass(models: DeviceModels, block_part: torch.Tensor,
                 tips: TipState, clv: torch.Tensor, scaler: torch.Tensor,
                 out: torch.Tensor, tv: OutrootTraversal, scale_exp: int,
                 ntips: int, site_rates=None) -> torch.Tensor:
    """Execute a pre-order traversal in place: a loop over the reversed
    waves, each one batched `outroot_wave` step, filling the outroot arena
    `out` [2*ntips-1, B, lane, R, K] (rows by node number - 1, last row
    scratch).  `out` arrives with the two root rows set (out[p-1] = D(q),
    out[q-1] = D(p)); `clv` and `scaler` are only read."""
    is_tip, tip_idx, inner_idx = _child_index(
        torch.cat([tv.left, tv.right], dim=1), ntips, clv.shape[0])
    up = Transport(models, block_part, tv.zu, site_rates)
    down = Transport(models, block_part, torch.cat([tv.zl, tv.zr], dim=1),
                     site_rates)
    for step in range(tv.up_row.shape[0]):
        x = _gather(tips, DenseArena(clv), is_tip[step], tip_idx[step],
                    inner_idx[step])
        ol, orr = _sibling(up(step, out[tv.up_row[step]]), down(step, x),
                           scale_exp)
        out[tv.lrow[step]] = ol.to(out.dtype)
        out[tv.rrow[step]] = orr.to(out.dtype)
    return out


def site_likelihoods(models: DeviceModels, block_part: torch.Tensor,
                     xp: torch.Tensor, xq: torch.Tensor,
                     z: torch.Tensor, site_rates=None) -> torch.Tensor:
    """Per-site likelihood L[b,l] at the root branch (p,q) with branch z:
    L = sum_r w_r sum_k f_k * xp_k * (P(z) xq)_k (reference
    `evaluateGAMMA_FLEX`, `evaluateGenericSpecial.c:154-231`, or the CAT
    evaluate kernels when site_rates is given)."""
    if site_rates is None:
        y = apply_p(p_matrices(models, z), block_part, xq)    # [B,l,R,K]
    else:
        d = psr_decay(models, block_part, site_rates, z)
        y = apply_p_factorized(models, block_part, d, xq)
    fb = models.freqs[block_part]                             # [B, R, K]
    wb = models.rate_weights[block_part]                      # [B, R]
    return torch.einsum("brk,blrk->bl", fb * wb[:, :, None], xp * y)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Sums of values[..., i] over segments seg[i], along the last axis;
    seg is nondecreasing (block_part and part_branch are, by
    construction), so segment g is one run [offsets[g], offsets[g+1]).

    One segment_reduce on either device.  With the segment axis first
    and a trailing unit axis it takes the kernel that adds each
    segment's values one after another from 0, in index order: the bits
    of the CPU's index_add_, the same on every run (index_add_ adds by
    atomics on the card), and the same whatever leading axes the values
    carry, so a job inside a fleet batch sums exactly as alone.  Cost
    O(values), whatever the segment count."""
    offsets = torch.searchsorted(
        seg, torch.arange(num + 1, dtype=seg.dtype, device=seg.device))
    out = torch.segment_reduce(values.movedim(-1, 0).unsqueeze(-1), "sum",
                               offsets=offsets, axis=0, unsafe=True)
    return out.squeeze(-1).movedim(0, -1)


def per_rate_site_lnls(models: DeviceModels, block_part: torch.Tensor,
                       tips: TipState, clv: torch.Tensor,
                       scaler: torch.Tensor, p_idx, q_idx, z: torch.Tensor,
                       site_rates: torch.Tensor, scale_exp: int,
                       ntips: int) -> torch.Tensor:
    """Per-site, per-rate-candidate log likelihood [B, lane, R] (float64):
    the batched replacement for the reference's per-site rate scan
    (`evaluatePartialGeneric` once per site per trial rate,
    `optimizeModel.c:1792-1922`) — one traversal per rate-grid chunk
    gives every site's lnL under every candidate rate."""
    xp, sp = gather_child(tips, clv, scaler, p_idx, ntips)
    xq, sq = gather_child(tips, clv, scaler, q_idx, ntips)
    d = psr_decay(models, block_part, site_rates, z)
    y = apply_p_factorized(models, block_part, d, xq)
    fb = models.freqs[block_part][:, 0]                       # [B, K]
    lsite = torch.einsum("bk,blrk->blr", fb, xp * y)          # [B, lane, R]
    _, _, log_min = scale_constants(scale_exp)
    sc = (sp + sq).to(ACC)                                    # [B, lane]
    lsite = lsite.clamp_min(torch.finfo(lsite.dtype).tiny)
    return torch.log(lsite).to(ACC) + sc[:, :, None] * log_min


def root_log_likelihood(models: DeviceModels, block_part: torch.Tensor,
                        weights: torch.Tensor, tips: TipState,
                        clv: torch.Tensor, scaler: torch.Tensor,
                        p_idx, q_idx, z: torch.Tensor, num_parts: int,
                        scale_exp: int, ntips: int,
                        site_rates=None) -> torch.Tensor:
    """Per-partition log likelihoods [M] (float64) after a traversal;
    p_idx/q_idx are gather indices (reference `evaluateGeneric`,
    `evaluateGenericSpecial.c:897-1001`)."""
    xp, sp = gather_child(tips, clv, scaler, p_idx, ntips)
    xq, sq = gather_child(tips, clv, scaler, q_idx, ntips)
    return root_log_likelihood_from(models, block_part, weights, xp, sp,
                                    xq, sq, z, num_parts, scale_exp,
                                    site_rates)


def root_site_terms(models: DeviceModels, block_part: torch.Tensor, xp, sp,
                    xq, sq, z: torch.Tensor, scale_exp: int,
                    site_rates=None) -> torch.Tensor:
    """Each site's unweighted log likelihood at the root branch [B, lane]
    (float64): log L plus its scaler's log 2^-E per rescale."""
    lsite = site_likelihoods(models, block_part, xp, xq, z, site_rates)
    _, _, log_min = scale_constants(scale_exp)
    lsite = lsite.clamp_min(torch.finfo(lsite.dtype).tiny)
    return torch.log(lsite).to(ACC) + (sp + sq).to(ACC) * log_min


def weighted_root_sums(weights: torch.Tensor, terms: torch.Tensor,
                       block_part: torch.Tensor,
                       num_parts: int) -> torch.Tensor:
    """Per-partition lnL [..., M] of site terms [B, lane] under pattern
    weights [..., B, lane] (one weight vector, or a batch of them)."""
    site_lnl = weights.to(ACC) * terms
    return _segment_sum(site_lnl.sum(dim=-1), block_part, num_parts)


def root_log_likelihood_from(models: DeviceModels, block_part: torch.Tensor,
                             weights: torch.Tensor, xp, sp, xq, sq,
                             z: torch.Tensor, num_parts: int,
                             scale_exp: int,
                             site_rates=None) -> torch.Tensor:
    """root_log_likelihood over pre-gathered root CLVs."""
    terms = root_site_terms(models, block_part, xp, sp, xq, sq, z,
                            scale_exp, site_rates)
    return weighted_root_sums(weights, terms, block_part, num_parts)


def sumtable(models: DeviceModels, block_part: torch.Tensor,
             xp: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """st[...,b,l,r,j] = (sum_k f_rk xp_k ev_r[k,j]) * (sum_k ei_r[j,k]
    xq_k), so L(lz) = sum_j st_j exp(eign_rj rate_r lz) per site
    (reference `makenewzIterative`, `makenewzGenericSpecial.c:251-326`);
    xp, xq [..., B, lane, R, K]."""
    evb = models.ev[block_part]                               # [B, R, K, K]
    eib = models.ei[block_part]
    fb = models.freqs[block_part]                             # [B, R, K]
    ap = torch.einsum("...blrk,brkj->...blrj", xp * fb[:, None], evb)
    bq = torch.einsum("brjk,...blrk->...blrj", eib, xq)
    return ap * bq


def nr_derivatives(models: DeviceModels, block_part: torch.Tensor,
                   weights: torch.Tensor, st: torch.Tensor, z: torch.Tensor,
                   num_slots: int, site_rates=None):
    """(lnL', lnL'') w.r.t. lz summed over sites, per branch slot, in
    float64 (reference `coreGAMMA_FLEX` / `coreGTRCAT` + derivative
    Allreduce, `makenewzGenericSpecial.c:394-619, 1241-1248`).  st [...,
    B, lane, R, K] and z [..., C] may carry leading batch axes (one
    branch per index); the result is [..., C] each."""
    wb = models.rate_weights[block_part]                      # [B, R]
    if site_rates is None:
        d = branch_decay(models, z)                           # [..., M,R,K]
        e1 = models.eign * models.gamma_rates[:, :, None]     # [M, R, K]
        db = d[..., block_part, :, :] * wb[:, :, None]        # [..., B,R,K]
        e1b = e1[block_part]
        eq = "...blrj,...brj->...bl"
    else:
        d = psr_decay(models, block_part, site_rates, z)      # [...,B,l,R,K]
        e1b = (models.eign[block_part][:, 0][:, None, None, :]
               * site_rates[:, :, :, None])                   # [B, l, R, K]
        db = d * wb[:, None, :, None]
        eq = "...blrj,...blrj->...bl"
    lsite = torch.einsum(eq, st, db)
    dsite = torch.einsum(eq, st, db * e1b)
    d2site = torch.einsum(eq, st, db * e1b * e1b)
    lsite = lsite.clamp_min(torch.finfo(lsite.dtype).tiny)
    dlnl = (dsite / lsite).to(ACC)
    d2lnl = (d2site / lsite).to(ACC) - dlnl * dlnl
    wacc = weights.to(ACC)
    M = models.eign.shape[0]
    both = torch.stack([(wacc * dlnl).sum(dim=-1),
                        (wacc * d2lnl).sum(dim=-1)])          # [2, ..., B]
    d = _segment_sum(_segment_sum(both, block_part, M), models.part_branch,
                     num_slots)
    return d[0], d[1]


def newton_raphson_branch(models: DeviceModels, block_part: torch.Tensor,
                          weights: torch.Tensor, st: torch.Tensor,
                          z0: np.ndarray, maxiters0: np.ndarray,
                          conv0: np.ndarray, num_slots: int,
                          site_rates=None, reduce=None) -> np.ndarray:
    """Branch-length Newton-Raphson to convergence per branch slot.

    The iteration state lives on the host in float64 and each iteration
    reads the two derivative sums back (one small device-to-host copy),
    with the guards of the reference's `topLevelMakenewz`
    (`makenewzGenericSpecial.c:1133-1349`) exactly as the JAX package's
    `lax.while_loop` applies them: the bad-curvature shortening z <- 0.37
    z + 0.63, the 0.25 zprev + 0.75 step cap, and the give-up-after-
    (maxiter+20) reset to z0.  Iterates z <- z * exp(-lnL'/lnL'') until
    |z - zprev| <= zstep.

    Lanes: z0, maxiters0 and conv0 may be [N, C] with st [N, B, lane, R,
    K], N independent branches solved at once (one read-back per
    iteration for the whole batch).  A lane whose slots have all
    converged is frozen while the others go on, as a `jax.vmap` of the
    JAX loop freezes it; [C] is one lane.

    reduce: the site-parallel sum over ranks (`SiteGroup.allreduce`)
    applied to the stacked (d1, d2) right after every iteration's
    read-back, the reference's per-iteration derivative Allreduce
    (`makenewzGenericSpecial.c:1241-1248`).  The loop's exit depends on
    those values, so every rank must see the same ones; None for one
    process."""
    z0 = np.asarray(z0, dtype=np.float64)
    z = z0.copy()
    zprev = z0.copy()
    zstep = np.zeros_like(z0)
    maxiters = np.asarray(maxiters0, dtype=np.int64).copy()
    outer = np.asarray(conv0, dtype=bool).copy()
    curvat = np.ones_like(outer)
    while not outer.all():
        live = ~outer.all(axis=-1, keepdims=True)
        z_in = z
        fresh = ~outer & curvat
        zprev = np.where(fresh, z, zprev)
        zstep = np.where(fresh, (1.0 - ZMAX) * z + ZMIN, zstep)
        curvat = np.where(fresh, False, curvat)
        z = np.clip(z, ZMIN, ZMAX)
        d1, d2 = nr_derivatives(
            models, block_part, weights, st,
            torch.as_tensor(z, dtype=st.dtype, device=st.device), num_slots,
            site_rates)
        d = torch.stack([d1, d2]).cpu().numpy()
        if reduce is not None:
            d = reduce(d)
        d1, d2 = d[0], d[1]
        active = ~outer & ~curvat
        bad = active & (d2 >= 0.0) & (z < ZMAX)
        z = np.where(bad, 0.37 * z + 0.63, z)
        zprev = np.where(bad, z, zprev)
        curvat = np.where(active & ~bad, True, curvat)
        step = curvat & ~outer
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            tantmp = np.where(d2 < 0.0, -d1 / np.where(d2 < 0.0, d2, 1.0),
                              np.inf)
            cap = 0.25 * zprev + 0.75
            znr = np.where(tantmp < 100.0,
                           np.maximum(z * np.exp(np.minimum(tantmp, 100.0)),
                                      ZMIN),
                           cap)
        znr = np.minimum(znr, cap)
        z2 = np.where(step & (d2 < 0.0), znr, z)
        z2 = np.minimum(z2, ZMAX)
        maxiters = np.where(step, maxiters - 1, maxiters)
        moving = np.abs(z2 - zprev) > zstep
        gave_up = moving & (maxiters < -20)
        z = np.where(step & gave_up, z0, z2)
        outer = np.where(step, ~moving | gave_up, outer)
        # A converged lane's other state is left as it was by the steps
        # above; only the clip would move its z.
        z = np.where(live, z, z_in)
    return z
