"""Plain PyTorch kernels of the likelihood engine (GAMMA models).

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
    """Tip data: packed codes + indicator lookup table."""
    codes: torch.Tensor        # [ntips, B, lane] uint8 state codes
    table: torch.Tensor        # [num_codes, K] 0/1 indicator vectors


def scale_constants(scale_exp: int):
    """(minlik, two_e, log_min) for exponent E: 2^-E, 2^E, -E log 2."""
    e = scale_exp
    return 2.0 ** (-e), 2.0 ** e, -e * math.log(2.0)


def gather_child(tips: TipState, clv: torch.Tensor, scaler: torch.Tensor,
                 idx: torch.Tensor, ntips: int):
    """CLV + scaler of child nodes given gather indices idx [...].

    Tips (idx < ntips) materialize their indicator vectors from the code
    table (scaler 0); inner nodes read arena row idx - ntips."""
    R = clv.shape[3]
    idx = torch.as_tensor(idx, dtype=torch.int64, device=clv.device)
    is_tip = idx < ntips
    tip_idx = idx.clamp(0, ntips - 1)
    codes = tips.codes[tip_idx].long()                   # [..., B, lane]
    tip_clv = tips.table[codes]                          # [..., B, lane, K]
    tip_clv = tip_clv.unsqueeze(-2).expand(
        tip_clv.shape[:-1] + (R, tip_clv.shape[-1]))
    inner_idx = (idx - ntips).clamp(0, clv.shape[0] - 1)
    inner_clv = clv[inner_idx].to(tips.table.dtype)
    sel = is_tip[..., None, None, None, None]
    x = torch.where(sel, tip_clv, inner_clv)
    sc = torch.where(is_tip[..., None, None], torch.zeros_like(
        scaler[inner_idx]), scaler[inner_idx])
    return x, sc


def branch_decay(models: DeviceModels, z: torch.Tensor) -> torch.Tensor:
    """d[m, r, j] = exp(eign_rj * rate_r * log z_m), the eigenvalue decay
    (z: [C] per-branch-slot values; each partition selects its slot)."""
    lz = torch.log(z[models.part_branch])                     # [M]
    return torch.exp(models.eign * models.gamma_rates[:, :, None]
                     * lz[:, None, None])                     # [M, R, K]


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


def rescale(v: torch.Tensor, scale_exp: int, state_dims=(-2, -1)):
    """Multiply sites whose max |v| falls below 2^-E by 2^E; returns
    (v, increment) with the increment an int32 0/1 per site."""
    minlik, two_e, _ = scale_constants(scale_exp)
    needs = v.abs().amax(dim=state_dims) < minlik
    shape = needs.shape + (1,) * len(state_dims)
    v = torch.where(needs.reshape(shape), v * two_e, v)
    return v, needs.to(torch.int32)


def newview_wave(models: DeviceModels, block_part: torch.Tensor,
                 xl: torch.Tensor, xr: torch.Tensor,
                 zl: torch.Tensor, zr: torch.Tensor, scale_exp: int):
    """Combine child CLVs into parent CLVs for one wave of W entries.

    xl, xr: [W, B, lane, R, K]; zl, zr: [W, C].  Returns (clv [W,B,lane,
    R,K], scale_inc [W,B,lane]).  Reference `newviewGAMMA_FLEX`
    (`newviewGenericSpecial.c:430-682`) batched over independent entries.
    """
    pl = p_matrices_wave(models, zl)[:, block_part]           # [W,B,R,K,K]
    pr = p_matrices_wave(models, zr)[:, block_part]
    yl = torch.einsum("wbrak,wblrk->wblra", pl, xl)
    yr = torch.einsum("wbrak,wblrk->wblra", pr, xr)
    return rescale(yl * yr, scale_exp)


def traverse(models: DeviceModels, block_part: torch.Tensor, tips: TipState,
             clv: torch.Tensor, scaler: torch.Tensor, tv: Traversal,
             scale_exp: int, ntips: int):
    """Execute a wave-scheduled traversal in place: a loop over waves,
    each one gather per child, a batched newview, and one scatter.

    Padding entries write the scratch row (duplicate scatter indices
    there only; its value is never read).  Reference `newviewIterative`
    (`newviewGenericSpecial.c:917-1515`)."""
    for step in range(tv.parent.shape[0]):
        parent = tv.parent[step]
        xl, sl = gather_child(tips, clv, scaler, tv.left[step], ntips)
        xr, sr = gather_child(tips, clv, scaler, tv.right[step], ntips)
        v, inc = newview_wave(models, block_part, xl, xr, tv.zl[step],
                              tv.zr[step], scale_exp)
        clv[parent] = v.to(clv.dtype)
        scaler[parent] = sl + sr + inc
    return clv, scaler


def site_likelihoods(models: DeviceModels, block_part: torch.Tensor,
                     xp: torch.Tensor, xq: torch.Tensor,
                     z: torch.Tensor) -> torch.Tensor:
    """Per-site likelihood L[b,l] at the root branch (p,q) with branch z:
    L = sum_r w_r sum_k f_k * xp_k * (P(z) xq)_k (reference
    `evaluateGAMMA_FLEX`, `evaluateGenericSpecial.c:154-231`)."""
    y = apply_p(p_matrices(models, z), block_part, xq)        # [B,l,R,K]
    fb = models.freqs[block_part]                             # [B, R, K]
    wb = models.rate_weights[block_part]                      # [B, R]
    return torch.einsum("brk,blrk->bl", fb * wb[:, :, None], xp * y)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor,
                 num: int) -> torch.Tensor:
    out = torch.zeros(num, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values)


def root_log_likelihood(models: DeviceModels, block_part: torch.Tensor,
                        weights: torch.Tensor, tips: TipState,
                        clv: torch.Tensor, scaler: torch.Tensor,
                        p_idx, q_idx, z: torch.Tensor, num_parts: int,
                        scale_exp: int, ntips: int) -> torch.Tensor:
    """Per-partition log likelihoods [M] (float64) after a traversal;
    p_idx/q_idx are gather indices (reference `evaluateGeneric`,
    `evaluateGenericSpecial.c:897-1001`)."""
    xp, sp = gather_child(tips, clv, scaler, p_idx, ntips)
    xq, sq = gather_child(tips, clv, scaler, q_idx, ntips)
    return root_log_likelihood_from(models, block_part, weights, xp, sp,
                                    xq, sq, z, num_parts, scale_exp)


def root_log_likelihood_from(models: DeviceModels, block_part: torch.Tensor,
                             weights: torch.Tensor, xp, sp, xq, sq,
                             z: torch.Tensor, num_parts: int,
                             scale_exp: int) -> torch.Tensor:
    """root_log_likelihood over pre-gathered root CLVs."""
    lsite = site_likelihoods(models, block_part, xp, xq, z)
    _, _, log_min = scale_constants(scale_exp)
    lsite = lsite.clamp_min(torch.finfo(lsite.dtype).tiny)
    site_lnl = weights.to(ACC) * (torch.log(lsite).to(ACC)
                                  + (sp + sq).to(ACC) * log_min)
    return _segment_sum(site_lnl.sum(dim=1), block_part, num_parts)


def sumtable(models: DeviceModels, block_part: torch.Tensor,
             xp: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """st[b,l,r,j] = (sum_k f_rk xp_k ev_r[k,j]) * (sum_k ei_r[j,k] xq_k),
    so L(lz) = sum_j st_j exp(eign_rj rate_r lz) per site (reference
    `makenewzIterative`, `makenewzGenericSpecial.c:251-326`)."""
    evb = models.ev[block_part]                               # [B, R, K, K]
    eib = models.ei[block_part]
    fb = models.freqs[block_part]                             # [B, R, K]
    ap = torch.einsum("blrk,brkj->blrj", xp * fb[:, None], evb)
    bq = torch.einsum("brjk,blrk->blrj", eib, xq)
    return ap * bq


def nr_derivatives(models: DeviceModels, block_part: torch.Tensor,
                   weights: torch.Tensor, st: torch.Tensor, z: torch.Tensor,
                   num_slots: int):
    """(lnL', lnL'') w.r.t. lz summed over sites, per branch slot [C],
    in float64 (reference `coreGAMMA_FLEX` + derivative Allreduce,
    `makenewzGenericSpecial.c:394-619, 1241-1248`)."""
    wb = models.rate_weights[block_part]                      # [B, R]
    d = branch_decay(models, z)                               # [M, R, K]
    e1 = models.eign * models.gamma_rates[:, :, None]         # [M, R, K]
    db = d[block_part] * wb[:, :, None]                       # [B, R, K]
    e1b = e1[block_part]
    lsite = torch.einsum("blrj,brj->bl", st, db)
    dsite = torch.einsum("blrj,brj->bl", st, db * e1b)
    d2site = torch.einsum("blrj,brj->bl", st, db * e1b * e1b)
    lsite = lsite.clamp_min(torch.finfo(lsite.dtype).tiny)
    dlnl = (dsite / lsite).to(ACC)
    d2lnl = (d2site / lsite).to(ACC) - dlnl * dlnl
    wacc = weights.to(ACC)
    M = models.eign.shape[0]
    d1 = _segment_sum(_segment_sum((wacc * dlnl).sum(dim=1), block_part, M),
                      models.part_branch, num_slots)
    d2 = _segment_sum(_segment_sum((wacc * d2lnl).sum(dim=1), block_part,
                                   M), models.part_branch, num_slots)
    return d1, d2


def newton_raphson_branch(models: DeviceModels, block_part: torch.Tensor,
                          weights: torch.Tensor, st: torch.Tensor,
                          z0: np.ndarray, maxiters0: np.ndarray,
                          conv0: np.ndarray, num_slots: int) -> np.ndarray:
    """Branch-length Newton-Raphson to convergence per branch slot.

    The iteration state lives on the host in float64 and each iteration
    reads the two derivative sums back (one small device-to-host copy),
    with the guards of the reference's `topLevelMakenewz`
    (`makenewzGenericSpecial.c:1133-1349`) exactly as the JAX package's
    `lax.while_loop` applies them: the bad-curvature shortening z <- 0.37
    z + 0.63, the 0.25 zprev + 0.75 step cap, and the give-up-after-
    (maxiter+20) reset to z0.  Iterates z <- z * exp(-lnL'/lnL'') until
    |z - zprev| <= zstep."""
    z0 = np.asarray(z0, dtype=np.float64)
    z = z0.copy()
    zprev = z0.copy()
    zstep = np.zeros_like(z0)
    maxiters = np.asarray(maxiters0, dtype=np.int64).copy()
    outer = np.asarray(conv0, dtype=bool).copy()
    curvat = np.ones_like(outer)
    while not outer.all():
        fresh = ~outer & curvat
        zprev = np.where(fresh, z, zprev)
        zstep = np.where(fresh, (1.0 - ZMAX) * z + ZMIN, zstep)
        curvat = np.where(fresh, False, curvat)
        z = np.clip(z, ZMIN, ZMAX)
        d1, d2 = nr_derivatives(
            models, block_part, weights, st,
            torch.as_tensor(z, dtype=st.dtype, device=st.device), num_slots)
        d1 = d1.cpu().numpy()
        d2 = d2.cpu().numpy()
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
    return z
