"""Device bodies of the batched SPR radius scan and the lane helpers
they share with the batched quartet scorer.

The search layer (search/batchscan.py) plans a pruned node's candidate
insertions; `LikelihoodEngine.batched_scan` / `batched_thorough` turn the
plan into a traversal and gather indices and call `scan_chunk` /
`thorough_chunk` here.  Both are plain torch ops on the engine's tensors
(the JAX package's `scan_program` / `thorough_program` bodies, one
device), reading and writing CLVs through the engine's store: the dense
arena, or under `-S` the SEV pool through its slot maps
(`kernels.DenseArena` / `kernels.CellPool`).  The lane helpers apply P
matrices, sum per-lane lnLs and run Newton-Raphson over T independent
branches at once (`kernels.newton_raphson_branch` with a lane axis);
search/quartets_batch.py scores its quartet jobs with them.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from examl_tpu_torch.constants import DEFAULTZ, DELTAZ, SMOOTHINGS, ZMAX, ZMIN
from examl_tpu_torch.ops import kernels

CAND_CHUNK = 16          # lazy candidates per batched chunk
TH_CHUNK = 8             # thorough candidates per batched chunk


def lane_papply(models, block_part, site_rates, z: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """P(z[t]) applied to x[t] for T branch vectors z [T, C] and CLVs x
    [T, B, lane, R, K] (or one x [B, lane, R, K] for every t)."""
    T = z.shape[0]
    if x.dim() == 4:
        x = x.expand((T,) + x.shape)
    if site_rates is not None:
        d = kernels.psr_decay(models, block_part, site_rates, z)
        return kernels.apply_p_factorized(models, block_part, d, x)
    pw = kernels.p_matrices_wave(models, z)[:, block_part]   # [T,B,R,K,K]
    return torch.einsum("tbrak,tblrk->tblra", pw, x)


def lane_lnls(models, block_part, weights, xp, xq, sc, scale_exp: int):
    """Per-lane lnL [T] (float64) of L = sum_r w_r sum_k f_k xp_k xq_k per
    site (xq already carries P), with per-site scaler counts sc."""
    fb = models.freqs[block_part]                             # [B, R, K]
    wb = models.rate_weights[block_part]                      # [B, R]
    lsite = torch.einsum("brk,tblrk->tbl", fb * wb[:, :, None], xp * xq)
    lsite = lsite.clamp_min(torch.finfo(lsite.dtype).tiny)
    _, _, log_min = kernels.scale_constants(scale_exp)
    site_lnl = weights.to(kernels.ACC)[None] * (
        torch.log(lsite).to(kernels.ACC) + sc.to(kernels.ACC) * log_min)
    return site_lnl.sum(dim=(1, 2))


def scan_chunk(models, block_part, weights, tips, store, scaler, tv, qg,
               upg, zc, s_idx: int, zp, scale_exp: int, ntips: int,
               site_rates=None) -> torch.Tensor:
    """The lazy arm's device body for one plan: the orientation fixes and
    the uppass entries (traversal tv, into store/scaler in place), the
    subtree operand u = P(zp) down(s), then per chunk of CAND_CHUNK
    candidates P(z') applied to down(q) (gather indices qg [N]) and to
    uppass(q) (upg [N]) with z' = zc [N, C], the rescale and the weighted
    site sum.  Returns the candidates' lnLs [N] (float64, on the device)."""
    kernels.traverse_store(models, block_part, tips, store, scaler, tv,
                           scale_exp, ntips, site_rates)
    xs, ss = kernels.gather_from(tips, store, scaler, s_idx, ntips)
    u = lane_papply(models, block_part, site_rates, zp[None], xs)[0]
    out = []
    for lo in range(0, qg.shape[0], CAND_CHUNK):
        z = zc[lo:lo + CAND_CHUNK]
        xq, sq = kernels.gather_from(tips, store, scaler,
                                     qg[lo:lo + CAND_CHUNK], ntips)
        xr, sr = kernels.gather_from(tips, store, scaler,
                                     upg[lo:lo + CAND_CHUNK], ntips)
        v, inc = kernels.rescale(lane_papply(models, block_part, site_rates,
                                             z, xq) * u, scale_exp)
        y = lane_papply(models, block_part, site_rates, z, xr)
        out.append(lane_lnls(models, block_part, weights, v, y,
                             sq + ss + inc + sr, scale_exp))
    return torch.cat(out)


def lane_newton(models, block_part, weights, site_rates, xp, xq, z0,
                maxiter: int, reduce=None) -> np.ndarray:
    """Newton-Raphson to convergence on T independent branches, branch t
    between CLVs xp[t] and xq[t] (either may be one CLV for every t),
    from z0 [T]; the new z [T] (float64).  reduce: the derivatives' sum
    over ranks (`kernels.newton_raphson_branch`)."""
    st = kernels.sumtable(models, block_part, xp, xq)
    T = st.shape[0]
    z0 = np.broadcast_to(np.asarray(z0, np.float64), (T,))
    return kernels.newton_raphson_branch(
        models, block_part, weights, st, z0.reshape(T, 1),
        np.full((T, 1), maxiter, np.int64), np.zeros((T, 1), bool), 1,
        site_rates, reduce)[:, 0]


def triangle(zqr, zqs, zrs):
    """The log-space star-triangle solve with the reference's degenerate
    caps (`insertBIG`'s thorough arm), over arrays of candidates."""
    lzmax = math.log(ZMAX)
    lzqr = np.log(np.maximum(zqr, ZMIN))
    lzqs = np.log(np.maximum(zqs, ZMIN))
    lzrs = np.log(np.maximum(zrs, ZMIN))
    lzsum = 0.5 * (lzqr + lzqs + lzrs)
    lzq, lzr, lzs = lzsum - lzrs, lzsum - lzqs, lzsum - lzqr
    e1, e2, e3 = np.exp(lzq), np.exp(lzr), np.exp(lzs)
    c1 = lzq > lzmax
    c2 = ~c1 & (lzr > lzmax)
    c3 = ~c1 & ~c2 & (lzs > lzmax)
    e1 = np.where(c1, ZMAX, np.where(c2, zqr, np.where(c3, zqs, e1)))
    e2 = np.where(c1, zqr, np.where(c2, ZMAX, np.where(c3, zrs, e2)))
    e3 = np.where(c1, zqs, np.where(c2, zrs, np.where(c3, ZMAX, e3)))
    return e1, e2, e3


def thorough_chunk(models, block_part, weights, tips, store, scaler, tv, qg,
                   upg, zq0, s_idx: int, scale_exp: int, ntips: int,
                   nr_iterations: int, site_rates=None, reduce=None
                   ) -> Tuple[torch.Tensor, np.ndarray]:
    """The thorough arm's device body for one plan: the traversal tv as in
    `scan_chunk`, then per chunk of TH_CHUNK candidates three
    Newton-Raphson solves to convergence (at most nr_iterations steps)
    between down(q), uppass(q) and the subtree CLV (started like
    `spr._triangle_branches`, zq0 [N] the candidates' z(q)), the triangle
    solve, up to SMOOTHINGS localSmooth passes (each branch one
    Newton-Raphson update with the DELTAZ
    movement test; a candidate whose pass moved nothing is done and
    frozen, the JAX body's `where(done, zold, znew)`), and the final
    evaluation across the r-side branch.  Returns (lnls [N] float64 on
    the device, e [N, 3] the smoothed z triplets).

    Newton derivatives do not depend on the operands' scaler counts (a
    per-site constant factor), so only the final lnL applies them.
    reduce: the derivatives' sum over ranks (`lane_newton`); the done
    masks come from the reduced z, so they agree on every rank.  The
    returned lnLs are this rank's site sums: the caller reduces them."""
    kernels.traverse_store(models, block_part, tips, store, scaler, tv,
                           scale_exp, ntips, site_rates)
    xs, ss = kernels.gather_from(tips, store, scaler, s_idx, ntips)
    dt, dev = xs.dtype, xs.device

    def papply(e: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        z = torch.as_tensor(e, dtype=dt, device=dev)[:, None]
        return lane_papply(models, block_part, site_rates, z, x)

    def nr(xp, xq, z0, maxiter):
        return lane_newton(models, block_part, weights, site_rates, xp, xq,
                           z0, maxiter, reduce)

    lnls, es = [], []
    for lo in range(0, qg.shape[0], TH_CHUNK):
        xq, sq = kernels.gather_from(tips, store, scaler,
                                     qg[lo:lo + TH_CHUNK], ntips)
        xr, sr = kernels.gather_from(tips, store, scaler,
                                     upg[lo:lo + TH_CHUNK], ntips)
        e1, e2, e3 = triangle(
            nr(xq, xr, zq0[lo:lo + TH_CHUNK], nr_iterations),
            nr(xq, xs, DEFAULTZ, nr_iterations),
            nr(xr, xs, DEFAULTZ, nr_iterations))
        done = np.zeros(e1.shape[0], dtype=bool)
        for _ in range(SMOOTHINGS):
            live = np.flatnonzero(~done)
            if live.size == 0:
                break
            lv = torch.as_tensor(live, device=dev)
            q, r = xq[lv], xr[lv]
            moved = np.zeros(live.size, dtype=bool)
            # localSmooth order: (p: e3), (p.next: e1), (p.next.next: e2)
            z = nr(papply(e1[live], q) * papply(e2[live], r), xs,
                   e3[live], 1)
            moved |= np.abs(z - e3[live]) > DELTAZ
            e3[live] = z
            z = nr(papply(e2[live], r) * papply(e3[live], xs), q,
                   e1[live], 1)
            moved |= np.abs(z - e1[live]) > DELTAZ
            e1[live] = z
            z = nr(papply(e1[live], q) * papply(e3[live], xs), r,
                   e2[live], 1)
            moved |= np.abs(z - e2[live]) > DELTAZ
            e2[live] = z
            done[live] = ~moved
        xp, inc = kernels.rescale(papply(e1, xq) * papply(e3, xs),
                                  scale_exp)
        lnls.append(lane_lnls(models, block_part, weights, xp,
                              papply(e2, xr), sq + ss + inc + sr, scale_exp))
        es.append(np.stack([e1, e2, e3], axis=1))
    return torch.cat(lnls), np.concatenate(es)
