"""Batched quartet scoring: many quartets x 3 topologies in one batch.

The port of `examl_tpu/search/quartets_batch.py`.  The reference scores
one quartet topology at a time inside the big tree structure: 5 branches
hooked up, up to 16 NNI smoothing passes each doing a per-branch Newton
update, then one evaluation, every step a separate newview / evaluate /
derivative round trip (`quartets.c:176-323`).

A quartet tree needs no CLV arena: with tip vectors t_a..t_d and the 5
branch lengths, every directional CLV is a closed-form product

    x_ab = P(z1) t_a * P(z2) t_b        x_cd = P(z3) t_c * P(z4) t_d

so the whole procedure (the smoothing passes, each branch one Newton
update with the reference's update() semantics and the DELTAZ movement
test, early stop when a pass moves nothing, then the final evaluation)
runs as torch ops over a batch of JOB_CHUNK jobs (quartets x
topologies), every Newton update one `kernels.newton_raphson_branch` call
with a lane per job (the lane helpers of ops/scan.py).  Scaling is
omitted: a 4-taxon product of two P-applied tip vectors stays far above
every rescale threshold.

Eligible with one state bucket, one branch slot, GAMMA rates and no SEV
pool (`-S`, as in the JAX package); the sequential scorer
(search/quartets.py) serves everything else.  Output
rows and their order are the sequential scorer's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from examl_tpu_torch.constants import DEFAULTZ, DELTAZ
from examl_tpu_torch.ops.scan import lane_lnls, lane_newton, lane_papply

JOB_CHUNK = 48           # jobs per batch (= 16 quartet sets)
NNI_SMOOTHINGS = 16      # branch passes per quartet (ref quartets.c:254)
# Jobs scored by score_jobs (a plain count, read by chip_smoke.py).
JOBS_SCORED = 0


def batch_eligible(inst) -> bool:
    """True when `compute_quartets` scores in batches: GAMMA, one branch
    slot, one state bucket, no SEV pool."""
    if inst.psr or inst.num_branch_slots != 1 or inst.save_memory:
        return False
    return len(inst.engines) == 1


def score_chunk(eng, codes: torch.Tensor) -> torch.Tensor:
    """lnL [J] (float64, on the device) of J jobs, codes [J, 4] the
    0-based tip rows (a, b, c, d) of topology ((a,b),(c,d)): the
    16-pass NNI smoothing with a done mask (a job whose pass moved no
    branch is frozen), then the evaluation across the d-branch.  Every
    Newton update reduces its derivatives over the engine's site group;
    the lnLs returned are this rank's site sums (`score_jobs` reduces
    them)."""
    m, bp, w = eng.models, eng.block_part, eng.weights
    tipv = eng.tips.vectors[codes]                    # [J, 4, B, lane, K]
    tipv = tipv.unsqueeze(-2).expand(tipv.shape[:-1] + (eng.R, eng.K))
    ta, tb, tc, td = tipv.unbind(1)                   # [J, B, lane, R, K]
    J = codes.shape[0]

    def papply(z: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        zt = torch.as_tensor(z, dtype=eng.dtype, device=eng.device)
        return lane_papply(m, bp, None, zt[:, None], x)

    def nr(xp, xq, z):
        """One reference update(): Newton-Raphson with maxiter 1."""
        return lane_newton(m, bp, w, None, xp, xq, z, 1,
                           eng.group.allreduce)

    # z[:, 0] the internal branch, z[:, 1..4] the branches to a, b, c, d;
    # each pass smooths them in the reference's order (nniSmooth's list).
    z = np.full((J, 5), DEFAULTZ)
    done = np.zeros(J, dtype=bool)
    for _ in range(NNI_SMOOTHINGS):
        live = np.flatnonzero(~done)
        if live.size == 0:
            break
        lv = torch.as_tensor(live, device=eng.device)
        a, b, c, d = ta[lv], tb[lv], tc[lv], td[lv]
        zl = z[live]
        moved = np.zeros(live.size, dtype=bool)

        def upd(i, xp, xq):
            nonlocal moved
            znew = nr(xp, xq, zl[:, i])
            moved |= np.abs(znew - zl[:, i]) > DELTAZ
            zl[:, i] = znew

        x_cd = papply(zl[:, 3], c) * papply(zl[:, 4], d)
        upd(0, papply(zl[:, 1], a) * papply(zl[:, 2], b), x_cd)
        x_cd5 = papply(zl[:, 0], x_cd)
        upd(1, a, papply(zl[:, 2], b) * x_cd5)
        upd(2, b, papply(zl[:, 1], a) * x_cd5)
        x_ab5 = papply(zl[:, 0], papply(zl[:, 1], a) * papply(zl[:, 2], b))
        upd(3, c, papply(zl[:, 4], d) * x_ab5)
        upd(4, d, papply(zl[:, 3], c) * x_ab5)
        z[live] = zl
        done[live] = ~moved

    # Evaluate across the d-branch: the CLV at the c/d-side inner node
    # viewing away from d, against tip d (the reference evaluates at
    # q2.next.next after smoothing).
    x_ab = papply(z[:, 1], ta) * papply(z[:, 2], tb)
    xp = papply(z[:, 0], x_ab) * papply(z[:, 3], tc)
    return lane_lnls(m, bp, w, xp, papply(z[:, 4], td),
                     torch.zeros((), dtype=torch.int32, device=eng.device),
                     eng.scale_exp)


def score_jobs(inst, jobs: Sequence[Tuple[int, int, int, int]]
               ) -> np.ndarray:
    """lnL for each job (a,b,c,d) meaning topology ((a,b),(c,d)); taxon
    numbers are 1-based."""
    global JOBS_SCORED
    (eng,) = inst.engines.values()
    out = np.zeros(len(jobs))
    for lo in range(0, len(jobs), JOB_CHUNK):
        chunk = np.asarray(jobs[lo:lo + JOB_CHUNK], np.int64) - 1
        out[lo:lo + len(chunk)] = eng.on_shards(_score_reduced, chunk)
        JOBS_SCORED += len(chunk)
    return out


def _score_reduced(eng, chunk: np.ndarray) -> np.ndarray:
    """`score_chunk` of a site shard's engine, reduced over its group."""
    codes = torch.as_tensor(chunk, device=eng.device)
    return eng.group.allreduce(score_chunk(eng, codes).cpu().numpy())


def three_topology_jobs(t1: int, t2: int, t3: int, t4: int
                        ) -> List[Tuple[int, int, int, int]]:
    """The reference's fixed topology order (`computeAllThreeQuartets`)."""
    return [(t1, t2, t3, t4), (t1, t3, t2, t4), (t1, t4, t2, t3)]
