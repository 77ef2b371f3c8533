"""PSR (per-site rate / CAT) model optimization.

Reference: `optimizeRateCategories` and its pipeline
(`optimizeModel.c:1792-2507`): the per-site rate hill scan
(`optRateCatPthreads` via `evaluatePartialGeneric`), the categorization
into at most `-c` categories (`categorizeTheRates` /
`categorizePartition`), the weighted mean-rate-1 normalization
(`updatePerSiteRates`), and accept-only-if-better semantics.

The port of `examl_tpu/optimize/psr.py`, single-process.  Instead of one
small traversal per (site, trial rate), every site's likelihood under a
whole grid of candidate rates comes from one full traversal per grid
chunk with a per-site-rate axis (`LikelihoodEngine.rate_scan`); the grid
reproduces the reference's hill-scan probes, current rate +- k spacings,
with the spacing shrinking per invocation.  The continuous refinement of
the category rates (`refine_category_rates`) always runs after the
reference's three scan rounds, the JAX package's default.
"""

from __future__ import annotations

import bisect

import numpy as np

from examl_tpu_torch.constants import ZMAX, ZMIN
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.optimize.brent import minimize_vector
from examl_tpu_torch.tree.topology import Tree, hookup

MIN_RATE = 0.0001          # reference lower bound on trial rates
RATE_STEPS = 64            # +-k steps covering the reference's open-ended
                           # scan reach (its crawl stops at the first
                           # non-improving step; 64 steps of the same
                           # spacing cover every realistic optimum)
CAT_MERGE_TOL = 0.001      # rates closer than this share a category
MAX_CAT_ROUNDS = 3         # catOpt < 3 in modOpt (optimizeModel.c:3100)


def _spacings(invocations: int) -> tuple[float, float]:
    """Shrinking scan spacings (reference `optimizeRateCategories`,
    `optimizeModel.c:2430-2444`)."""
    n = max(invocations, 1)
    if n == 1:
        lower, upper = 0.5, 1.0
    else:
        lower, upper = 0.05 / n, 0.1 / n
    return max(lower, 0.001), max(upper, 0.001)


def _scan_partition_rates(inst: PhyloInstance, tree: Tree,
                          lower: float, upper: float,
                          grid_chunk: int = 8) -> None:
    """Update inst.patrat / inst.site_lhs with the best rate per site.

    The batched replacement for the reference's per-site open-ended hill
    climb (`optRateCatPthreads`): every site's lnL under a +-RATE_STEPS
    candidate grid comes from shared full traversals.  The grid is the
    same arithmetic lattice (current rate + k*spacing) the reference's
    crawl walks: sites landing on shared lattice values is what lets the
    mass-ranked category selection find good representatives."""
    p, entries = tree.full_traversal()
    up = upper * np.arange(1, RATE_STEPS + 1)
    down = -lower * np.arange(1, RATE_STEPS + 1)
    if inst.save_memory:
        # The rate scan's scratch CLV is dense [rows, B, lane, G, K]
        # (engine.rate_scan), G times a single-rate dense arena; -S runs
        # exist because dense does not fit, so the transient peak stays
        # at ~2 dense arenas.
        grid_chunk = min(grid_chunk, 2)

    for states, bucket in inst.buckets.items():
        eng = inst.engines[states]
        packed_r0 = np.ones(bucket.num_sites)
        for li, gid in enumerate(bucket.part_ids):
            packed_r0[bucket.site_indices(li)] = inst.patrat[gid]
        r0 = packed_r0.reshape(bucket.num_blocks, bucket.lane)
        # Per-site lnls are weight-multiplied as the reference's
        # `term * w` (`evaluatePartialGenericSpecial.c:1049`): high-weight
        # patterns crawl further before the epsilon stop, and the
        # categorization ranks rate groups by weighted mass.
        w = inst.psr_packed_weights(bucket)

        def eval_offsets(offs):
            grid = r0[:, :, None] + offs[None, None, :]
            valid = grid > MIN_RATE
            grid = np.maximum(grid, MIN_RATE)
            lnls = eng.rate_scan(entries, p.number, p.back.number, p.z,
                                 grid) * w[:, :, None]       # [B, lane, Gc]
            return np.where(valid, lnls, -np.inf)

        cur_lnl = eval_offsets(np.zeros(1))[:, :, 0]

        def crawl(dir_offsets):
            """Directional crawl with the reference's stop rule: go on only
            while the next step improves by more than epsilon = 1e-5
            (`optRateCatPthreads`).  Grid chunks are evaluated lazily in
            walk order and the scan stops once every site's crawl has
            died, so the usual cost is a couple of chunks."""
            best = cur_lnl.copy()
            best_r = r0.copy()
            alive = np.ones_like(best, dtype=bool)
            for start in range(0, len(dir_offsets), grid_chunk):
                offs = dir_offsets[start:start + grid_chunk]
                lnls = eval_offsets(offs)
                for k in range(len(offs)):
                    v = lnls[:, :, k]
                    step = alive & (v > best) & (np.abs(best - v) > 1e-5)
                    rate_k = np.maximum(r0 + offs[k], MIN_RATE)
                    best = np.where(step, v, best)
                    best_r = np.where(step, rate_k, best_r)
                    alive = step
                if not alive.any():
                    break
            return best, best_r

        up_lnl, up_rate = crawl(up)
        dn_lnl, dn_rate = crawl(down)
        # The better crawl end if it strictly beats the current rate; on
        # an exact up-vs-down tie the down rate wins, as the reference's
        # `if(rightLH > leftLH) right else left` (`optimizeModel.c:
        # 1905-1917`).
        best_lnl = cur_lnl.copy()
        best_rate = r0.copy()
        use_up = (up_lnl > cur_lnl) & (up_lnl > dn_lnl)
        use_dn = (dn_lnl > cur_lnl) & ~use_up
        best_lnl = np.where(use_up, up_lnl, np.where(use_dn, dn_lnl,
                                                     best_lnl))
        best_rate = np.where(use_up, up_rate, np.where(use_dn, dn_rate,
                                                       best_rate))

        flat_rate = best_rate.reshape(-1)
        flat_lnl = best_lnl.reshape(-1)
        for li, gid in enumerate(bucket.part_ids):
            idx = bucket.site_indices(li)
            inst.patrat[gid] = flat_rate[idx].copy()
            inst.site_lhs[gid] = flat_lnl[idx].copy()


def _categorize_partition(patrat: np.ndarray, lhs: np.ndarray,
                          max_categories: int):
    """Bucket a partition's site rates into <= max_categories categories,
    the reference's algorithm (`categorizeTheRates`
    `optimizeModel.c:2171-2252`, `categorizePartition` :1734-1790):

    1. First-come tolerance merge in site order: a site joins the
       earliest-created category whose representative (first-seen) rate
       is within 0.001 absolute; otherwise it founds a new category with
       itself as representative.
    2. Categories sorted ascending by accumulated site lnL (sums of
       negative values: the biggest lnL mass first); the first
       max_categories survive.
    3. Each site takes the first surviving category (in mass order)
       within tolerance of its rate, else the nearest representative.

    Returns (category_per_site [W] int32, category_rates [ncat]).  The
    merge is O(W log C): representatives in a sorted list, candidates by
    bisection, the first-come rule resolved by the minimum creation index
    among in-tolerance candidates."""
    rep_rates: list = []      # sorted representative rates
    rep_created: list = []    # parallel creation indices
    cat_rate: list = []       # creation-order representatives
    cat_lnl: list = []        # accumulated site lnL per category
    tol = CAT_MERGE_TOL
    for r, l in zip(patrat.tolist(), lhs.tolist()):
        lo = bisect.bisect_left(rep_rates, r - tol)
        hi = bisect.bisect_right(rep_rates, r + tol)
        best = -1
        for j in range(lo, hi):
            if (r == rep_rates[j] or abs(r - rep_rates[j]) < tol) \
                    and (best == -1 or rep_created[j] < best):
                best = rep_created[j]
        if best == -1:
            best = len(cat_rate)
            cat_rate.append(r)
            cat_lnl.append(l)
            ins = bisect.bisect_left(rep_rates, r)
            rep_rates.insert(ins, r)
            rep_created.insert(ins, best)
        else:
            cat_lnl[best] += l

    order = np.argsort(np.asarray(cat_lnl), kind="stable")  # ascending
    kept = np.asarray(cat_rate)[order[:max_categories]]
    diff = np.abs(patrat[:, None] - kept[None, :])
    in_tol = (diff < tol) | (patrat[:, None] == kept[None, :])
    first_tol = np.argmax(in_tol, axis=1)
    nearest = np.argmin(diff, axis=1)
    category = np.where(in_tol.any(axis=1), first_tol, nearest)
    return category.astype(np.int32), kept


def _normalize_mean_rate(inst: PhyloInstance) -> None:
    """Scale category rates so the weighted mean site rate is 1: per
    partition under per-partition branch lengths, globally otherwise
    (reference `updatePerSiteRates`, `optimizeModel.c:2060-2120`).
    patrat keeps the un-snapped per-site scan optima, which seed the next
    scan, as the reference's does."""
    parts = inst.alignment.partitions
    if inst.num_branch_slots > 1:
        for gid in range(len(parts)):
            w = inst.psr_pattern_weights(gid)
            rates = inst.per_site_rates[gid][inst.rate_category[gid]]
            mean = float(w @ rates) / float(w.sum())
            inst.per_site_rates[gid] = inst.per_site_rates[gid] / mean
    else:
        num = den = 0.0
        for gid in range(len(parts)):
            w = inst.psr_pattern_weights(gid)
            rates = inst.per_site_rates[gid][inst.rate_category[gid]]
            num += float(w @ rates)
            den += float(w.sum())
        scale = num / den
        for gid in range(len(parts)):
            inst.per_site_rates[gid] = inst.per_site_rates[gid] / scale


def refine_category_rates(inst: PhyloInstance, tree: Tree,
                          tol: float = 0.0001) -> float:
    """Continuous polish of a frozen categorization, run in the mod_opt
    rounds after the reference's three scan/categorize rounds (where its
    CAT branch does nothing further for rate heterogeneity).

    Each category's representative rate becomes a free continuous
    parameter: Brent each category index across partitions (batched,
    accept-if-better per partition), then restore the weighted mean rate
    1 exactly via rates /= m and z -> z**m (lnL depends on the product
    rate * log z only, `makeP`'s EIGN*r*log z, so the joint rescale leaves
    it unchanged)."""
    if not inst.psr:
        raise RuntimeError("category rates belong to the PSR model")
    inst.evaluate(tree, full=True)
    # Accepted per-partition lnL, kept incrementally from the Brent
    # results (the next category's bracket starts from the accepted
    # state).
    cur = [float(v) for v in inst.per_partition_lnl]
    ncat_max = max(len(r) for r in inst.per_site_rates)
    for k in range(ncat_max):
        gids = [g for g in range(inst.num_parts)
                if len(inst.per_site_rates[g]) > k]
        if not gids:
            continue
        x0 = np.array([float(inst.per_site_rates[g][k]) for g in gids])
        start = np.array([cur[g] for g in gids])

        def fn(xs: np.ndarray) -> np.ndarray:
            for g, v in zip(gids, xs):
                inst.per_site_rates[g][k] = float(v)
            inst.push_site_rates()
            inst.evaluate(tree, full=True)
            return -np.array([float(inst.per_partition_lnl[g])
                              for g in gids])

        xb, fb = minimize_vector(x0, np.full(len(gids), MIN_RATE),
                                 np.full(len(gids), 32.0), fn, tol)
        for g, v0, v1, f1, l0 in zip(gids, x0, xb, fb, start):
            accept = -f1 > l0
            inst.per_site_rates[g][k] = float(v1 if accept else v0)
            cur[g] = float(-f1) if accept else float(l0)
        inst.push_site_rates()
    # Exact mean-rate-1 restoration: globally with one exponent, or per
    # partition under -M (each partition's branch slot compensates with
    # its own exponent, the reference's per-partition convention).
    # Clipping at ZMIN/ZMAX breaks exactness only for branches already at
    # the bounds, where the reference clips alike.
    parts = inst.alignment.partitions
    C = inst.num_branch_slots
    if C > 1:
        mexp = np.ones(C)
        for gid in range(len(parts)):
            w = inst.psr_pattern_weights(gid)
            rates = inst.per_site_rates[gid][inst.rate_category[gid]]
            m = float(w @ rates) / float(w.sum())
            inst.per_site_rates[gid] = inst.per_site_rates[gid] / m
            mexp[gid] = m
    else:
        num = den = 0.0
        for gid in range(len(parts)):
            w = inst.psr_pattern_weights(gid)
            rates = inst.per_site_rates[gid][inst.rate_category[gid]]
            num += float(w @ rates)
            den += float(w.sum())
        mexp = np.full(1, num / den)
        for gid in range(inst.num_parts):
            inst.per_site_rates[gid] = inst.per_site_rates[gid] / mexp[0]
    inst.push_site_rates()
    for a, b in tree.all_branches():
        z = np.clip(np.power(np.asarray(a.z, np.float64), mexp),
                    ZMIN, ZMAX)
        hookup(a, b, z.tolist())
    return inst.evaluate(tree, full=True)


def optimize_rate_categories(inst: PhyloInstance, tree: Tree,
                             max_categories: int | None = None) -> float:
    """One CAT optimization round: scan, categorize, normalize, accept if
    the full lnL improved (reference `optimizeRateCategories`)."""
    if not inst.psr:
        raise RuntimeError("rate categories belong to the PSR model")
    max_categories = max_categories or inst.psr_categories
    if max_categories == 1:
        return inst.evaluate(tree, full=True)

    initial_lnl = inst.evaluate(tree, full=True)
    backup = ([r.copy() for r in inst.patrat],
              [c.copy() for c in inst.rate_category],
              [p.copy() for p in inst.per_site_rates])

    inst.psr_invocations += 1
    lower, upper = _spacings(inst.psr_invocations)
    _scan_partition_rates(inst, tree, lower, upper)

    for gid in range(inst.num_parts):
        cat, kept = _categorize_partition(
            inst.patrat[gid], inst.site_lhs[gid], max_categories)
        inst.rate_category[gid] = cat
        inst.per_site_rates[gid] = kept
    _normalize_mean_rate(inst)
    inst.push_site_rates()

    lnl = inst.evaluate(tree, full=True)
    if lnl < initial_lnl:
        inst.patrat, inst.rate_category, inst.per_site_rates = backup
        inst.push_site_rates()
        lnl = inst.evaluate(tree, full=True)
        assert abs(lnl - initial_lnl) < 1e-6, (lnl, initial_lnl)
    return lnl
