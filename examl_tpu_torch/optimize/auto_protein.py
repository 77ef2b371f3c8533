"""Automatic protein model selection for AUTO partitions.

Reference `autoProtein` + `optModel` (`optimizeModel.c:2606-2900`): every
candidate empirical matrix is scored on all AUTO partitions at once —
branches reset to default, one smoothing pass, per-partition lnL recorded —
under both the matrix's own frequencies and the partition's empirical
frequencies; the winner per partition is picked by ML / BIC / AIC / AICc
(empirical frequencies cost 19 extra free parameters), and the whole
selection is reverted if the final smoothed likelihood got worse.

The port of `examl_tpu/optimize/auto_protein.py`.
"""

from __future__ import annotations

import numpy as np

from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.models import protein as protein_mod
from examl_tpu_torch.models.gtr import build_model
from examl_tpu_torch.optimize.branch import tree_evaluate
from examl_tpu_torch.search.snapshots import TreeSnapshot
from examl_tpu_torch.tree.topology import Tree

CRITERIA = ("ml", "bic", "aic", "aicc")


def _install(inst: PhyloInstance, gid: int, name: str,
             empirical: bool) -> None:
    part = inst.alignment.partitions[gid]
    rates, model_freqs = protein_mod.get_matrix(name)
    freqs = part.empirical_freqs if empirical else model_freqs
    inst.models[gid] = build_model(part.datatype, freqs, rates=rates,
                                   alpha=inst.models[gid].alpha,
                                   ncat=inst.ncat,
                                   use_median=inst.use_median)


def _scan(inst: PhyloInstance, tree: Tree, autos, empirical: bool):
    """Best (matrix index, lnL) per AUTO partition across all candidates
    (reference `optModel`)."""
    best_idx = {gid: -1 for gid in autos}
    best_lnl = {gid: -np.inf for gid in autos}
    for i, name in enumerate(protein_mod.AUTO_CANDIDATES):
        for gid in autos:
            _install(inst, gid, name, empirical)
        inst.push_models()
        tree.reset_branches()
        inst.evaluate(tree, full=True)
        tree_evaluate(inst, tree, 0.5)
        for gid in autos:
            lnl = float(inst.per_partition_lnl[gid])
            if lnl > best_lnl[gid]:
                best_lnl[gid] = lnl
                best_idx[gid] = i
    return best_idx, best_lnl


def _criterion_score(criterion: str, lnl: float, k: float,
                     n: float) -> float:
    """Lower is better for BIC/AIC/AICc; ML handled by the caller."""
    if criterion == "bic":
        return -2.0 * lnl + k * np.log(n)
    if criterion == "aic":
        return 2.0 * (k - lnl)
    if criterion == "aicc":
        if n - k - 1.0 < 0.5:
            # Sample size too small for the correction term: this model
            # cannot be ranked — score it worst (the reference's 0.0 here
            # would make it win unconditionally, which is backwards).
            return float("inf")
        return 2.0 * (k - lnl) + (2.0 * k * (k + 1.0)) / (n - k - 1.0)
    raise ValueError(criterion)


def auto_protein(inst: PhyloInstance, tree: Tree, criterion: str = "ml",
                 log=lambda m: None) -> None:
    """Select and install the best matrix for every AUTO partition
    (reference `autoProtein`)."""
    autos = [gid for gid, p in enumerate(inst.alignment.partitions)
             if p.auto]
    if not autos:
        return
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}, expected one "
                         f"of {CRITERIA}")

    start_lnl = inst.evaluate(tree, full=True)
    snap = TreeSnapshot.capture(tree, start_lnl, with_key=False)
    old = {gid: (inst.auto_prot_models.get(gid, "WAG"),
                 inst.auto_prot_freqs.get(gid, "fixed")) for gid in autos}

    fixed_idx, fixed_lnl = _scan(inst, tree, autos, empirical=False)
    emp_idx, emp_lnl = _scan(inst, tree, autos, empirical=True)

    ntips = inst.alignment.ntaxa
    for gid in autos:
        part = inst.alignment.partitions[gid]
        # The sample size is the alignment's, also on a rank that read
        # only its own columns.
        n = float(part.global_weight_sum if part.global_weight_sum
                  is not None else part.weights.sum())
        k_fixed = float(2 * ntips - 3)
        if inst.psr:
            k_fixed += len(inst.per_site_rates[gid])
        else:
            k_fixed += 1.0                       # alpha
        k_emp = k_fixed + 19.0
        if criterion == "ml":
            use_emp = emp_lnl[gid] > fixed_lnl[gid]
        else:
            use_emp = (_criterion_score(criterion, emp_lnl[gid], k_emp, n)
                       < _criterion_score(criterion, fixed_lnl[gid],
                                          k_fixed, n))
        idx = emp_idx[gid] if use_emp else fixed_idx[gid]
        name = protein_mod.AUTO_CANDIDATES[idx]
        inst.auto_prot_models[gid] = name
        inst.auto_prot_freqs[gid] = "empirical" if use_emp else "fixed"
        _install(inst, gid, name, use_emp)
        log(f"partition {gid} best-scoring AA model: {name} "
            f"(lnL {emp_lnl[gid] if use_emp else fixed_lnl[gid]:.4f}, "
            f"{'empirical' if use_emp else 'fixed'} frequencies, "
            f"{criterion.upper()})")
    inst.push_models()

    tree.reset_branches()
    inst.evaluate(tree, full=True)
    tree_evaluate(inst, tree, 2.0)
    if inst.likelihood < start_lnl:
        for gid in autos:
            name, fr = old[gid]
            inst.auto_prot_models[gid] = name
            inst.auto_prot_freqs[gid] = fr
            _install(inst, gid, name, fr == "empirical")
        inst.push_models()
        snap.restore_into(tree)
        inst.evaluate(tree, full=True)
    if inst.likelihood < start_lnl - 1e-6:
        raise RuntimeError(f"auto_protein lowered lnL: {start_lnl} -> "
                           f"{inst.likelihood}")
