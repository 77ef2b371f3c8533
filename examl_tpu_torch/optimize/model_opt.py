"""Model-parameter optimization: GTR rates, alpha, base frequencies, modOpt.

Semantics of the reference's `optimizeModel.c` (`optRatesGeneric` :1634,
`optAlphasGeneric` :1136, `optBaseFreqs` :1501, `modOpt` :2963-3133): each
parameter is optimized by 1-D Brent over linkage groups (default: every
partition its own group; amino-acid GTR partitions share one rate group,
ref `initLinkageListGTR` :260), with base frequencies parameterized as
softmax exponents, and the whole cycle repeated until the lnL gain drops
below the caller's epsilon.  All groups' Brent probes are batched into one
evaluation per step (see optimize/brent.py); every probe is a full
traversal on the engines' `newview` tier.

The port of `examl_tpu/optimize/model_opt.py`, under GAMMA or PSR: GTR
rates, empirical protein matrices (rates fixed), LG4M (alpha) and LG4X
(free category rates and weights, `opt_lg4x`), and AUTO partitions'
matrix choice (`optimize/auto_protein.py`) once per round.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List, Sequence

import numpy as np

from examl_tpu_torch import obs
from examl_tpu_torch.constants import ALPHA_MAX, ALPHA_MIN, RATE_MAX, RATE_MIN
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.models.gtr import (n_exchange, with_alpha, with_freqs,
                                        with_rates)
from examl_tpu_torch.models.lg4 import (LG4X_RATE_MAX, LG4X_RATE_MIN,
                                        LG4Params, lg4_with_alpha,
                                        lg4x_with_rates, lg4x_with_weights)
from examl_tpu_torch.optimize.auto_protein import auto_protein
from examl_tpu_torch.optimize.branch import tree_evaluate
from examl_tpu_torch.optimize.brent import minimize_vector
from examl_tpu_torch.optimize.psr import (MAX_CAT_ROUNDS,
                                          optimize_rate_categories,
                                          refine_category_rates)
from examl_tpu_torch.resilience import heartbeat
from examl_tpu_torch.tree.topology import Tree

MODEL_EPSILON = 0.0001
FREQ_EXP_MIN = -1.0e6
FREQ_EXP_MAX = 200.0


def _group_lnl(inst: PhyloInstance, groups: Sequence[List[int]]) -> np.ndarray:
    return np.array([sum(inst.per_partition_lnl[g] for g in grp)
                     for grp in groups])


def _opt_param(inst: PhyloInstance, tree: Tree, groups: Sequence[List[int]],
               get0: Callable[[int], float],
               setv: Callable[[int, float], None],
               lim_inf: float, lim_sup: float,
               tol: float = MODEL_EPSILON, only_states=None,
               coherent: bool = False) -> None:
    """Optimize one scalar parameter per linkage group by batched Brent.

    get0(gid) reads the current value from partition gid; setv(gid, v)
    installs a trial value into inst.models[gid] (without device push).
    Accept-if-improved per group, as the reference's optParamGeneric.
    Brent probes touch only the affected state buckets (only_states);
    the final evaluate is unrestricted so all engines end coherent.
    coherent=True promises per_partition_lnl already matches the current
    models+tree (skips the leading full evaluate).
    """
    if not groups:
        return
    if not coherent:
        inst.evaluate(tree, full=True)
    start_lnl = _group_lnl(inst, groups)
    x0 = np.array([get0(grp[0]) for grp in groups])

    def fn(xs: np.ndarray) -> np.ndarray:
        for grp, v in zip(groups, xs):
            for gid in grp:
                setv(gid, float(v))
        inst.push_models(only_states)
        inst.evaluate(tree, full=True, only_states=only_states)
        return -_group_lnl(inst, groups)

    xb, fb = minimize_vector(x0, np.full(len(groups), lim_inf),
                             np.full(len(groups), lim_sup), fn, tol)
    # Accept per group only if improved; otherwise restore.
    for grp, v0, v1, f1, l0 in zip(groups, x0, xb, fb, start_lnl):
        v = v1 if -f1 > l0 else v0
        for gid in grp:
            setv(gid, float(v))
    inst.push_models()
    inst.evaluate(tree, full=True)


def _rate_groups(inst: PhyloInstance, states: int) -> List[List[int]]:
    """Linkage groups for rate optimization within one state bucket:
    unlinked, except all amino-acid GTR partitions share one group."""
    groups: List[List[int]] = []
    gtr_group: List[int] = []
    for gid, part in enumerate(inst.alignment.partitions):
        if part.states != states:
            continue
        if part.datatype.name == "AA" and part.model_name != "GTR":
            continue                      # empirical matrix: rates fixed
        if part.datatype.name == "AA":
            gtr_group.append(gid)
        else:
            groups.append([gid])
    if gtr_group:
        groups.append(gtr_group)
    return groups


def opt_rates(inst: PhyloInstance, tree: Tree,
              tol: float = MODEL_EPSILON) -> None:
    """Brent over every free exchangeability (last one fixed at 1.0)."""
    for states in sorted(inst.buckets):
        groups = _rate_groups(inst, states)
        if not groups:
            continue
        nrates = n_exchange(states) - 1   # last exchangeability pinned
        for k in range(nrates):
            def get0(gid, k=k):
                return float(inst.models[gid].rates[k])

            def setv(gid, v, k=k):
                m = inst.models[gid]
                rates = m.rates.copy()
                rates[k] = v
                inst.models[gid] = with_rates(m, rates)

            _opt_param(inst, tree, groups, get0, setv, RATE_MIN, RATE_MAX,
                       tol, only_states={states}, coherent=k > 0)


def opt_alphas(inst: PhyloInstance, tree: Tree,
               tol: float = MODEL_EPSILON) -> None:
    """Gamma-shape Brent for every partition except LG4X (whose category
    rates are free parameters optimized by opt_lg4x instead)."""
    groups = [[gid] for gid in range(inst.num_parts)
              if not (isinstance(inst.models[gid], LG4Params)
                      and inst.models[gid].is_lg4x)]
    if not groups:
        return

    def get0(gid):
        return float(inst.models[gid].alpha)

    def setv(gid, v):
        m = inst.models[gid]
        inst.models[gid] = (lg4_with_alpha(m, v)
                            if isinstance(m, LG4Params) else with_alpha(m, v))

    _opt_param(inst, tree, groups, get0, setv, ALPHA_MIN, ALPHA_MAX, tol)


def opt_lg4x(inst: PhyloInstance, tree: Tree,
             tol: float = MODEL_EPSILON) -> None:
    """LG4X free category rates + weights (reference `optLG4X` +
    `optimizeWeights`, `optimizeModel.c:1114-1132`): per round, Brent each
    of the 4 rates then each of the 4 weight exponents."""
    gids = [gid for gid in range(inst.num_parts)
            if isinstance(inst.models[gid], LG4Params)
            and inst.models[gid].is_lg4x]
    if not gids:
        return
    groups = [[g] for g in gids]

    # Trial rate vectors derive from a per-k base snapshot, not from the
    # trial-mutated model: normalization rescales all four rates, so the
    # objective must be a pure function of the Brent variable and the
    # reject-restore (setv(v0)) must reproduce the base exactly.
    for k in range(4):
        base = {g: np.asarray(inst.models[g].gamma_rates).copy()
                for g in gids}

        def get0(gid, k=k):
            return float(base[gid][k])

        def setv(gid, v, k=k):
            rates = base[gid].copy()
            rates[k] = v
            inst.models[gid] = lg4x_with_rates(inst.models[gid], rates)

        _opt_param(inst, tree, groups, get0, setv, LG4X_RATE_MIN,
                   LG4X_RATE_MAX, tol, only_states={20}, coherent=k > 0)

    exponents = {g: np.log(np.maximum(inst.models[g].rate_weights, 1e-12))
                 for g in gids}
    for k in range(4):
        def get0(gid, k=k):
            return float(exponents[gid][k])

        def setv(gid, v, k=k):
            exponents[gid][k] = v
            e = exponents[gid] - exponents[gid].max()
            inst.models[gid] = lg4x_with_weights(inst.models[gid],
                                                 np.exp(e))

        _opt_param(inst, tree, groups, get0, setv, FREQ_EXP_MIN,
                   FREQ_EXP_MAX, tol, only_states={20}, coherent=True)


def opt_freqs(inst: PhyloInstance, tree: Tree,
              tol: float = MODEL_EPSILON) -> None:
    """Softmax-exponent frequency optimization for X-flagged partitions."""
    for states in sorted(inst.buckets):
        gids = [gid for gid, p in enumerate(inst.alignment.partitions)
                if p.states == states and p.optimize_freqs]
        if not gids:
            continue
        groups = [[g] for g in gids]
        exponents = {g: np.log(np.maximum(inst.models[g].freqs, 1e-12))
                     for g in gids}
        for k in range(states):
            def get0(gid, k=k):
                return float(exponents[gid][k])

            def setv(gid, v, k=k):
                exponents[gid][k] = v
                e = exponents[gid] - exponents[gid].max()
                freqs = np.exp(e) / np.exp(e).sum()
                inst.models[gid] = with_freqs(inst.models[gid], freqs)

            _opt_param(inst, tree, groups, get0, setv,
                       FREQ_EXP_MIN, FREQ_EXP_MAX, tol, only_states={states},
                       coherent=k > 0)


def mod_opt(inst: PhyloInstance, tree: Tree, likelihood_epsilon: float,
            max_rounds: int = 100, auto_protein_fn=None,
            checkpoint_cb=None) -> float:
    """Round-robin parameter optimization until Delta lnL < epsilon
    (reference `modOpt`, `optimizeModel.c:2963-3133`).  Under GAMMA the
    rate-heterogeneity step is the alpha Brent, then LG4X's free category
    rates and weights; under PSR it is a rate categorization round,
    capped at 3 per call as the reference's `catOpt < 3`
    (`optimizeModel.c:3100-3110`), after which the categories' rates are
    refined as continuous parameters (`psr.refine_category_rates`).
    AUTO partitions choose their matrix after the rates in every round
    (`auto_protein_fn`, by default `auto_protein` under the instance's
    `auto_prot_criterion`).

    checkpoint_cb(state, extras), when given, is invoked after every
    optimization round — the reference's MOD_OPT checkpoint cadence in
    tree-evaluation mode (`optimizeModel.c:2995-3010`, `axml.h:655-659`)."""
    inst.evaluate(tree, full=True)
    if inst.psr:
        inst.cat_opt_rounds = 0
    if auto_protein_fn is None and any(
            p.auto for p in inst.alignment.partitions):
        auto_protein_fn = partial(auto_protein,
                                  criterion=inst.auto_prot_criterion)
    rounds = 0
    while max_rounds > 0:
        max_rounds -= 1
        current = inst.likelihood
        rounds += 1
        obs.inc("search.model_opt_rounds")
        # Optimizer rounds are search-loop iterations too: a wedge inside
        # one must freeze the liveness clock (resilience/heartbeat.py).
        heartbeat.beat("MOD_OPT")
        with obs.span("opt:model_opt_round", args={"round": rounds}):
            opt_rates(inst, tree)
            if auto_protein_fn is not None:
                auto_protein_fn(inst, tree)
            tree_evaluate(inst, tree, 0.0625)
            opt_freqs(inst, tree)
            tree_evaluate(inst, tree, 0.0625)
            if inst.psr:
                if inst.cat_opt_rounds < MAX_CAT_ROUNDS:
                    optimize_rate_categories(inst, tree)
                    inst.cat_opt_rounds += 1
                else:
                    refine_category_rates(inst, tree)
            else:
                opt_alphas(inst, tree)
                opt_lg4x(inst, tree)
                tree_evaluate(inst, tree, 0.1)
        if checkpoint_cb is not None:
            checkpoint_cb("MOD_OPT", {})
        if abs(current - inst.likelihood) <= likelihood_epsilon:
            break
    return inst.likelihood
