"""RAxML hill-climbing search: SPR cycles, radius auto-tune, main loop.

Reference semantics: `treeOptimizeRapid` (ExaML `searchAlgo.c:914-1036`),
`determineRearrangementSetting` (:1752-1912), `computeBIGRAPID`
(:1914-2631).  The lnL-cutoff heuristic, 20-best-tree re-scoring, lazy→
thorough two-phase cycle, and radius escalation schedule are preserved;
checkpoint writes and RF-convergence checks are injected via callbacks so
the checkpoint and bipartition subsystems stay decoupled.

The port of `examl_tpu/search/raxml_search.py`, with its `search:*` spans,
`search.*` counters and heartbeats; `rearrange` is `spr.rearrange_auto`
(the batched scan on the card, the sequential arm on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from examl_tpu_torch import obs
from examl_tpu_torch.constants import UNLIKELY
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.optimize.branch import tree_evaluate
from examl_tpu_torch.optimize.model_opt import mod_opt
from examl_tpu_torch.resilience import heartbeat
from examl_tpu_torch.search.snapshots import BestList, InfoList
from examl_tpu_torch.search.spr import (SprContext, dfs_slot_order,
                                        rearrange_auto as rearrange,
                                        restore_tree_fast,
                                        save_candidate_topology)
from examl_tpu_torch.tree.topology import Tree

MAX_FAST_RADIUS = 26       # radius scan tries 5,10,...,25 (ref :1755)
MAX_REARRANGE = 21         # slow-SPR radius ceiling
STEPWIDTH = 5              # slow-SPR radius increment


@dataclass
class SearchOptions:
    """Search-relevant subset of the reference `analdef` (axml.c:680-700)."""
    initial: int = 10                  # -i rearrangement radius
    initial_set: bool = False          # user fixed the radius
    save_best_trees: int = 0           # -B
    constraint: object = None          # TreeConstraint (-g)
    do_cutoff: bool = True             # lnL cutoff heuristic (no -f o flag)
    search_convergence: bool = False   # -D RF criterion
    # Note: the reference's -e likelihoodEpsilon does NOT enter the search;
    # its modOpt schedule is fixed at 10/5/1 (searchAlgo.c:1996,2038,2327).
    log: Callable[[str], None] = field(default=lambda msg: None)


class SearchResult:
    def __init__(self):
        self.likelihood = UNLIKELY
        self.fast_iterations = 0
        self.thorough_iterations = 0
        self.best_trav = 0
        self.converged_by_rf = False
        self.good_trees: List = []


def tree_optimize_rapid(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                        mintrav: int, maxtrav: int,
                        bt: BestList, best_ml: Optional[BestList],
                        ilist: InfoList) -> float:
    """One SPR cycle over all nodes (reference `treeOptimizeRapid`)."""
    obs.inc("search.spr_cycles")
    with obs.span("search:spr_cycle",
                  args={"mintrav": mintrav, "maxtrav": maxtrav,
                        "thorough": bool(ctx.thorough)}):
        return _tree_optimize_rapid(inst, tree, ctx, mintrav, maxtrav, bt,
                                    best_ml, ilist)


def _tree_optimize_rapid(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                         mintrav: int, maxtrav: int,
                         bt: BestList, best_ml: Optional[BestList],
                         ilist: InfoList) -> float:
    slots = dfs_slot_order(tree)
    maxtrav = min(maxtrav, tree.ntips - 3)
    ilist.reset()
    bt.reset()
    ctx.start_lh = ctx.end_lh = inst.likelihood

    if ctx.do_cutoff:
        if ctx.it_count == 0:
            ctx.lh_cutoff = inst.likelihood / -1000.0
        elif ctx.lh_dec > 0:
            ctx.lh_cutoff = ctx.lh_avg / ctx.lh_dec
        else:
            # No scored insertion decreased lnL last cycle: disable the
            # cutoff (the reference's 0/0 makes its >= test always false).
            ctx.lh_cutoff = float("inf")
        ctx.it_count += 1
        ctx.lh_avg = 0.0
        ctx.lh_dec = 0

    for p in slots:
        # Liveness beat per SPR slot: every beat proves the previous
        # slot's dispatches returned.
        heartbeat.beat("SPR_THOROUGH" if ctx.thorough else "SPR_LAZY")
        ctx.best_of_node = UNLIKELY
        if not rearrange(inst, tree, ctx, p, mintrav, maxtrav):
            continue
        if ctx.thorough:
            if ctx.end_lh > ctx.start_lh:
                restore_tree_fast(inst, tree, ctx)
                ctx.start_lh = ctx.end_lh = inst.likelihood
                bt.save(tree, inst.likelihood)
                if best_ml is not None:
                    best_ml.save(tree, inst.likelihood)
            elif ctx.best_of_node != UNLIKELY:
                save_candidate_topology(inst, tree, ctx, bt, best_ml)
        else:
            ilist.insert(p, ctx.best_of_node)
            if ctx.end_lh > ctx.start_lh:
                restore_tree_fast(inst, tree, ctx)
                ctx.start_lh = ctx.end_lh = inst.likelihood

    if not ctx.thorough:
        # Thorough re-pass over the best lazy-insertion origins (iList).
        ctx.thorough = True
        for p in ilist.active_nodes():
            heartbeat.beat("SPR_REPASS")
            ctx.best_of_node = UNLIKELY
            if not rearrange(inst, tree, ctx, p, mintrav, maxtrav):
                continue
            if ctx.end_lh > ctx.start_lh:
                restore_tree_fast(inst, tree, ctx)
                ctx.start_lh = ctx.end_lh = inst.likelihood
                bt.save(tree, inst.likelihood)
                if best_ml is not None:
                    best_ml.save(tree, inst.likelihood)
            elif ctx.best_of_node != UNLIKELY:
                save_candidate_topology(inst, tree, ctx, bt, best_ml)
        ctx.thorough = False

    return ctx.start_lh


def determine_rearrangement_setting(inst: PhyloInstance, tree: Tree,
                                    ctx: SprContext, opts: SearchOptions,
                                    best_t: BestList, bt: BestList,
                                    best_ml: Optional[BestList],
                                    checkpoint_cb=None) -> int:
    """Scan radii 5,10,...,25 on the starting tree; return the smallest
    radius attaining the best lnL (reference
    `determineRearrangementSetting`)."""
    with obs.span("search:radius_autotune"):
        return _determine_rearrangement_setting(
            inst, tree, ctx, opts, best_t, bt, best_ml, checkpoint_cb)


def _determine_rearrangement_setting(inst, tree, ctx, opts, best_t, bt,
                                     best_ml, checkpoint_cb=None) -> int:
    maxtrav, best_trav = 5, 5
    start_lh = inst.likelihood
    impr = True
    cutoff_saved = ctx.do_cutoff
    ctx.do_cutoff = False
    bt.reset()

    while impr and maxtrav < MAX_FAST_RADIUS:
        best_t.recall(inst, tree, 1)
        if checkpoint_cb is not None:
            checkpoint_cb("REARR_SETTING", dict(
                maxtrav=maxtrav, best_trav=best_trav, start_lh=start_lh,
                impr=impr, cutoff=cutoff_saved))
        maxtrav = min(maxtrav, tree.ntips - 3)
        ctx.start_lh = ctx.end_lh = inst.likelihood
        for p in dfs_slot_order(tree):
            heartbeat.beat("REARR_SETTING")
            ctx.best_of_node = UNLIKELY
            if rearrange(inst, tree, ctx, p, 1, maxtrav):
                if ctx.end_lh > ctx.start_lh:
                    restore_tree_fast(inst, tree, ctx)
                    ctx.start_lh = ctx.end_lh = inst.likelihood
        tree_evaluate(inst, tree, 0.25)
        bt.save(tree, inst.likelihood)
        if best_ml is not None:
            best_ml.save(tree, inst.likelihood)
        if inst.likelihood > start_lh:
            start_lh = inst.likelihood
            best_trav = maxtrav
            impr = True
        else:
            impr = False
        maxtrav += 5

    bt.recall(inst, tree, 1)
    ctx.do_cutoff = cutoff_saved
    return best_trav


def compute_big_rapid(inst: PhyloInstance, tree: Tree,
                      opts: Optional[SearchOptions] = None,
                      convergence_cb=None, checkpoint_cb=None,
                      resume=None) -> SearchResult:
    """The full hill-climbing search (reference `computeBIGRAPID`).

    convergence_cb(tree, phase, iteration) -> bool implements the -D RF
    criterion; checkpoint_cb(state_name, extras) writes checkpoints; resume
    is a restart blob from the checkpoint subsystem (search/checkpoint.py).
    """
    opts = opts or SearchOptions()
    res = SearchResult()
    ctx = SprContext(inst, do_cutoff=opts.do_cutoff)
    ctx.constraint = opts.constraint
    best_t = BestList(1)
    bt = BestList(20)
    best_ml = BestList(opts.save_best_trees) if opts.save_best_trees else None
    ilist = InfoList(50)

    difference = 10.0
    epsilon = 0.01
    lh = previous_lh = UNLIKELY
    best_trav = opts.initial
    fast_iterations = 0
    thorough_iterations = 0
    rearr_min = rearr_max = 0
    state = resume["state"] if resume else None

    def ckpt(name: str, extras: dict) -> None:
        if checkpoint_cb is None:
            return
        merged = dict(
            best_trav=best_trav, lh=lh, previous_lh=previous_lh,
            difference=difference, epsilon=epsilon,
            fast_iterations=fast_iterations,
            thorough_iterations=thorough_iterations,
            rearr_min=rearr_min, rearr_max=rearr_max,
            it_count=ctx.it_count, lh_cutoff=ctx.lh_cutoff,
            lh_avg=ctx.lh_avg, lh_dec=ctx.lh_dec,
            likelihood=inst.likelihood, best_t=best_t.to_dict())
        merged.update(extras)        # phase-specific values win
        checkpoint_cb(name, merged)

    if resume and state == "REARR_SETTING":
        # Radius determination is cheap relative to the SPR phases: restore
        # the best tree seen and redo the pre-fast sequence from there
        # (the reference re-enters mid-scan; the search outcome only
        # depends on the returned radius).
        blob = resume["extras"]
        if "best_t" in blob and blob["best_t"]["entries"]:
            best_t.load_dict(blob["best_t"], tree)
            best_t.recall(inst, tree, 1)
        else:
            # Older/minimal checkpoint: the checkpoint's own tree (already
            # restored into `tree` by CheckpointManager.restore) is the
            # best known state.
            best_t.save(tree, inst.likelihood)
        best_trav = determine_rearrangement_setting(
            inst, tree, ctx, opts, best_t, bt, best_ml, ckpt)
        opts.log(f"best rearrangement radius: {best_trav}")
        mod_opt(inst, tree, 5.0)
        best_t.save(tree, inst.likelihood)
        state = None
    elif resume:
        blob = resume["extras"]
        best_trav = blob.get("best_trav", opts.initial)
        lh = blob.get("lh", UNLIKELY)
        previous_lh = blob.get("previous_lh", UNLIKELY)
        difference = blob.get("difference", 10.0)
        epsilon = blob.get("epsilon", 0.01)
        fast_iterations = blob.get("fast_iterations", 0)
        thorough_iterations = blob.get("thorough_iterations", 0)
        rearr_min = blob.get("rearr_min", 0)
        rearr_max = blob.get("rearr_max", 0)
        ctx.it_count = blob.get("it_count", 0)
        ctx.lh_cutoff = blob.get("lh_cutoff", 0.0)
        ctx.lh_avg = blob.get("lh_avg", 0.0)
        ctx.lh_dec = blob.get("lh_dec", 0)
        if "best_t" in blob:
            best_t.load_dict(blob["best_t"], tree)
            best_t.recall(inst, tree, 1)
    else:
        mod_opt(inst, tree, 10.0)
        opts.log(f"initial lnL {inst.likelihood:.6f}")
        best_t.save(tree, inst.likelihood)

        if opts.initial_set:
            best_trav = opts.initial
            opts.log(f"user-defined rearrangement radius: {best_trav}")
        else:
            best_trav = determine_rearrangement_setting(
                inst, tree, ctx, opts, best_t, bt, best_ml, ckpt)
            opts.log(f"best rearrangement radius: {best_trav}")

        mod_opt(inst, tree, 5.0)
        best_t.save(tree, inst.likelihood)

    res.best_trav = best_trav
    impr = True
    if ctx.do_cutoff:
        ctx.it_count = 0

    # ---- fast (lazy) SPR loop --------------------------------------------
    if state in (None, "FAST_SPRS"):
        while impr:
            if state == "FAST_SPRS":
                state = None
            else:
                best_t.recall(inst, tree, 1)
            ckpt("FAST_SPRS", dict(impr=impr))

            if opts.search_convergence and convergence_cb is not None:
                if convergence_cb(tree, "fast", fast_iterations):
                    opts.log(f"fast search RF-converged at cycle "
                             f"{fast_iterations}")
                    res.converged_by_rf = True
                    break

            fast_iterations += 1
            obs.inc("search.fast_cycles")
            heartbeat.beat("FAST_SPRS")
            tree_evaluate(inst, tree, 1.0)
            best_t.save(tree, inst.likelihood)
            opts.log(f"fast cycle {fast_iterations} start "
                     f"lnL {inst.likelihood:.6f}")
            lh = previous_lh = inst.likelihood

            tree_optimize_rapid(inst, tree, ctx, 1, best_trav, bt,
                                best_ml, ilist)

            impr = False
            for i in range(1, bt.nvalid + 1):
                bt.recall(inst, tree, i)
                tree_evaluate(inst, tree, 0.25)
                difference = abs(inst.likelihood - previous_lh)
                if inst.likelihood > lh and difference > epsilon:
                    impr = True
                    lh = inst.likelihood
                    best_t.save(tree, inst.likelihood)

    res.fast_iterations = fast_iterations

    # ---- thorough (slow) SPR loop ----------------------------------------
    ctx.thorough = True
    impr = True
    if state != "SLOW_SPRS":
        best_t.recall(inst, tree, 1)
        inst.evaluate(tree, full=True)
        mod_opt(inst, tree, 1.0)

    while True:
        if state == "SLOW_SPRS":
            state = None
            impr = resume["extras"].get("impr", True)
        else:
            best_t.recall(inst, tree, 1)
        ckpt("SLOW_SPRS", dict(impr=impr))

        if impr:
            rearr_min = 1
            rearr_max = STEPWIDTH
            if opts.search_convergence and convergence_cb is not None:
                if convergence_cb(tree, "thorough", thorough_iterations):
                    opts.log(f"search RF-converged at thorough cycle "
                             f"{thorough_iterations}")
                    res.converged_by_rf = True
                    break
            thorough_iterations += 1
            obs.inc("search.thorough_cycles")
            heartbeat.beat("SLOW_SPRS")
        else:
            rearr_max += STEPWIDTH
            rearr_min += STEPWIDTH
            if rearr_max > MAX_REARRANGE:
                break

        tree_evaluate(inst, tree, 1.0)
        previous_lh = lh = inst.likelihood
        best_t.save(tree, inst.likelihood)
        opts.log(f"thorough cycle {thorough_iterations} radius "
                 f"{rearr_min}-{rearr_max} lnL {inst.likelihood:.6f}")

        tree_optimize_rapid(inst, tree, ctx, rearr_min, rearr_max, bt,
                            best_ml, ilist)

        impr = False
        for i in range(1, bt.nvalid + 1):
            bt.recall(inst, tree, i)
            tree_evaluate(inst, tree, 0.25)
            difference = abs(inst.likelihood - previous_lh)
            if inst.likelihood > lh and difference > epsilon:
                impr = True
                lh = inst.likelihood
                best_t.save(tree, inst.likelihood)

    # ---- finish ----------------------------------------------------------
    res.thorough_iterations = thorough_iterations
    inst.evaluate(tree, full=True)
    res.likelihood = inst.likelihood
    opts.log(f"likelihood of best tree: {inst.likelihood:.6f}")
    if best_ml is not None:
        res.good_trees = list(best_ml.entries)
    return res
