"""SPR move primitives: prune, regraft, scored test-insertion, radius scan.

Host-side re-implementation of the reference's SPR machinery (ExaML
`searchAlgo.c`): `removeNodeBIG` :442, `insertBIG` :484, `testInsertBIG`
:682, `addTraverseBIG` :785, `rearrangeBIG` :804, `restoreTreeFast` :1095,
`restoreTopologyOnly` :612.  Tree surgery is pure host bookkeeping; every
scored insertion costs one partial CLV traversal + one root evaluation on
device (the innermost step of the search, SURVEY §3.4).

The `lazy` mode (reference `Thorough == 0`) regrafts with sqrt-combined
branch lengths and no Newton-Raphson; thorough mode optimizes the three
branches around the insertion point (triangle solve + local smoothing).

The port of `examl_tpu/search/spr.py`.  Two arms score the candidates
of a pruned node: the sequential one (`rearrange`, the JAX package's
`EXAML_BATCH_SCAN=0` semantics) one at a time with the lnL-cutoff
early-outs, and the batched one (`rearrange_batched`,
search/batchscan.py) the whole radius window in one engine call per
pruned endpoint, lazy or thorough.  `rearrange_auto` picks between them
as the JAX package does: batched where the arenas live on the card
(or as `PhyloInstance(batch_scan=..., batch_thorough=...)` forces),
sequential on the CPU.  The partial traversals of both run on the
engines' wave-scan tier.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from examl_tpu_torch import obs
from examl_tpu_torch.constants import DEFAULTZ, SMOOTHINGS, UNLIKELY, ZMAX, ZMIN
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.optimize.branch import local_smooth
from examl_tpu_torch.search import batchscan
from examl_tpu_torch.tree.topology import Node, Tree, hookup
from examl_tpu_torch.utils import z_slots

SPR_NR_ITERATIONS = 10      # NR iterations per insertion branch (ref axml.h:90)
# Candidate insertions scored, by test_insert or by the batched arm (a
# plain count, read by chip_smoke.py).
INSERTIONS_SCORED = 0


class SprContext:
    """Per-search mutable state (the search-related fields of the reference
    `tree` struct: startLH/endLH/bestOfNode, saved branch vectors, the lnL
    cutoff heuristic counters, and the Thorough flag)."""

    def __init__(self, inst: PhyloInstance, thorough: bool = False,
                 do_cutoff: bool = True):
        C = inst.num_branch_slots
        self.thorough = thorough
        self.start_lh = UNLIKELY
        self.end_lh = UNLIKELY
        self.best_of_node = UNLIKELY
        self.remove_node: Optional[Node] = None
        self.insert_node: Optional[Node] = None
        # Branch vectors of the current/best candidate move.
        self.zqr = np.full(C, DEFAULTZ)
        self.current_zqr = np.full(C, DEFAULTZ)
        self.current_lzq = np.full(C, DEFAULTZ)
        self.current_lzr = np.full(C, DEFAULTZ)
        self.current_lzs = np.full(C, DEFAULTZ)
        self.lzq = np.full(C, DEFAULTZ)
        self.lzr = np.full(C, DEFAULTZ)
        self.lzs = np.full(C, DEFAULTZ)
        # lnL cutoff heuristic (reference doCutoff/lhCutoff/lhAVG/lhDEC).
        self.do_cutoff = do_cutoff
        self.lh_cutoff = 0.0
        self.lh_avg = 0.0
        self.lh_dec = 0
        self.it_count = 0
        # Constraint checking hook (set when a constraint tree is loaded)
        # + the pruned subtree's cluster set, cached per prune.
        self.constraint = None
        self.pruned_clusters = None


def _zvec(inst: PhyloInstance, z) -> np.ndarray:
    return z_slots(z, inst.num_branch_slots)


def remove_node(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                p: Node) -> Node:
    """Prune the subtree hanging off p's cycle; join q--r with an optimized
    branch (reference `removeNodeBIG`)."""
    q = p.next.back
    r = p.next.next.back
    zqr = _zvec(inst, q.z) * _zvec(inst, r.z)
    result = inst.makenewz(tree, q, r, zqr, maxiter=SPR_NR_ITERATIONS)
    ctx.zqr = result.copy()
    hookup(q, r, result.tolist())
    p.next.back = None
    p.next.next.back = None
    if ctx.constraint is not None:
        ctx.pruned_clusters = ctx.constraint.clusters_behind(p.back)
    return q


def remove_node_restore(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                        p: Node) -> Node:
    """Prune again along the best-known move, reusing the saved q--r branch
    (reference `removeNodeRestoreBIG`)."""
    q = p.next.back
    r = p.next.next.back
    inst.new_view(tree, q)
    inst.new_view(tree, r)
    hookup(q, r, ctx.current_zqr.tolist())
    p.next.back = None
    p.next.next.back = None
    return q


def _triangle_branches(inst, tree, ctx, p: Node, q: Node):
    """Thorough insertion: NR-optimize the three pairwise virtual branches
    then solve the star triangle for the branches around p
    (reference `insertBIG` Thorough arm, `searchAlgo.c:495-533`)."""
    r = q.back
    s = p.back
    default = np.full(inst.num_branch_slots, DEFAULTZ)
    zqr = inst.makenewz(tree, q, r, _zvec(inst, q.z),
                        maxiter=SPR_NR_ITERATIONS)
    zqs = inst.makenewz(tree, q, s, default, maxiter=SPR_NR_ITERATIONS)
    zrs = inst.makenewz(tree, r, s, default, maxiter=SPR_NR_ITERATIONS)

    lzqr = np.log(np.maximum(zqr, ZMIN))
    lzqs = np.log(np.maximum(zqs, ZMIN))
    lzrs = np.log(np.maximum(zrs, ZMIN))
    lzsum = 0.5 * (lzqr + lzqs + lzrs)
    lzq = lzsum - lzrs
    lzr = lzsum - lzqs
    lzs = lzsum - lzqr
    lzmax = np.log(ZMAX)
    e1, e2, e3 = np.exp(lzq), np.exp(lzr), np.exp(lzs)
    # Degenerate triangles: pin the overshooting branch at zmax and fall
    # back to the pairwise estimates for the other two.
    for i in range(len(e1)):
        if lzq[i] > lzmax:
            e1[i], e2[i], e3[i] = ZMAX, zqr[i], zqs[i]
        elif lzr[i] > lzmax:
            e2[i], e1[i], e3[i] = ZMAX, zqr[i], zrs[i]
        elif lzs[i] > lzmax:
            e3[i], e1[i], e2[i] = ZMAX, zqs[i], zrs[i]
    return e1, e2, e3


def insert_node(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                p: Node, q: Node) -> None:
    """Regraft the pruned subtree at branch (q, q.back)
    (reference `insertBIG`)."""
    r = q.back
    s = p.back
    if ctx.thorough:
        e1, e2, e3 = _triangle_branches(inst, tree, ctx, p, q)
        hookup(p.next, q, e1.tolist())
        hookup(p.next.next, r, e2.tolist())
        hookup(p, s, e3.tolist())
    else:
        z = np.clip(np.sqrt(_zvec(inst, q.z)), ZMIN, ZMAX)
        hookup(p.next, q, z.tolist())
        hookup(p.next.next, r, z.tolist())
    inst.new_view(tree, p)
    if ctx.thorough:
        local_smooth(inst, tree, p, SMOOTHINGS)
        ctx.lzq = _zvec(inst, p.next.z)
        ctx.lzr = _zvec(inst, p.next.next.z)
        ctx.lzs = _zvec(inst, p.z)


def insert_node_restore(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                        p: Node, q: Node) -> None:
    """Regraft along the best-known move with its saved branch vectors
    (reference `insertRestoreBIG`)."""
    r = q.back
    s = p.back
    if ctx.thorough:
        hookup(p.next, q, ctx.current_lzq.tolist())
        hookup(p.next.next, r, ctx.current_lzr.tolist())
        hookup(p, s, ctx.current_lzs.tolist())
    else:
        z = np.clip(np.sqrt(_zvec(inst, q.z)), ZMIN, ZMAX)
        hookup(p.next, q, z.tolist())
        hookup(p.next.next, r, z.tolist())
    inst.new_view(tree, p)


def test_insert(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                p: Node, q: Node) -> bool:
    """Score regrafting at (q, q.back), record if best, undo
    (reference `testInsertBIG`).  Returns False to stop descending deeper
    along this path (lnL-cutoff heuristic)."""
    global INSERTIONS_SCORED
    r = q.back
    start_lh = ctx.end_lh
    qz = list(q.z)
    pz = list(p.z)

    if ctx.constraint is not None and not ctx.constraint.insertion_ok(
            p, q, ctx.pruned_clusters):
        return True

    insert_node(inst, tree, ctx, p, q)
    lnl = inst.evaluate(tree, p.next.next)
    INSERTIONS_SCORED += 1

    if lnl > ctx.best_of_node:
        ctx.best_of_node = lnl
        ctx.insert_node = q
        ctx.remove_node = p
        ctx.current_zqr = ctx.zqr.copy()
        ctx.current_lzq = ctx.lzq.copy()
        ctx.current_lzr = ctx.lzr.copy()
        ctx.current_lzs = ctx.lzs.copy()
    if lnl > ctx.end_lh:
        ctx.insert_node = q
        ctx.remove_node = p
        ctx.current_zqr = ctx.zqr.copy()
        ctx.end_lh = lnl

    # Undo: detach p, re-join q--r with its pre-insertion branch.
    hookup(q, r, qz)
    p.next.back = None
    p.next.next.back = None
    if ctx.thorough:
        hookup(p, p.back, pz)

    if ctx.do_cutoff and lnl < start_lh:
        ctx.lh_avg += start_lh - lnl
        ctx.lh_dec += 1
        return (start_lh - lnl) < ctx.lh_cutoff
    return True


def test_insert_restore(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                        p: Node, q: Node) -> None:
    """Re-apply the recorded best move for keeps
    (reference `testInsertRestoreBIG`)."""
    if ctx.thorough:
        insert_node(inst, tree, ctx, p, q)
        inst.evaluate(tree, p.next.next)
    else:
        insert_node_restore(inst, tree, ctx, p, q)
        # Refresh the CLV orientations the continuing search will read,
        # without paying for a root evaluation (reference skips it too and
        # trusts endLH).
        x = p.next.next
        y = p.back
        if not tree.is_tip(x.number):
            inst.new_view(tree, x)
        if not tree.is_tip(y.number):
            inst.new_view(tree, y)
        inst.likelihood = ctx.end_lh


def restore_tree_fast(inst: PhyloInstance, tree: Tree,
                      ctx: SprContext) -> None:
    """Commit the best move found for the current pruned node
    (reference `restoreTreeFast`)."""
    remove_node_restore(inst, tree, ctx, ctx.remove_node)
    test_insert_restore(inst, tree, ctx, ctx.remove_node, ctx.insert_node)


def save_candidate_topology(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                            bt, best_ml=None) -> None:
    """Temporarily apply the node's best move just to snapshot the topology
    into the best-tree lists, then restore the tree exactly
    (reference `restoreTopologyOnly`)."""
    p = ctx.remove_node
    q = ctx.insert_node
    p1 = p.next.back
    p2 = p.next.next.back
    p1z = list(p1.z)
    p2z = list(p2.z)
    hookup(p1, p2, ctx.current_zqr.tolist())
    p.next.back = None
    p.next.next.back = None
    qz = list(q.z)
    pz = list(p.z)
    r = q.back
    s = p.back
    if ctx.thorough:
        hookup(p.next, q, ctx.current_lzq.tolist())
        hookup(p.next.next, r, ctx.current_lzr.tolist())
        hookup(p, s, ctx.current_lzs.tolist())
    else:
        z = np.clip(np.sqrt(np.asarray(qz)), ZMIN, ZMAX)
        hookup(p.next, q, z.tolist())
        hookup(p.next.next, r, z.tolist())

    bt.save(tree, ctx.best_of_node)
    if best_ml is not None:
        best_ml.save(tree, ctx.best_of_node)

    # Exact undo.
    hookup(q, r, qz)
    p.next.back = None
    p.next.next.back = None
    if ctx.thorough:
        hookup(p, s, pz)
    hookup(p.next, p1, p1z)
    hookup(p.next.next, p2, p2z)


def add_traverse(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                 p: Node, q: Node, mintrav: int, maxtrav: int) -> None:
    """Recursively test insertions along branches within the radius window
    (reference `addTraverseBIG`)."""
    if mintrav - 1 <= 0:
        if not test_insert(inst, tree, ctx, p, q):
            return
    if not tree.is_tip(q.number) and maxtrav - 1 > 0:
        add_traverse(inst, tree, ctx, p, q.next.back, mintrav - 1, maxtrav - 1)
        add_traverse(inst, tree, ctx, p, q.next.next.back,
                     mintrav - 1, maxtrav - 1)


def rearrange(inst: PhyloInstance, tree: Tree, ctx: SprContext, p: Node,
              mintrav: int, maxtrav: int) -> bool:
    """Try all SPR moves pruning at p (and at p.back) within the radius
    window; the tree is returned to its entry state with only ctx updated
    (reference `rearrangeBIG`)."""
    if maxtrav < 1 or mintrav > maxtrav:
        return False
    q = p.back

    if not tree.is_tip(p.number):
        p1 = p.next.back
        p2 = p.next.next.back
        if not tree.is_tip(p1.number) or not tree.is_tip(p2.number):
            p1z = list(p1.z)
            p2z = list(p2.z)
            remove_node(inst, tree, ctx, p)
            if not tree.is_tip(p1.number):
                add_traverse(inst, tree, ctx, p, p1.next.back,
                             mintrav, maxtrav)
                add_traverse(inst, tree, ctx, p, p1.next.next.back,
                             mintrav, maxtrav)
            if not tree.is_tip(p2.number):
                add_traverse(inst, tree, ctx, p, p2.next.back,
                             mintrav, maxtrav)
                add_traverse(inst, tree, ctx, p, p2.next.next.back,
                             mintrav, maxtrav)
            hookup(p.next, p1, p1z)
            hookup(p.next.next, p2, p2z)
            inst.new_view(tree, p)

    if not tree.is_tip(q.number) and maxtrav > 0:
        q1 = q.next.back
        q2 = q.next.next.back
        # Worth pruning q only if the far side has structure to explore
        # (reference's grandchildren test).
        def has_depth(x: Node) -> bool:
            return (not tree.is_tip(x.number)
                    and (not tree.is_tip(x.next.back.number)
                         or not tree.is_tip(x.next.next.back.number)))
        if has_depth(q1) or has_depth(q2):
            q1z = list(q1.z)
            q2z = list(q2.z)
            remove_node(inst, tree, ctx, q)
            mintrav2 = max(mintrav, 2)
            if not tree.is_tip(q1.number):
                add_traverse(inst, tree, ctx, q, q1.next.back,
                             mintrav2, maxtrav)
                add_traverse(inst, tree, ctx, q, q1.next.next.back,
                             mintrav2, maxtrav)
            if not tree.is_tip(q2.number):
                add_traverse(inst, tree, ctx, q, q2.next.back,
                             mintrav2, maxtrav)
                add_traverse(inst, tree, ctx, q, q2.next.next.back,
                             mintrav2, maxtrav)
            hookup(q.next, q1, q1z)
            hookup(q.next.next, q2, q2z)
            inst.new_view(tree, q)
    return True


def dfs_slot_order(tree: Tree) -> List[Node]:
    """Deterministic node-iteration order for SPR cycles: tips 1..n, then
    inner-node slots in depth-first order from tip 1 (the reference's
    `nodeRectifier`/`reorderNodes`, `trash.c:21-74`, which re-points the
    nodep table at the DFS-entry slot of each inner node)."""
    inner: List[Node] = []
    stack = [tree.start.back]
    while stack:                      # iterative: must scale past the
        s = stack.pop()               # recursion limit (SURVEY §6, ~120k taxa)
        if tree.is_tip(s.number):
            continue
        inner.append(s)
        stack.append(s.next.next.back)
        stack.append(s.next.back)
    tips = [tree.nodep[i] for i in range(1, tree.ntips + 1)]
    return tips + inner


def batched_scan_enabled(inst: PhyloInstance) -> bool:
    """True when the lazy arm scores a pruned node's window in one batched
    call (search/batchscan.py).  The batched window trades compute (the
    whole radius window, no mid-descent lnL-cutoff early-outs) for
    launches and host round trips, which wins on the card and loses on
    the CPU, where the skipped work is the cheaper currency: by default
    it follows the arenas' device.  `inst.batch_scan` False forces the
    sequential arm everywhere, True the batched scan on any device (the
    JAX package's EXAML_BATCH_SCAN=0 / 1)."""
    if inst.batch_scan is not None:
        return bool(inst.batch_scan)
    return _on_accelerator(inst)


def _on_accelerator(inst: PhyloInstance) -> bool:
    """True when every engine's CLV state (the dense arena, or the SEV
    pool under -S) lives on the card."""
    return all(e.device.type == "cuda" for e in inst.engines.values())


def rearrange_batched(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                      p: Node, mintrav: int, maxtrav: int,
                      thorough: bool = False) -> bool:
    """`rearrange` with the candidate scoring batched into one engine call
    per pruned endpoint (search/batchscan.py), for either arm: lazy
    (sqrt-branch scores) or thorough (triangle Newton + localSmooth per
    candidate).  The ctx contract is the sequential test_insert's:
    best_of_node/end_lh/insert_node/remove_node/current_zqr (plus the
    smoothed current_lzq/lzr/lzs triplet in thorough mode) and the cutoff
    statistics lh_avg/lh_dec, with the whole radius window evaluated (the
    sequential scan's mid-descent cutoff stops are a CPU-cost heuristic;
    the batched window is a superset, so no move is ever missed).
    """
    if maxtrav < 1 or mintrav > maxtrav:
        return False
    with obs.span("search:rearrange"):
        return _rearrange_batched(inst, tree, ctx, p, mintrav, maxtrav,
                                  thorough)


def _rearrange_batched(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                       p: Node, mintrav: int, maxtrav: int,
                       thorough: bool) -> bool:
    def scan_one(prune: Node, mintrav_: int) -> None:
        global INSERTIONS_SCORED
        p1 = prune.next.back
        p2 = prune.next.next.back
        p1z = list(p1.z)
        p2z = list(p2.z)
        remove_node(inst, tree, ctx, prune)
        with obs.span("search:plan") as sp:
            plan = batchscan.plan_for_endpoints(
                inst, tree, prune, p1, p2, mintrav_, maxtrav,
                ctx.constraint, ctx.pruned_clusters)
            if sp:
                sp.note(candidates=0 if plan is None
                        else len(plan.candidates))
        if plan is not None:
            if thorough:
                lnls, es = batchscan.run_plan_thorough(inst, tree, plan)
            else:
                lnls = batchscan.run_plan(inst, tree, plan)
                es = [None] * len(lnls)
            INSERTIONS_SCORED += len(plan.candidates)
            for cand, lnl, e in zip(plan.candidates, lnls, es):
                lnl = float(lnl)
                # test_insert's contract: start_lh is the CURRENT end_lh
                # at each candidate (it rises mid-window), so the cutoff
                # statistics feed the same auto-tuning as the sequential
                # scan (`searchAlgo.c:710-742`).
                start_lh = ctx.end_lh
                if lnl > ctx.best_of_node:
                    ctx.best_of_node = lnl
                    ctx.insert_node = cand.q_slot
                    ctx.remove_node = prune
                    ctx.current_zqr = ctx.zqr.copy()
                    if e is not None:
                        ctx.current_lzq = np.full_like(ctx.current_lzq,
                                                       e[0])
                        ctx.current_lzr = np.full_like(ctx.current_lzr,
                                                       e[1])
                        ctx.current_lzs = np.full_like(ctx.current_lzs,
                                                       e[2])
                if lnl > ctx.end_lh:
                    ctx.insert_node = cand.q_slot
                    ctx.remove_node = prune
                    ctx.current_zqr = ctx.zqr.copy()
                    ctx.end_lh = lnl
                if ctx.do_cutoff and lnl < start_lh:
                    ctx.lh_avg += start_lh - lnl
                    ctx.lh_dec += 1
        hookup(prune.next, p1, p1z)
        hookup(prune.next.next, p2, p2z)
        # No eager new_view(prune): the x-flags heal themselves -- the
        # next engine call (the second endpoint's plan, or the next
        # pruned node's makenewz) folds prune's stale orientation into
        # its own traversal entries (compute_traversal resolves
        # staleness).  The sequential arm keeps the reference's eager
        # newviewGeneric.

    q = p.back
    if not tree.is_tip(p.number):
        p1 = p.next.back
        p2 = p.next.next.back
        if not tree.is_tip(p1.number) or not tree.is_tip(p2.number):
            scan_one(p, mintrav)

    if not tree.is_tip(q.number) and maxtrav > 0:
        q1 = q.next.back
        q2 = q.next.next.back

        def has_depth(x: Node) -> bool:
            return (not tree.is_tip(x.number)
                    and (not tree.is_tip(x.next.back.number)
                         or not tree.is_tip(x.next.next.back.number)))

        if has_depth(q1) or has_depth(q2):
            scan_one(q, max(mintrav, 2))
    return True


def thorough_batched_ok(inst: PhyloInstance) -> bool:
    """True when the thorough arm runs batched.  It needs ONE state bucket
    and ONE branch slot: its Newton-Raphson loops run per engine, so mixed
    buckets (whose derivatives must sum across engines every iteration)
    and per-partition branches (-M) keep the sequential arm.  GAMMA and
    PSR both batch.  Like the lazy scan it follows the arenas' device by
    default; `inst.batch_scan` False or `inst.batch_thorough` False turn
    it off anywhere, `inst.batch_thorough` True turns it on wherever the
    structural requirements hold (the JAX package's EXAML_BATCH_SCAN=0,
    EXAML_BATCH_THOROUGH=0 / 1)."""
    if inst.batch_thorough is False or inst.batch_scan is False:
        return False
    if not (len(inst.engines) == 1 and inst.num_branch_slots == 1):
        return False
    if inst.batch_thorough:
        return True
    return _on_accelerator(inst)


def rearrange_batched_thorough(inst: PhyloInstance, tree: Tree,
                               ctx: SprContext, p: Node, mintrav: int,
                               maxtrav: int) -> bool:
    """Thorough-arm batched rearrange (shared scaffolding above)."""
    return rearrange_batched(inst, tree, ctx, p, mintrav, maxtrav,
                             thorough=True)


def rearrange_auto(inst: PhyloInstance, tree: Tree, ctx: SprContext,
                   p: Node, mintrav: int, maxtrav: int) -> bool:
    """The search's rearrange: the batched arm where `batched_scan_enabled`
    / `thorough_batched_ok` select it, else the sequential one.  A failure
    of the batched arm raises; it never gives way to the sequential
    one."""
    if ctx.thorough:
        if thorough_batched_ok(inst):
            return rearrange_batched_thorough(inst, tree, ctx, p,
                                              mintrav, maxtrav)
        return rearrange(inst, tree, ctx, p, mintrav, maxtrav)
    if not batched_scan_enabled(inst):
        return rearrange(inst, tree, ctx, p, mintrav, maxtrav)
    return rearrange_batched(inst, tree, ctx, p, mintrav, maxtrav)
