"""Branch-length smoothing passes over the tree.

The port of `examl_tpu/optimize/branch.py`: the reference's
`update`/`smooth`/`smoothTree`/`treeEvaluate` (ExaML
`searchAlgo.c:127-436, 2635-2650`) — repeated passes over every branch
until no branch moves by more than `deltaz`, tracked per branch slot
through the instance's `partition_smoothed` / `partition_converged`
flags, plus the SPR search's local passes (`localSmooth`,
`regionalSmooth`).

Two routes for the full-tree pass (`smooth_tree`), chosen by the
instance's `grad_smooth` (the JAX package's EXAML_GRAD_SMOOTH):

* WHOLE-TREE GRADIENT (the default): per sweep, one full traversal and
  one whole-tree gradient pass per engine (ops/gradient.py) give (d1, d2)
  for all 2n-3 branches, then one batched damped-Newton update moves
  every branch at once; sweeps repeat to the same DELTAZ criterion.
* PER-BRANCH (the reference's, `grad_smooth=False`): one partial
  traversal + sumtable + Newton solve per branch per sweep.  The local
  and regional passes always take it (a handful of branches).

`grad_smooth_ineligible` decides up front where the gradient pass cannot
serve an instance (under `-S` there is no dense arena for it), and the
per-branch route runs there.  Unlike the JAX package, a failed gradient
pass raises: there is no per-branch fallback behind it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from examl_tpu_torch import obs
from examl_tpu_torch.constants import DELTAZ, SMOOTHINGS, ZMAX, ZMIN
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.ops import gradient
from examl_tpu_torch.tree.topology import Node, Tree
from examl_tpu_torch.utils import z_slots

# Largest per-branch step scale of the gradient route (the JAX package's
# EXAML_GRAD_DAMPING default).
GRAD_DAMPING = 1.0
# Gradient-route sweeps run (a plain count, read by chip_smoke.py).
GRAD_SWEEPS = 0


def update_branch(inst: PhyloInstance, tree: Tree, p: Node) -> None:
    """One-branch NR update + smoothed-flag bookkeeping (ref `update`)."""
    q = p.back
    z0 = z_slots(q.z, inst.num_branch_slots)
    z = inst.makenewz(tree, p, q, z0, maxiter=1,
                      mask_converged=inst.num_branch_slots > 1)
    moved = np.abs(z - z0) > DELTAZ
    upd = ~inst.partition_converged
    inst.partition_smoothed &= ~(upd & moved)
    znew = np.where(upd, z, z0)
    p.z[:] = znew.tolist()
    q.z[:] = znew.tolist()


def smooth_subtree(inst: PhyloInstance, tree: Tree, p: Node) -> None:
    """Adjust branch (p, p.back) then descend below p (ref `smooth`),
    with an explicit two-visit stack instead of recursion."""
    stack: List[Tuple[Node, bool]] = [(p, False)]
    while stack:
        s, expanded = stack.pop()
        if expanded:
            inst.new_view(tree, s)
            continue
        update_branch(inst, tree, s)
        if not tree.is_tip(s.number):
            stack.append((s, True))
            stack.append((s.next.next.back, False))
            stack.append((s.next.back, False))


def _all_smoothed(inst: PhyloInstance) -> bool:
    result = True
    for i in range(inst.num_branch_slots):
        if not inst.partition_smoothed[i]:
            result = False
        else:
            inst.partition_converged[i] = True
    return result


# -- whole-tree gradient smoothing (ops/gradient.py) -------------------------


def grad_smooth_ineligible(inst: PhyloInstance) -> Optional[str]:
    """None when the whole-tree gradient pass can serve this instance,
    else the reason the per-branch route is kept."""
    if inst.save_memory:
        return "-S SEV pools keep the per-branch Newton path"
    return None


def _slot_facing(tree: Tree, child: int, parent: int) -> Node:
    """The slot at `child` whose back is `parent` — the Node owning the
    branch's shared z list (hookup aliases both endpoints' z to one list,
    so writing through either slot updates the branch)."""
    if tree.is_tip(child):
        return tree.nodep[child]
    for sl in tree.slots(child):
        if sl.back is not None and sl.back.number == parent:
            return sl
    raise KeyError(f"no slot at node {child} faces node {parent}")


def _edge_slots(tree: Tree, flat, p: Node) -> List[Node]:
    """Node slots in the engine's edge order (ops/gradient.py): edge 0
    the traversal's root edge, then each entry's (left, right) child
    branches in flat order."""
    slots = [p]
    for v, l, r in zip(flat.parent.tolist(), flat.left.tolist(),
                       flat.right.tolist()):
        slots.append(_slot_facing(tree, l, v))
        slots.append(_slot_facing(tree, r, v))
    return slots


def tree_gradients(inst: PhyloInstance, tree: Tree):
    """Analytic (d1, d2) w.r.t. lz for every branch, with the Node slots
    owning them: per engine one full traversal and one whole-tree
    gradient pass.  Mixed state buckets sum their per-engine derivatives
    (the cross-engine sum `makenewz` takes per NR iteration)."""
    p = tree.centroid_branch()
    flat = tree.flat_full_traversal(p)
    root_z = z_slots(p.z, inst.num_branch_slots)
    d1 = d2 = None
    for eng in inst.engines.values():
        eng.run_traversal(flat, full=True)
        e1, e2 = eng.whole_tree_gradients(flat, root_z)
        d1 = e1 if d1 is None else d1 + e1
        d2 = e2 if d2 is None else d2 + e2
    slots = _edge_slots(tree, flat, p)
    assert len(slots) == d1.shape[0], (len(slots), d1.shape)
    return slots, d1, d2


def gradient_smooth_tree(inst: PhyloInstance, tree: Tree,
                         maxtimes: int) -> bool:
    """Simultaneous whole-tree branch-length optimization: per sweep one
    gradient pass (all branches at once) and one batched damped-Newton
    update (`gradient.newton_step`, the reference NR body's single
    iteration vectorized over edges), to the per-branch route's DELTAZ
    movement criterion.

    Simultaneous (Jacobi-style) updates can make an adjacent branch pair
    overshoot in antiphase where the sequential solve damps through the
    coupling, so each branch carries an Rprop-style step scale in lz
    space: a direction flip between sweeps halves it, a consistent
    direction grows it back (x1.2, capped at GRAD_DAMPING).  The budget is
    4 x `maxtimes` single-step sweeps against the per-branch route's
    `maxtimes` full-solve sweeps; returns False if branches still moved at
    the end."""
    global GRAD_SWEEPS
    C = inst.num_branch_slots
    scale = prev_step = None
    for _ in range(max(1, 4 * maxtimes)):
        d0 = obs.counter("engine.dispatch_count")
        inst.partition_smoothed[:] = True
        slots, d1, d2 = tree_gradients(inst, tree)
        z0 = np.clip(np.stack([z_slots(s.z, C) for s in slots]),
                     ZMIN, ZMAX)
        znew = gradient.newton_step(z0, d1, d2)
        step = np.log(znew) - np.log(z0)
        if scale is None:
            scale = np.full_like(step, GRAD_DAMPING)
        else:
            flip = prev_step * step < 0.0
            scale = np.maximum(
                np.where(flip, scale * 0.5,
                         np.minimum(scale * 1.2, GRAD_DAMPING)), 1.0 / 64)
        prev_step = step
        zapp = np.clip(z0 * np.exp(step * scale), ZMIN, ZMAX)
        upd = ~inst.partition_converged
        zapp = np.where(upd[None, :], zapp, z0)
        moved = np.abs(zapp - z0) > DELTAZ
        inst.partition_smoothed &= ~(upd & moved.any(axis=0))
        for i, s in enumerate(slots):
            s.z[:] = zapp[i].tolist()
        GRAD_SWEEPS += 1
        obs.gauge("engine.dispatches_per_smoothing_round",
                  obs.counter("engine.dispatch_count") - d0)
        obs.inc("optimize.grad_smooth_sweeps")
        if _all_smoothed(inst):
            return True
    return False


def smooth_tree(inst: PhyloInstance, tree: Tree, maxtimes: int) -> None:
    """Smoothing passes over every branch (ref `smoothTree`), by
    whole-tree gradients unless the instance was built with
    `grad_smooth=False` or `grad_smooth_ineligible` names a reason.  A
    gradient run whose sweep budget runs out is accepted, as the
    per-branch route accepts its own maxtimes.  The per-branch route
    descends once from start.back (tree.start is tip 1) and so covers
    every branch."""
    inst.partition_converged[:] = False
    if inst.grad_smooth and grad_smooth_ineligible(inst) is None:
        if not gradient_smooth_tree(inst, tree, maxtimes):
            obs.inc("optimize.grad_smooth_unconverged")
        inst.partition_converged[:] = False
        return
    p = tree.start
    while maxtimes > 0:
        maxtimes -= 1
        d0 = obs.counter("engine.dispatch_count")
        inst.partition_smoothed[:] = True
        smooth_subtree(inst, tree, p.back)
        obs.gauge("engine.dispatches_per_smoothing_round",
                  obs.counter("engine.dispatch_count") - d0)
        if _all_smoothed(inst):
            break
    inst.partition_converged[:] = False


def local_smooth(inst: PhyloInstance, tree: Tree, p: Node,
                 maxtimes: int) -> bool:
    """Smooth only the three branches of inner node p (ref `localSmooth`)."""
    if tree.is_tip(p.number):
        return False
    inst.partition_converged[:] = False
    while maxtimes > 0:
        maxtimes -= 1
        inst.partition_smoothed[:] = True
        for s in (p, p.next, p.next.next):
            update_branch(inst, tree, s)
        if _all_smoothed(inst):
            break
    inst.partition_smoothed[:] = False
    inst.partition_converged[:] = False
    return True


def region_smooth(inst: PhyloInstance, tree: Tree, p: Node, region: int,
                  maxtimes: int) -> bool:
    """Smooth branches within `region` hops of branch (p, p.back)
    (ref `regionalSmooth`, `searchAlgo.c:368-436`).  Iterative like
    `smooth_subtree` — the same recursion-depth hazard, one level down."""
    def smooth_region(s0: Node, region: int) -> None:
        stack: List[Tuple[Node, int, bool]] = [(s0, region, False)]
        while stack:
            s, depth, expanded = stack.pop()
            if expanded:
                inst.new_view(tree, s)
                continue
            update_branch(inst, tree, s)
            if depth > 0 and not tree.is_tip(s.number):
                stack.append((s, depth, True))
                stack.append((s.next.next.back, depth - 1, False))
                stack.append((s.next.back, depth - 1, False))

    if tree.is_tip(p.number) and tree.is_tip(p.back.number):
        return False
    inst.partition_converged[:] = False
    while maxtimes > 0:
        maxtimes -= 1
        inst.partition_smoothed[:] = True
        smooth_region(p, region)
        smooth_region(p.back, region)
        if _all_smoothed(inst):
            break
    inst.partition_smoothed[:] = False
    inst.partition_converged[:] = False
    return True


def tree_evaluate(inst: PhyloInstance, tree: Tree,
                  smooth_factor: float = 1.0) -> float:
    """Smooth all branches then evaluate (ref `treeEvaluate`)."""
    smooth_tree(inst, tree, int(SMOOTHINGS * smooth_factor))
    return inst.evaluate(tree, tree.start, full=True)
