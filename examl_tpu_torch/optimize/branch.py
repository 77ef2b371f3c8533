"""Branch-length smoothing passes over the tree (per-branch route).

The port of the per-branch half of `examl_tpu/optimize/branch.py` (the
JAX package's `EXAML_GRAD_SMOOTH=0` semantics): the reference's
`update`/`smooth`/`smoothTree`/`treeEvaluate` (ExaML
`searchAlgo.c:127-436, 2635-2650`) — repeated Newton-Raphson passes over
every branch until no branch moves by more than `deltaz`, tracked per
branch slot through the instance's `partition_smoothed` /
`partition_converged` flags, plus the SPR search's local passes
(`localSmooth`, `regionalSmooth`).  The whole-tree gradient route comes
with the gradient kernels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from examl_tpu_torch.constants import DELTAZ, SMOOTHINGS
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.tree.topology import Node, Tree
from examl_tpu_torch.utils import z_slots


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


def smooth_tree(inst: PhyloInstance, tree: Tree, maxtimes: int) -> None:
    """Smoothing passes over every branch (ref `smoothTree`): tree.start
    is tip 1, so one descent from start.back covers every branch."""
    inst.partition_converged[:] = False
    p = tree.start
    while maxtimes > 0:
        maxtimes -= 1
        inst.partition_smoothed[:] = True
        smooth_subtree(inst, tree, p.back)
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
