"""Batched SPR radius scan: every candidate insertion of a pruned node in
one engine call.

The port of `examl_tpu/search/batchscan.py`.  The reference scores one
candidate at a time (ExaML `addTraverseBIG`/`testInsertBIG`,
`searchAlgo.c:682-833`): one newview and one evaluate per candidate
branch.  The batched scan restructures it around directional CLVs:

* after `remove_node` the tree is conceptually rooted at the merged
  branch (q1, q2).  Every candidate edge (v, parent(v)) needs `down(v)`,
  v's CLV away from the merged edge (kept current by the x-flags), and
  `uppass(v)`, the CLV at parent(v) directed away from v;
* `uppass` obeys newview's recurrence,
      uppass(v) = P_{z(w,pw)} uppass(w) * P_{z(w,sib)} down(sib)
  for w = parent(v), so the window's uppass vectors are more traversal
  entries, wave-scheduled into a scan region of the CLV arena above its
  normal rows (`LikelihoodEngine.ensure_scan_rows`) and computed by the
  wave-scan tier's `kernels.traverse`;
* the lazy score at (v, parent(v)) with the sqrt-branch rule
  z' = clip(sqrt(z_v)) (reference `insertBIG` lazy arm) is
      lnL = root_eval(P_{z_p} down(subtree) * P_{z'} down(v), uppass(v), z')
  which batches over candidates in chunks of CAND_CHUNK;
* the thorough score runs the reference's Thorough procedure (`insertBIG`
  thorough arm + `localSmooth`, `searchAlgo.c:495-533, 196-436`) for
  TH_CHUNK candidates at once, every Newton-Raphson solve batched over the
  candidates (`kernels.newton_raphson_branch` with a lane axis).

The candidate set is `addTraverseBIG`'s whole radius window: the
sequential scan's lnL cutoff skips descendants of bad branches mid-scan
(a CPU-cost heuristic, `searchAlgo.c:710-742`); the batched window is a
superset, so it never loses a move the sequential scan would find, and
feeds the same per-insertion statistics to the cutoff auto-tuner.

The host code (`Candidate` to `plan_for_endpoints`, `run_plan`,
`run_plan_thorough`) is the JAX package's; the device bodies
(ops/scan.py: `scan_chunk`, `thorough_chunk`) are plain torch ops on the
engine's tensors, dense arena only (no -S pool, one device).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from examl_tpu_torch import obs
from examl_tpu_torch.constants import ZMAX, ZMIN
from examl_tpu_torch.tree.topology import Node, Tree
from examl_tpu_torch.utils import z_slots

# Scan plans executed, lazy and thorough (a plain count, read by
# chip_smoke.py).
SCAN_CALLS = 0


class Candidate(NamedTuple):
    q_slot: Node            # slot of the edge's far end (q_slot.back = parent)
    up_slot: int            # scan-slot index of uppass(q)
    z: tuple                # candidate branch vector (sqrt rule, clipped)
    depth: int              # edges from the merged branch (>= 1)

    @property
    def q_num(self) -> int:
        return self.q_slot.number


class UpEntry(NamedTuple):
    """uppass(slot) = P_{zl}·left ⊙ P_{zr}·right; left/right reference
    either a tree node ("node", number) or an earlier slot ("slot", s)."""
    slot: int
    left: Tuple[str, int]
    right: Tuple[str, int]
    zl: tuple
    zr: tuple


class ScanPlan(NamedTuple):
    down_entries: list          # TraversalEntry list (orientation fixes)
    up_entries: List[UpEntry]
    candidates: List[Candidate]
    s_num: int                  # subtree CLV node (p.back)
    zp: tuple                   # branch vector p -- subtree


def _zt(z) -> tuple:
    return tuple(float(x) for x in np.asarray(z, dtype=np.float64))


def plan_for_endpoints(inst, tree: Tree, p: Node, q1: Node, q2: Node,
                       mintrav: int, maxtrav: int, constraint=None,
                       pruned_clusters=None) -> Optional[ScanPlan]:
    """Build the scan plan after remove_node(p) joined q1 -- q2.

    The descent mirrors `rearrangeBIG`/`addTraverseBIG`: from each
    non-tip endpoint, the two windows rooted at its children, testing
    each edge (v, parent v) once mintrav is consumed, stopping at tips
    or when maxtrav runs out.  Iterative (explicit stack) so deep scan
    radii cannot hit the recursion limit.
    """
    C = inst.num_branch_slots

    def sqrt_z(z) -> tuple:
        return tuple(np.clip(np.sqrt(z_slots(z, C)), ZMIN, ZMAX))

    def allowed(v: Node) -> bool:
        if constraint is None:
            return True
        return constraint.insertion_ok(p, v, pruned_clusters)

    up_entries: List[UpEntry] = []
    candidates: List[Candidate] = []
    gather_nodes: List[Node] = []       # nodes whose down-CLV is read
    zqr = _zt(q1.z)

    roots: List[Tuple[Node, int, int, int, int]] = []
    for a, b in ((q1, q2), (q2, q1)):
        if tree.is_tip(a.number):
            continue
        for child_link, sib_link in ((a.next, a.next.next),
                                     (a.next.next, a.next)):
            child, sib = child_link.back, sib_link.back
            slot = len(up_entries)
            # root uppass: CLV at a away from child
            up_entries.append(UpEntry(
                slot, ("node", b.number), ("node", sib.number),
                zqr, _zt(sib_link.z)))
            gather_nodes.append(b)
            gather_nodes.append(sib)
            roots.append((child, slot, 1, mintrav - 1, maxtrav - 1))

    # Candidate order replicates addTraverseBIG's recursion (test the
    # edge, then the v.next subtree, then v.next.next): the order decides
    # which move wins exact lnL ties and when end_lh rises for the
    # cutoff statistics, so it must match the sequential scan.
    for item in roots:
        stack = [item]
        while stack:
            v, up_slot, depth, mint, maxt = stack.pop()
            if mint <= 0 and allowed(v):
                candidates.append(Candidate(v, up_slot, sqrt_z(v.z),
                                            depth))
                gather_nodes.append(v)
            if tree.is_tip(v.number) or maxt <= 0:
                continue
            pushes = []
            for child_link, sib_link in ((v.next, v.next.next),
                                         (v.next.next, v.next)):
                child, sib = child_link.back, sib_link.back
                slot = len(up_entries)
                up_entries.append(UpEntry(
                    slot, ("slot", up_slot), ("node", sib.number),
                    _zt(v.z), _zt(sib_link.z)))
                gather_nodes.append(sib)
                pushes.append((child, slot, depth + 1, mint - 1,
                               maxt - 1))
            stack.extend(reversed(pushes))   # LIFO: v.next pops first

    if not candidates:
        return None

    # Down-CLV orientation: every gathered node must view away from the
    # merged edge; compute_traversal resolves staleness via the x-flags
    # (dedup by parent -- windows overlap heavily).  The deduped union
    # must then be DEPENDENCY-SORTED: compute_traversal always recomputes
    # its top node, so a later call can emit a rewrite of a node that an
    # earlier call's entry reads -- list order alone would let
    # schedule_waves place the reader at or before the writer and gather
    # a stale CLV.
    need = {}
    subtree_root = p.back
    for v in gather_nodes + [subtree_root]:
        if tree.is_tip(v.number):
            continue
        for e in tree.compute_traversal(v, full=False):
            need.setdefault(e.parent, e)

    down_entries: list = []
    emitted = set()

    def emit(entry) -> None:
        stack = [(entry, False)]
        while stack:
            e, expanded = stack.pop()
            if e.parent in emitted:
                continue
            if expanded:
                emitted.add(e.parent)
                down_entries.append(e)
                continue
            stack.append((e, True))
            for child in (e.left, e.right):
                if child in need and child not in emitted:
                    stack.append((need[child], False))

    for e in need.values():
        emit(e)

    return ScanPlan(down_entries=down_entries,
                    up_entries=up_entries, candidates=candidates,
                    s_num=subtree_root.number, zp=_zt(p.z))


def run_plan(inst, tree: Tree, plan: ScanPlan) -> np.ndarray:
    """Execute the plan; returns per-candidate total lnL [N]: the
    orientation fixes, the uppass traversal and every candidate score,
    one engine call per state bucket."""
    global SCAN_CALLS
    SCAN_CALLS += 1
    N = len(plan.candidates)
    obs.inc("search.scan_dispatches")
    obs.inc("search.scan_candidates", N)
    total = np.zeros(N, dtype=np.float64)
    with obs.span("search:spr_batched_scan", args={"candidates": N}):
        for eng in inst.engines.values():
            total += np.asarray(eng.batched_scan(plan), dtype=np.float64)
    return total


def run_plan_thorough(inst, tree: Tree, plan: ScanPlan
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Thorough scores for every plan candidate: (lnls [N], e [N, 3])
    with e = the smoothed (lzq, lzr, lzs) branch triplet per candidate.
    Single-engine, single-branch-slot instances only (the caller
    gates)."""
    from examl_tpu_torch.search.spr import SPR_NR_ITERATIONS

    global SCAN_CALLS
    SCAN_CALLS += 1
    obs.inc("search.scan_dispatches")
    obs.inc("search.scan_candidates", len(plan.candidates))
    (eng,) = inst.engines.values()
    with obs.span("search:spr_batched_thorough",
                  args={"candidates": len(plan.candidates)}):
        return eng.batched_thorough(plan, SPR_NR_ITERATIONS)
