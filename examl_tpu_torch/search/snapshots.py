"""Tree snapshots and ranked best-tree lists.

Host-side equivalents of the reference's two topology-snapshot structures
(ExaML `topologies.c`): the lightweight connection list `topol` (saveTree /
restoreTree :314-368) and the scored, deduplicated `bestlist` ranking
(initBestTree / saveBestTree / recallBestTree :370-680).  Unlike the
reference, snapshots store (node-number, node-number, z) edge records
instead of raw pointers, so they serialize portably into checkpoints
(SURVEY §5.4 flags the reference's raw-pointer dump as a design to avoid).
"""

from __future__ import annotations

from typing import FrozenSet, List, Optional, Tuple

from examl_tpu_torch.constants import UNLIKELY
from examl_tpu_torch.tree.topology import Tree, hookup

Edge = Tuple[int, int, Tuple[float, ...]]


def topology_key(tree: Tree) -> FrozenSet[FrozenSet[int]]:
    """Canonical topology identity: the set of non-trivial bipartitions,
    each written as the tip set on the side away from tip 1.

    Replaces the reference's ordered-traversal topology compare
    (`topologies.c:445-550` cmpSubtopol/cmpTopol) with a hashable value.
    """
    n = tree.ntips
    keys: List[FrozenSet[int]] = []

    def rec(slot) -> frozenset:
        if tree.is_tip(slot.number):
            return frozenset((slot.number,))
        s = rec(slot.next.back) | rec(slot.next.next.back)
        if 1 < len(s) < n - 1:
            keys.append(frozenset(s))
        return s

    rec(tree.start.back)
    return frozenset(keys)


class TreeSnapshot:
    """Full topology + branch-length snapshot, restorable into the same
    Tree object (Node identities are reused, only connections change)."""

    __slots__ = ("edges", "likelihood", "key")

    def __init__(self, edges: List[Edge], likelihood: float,
                 key: Optional[FrozenSet] = None):
        self.edges = edges
        self.likelihood = likelihood
        self.key = key

    @classmethod
    def capture(cls, tree: Tree, likelihood: float,
                with_key: bool = True) -> "TreeSnapshot":
        edges: List[Edge] = [(p.number, q.number, tuple(p.z))
                             for p, q in tree.all_branches()]
        return cls(edges, likelihood,
                   topology_key(tree) if with_key else None)

    def restore_into(self, tree: Tree) -> None:
        """Rebuild the tree's connections from the edge list.

        Slots within an inner node's 3-cycle are assigned first-free-first,
        which permutes cycle order relative to capture time — harmless, as
        orientation flags are cleared and every consumer traverses via
        back pointers only."""
        for num in range(1, tree.max_nodes + 1):
            for slot in tree.slots(num):
                slot.back = None
                slot.x = False
        free = {num: list(tree.slots(num))
                for num in range(1, tree.max_nodes + 1)}
        for u, v, z in self.edges:
            hookup(free[u].pop(0), free[v].pop(0), list(z))
        tree._check_connected()

    # checkpoint (de)serialization ------------------------------------------

    def to_dict(self) -> dict:
        return {"edges": [[u, v, list(z)] for u, v, z in self.edges],
                "likelihood": self.likelihood}

    @classmethod
    def from_dict(cls, d: dict) -> "TreeSnapshot":
        edges = [(int(u), int(v), tuple(z)) for u, v, z in d["edges"]]
        return cls(edges, float(d["likelihood"]))


class BestList:
    """Ranked list of the `nkeep` best distinct topologies seen.

    Reference `bestlist` semantics (`topologies.c:552-641` saveBestTree):
    duplicate topologies are not stored twice; a revisit with a better
    likelihood refreshes the stored branch lengths and score.
    """

    def __init__(self, nkeep: int):
        self.nkeep = nkeep
        self.entries: List[TreeSnapshot] = []   # sorted best-first

    def reset(self) -> None:
        self.entries.clear()

    @property
    def nvalid(self) -> int:
        return len(self.entries)

    @property
    def best_lnl(self) -> float:
        return self.entries[0].likelihood if self.entries else UNLIKELY

    def save(self, tree: Tree, likelihood: float) -> int:
        """Insert the current tree; returns its 1-based rank, 0 if rejected."""
        snap = TreeSnapshot.capture(tree, likelihood)
        for i, e in enumerate(self.entries):
            if e.key == snap.key:
                if likelihood > e.likelihood:
                    self.entries[i] = snap
                    self.entries.sort(key=lambda s: -s.likelihood)
                    return self.entries.index(snap) + 1
                return 0
        if len(self.entries) >= self.nkeep:
            if likelihood <= self.entries[-1].likelihood:
                return 0
            self.entries.pop()
        self.entries.append(snap)
        self.entries.sort(key=lambda s: -s.likelihood)
        return self.entries.index(snap) + 1

    def recall(self, inst, tree: Tree, rank: int = 1) -> float:
        """Restore the rank-th best tree (1-based) and re-evaluate fully
        (reference restoreTree ends with evaluateGeneric, `topologies.c:364`)."""
        snap = self.entries[rank - 1]
        snap.restore_into(tree)
        return inst.evaluate(tree, full=True)

    # checkpoint (de)serialization ------------------------------------------

    def to_dict(self) -> dict:
        return {"nkeep": self.nkeep,
                "entries": [e.to_dict() for e in self.entries]}

    def load_dict(self, d: dict, tree: Tree) -> None:
        self.nkeep = int(d["nkeep"])
        self.entries = []
        for ed in d["entries"]:
            snap = TreeSnapshot.from_dict(ed)
            snap.restore_into(tree)
            snap.key = topology_key(tree)
            self.entries.append(snap)


class InfoList:
    """Fixed-size pool of the best (node, lnL) insertion origins from the
    lazy SPR pass, re-examined thoroughly afterwards (reference `infoList`,
    `searchAlgo.c:316-376`): a new record replaces the current minimum."""

    def __init__(self, n: int = 50):
        self.n = n
        self.nodes: List = [None] * n
        self.lnls: List[float] = [UNLIKELY] * n
        self.valid = 0

    def reset(self) -> None:
        for i in range(self.n):
            self.nodes[i] = None
            self.lnls[i] = UNLIKELY
        self.valid = 0

    def insert(self, node, likelihood: float) -> None:
        imin = min(range(self.n), key=lambda i: self.lnls[i])
        if likelihood > self.lnls[imin]:
            self.lnls[imin] = likelihood
            self.nodes[imin] = node
            self.valid = min(self.valid + 1, self.n)

    def active_nodes(self) -> List:
        return [nd for nd in self.nodes if nd is not None][: self.valid]
