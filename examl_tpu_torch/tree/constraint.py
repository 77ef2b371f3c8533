"""Multifurcating constraint trees (-g): random resolution + SPR gating.

Reference: `treeReadLenMULT` (`treeIO.c:920-1160`) reads a comprehensive
multifurcating constraint tree, labels every taxon with the id of its
enclosing constraint node (`constraintVector`), and randomly resolves the
multifurcations into a binary starting tree (seeded by -p); during the
search, `testInsertBIG`'s constraint check (`searchAlgo.c:697-722` with
`checker` :69-93) only admits insertions whose pruned subtree lands next
to a subtree of its own constraint cluster.

Deviation from the reference noted for the record: the reference's
`checker` is a first-labeled-node heuristic over labels cached at
tree-reading time, which can admit moves that break a constraint cluster
once the topology has drifted.  Here the admission rule is exact: a
regraft is allowed iff every constraint cluster remains monophyletic
afterwards, decided from the cluster content of the pruned subtree and of
the two insertion-branch sides (O(n) per scored insertion).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from examl_tpu_torch.io.newick import NewickNode, parse_newick
from examl_tpu_torch.tree.topology import Node, Tree

ROOT_CLUSTER = 0


class TreeConstraint:
    """Tip-cluster labels + the exact SPR insertion admission rule."""

    def __init__(self, tree: Tree, tip_cluster: Dict[int, int]):
        self._tree = tree
        self.tip_cluster = tip_cluster

    def clusters_behind(self, slot: Node) -> frozenset:
        """Set of cluster ids of all tips behind slot (away from
        slot.back); detached slots (the prune cut) contribute nothing.
        Iterative — safe on deep pectinate trees."""
        out = set()
        stack = [slot]
        while stack:
            s = stack.pop()
            if self._tree.is_tip(s.number):
                out.add(self.tip_cluster[s.number])
                continue
            for t in (s.next, s.next.next):
                if t.back is not None:
                    stack.append(t.back)
        return frozenset(out)

    def insertion_ok(self, p: Node, q: Node,
                     pruned_clusters: frozenset | None = None) -> bool:
        """May the subtree pruned at p be regrafted onto branch (q, q.back)?

        Exact rule per constrained cluster C (S = pruned tip set,
        side_q / side_r = the insertion branch's two sides):
        - C disjoint from S: reject iff the branch lies strictly inside
          C's clade (C present on both sides).
        - C entirely inside S: fine.
        - S pure-C but C also outside S: the branch must lie inside or on
          the boundary of C's remainder clade.
        - S mixed and C split between S and the rest: never repairable.

        pruned_clusters caches clusters_behind(p.back), constant for all
        candidate insertions of one prune (the SPR search supplies it).
        """
        s_cl = (pruned_clusters if pruned_clusters is not None
                else self.clusters_behind(p.back))
        side_q = self.clusters_behind(q)
        side_r = self.clusters_behind(q.back)
        constrained = (s_cl | side_q | side_r) - {ROOT_CLUSTER}
        for c in constrained:
            in_s = c in s_cl
            if not in_s:
                if c in side_q and c in side_r:
                    return False
                continue
            if c not in side_q and c not in side_r:
                continue                      # C fully inside S
            if s_cl != frozenset((c,)):
                return False                  # mixed S carries part of C
            inside = c in side_q and c in side_r
            boundary = side_q == frozenset((c,)) or side_r == frozenset((c,))
            if not (inside or boundary):
                return False
        return True


def _binarize(nw: NewickNode, rng: np.random.Generator,
              at_root: bool) -> None:
    """Randomly resolve a multifurcation in place: repeatedly merge two
    random children under a fresh node, keeping 3 children at the unrooted
    root and 2 elsewhere (the role of the random resolution in
    `addElementLenMULT`)."""
    for child in nw.children:
        _binarize(child, rng, at_root=False)
    target = 3 if at_root else 2
    while len(nw.children) > target:
        i, j = sorted(rng.choice(len(nw.children), size=2, replace=False))
        merged = NewickNode(children=[nw.children[i], nw.children[j]])
        rest = [c for k, c in enumerate(nw.children) if k not in (i, j)]
        nw.children = rest + [merged]


def load_constraint(text: str, taxon_names: Sequence[str], seed: int,
                    num_branches: int = 1) -> tuple[Tree, TreeConstraint]:
    """Parse a comprehensive multifurcating constraint tree, randomly
    resolve it into a binary starting Tree, and return the constraint
    checker (reference `getStartingTree` -g path)."""
    root = parse_newick(text)
    leaves = [l.name for l in root.leaves()]
    if sorted(leaves) != sorted(taxon_names):
        missing = set(taxon_names) - set(leaves)
        extra = set(leaves) - set(taxon_names)
        raise ValueError(
            "the constraint tree must contain exactly the alignment's "
            f"taxa (missing: {sorted(missing)[:5]}, "
            f"unknown: {sorted(extra)[:5]})")

    # Cluster ids: each internal constraint node below the root gets a
    # fresh id; tips are labeled with their parent's id (root level = 0).
    name_to_num = {n: i + 1 for i, n in enumerate(taxon_names)}
    tip_cluster: Dict[int, int] = {}
    counter = [ROOT_CLUSTER]

    def assign(nw: NewickNode, cluster: int) -> None:
        for child in nw.children:
            if child.is_leaf:
                tip_cluster[name_to_num[child.name]] = cluster
            else:
                counter[0] += 1
                assign(child, counter[0])

    assign(root, ROOT_CLUSTER)

    rng = np.random.default_rng(seed)
    # Collapse a rooted constraint into the unrooted trifurcation first.
    while len(root.children) == 2:
        a, b = root.children
        inner = a if not a.is_leaf else b
        if inner.is_leaf:
            raise ValueError("two-taxon constraint tree is not supported")
        other = b if inner is a else a
        root = NewickNode(children=list(inner.children) + [other])
    _binarize(root, rng, at_root=True)

    tree = Tree.from_newick(_format(root) + ";", taxon_names, num_branches)
    return tree, TreeConstraint(tree, tip_cluster)


def _format(nw: NewickNode) -> str:
    if nw.is_leaf:
        return nw.name
    return "(" + ",".join(_format(c) for c in nw.children) + ")"
