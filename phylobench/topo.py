"""The benchmark's own unrooted binary tree, independent of the program.

Tips are 0..n-1 (taxon `t<i>`), inner nodes n..2n-3.  Every edge has a
length t (expected substitutions per site).  The shape is drawn from a
seed of the configuration's and the lengths from the run's; the tree is
handed to the program as Newick, walked by the reference's pruning, and
counted: the entries of a full traversal and the radius
window of every lazy SPR prune come from here, never from the program's
counters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Topology:
    def __init__(self, ntips: int, adj: List[List[int]],
                 length: Dict[Tuple[int, int], float]):
        self.ntips = ntips
        self.adj = adj                  # node -> neighbours
        self.length = length            # (a, b) with a < b -> t

    @property
    def num_nodes(self) -> int:
        return len(self.adj)

    def is_tip(self, v: int) -> bool:
        return v < self.ntips

    def t(self, a: int, b: int) -> float:
        return self.length[(a, b) if a < b else (b, a)]

    def edges(self) -> List[Tuple[int, int]]:
        return sorted(self.length)

    # -- construction ------------------------------------------------------

    @classmethod
    def random(cls, ntips: int, shape_rng: np.random.Generator,
               length_rng: np.random.Generator, mean_length: float,
               min_length: float = 1e-3, max_length: float = 2.0
               ) -> "Topology":
        """Stepwise addition of the tips, in a random order, each on a
        uniformly drawn edge (from `shape_rng`); lengths exponential
        around `mean_length` (from `length_rng`)."""
        order = [int(i) for i in shape_rng.permutation(ntips)]
        adj: List[List[int]] = [[] for _ in range(2 * ntips - 2)]
        edges: List[Tuple[int, int]] = []
        centre = ntips
        for tip in order[:3]:
            adj[centre].append(tip)
            adj[tip].append(centre)
            edges.append((tip, centre))
        nxt = ntips + 1
        for tip in order[3:]:
            i = int(shape_rng.integers(len(edges)))
            a, b = edges[i]
            c = nxt
            nxt += 1
            adj[a][adj[a].index(b)] = c
            adj[b][adj[b].index(a)] = c
            adj[c] = [a, b, tip]
            adj[tip].append(c)
            edges[i] = (a, c)
            edges.append((c, b))
            edges.append((tip, c))
        t = np.clip(length_rng.exponential(mean_length, len(edges)),
                    min_length, max_length)
        length = {}
        for (a, b), ti in zip(sorted((min(e), max(e)) for e in edges), t):
            length[(a, b)] = float(ti)
        return cls(ntips, adj, length)

    def newick(self, names: Sequence[str]) -> str:
        """Unrooted Newick, trifurcating at tip 0's neighbour; lengths in
        full precision."""
        root = self.adj[0][0]

        def sub(v: int, parent: int) -> str:
            lab = f":{self.t(v, parent)!r}"
            if self.is_tip(v):
                return names[v] + lab
            kids = [sub(c, v) for c in self.adj[v] if c != parent]
            return "(" + ",".join(kids) + ")" + lab

        return "(" + ",".join(sub(c, root) for c in self.adj[root]) + ");"

    # -- walks -------------------------------------------------------------

    def postorder(self, root: int) -> List[Tuple[int, int]]:
        """(node, parent) pairs, children before parents, every node but
        `root`, walking away from `root`."""
        out: List[Tuple[int, int]] = []
        stack = [(c, root, False) for c in self.adj[root]]
        while stack:
            v, par, done = stack.pop()
            if done or self.is_tip(v):
                out.append((v, par))
                continue
            stack.append((v, par, True))
            stack.extend((c, v, False) for c in self.adj[v] if c != par)
        return out

    def side_postorder(self, v: int, away: int) -> List[Tuple[int, int]]:
        """(node, parent) pairs of v's side away from its neighbour
        `away`, children before parents, ending with (v, away)."""
        out: List[Tuple[int, int]] = []
        stack = [(v, away, False)]
        while stack:
            u, par, done = stack.pop()
            if done or self.is_tip(u):
                out.append((u, par))
                continue
            stack.append((u, par, True))
            stack.extend((c, u, False) for c in self.adj[u] if c != par)
        return out

    def tip_sets(self) -> Dict[int, int]:
        """Each inner node's tips on the side away from tip 0, as a bit
        mask (the split that names the node in any numbering)."""
        mask: Dict[int, int] = {}
        for v, par in self.postorder(0):
            mask[v] = (1 << v) if self.is_tip(v) else sum(
                mask[c] for c in self.adj[v] if c != par)
        return {v: m for v, m in mask.items() if not self.is_tip(v)}

    def slot_order(self) -> List[Tuple[int, int]]:
        """Prune order of a lazy SPR pass as (node, neighbour the slot
        faces): every tip in number order, then every inner node in
        depth-first order from tip 0, facing its parent (the program's
        `dfs_slot_order` over this numbering)."""
        out = [(i, self.adj[i][0]) for i in range(self.ntips)]
        stack = [(self.adj[0][0], 0)]
        while stack:
            v, par = stack.pop()
            if self.is_tip(v):
                continue
            out.append((v, par))
            stack.extend(reversed([(c, v) for c in self.adj[v]
                                   if c != par]))
        return out

    # -- the lazy SPR radius window ---------------------------------------

    def window(self, x: int, s: int, mintrav: int, maxtrav: int
               ) -> Optional[Tuple[List[Tuple[int, int]], int]]:
        """Prune node x away from its neighbour s, join its other two
        neighbours, and list the insertion edges (v, parent) of the
        radius window: depth mintrav..maxtrav from either endpoint, away
        from the join.  Returns (edges, uppass entries), or None where
        no edge qualifies."""
        if self.is_tip(x):
            return None
        a, b = [c for c in self.adj[x] if c != s]
        edges: List[Tuple[int, int]] = []
        ups = 0
        for end in (a, b):
            if self.is_tip(end):
                continue
            for child in self.adj[end]:
                if child == x:
                    continue
                ups += 1
                stack = [(child, end, 1)]
                while stack:
                    v, par, depth = stack.pop()
                    if depth >= mintrav:
                        edges.append((v, par))
                    if self.is_tip(v) or depth >= maxtrav:
                        continue
                    for c in self.adj[v]:
                        if c != par:
                            ups += 1
                            stack.append((c, v, depth + 1))
        return (edges, ups) if edges else None

    def prune_windows(self, slot: Tuple[int, int], mintrav: int,
                      maxtrav: int) -> List[Tuple[int, int, list, int]]:
        """The scans one lazy SPR step makes at a slot (node p facing
        q = p.back), as (pruned node, subtree neighbour, edges, uppass
        entries): p away from q where one of p's other neighbours is
        inner, then q away from p where one of q's other neighbours has
        an inner neighbour besides q, with a radius of at least 2."""
        p, q = slot
        out = []
        if not self.is_tip(p):
            others = [c for c in self.adj[p] if c != q]
            if any(not self.is_tip(c) for c in others):
                w = self.window(p, q, mintrav, maxtrav)
                if w is not None:
                    out.append((p, q, w[0], w[1]))

        def has_depth(v: int) -> bool:
            return (not self.is_tip(v) and any(
                not self.is_tip(c) for c in self.adj[v] if c != q))

        if not self.is_tip(q) and maxtrav > 0:
            others = [c for c in self.adj[q] if c != p]
            if any(has_depth(c) for c in others):
                w = self.window(q, p, max(mintrav, 2), maxtrav)
                if w is not None:
                    out.append((q, p, w[0], w[1]))
        return out

    def regrafted(self, x: int, s: int, v: int, par: int, t_join: float,
                  t_insert: float) -> "Topology":
        """The tree with node x pruned away from s, its other neighbours
        joined by an edge of length t_join, and x put back on edge
        (v, par), both halves of length t_insert; x -- s keeps its
        length."""
        a, b = [c for c in self.adj[x] if c != s]
        adj = [list(n) for n in self.adj]
        length = dict(self.length)

        def cut(u, w):
            adj[u].remove(w)
            adj[w].remove(u)
            length.pop((u, w) if u < w else (w, u))

        def join(u, w, t):
            adj[u].append(w)
            adj[w].append(u)
            length[(u, w) if u < w else (w, u)] = t

        cut(x, a)
        cut(x, b)
        join(a, b, t_join)
        cut(v, par)
        join(x, v, t_insert)
        join(x, par, t_insert)
        return Topology(self.ntips, adj, length)
