"""Unrooted binary tree with node-triple inner nodes and CLV orientation flags.

Host-side topology bookkeeping, the same data model as the reference
(ExaML `axml.h:492-506` `node`/`nodeptr`, `newviewGenericSpecial.c:691`
`computeTraversalInfo`): tips are numbered 1..n, inner nodes n+1..2n-2; an
inner node is a cycle of three slots (`next` pointers); each slot has a
`back` pointer across a branch; the `x` flag marks which of a cycle's slots
the node's single CLV is currently oriented towards (the CLV summarizes the
subtree away from that slot's `back`).

The device engine (ops/engine.py) never sees this structure — only flat
traversal descriptors produced here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from examl_tpu_torch.constants import DEFAULTZ, ZMAX, ZMIN
from examl_tpu_torch.io.newick import NewickNode, format_newick, parse_newick
from examl_tpu_torch.resilience import heartbeat


class Node:
    __slots__ = ("number", "back", "next", "z", "x")

    def __init__(self, number: int):
        self.number = number
        self.back: Optional[Node] = None
        self.next: Optional[Node] = None
        self.z: List[float] = []
        self.x: bool = False

    def __repr__(self):
        b = self.back.number if self.back else None
        return f"<Node {self.number} back={b} x={self.x}>"


_TOPO_CLOCK = [0]
"""Global monotonic topology clock: bumped by every `hookup` that
CHANGES a back pointer (pure branch-length rewrites of an existing
branch don't count).  Every topology mutation in the codebase — SPR
prune/regraft, NNI-style swaps, tree construction, snapshot restore —
passes through `hookup` with at least one changed back pointer, so a
tree whose traversal caches carry an unchanged clock value is
guaranteed structurally identical (the cheap validity check behind
`Tree.flat_full_traversal`'s host-side caching)."""


def hookup(p: Node, q: Node, z: Sequence[float]) -> None:
    """Connect two slots with a shared branch-length vector."""
    if p.back is not q or q.back is not p:
        _TOPO_CLOCK[0] += 1
    p.back = q
    q.back = p
    shared = [min(max(v, ZMIN), ZMAX) for v in z]
    p.z = shared
    q.z = shared


class TraversalEntry:
    """One inner-node CLV update: parent from (left, right) children."""
    __slots__ = ("parent", "left", "right", "zl", "zr")

    def __init__(self, parent: int, left: int, right: int,
                 zl: Sequence[float], zr: Sequence[float]):
        self.parent = parent
        self.left = left
        self.right = right
        self.zl = tuple(zl)
        self.zr = tuple(zr)

    def __repr__(self):
        return f"TE(p={self.parent},l={self.left},r={self.right})"


class FlatTraversal:
    """Array-form FULL traversal rooted at an edge (tentpole of the host-
    path scale work): entry i recomputes inner node ``parent[i]`` from
    children ``(left[i], right[i])`` with branch-length vectors
    ``zl[i]/zr[i]``.  Entries are wave-major (ASAP level order, exactly
    `Tree.schedule_waves` semantics) so consumers never re-derive the
    dependency structure.

    ``topo_key`` digests ONLY the structural arrays (parent/left/right
    + ntips) — it identifies the schedule STRUCTURE independent of
    branch lengths, which is what lets the engine cache the expensive
    chunk layout and refresh only z on repeated fixed-topology
    traversals (ops/engine.py sched cache).  The digest is 128-bit
    blake2b: self-validating, so SPR/NNI topology changes can never be
    served a stale structure even without an explicit invalidation
    call.
    """

    __slots__ = ("parent", "left", "right", "zl", "zr", "wave_sizes",
                 "n", "ntips", "topo_key", "_entries")

    def __init__(self, parent, left, right, zl, zr, wave_sizes,
                 ntips: int):
        import hashlib
        self.parent = parent          # [n] int64 node numbers
        self.left = left              # [n] int64
        self.right = right            # [n] int64
        self.zl = zl                  # [n, C] float64
        self.zr = zr                  # [n, C] float64
        self.wave_sizes = wave_sizes  # [n_waves] int64
        self.n = int(parent.shape[0])
        self.ntips = ntips
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64(ntips).tobytes())
        h.update(np.ascontiguousarray(parent, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(left, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(right, dtype=np.int64).tobytes())
        self.topo_key = h.digest()
        self._entries: Optional[List[TraversalEntry]] = None

    def to_entries(self) -> List[TraversalEntry]:
        """Materialize as the legacy TraversalEntry list (scan-tier /
        PSR / SEV consumers).  Wave-major order is a valid post-order,
        so `Tree.schedule_waves` reproduces the identical waves.
        Memoized — multiple engines share one conversion."""
        if self._entries is None:
            zl = self.zl.tolist()
            zr = self.zr.tolist()
            self._entries = [
                TraversalEntry(p, l, r, a, b)
                for p, l, r, a, b in zip(self.parent.tolist(),
                                         self.left.tolist(),
                                         self.right.tolist(), zl, zr)]
        return self._entries

    def __len__(self) -> int:
        return self.n


class Tree:
    """Unrooted strictly-binary tree over tips 1..ntips."""

    def __init__(self, ntips: int, num_branches: int = 1):
        if ntips < 3:
            raise ValueError("need at least 3 taxa for an unrooted tree")
        self.ntips = ntips
        self.num_branches = num_branches
        self.nodep: Dict[int, Node] = {}          # canonical slot per number
        for i in range(1, ntips + 1):
            self.nodep[i] = Node(i)
        self._next_inner = ntips + 1
        # Host-side traversal caches, validated against _TOPO_CLOCK
        # (flat_full_traversal structures; the memoized centroid edge).
        self._flat_caches: Dict[int, dict] = {}
        self._centroid_cache: Optional[Tuple[int, Node]] = None

    # -- structure helpers -------------------------------------------------

    @property
    def max_nodes(self) -> int:
        return 2 * self.ntips - 2

    def is_tip(self, number: int) -> bool:
        return number <= self.ntips

    def new_inner(self) -> Node:
        """Allocate an inner node (cycle of three slots)."""
        num = self._next_inner
        if num > self.max_nodes:
            raise RuntimeError("inner node overflow")
        self._next_inner += 1
        a, b, c = Node(num), Node(num), Node(num)
        a.next, b.next, c.next = b, c, a
        self.nodep[num] = a
        return a

    def slots(self, number: int):
        p = self.nodep[number]
        if self.is_tip(number):
            return (p,)
        return (p, p.next, p.next.next)

    def default_z(self) -> List[float]:
        return [DEFAULTZ] * self.num_branches

    @property
    def start(self) -> Node:
        return self.nodep[1]

    def orient(self, p: Node) -> None:
        """Set the x flag of p's cycle onto slot p."""
        if self.is_tip(p.number):
            return
        p.x = True
        p.next.x = False
        p.next.next.x = False

    # -- construction ------------------------------------------------------

    @classmethod
    def from_newick(cls, text: str, taxon_names: Sequence[str],
                    num_branches: int = 1) -> "Tree":
        root = parse_newick(text)
        root = _deroot(root)
        name_to_num = {n: i + 1 for i, n in enumerate(taxon_names)}
        leaves = list(root.leaves())
        if len(leaves) != len(taxon_names):
            raise ValueError(
                f"tree has {len(leaves)} taxa, alignment has {len(taxon_names)}")
        tree = cls(len(taxon_names), num_branches)

        def build(nw: NewickNode) -> Node:
            """Return the slot representing subtree nw, to be hooked upward.

            Iterative post-order (results memoized by id) — reference-scale
            trees exceed the recursion limit (SURVEY §6)."""
            done: Dict[int, Node] = {}
            stack: List[Tuple[NewickNode, bool]] = [(nw, False)]
            steps = 0
            while stack:
                steps += 1
                if not (steps & 0xFFFF):
                    # Liveness during a large build: a stall detector
                    # must see setup phases breathing.
                    heartbeat.phase_beat("PARSE")
                n, expanded = stack.pop()
                if n.is_leaf:
                    try:
                        done[id(n)] = tree.nodep[name_to_num[n.name]]
                    except KeyError:
                        raise ValueError(f"taxon {n.name!r} not in alignment")
                    continue
                if len(n.children) != 2:
                    raise ValueError(
                        "multifurcating inner node (resolve first)")
                if not expanded:
                    stack.append((n, True))
                    stack.extend((c, False) for c in n.children)
                    continue
                inner = tree.new_inner()
                for slot, child in zip((inner.next, inner.next.next),
                                       n.children):
                    hookup(slot, done.pop(id(child)),
                           _z_of(child, num_branches))
                done[id(n)] = inner
            return done[id(nw)]

        if len(root.children) != 3:
            raise ValueError("expected unrooted (trifurcating) tree after derooting")
        center = tree.new_inner()
        c0, c1, c2 = root.children
        hookup(center, build(c0), _z_of(c0, num_branches))
        hookup(center.next, build(c1), _z_of(c1, num_branches))
        hookup(center.next.next, build(c2), _z_of(c2, num_branches))
        tree._check_connected()
        return tree

    @classmethod
    def random(cls, taxon_names: Sequence[str], seed: int = 0,
               num_branches: int = 1) -> "Tree":
        """Stepwise random-addition topology (no likelihood): start from a
        3-taxon star, insert each remaining tip on a uniformly random branch."""
        rng = np.random.default_rng(seed)
        n = len(taxon_names)
        tree = cls(n, num_branches)
        order = rng.permutation(n) + 1
        center = tree.new_inner()
        hookup(center, tree.nodep[int(order[0])], tree.default_z())
        hookup(center.next, tree.nodep[int(order[1])], tree.default_z())
        hookup(center.next.next, tree.nodep[int(order[2])], tree.default_z())
        # Incremental branch list: each insertion splits one branch into
        # three, so the candidate set updates in O(1) instead of a full
        # all_branches() sweep — O(n) total, which is what makes the
        # reference-scale ~120k-taxon regime (SURVEY §6) reachable
        # (the O(n^2) sweep took hours at 50k taxa).
        branches = [(center, center.back),
                    (center.next, center.next.back),
                    (center.next.next, center.next.next.back)]
        for step, num in enumerate(order[3:]):
            if not (step & 0xFFFF):
                heartbeat.phase_beat("PARSE")
            i = int(rng.integers(len(branches)))
            p, q = branches[i]
            inner = tree.new_inner()
            hookup(inner.next, p, p.z)
            hookup(inner.next.next, q, tree.default_z())
            tip = tree.nodep[int(num)]
            hookup(inner, tip, tree.default_z())
            branches[i] = (p, p.back)
            branches.append((q, q.back))
            branches.append((tip, tip.back))
        tree._check_connected()
        return tree

    def _check_connected(self) -> None:
        for num in range(1, self._next_inner):
            for slot in self.slots(num):
                assert slot.back is not None, f"dangling slot at node {num}"

    # -- traversal descriptors --------------------------------------------

    def compute_traversal(self, p: Node, full: bool) -> List[TraversalEntry]:
        """Post-order list of CLV updates so that slot p's CLV is valid.

        The top node p is ALWAYS recomputed (orientation flags do not track
        branch-length changes, so the point-of-use CLV must be refreshed);
        partial traversals prune only descendants whose x flag is already
        oriented correctly.  Exactly the reference `computeTraversalInfo`
        semantics (`newviewGenericSpecial.c:691-813`: children recurse only
        on `!x || !partialTraversal`, while p itself is appended
        unconditionally).

        Iterative post-order (explicit stack): the reference ambition is
        ~120k taxa (SURVEY §6), far beyond Python's recursion limit.
        """
        entries: List[TraversalEntry] = []
        # (slot, expanded?) — post-order via a two-visit stack.
        stack: List[Tuple[Node, bool]] = [(p, False)]
        top = True
        while stack:
            s, expanded = stack.pop()
            if self.is_tip(s.number):
                continue
            if expanded:
                q = s.next.back
                r = s.next.next.back
                entries.append(
                    TraversalEntry(s.number, q.number, r.number, q.z, r.z))
                self.orient(s)
                continue
            if not full and s.x and not top:
                continue
            top = False
            stack.append((s, True))
            stack.append((s.next.next.back, False))
            stack.append((s.next.back, False))
        return entries

    @staticmethod
    def schedule_waves(entries: List[TraversalEntry]) -> List[List[TraversalEntry]]:
        """Group a post-order traversal into dependency waves.

        Wave k contains entries whose children are tips, stale-free CLVs, or
        parents of waves < k (ASAP level scheduling).  All entries of one
        wave are independent, so the device executes them as one batched
        newview step — the TPU replacement for the reference's strictly
        sequential traversal replay (`newviewIterative`,
        `newviewGenericSpecial.c:917-1515`).

        Large traversals (full-tree rebuilds at reference scale, SURVEY
        §6) take a vectorized path: level propagation runs as numpy
        scatter/gather per wave instead of a per-entry dict crawl, which
        is what keeps a 120k-taxon wave schedule at array rate.  The
        vectorized branch requires each parent to appear once (always
        true for full traversals); repeated parents — merged multi-root
        partial traversals (search/batchscan.py) — keep the loop, whose
        last-write-wins level semantics they rely on.
        """
        n = len(entries)
        if n >= 512:
            parent = np.fromiter((e.parent for e in entries), np.int64, n)
            uniq = np.unique(parent)
            if uniq.shape[0] == n:
                left = np.fromiter((e.left for e in entries), np.int64, n)
                right = np.fromiter((e.right for e in entries), np.int64, n)
                order, wave_sizes = _wave_order(parent, left, right)
                waves = []
                off = 0
                for w in wave_sizes:
                    waves.append([entries[i] for i in order[off:off + w]])
                    off += w
                return waves
        level: Dict[int, int] = {}
        waves: List[List[TraversalEntry]] = []
        for e in entries:
            lv = max(level.get(e.left, 0), level.get(e.right, 0))
            level[e.parent] = lv + 1
            if lv == len(waves):
                waves.append([])
            waves[lv].append(e)
        return waves

    def flat_full_traversal(self, p: Node) -> FlatTraversal:
        """Array-rate full traversal rooted at the edge (p, p.back).

        The vectorized replacement for the full-traversal branch of
        `compute_traversal` + `schedule_waves` + per-entry schedule
        assembly: ONE minimal Python pass extracts the pointer structure
        into numpy arrays (the unavoidable cost of leaving the
        reference's node-cycle data model), then rooting (frontier BFS),
        ASAP wave levels (Kahn), and entry assembly all run as array
        ops.  Equivalent to `invalidate_all()` followed by
        `compute_traversal(p, full=True)` + `compute_traversal(p.back,
        full=True)`: the same entry set, the same wave partition, and
        the same final x-flag orientation (every inner node oriented
        toward the root edge) — proven by tests/test_sched_cache.py.

        The structural result (rooting, wave order, child arrays) is a
        function of topology + root edge only, so it is cached on the
        tree and validated against the module topology clock (`hookup`
        bumps it on every back-pointer change): the branch-length-only
        traversals that dominate model optimization and makenewz rounds
        re-read just the z vectors and re-orient the x flags.
        """
        cache = self._flat_caches.get(id(p))
        if (cache is not None and cache["clock"] == _TOPO_CLOCK[0]
                and cache["root"] is p):
            return self._flat_from_cache(cache)
        cache = self._flat_build_cache(p)
        self._flat_caches[id(p)] = cache
        while len(self._flat_caches) > 4:
            self._flat_caches.pop(next(iter(self._flat_caches)))
        return self._flat_from_cache(cache)

    def _flat_build_cache(self, p: Node) -> dict:
        """The structural (topology + root only) half of a flat full
        traversal; everything here is skipped on a cache hit."""
        ntips = self.ntips
        n_inner = self._next_inner - ntips - 1
        q = p.back
        heartbeat.phase_beat("SCHEDULE")
        # 1. Extraction: canonical slot triples -> neighbor numbers
        #    (tight loop, tiny body; flat int list -> one np.fromiter).
        nodep = self.nodep
        nb_flat: List[int] = []
        extend = nb_flat.extend
        slot0: List[Node] = []
        sappend = slot0.append
        for num in range(ntips + 1, self._next_inner):
            s0 = nodep[num]
            s1 = s0.next
            s2 = s1.next
            extend((s0.back.number, s1.back.number, s2.back.number))
            sappend(s0)
            if not (num & 0xFFFF):
                heartbeat.phase_beat("SCHEDULE")
        nb = np.fromiter(nb_flat, np.int64, 3 * n_inner).reshape(-1, 3)
        # 2. Rooting: frontier BFS from the edge endpoints assigns each
        #    inner node the slot index facing the root edge.
        parent_j = np.full(n_inner, -1, dtype=np.int64)
        init = []
        for s in (p, q):
            if s.number > ntips:
                i = s.number - ntips - 1
                c = nodep[s.number]
                j = 0 if s is c else (1 if s is c.next else 2)
                parent_j[i] = j
                init.append(i)
        frontier = np.asarray(init, dtype=np.int64)
        while frontier.size:
            k = frontier.shape[0]
            keep = np.ones((k, 3), dtype=bool)
            keep[np.arange(k), parent_j[frontier]] = False
            cand = nb[frontier][keep]                     # [2k] slot order
            m = cand > ntips
            new_nums = cand[m]
            if not new_nums.size:
                break
            new_idx = new_nums - ntips - 1
            par_nums = np.repeat(frontier + ntips + 1, 2)[m]
            parent_j[new_idx] = np.argmax(
                nb[new_idx] == par_nums[:, None], axis=1)
            frontier = new_idx
        assert (parent_j >= 0).all(), "tree not connected from root edge"
        # 3. Children in slot order from the parent-facing slot — exactly
        #    compute_traversal's (s.next.back, s.next.next.back).
        ar = np.arange(n_inner)
        lj = (parent_j + 1) % 3
        rj = (parent_j + 2) % 3
        left = nb[ar, lj]
        right = nb[ar, rj]
        parent_nums = ar + ntips + 1
        # 4. ASAP wave order (vectorized Kahn).
        order, wave_sizes = _wave_order(parent_nums, left, right)
        heartbeat.phase_beat("SCHEDULE")
        # 5. The z-read plan: the slot objects owning each sorted entry's
        #    two branch vectors (z lists may be REBOUND by hookup, so the
        #    cache holds the slots, not the lists).
        slot_at = {0: slot0, 1: [s.next for s in slot0],
                   2: [s.next.next for s in slot0]}
        ot = order.tolist()
        ljt = lj.tolist()
        rjt = rj.tolist()
        zl_slots = [slot_at[ljt[i]][i] for i in ot]
        zr_slots = [slot_at[rjt[i]][i] for i in ot]
        proto = FlatTraversal(parent_nums[order], left[order],
                              right[order],
                              np.ones((n_inner, self.num_branches)),
                              np.ones((n_inner, self.num_branches)),
                              wave_sizes, ntips)
        return {"clock": _TOPO_CLOCK[0], "root": p, "proto": proto,
                "slot0": slot0, "pj": parent_j.tolist(),
                "zl_slots": zl_slots, "zr_slots": zr_slots}

    def _flat_from_cache(self, cache: dict) -> FlatTraversal:
        """The per-call half: re-read branch vectors through the cached
        slot plan, re-orient the x flags, stamp fresh z arrays onto the
        cached structural prototype."""
        proto = cache["proto"]
        C = self.num_branches
        if C == 1:
            zl = np.fromiter((s.z[0] for s in cache["zl_slots"]),
                             np.float64, proto.n).reshape(-1, 1)
            zr = np.fromiter((s.z[0] for s in cache["zr_slots"]),
                             np.float64, proto.n).reshape(-1, 1)
        else:
            zl = np.asarray([s.z for s in cache["zl_slots"]], np.float64)
            zr = np.asarray([s.z for s in cache["zr_slots"]], np.float64)
        for s0, j in zip(cache["slot0"], cache["pj"]):
            s1 = s0.next
            s2 = s1.next
            s0.x = j == 0
            s1.x = j == 1
            s2.x = j == 2
        flat = FlatTraversal.__new__(FlatTraversal)
        flat.parent = proto.parent
        flat.left = proto.left
        flat.right = proto.right
        flat.zl = zl
        flat.zr = zr
        flat.wave_sizes = proto.wave_sizes
        flat.n = proto.n
        flat.ntips = proto.ntips
        flat.topo_key = proto.topo_key
        flat._entries = None
        return flat

    def full_traversal(self) -> Tuple[Node, List[TraversalEntry]]:
        """Traversal making both ends of the branch at `start` valid."""
        p = self.start.back
        entries = self.compute_traversal(p, full=True)
        return p, entries

    def centroid_branch(self) -> Node:
        """A slot on the topological center branch of the tree.

        Rooting full traversals here minimizes the dependency depth of the
        wave schedule (≈ tree radius instead of height from an arbitrary
        tip), which on TPU sets the number of sequential newview steps —
        the analogue of picking a good virtual root, a freedom the
        reference's strictly sequential `newviewIterative` never needed.
        Classic double-BFS: the middle edge of a diameter path.
        Memoized against the topology clock — the centroid is a function
        of topology alone, and the double-BFS is an interpreter-rate
        walk that would otherwise dominate every cached full traversal
        at reference scale.
        """
        from collections import deque

        if (self._centroid_cache is not None
                and self._centroid_cache[0] == _TOPO_CLOCK[0]):
            return self._centroid_cache[1]

        def bfs(src: Node):
            # Walk slots; returns (farthest tip number, parents map by id).
            dist = {src.number: 0}
            prev: Dict[int, int] = {}
            dq = deque([src])
            far = src
            while dq:
                s = dq.popleft()
                for slot in self.slots(s.number):
                    nb = slot.back
                    if nb is None or nb.number in dist:
                        continue
                    dist[nb.number] = dist[s.number] + 1
                    prev[nb.number] = s.number
                    if dist[nb.number] > dist[far.number]:
                        far = self.nodep[nb.number]
                    dq.append(self.nodep[nb.number])
            return far, dist, prev

        a, _, _ = bfs(self.start)
        b, dist, prev = bfs(a)
        # middle of the a->b path
        path = [b.number]
        while path[-1] != a.number:
            path.append(prev[path[-1]])
        mid = path[len(path) // 2]
        mid_next = path[max(len(path) // 2 - 1, 0)]
        # return the slot of `mid` whose back is `mid_next`
        out = self.nodep[mid]
        for slot in self.slots(mid):
            if slot.back is not None and slot.back.number == mid_next:
                out = slot
                break
        self._centroid_cache = (_TOPO_CLOCK[0], out)
        return out

    def full_traversal_centroid(self) -> Tuple[Node, List[TraversalEntry]]:
        """Full traversal rooted at the centroid branch (minimum wave depth)."""
        s = self.centroid_branch()
        if self.is_tip(s.number):
            s = s.back
        self.invalidate_all()
        entries = self.compute_traversal(s, full=True)
        if not self.is_tip(s.back.number):
            entries += self.compute_traversal(s.back, full=True)
        return s, entries

    def reset_branches(self) -> None:
        """Set every branch back to the default length (reference
        `resetBranches`, `optimizeModel.c:2510-2530`)."""
        for p, _ in self.all_branches():
            p.z[:] = [DEFAULTZ] * len(p.z)
        self.invalidate_all()

    def invalidate_all(self) -> None:
        for num in range(self.ntips + 1, self._next_inner):
            for slot in self.slots(num):
                slot.x = False

    # -- enumeration -------------------------------------------------------

    def all_branches(self) -> List[Tuple[Node, Node]]:
        """Each branch once, as (slot, slot.back)."""
        out: List[Tuple[Node, Node]] = []
        seen = set()
        for num in range(1, self._next_inner):
            for slot in self.slots(num):
                if slot.back is None:
                    continue
                key = id(slot.z)
                if key in seen:
                    continue
                seen.add(key)
                out.append((slot, slot.back))
        return out

    def inner_numbers(self) -> List[int]:
        return list(range(self.ntips + 1, self._next_inner))

    # -- newick export -----------------------------------------------------

    def to_newick(self, taxon_names: Sequence[str], with_lengths: bool = True,
                  branch_index: int = 0) -> str:
        def t_of(z: float) -> float:
            return -np.log(min(max(z, ZMIN), ZMAX))

        def rec(slot: Node) -> NewickNode:
            # Iterative post-order build (tree height can exceed the
            # recursion limit at reference scale, SURVEY §6).
            top = NewickNode()
            stack = [(slot, top)]
            while stack:
                s, nw = stack.pop()
                if self.is_tip(s.number):
                    nw.name = taxon_names[s.number - 1]
                    continue
                for sl in (s.next, s.next.next):
                    child = NewickNode(length=t_of(sl.z[branch_index]))
                    nw.children.append(child)
                    stack.append((sl.back, child))
            return top

        # Standard unrooted export: trifurcation at start.back with the
        # starting tip as one child (reference Tree2String starts at
        # tr->start->back, `treeIO.c:324`).
        start = self.start           # tip 1
        root = NewickNode()
        inner = rec(start.back)
        root.children = [NewickNode(name=taxon_names[start.number - 1],
                                    length=t_of(start.z[branch_index]))]
        root.children.extend(inner.children)
        return format_newick(root, with_lengths=with_lengths)


def _wave_order(parent: np.ndarray, left: np.ndarray,
                right: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ASAP wave scheduling over entry arrays (parents must
    be unique).  Returns (order, wave_sizes): `order` lists entry
    indices wave-major, ascending within each wave — identical
    membership AND order to the dict-based `Tree.schedule_waves` on the
    same input.  Per-wave work is numpy scatter/gather, so the total
    cost is O(n) plus a small fixed overhead per wave (= schedule
    depth), instead of a per-entry interpreter crawl."""
    n = parent.shape[0]
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    maxnum = int(max(parent.max(), left.max(), right.max())) + 1
    pos = np.full(maxnum, -1, dtype=np.int64)
    pos[parent] = np.arange(n)
    li = pos[left]                    # entry computing the left child, -1
    ri = pos[right]                   # if the child is a tip / external
    remaining = (li >= 0).astype(np.int64) + (ri >= 0)
    # Reverse adjacency (entry -> dependents), grouped by sorting.
    child_idx = np.concatenate([li, ri])
    dep_entry = np.concatenate([np.arange(n), np.arange(n)])
    m = child_idx >= 0
    child_idx = child_idx[m]
    dep_entry = dep_entry[m]
    so = np.argsort(child_idx, kind="stable")
    child_sorted = child_idx[so]
    dep_sorted = dep_entry[so]
    starts = np.searchsorted(child_sorted, np.arange(n))
    ends = np.searchsorted(child_sorted, np.arange(n), side="right")
    order_parts: List[np.ndarray] = []
    wave_sizes: List[int] = []
    frontier = np.flatnonzero(remaining == 0)
    scheduled = 0
    while frontier.size:
        order_parts.append(frontier)
        wave_sizes.append(int(frontier.size))
        scheduled += int(frontier.size)
        counts = ends[frontier] - starts[frontier]
        total = int(counts.sum())
        if total == 0:
            break
        seg0 = np.cumsum(counts) - counts
        idx = (np.repeat(starts[frontier], counts)
               + np.arange(total) - np.repeat(seg0, counts))
        deps = dep_sorted[idx]
        np.subtract.at(remaining, deps, 1)
        cand = np.unique(deps)
        frontier = cand[remaining[cand] == 0]
    if scheduled != n:
        raise ValueError(
            f"cyclic or disconnected traversal: scheduled {scheduled} "
            f"of {n} entries")
    return np.concatenate(order_parts), np.asarray(wave_sizes, np.int64)


def _z_of(nw: NewickNode, num_branches: int) -> List[float]:
    if nw.length is None:
        return [DEFAULTZ] * num_branches
    z = float(np.exp(-max(nw.length, 0.0)))
    z = min(max(z, ZMIN), ZMAX)
    return [z] * num_branches


def _deroot(root: NewickNode) -> NewickNode:
    """Collapse a bifurcating root into an unrooted trifurcation."""
    while len(root.children) == 2:
        a, b = root.children
        if a.is_leaf and b.is_leaf:
            raise ValueError("two-taxon tree is not supported")
        inner, other = (a, b) if not a.is_leaf else (b, a)
        ta = a.length or 0.0
        tb = b.length or 0.0
        other.length = ta + tb
        new_root = NewickNode(children=list(inner.children) + [other])
        root = new_root
    return root
