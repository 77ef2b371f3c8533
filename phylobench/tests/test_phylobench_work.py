"""The frozen byte, flop and work counters against hand counts on a
5-taxon tree, and the radius window against the program's own plan."""

import pytest

from phylobench import work
from phylobench.topo import Topology

# Tips 0..4, inner 5, 6, 7:  (0,1)5 -- 6(2) -- 7(3,4)
ADJ = [[5], [5], [6], [7], [7], [0, 1, 6], [5, 2, 7], [6, 3, 4]]
EDGES = [(0, 5), (1, 5), (5, 6), (2, 6), (6, 7), (3, 7), (4, 7)]


def five():
    return Topology(5, [list(a) for a in ADJ],
                    {e: 0.1 * (i + 1) for i, e in enumerate(EDGES)})


def test_counts_by_hand():
    t = five()
    assert work.full_traversal_counts(t) == (3, 5)
    P, R, K = 1000, 4, 4
    # 3 rows written and 1 inner child read, each a CLV row (P*R*K*4
    # bytes) with its scaler row (P*4); 5 tip children read P bytes.
    assert work.traversal_bytes(3, 5, P, R, K, 4) == 4 * (64000 + 4000) \
        + 5 * 1000
    # 1 inner child x P x 2RK^2 for the P application, 3 entries x P x RK.
    assert work.traversal_flops(3, 5, P, R, K) == 1000 * 128 + 3 * 1000 * 16
    assert work.clv_updates(t, P, R, K) == 3 * 1000 * 16
    # Bandwidth bounds a K = 4 traversal at the H100's peaks.
    b = work.traversal_bytes(3, 5, P, R, K, 4)
    assert work.least_seconds(b, 1) == pytest.approx(b / 3.35e12)


def test_full_traversal_counts_match_the_program():
    from examl_tpu_torch.tree.topology import Tree
    t = five()
    names = [f"t{i}" for i in range(5)]
    tree = Tree.from_newick(t.newick(names), names)
    flat = tree.flat_full_traversal(tree.centroid_branch())
    tips = int((flat.left <= 5).sum() + (flat.right <= 5).sum())
    assert (flat.n, tips) == work.full_traversal_counts(t)


def test_radius_window_by_hand():
    t = five()
    # Tip 0's slot: the tip is pruned with node 5 away from it; the join
    # is 1 -- 6 and radius 2 reaches (3, 7) and (4, 7) from 6.
    (w,) = t.prune_windows((0, 5), 1, 2)
    x, s, edges, ups = w
    assert (x, s) == (5, 0)
    assert sorted(edges) == [(3, 7), (4, 7)]
    assert ups == 4
    # Node 6 facing 5: pruned away from 5 (joins 2 -- 7), then node 5
    # pruned away from 6 (joins 0 -- 1, both tips: no window).
    wins = t.prune_windows((6, 5), 1, 2)
    assert [(x, s, sorted(e)) for x, s, e, _ in wins] == \
        [(6, 5, [(3, 7), (4, 7)])]


def test_slot_order_visits_every_node_once():
    t = five()
    order = t.slot_order()
    assert [u for u, _ in order] == [0, 1, 2, 3, 4, 5, 6, 7]
    assert all(y in t.adj[u] for u, y in order)
