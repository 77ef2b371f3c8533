"""The port's constraint trees (-g) against the JAX package's.

`load_constraint` resolves a multifurcating constraint tree into the same
binary newick as the JAX package for the same seed, and `insertion_ok`
gives the same answer for every (pruned node, insertion branch) pair of a
10-taxon tree, with the subtree pruned as the SPR search prunes it.
"""

import pytest

from examl_tpu.tree import constraint as jconstraint
from examl_tpu.tree.topology import hookup as jhookup
from examl_tpu_torch.tree import constraint
from examl_tpu_torch.tree.topology import hookup

NAMES = [f"t{i}" for i in range(10)]
CONSTRAINTS = ["((t0,t1,t2),(t3,t4),t5,t6,(t7,t8,t9));",
               "(((t0,t1),(t2,t3,t4)),(t5,t6,t7,t8,t9));"]


@pytest.mark.parametrize("text", CONSTRAINTS)
@pytest.mark.parametrize("seed", [1, 12345])
def test_load_constraint_resolves_like_jax(text, seed):
    tree, tc = constraint.load_constraint(text, NAMES, seed)
    jtree, jtc = jconstraint.load_constraint(text, NAMES, seed)
    assert tree.to_newick(NAMES) == jtree.to_newick(NAMES)
    assert tc.tip_cluster == jtc.tip_cluster


def _reachable(slot):
    """Every slot of the tree part that `slot` lies in, skipping detached
    back pointers."""
    seen, stack, out = set(), [slot], []
    while stack:
        s = stack.pop()
        if id(s) in seen:
            continue
        seen.add(id(s))
        out.append(s)
        for t in (s.back, s.next):
            if t is not None:
                stack.append(t)
    return out


@pytest.mark.parametrize("text", CONSTRAINTS)
def test_insertion_ok_matches_jax_on_every_pair(text):
    tree, tc = constraint.load_constraint(text, NAMES, 7)
    jtree, jtc = jconstraint.load_constraint(text, NAMES, 7)
    pairs = allowed = 0
    for num in range(tree.ntips + 1, tree.max_nodes + 1):
        for k, p in enumerate(tree.slots(num)):
            jp = jtree.slots(num)[k]
            sides = []
            for pp, hk in ((p, hookup), (jp, jhookup)):
                q, r = pp.next.back, pp.next.next.back
                sides.append((q, r, list(q.z), list(r.z)))
                hk(q, r, list(q.z))
                pp.next.back = pp.next.next.back = None
            pruned = tc.clusters_behind(p.back)
            jpruned = jtc.clusters_behind(jp.back)
            assert pruned == jpruned
            for s in _reachable(sides[0][0]):
                if s.back is None:
                    continue
                js = jtree.slots(s.number)[tree.slots(s.number).index(s)] \
                    if not tree.is_tip(s.number) else jtree.nodep[s.number]
                ok = tc.insertion_ok(p, s, pruned)
                assert ok == jtc.insertion_ok(jp, js, jpruned), \
                    (num, k, s.number)
                pairs += 1
                allowed += ok
            for pp, hk, (q, r, qz, rz) in ((p, hookup, sides[0]),
                                           (jp, jhookup, sides[1])):
                hk(pp.next, q, qz)
                hk(pp.next.next, r, rz)
    assert pairs > 400 and 0 < allowed < pairs
    assert tree.to_newick(NAMES) == jtree.to_newick(NAMES)
