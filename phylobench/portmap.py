"""The benchmark's nodes in the program's numbering, and back.

Tips are named `t<i>`, which the program numbers i + 1.  An inner node
is named by its split: the tips on its side away from tip 0, the same
set in either tree whatever the numbering.  Read once at set-up, to
address the nodes the benchmark chose and to read the program's answers.
"""

from __future__ import annotations

from typing import Dict, Tuple

from phylobench.topo import Topology


def node_map(topo: Topology, tree) -> Tuple[Dict[int, int], Dict[int, int]]:
    """(benchmark -> program, program -> benchmark) node numbers."""
    to_port = {i: i + 1 for i in range(topo.ntips)}
    mask: Dict[int, int] = {}
    # The program's tree walked from tip 1 (taxon 0), children first.
    stack = [(tree.nodep[1].back, False)]
    while stack:
        slot, done = stack.pop()
        if tree.is_tip(slot.number):
            mask[id(slot)] = 1 << (slot.number - 1)
            continue
        kids = (slot.next.back, slot.next.next.back)
        if done:
            mask[id(slot)] = mask[id(kids[0])] | mask[id(kids[1])]
            continue
        stack.append((slot, True))
        stack.extend((k, False) for k in kids)
    by_split = {m: v for v, m in topo.tip_sets().items()}
    for num in tree.inner_numbers():
        for slot in tree.slots(num):
            if id(slot) in mask:
                to_port[by_split[mask[id(slot)]]] = num
    if len(to_port) != topo.num_nodes:
        raise ValueError("the program's tree is not the benchmark's")
    return to_port, {p: b for b, p in to_port.items()}
