"""Search: host ms per insertion in the program's prunes: the
`search:rearrange` spans less their `engine:spr_scan` and `engine:newton`
descendants (the batched scan and the prune's own branch step, engine
ops that end in a read-back: the card's work and the host's wait for
it), so what is left is the plan, the scan's set-up and the bookkeeping,
in the traced sub-window; insertions counted on the benchmark's own
tree."""

from phylobench import spans

DEVICE_OPS = ("engine:spr_scan", "engine:newton")


def read(m):
    if m.kind != "spr":
        return None
    got = spans.window(m)
    ns = spans.less_inner(got, "search:rearrange", DEVICE_OPS) \
        if got else None
    if ns is None or not m.trace["work"]:
        return None
    return ns / 1e6 / m.trace["work"]
