"""Instance and chunk tier: host ms per probe inside the program's
evaluate: its `instance:evaluate` spans less their `engine:readback` and
`engine:upload` descendants, the host's waits on the card (the read-back,
and the root's first gather, whose blocking index upload waits for the
traversal queued before it), in the traced sub-window."""

from phylobench import spans

WAITS = ("engine:readback", "engine:upload")


def read(m):
    if m.kind != "probe":
        return None
    got = spans.window(m)
    ns = spans.less_inner(got, "instance:evaluate", WAITS) if got else None
    if ns is None:
        return None
    return ns / 1e6 / m.trace["steps"]
