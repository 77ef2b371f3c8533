"""Models layer: host ms per probe in the program's model set-up (the
outermost `models:*` spans: gamma rates, eigensystems, the push and its
stacked upload), in the traced sub-window."""

from phylobench import spans


def read(m):
    if m.kind != "probe":
        return None
    got = spans.window(m)
    if not got:
        return None
    top = spans.outermost(got, lambda n: n.startswith("models:"))
    if not top:
        return None
    return sum(s.duration for s in top) / 1e6 / m.trace["steps"]
