"""Instance and chunk tier: MB (1e6 bytes) of P matrices and the tip
products built from them per probe (the `p_bytes` counts of the
program's `engine:operands` spans), in the traced sub-window."""

from phylobench import spans


def read(m):
    if m.kind != "probe":
        return None
    got = spans.window(m)
    ops = [s for s in got or () if s.name == "engine:operands"]
    if not ops:
        return None
    return sum((s.args or {}).get("p_bytes", 0) for s in ops) / 1e6 / \
        m.trace["steps"]
