"""Scan tier: device busy ms per insertion in the traced sub-window (the
insertions counted on the benchmark's own tree)."""


def read(m):
    t = m.trace
    if m.kind != "spr" or t is None or not t["work"]:
        return None
    return 1e3 * t["busy_s"] / t["work"]
