"""Search: insertions the program scored per batched scan call over the
window (its `search.scan_candidates` / `search.scan_dispatches`
counters)."""


def read(m):
    n = m.counters.get("search.scan_dispatches")
    if m.kind != "spr" or not n:
        return None
    return m.counters["search.scan_candidates"] / n
