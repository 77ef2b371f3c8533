"""The program's own spans over the traced sub-window, for the per-layer
readers of `metrics/` whose source is `program_span`.

`examl_tpu_torch.obs.trace` records a span only while someone traces the
process, and the benchmark traces only its profiler window, so what the
recorder holds after a traced run is that window's spans.  A checkout
whose program has no recorder, a run without a device trace (the CPU)
and a window with no span give None, and the metric is left out.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


def window(m) -> Optional[list]:
    """The recorded spans that opened inside the traced sub-window: from
    the window's length before the last span's end (which lies inside it)
    on, so that a window traced earlier in the same process stays out."""
    t = m.trace
    if t is None or not t.get("steps"):
        return None
    try:
        from examl_tpu_torch.obs.trace import recorded
    except ImportError:
        return None
    spans = recorded()
    if not spans:
        return None
    since = max(s.end for s in spans) - int(t["window_s"] * 1e9)
    return [s for s in spans if s.start >= since] or None


def _ancestors(span, by_index: Dict[int, object]):
    s = by_index.get(span.parent)
    while s is not None:
        yield s
        s = by_index.get(s.parent)


def outermost(spans: list, test: Callable[[str], bool]) -> List[object]:
    """The spans whose name passes `test` and none of whose ancestors'
    does."""
    by_index = {s.index: s for s in spans}
    return [s for s in spans if test(s.name) and
            not any(test(a.name) for a in _ancestors(s, by_index))]


def less_inner(spans: list, outer: str, inner) -> Optional[int]:
    """ns: the durations of the spans named `outer`, less the durations of
    their outermost descendants whose name is in `inner`; None where no
    span is named `outer`."""
    by_index = {s.index: s for s in spans}
    outers = [s for s in spans if s.name == outer]
    if not outers:
        return None
    total = sum(s.duration for s in outers)
    for s in spans:
        if s.name not in inner:
            continue
        for a in _ancestors(s, by_index):
            if a.name in inner:
                break
            if a.name == outer:
                total -= s.duration
                break
    return total
