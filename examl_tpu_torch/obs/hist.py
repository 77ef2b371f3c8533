"""Log-bucketed latency histograms (stdlib-only).

The port of `examl_tpu/obs/hist.py`, its arithmetic unchanged, so the
two packages' snapshots merge with each other.

A `TimerStat`'s count/total/min/max cannot show a tail: one slow
extension build inside 10,000 sub-millisecond dispatches vanishes into
`total_s`.  Every timer therefore carries one of these: durations land
in geometrically-spaced buckets (20 per decade, ~12% relative width)
spanning 100 ns .. ~10^4 s, so p50/p95/p99 are readable from any
`--metrics` snapshot and two snapshots MERGE exactly (bucket counts
add; quantiles recompute) — the property a supervisor's attempt
merging relies on, and the one min/max/avg fundamentally lacks.

Representation: a sparse `{bucket_index: count}` dict.  Bucket i covers
seconds in `[FLOOR * BASE**i, FLOOR * BASE**(i+1))`; a quantile reports
the geometric midpoint of its bucket, so the relative error is bounded
by half the bucket width (~6%).  Serialized as string-keyed dicts
(JSON round-trip safe).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

# 20 buckets per decade over [1e-7 s, 1e4 s): index range [0, 220).
FLOOR = 1e-7
DECADE_BUCKETS = 20
BASE = 10.0 ** (1.0 / DECADE_BUCKETS)
_LOG_BASE = math.log(BASE)
MAX_INDEX = 11 * DECADE_BUCKETS - 1        # 1e-7 .. 1e4: 11 decades

QUANTILES = (0.5, 0.95, 0.99)


def bucket_index(seconds: float) -> int:
    """The bucket holding `seconds`; durations at or below FLOOR share
    bucket 0 and absurdly long ones clamp to MAX_INDEX (an observation
    must never be droppable)."""
    if seconds <= FLOOR:
        return 0
    i = int(math.log(seconds / FLOOR) / _LOG_BASE)
    return min(max(i, 0), MAX_INDEX)


def bucket_bounds(index: int) -> tuple:
    """[lo, hi) seconds covered by bucket `index`."""
    return (FLOOR * BASE ** index, FLOOR * BASE ** (index + 1))


def bucket_mid(index: int) -> float:
    """Geometric midpoint — the value a quantile inside this bucket
    reports."""
    return FLOOR * BASE ** (index + 0.5)


class Histogram:
    """Sparse log-bucketed histogram of seconds."""

    __slots__ = ("buckets", "count")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0

    def observe(self, seconds: float) -> None:
        i = bucket_index(seconds)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        return quantile_from_buckets(self.buckets, q)

    def quantiles(self, qs: Iterable[float] = QUANTILES) -> dict:
        return {f"p{int(q * 100)}_s": self.quantile(q) for q in qs}

    def to_dict(self) -> Dict[str, int]:
        """JSON-safe sparse form ({str(index): count})."""
        return {str(i): c for i, c in sorted(self.buckets.items())}

    def merge_dict(self, buckets: Dict) -> None:
        """Fold a serialized bucket dict in (snapshot accumulation)."""
        for k, c in (buckets or {}).items():
            i = int(k)
            self.buckets[i] = self.buckets.get(i, 0) + int(c)
            self.count += int(c)


def quantile_from_buckets(buckets: Dict, q: float) -> Optional[float]:
    """The q-quantile of a (possibly serialized, string-keyed) bucket
    dict, or None when empty.  Reports the geometric midpoint of the
    bucket holding the q-th observation."""
    items: List[tuple] = sorted((int(k), int(c))
                                for k, c in (buckets or {}).items())
    total = sum(c for _, c in items)
    if total <= 0:
        return None
    # rank of the target observation, 1-based, ceil(q * total) clamped
    rank = min(total, max(1, math.ceil(q * total)))
    seen = 0
    for i, c in items:
        seen += c
        if seen >= rank:
            return bucket_mid(i)
    return bucket_mid(items[-1][0])


def merge_bucket_dicts(*dicts: Dict) -> Dict[str, int]:
    """Sum serialized bucket dicts (the snapshot-merge primitive)."""
    out: Dict[int, int] = {}
    for d in dicts:
        for k, c in (d or {}).items():
            i = int(k)
            out[i] = out.get(i, 0) + int(c)
    return {str(i): c for i, c in sorted(out.items())}
