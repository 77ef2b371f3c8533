"""The ONE bytes-per-traversal traffic model.

The port of `examl_tpu/obs/traffic.py`, its arithmetic unchanged: the
model PERF.md quotes for every kernel's bound, and the one the engine
uses for its per-traversal `engine.traffic_bytes` counter, computed on
the host from entry counts and the launch table (never from a device
read).

Model: per traversal entry one CLV row written, each non-tip child's CLV
row read, scaler rows alongside (int32/lane), tip children read 1-byte
code rows; P matrices / tip tables are O(states^2) noise.

The JAX package also classifies a measurement's regime against its TPU
launch floor; the port publishes no verdict (its launches per traversal
do not follow an XLA program count, and its GB/s gauge is modelled
bytes over host wall time, not a device reading), so it has no
classifier.

stdlib only — report tools import this with no torch on the path.
"""

from __future__ import annotations

import numbers
from typing import Optional

# Minimum seconds between `traffic.window` ledger events per tier: the
# gauges always carry the latest window; the ledger gets periodic
# samples, not one line per window.
LEDGER_EVENT_INTERVAL_S = 30.0

# A window closes after this many blocking dispatches or this many
# seconds of their wall time, whichever comes first.
WINDOW_DISPATCHES = 8
WINDOW_WALL_S = 2.0


def bytes_per_traversal_counts(n_entries: int, n_tip_children: int,
                               patterns: int, R: int, K: int,
                               itemsize: int) -> int:
    """Closed-form core of the model: `n_entries` CLV rows written,
    `2*n_entries - n_tip_children` inner-child CLV rows read (each with
    its scaler row), `n_tip_children` 1-byte tip code rows read."""
    clv_row = patterns * R * K * itemsize
    sc_row = patterns * 4
    inner_children = 2 * n_entries - n_tip_children
    return ((n_entries + inner_children) * (clv_row + sc_row)
            + n_tip_children * patterns)


def count_tip_children(entries, ntips: int) -> int:
    """Tip children of a TraversalEntry list (node numbers 1..ntips are
    tips)."""
    n = 0
    for e in entries:
        for ch in (e.left, e.right):
            if isinstance(ch, numbers.Integral) and ch <= ntips:
                n += 1
    return n


def bytes_per_grad_pass(n_entries: int, n_tip_children: int,
                        n_edges: int, patterns: int, R: int, K: int,
                        itemsize: int) -> int:
    """Closed-form model of one whole-tree gradient pass
    (ops/gradient.py): the PRE-ORDER pass reads one outroot row and
    two child partials per entry (tip children read 1-byte code rows,
    like the post-order model) and writes two outroot rows; the
    EDGE-DERIVATIVE contraction then reads one outroot row and one
    down partial per edge (d1/d2 outputs are O(edges) scalars —
    noise).  Shares the post-order model's per-row cost so the "grad"
    tier's achieved-GB/s gauge is comparable with the traversal
    tiers'."""
    clv_row = patterns * R * K * itemsize
    sc_row = patterns * 4
    inner_children = 2 * n_entries - n_tip_children
    pre = ((n_entries + 2 * n_entries) * clv_row      # up reads + writes
           + inner_children * (clv_row + sc_row)      # child CLV reads
           + n_tip_children * patterns)               # child code reads
    edges = n_edges * (2 * clv_row + sc_row)
    return pre + edges


def bytes_per_traversal(entries, ntips: int, patterns: int, R: int,
                        K: int, itemsize: int) -> int:
    """Entry-list form, a thin wrapper over the shared closed form."""
    return bytes_per_traversal_counts(
        len(entries), count_tip_children(entries, ntips), patterns, R,
        K, itemsize)


class TrafficWindow:
    """Windowed achieved-GB/s accumulator for the engine's timed
    (blocking) dispatch path: per blocked dispatch `add()` records
    (bytes, wall seconds); once `min_dispatches` have accumulated or
    `min_wall_s` has been spanned, `add()` returns the window —
    (gbps, dispatches) — and resets.  Windowing keeps the gauge honest
    (a single warm dispatch after a compile would otherwise swing it)
    and cheap (one division per window, not per dispatch)."""

    __slots__ = ("min_dispatches", "min_wall_s", "bytes", "wall", "n")

    def __init__(self, min_dispatches: int = WINDOW_DISPATCHES,
                 min_wall_s: float = WINDOW_WALL_S) -> None:
        self.min_dispatches = min_dispatches
        self.min_wall_s = min_wall_s
        self.bytes = 0
        self.wall = 0.0
        self.n = 0

    def add(self, nbytes: int, wall_s: float) -> Optional[tuple]:
        self.bytes += int(nbytes)
        self.wall += float(wall_s)
        self.n += 1
        if self.n < self.min_dispatches and self.wall < self.min_wall_s:
            return None
        if self.wall <= 0:
            self.__init__(self.min_dispatches, self.min_wall_s)
            return None
        gbps = self.bytes / self.wall / 1e9
        n = self.n
        self.__init__(self.min_dispatches, self.min_wall_s)
        return gbps, n
