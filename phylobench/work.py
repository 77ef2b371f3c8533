"""Work a traffic step needs, counted from shapes, and the table of peaks.

Frozen copies of the program's modelled traffic (the closed form of
`examl_tpu_torch/obs/traffic.py`, and `traversal_bytes` /
`traversal_flops` of `chip_smoke.py`), taken over the benchmark's own
tree and the real (unpadded) pattern count, so that they read the same
whatever implements the traversal.
"""

from __future__ import annotations

import json
from pathlib import Path

from phylobench.topo import Topology

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def full_traversal_counts(topo: Topology):
    """(entries, tip children) of one full traversal rooted at an edge
    between two inner nodes: every inner node is one entry, and every tip
    is read once as a child."""
    return topo.ntips - 2, topo.ntips


def traversal_bytes(entries: int, tip_children: int, patterns: int, R: int,
                    K: int, itemsize: int) -> int:
    """Each entry writes one CLV row and its scaler row, each inner child
    is read once with its scaler row, each tip child reads 1-byte
    codes."""
    clv_row = patterns * R * K * itemsize
    sc_row = patterns * 4
    inner_children = 2 * entries - tip_children
    return ((entries + inner_children) * (clv_row + sc_row)
            + tip_children * patterns)


def traversal_flops(entries: int, tip_children: int, patterns: int, R: int,
                    K: int) -> int:
    """2*R*K*K per inner child per site (the P application) plus R*K
    products per entry."""
    return ((2 * entries - tip_children) * patterns * 2 * R * K * K
            + entries * patterns * R * K)


def clv_updates(topo: Topology, patterns: int, R: int, K: int) -> int:
    """Site-CLV updates of one full traversal: inner entries x patterns x
    R x K."""
    return full_traversal_counts(topo)[0] * patterns * R * K


def least_seconds(nbytes: int, flops: int, chips: int = 1) -> float:
    """The least time the chips could take: the larger of bytes over
    peak bandwidth and f32 operations over the f32 peak."""
    peak = PEAKS["NVIDIA H100"]
    return max(nbytes / (chips * peak["hbm_bytes_per_s"]),
               flops / (chips * peak["f32_flops_per_s"]))
