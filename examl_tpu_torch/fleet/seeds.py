"""Deterministic per-job seed derivation (splitmix64).

The port of `examl_tpu/fleet/seeds.py`, the same function bit for bit.

Fleet seed hygiene: replicate K must be the SAME analysis on every
resume — across `-R` restarts, supervisor retries, elastic gang shrink,
and any reordering of the work queue.  A seed therefore depends only on
`(parent_seed, stream, index)`: never on world size, attempt number,
wall clock, or dispatch order.

splitmix64 (Steele et al., "Fast splittable pseudorandom number
generators") is the standard avalanche mixer for exactly this job:
one multiply-xorshift pipeline whose outputs over consecutive inputs
are statistically independent — cheap, stdlib-only, and identical on
every platform.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

# Stream tags keep the derivation domains disjoint: a bootstrap
# replicate, a multi-start tree and a per-partition resample with the
# same index must never collide.
STREAMS = {
    "bootstrap": 0xB001,
    "start": 0x5AA7,
    "eval": 0xE7A1,
    "partition": 0x9A27,
}


def splitmix64(x: int) -> int:
    """One splitmix64 output for input x (pure, 64-bit)."""
    x = (x + _GOLDEN) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def derive(parent_seed: int, stream: str, index: int) -> int:
    """Per-job seed: a pure function of (parent, stream, index).

    Two mixing rounds — the first keys the stream, the second the
    index — so nearby parents/indices land in unrelated states.  The
    result is clamped to 63 bits: every consumer (numpy Generators,
    `Tree.random`) accepts it as a non-negative Python int.
    """
    if index < 0:
        raise ValueError(f"job index must be >= 0, got {index}")
    tag = STREAMS.get(stream)
    if tag is None:
        raise ValueError(f"unknown seed stream {stream!r} "
                         f"(expected one of {sorted(STREAMS)})")
    state = splitmix64((parent_seed & _MASK64) ^ (tag * _GOLDEN & _MASK64))
    return splitmix64((state + index * _GOLDEN) & _MASK64) >> 1
