"""Bootstrap weight resampling over SITE multiplicity.

The port of `examl_tpu/fleet/bootstrap.py` (the same weights).

The alignment stores one column per unique pattern with an integer
multiplicity (`weights`); a bootstrap replicate draws the original
number of SITES with replacement — i.e. a multinomial over patterns
with probabilities `w_i / L` where `L = sum(w_i)` is the partition's
site count — NOT a uniform draw over patterns, which would weight rare
patterns as heavily as common ones (the classic resampling bug the
parity tests pin).  Resampled weights are integers summing exactly to
each partition's site count, and the draw is deterministic under the
derived per-(replicate, partition) seed.

Because pattern weights enter the likelihood ONLY at the root reduction
(`kernels.weighted_root_sums`), the replicates of a fixed topology share
one CLV pass, then one batched weight matrix in the lnL sum
(fleet/batch.py).
"""

from __future__ import annotations

from typing import List

import numpy as np

from examl_tpu_torch.fleet import seeds


def resample_weights(weights, seed: int) -> np.ndarray:
    """One partition's bootstrap weights: multinomial over patterns with
    site-multiplicity probabilities.  Returns float64 (the engines'
    weight dtype) holding exact integers that sum to `sum(weights)`."""
    w = np.asarray(weights, dtype=np.float64)
    total = int(round(w.sum()))
    if total <= 0:
        return np.zeros_like(w)
    rng = np.random.default_rng(seed)
    return rng.multinomial(total, w / w.sum()).astype(np.float64)


def bootstrap_weights(alignment, replicate_seed: int) -> List[np.ndarray]:
    """Per-partition resampled pattern weights for one replicate.

    Partitions resample independently (each keeps its own site count,
    the reference's per-partition bootstrap semantics), under seeds
    derived per (replicate, partition) so adding a partition never
    perturbs another's draw."""
    return [resample_weights(part.weights,
                             seeds.derive(replicate_seed, "partition", gid))
            for gid, part in enumerate(alignment.partitions)]


def packed_weights(bucket, per_part: List[np.ndarray]) -> np.ndarray:
    """Pack per-partition weights into a bucket's [B, lane] layout
    (padding sites keep weight 0) — the same layout arithmetic as
    `instance.packed_site_rates`."""
    return packed_weights_batch(bucket, [per_part])[0]


def packed_weights_batch(bucket, per_job: List[List[np.ndarray]]
                         ) -> np.ndarray:
    """`packed_weights` of J replicates at once: [J, B, lane], B the
    bucket's block window (the whole axis on a global bucket; a site
    shard's or a rank's window of it).  A partition's patterns are one
    run of the padded axis (`bucket.site_indices`), so each is one slice
    assignment."""
    packed = np.zeros((len(per_job), bucket.num_sites))
    for li, gid in enumerate(bucket.part_ids):
        o = int(bucket.part_offsets[li])
        packed[:, o:o + int(bucket.part_widths[li])] = np.stack(
            [w[gid] for w in per_job])
    b0 = bucket.block_offset
    return packed.reshape(len(per_job), bucket.num_blocks, bucket.lane)[
        :, b0:b0 + bucket.local_num_blocks]
