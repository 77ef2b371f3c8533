"""PhyloInstance: alignment + models + likelihood engines behind one facade.

The port of `examl_tpu/instance.py`, under GAMMA or PSR
rate heterogeneity, in one process or as one rank of a site-parallel run
(parallel/sharding.py), on one card or over the site shards of a mesh's
first tree slice (parallel/shards.py), on dense CLV arenas or SEV pools
(`-S`): owns the per-partition model parameters (GTR, empirical protein
matrices, LG4M/LG4X, AUTO's current choice), the
per-site rate state under PSR, the packed site buckets (one engine per
state count) and the CLV orientation bookkeeping against a host `Tree`
(reference `evaluateGeneric`, `newviewGeneric`, `makenewzGeneric`,
`axml.h:1223-1256`).

`evaluate` is the `engine.dispatch` and `engine.nonfinite` fault seams
and carries the JAX package's non-finite guard: a NaN or infinite lnL
from one engine is recomputed once on the wave-scan tier, and a second
one raises.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from examl_tpu_torch import config, obs
from examl_tpu_torch.constants import ZMAX, ZMIN
from examl_tpu_torch.io.alignment import AlignmentData
from examl_tpu_torch.models import protein
from examl_tpu_torch.models.gtr import ModelParams, build_model
from examl_tpu_torch.models.lg4 import build_lg4
from examl_tpu_torch.ops.engine import LikelihoodEngine
from examl_tpu_torch.parallel.packing import (pack_partitions,
                                              pack_partitions_local,
                                              window_of)
from examl_tpu_torch.parallel.sharding import SINGLE, SiteGroup
from examl_tpu_torch.resilience import faults
from examl_tpu_torch.tree.topology import Node, Tree, TraversalEntry
from examl_tpu_torch.utils import z_slots


def packed_site_rates(bucket, per_site_rates, rate_category) -> np.ndarray:
    """Packed per-site rate multipliers [B, lane] for a bucket's block
    window (padding sites keep rate 1): `perSiteRates[rateCategory]`
    scattered through the bucket's global layout, then cut to the window
    (the whole axis on a global bucket).  The rate state is host-global
    on every rank, so every rank computes the same global array."""
    packed = np.ones(bucket.num_sites)
    for li, gid in enumerate(bucket.part_ids):
        packed[bucket.site_indices(li)] = \
            per_site_rates[gid][rate_category[gid]]
    b0 = bucket.block_offset
    return packed.reshape(bucket.num_blocks, bucket.lane)[
        b0:b0 + bucket.local_num_blocks]


class PhyloInstance:
    def __init__(self, alignment: AlignmentData, dtype: Optional[torch.dtype]
                 = None, device=None, ncat: int = 4,
                 use_median: bool = False,
                 per_partition_branches: bool = False,
                 block_multiple: int = 1, newview: Optional[str] = None,
                 grad_smooth: bool = True, rate_model: str = "GAMMA",
                 psr_categories: int = 25,
                 batch_scan: Optional[bool] = None,
                 batch_thorough: Optional[bool] = None,
                 save_memory: bool = False, clv_dtype=None,
                 local_window=None, group: SiteGroup = SINGLE,
                 sharding=None):
        """newview: the engines' full-traversal tier, "chunk" (kernel B1,
        the default), "whole" (kernel B2) or "scan" (the wave-scan tier,
        no kernel: the JAX package's EXAML_FAST_TRAVERSAL=0), see
        ops/engine.py.
        clv_dtype: the CLV storage of every engine's arena, scan region
        and SEV pool, None / "same" (the compute dtype) or bfloat16
        ("bf16", torch.bfloat16) with float32 compute, the JAX package's
        EXAML_CLV_DTYPE=bf16; bfloat16 with float64 compute or with the
        whole tier raises (`config.clv_storage_dtype`).
        save_memory: SEV memory saving (the CLI's -S): every engine keeps
        its CLVs in a block-cell pool (ops/sev.py) and runs every
        traversal on the pooled wave-scan tier; a kernel tier named with
        it is refused.  grad_smooth: full-tree
        smoothing by whole-tree gradients (True, the JAX package's
        default) or branch by branch (False, its EXAML_GRAD_SMOOTH=0).
        rate_model: "GAMMA" or "PSR" (per-site rates, at most
        `psr_categories` categories per partition; one rate category).
        batch_scan / batch_thorough: the SPR search's batched scan
        (search/spr.py, the JAX package's EXAML_BATCH_SCAN /
        EXAML_BATCH_THOROUGH): None follows the device (batched on the
        card, sequential on the CPU); batch_scan=False keeps both arms
        sequential, True batches the lazy arm anywhere; batch_thorough
        True / False forces the thorough arm, which batches only with one
        state bucket and one branch slot.
        group: this rank's place on the site axis (parallel/sharding.py;
        the world of one by default).  With more than one rank every
        bucket holds only the rank's block window, and each engine
        reduces its site sums over the group; the block count pads to a
        multiple of the world size.  local_window=(procid, nprocs) says
        that `alignment` holds only that window's columns (a sliced read,
        io/bytefile.read_bytefile_for_process); without it a
        multi-rank instance packs the whole alignment and cuts its
        window out.
        sharding: a site mesh or a (sites, tree) fabric of
        parallel/sharding.py (`make_mesh` + `site_sharding`, or
        `make_fabric_mesh` + `fabric_sharding`; the CLI's default over
        several cards, `--mesh Sx1`, `--mesh 1xT`).  S > 1 site shards:
        every bucket's blocks pad to a multiple of S and split into S
        windows, one engine each on its card of the site axis, run
        together by a ShardPool (parallel/shards.py; `self.engines` holds
        ShardedEngines); `device` is then the first shard's card.  T > 1
        tree slices: the fleet's batches run through a MeshShard
        (fleet/shard.py).  Both at once: this instance is the `Sx1` one
        over tree slice 0's S cards, and the MeshShard's slices k >= 1
        copy its shards' constants to theirs.  A site mesh in a rank of
        a site-parallel run, and T > 1 with save_memory (the engines'
        check), raise."""
        self.site_shards = sharding.site_shards if sharding else 1
        if self.site_shards > 1:
            if group.size > 1 or local_window is not None:
                raise ValueError(
                    "site shards in one process cannot split a rank's "
                    "window of a site-parallel run: each rank holds one "
                    "card")
        self.sharding = sharding
        if rate_model not in ("GAMMA", "PSR"):
            raise ValueError(f"unknown rate model {rate_model!r}")
        self.rate_model = rate_model
        self.psr = rate_model == "PSR"
        if self.psr:
            ncat = 1                      # one rate per site, weight 1
        self.psr_categories = psr_categories
        self.grad_smooth = grad_smooth
        self.save_memory = save_memory       # SEV mode (ops/sev.py)
        self.batch_scan = batch_scan
        self.batch_thorough = batch_thorough
        self.shard_pool = None
        if self.site_shards > 1:
            from examl_tpu_torch.parallel.shards import ShardPool
            devices = [config.resolve_device(d)
                       for d in sharding.site_devices()]
            device = devices[0]
            self.shard_pool = ShardPool(devices)
        self.device = config.resolve_device(device)
        self.dtype = dtype if dtype is not None else \
            config.default_dtype(self.device)
        self.storage_dtype = config.clv_storage_dtype(self.dtype, clv_dtype)
        self.alignment = alignment
        self.ncat = ncat
        self.use_median = use_median
        M = len(alignment.partitions)
        self.num_parts = M
        self.per_partition_branches = per_partition_branches
        self.num_branch_slots = M if per_partition_branches else 1

        # Initial models (reference initModel `models.c:4180`): GTR rates
        # all 1.0, empirical frequencies (or the protein matrix's own),
        # alpha 1.0.  AUTO partitions start from WAG (reference
        # `models.c:4222`) until auto_protein replaces them in mod_opt.
        self.models: List[ModelParams] = []
        self.auto_prot_models: Dict[int, str] = {
            gid: "WAG" for gid, p in enumerate(alignment.partitions)
            if p.auto}
        self.auto_prot_freqs: Dict[int, str] = {
            gid: "fixed" for gid in self.auto_prot_models}
        self.auto_prot_criterion = "ml"
        for gid, part in enumerate(alignment.partitions):
            name = self.auto_prot_models.get(gid, part.model_name)
            if part.lg4:
                if self.psr:
                    raise ValueError(
                        "LG4 models are not supported under PSR (the "
                        "reference likewise restricts LG4 to GAMMA)")
                if ncat != 4:
                    raise ValueError("LG4 models require 4 rate categories")
                if part.optimize_freqs or part.use_empirical_freqs:
                    raise ValueError(
                        f"partition {part.name}: LG4 models carry one "
                        "frequency vector per rate category; the F/X "
                        "frequency suffixes are not applicable")
                self.models.append(build_lg4(name, alpha=1.0,
                                             use_median=use_median))
                continue
            rates, freqs = None, part.empirical_freqs
            if part.datatype.name == "AA" and name != "GTR":
                rates, model_freqs = protein.get_matrix(name)
                if not part.use_empirical_freqs and not part.optimize_freqs:
                    freqs = model_freqs
            self.models.append(build_model(
                part.datatype, freqs, rates=rates, alpha=1.0, ncat=ncat,
                use_median=use_median))

        self.group = group
        block_multiple = math.lcm(block_multiple, group.size,
                                  self.site_shards)
        if local_window is not None:
            if tuple(local_window) != (group.rank, group.size):
                raise ValueError(f"local window {tuple(local_window)} is "
                                 f"not rank {group.rank} of {group.size}")
            self.buckets = pack_partitions_local(
                alignment.partitions, group.rank, group.size,
                block_multiple=block_multiple)
        else:
            self.buckets = pack_partitions(alignment.partitions,
                                           block_multiple=block_multiple)
            if group.size > 1:
                self.buckets = {s: window_of(b, group.rank, group.size)
                                for s, b in self.buckets.items()}
        self.engines: Dict[int, LikelihoodEngine] = {}
        for states, bucket in self.buckets.items():
            branch_indices = (list(bucket.part_ids) if per_partition_branches
                              else [0] * bucket.num_parts)
            bucket_models = [self.models[g] for g in bucket.part_ids]

            def engine(window, device, group):
                return LikelihoodEngine(
                    window, bucket_models, alignment.ntaxa,
                    num_branch_slots=self.num_branch_slots,
                    branch_indices=branch_indices, dtype=self.dtype,
                    device=device, newview=newview, psr=self.psr,
                    save_memory=save_memory, clv_dtype=self.storage_dtype,
                    group=group, sharding=sharding)

            if self.shard_pool is None:
                self.engines[states] = engine(bucket, self.device, group)
                continue
            # Each shard's engine is made on its own thread, so that its
            # tensors are allocated on its card and stream.
            from examl_tpu_torch.parallel.shards import ShardedEngine
            pool = self.shard_pool
            self.engines[states] = ShardedEngine(pool, pool.run(
                lambda r: engine(window_of(bucket, r, pool.size),
                                 pool.devices[r], pool.groups[r])), bucket)

        # PSR per-site rate state (reference patrat / rateCategory /
        # perSiteRates, `axml.h:585-600`), host copies per partition:
        # patrat holds each site's un-snapped scan optimum, the sites
        # evaluate under per_site_rates[rate_category].  Sized globally
        # on every rank, also after a sliced read: the rate scan
        # allgathers its per-site lnLs (engine.rate_scan), so the
        # categorization runs alike everywhere (the reference's CAT
        # Gatherv/Scatterv, `optimizeModel.c:2135-2254`).
        if self.psr:
            widths = [p.global_width if p.global_width is not None
                      else p.width for p in alignment.partitions]
            self.patrat = [np.ones(w) for w in widths]
            self.site_lhs = [np.zeros(w) for w in widths]
            self.rate_category = [np.zeros(w, dtype=np.int32)
                                  for w in widths]
            self.per_site_rates = [np.ones(1) for _ in alignment.partitions]
            self.psr_invocations = 0
            self.cat_opt_rounds = 0
            self._psr_packed_weights: Dict[int, np.ndarray] = {}
            self._psr_global_weights: Optional[Dict[int, np.ndarray]] = None

        self.per_partition_lnl = np.full(M, np.nan)
        self.likelihood = np.nan
        # Smoothing state (reference partitionSmoothed/partitionConverged).
        self.partition_smoothed = np.zeros(self.num_branch_slots, dtype=bool)
        self.partition_converged = np.zeros(self.num_branch_slots, dtype=bool)

    # -- model push --------------------------------------------------------

    def push_models(self, only_states=None) -> None:
        with obs.span("models:push") as sp:
            if sp:
                sp.note(partitions=len(self.models))
            for states, bucket in self.buckets.items():
                if only_states is not None and states not in only_states:
                    continue
                self.engines[states].set_models(
                    [self.models[g] for g in bucket.part_ids])

    def set_model(self, gid: int, model: ModelParams, push: bool = True) -> None:
        self.models[gid] = model
        if push:
            self.push_models()

    def push_site_rates(self) -> None:
        """Install the categorized per-site rates into the engines (PSR):
        sites evaluate under their category's representative rate
        (`perSiteRates[rateCategory]`); patrat only seeds the next scan."""
        if not self.psr:
            raise RuntimeError("site rates belong to the PSR model")
        for states, bucket in self.buckets.items():
            self.engines[states].set_site_rates(packed_site_rates(
                bucket, self.per_site_rates, self.rate_category))

    # The scan/categorize pipeline is host-global on every rank, but each
    # rank's bucket holds only its window of the packed weights: one
    # allgather of the windows (rank-ordered, they tile the axis) gives
    # every rank the global weights for the weighted crawl and the
    # weighted mean-rate-1 normalization.

    def psr_packed_weights(self, bucket) -> np.ndarray:
        """GLOBAL packed pattern weights [B, lane] of a bucket (PSR rate
        scan).  Weights are static, so the gather runs once per bucket
        and is cached."""
        cached = self._psr_packed_weights.get(bucket.states)
        if cached is None:
            cached = self.group.allgather_blocks(
                np.asarray(bucket.weights, dtype=np.float64).reshape(
                    bucket.local_num_blocks, bucket.lane))
            self._psr_packed_weights[bucket.states] = cached
        return cached

    def psr_pattern_weights(self, gid: int) -> np.ndarray:
        """GLOBAL pattern weights of partition `gid` (PSR normalization;
        the partition's own weights unless it is a sliced read)."""
        part = self.alignment.partitions[gid]
        if part.global_width is None:
            return np.asarray(part.weights, dtype=np.float64)
        if self._psr_global_weights is None:
            self._psr_global_weights = {}
            for bucket in self.buckets.values():
                flat = self.psr_packed_weights(bucket).reshape(-1)
                for li, g in enumerate(bucket.part_ids):
                    self._psr_global_weights[g] = flat[
                        bucket.site_indices(li)].copy()
        return self._psr_global_weights[gid]

    # -- tree construction -------------------------------------------------

    def tree_from_newick(self, text: str) -> Tree:
        return Tree.from_newick(text, self.alignment.taxon_names,
                                self.num_branch_slots)

    def random_tree(self, seed: int = 0) -> Tree:
        return Tree.random(self.alignment.taxon_names, seed,
                           self.num_branch_slots)

    def batch_evaluator(self):
        """The fleet's batched many-tree evaluator over this instance
        (fleet/batch.py), or None where `batch.batch_eligible` gives a
        reason; one per instance, made at the first call.  On a fabric
        (`sharding`) the MeshShard evaluator: each batch's jobs cut over
        the tree slices, and each slice's over its site shards; over the
        site shards of a 1-D mesh the SiteLanes (fleet/shard.py)."""
        ev = getattr(self, "_batch_evaluator", None)
        if ev is None:
            from examl_tpu_torch.fleet.batch import (BatchEvaluator,
                                                     batch_eligible)
            if batch_eligible(self) is not None:
                return None
            if self.sharding is not None and self.sharding.is_fabric:
                from examl_tpu_torch.fleet.shard import MeshShard
                ev = MeshShard(self)
            elif self.site_shards > 1:
                from examl_tpu_torch.fleet.shard import SiteLanes
                ev = SiteLanes(self)
            else:
                ev = BatchEvaluator(self)
            self._batch_evaluator = ev
        return ev

    # -- CLV orientation / traversal ---------------------------------------

    def _collect(self, tree: Tree, slot: Node, full: bool) -> List[TraversalEntry]:
        if tree.is_tip(slot.number):
            return []
        return tree.compute_traversal(slot, full)

    def new_view(self, tree: Tree, slot: Node) -> None:
        """Make slot's CLV valid (reference newviewGeneric)."""
        self.run_traversal(self._collect(tree, slot, full=False))

    def run_traversal(self, entries, only_states=None,
                      full: bool = False) -> None:
        if not len(entries):
            return
        for states, eng in self.engines.items():
            if only_states is not None and states not in only_states:
                continue
            eng.run_traversal(entries, full=full)

    # -- likelihood --------------------------------------------------------

    def evaluate(self, tree: Tree, p: Optional[Node] = None,
                 full: bool = False, only_states=None) -> float:
        """lnL at branch (p, p.back); reference evaluateGeneric
        (`evaluateGenericSpecial.c:897-1001`).  Full traversals root at
        the topological centroid by default (lnL is rooting-invariant;
        the centroid minimizes the wave depth) and take the engines'
        `newview` tier.

        only_states restricts traversal+evaluation to the named state
        buckets (the reference's executeModel masking during model
        optimization): other partitions keep their cached lnL, which stays
        valid because their parameters and the tree are unchanged.  Callers
        must finish with an unrestricted evaluate before changing topology.
        """
        with obs.span("instance:evaluate") as sp:
            if sp:
                sp.note(full=bool(full), engines=sum(
                    only_states is None or s in only_states
                    for s in self.engines))
            return self._evaluate(tree, p, full, only_states)

    def _evaluate(self, tree: Tree, p: Optional[Node], full: bool,
                  only_states) -> float:
        if p is None:
            p = tree.centroid_branch() if full else tree.start
        q = p.back
        if full:
            with obs.timer("host_schedule"), obs.span("engine:schedule"):
                entries = tree.flat_full_traversal(p)
        else:
            entries = (self._collect(tree, p, full)
                       + self._collect(tree, q, full))
        per_part = self.per_partition_lnl
        faults.fire("engine.dispatch")
        for states, eng in self.engines.items():
            if only_states is not None and states not in only_states:
                continue
            vals = eng.traverse_evaluate(entries, p.number, q.number, p.z,
                                         full=full)
            if faults.fire("engine.nonfinite"):
                vals = np.full_like(np.asarray(vals, dtype=float), np.nan)
            if not np.all(np.isfinite(vals)):
                vals = self._nonfinite_retry(tree, eng, p, q)
            for li, gid in enumerate(eng.bucket.part_ids):
                per_part[gid] = vals[li]
        if only_states is not None and np.isnan(per_part).any():
            raise RuntimeError(
                "restricted evaluate before any unrestricted one: cached "
                "per-partition lnL is uninitialized for the skipped buckets")
        self.likelihood = float(per_part.sum())
        return self.likelihood

    def _nonfinite_retry(self, tree: Tree, eng, p: Node, q: Node):
        """The non-finite guard (JAX `PhyloInstance._nonfinite_retry`): a
        NaN or infinite lnL from one engine means poisoned CLVs, not a
        search state.  Recompute every CLV of that engine once with one
        full traversal on the wave-scan tier (torch ops over the arena,
        no kernel; the engine's own tier serves the next traversal), and
        raise if the result is still not finite: a search step taken on
        a poisoned lnL silently corrupts the tree.  Counted as
        engine.nonfinite_retries / .nonfinite_recovered."""
        obs.inc("engine.nonfinite_retries")
        obs.log(f"EXAML: non-finite lnL from the states={eng.bucket.states} "
                "engine; recomputing once on the wave-scan tier")
        tree.invalidate_all()
        entries = (self._collect(tree, p, True)
                   + self._collect(tree, q, True))
        vals = eng.traverse_evaluate(entries, p.number, q.number, p.z)
        if not np.all(np.isfinite(vals)):
            raise FloatingPointError(
                "non-finite log-likelihood persists on the wave-scan "
                f"retry (states={eng.bucket.states}); refusing to search "
                "on a poisoned lnL")
        obs.inc("engine.nonfinite_recovered")
        return vals

    # -- branch-length optimization (Newton-Raphson) ------------------------

    def makenewz(self, tree: Tree, p: Node, q: Node, z0: Sequence[float],
                 maxiter: int = 1, mask_converged: bool = False) -> np.ndarray:
        """Optimize the branch (p,q) starting from z0; returns new z [C].

        Mirrors reference `topLevelMakenewz`
        (`makenewzGenericSpecial.c:1133-1349`) including the curvature
        guards."""
        if len(self.engines) == 1:
            (eng,) = self.engines.values()
            entries = (self._collect(tree, p, False)
                       + self._collect(tree, q, False))
            conv = self.partition_converged if mask_converged else None
            return eng.newton_branch(entries, p.number, q.number,
                                     z_slots(z0, self.num_branch_slots),
                                     maxiter, conv)

        # Mixed state buckets: derivatives sum across engines each NR
        # iteration, so the loop runs on the host over per-engine sumtables.
        self.new_view(tree, p)
        self.new_view(tree, q)
        sts = {s: eng.make_sumtable(p.number, q.number)
               for s, eng in self.engines.items()}

        C = self.num_branch_slots
        z = np.asarray(z0, dtype=np.float64).copy()
        zprev = z.copy()
        zstep = np.zeros(C)
        maxiters = np.full(C, maxiter)
        outer_conv = np.zeros(C, dtype=bool)
        curvat_ok = np.ones(C, dtype=bool)
        if mask_converged:
            outer_conv |= self.partition_converged

        while not outer_conv.all():
            fresh = ~outer_conv & curvat_ok
            zprev = np.where(fresh, z, zprev)
            zstep = np.where(fresh, (1.0 - ZMAX) * z + ZMIN, zstep)
            curvat_ok = np.where(fresh, False, curvat_ok)

            z = np.clip(z, ZMIN, ZMAX)
            d1 = np.zeros(C)
            d2 = np.zeros(C)
            for s, eng in self.engines.items():
                e1, e2 = eng.branch_derivatives(sts[s], z)
                d1 += e1
                d2 += e2

            active = ~outer_conv & ~curvat_ok
            bad = active & (d2 >= 0.0) & (z < ZMAX)
            z = np.where(bad, 0.37 * z + 0.63, z)
            zprev = np.where(bad, z, zprev)
            curvat_ok = np.where(active & ~bad, True, curvat_ok)

            step = curvat_ok & ~outer_conv
            if step.any():
                with np.errstate(over="ignore", divide="ignore",
                                 invalid="ignore"):
                    tantmp = np.where(d2 < 0.0,
                                      -d1 / np.where(d2 < 0, d2, 1.0),
                                      np.inf)
                    znew = np.where(tantmp < 100.0,
                                    np.clip(z * np.exp(np.minimum(tantmp,
                                                                  100.0)),
                                            ZMIN, None),
                                    0.25 * zprev + 0.75)
                    znew = np.minimum(znew, 0.25 * zprev + 0.75)
                z = np.where(step & (d2 < 0.0), znew, z)
                z = np.minimum(z, ZMAX)
                maxiters = np.where(step, maxiters - 1, maxiters)
                moving = np.abs(z - zprev) > zstep
                gave_up = moving & (maxiters < -20)
                z = np.where(step & gave_up, np.asarray(z0), z)
                outer_conv = np.where(step, ~moving | gave_up, outer_conv)
        return z
