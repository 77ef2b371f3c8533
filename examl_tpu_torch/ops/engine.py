"""LikelihoodEngine: the CLV arena of one state-count bucket and the
traversal / evaluation / branch-derivative entry points over it.

The port of the GAMMA and PSR, dense-arena and SEV subset of
`examl_tpu/ops/engine.py`, on one device.  The arena is `[rows, B, lane,
R, K]` holding inner nodes only, plus slack rows for the fast path's
padded chunk writes and one scratch row; tips live as uint8 codes with
an indicator table; the scaler is int32 `[rows, B, lane]`.  Row assignment is a host map
(`row_map`): a full traversal relays the rows out in wave order (the
bounded chunk layout of ops/fastpath.py, whose launch table runs through
kernel B1 — or, with `newview="whole"`, the flat schedule of
ops/newview_whole.py, run as one launch of kernel B2), and partial
traversals — makenewz, new_view — update rows in place through the map
on the wave-scan tier (plain torch ops), as the JAX engine runs its XLA
scan tier there.  Under the PSR model (`psr=True`) every traversal takes
the wave-scan tier, as in the JAX engine: kernels B1 and B2 serve GAMMA
only, with instances for R = 4 rates of K = 2 (binary), 4 (DNA) and 20
(amino-acid: GTR, empirical matrices, LG4M/LG4X) states.  An engine on
the card whose (R, K) has no instance is refused when it is built (the
CLI always uses R = 4; only ncat != 4 from Python reaches that), never
sent to another tier.  With `newview="scan"` every traversal, full ones
included, takes the wave-scan tier and the engine loads no CUDA library:
the kernel-free route (the JAX engine's `force_scan`,
EXAML_FAST_TRAVERSAL=0), which the supervisor's last rung and the
extension bank's degraded `newview_chunk` fall back to.
`whole_tree_gradients` gives every branch's derivatives from one
pre-order pass over the current arena
(ops/gradient.py), `rate_scan` every site's lnL under a grid of
candidate rates (PSR), and `batched_scan` / `batched_thorough` every
candidate insertion of a pruned node (ops/scan.py), their uppass
entries written on the wave-scan tier into a scan region above the
arena's `num_rows` rows (`ensure_scan_rows`).

Under SEV memory saving (`save_memory=True`, the CLI's `-S`) there is no
dense arena: inner CLVs live in a block-cell pool (ops/sev.py) and every
traversal, full or partial, runs on the wave-scan tier through the slot
maps (`kernels.traverse_pooled`) — the "pooled" tier, chosen at
construction as the JAX engine chooses it (it runs no Pallas under
`-S`); kernels B1 and B2 have no pooled form and are never launched.
The scaler stays dense, and the batched scan's region is carved from the
pool.  The whole-tree gradient pass needs the dense arena, so `-S`
smoothing takes the per-branch route (optimize/branch.py).

In a site-parallel run (parallel/sharding.py) the bucket is this rank's
window of `B_local` blocks: the arena, the scaler, the tip codes, the
weights, the SEV pool, the scan region, the outroot arena and every
kernel launch cover the window only, and each value the engine returns
that sums over sites (per-partition lnL, Newton-Raphson and gradient
derivatives, candidate lnLs) is reduced over the group once, inside the
Newton-Raphson loop once per iteration, as the reference's Allreduce.
The PSR rate scan allgathers its per-site result instead.

With `clv_dtype=torch.bfloat16` (float32 compute only; the JAX engine's
EXAML_CLV_DTYPE=bf16) the arena, its scan region and the SEV pool store
bfloat16 while every computation stays float32: reads upcast after the
load, writes round to nearest even after the rescale.  Full traversals
then run the bfloat16-storage instances of kernel B1 on the chunk tier;
the whole tier is refused (B2 has no such instance, and the JAX package
runs Pallas only with float32 storage).  Scratch arenas that live inside
one call (the outroot arena, the PSR rate scan's) keep the compute
dtype, as in the JAX engine.

Every entry point is instrumented as the JAX engine's is (obs/): a
`device_span` named `engine:<op>` (traverse, evaluate, trav_eval,
derivs, sumtable, newton, grad_pass, rate_scan, spr_scan, spr_thorough),
`engine.dispatch_count` and `engine.traversal_entries`, and the modeled
`engine.traffic_bytes` of obs/traffic.py, all computed from host values
(entry counts, the flat traversal's child numbers): no instrument reads
a tensor.  Blocking entry points (those that return host values) feed
the `dispatch` timer and the windowed `engine.achieved_gbps.<tier>.<tag>`
gauges with their wall time: modelled bytes over host wall time, not a
device reading.
"""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from examl_tpu_torch import config, datatypes, obs
from examl_tpu_torch.constants import NEWVIEW_TIERS, POOLED_TIER
from examl_tpu_torch.models.gtr import ModelParams
from examl_tpu_torch.models.lg4 import LG4Params
from examl_tpu_torch.obs import traffic as _traffic
from examl_tpu_torch.ops import (fastpath, gradient, kernels, newview_chunk,
                                 newview_whole, scan)
from examl_tpu_torch.ops.kernels import (DeviceModels, OutrootTraversal,
                                         Traversal)
from examl_tpu_torch.ops.sev import SevState
from examl_tpu_torch.parallel.packing import PackedBucket
from examl_tpu_torch.parallel.sharding import SINGLE, SiteGroup
from examl_tpu_torch.tree.topology import FlatTraversal, Tree, TraversalEntry
from examl_tpu_torch.utils import next_pow2, z_slots

# Full traversals dispatched on either kernel tier, partial traversals
# run on the wave-scan tier, traversals of the pooled tier (-S: full and
# partial, the batched scan's included), the launch-table rows the chunk
# tier dispatched, and whole-tree gradient passes (plain counts, read by
# chip_smoke.py beside each kernel's launch count).
FULL_TRAVERSALS = 0
PARTIAL_TRAVERSALS = 0
POOLED_TRAVERSALS = 0
CHUNK_LAUNCH_ROWS = 0
GRAD_PASSES = 0
# Entries kept per topology-keyed cache (layouts, gradient plans).
SCHED_CACHE_CAP = 8


def stack_models(models: Sequence[ModelParams],
                 branch_indices: Sequence[int], dtype: torch.dtype,
                 device, psr: bool = False) -> DeviceModels:
    """Stack per-partition models into [M, R, ...] tensors: an LG4 model
    gives one eigensystem and frequency vector per rate category and its
    own category weights (LG4X's are free); a plain model tiles its one
    eigensystem over the R categories, weights 1/R; under PSR there is
    one category of weight 1."""
    R = models[0].ncat
    if any(m.ncat != R for m in models):
        raise ValueError("all partitions of a bucket need the same ncat")

    def arr(xs):
        return torch.as_tensor(np.stack(xs), dtype=dtype, device=device)

    def per_cat(m, field):
        if isinstance(m, LG4Params):
            return np.stack(getattr(m, field + "_list"))
        v = getattr(m, field)
        return np.broadcast_to(v, (R,) + v.shape)

    def weights_of(m):
        if psr:
            return np.ones(R)
        if isinstance(m, LG4Params):
            return np.asarray(m.rate_weights)
        return np.full(R, 1.0 / R)

    return DeviceModels(
        eign=arr([per_cat(m, "eign") for m in models]),
        ev=arr([per_cat(m, "ev") for m in models]),
        ei=arr([per_cat(m, "ei") for m in models]),
        freqs=arr([per_cat(m, "freqs") for m in models]),
        gamma_rates=arr([m.gamma_rates for m in models]),
        rate_weights=arr([weights_of(m) for m in models]),
        part_branch=torch.as_tensor(np.asarray(branch_indices, np.int64),
                                    device=device),
    )


class LikelihoodEngine:
    _obs_seq = 0                # per-process engine ordinal (gauge tags)

    def __init__(self, bucket: PackedBucket, models: Sequence[ModelParams],
                 ntips: int, num_branch_slots: int = 1,
                 branch_indices: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None, device=None,
                 scale_exp: Optional[int] = None, wave_width: int = 8,
                 newview: Optional[str] = None, psr: bool = False,
                 save_memory: bool = False, clv_dtype=None,
                 group: SiteGroup = SINGLE):
        """newview selects the full-traversal tier: "chunk" (the bounded
        chunk program through kernel B1, the default), "whole" (one
        launch of kernel B2 per traversal) — the JAX engine's
        EXAML_PALLAS=1 | whole — or "scan" (the wave-scan tier, no
        kernel; its EXAML_FAST_TRAVERSAL=0).  psr: per-site rates (CAT);
        every traversal then takes the wave-scan tier.  save_memory: SEV (-S),
        the block-cell pool and the "pooled" tier; a kernel tier named
        with it is refused.  clv_dtype: the CLV storage dtype
        (`config.clv_storage_dtype`: None / "same", or bfloat16 with
        float32 compute); bfloat16 with the whole tier is refused.
        group: the site axis's ranks (parallel/sharding.py); the bucket
        is this rank's block window, and every site sum the engine
        returns is reduced over the group once."""
        if save_memory:
            if newview not in (None, POOLED_TIER):
                raise ValueError(
                    f"newview={newview!r} with save_memory: kernels B1 "
                    "and B2 have no pooled form; -S runs every traversal "
                    f"on the {POOLED_TIER!r} wave-scan tier")
            newview = POOLED_TIER
        elif newview is None:
            newview = "chunk"
        elif newview not in NEWVIEW_TIERS:
            raise ValueError(f"newview={newview!r}, expected one of "
                             f"{NEWVIEW_TIERS}")
        self.newview = newview
        self.psr = psr
        self.device = config.resolve_device(device)
        self.dtype = dtype if dtype is not None else \
            config.default_dtype(self.device)
        self.storage_dtype = config.clv_storage_dtype(self.dtype, clv_dtype)
        if newview == "whole" and self.storage_dtype != self.dtype:
            raise ValueError(
                f"newview='whole' with {self.storage_dtype} CLV storage: "
                "kernel B2 has no such instance; full traversals over a "
                "bfloat16 arena take the chunk tier (kernel B1)")
        self.scale_exp = (scale_exp if scale_exp is not None
                          else config.scale_exponent(self.dtype))
        self.bucket = bucket
        self.ntips = ntips
        self.num_branch_slots = num_branch_slots
        self.wave_width = wave_width
        self.num_parts = bucket.num_parts
        self.n_inner = max(ntips - 2, 1)
        self.fast_slack = (0 if psr or save_memory or newview == "scan"
                           else fastpath.slack_rows(ntips))
        self.num_rows = self.n_inner + self.fast_slack + 1
        self.scratch_row = self.num_rows - 1
        self.row_map = np.full(2 * ntips - 1, -1, dtype=np.int64)
        for num in range(ntips + 1, 2 * ntips - 1):
            self.row_map[num] = num - ntips - 1
        # Layouts of the full-traversal tier and whole-tree gradient plans
        # (ops/gradient.py), each keyed by topology signature (_cached),
        # and the outroot arena, made at the first gradient pass.
        self._sched_cache: "OrderedDict[bytes, object]" = OrderedDict()
        self._grad_structs: "OrderedDict[bytes, object]" = OrderedDict()
        self._outroot: Optional[torch.Tensor] = None
        # Rows of the batched SPR scan's region above num_rows
        # (ensure_scan_rows).
        self._scan_cap = 0

        self.group = group
        # Every per-site tensor covers this rank's window of blocks.
        self.B, self.lane = bucket.local_num_blocks, bucket.lane
        self.R = models[0].ncat
        self.K = bucket.states
        tier = newview_whole if newview == "whole" else newview_chunk
        if (self.device.type == "cuda" and not psr and not save_memory
                and newview != "scan"
                and not tier.supported(self.R, self.K, self.storage_dtype)):
            raise ValueError(
                f"kernel {'B2' if newview == 'whole' else 'B1'} has no "
                f"instance for (R, K) = ({self.R}, {self.K}) with "
                f"{self.storage_dtype} storage: full traversals on the "
                f"{newview} tier need 4 rate categories of 2, 4 or 20 "
                "states")
        if branch_indices is None:
            branch_indices = [0] * self.num_parts
        self._branch_indices = list(branch_indices)
        # The site sums (kernels._segment_sum) take both maps as runs.
        for name, ids in (("block_part", bucket.block_part),
                          ("branch_indices", self._branch_indices)):
            if np.any(np.diff(np.asarray(ids)) < 0):
                raise ValueError(f"{name} must be nondecreasing")
        self.models = stack_models(models, self._branch_indices, self.dtype,
                                   self.device, psr)
        # Per-site rate multipliers [B, lane, 1] under PSR (None selects
        # the GAMMA form of every kernel).
        self.site_rates = (torch.ones((self.B, self.lane, 1),
                                      dtype=self.dtype, device=self.device)
                           if psr else None)
        bp = torch.as_tensor(np.asarray(bucket.block_part, np.int64),
                             device=self.device)
        self.block_part = bp                         # torch-op indexing
        self.block_part_i32 = bp.to(torch.int32)     # kernels B1, B2 operand
        self.weights = torch.as_tensor(
            np.asarray(bucket.weights, np.float64).reshape(self.B,
                                                           self.lane),
            dtype=self.dtype, device=self.device)
        self.tips = self._build_tip_state()
        if save_memory:
            self.clv = None
            self.sev = SevState(bucket.tip_codes,
                                self._datatype().undetermined_code,
                                self.num_rows, self.B, self.lane, self.R,
                                self.K, self.storage_dtype, self.device)
        else:
            self.sev = None
            self.clv = torch.zeros((self.num_rows, self.B, self.lane,
                                    self.R, self.K),
                                   dtype=self.storage_dtype,
                                   device=self.device)
        self.scaler = torch.zeros((self.num_rows, self.B, self.lane),
                                  dtype=torch.int32, device=self.device)
        # The arena's ready flags for kernel B1's dataflow launches (sized
        # at the first one).
        self.ready = newview_chunk.Ready()
        # Traffic accounting (obs/traffic.py): the true pattern count of
        # this rank's window and per-tier windowed achieved-GB/s
        # accumulators fed by the blocking entry points.
        self._patterns_true = (int(np.count_nonzero(bucket.weights))
                               if bucket.is_local
                               else int(np.sum(bucket.part_widths)))
        self._itemsize = torch.empty(
            (), dtype=self.storage_dtype).element_size()
        self._traffic_win: Dict[str, _traffic.TrafficWindow] = {}
        self._traffic_led: Dict[str, float] = {}
        self._register_obs()

    # -- observability ------------------------------------------------------

    def _register_obs(self) -> None:
        """Count the engine and publish its arena gauge through a
        weakref-bound snapshot collector: zero per-dispatch cost, and
        nothing read from the card."""
        obs.inc("engine.instances")
        seq = LikelihoodEngine._obs_seq
        LikelihoodEngine._obs_seq += 1
        self._obs_tag = f"s{self.K}.e{seq}"
        self._update_arena_gauge()
        ref = weakref.ref(self)

        def _collect():
            eng = ref()
            if eng is None:
                return False
            eng._update_arena_gauge()
            return True

        obs.add_collector(_collect)

    def _update_arena_gauge(self) -> None:
        """Bytes of the CLV store: the dense arena with its scan region,
        or under -S the pool."""
        store = self.clv if self.clv is not None else \
            (self.sev.pool if self.sev is not None else None)
        obs.gauge(f"engine.clv_arena_bytes.{self._obs_tag}",
                  0 if store is None else store.numel() * self._itemsize)

    def _tier_for(self, entries, full: bool) -> str:
        """The tier a traversal over `entries` runs on (the traffic
        gauges' label)."""
        if self.sev is not None:
            return POOLED_TIER
        if full and self._fast_eligible(entries):
            return self.newview
        return "scan"

    def _traversal_traffic_bytes(self, entries) -> int:
        """Modeled bytes of one traversal over `entries` (a
        TraversalEntry list or a FlatTraversal): the closed form of
        obs/traffic.py, from host arrays only."""
        if isinstance(entries, FlatTraversal):
            tips = int((entries.left <= self.ntips).sum()
                       + (entries.right <= self.ntips).sum())
            return _traffic.bytes_per_traversal_counts(
                entries.n, tips, self._patterns_true, self.R, self.K,
                self._itemsize)
        return _traffic.bytes_per_traversal(
            entries, self.ntips, self._patterns_true, self.R, self.K,
            self._itemsize)

    def _scan_plan_traffic_bytes(self, plan) -> int:
        """Modeled bytes of one batched-scan call: the orientation fixes
        plus the uppass entries, each writing one scan row and reading
        its two child refs (a non-slot ref v <= ntips is a tip)."""
        up = plan.up_entries
        tips = sum(1 for e in up for kind, v in (e.left, e.right)
                   if kind != "slot" and v <= self.ntips)
        return (self._traversal_traffic_bytes(list(plan.down_entries))
                + _traffic.bytes_per_traversal_counts(
                    len(up), tips, self._patterns_true, self.R, self.K,
                    self._itemsize))

    def _record_traffic(self, nbytes: int, tier: str,
                        wall_s: Optional[float] = None) -> None:
        """Account one call's modeled bytes; a blocking call (wall_s
        given) also lands in the `dispatch` timer and feeds the windowed
        achieved-GB/s gauge: modelled bytes over host wall time, not a
        device reading, so no regime verdict goes with it."""
        obs.inc("engine.traffic_bytes", nbytes)
        if wall_s is None:
            return
        obs.observe("dispatch", wall_s)
        win = self._traffic_win.get(tier)
        if win is None:
            win = self._traffic_win[tier] = _traffic.TrafficWindow()
        out = win.add(nbytes, wall_s, 1)
        if out is None:
            return
        gbps, _, n = out
        obs.gauge(f"engine.achieved_gbps.{tier}.{self._obs_tag}",
                  round(gbps, 3))
        from examl_tpu_torch.obs import programs as _programs
        _programs.sample_memory()
        now = time.time()
        if now - self._traffic_led.get(tier, 0.0) >= \
                _traffic.LEDGER_EVENT_INTERVAL_S:
            self._traffic_led[tier] = now
            obs.ledger_event("traffic.window", tier=tier,
                             gbps=round(gbps, 3), dispatches=n,
                             source="model")

    # -- construction helpers ---------------------------------------------

    def _datatype(self):
        return {4: datatypes.DNA, 20: datatypes.AA}.get(self.K,
                                                         datatypes.BINARY)

    def _build_tip_state(self) -> kernels.TipState:
        table = torch.as_tensor(self._datatype().tip_indicator_table(),
                                dtype=self.dtype, device=self.device)
        codes = torch.as_tensor(
            self.bucket.tip_codes.astype(np.uint8).reshape(
                self.ntips, self.B, self.lane), device=self.device)
        return kernels.tip_state(codes, table)

    def set_models(self, models: Sequence[ModelParams]) -> None:
        self.models = stack_models(models, self._branch_indices, self.dtype,
                                   self.device, self.psr)

    def set_site_rates(self, rates: np.ndarray) -> None:
        """Install per-site rate multipliers [B, lane] (PSR model)."""
        if not self.psr:
            raise RuntimeError("site rates need an engine built with psr")
        self.site_rates = torch.as_tensor(
            np.asarray(rates, dtype=np.float64).reshape(self.B, self.lane,
                                                        1),
            dtype=self.dtype, device=self.device)

    # -- CLV state: the dense arena or the SEV pool ---------------------------

    def _store(self):
        """The CLV store every torch op reads and writes: the dense arena,
        or under -S the pool with its current slot maps."""
        if self.sev is None:
            return kernels.DenseArena(self.clv)
        if self.sev.pool is None:
            self.sev.sync()
        return kernels.CellPool(self.sev.pool, self.sev.slot_read,
                                self.sev.slot_write)

    def _gather(self, num: int):
        """(CLV, scaler) of node num's current orientation."""
        return kernels.gather_from(self.tips, self._store(), self.scaler,
                                   self._gidx(num), self.ntips)

    # -- wave-scan tier (partial traversals) --------------------------------

    def _gidx(self, num: int) -> int:
        """gather_child index of a node: tips by code slot, inner nodes by
        ntips + current arena row."""
        if num <= self.ntips:
            return num - 1
        return self.ntips + int(self.row_map[num])

    def _traversal_arrays(self, entries: List[TraversalEntry],
                          parent_row=None, gidx=None) -> Traversal:
        """Wave-schedule entries into [L, W]: waves wider than
        `wave_width` split over several steps (their entries are
        independent), narrow waves pad to W with scratch-row entries.
        parent_row(entry) / gidx(id) map an entry's parent to its arena row
        and a child id to its gather index: by default through the row
        map; the batched SPR scan also targets its scan region."""
        parent_row = parent_row or (lambda e: self.row_map[e.parent])
        gidx = gidx or self._gidx
        raw = Tree.schedule_waves(entries)
        cap = self.wave_width
        W = min(next_pow2(max((len(w) for w in raw), default=1)), cap)
        waves = [w[i:i + W] for w in raw for i in range(0, len(w), W)]
        L = len(waves)
        C = self.num_branch_slots
        parent = np.full((L, W), self.scratch_row, dtype=np.int64)
        left = np.zeros((L, W), dtype=np.int64)
        right = np.zeros((L, W), dtype=np.int64)
        zl = np.ones((L, W, C), dtype=np.float64)
        zr = np.ones((L, W, C), dtype=np.float64)
        for li, wave in enumerate(waves):
            for wi, e in enumerate(wave):
                parent[li, wi] = parent_row(e)
                left[li, wi] = gidx(e.left)
                right[li, wi] = gidx(e.right)
                zl[li, wi, :] = z_slots(e.zl, C)
                zr[li, wi, :] = z_slots(e.zr, C)
        idx = torch.from_numpy(np.stack([parent, left, right])).to(
            self.device)
        z = torch.from_numpy(np.stack([zl, zr])).to(device=self.device,
                                                    dtype=self.dtype)
        return Traversal(parent=idx[0], left=idx[1], right=idx[2],
                         zl=z[0], zr=z[1])

    def _run_scan(self, entries: List[TraversalEntry]) -> None:
        tv = self._traversal_arrays(entries)
        kernels.traverse_store(self.models, self.block_part, self.tips,
                               self._store(), self.scaler, tv,
                               self.scale_exp, self.ntips, self.site_rates)

    # -- chunk-tier full traversals (ops/fastpath.py + kernel B1) ------------

    def _fast_eligible(self, entries) -> bool:
        return not self.psr and self.newview != "scan" and \
            isinstance(entries, FlatTraversal) and entries.n == self.n_inner

    @staticmethod
    def _cached(cache: "OrderedDict[bytes, object]", flat: FlatTraversal,
                build, counter: Optional[str] = None):
        """The entry of `cache` for flat's topology signature (topology +
        root edge only, so a stale entry can never be served), built on a
        miss; the least recently used of more than SCHED_CACHE_CAP goes.
        `counter` names the cache's hit / miss / evictions counters."""
        st = cache.get(flat.topo_key)
        if st is not None:
            cache.move_to_end(flat.topo_key)
            if counter:
                obs.inc(counter + ".hit")
            return st
        if counter:
            obs.inc(counter + ".miss")
        with obs.timer("host_schedule"):
            st = cache[flat.topo_key] = build()
        while len(cache) > SCHED_CACHE_CAP:
            cache.popitem(last=False)
            if counter:
                obs.inc(counter + ".evictions")
        return st

    def _build_structure(self, flat: FlatTraversal):
        if self.newview == "whole":
            return newview_whole.build_structure(flat, self.ntips,
                                                 self.num_branch_slots,
                                                 self.device)
        st = fastpath.build_structure(flat, self.ntips, self.device)
        if st.max_write > self.num_rows - 1:
            raise RuntimeError(f"chunk layout writes row {st.max_write} "
                               f"of a {self.num_rows}-row arena")
        return st

    def _structure(self, flat: FlatTraversal):
        """The layout of flat's topology on this engine's tier: a
        fastpath.FastStructure on the chunk tier, a
        newview_whole.WholeStructure on the whole tier."""
        return self._cached(self._sched_cache, flat,
                            lambda: self._build_structure(flat),
                            "engine.sched_cache")

    def _install_row_map(self, st) -> None:
        self.row_map[:st.row_of.shape[0]] = st.row_of

    def _run_fast(self, flat: FlatTraversal) -> None:
        """Full traversal on the chunk tier: one batched operand build (P in
        the compute dtype), then kernel B1 over the cached layout's launch
        table (every chunk with real entries, from one host call; the
        instance of the arena's storage dtype, one dataflow launch reading
        the structure's dataflow table and this arena's ready flags, or one
        launch a row); installs the wave-ordered row map it wrote."""
        global CHUNK_LAUNCH_ROWS
        st = self._structure(flat)
        zl, zr = fastpath.refresh_z(st, flat, self.num_branch_slots,
                                    self.dtype, self.device)
        pmat = newview_chunk.chunk_operands(self.models, zl, zr)
        CHUNK_LAUNCH_ROWS += st.launch.shape[0]
        newview_chunk.chunk_apply(self.clv, self.scaler, self.tips.codes,
                                  self.tips.table, self.block_part_i32,
                                  st.launch, st.lidx, st.ridx, st.lcode,
                                  st.rcode, pmat, self.scale_exp,
                                  newview_chunk.Dataflow(st.flow_rows,
                                                         st.wait,
                                                         self.ready))
        self._install_row_map(st)

    # -- whole-traversal tier (ops/newview_whole.py + kernel B2) -------------

    def _run_whole(self, flat: FlatTraversal) -> None:
        """Full traversal as one launch of kernel B2 (cached schedule,
        fresh z); installs the schedule's row map (rows 0..E-1 in wave
        order) once the launch went through."""
        st = self._structure(flat)
        zl, zr = newview_whole.refresh_z(st, flat, self.num_branch_slots)
        pmat = newview_whole.whole_operands(self.models, zl, zr, self.dtype,
                                            self.device)
        newview_whole.whole_apply(self.clv, self.scaler, self.tips.codes,
                                  self.tips.table, self.block_part_i32,
                                  st.meta, st.l_code, st.r_code,
                                  st.wave_start, pmat, self.scale_exp)
        self._install_row_map(st)

    def run_traversal(self, entries, full: bool = False) -> None:
        """Recompute CLVs for `entries` — a TraversalEntry list, or a
        `FlatTraversal` (full traversals take the `newview` tier)."""
        if not len(entries):
            return
        obs.inc("engine.dispatch_count")
        obs.inc("engine.traversal_entries", len(entries))
        self._record_traffic(self._traversal_traffic_bytes(entries),
                             self._tier_for(entries, full))
        with obs.device_span("engine:traverse",
                             args={"entries": len(entries),
                                   "full": bool(full)}):
            self._traverse(entries, full)

    def _traverse(self, entries, full: bool) -> None:
        global FULL_TRAVERSALS, PARTIAL_TRAVERSALS, POOLED_TRAVERSALS
        if not len(entries):
            return
        if self.sev is not None:
            if isinstance(entries, FlatTraversal):
                entries = entries.to_entries()
            POOLED_TRAVERSALS += 1
            self.sev.update_for_entries(entries)
            self.sev.sync()
            self._run_scan(entries)
            return
        if full and self._fast_eligible(entries):
            FULL_TRAVERSALS += 1
            if self.newview == "whole":
                self._run_whole(entries)
            else:
                self._run_fast(entries)
            return
        if isinstance(entries, FlatTraversal):
            entries = entries.to_entries()
        PARTIAL_TRAVERSALS += 1
        self._run_scan(entries)

    # -- evaluation ----------------------------------------------------------

    def _z(self, z) -> torch.Tensor:
        return torch.as_tensor(z_slots(z, self.num_branch_slots),
                               dtype=self.dtype, device=self.device)

    def evaluate(self, p_num: int, q_num: int, z: Sequence[float]) -> np.ndarray:
        """Per-partition lnL [M] at branch (p,q); CLVs must be current."""
        obs.inc("engine.dispatch_count")
        with obs.device_span("engine:evaluate"):
            return self._evaluate(p_num, q_num, z)

    def _evaluate(self, p_num: int, q_num: int,
                  z: Sequence[float]) -> np.ndarray:
        xp, sp = self._gather(p_num)
        xq, sq = self._gather(q_num)
        out = kernels.root_log_likelihood_from(
            self.models, self.block_part, self.weights, xp, sp, xq, sq,
            self._z(z), self.num_parts, self.scale_exp, self.site_rates)
        return self.group.allreduce(out.cpu().numpy())

    def traverse_evaluate(self, entries, p_num: int, q_num: int,
                          z: Sequence[float], full: bool = False) -> np.ndarray:
        """Traversal then root evaluation at (p, q).  The lnL comes back to
        the host, so the call's wall time covers the traversal: a full
        traversal feeds the achieved-GB/s window."""
        obs.inc("engine.dispatch_count")
        obs.inc("engine.traversal_entries", len(entries))
        nbytes = self._traversal_traffic_bytes(entries) if len(entries) \
            else 0
        t0 = time.perf_counter()
        with obs.device_span("engine:trav_eval",
                             args={"entries": len(entries),
                                   "full": bool(full)}):
            self._traverse(entries, full)
            out = self._evaluate(p_num, q_num, z)
        self._record_traffic(
            nbytes, self._tier_for(entries, full),
            wall_s=(time.perf_counter() - t0) if full and len(entries)
            else None)
        return out

    # -- branch derivatives ----------------------------------------------

    def make_sumtable(self, p_num: int, q_num: int) -> torch.Tensor:
        obs.inc("engine.dispatch_count")
        with obs.device_span("engine:sumtable"):
            return self._sumtable(p_num, q_num)

    def _sumtable(self, p_num: int, q_num: int) -> torch.Tensor:
        xp, _ = self._gather(p_num)
        xq, _ = self._gather(q_num)
        return kernels.sumtable(self.models, self.block_part, xp, xq)

    def branch_derivatives(self, st: torch.Tensor, z: Sequence[float]):
        obs.inc("engine.dispatch_count")
        with obs.device_span("engine:derivs"):
            d1, d2 = kernels.nr_derivatives(self.models, self.block_part,
                                            self.weights, st, self._z(z),
                                            self.num_branch_slots,
                                            self.site_rates)
            d = self.group.allreduce(torch.stack([d1, d2]).cpu().numpy())
        return d[0], d[1]

    def newton_branch(self, entries: List[TraversalEntry], p_num: int,
                      q_num: int, z0: np.ndarray, maxiter: int,
                      conv_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Partial traversal + sumtable + NR to convergence; new z [C]."""
        obs.inc("engine.dispatch_count")
        obs.inc("engine.newton_dispatches")
        obs.inc("engine.traversal_entries", len(entries))
        self._record_traffic(self._traversal_traffic_bytes(entries), "scan")
        C = self.num_branch_slots
        if conv_mask is None:
            conv_mask = np.zeros(C, dtype=bool)
        with obs.device_span("engine:newton",
                             args={"entries": len(entries)}):
            self._traverse(entries, False)
            st = self._sumtable(p_num, q_num)
            return kernels.newton_raphson_branch(
                self.models, self.block_part, self.weights, st,
                np.asarray(z0, np.float64), np.full(C, maxiter, np.int64),
                np.asarray(conv_mask, bool), C, self.site_rates,
                self.group.allreduce)

    # -- batched SPR radius scan (ops/scan.py) ------------------------------

    def ensure_scan_rows(self, n: int) -> int:
        """Grow the arena by a scan region of >= n rows (a power of two, so
        a search reallocates O(log n) times) and return the region's base
        row.  The region lies above the `num_rows` rows that traversals,
        the scratch row and the chunk layouts' slack use, so it is free
        scratch between scan calls.  The arena and the scaler are replaced
        by larger tensors, never kept elsewhere: every kernel reads
        self.clv / self.scaler (and their row count) at its call.

        Under -S the region is carved from the pool (`SevState.
        ensure_scan_rows`: a real cell in every block, rows below the
        node rows in the slot maps), and the dense scaler grows with it
        to the slot maps' row count, so that the scan rows' scalers have
        rows to go to."""
        if self.sev is not None:
            base = self.sev.ensure_scan_rows(n)
            grow = self.sev.num_rows - self.scaler.shape[0]
            if grow > 0:
                self.scaler = torch.cat([self.scaler, self.scaler.new_zeros(
                    (grow,) + self.scaler.shape[1:])])
            return base
        if n > self._scan_cap:
            grow = next_pow2(n) - self._scan_cap
            self.clv = torch.cat([self.clv, self.clv.new_zeros(
                (grow,) + self.clv.shape[1:])])
            self.scaler = torch.cat([self.scaler, self.scaler.new_zeros(
                (grow,) + self.scaler.shape[1:])])
            self._scan_cap += grow
        return self.num_rows

    def _scan_traversal_arrays(self, down_entries, up_entries,
                               base: int) -> Traversal:
        """The orientation fixes and the uppass entries wave-scheduled into
        one Traversal.  Scan slot s gets the id SLOT0 + s, above the node
        numbers, so Tree.schedule_waves resolves node->node, node->slot and
        slot->slot dependencies alike; down entries write arena rows
        through the row map, up entries the scan region from `base`."""
        SLOT0 = 2 * self.ntips + 1

        def ref_id(ref) -> int:
            kind, v = ref
            return SLOT0 + v if kind == "slot" else v

        pseudo = list(down_entries) + [
            TraversalEntry(SLOT0 + e.slot, ref_id(e.left), ref_id(e.right),
                           e.zl, e.zr)
            for e in up_entries]

        def parent_row(e) -> int:
            if e.parent >= SLOT0:
                return base + (e.parent - SLOT0)
            return self.row_map[e.parent]

        def gidx(ident: int) -> int:
            if ident >= SLOT0:
                return self.ntips + base + (ident - SLOT0)
            return self._gidx(ident)

        return self._traversal_arrays(pseudo, parent_row, gidx)

    def _scan_dispatch_arrays(self, plan, base: int):
        """Gather indices [N] of the candidates' down(q) and uppass(q).
        Unlike the JAX engine's, nothing is padded: torch ops take any
        candidate count."""
        qg = [self._gidx(c.q_num) for c in plan.candidates]
        upg = [self.ntips + base + c.up_slot for c in plan.candidates]
        idx = torch.as_tensor([qg, upg], dtype=torch.int64,
                              device=self.device)
        return idx[0], idx[1]

    def _scan_setup(self, plan):
        """(traversal, qg, upg) of a plan, the scan region grown to hold
        its uppass entries; counted as one partial traversal (a pooled one
        under -S, where the orientation fixes' cells are allocated
        first)."""
        global PARTIAL_TRAVERSALS, POOLED_TRAVERSALS
        obs.inc("engine.dispatch_count")
        obs.inc("engine.traversal_entries",
                len(plan.down_entries) + len(plan.up_entries))
        self._record_traffic(self._scan_plan_traffic_bytes(plan),
                             POOLED_TIER if self.sev is not None else "scan")
        if self.sev is not None:
            self.sev.update_for_entries(plan.down_entries)
            POOLED_TRAVERSALS += 1
        else:
            PARTIAL_TRAVERSALS += 1
        base = self.ensure_scan_rows(len(plan.up_entries))
        tv = self._scan_traversal_arrays(plan.down_entries, plan.up_entries,
                                         base)
        return (tv,) + self._scan_dispatch_arrays(plan, base)

    def batched_scan(self, plan) -> np.ndarray:
        """The orientation fixes, the uppass traversal and every
        candidate's lazy insertion score (ops/scan.py); returns
        this engine's per-candidate lnL sums [N] (float64)."""
        tv, qg, upg = self._scan_setup(plan)
        C = self.num_branch_slots
        with obs.device_span("engine:spr_scan",
                             args={"candidates": len(plan.candidates)}):
            zc = torch.as_tensor(np.stack([z_slots(c.z, C)
                                           for c in plan.candidates]),
                                 dtype=self.dtype, device=self.device)
            lnls = scan.scan_chunk(
                self.models, self.block_part, self.weights, self.tips,
                self._store(), self.scaler, tv, qg, upg, zc,
                self._gidx(plan.s_num), self._z(plan.zp), self.scale_exp,
                self.ntips, self.site_rates)
            return self.group.allreduce(lnls.cpu().numpy())

    def batched_thorough(self, plan, nr_iterations: int):
        """The thorough-arm companion of `batched_scan`: triangle
        Newton-Raphson (at most nr_iterations steps a solve), localSmooth
        and the score per candidate; returns (lnls [N], smoothed branch
        triplets [N, 3])."""
        tv, qg, upg = self._scan_setup(plan)
        zq0 = np.array([float(np.asarray(c.q_slot.z, np.float64)[0])
                        for c in plan.candidates])
        with obs.device_span("engine:spr_thorough",
                             args={"candidates": len(plan.candidates)}):
            lnls, es = scan.thorough_chunk(
                self.models, self.block_part, self.weights, self.tips,
                self._store(), self.scaler, tv, qg, upg, zq0,
                self._gidx(plan.s_num), self.scale_exp, self.ntips,
                nr_iterations, self.site_rates, self.group.allreduce)
            return self.group.allreduce(lnls.cpu().numpy()), es

    # -- PSR rate-grid scan ----------------------------------------------

    def rate_scan(self, entries: List[TraversalEntry], p_num: int,
                  q_num: int, z: Sequence[float],
                  grid: np.ndarray) -> np.ndarray:
        """Per-site lnL under each candidate rate: grid [B, lane, G] ->
        [B, lane, G] (float64).  `entries` must be a full traversal for
        the branch (p, q).  One traversal over a scratch arena [rows, B,
        lane, G, K], made for the call, replaces the reference's per-site
        `evaluatePartialGeneric` scan (`optimizeModel.c:1792-1922`).
        Under -S too the scratch arena is dense and the pool is not read
        (the PSR optimizer caps G at 2 there).  `grid` is global (every
        rank builds the same one from the host-global patrat): the rank
        scans its window of blocks and the result is allgathered, so
        every rank returns the global [B, lane, G]."""
        if not self.psr:
            raise RuntimeError("the rate scan needs an engine built with "
                               "psr")
        obs.inc("engine.dispatch_count")
        obs.inc("engine.traversal_entries", len(entries))
        with obs.device_span("engine:rate_scan",
                             args={"entries": len(entries)}):
            return self._rate_scan(entries, p_num, q_num, z, grid)

    def _rate_scan(self, entries, p_num, q_num, z, grid) -> np.ndarray:
        G = grid.shape[2]
        tv = self._traversal_arrays(entries)
        b0 = self.bucket.block_offset
        grid_dev = torch.as_tensor(
            np.asarray(grid, dtype=np.float64)[b0:b0 + self.B],
            dtype=self.dtype, device=self.device)
        clv = torch.zeros((self.num_rows, self.B, self.lane, G, self.K),
                          dtype=self.dtype, device=self.device)
        scaler = torch.zeros((self.num_rows, self.B, self.lane),
                             dtype=torch.int32, device=self.device)
        kernels.traverse(self.models, self.block_part, self.tips, clv,
                         scaler, tv, self.scale_exp, self.ntips, grid_dev)
        out = kernels.per_rate_site_lnls(
            self.models, self.block_part, self.tips, clv, scaler,
            self._gidx(p_num), self._gidx(q_num), self._z(z), grid_dev,
            self.scale_exp, self.ntips)
        return self.group.allgather_blocks(out.cpu().numpy())

    # -- whole-tree analytic gradients (ops/gradient.py) --------------------

    def _outroot_arena(self) -> torch.Tensor:
        """The outroot arena [2*ntips-1, B, lane, R, K]: one row per node
        (number - 1), the last row scratch, in the compute dtype whatever
        the CLV storage (as the JAX engine's).  Every pass writes each row
        it reads first, so the arena is made once and reused."""
        if self._outroot is None:
            self._outroot = torch.zeros(
                (2 * self.ntips - 1, self.B, self.lane, self.R, self.K),
                dtype=self.dtype, device=self.device)
        return self._outroot

    def whole_tree_gradients(self, flat: FlatTraversal, root_z, clv=None,
                             scaler=None, row_map=None, gs=None):
        """(d1, d2) [E, C] float64: the lnL's gradient and curvature with
        respect to lz = log z for every branch of the full traversal
        `flat`, from one pre-order pass and one batched edge-derivative
        pass.

        Edge order: edge 0 is the traversal's root edge; edges 1+2i /
        2+2i are entry i's left / right child branches (flat order).
        Precondition: the CLV arena is current for `flat` (a
        `run_traversal(flat, full=True)` on any tier just ran; the gather
        indices resolve through the row map that traversal installed);
        `root_z` is the root edge's branch vector.  `clv`, `scaler` and
        `row_map` name another arena holding flat's CLVs (a fleet job's
        slice of a stacked arena, fleet/batch.py) in place of the
        engine's own, `gs` the plan (default: the engine's cached one)."""
        if self.sev is not None:
            raise RuntimeError("the whole-tree gradient pass needs the "
                               "dense arena; -S SEV pools keep the "
                               "per-branch route")
        clv = self.clv if clv is None else clv
        scaler = self.scaler if scaler is None else scaler
        row_map = self.row_map if row_map is None else row_map
        if gs is None:
            gs = self._cached(self._grad_structs, flat,
                              lambda: gradient.build_structure(
                                  flat, self.wave_width))
        obs.inc("engine.dispatch_count")
        obs.inc("engine.grad_pass_dispatches")
        itemsize = clv.element_size()
        tips = int((flat.left <= self.ntips).sum()
                   + (flat.right <= self.ntips).sum())
        nbytes = _traffic.bytes_per_grad_pass(
            flat.n, tips, 2 * flat.n + 1, self._patterns_true, self.R,
            self.K, itemsize)
        t0 = time.perf_counter()
        with obs.device_span("engine:grad_pass",
                             args={"entries": flat.n}):
            d = self._grad_pass(flat, root_z, clv, scaler, row_map, gs)
        dt = time.perf_counter() - t0
        obs.observe("engine.grad_pass", dt)
        self._record_traffic(nbytes, "grad", wall_s=dt)
        return d[0], d[1]

    def _grad_pass(self, flat, root_z, clv, scaler, row_map, gs):
        global GRAD_PASSES
        C = self.num_branch_slots
        pre, ex_rows, ey_gidx, ez = gradient.grad_arrays(
            gs, flat, row_map, C, root_z)
        dev = self.device
        idx = torch.from_numpy(np.stack(pre[:5])).to(dev)
        zs = torch.from_numpy(np.stack(pre[5:])).to(device=dev,
                                                   dtype=self.dtype)
        tvp = OutrootTraversal(up_row=idx[0], lrow=idx[1], rrow=idx[2],
                               left=idx[3], right=idx[4], zu=zs[0],
                               zl=zs[1], zr=zs[2])
        eidx = torch.from_numpy(np.stack([ex_rows, ey_gidx])).to(dev)
        ezd = torch.from_numpy(ez).to(device=dev, dtype=self.dtype)
        out = self._outroot_arena()
        p, q = gs.roots

        def gidx(num: int) -> int:
            return num - 1 if num <= self.ntips else \
                self.ntips + int(row_map[num])

        dq, _ = kernels.gather_child(self.tips, clv, scaler, gidx(q),
                                     self.ntips)
        dp, _ = kernels.gather_child(self.tips, clv, scaler, gidx(p),
                                     self.ntips)
        out[p - 1] = dq.to(out.dtype)
        out[q - 1] = dp.to(out.dtype)
        kernels.outroot_pass(self.models, self.block_part, self.tips,
                             clv, scaler, out, tvp, self.scale_exp,
                             self.ntips, self.site_rates)
        d1, d2 = gradient.edge_gradients(
            self.models, self.block_part, self.weights, self.tips, clv,
            scaler, out, eidx[0], eidx[1], ezd, C, self.ntips,
            self.site_rates)
        GRAD_PASSES += 1
        return self.group.allreduce(torch.stack([d1, d2]).cpu().numpy())
