"""Batched many-tree evaluation: J jobs through one launch table.

The port of `examl_tpu/fleet/batch.py`.  The JAX package `vmap`s its
chunk program over a job axis; here kernel B1 already reads its launch
table, its child rows and its packed slots as data, so a batch of tree
jobs is one table over a stacked arena (`fastpath.stack_tables`):
job j owns rows j*Rj .. (j+1)*Rj-1 (Rj = the engine's `num_rows`, the
JAX package's `n_inner + fast_slack + 1`), and its chunks, slots and
inner-child rows move there.  Per engine and batch: one transfer of all
jobs' branch vectors, each job's P (and on the card its tip products) at
its own shapes, one `newview_chunk.chunk_apply` (on the card one
dataflow launch, or one launch a row from one host call on the per-chunk
route), then each job's root reduction on its slice of the arena and one
read-back.  Each job reads and writes only its own rows, with the
arithmetic of a traversal of its own, so its lnL does not depend on the
batch it lands in: it equals the job's one-at-a-time evaluate bit for
bit (the parity the tests pin).

* TREE batches: every chunk-tier job shares one group key (`FAST_GROUP`)
  whatever its topology, since B1 compiles nothing per shape: the
  port's counterpart of both the JAX package's per-profile `_fast_fn`
  and its mixed-profile `launch_universal`.  No job count is padded.
* SCAN groups: under PSR or `newview="scan"`, jobs group by the JAX
  package's wave-scan shape and each job's traversal runs on the
  wave-scan tier, one job after another (there is no kernel there).
* WEIGHTS batches: bootstrap replicates on a fixed topology share one
  ordinary CLV pass, then one batched root reduction over their weight
  vectors (pattern weights enter only there).
* SMOOTHING (`smooth_batch`): per sweep the stacked table gives every
  job's post-order, each job's gradient pass reads its slice
  (`engine.whole_tree_gradients`), and the host applies the batched
  Rprop-damped Newton update of optimize/branch.py.

A stacked arena that would not fit in the card's free memory is cut:
the batch runs as consecutive parts in queue order (the evaluator's
`log` says so), with the same results.

LAUNCH AND COLLECT: `eval_batch` is `collect(launch_eval(jobs))`.
`launch_eval` enqueues the whole batch on the evaluator's own CUDA
stream and records an event, without a host sync (every host-to-device
copy is asynchronous, `fastpath.upload`: the stacked tables, the branch
vectors, the root branches' gather indices and z); `collect` waits on
the event and reads the rows back once.  So the lanes of
fleet/shard.py, each an evaluator with its own stream, ready flags and
constants, all launch before any collects.  Every engine constant the
batch reads goes through `_const`, which a lane overrides with its own
device's copies.  The memory a batch needs is decided before the
launch (`admit`): the stacked arena's parts, reserved on the lane's
device (`memgov.reserve`) until the launch allocates them.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet import bootstrap
from examl_tpu_torch.ops import (engine as _engine, fastpath, gradient,
                                 kernels, newview_chunk)
from examl_tpu_torch.resilience import memgov
from examl_tpu_torch.utils import bucket_len, next_pow2, z_slots

# Batch-group keys: shared-topology weight replicates, and every
# chunk-tier tree job.
WEIGHTS_GROUP = ("weights",)
FAST_GROUP = ("fast",)
# Bytes left free beside a stacked arena on the card (P, the tip
# products, the root reductions' and the gradient pass's transients).
ARENA_MARGIN = 4 << 30
# Stacked tables dispatched, one per engine per batch part (a plain
# count, read by chip_smoke.py beside B1's launches).
TABLES = 0


class PreparedJob:
    """One job's host-side evaluation state: the centroid-rooted flat
    traversal (rebuilt per cycle — branch lengths move), its launch table
    (topology-keyed, reused across cycles), its batch group key and its
    root branch vector."""

    __slots__ = ("tree", "p", "flat", "st", "key", "z", "gs")

    def __init__(self, tree, p, flat, st, key, z):
        self.tree = tree
        self.p = p
        self.flat = flat
        self.st = st          # fastpath.JobTable (chunk tier) or None
        self.key = key        # hashable batch-group key
        self.z = z            # root-branch z [C]
        self.gs = None        # gradient plan (built at the first sweep,
                              # reused while the topology holds)


class Admission:
    """A batch's stacked arenas admitted on its lane's device: per engine
    (by state count) the sizes of the parts, in queue order, that its jobs
    are cut into to fit, and the bytes held there (`memgov.reserve`) until
    the launch allocates them or `release` (idempotent) gives them up.
    Sizes, not jobs: a job may be prepared again (smoothed) between its
    admission and its launch."""

    __slots__ = ("parts", "device", "nbytes")

    def __init__(self, parts: dict, device, nbytes: int):
        self.parts = parts
        self.device = device
        self.nbytes = int(nbytes)
        memgov.reserve(device, self.nbytes)

    def release(self) -> None:
        memgov.unreserve(self.device, self.nbytes)
        self.nbytes = 0


class PendingBatch:
    """A launched, not yet collected batch: its per-job rows on the
    device (columns in the evaluator's `columns` order; a MeshShard's:
    its slices' PendingBatches), the evaluator lane that launched it,
    and the event recorded after the rows on the lane's stream (None on
    the CPU).  Everything else the launch allocated was allocated on the
    lane's stream, so the caching allocator hands it out again only to
    work queued after it there."""

    __slots__ = ("jobs", "out", "ev", "done")

    def __init__(self, jobs, out, ev, done=None):
        self.jobs = jobs
        self.out = out
        self.ev = ev
        self.done = done


def batch_eligible(inst) -> Optional[str]:
    """None when the instance can take the batched tier, else the reason
    it cannot (the driver then evaluates jobs one at a time)."""
    if inst.save_memory:
        return "-S SEV pools hold one arena per instance"
    if inst.group.size > 1:
        return "multi-process sharded arenas cannot stack per job"
    return None


class BatchEvaluator:
    """Batched evaluation over one PhyloInstance (all engines).  `log`
    receives the note of a batch cut to fit the card's memory.

    `shard`: over an instance of S > 1 site shards, the evaluator of
    shard `shard`'s engines alone, on its card: its rows are that
    window's partial sums, which fleet/shard.py's `SiteLanes` adds up
    over the shards (an instance over site shards batches through
    `inst.batch_evaluator()`)."""

    def __init__(self, inst, log=None, shard: Optional[int] = None):
        reason = batch_eligible(inst)
        if reason is not None:
            raise ValueError(f"batched tier unavailable: {reason}")
        if shard is None and inst.site_shards > 1:
            raise ValueError(
                f"an instance over {inst.site_shards} site shards batches "
                "one lane a shard (inst.batch_evaluator(): SiteLanes or "
                "MeshShard, fleet/shard.py)")
        self.inst = inst
        self.shard = shard
        self.engines = [e.shards[shard or 0] for e in inst.engines.values()]
        eng = self.engines[0]
        self.ntips = eng.ntips
        self.C = inst.num_branch_slots
        self.fast = not eng.psr and eng.fast_slack > 0
        self.wave_width = eng.wave_width
        self.log = log or (lambda *_: None)
        # The lane: its device (the instance's, or its shard's, for the
        # primary), its own CUDA stream (made at the first launch), the
        # stream whose work its launches wait for besides the caller's
        # (a site shard's worker stream, `after`), and its index in the
        # driver's counters.
        self.device = _indexed(eng.device)
        self.index = 0
        self.seam = "fleet.batch_arenas"
        self.stream = None
        self.after = None
        if shard and inst.shard_pool is not None:
            self.after = inst.shard_pool.streams[shard]
        # The stacked arenas' ready flags, one set per engine (the
        # engine's own flags belong to its own arena), for the launches on
        # the lane's stream, and a second set for those on any other
        # (`_flags`): two launches in flight never share one.
        self._ready = {states: newview_chunk.Ready()
                       for states in inst.engines}
        self._default_ready = {states: newview_chunk.Ready()
                               for states in inst.engines}
        # Partition id of each column of a batch's [J, M] result.
        self.columns = [gid for e in self.engines
                        for gid in e.bucket.part_ids]

    def _const(self, eng, name: str):
        """One engine constant (models, tips, block_part, block_part_i32,
        weights, site_rates) as this evaluator's launches read it: the
        engine's own; a DeviceShard (fleet/shard.py) overrides this with
        its device's copies."""
        return getattr(eng, name)

    @contextlib.contextmanager
    def _on_lane(self):
        """Everything inside runs on this lane's stream (its allocations
        belong to that stream), after the work already queued on the
        device's current stream.  A no-op on the CPU."""
        if self.device.type != "cuda":
            yield
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        if self.after is not None:
            self.stream.wait_stream(self.after)
        with torch.cuda.stream(self.stream):
            yield

    # -- preparation / grouping --------------------------------------------

    def prepare(self, tree, prev: Optional[PreparedJob] = None) -> PreparedJob:
        """Host-side schedule state for one job (cheap on re-prepare:
        the launch table survives while the topology holds; only z
        refreshes)."""
        p = tree.centroid_branch()
        flat = tree.flat_full_traversal(p)
        z = np.asarray(z_slots(p.z, self.C), dtype=np.float64)
        if not self.fast:
            return PreparedJob(tree, p, flat, None,
                               ("scan",) + self._scan_shape(flat), z)
        same = prev is not None and prev.st is not None \
            and prev.flat.topo_key == flat.topo_key
        st = prev.st if same else fastpath.job_table(flat, self.ntips)
        pj = PreparedJob(tree, p, flat, st, FAST_GROUP, z)
        if same:
            pj.gs = prev.gs
        return pj

    def _scan_shape(self, flat) -> tuple:
        """The JAX package's wave-scan [L, W] traversal shape: the group
        key of PSR jobs."""
        sizes = np.asarray(flat.wave_sizes)
        W = min(next_pow2(int(sizes.max())), self.wave_width) \
            if len(sizes) else 1
        nwaves = int(np.sum((sizes + W - 1) // W))
        return (bucket_len(nwaves), W)

    # -- the stacked table ---------------------------------------------------

    def _gidx(self, job: PreparedJob, num: int) -> int:
        """Gather index of node num in its job's slice of the arena."""
        return num - 1 if num <= self.ntips else \
            self.ntips + int(job.st.row_of[num])

    def _parts(self, eng, jobs: List[PreparedJob]) -> List[list]:
        """`jobs` cut in queue order into parts whose stacked arenas fit
        in the card's free memory less ARENA_MARGIN (one part on the
        CPU), and under the memory governor's budget: under pressure
        `memgov.effective_cap` shrinks the part (occupancy shrinks
        instead of OOM), and each part's arena is an admission
        (`memgov.admit_bytes`: a denial is counted, never a block)."""
        if len(jobs) == 1:
            return [jobs]
        per_job = self._job_bytes(eng)
        dev = self.device if eng.device.type == self.device.type \
            else eng.device
        fit = len(jobs)
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            free += (torch.cuda.memory_reserved(dev)
                     - torch.cuda.memory_allocated(dev)
                     - memgov.reserved_bytes(dev))
            fit = min(fit, max(1, (free - ARENA_MARGIN) // per_job))
        cap = memgov.effective_cap(fit)
        memgov.admit_bytes(cap * per_job, seam=self.seam, device=dev)
        if cap >= len(jobs):
            return [jobs]
        why = ("the memory budget" if cap < fit
               else f"{free / 1e9:.2f} GB free")
        self.log(f"fleet: a batch of {len(jobs)} jobs needs "
                 f"{len(jobs) * per_job / 1e9:.2f} GB of stacked arena; "
                 f"under {why} it runs in parts of {cap} jobs in queue "
                 "order")
        return [jobs[i:i + cap] for i in range(0, len(jobs), cap)]

    @staticmethod
    def _job_bytes(eng) -> int:
        """One job's rows of a stacked arena and its scaler."""
        return eng.num_rows * eng.B * eng.lane * (
            eng.R * eng.K * eng.clv.element_size() + 4)

    def admit(self, jobs: List[PreparedJob]) -> Admission:
        """The batch's arenas admitted on this lane's device, before its
        launch: per engine the parts `_parts` cuts (free memory read
        here, less what other lanes reserved on the card), and the
        largest part's bytes reserved until the launch.  Wave-scan
        batches stack nothing."""
        if not self.fast:
            return Admission({K: [len(jobs)] for K in self.inst.engines},
                             self.device, 0)
        parts = {eng.K: [len(p) for p in self._parts(eng, jobs)]
                 for eng in self.engines}
        nbytes = max(max(parts[eng.K]) * self._job_bytes(eng)
                     for eng in self.engines)
        return Admission(parts, self.device, nbytes)

    def _operands(self, eng, jobs: List[PreparedJob]):
        """The stacked table's P [sum P_j, 2, M, R, K, K] and, on the card,
        its tip products: every job's branch vectors go to the device in
        one transfer, then each job's P and tip products are built at its
        own shapes and concatenated.  A batched matmul over all jobs'
        slots at once may take another cuBLAS kernel than one job's alone
        (measured on the H100 at 512 taxa: last-bit differences), and
        each job's P must be the bits of its own traversal."""
        zs = [fastpath.refresh_z_host(j.st, j.flat, self.C) for j in jobs]
        z = fastpath.upload(np.stack([
            np.concatenate([a for a, _ in zs]),
            np.concatenate([b for _, b in zs])]), self.device, eng.dtype)
        sizes = [a.shape[0] for a, _ in zs]
        models = self._const(eng, "models")
        pms = [newview_chunk.chunk_operands(models, zl, zr)
               for zl, zr in zip(z[0].split(sizes), z[1].split(sizes))]
        u = None
        if self.device.type == "cuda":
            table = self._const(eng, "tips").table
            u = torch.cat([newview_chunk.tip_products(p, table)
                           for p in pms])
        return torch.cat(pms), u

    def _flags(self) -> dict:
        """The ready flags of a launch on the current stream: the lane's
        own on its stream, another set on any other (a stacked table on
        the default stream, as batched smoothing runs, while this lane's
        batch may be in flight)."""
        if self.stream is not None and \
                torch.cuda.current_stream(self.device) == self.stream:
            return self._ready
        return self._default_ready

    def _traverse(self, eng, jobs: List[PreparedJob]):
        """Every job's full traversal through one launch table over a
        stacked arena [J * Rj, B, lane, R, K] (kernel B1 on the card, its
        plain version on the CPU), on the current stream.  Returns (clv,
        scaler).  The arena is not cleared: the table writes every row
        that anything reads."""
        global TABLES
        Rj = eng.num_rows
        table = fastpath.stack_tables([j.st for j in jobs], Rj, self.device)
        pmat, u = self._operands(eng, jobs)
        tips = self._const(eng, "tips")
        rows = len(jobs) * Rj
        clv = torch.empty((rows, eng.B, eng.lane, eng.R, eng.K),
                          dtype=eng.storage_dtype, device=self.device)
        scaler = torch.empty((rows, eng.B, eng.lane), dtype=torch.int32,
                             device=self.device)
        newview_chunk.chunk_apply(
            clv, scaler, tips.codes, tips.table,
            self._const(eng, "block_part_i32"), table.launch, table.lidx,
            table.ridx, table.lcode, table.rcode, pmat, eng.scale_exp,
            newview_chunk.Dataflow(table.flow_rows, table.wait,
                                   self._flags()[eng.K]), u)
        TABLES += 1
        return clv, scaler

    # -- tree batches --------------------------------------------------------

    def eval_batch(self, jobs: List[PreparedJob]) -> np.ndarray:
        """Per-job per-partition lnL [J, M] for one same-key batch:
        `collect(launch_eval(jobs))`."""
        return self.collect(self.launch_eval(jobs))

    def launch_eval(self, jobs: List[PreparedJob],
                    admission: Optional[Admission] = None) -> PendingBatch:
        """Enqueue one same-key batch on this lane without a host sync:
        per engine one stacked table per admitted part (`admit`, made here
        by default) and each job's root reduction on its slice of the
        arena, or on the wave-scan tier each job's traversal and root
        reduction on an arena of the lane's own; then an event on the
        lane's stream.  Every host-to-device copy is asynchronous
        (`fastpath.upload`)."""
        assert jobs, "empty batch"
        assert len({j.key for j in jobs}) == 1, \
            "batch mixes job groups (driver bug)"
        if admission is None:
            admission = self.admit(jobs)
        try:
            obs.inc("engine.dispatch_count")
            with obs.device_span("fleet:batch_eval",
                                 args={"jobs": len(jobs)}), self._on_lane():
                outs = []
                for eng in self.engines:
                    if not self.fast:
                        outs.append(self._scan_rows(eng, jobs))
                        continue
                    rows, i = [], 0
                    for n in admission.parts[eng.K]:
                        part, i = jobs[i:i + n], i + n
                        clv, scaler = self._traverse(eng, part)
                        rows += self._root_rows(eng, part, clv, scaler)
                        del clv, scaler
                    outs.append(torch.stack(rows))
                out = torch.cat(outs, dim=1)
                done = None
                if self.stream is not None:
                    done = torch.cuda.Event()
                    done.record(self.stream)
        finally:
            admission.release()
        return PendingBatch(jobs, out, self, done)

    def collect(self, pending: PendingBatch) -> np.ndarray:
        """A launched batch's per-job per-partition lnL [J, M]: wait for
        its event, then read its rows back once."""
        return self._scatter(self._host_rows(pending))

    def _host_rows(self, pending: PendingBatch) -> np.ndarray:
        """A launched batch's device rows on the host, as computed (the
        columns of `columns`): wait for its event, then one read-back."""
        if pending.done is not None:
            pending.done.synchronize()
        with self._on_lane():
            return pending.out.cpu().numpy()

    def _roots(self, eng, jobs, gidx):
        """Every job's root branch on the device, two transfers: the
        gather indices [J, 2] and the branch vectors [J, C]."""
        idx = fastpath.upload(np.asarray(
            [[gidx(j, j.p.number), gidx(j, j.p.back.number)] for j in jobs],
            dtype=np.int64), self.device)
        z = fastpath.upload(np.stack([z_slots(j.z, eng.num_branch_slots)
                                      for j in jobs]).astype(np.float64),
                            self.device, eng.dtype)
        return idx, z

    def _root_rows(self, eng, jobs, clv, scaler) -> list:
        """Each job's per-partition lnL [M_eng] at its root branch, from
        its slice of the stacked arena (the engine's `evaluate`)."""
        Rj = eng.num_rows
        idx, z = self._roots(eng, jobs, self._gidx)
        models, block_part, weights, tips, site_rates = (
            self._const(eng, n) for n in ("models", "block_part", "weights",
                                          "tips", "site_rates"))
        out = []
        for i in range(len(jobs)):
            v = slice(i * Rj, (i + 1) * Rj)
            out.append(kernels.root_log_likelihood(
                models, block_part, weights, tips, clv[v], scaler[v],
                idx[i, 0], idx[i, 1], z[i], eng.num_parts, eng.scale_exp,
                eng.ntips, site_rates))
        return out

    def _scan_rows(self, eng, jobs) -> torch.Tensor:
        """PSR (and `newview="scan"`): each job's traversal on the wave-scan
        tier (the engine's schedule, through its row map) and its root
        reduction, one job after another, on an arena of the lane's own,
        never the engine's (two lanes must not write one arena): the
        arithmetic of the engine's `traverse_evaluate`."""
        idx, z = self._roots(eng, jobs, lambda j, num: eng._gidx(num))
        models, block_part, weights, tips, site_rates = (
            self._const(eng, n) for n in ("models", "block_part", "weights",
                                          "tips", "site_rates"))
        clv = torch.zeros((eng.num_rows, eng.B, eng.lane, eng.R, eng.K),
                          dtype=eng.storage_dtype, device=self.device)
        scaler = torch.zeros((eng.num_rows, eng.B, eng.lane),
                             dtype=torch.int32, device=self.device)
        out = []
        for i, j in enumerate(jobs):
            _engine.PARTIAL_TRAVERSALS += 1
            tv = eng._traversal_arrays(j.flat.to_entries(),
                                       device=self.device)
            kernels.traverse_store(models, block_part, tips,
                                   kernels.DenseArena(clv), scaler, tv,
                                   eng.scale_exp, eng.ntips, site_rates)
            out.append(kernels.root_log_likelihood(
                models, block_part, weights, tips, clv, scaler, idx[i, 0],
                idx[i, 1], z[i], eng.num_parts, eng.scale_exp, eng.ntips,
                site_rates))
        return torch.stack(out)

    def _scatter(self, vals: np.ndarray) -> np.ndarray:
        """Per-job per-partition lnL [J, M] from a batch's host rows
        (columns in `columns` order)."""
        per_part = np.full((vals.shape[0], len(self.inst.models)), np.nan)
        per_part[:, self.columns] = vals
        return per_part

    # -- batched whole-tree gradient smoothing (--fleet-cycles) --------------

    def _grad_batch(self, jobs: List[PreparedJob]):
        """(d1, d2) [J, E, C] summed across engines: per engine the
        stacked post-order, then each job's whole-tree gradient pass on
        its slice (the tree's branch vectors re-read: smoothing moves
        them between sweeps)."""
        self._grad_plans(jobs)
        return self._grad_rows(jobs)

    def _grad_plans(self, jobs: List[PreparedJob]) -> None:
        """Each job's traversal with its current branch vectors, and its
        gradient plan (kept while the topology holds)."""
        for j in jobs:
            j.flat = j.tree.flat_full_traversal(j.p)
            if j.gs is None:
                j.gs = gradient.build_structure(j.flat, self.wave_width)

    def _grad_rows(self, jobs: List[PreparedJob]):
        """`_grad_batch` after `_grad_plans`: each engine's gradient pass
        reduces its sums over the engine's group (a site shard's over
        the shards, so every shard runs this at once)."""
        d1 = d2 = None
        for eng in self.engines:
            eng._outroot_arena()          # allocated before _parts measures
            e1s, e2s = [], []
            Rj = eng.num_rows
            for part in self._parts(eng, jobs):
                clv, scaler = self._traverse(eng, part)
                for i, j in enumerate(part):
                    v = slice(i * Rj, (i + 1) * Rj)
                    a, b = eng.whole_tree_gradients(
                        j.flat, z_slots(j.p.z, self.C), clv[v], scaler[v],
                        j.st.row_of, j.gs)
                    e1s.append(a)
                    e2s.append(b)
                del clv, scaler
            e1, e2 = np.stack(e1s), np.stack(e2s)
            d1 = e1 if d1 is None else d1 + e1
            d2 = e2 if d2 is None else d2 + e2
        return d1, d2

    def smooth_batch(self, jobs: List[PreparedJob], maxtimes: int) -> bool:
        """Whole-tree gradient smoothing for one batch: per sweep one
        stacked table per engine covers every job's post-order, then the
        batched Rprop-damped Newton update moves all jobs' branches at
        once (optimize/branch.py's `gradient_smooth_tree`, per job).
        A job stops moving once a sweep moved none of its branches by
        more than DELTAZ.  Returns False when some job still moved at the
        sweep budget, which the caller accepts as the per-branch route
        accepts its own."""
        from examl_tpu_torch.constants import DELTAZ, ZMAX, ZMIN
        from examl_tpu_torch.optimize.branch import GRAD_DAMPING, _edge_slots
        assert jobs
        J = len(jobs)
        slot_lists = [_edge_slots(j.tree, j.flat, j.p) for j in jobs]
        scale = prev_step = None
        done = np.zeros(J, dtype=bool)
        for _ in range(max(1, 4 * maxtimes)):
            d1, d2 = self._grad_batch(jobs)                # [J, E, C]
            z0 = np.clip(np.stack(
                [[z_slots(s.z, self.C) for s in sl] for sl in slot_lists]),
                ZMIN, ZMAX)
            znew = gradient.newton_step(z0, d1, d2)
            step = np.log(znew) - np.log(z0)
            if scale is None:
                scale = np.full_like(step, GRAD_DAMPING)
            else:
                flip = prev_step * step < 0.0
                scale = np.maximum(
                    np.where(flip, scale * 0.5,
                             np.minimum(scale * 1.2, GRAD_DAMPING)),
                    1.0 / 64)
            prev_step = step
            zapp = np.clip(z0 * np.exp(step * scale), ZMIN, ZMAX)
            zapp = np.where(done[:, None, None], z0, zapp)
            moved = np.abs(zapp - z0) > DELTAZ
            for ji, sl in enumerate(slot_lists):
                if done[ji]:
                    continue
                for i, s in enumerate(sl):
                    s.z[:] = zapp[ji, i].tolist()
            done |= ~moved.any(axis=(1, 2))
            if done.all():
                return True
        return False

    # -- weights-only batch (shared topology) --------------------------------

    def eval_weights_batch(self, tree,
                           per_job_weights: List[List[np.ndarray]]
                           ) -> np.ndarray:
        """Per-job per-partition lnL [J, M] of J weight replicates on ONE
        topology: one ordinary CLV pass (the instance's evaluate, on its
        engines' tier), then per engine one root reduction over the J
        weight vectors [J, B, lane]; read back once."""
        assert per_job_weights
        p = tree.centroid_branch()
        self.inst.evaluate(tree, p, full=True)
        obs.inc("engine.dispatch_count")
        with obs.device_span("fleet:weights_eval",
                             args={"jobs": len(per_job_weights)}):
            return self._weights_rows(p, per_job_weights)

    def _weights_rows(self, p, per_job_weights) -> np.ndarray:
        return self._scatter(self._weights_host(p, per_job_weights))

    def _weights_host(self, p, per_job_weights) -> np.ndarray:
        """The weights batch's rows [J, columns] from the engines' live
        arenas (current for the tree at p), read back once."""
        outs = []
        for eng in self.engines:
            # Converted on the device: one transfer, no host pass.
            w = torch.from_numpy(bootstrap.packed_weights_batch(
                eng.bucket, per_job_weights)).to(eng.device).to(eng.dtype)
            xp, sp = eng._gather(p.number)
            xq, sq = eng._gather(p.back.number)
            terms = kernels.root_site_terms(
                eng.models, eng.block_part, xp, sp, xq, sq, eng._z(p.z),
                eng.scale_exp, eng.site_rates)
            outs.append(kernels.weighted_root_sums(w, terms, eng.block_part,
                                                   eng.num_parts))
        return torch.cat(outs, dim=1).cpu().numpy()


def _indexed(device) -> torch.device:
    """A card named with its index (`cuda` -> `cuda:<current>`), so that
    one card has one name in the lanes' reservations and counters."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
