"""The fleet's tree axis: evaluation lanes over devices.

The port of `examl_tpu/fleet/shard.py`.  The jobs of a fleet are
independent, so the second parallel axis is data parallelism over the
host's cards: the drain cuts up to one batch per lane, largest group
first, and round-robins the cuts over the lanes (fleet/driver.py).

* `DeviceShard` — a `BatchEvaluator` whose launches run on one device:
  the engine constants every launch reads (`_CONST_NAMES`) are copied
  there at init, and it owns its CUDA stream and its `newview_chunk.Ready`
  flags per engine (two launches in flight must never share one).  Its
  stacked arenas, operands and wave-scan arenas are allocated on its
  stream.  Init probes the device with a real tiny dispatch.
* `SiteLanes` — the batched tier of an instance over S site shards
  (parallel/shards.py): a lane per shard, each over its shard's engines
  and block window on its card, every job's row the shards' partial
  rows summed in rank order (the instance's `evaluate`, bit for bit).
  Launches go out from the caller's thread with no collective; the
  gradient passes of smoothing and the weights batches, which reduce
  or read the live arenas, run on the shards' threads.
* `MeshShard` — the `SxT` fabric (parallel/sharding.py): one evaluator
  whose batches are cut into T slices of `ceil(J / T)` jobs in queue
  order, each launched as its own table on its slice's device and
  stream (a `DeviceShard` per slice), or for S > 1 as one table a site
  shard on the slice's S cards (a `SiteLanes` per slice: slice 0 the
  instance's engines, slice k >= 1 `DeviceShard`s over each shard's
  engines), and collected together.  J real jobs, no padding: kernel
  B1 compiles nothing per batch size.
* `ShardSet` — the primary lane (the instance's own evaluator, on its
  device; it also runs the work anchored to the engines' live arenas:
  bootstrap weight batches and `--fleet-cycles` smoothing) plus one
  `DeviceShard` per further device.

Launch and collect are two phases (`launch_eval` enqueues without a host
sync, `collect` waits on the lane's event), so every lane launches
before any collects and lanes on distinct cards run at once.  Lanes may
share a card (an explicit device list from Python names it more than
once): they then run the same code paths, streams and readbacks, and
the kernels of several lanes share its SMs.

FAULT DOMAIN: a whole-card lane whose INIT raises is dropped from the
set (`fleet.device_degraded`, an operator log line), never an abort; a
fabric's lane whose init raises fails the fabric (it cannot run without
one of its slices or site shards).  A shard lane that raises in a batch
ends the batch with its own error (on the shards' threads the board is
reset, parallel/shards.py).  A
CUDA or kernel error AFTER init is no job's and no lane's to absorb: as
on one lane, `_build.KernelError` and CUDA runtime errors end the run
(fleet/quarantine.py: `device_fault`).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet.batch import (WEIGHTS_GROUP, BatchEvaluator,
                                         PendingBatch, PreparedJob, _indexed)

# The engine constants a lane's launches read, copied to its device.
_CONST_NAMES = ("models", "tips", "block_part", "block_part_i32", "weights",
                "site_rates")


def _to(value, device):
    """A constant on `device`: a tensor, or a NamedTuple of tensors
    (DeviceModels, TipState); None stays None.  A tensor already there is
    the same tensor."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return type(value)(*(_to(v, device) for v in value))


def _probe(device) -> None:
    """A real tiny dispatch: a lane that cannot even add two numbers must
    fail at INIT, not its first real batch."""
    probe = torch.ones((), dtype=torch.float32, device=device)
    if float(probe + 1.0) != 2.0:
        raise RuntimeError(f"device {device} failed its probe")


class DeviceShard(BatchEvaluator):
    """A BatchEvaluator whose launches run on one specific device (over
    site shard `shard`'s engines of an instance over site shards)."""

    def __init__(self, inst, device, index: int, log=None,
                 shard: Optional[int] = None):
        super().__init__(inst, log=log, shard=shard)
        self.device = _indexed(device)
        self.index = int(index)
        # Keyed by state count within the lane; a lane holds one shard's.
        self._consts = {
            eng.K: {name: _to(getattr(eng, name), self.device)
                    for name in _CONST_NAMES} for eng in self.engines}
        _probe(self.device)

    def _const(self, eng, name: str):
        return self._consts[eng.K][name]


@contextlib.contextmanager
def _quiet(on: bool):
    """The caller's instruments off inside (on=True): a batch is counted,
    timed and traced once, by its first site shard's lane."""
    was = obs.quiet()
    obs.set_quiet(was or on)
    try:
        yield
    finally:
        obs.set_quiet(was)


class SiteLanes(BatchEvaluator):
    """The batched tier of an instance over S site shards: one lane per
    shard, each the evaluator of that shard's engines on its card (its
    own stream, ready flags and stacked arenas over its block window),
    and each job's row the shards' partial rows summed in rank order, as
    `SiteGroup.allreduce` sums them: bit for bit the job's `evaluate` on
    the instance.  `lanes`: the shards' lanes of one tree slice (default:
    the live engines' lanes on the shards' own cards, slice 0).

    Launching needs no collective, so `launch_eval` issues every lane's
    table from the caller's thread, one card after another, without a
    host sync; `collect` reads each lane's rows back and sums them.  The
    work whose engine ops reduce inside (smoothing's gradient passes)
    and the weights batches, which read the live arenas, run on every
    shard at once through the instance's ShardPool."""

    def __init__(self, inst, lanes: Optional[List[BatchEvaluator]] = None,
                 index: int = 0, log=None):
        super().__init__(inst, log=log, shard=0)
        self.pool = inst.shard_pool
        # The live lanes (the instance's engines, on the pool's cards) are
        # the ones the pool's work may run on.
        self.live = lanes is None
        if lanes is None:
            lanes = [BatchEvaluator(inst, log=log, shard=s)
                     for s in range(inst.site_shards)]
        if len(lanes) != inst.site_shards:
            raise ValueError(f"{len(lanes)} lanes for {inst.site_shards} "
                             "site shards")
        self.lanes = lanes
        self.index = int(index)
        self.device = self.lanes[0].device

    def admit(self, jobs: List[PreparedJob]) -> "SliceAdmissions":
        """Each shard lane's arenas admitted on its card in rank order, so
        a lane counts the reservations of the lanes before it there."""
        return SliceAdmissions(lane.admit(jobs) for lane in self.lanes)

    def launch_eval(self, jobs: List[PreparedJob],
                    admission: Optional["SliceAdmissions"] = None
                    ) -> PendingBatch:
        assert jobs, "empty batch"
        subs = admission if admission is not None else \
            [None] * len(self.lanes)
        pending = []
        try:
            for r, (lane, adm) in enumerate(zip(self.lanes, subs)):
                with _quiet(r > 0):
                    pending.append(lane.launch_eval(jobs, adm))
        finally:
            if admission is not None:
                admission.release()
        return PendingBatch(jobs, pending, self)

    def _sum(self, parts: list) -> np.ndarray:
        """The shards' rows [J, columns] summed in rank order, in float64:
        `SiteGroup.allreduce`'s arithmetic."""
        out = np.asarray(parts[0], dtype=np.float64).copy()
        for p in parts[1:]:
            out += np.asarray(p, dtype=np.float64)
        return out

    def collect(self, pending: PendingBatch) -> np.ndarray:
        return self._scatter(self._sum(
            [lane._host_rows(p) for lane, p in zip(self.lanes,
                                                   pending.out)]))

    def _on_shards(self, fn) -> list:
        """fn(lane) for every shard lane at once, each on its shard's
        thread of the instance's pool (the lanes must be the live ones)."""
        if not self.live:
            raise RuntimeError("work on the live arenas runs on the "
                               "instance's own site shards (slice 0)")
        return self.pool.run(lambda r: fn(self.lanes[r]))

    def _grad_batch(self, jobs: List[PreparedJob]):
        self._grad_plans(jobs)
        return self._on_shards(lambda lane: lane._grad_rows(jobs))[0]

    def _weights_rows(self, p, per_job_weights) -> np.ndarray:
        return self._scatter(self._sum(self._on_shards(
            lambda lane: lane._weights_host(p, per_job_weights))))


class MeshShard(BatchEvaluator):
    """The evaluator of an `SxT` fabric: each batch's J jobs cut into T
    slices of `ceil(J / T)` in queue order, one launch table each on its
    slice's lane (S = 1: a DeviceShard on the slice's card; S > 1: the
    SiteLanes of S shard lanes on the slice's cards, `mesh.devices[:,
    k]`), collected together.  The rows are the plain evaluator's (S =
    1) or the instance's `evaluate`'s (S > 1) bit for bit: each job's
    arithmetic is its own.  Slice 0 runs on the instance's own engines,
    slices k >= 1 on copies of their constants.  Ticks
    `fleet.mesh_batches` per batch and, per launched slice k,
    `fleet.mesh_slice_dispatches.t{k}` and `fleet.mesh_slice_jobs.t{k}`.
    The work anchored to the live arenas (weights batches, smoothing)
    runs on the instance's own device (S = 1: this evaluator is itself
    a lane there) or shards (slice 0's SiteLanes).  A lane that fails
    its init probe fails the fabric's: a fabric cannot run without one
    of its site shards or slices."""

    def __init__(self, inst, sharding=None, log=None):
        sh = sharding if sharding is not None else inst.sharding
        if sh is None or not sh.is_fabric:
            raise ValueError("MeshShard needs a fabric (parallel/sharding."
                             "py: make_fabric_mesh)")
        S, T = sh.site_shards, sh.tree_shards
        if S != inst.site_shards:
            raise ValueError(
                f"mesh {S}x{T} over an instance of {inst.site_shards} site "
                "shard(s): the fabric's site axis is the instance's")
        super().__init__(inst, log=log, shard=0 if S > 1 else None)
        self.mesh = sh.mesh
        self.site_shards = S
        self.tree_shards = T
        self.slices = []
        for k in range(T):
            try:
                self.slices.append(self._slice(inst, sh, k, log))
            except Exception as exc:
                raise RuntimeError(
                    f"mesh {S}x{T}: tree slice {k} failed at init "
                    f"({exc})") from exc
        obs.gauge("fleet.mesh_tree_shards", self.tree_shards)

    def _slice(self, inst, sh, k: int, log) -> BatchEvaluator:
        """Tree slice k's lane: a DeviceShard (S = 1), or the SiteLanes
        of its S shard lanes: slice 0 the instance's own shard engines
        (on their cards, which the mesh must name), slice k >= 1 a
        DeviceShard over shard s's engines on `mesh.devices[s, k]`."""
        devices = sh.slice_devices(k)
        if self.site_shards == 1:
            lane = DeviceShard(inst, devices[0], k, log=log)
            lane.seam = "fleet.mesh_arenas"
            return lane
        if k == 0:
            sl = SiteLanes(inst, log=log)
            for lane, dev in zip(sl.lanes, devices):
                if lane.device != _indexed(dev):
                    raise ValueError(
                        f"slice 0 names {dev} for site shard {lane.shard}, "
                        f"whose engines live on {lane.device}")
                _probe(lane.device)
        else:
            sl = SiteLanes(inst, [DeviceShard(inst, dev, k, log=log, shard=s)
                                  for s, dev in enumerate(devices)], k,
                           log=log)
        for lane in sl.lanes:
            lane.seam = "fleet.mesh_arenas"
        return sl

    def _grad_batch(self, jobs: List[PreparedJob]):
        if self.site_shards > 1:
            return self.slices[0]._grad_batch(jobs)
        return super()._grad_batch(jobs)

    def _weights_rows(self, p, per_job_weights) -> np.ndarray:
        if self.site_shards > 1:
            return self.slices[0]._weights_rows(p, per_job_weights)
        return super()._weights_rows(p, per_job_weights)

    def _cut(self, jobs: List[PreparedJob]) -> list:
        """(lane, its jobs) of each non-empty slice."""
        per = -(-len(jobs) // self.tree_shards)
        return [(lane, jobs[k * per:(k + 1) * per])
                for k, lane in enumerate(self.slices)
                if jobs[k * per:(k + 1) * per]]

    def admit(self, jobs: List[PreparedJob]) -> "SliceAdmissions":
        """Each slice's arenas admitted on its lanes' cards in turn, so a
        lane counts the arenas of the lanes before it on the same card."""
        return SliceAdmissions(lane.admit(part)
                               for lane, part in self._cut(jobs))

    def launch_eval(self, jobs: List[PreparedJob],
                    admission: Optional["SliceAdmissions"] = None
                    ) -> PendingBatch:
        assert jobs, "empty batch"
        cut = self._cut(jobs)
        subs = admission if admission is not None else [None] * len(cut)
        obs.inc("fleet.mesh_batches")
        pending = []
        try:
            for (lane, part), adm in zip(cut, subs):
                obs.inc(f"fleet.mesh_slice_dispatches.t{lane.index}")
                obs.inc(f"fleet.mesh_slice_jobs.t{lane.index}", len(part))
                pending.append(lane.launch_eval(part, adm))
        finally:
            if admission is not None:
                admission.release()
        return PendingBatch(jobs, pending, self)

    def collect(self, pending: PendingBatch) -> np.ndarray:
        return np.concatenate([p.ev.collect(p) for p in pending.out])


class SliceAdmissions(list):
    """A MeshShard batch's admissions, one per slice."""

    def release(self) -> None:
        for adm in self:
            adm.release()


class ShardSet:
    """The drivable set of evaluation lanes: the primary evaluator (the
    instance's own, on its device) plus one DeviceShard per further
    device that survives its init.

    `devices`: an explicit device list (Python only; it may name one card
    more than once, for lanes that share it), else the visible cards, the
    first `max_devices` of them when that is > 0.  The primary takes the
    first; a MeshShard primary already spans its fabric, and the set
    stays one lane."""

    def __init__(self, inst, primary: Optional[BatchEvaluator],
                 max_devices: int = 0, log=None, devices=None):
        log = log or (lambda *_: None)
        self.inst = inst
        self.shards: List[BatchEvaluator] = []
        if primary is None:
            # No batched tier (-S): jobs evaluate one at a time.
            obs.gauge("fleet.devices", 0)
            return
        self.shards.append(primary)
        if isinstance(primary, MeshShard):
            obs.gauge("fleet.devices", 1)
            log(f"fleet: {primary.site_shards}x{primary.tree_shards} "
                "likelihood fabric owns the device set; single mesh lane "
                "(no whole-device lanes cut)")
            return
        if devices is None:
            from examl_tpu_torch.parallel.sharding import visible_devices
            devices = (visible_devices() if primary.device.type == "cuda"
                       else [primary.device])
            if max_devices and max_devices > 0:
                devices = devices[:max_devices]
        shared = len({str(_indexed(d)) for d in devices}) < len(devices)
        for i, dev in enumerate(list(devices)[1:], start=1):
            try:
                self.shards.append(DeviceShard(inst, dev, i, log=log))
            except Exception as exc:  # noqa: BLE001 — a device's init
                # fault degrades the set; it never aborts the run.
                obs.inc("fleet.device_degraded")
                log(f"fleet: device {dev} degraded at init ({exc}); "
                    f"continuing with {len(self.shards)} lane(s)")
        obs.gauge("fleet.devices", len(self.shards))
        if len(self.shards) > 1:
            log(f"fleet: tree-axis sharding over {len(self.shards)} device "
                "lane(s): " + ", ".join(str(s.device) for s in self.shards)
                + (" (lanes share a card)" if shared else ""))

    def __len__(self) -> int:
        return len(self.shards)

    @property
    def primary(self) -> Optional[BatchEvaluator]:
        return self.shards[0] if self.shards else None

    def devices(self) -> list:
        """Every device a lane runs on (a MeshShard's slices and their site
        shards' lanes included)."""
        out = []
        for s in self.shards:
            for dev in lane_devices(s):
                if dev not in out:
                    out.append(dev)
        return out

    def shard_for(self, key, lane: int) -> BatchEvaluator:
        """The lane for a batch: the weights group (anchored to the live
        engine arenas) always on the primary, everything else
        round-robin."""
        if not self.shards:
            raise ValueError("no device lanes")
        if key == WEIGHTS_GROUP or (isinstance(key, tuple) and key
                                    and key[0] == "seq"):
            return self.shards[0]
        return self.shards[lane % len(self.shards)]


def lane_devices(ev) -> list:
    """The device of every lane an evaluator launches on: a MeshShard's
    slices, a SiteLanes' shard lanes, or the evaluator itself."""
    out = []
    for part in getattr(ev, "slices", [ev]):
        out += [lane.device for lane in getattr(part, "lanes", [part])]
    return out
