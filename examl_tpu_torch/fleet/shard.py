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
* `MeshShard` — the `1xT` fabric (parallel/sharding.py): one evaluator
  whose batches are cut into T slices of `ceil(J / T)` jobs in queue
  order, each launched as its own table on its slice's device and
  stream (a `DeviceShard` per slice), and collected together.  J real
  jobs, no padding: kernel B1 compiles nothing per batch size.
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

FAULT DOMAIN: a lane whose INIT raises is dropped from the set
(`fleet.device_degraded`, an operator log line), never an abort.  A
CUDA or kernel error AFTER init is no job's and no lane's to absorb: as
on one lane, `_build.KernelError` and CUDA runtime errors end the run
(fleet/quarantine.py: `device_fault`).
"""

from __future__ import annotations

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


class DeviceShard(BatchEvaluator):
    """A BatchEvaluator whose launches run on one specific device."""

    def __init__(self, inst, device, index: int, log=None):
        super().__init__(inst, log=log)
        self.device = _indexed(device)
        self.index = int(index)
        self._consts = {
            eng.K: {name: _to(getattr(eng, name), self.device)
                    for name in _CONST_NAMES} for eng in self.engines}
        # A lane that cannot even add two numbers must degrade at INIT,
        # not fail its first real batch.
        probe = torch.ones((), dtype=torch.float32, device=self.device)
        if float(probe + 1.0) != 2.0:
            raise RuntimeError(f"device {self.device} failed its probe")

    def _const(self, eng, name: str):
        return self._consts[eng.K][name]


class MeshShard(BatchEvaluator):
    """The evaluator of a `1xT` fabric: each batch's J jobs cut into T
    slices of `ceil(J / T)` in queue order, one launch table each on its
    slice's lane, collected together.  The rows are the plain
    BatchEvaluator's bit for bit (each job's arithmetic is its own).
    Ticks `fleet.mesh_batches` per batch and, per launched slice k,
    `fleet.mesh_slice_dispatches.t{k}` and `fleet.mesh_slice_jobs.t{k}`.
    Itself a lane on the instance's device for the work anchored to the
    live arenas (weights batches, smoothing)."""

    def __init__(self, inst, sharding=None, log=None):
        super().__init__(inst, log=log)
        sh = sharding if sharding is not None else inst.sharding
        if sh is None or not sh.is_fabric:
            raise ValueError("MeshShard needs a fabric (parallel/sharding."
                             "py: make_fabric_mesh)")
        if sh.site_shards != 1:
            raise ValueError(
                f"mesh {sh.site_shards}x{sh.tree_shards}: a fleet over site "
                "shards (S > 1) is not ported (ROADMAP A15c)")
        self.mesh = sh.mesh
        self.site_shards = sh.site_shards
        self.tree_shards = sh.tree_shards
        self.slices = []
        for k, dev in enumerate(sh.tree_devices()):
            lane = DeviceShard(inst, dev, k, log=log)
            lane.seam = "fleet.mesh_arenas"
            self.slices.append(lane)
        obs.gauge("fleet.mesh_tree_shards", self.tree_shards)

    def _cut(self, jobs: List[PreparedJob]) -> list:
        """(lane, its jobs) of each non-empty slice."""
        per = -(-len(jobs) // self.tree_shards)
        return [(lane, jobs[k * per:(k + 1) * per])
                for k, lane in enumerate(self.slices)
                if jobs[k * per:(k + 1) * per]]

    def admit(self, jobs: List[PreparedJob]) -> "SliceAdmissions":
        """Each slice's arena admitted on its lane's device in turn, so a
        slice counts the arenas of the slices before it on the same card."""
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
        """Every device a lane runs on (a MeshShard's slices included)."""
        out = []
        for s in self.shards:
            for lane in getattr(s, "slices", [s]):
                if lane.device not in out:
                    out.append(lane.device)
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

