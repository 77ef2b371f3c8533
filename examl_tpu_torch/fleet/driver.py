"""The fleet job-queue driver: grouped batched dispatch over device lanes.

The port of the single-process `examl_tpu/fleet/driver.py`.  Pending
jobs group by their batch key — one key for every chunk-tier tree job
(`batch.FAST_GROUP`: kernel B1 runs any mix of topologies in one
table), the wave-scan shape under PSR, or the shared-topology weights
group for bootstrap replicates — and the largest group dispatches
first, at most `batch_cap` jobs a batch.

The whole job table is checkpointed through CheckpointManager after
every batch (state "FLEET", the JAX package's format), and a `-R`
restart skips finished jobs: a kill loses at most each in-flight job's
current cycle.

FAILURE DOMAINS are job-level (fleet/quarantine.py): a raise inside a
batched dispatch bisects to the guilty job(s), a non-finite row fails
only its own job, each failure burns one of the job's capped attempts
(jittered backoff between retries), and a job past its cap lands in
the dead-letter file — healthy cohabitants keep results bit-identical
to a clean run.  A fault of a kernel or of the card is no job's: it
ends the run.  Finished results also append to the fsync'd per-run
journal, so a kill loses compute, never a finished result.

LEASED RANKS (fleet/lease.py): with a lease board, every rank of a
leased fleet runs its own driver over the same queue.  A rank dispatches
only the jobs it holds a lease on (it claims free ones, at most two
batches ahead), absorbs the results its peers journaled (a job finished
by any rank finishes everywhere, with no second `job.done`), reaps the
expired leases of a dead rank after a jittered backoff, and fences every
completion (`still_mine`) so a lease reaped under a slow holder never
counts a job twice.

THE PER-JOB DEADLINE: with `--fleet-job-deadline S`, the beat before a
batch declares its jobs and a wall-clock deadline S ahead; a supervisor
that sees the deadline pass kills the process as `fleet-job-stuck` and
exports each stuck job's hang attempts to the retry
(`apply_hang_attempts`): a job at its cap is quarantined, the others
re-dispatch one at a time, so the job that hangs is the one that pays.

Instrumented as the JAX driver is: `fleet.*` counters and gauges, the
`job.start` / `job.done` / `job.failed` / `job.quarantined` /
`batch.dispatch` ledger events, one heartbeat per batch (the fleet's
iteration clock), and the fault seams `fleet.dispatch`,
`fleet.job.hang`, `mem.oom` and `fleet.job.poison`.  Under memory
pressure the batch's stacked arena is cut into smaller parts
(fleet/batch.py, `memgov.effective_cap`), and an allocator OOM in a
batch goes through `is_oom` -> `oom_event` -> `evict_engine` -> the
halving re-dispatch -> `oom_recovered`.

DEVICE LANES (fleet/shard.py): with `devices` other than 1 the driver
holds a ShardSet, the primary evaluator plus one DeviceShard per further
card, and each drain round cuts up to one batch per lane, largest group
first, under `memgov.effective_cap`.  A round admits every lane's arena
first (`admit`: reserved on its card), launches every lane (each on its
own stream, no host sync), then collects each and runs it through the
job-level fault ladder (`_isolate_launched`: the launched outcome stands
in for the ladder's first dispatch).  On an `SxT` fabric the instance's
evaluator is a MeshShard, one lane whose batches span the T tree slices
and each slice's S site shards; over site shards (S > 1) whole-card
lanes are refused.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet import bootstrap as _bootstrap
from examl_tpu_torch.fleet import lease as _lease
from examl_tpu_torch.fleet import quarantine
from examl_tpu_torch.fleet.batch import WEIGHTS_GROUP, batch_eligible
from examl_tpu_torch.fleet.jobs import JobSpec
from examl_tpu_torch.fleet.shard import lane_devices
from examl_tpu_torch.obs import programs as _programs
from examl_tpu_torch.resilience import faults, heartbeat, memgov, preempt


class FleetDriver:
    def __init__(self, inst, start_tree=None, batch_cap: int = 16,
                 cycles: int = 1, mgr=None, log=None,
                 policy: Optional[quarantine.JobFaultPolicy] = None,
                 journal: Optional[quarantine.ResultsJournal] = None,
                 deadletters: Optional[quarantine.DeadLetters] = None,
                 leases: Optional[_lease.LeaseBoard] = None,
                 peer_journals: Optional[Callable[[], list]] = None,
                 devices=1):
        """devices: the fleet's lanes: 1 (one lane, the instance's
        evaluator), 0 (a lane per visible card), N (the first N cards), or
        from Python an explicit device list, which may name one card more
        than once (lanes that share it).  Over an instance of site shards
        (`--mesh SxT`, S > 1) the fleet's lanes are the fabric's (its
        evaluator's site lanes and tree slices), and whole-card lanes are
        refused: such a lane needs the whole tree's constants on one
        card, and the shards hold windows of them."""
        if getattr(inst, "site_shards", 1) > 1 and \
                (not isinstance(devices, int) or devices != 1):
            raise ValueError(
                f"whole-card fleet lanes over an instance of "
                f"{inst.site_shards} site shards: a whole-card lane needs "
                "the whole tree's constants on one card, and the shards "
                "hold windows of them; the fabric's tree slices are the "
                "fleet's lanes (--mesh SxT)")
        self.inst = inst
        self.start_tree = start_tree          # bootstrap topology (+ ckpt
        self.batch_cap = max(1, int(batch_cap))   # scaffold)
        self.cycles = max(1, int(cycles))
        self.mgr = mgr
        self.log = log or (lambda *_: None)
        self.policy = policy or quarantine.JobFaultPolicy()
        self.journal = journal
        self.deadletters = deadletters
        # A leased rank's board, and the reader of every rank's journal.
        self.leases = leases
        self.peer_journals = peer_journals
        self._reap_after: Dict[str, float] = {}
        self._reap_tries: Dict[str, int] = {}
        self._last_absorb = 0.0
        reason = batch_eligible(inst)
        self.evaluator = inst.batch_evaluator()
        if self.evaluator is not None:
            self.evaluator.log = self.log
        else:
            self.log(f"fleet: batched tier unavailable ({reason}); "
                     "jobs evaluate one at a time")
        # The tree axis over devices: one lane per surviving device, or
        # the single lane of the plain evaluator.
        from examl_tpu_torch.fleet.shard import MeshShard, ShardSet
        explicit = not isinstance(devices, int)
        if self.evaluator is not None and (explicit or devices != 1):
            self.shards = ShardSet(
                inst, self.evaluator, log=self.log,
                max_devices=0 if explicit else devices,
                devices=list(devices) if explicit else None)
        else:
            self.shards = None
        if isinstance(self.evaluator, MeshShard):
            shape = (f"{self.evaluator.site_shards}x"
                     f"{self.evaluator.tree_shards}")
            self.log(f"fleet: batches dispatch on the {shape} likelihood "
                     "fabric (each batch's jobs cut over its tree slices: "
                     + ", ".join(
                         f"t{k} " + "+".join(str(d) for d in lane_devices(s))
                         for k, s in enumerate(self.evaluator.slices))
                     + ")")
            if self.leases is not None:
                self.leases.mesh = shape
        self.jobs: List[JobSpec] = []
        self._trees: Dict[str, object] = {}       # job_id -> Tree
        self._prepared: Dict[str, object] = {}    # job_id -> PreparedJob
        self._weights: Dict[str, list] = {}       # job_id -> per-part w
        self._keys: Dict[str, object] = {}        # job_id -> batch key
        self._not_before: Dict[str, float] = {}   # job_id -> retry time
        self._smoothed: Dict[str, int] = {}       # job_id -> cycle whose
                                                  # smoothing already ran
        self._started: set = set()                # job ids with job.start
        self._solo: set = set()                   # deadline suspects:
                                                  # dispatched one at a time

    def _evict(self, job: JobSpec) -> None:
        """Drop a finished job's host-side state: a long-running
        `--serve` process must not keep every completed job's tree,
        launch table and weight arrays alive."""
        for cache in (self._trees, self._prepared, self._weights,
                      self._keys, self._not_before, self._smoothed):
            cache.pop(job.job_id, None)
        self._solo.discard(job.job_id)

    # -- job-table persistence (rides CheckpointManager) --------------------

    def extras(self) -> dict:
        return {"fleet": {"jobs": [j.to_dict() for j in self.jobs],
                          "cycles": self.cycles}}

    def restore_jobs(self, extras: dict, jobs=None) -> int:
        """Merge a restored job table into `jobs` (default: the whole
        queue), matched by job_id: finished jobs stay finished, in-flight
        jobs keep their completed cycles and their current tree.  Returns
        the number of jobs restored as done.

        The serve loop passes each poll's FRESH specs only, so the
        snapshot applies to every job exactly once — at the moment it
        joins the queue."""
        blob = (extras or {}).get("fleet") or {}
        by_id = {d.get("job_id"): d for d in blob.get("jobs", [])}
        done = 0
        for job in (self.jobs if jobs is None else jobs):
            d = by_id.get(job.job_id)
            if d is None:
                continue
            rj = JobSpec.from_dict(d)
            job.cycles_done = rj.cycles_done
            job.lnl = rj.lnl
            job.done = rj.done
            job.failed = rj.failed
            # The retry ladder resumes where it was: a restart never
            # hands a poison job a fresh attempt budget.
            job.attempts = max(job.attempts, rj.attempts)
            job.cause = rj.cause or job.cause
            job.last_error = rj.last_error or job.last_error
            if rj.newick:
                job.newick = rj.newick
            done += int(job.done)
        return done

    def apply_hang_attempts(self, jobs: Optional[List[JobSpec]] = None
                            ) -> None:
        """Fold the supervisor's EXAML_FLEET_HANG_ATTEMPTS export into the
        job table: a job the supervisor killed for blowing its batch's
        deadline carries those attempts here, and one at or past the
        policy cap is quarantined BEFORE it can hang the resumed fleet
        again."""
        counts = quarantine.parse_hang_attempts(
            os.environ.get(quarantine.ENV_HANG_ATTEMPTS))
        if not counts:
            return
        for job in (self.jobs if jobs is None else jobs):
            n = counts.get(job.job_id)
            if not n or job.done:
                continue
            job.attempts = max(job.attempts, n)
            if job.attempts >= self.policy.max_attempts:
                self._quarantine(
                    job, quarantine.CAUSE_HANG,
                    f"exceeded the per-job deadline in {job.attempts} "
                    "attempt(s) (supervisor hang-attempt record)")
            else:
                # A deadline kill names the whole stuck batch (nobody can
                # see inside a hung dispatch), so the suspects
                # re-dispatch ONE AT A TIME: an innocent cohabitant
                # completes alone, the job that hangs hangs alone and is
                # quarantined at the cap.
                self._solo.add(job.job_id)
                self.log(f"fleet: job {job.job_id} is a deadline suspect "
                         f"(attempt {job.attempts}); re-dispatching it "
                         "alone")

    # -- job materialization -------------------------------------------------

    def _tree_for(self, job: JobSpec):
        t = self._trees.get(job.job_id)
        if t is not None:
            return t
        if job.kind == "bootstrap":
            if self.start_tree is None:
                raise ValueError("bootstrap jobs need a starting tree (-t)")
            t = self.start_tree
        elif job.newick:                       # eval job / resumed start job
            t = self.inst.tree_from_newick(job.newick)
        else:                                  # multi-start: derived seed
            t = self.inst.random_tree(seed=job.seed)
        self._trees[job.job_id] = t
        return t

    def _key_for(self, job: JobSpec):
        if job.kind == "bootstrap":
            self._tree_for(job)                # raises without a -t tree
            return WEIGHTS_GROUP
        if self.evaluator is None:
            return ("seq", job.job_id)         # no grouping: one per batch
        prep = self.evaluator.prepare(self._tree_for(job),
                                      self._prepared.get(job.job_id))
        self._prepared[job.job_id] = prep
        return prep.key

    def _weights_for(self, job: JobSpec) -> list:
        w = self._weights.get(job.job_id)
        if w is None:
            w = _bootstrap.bootstrap_weights(self.inst.alignment, job.seed)
            self._weights[job.job_id] = w
        return w

    # -- the job-level failure ladder ---------------------------------------

    def _journal_job(self, job: JobSpec) -> None:
        if self.journal is not None:
            self.journal.append(quarantine.job_record(job))

    def _quarantine(self, job: JobSpec, cause: str, error: str) -> None:
        """Terminal failure: the job leaves the queue for the dead
        letters — with cause, attempts and last error — and never costs
        another dispatch."""
        error = (error or "")[:200]
        job.done = job.failed = True
        job.cause = cause
        job.last_error = error
        self._evict(job)
        obs.inc("fleet.quarantined")
        obs.inc("fleet.jobs_failed")
        obs.ledger_event("job.quarantined", job=job.job_id, cause=cause,
                         attempts=job.attempts, error=error)
        if self.deadletters is not None:
            self.deadletters.append(job, cause, error)
        self._journal_job(job)
        if self.leases is not None:
            self.leases.release(job.job_id)
        self.log(f"fleet: job {job.job_id} QUARANTINED ({cause} after "
                 f"{job.attempts} attempt(s): {error})")

    def _fail(self, job: JobSpec, cause: str, error) -> None:
        """One failed attempt: burn it, then retry with jittered
        backoff or quarantine at the cap."""
        err = str(error)[:200]
        job.attempts += 1
        job.cause = cause
        job.last_error = err
        obs.ledger_event("job.failed", job=job.job_id, cause=cause,
                         attempt=job.attempts, error=err)
        if job.attempts >= self.policy.max_attempts:
            self._quarantine(job, cause, err)
            return
        obs.inc("fleet.job_retries")
        delay = self.policy.backoff(job.job_id, job.attempts)
        self._not_before[job.job_id] = time.time() + delay
        self.log(f"fleet: job {job.job_id} attempt {job.attempts} "
                 f"failed ({cause}: {err}); retrying in {delay:.2f}s")

    # -- the queue loop ------------------------------------------------------

    def run(self, jobs: List[JobSpec],
            resume_extras: Optional[dict] = None) -> List[JobSpec]:
        self.jobs = list(jobs)
        if resume_extras:
            restored = self.restore_jobs(resume_extras)
            self.log(f"fleet: resumed job table — {restored} of "
                     f"{len(self.jobs)} jobs already done")
        self.apply_hang_attempts()
        obs.gauge("fleet.jobs_total", len(self.jobs))
        self.drain()
        return self.jobs

    def pending(self) -> List[JobSpec]:
        return [j for j in self.jobs if not j.done]

    def drain(self) -> None:
        """Run batches until no job is pending: group the ready jobs by
        batch key and dispatch the largest group first (at most
        `batch_cap` of its jobs).  A job that cannot even materialize (a
        malformed eval newick, a bootstrap job without a -t tree) is
        quarantined alone: retrying the same host-side parse cannot
        succeed."""
        while True:
            if self.leases is not None:
                # A leased rank first absorbs its peers' journaled
                # results and renews the leases it holds.
                self._absorb_remote()
                self._renew_leases()
            pending = self.pending()
            obs.gauge("fleet.queue_depth", len(pending))
            # "done" means SUCCEEDED: failed jobs leave the queue but
            # must not read as successes.
            obs.gauge("fleet.jobs_done",
                      sum(1 for j in self.jobs if j.done and not j.failed))
            if not pending:
                break
            # Retry backoff: a job whose jittered delay has not expired
            # is pending but not ready; with nothing ready, sleep toward
            # the earliest retry.
            now = time.time()
            ready = [j for j in pending
                     if self._not_before.get(j.job_id, 0.0) <= now]
            if self.leases is not None:
                ready = self._lease_ready(ready, now)
            if not ready:
                wake = min(self._not_before.get(j.job_id, now)
                           for j in pending)
                heartbeat.phase_beat("FLEET")
                floor = 0.25 if self.leases is not None else 0.01
                time.sleep(min(max(wake - now, floor), 1.0))
                continue
            groups: Dict[object, List[JobSpec]] = {}
            for job in ready:
                key = self._keys.get(job.job_id)
                if key is None:
                    try:
                        key = self._key_for(job)
                    except Exception as exc:   # noqa: BLE001
                        if quarantine.device_fault(exc):
                            raise
                        job.attempts += 1
                        self._quarantine(job, quarantine.CAUSE_ERROR,
                                         f"failed to materialize: {exc}")
                        continue
                    self._keys[job.job_id] = key
                if job.job_id in self._solo:
                    key = ("solo", job.job_id)
                groups.setdefault(key, []).append(job)
            if not groups:
                continue                       # everything failed: re-check
            # Up to one batch per lane, largest group first (a deep group
            # splits over the lanes: the jobs are independent), round-robin
            # over the lanes, at most the governor's cap each over several
            # lanes (under memory pressure the batches shrink instead of
            # running out of memory; one lane's batch is cut into parts
            # under it, `BatchEvaluator._parts`).
            nlanes = self._lanes()
            cap = memgov.effective_cap(self.batch_cap) if nlanes > 1 \
                else self.batch_cap
            batches: List = []
            for key, members in sorted(groups.items(), key=lambda kv: (
                    -len(kv[1]), str(kv[0]))):
                for i in range(0, len(members), cap):
                    batches.append((key, members[i:i + cap]))
                    if len(batches) >= nlanes:
                        break
                if len(batches) >= nlanes:
                    break
            if len(batches) == 1:
                self._dispatch(batches[0][1])
            else:
                self._dispatch_round([
                    (self.shards.shard_for(key, lane), batch)
                    for lane, (key, batch) in enumerate(batches)])
            # Clear the in-flight declaration of the heartbeat.
            heartbeat.phase_beat("FLEET", payload={"fleet": None})
            if self.mgr is not None:
                self._checkpoint()
                # The checkpoint just written is coherent: a pending
                # SIGTERM/SIGINT exits resumable here.
                preempt.check_after_checkpoint(log=self.log)
            elif self.leases is not None:
                # A leased rank checkpoints nothing (its fsynced journal
                # is the record, and its peers are not in lockstep), but
                # everything it finished is journaled: a pending
                # preemption exits resumable here too.
                preempt.check_after_checkpoint(log=self.log)

    def _checkpoint(self) -> None:
        tree = self.start_tree
        if tree is None:
            live = next((self._trees[j.job_id] for j in self.jobs
                         if j.job_id in self._trees), None)
            tree = live if live is not None \
                else self.inst.random_tree(seed=0)
        self.mgr.write("FLEET", self.extras(), self.inst, tree)

    # -- lease bookkeeping (the rank-level fault domain) --------------------

    def _absorb_remote(self) -> None:
        """Fold the peers' journaled results into the job table: a job
        any rank finished (done OR quarantined) finishes here too,
        WITHOUT a second `job.done` (the finishing rank emitted it).  An
        absorbed job is no longer pending, so its stale lease is scrubbed
        instead of reaped and re-dispatched."""
        if self.peer_journals is None:
            return
        now = time.time()
        if now - self._last_absorb < 0.5:
            return
        self._last_absorb = now
        try:
            recs = self.peer_journals()
        except OSError:
            return
        by_id = {r.get("job_id"): r for r in recs if r.get("done")}
        for job in self.jobs:
            if job.done:
                continue
            rec = by_id.get(job.job_id)
            if rec is None:
                continue
            rj = JobSpec.from_dict({k: v for k, v in rec.items()
                                    if k != "t"})
            job.cycles_done = rj.cycles_done
            job.lnl = rj.lnl
            job.done = True
            job.failed = rj.failed
            job.attempts = max(job.attempts, rj.attempts)
            job.cause = rj.cause
            job.last_error = rj.last_error
            if rj.newick:
                job.newick = rj.newick
            obs.inc("fleet.jobs_absorbed")
            self._evict(job)
            self._reap_after.pop(job.job_id, None)
            if self.leases is not None:
                self.leases.scrub(job.job_id)

    def _renew_leases(self) -> None:
        for jid in self.leases.held():
            self.leases.renew(jid)

    def _lease_ready(self, ready: List[JobSpec],
                     now: float) -> List[JobSpec]:
        """The leased view of the ready set: only jobs THIS rank holds a
        lease on may dispatch.  Free jobs are claimed (at most two
        batches' worth, so one rank never hogs the queue), live foreign
        leases wait, and expired ones (a dead rank's in-flight jobs) are
        reaped after a jittered backoff, so the surviving ranks never
        stampede the steal."""
        out: List[JobSpec] = []
        cap = 2 * self._lanes() * self.batch_cap
        held = set(self.leases.held())
        nheld = len(held)
        claimed = False
        for job in ready:
            jid = job.job_id
            if jid in held:
                out.append(job)
                continue
            if nheld >= cap:
                continue
            state = self.leases.expired(jid)
            if state is None:                      # free: claim it
                if self.leases.acquire(jid):
                    out.append(job)
                    claimed = True
                    nheld += 1
                continue
            if state is False:
                if self.leases.stale_own(jid):
                    # A dead predecessor in THIS rank slot held it: the
                    # restarted rank reclaims its own lost jobs now
                    # instead of idling out the ttl.
                    if self.leases.reap(jid, own=True):
                        self.log(f"fleet: reclaimed own stale lease for "
                                 f"{jid} (restarted rank)")
                        out.append(job)
                        claimed = True
                        nheld += 1
                continue                           # live foreign lease
            due = self._reap_after.get(jid)
            if due is None:
                att = self._reap_tries.get(jid, 0) + 1
                self._reap_tries[jid] = att
                self._reap_after[jid] = now + _lease.reap_backoff(
                    jid, self.leases.rank, att)
                continue
            if now < due:
                continue
            self._reap_after.pop(jid, None)
            if self.leases.reap(jid):
                self.log(f"fleet: reaped expired lease for {jid} (its "
                         "rank died or stalled); re-dispatching")
                out.append(job)
                claimed = True
                nheld += 1
        if claimed:
            # A finishing rank journals BEFORE it releases, so a job just
            # claimed has its result visible now if it ever finished:
            # re-read the journals (past the rate limit) and drop the
            # claimed jobs that are done before one dispatch happens.
            self._last_absorb = 0.0
            self._absorb_remote()
            out = [j for j in out if not j.done]
        return out

    def _fenced(self, job: JobSpec) -> bool:
        """True when a leased job's completion must be DISCARDED: its
        lease expired under this rank and another rank reaped it during
        the dispatch.  The reaper owns the job now."""
        if self.leases is None or self.leases.still_mine(job.job_id):
            return False
        obs.inc("fleet.leases_lost")
        self.log(f"fleet: lease for {job.job_id} was reaped during the "
                 "dispatch; discarding this result (the reaper owns the "
                 "job)")
        return True

    # -- batch dispatch ------------------------------------------------------

    def _lanes(self) -> int:
        return len(self.shards) if self.shards is not None else 1

    def _dispatch(self, batch: List[JobSpec]) -> None:
        """One batch: a round of one lane."""
        shard = (self.shards.shard_for(self._keys.get(batch[0].job_id), 0)
                 if self.shards is not None else self.evaluator)
        self._dispatch_round([(shard, batch)])

    def _dispatch_round(self, assignments: List) -> None:
        """One drain round of (lane, batch) pairs: ADMIT every lane's
        stacked arena (its card's free memory read before any lane of the
        round allocates, each reservation counted by the next), LAUNCH
        every lane (no host sync: lanes on distinct cards run at once),
        then collect each batch and run it through the job-level fault
        ladder.  A failed launch or collect takes the same quarantine
        bisection as a synchronous raise; a device fault ends the run."""
        for _, batch in assignments:
            for job in batch:
                if job.job_id not in self._started:
                    self._started.add(job.job_id)
                    obs.ledger_event("job.start", job=job.job_id,
                                     job_kind=job.kind, index=job.index,
                                     seed=job.seed, cycle=job.cycles_done)
        compiles0 = obs.counter("engine.compile_count")
        bisects0 = obs.counter("fleet.bisect_dispatches")
        t0 = time.perf_counter()

        def declare(batch):
            """The in-flight declaration is per BATCH, also in a round of
            several lanes: the launch and collect loops are sequential
            host code, so declaring the batch the host is about to block
            on keeps a deadline kill on that batch's jobs alone."""
            fl = {"jobs": [j.job_id for j in batch]}
            if self.policy.deadline_s > 0:
                fl["deadline"] = time.time() + self.policy.deadline_s
            return {"fleet": fl}

        admissions = [self._admit(shard, batch)
                      for shard, batch in assignments]
        launches = []
        try:
            for (shard, batch), adm in zip(assignments, admissions):
                lane = getattr(shard, "index", 0)
                obs.ledger_event("batch.dispatch", jobs=len(batch),
                                 job_kind=batch[0].kind, lane=lane,
                                 ids=",".join(j.job_id for j in batch[:8]))
                obs.inc(f"fleet.device_dispatches.d{lane}")
                obs.inc(f"fleet.device_jobs.d{lane}", len(batch))
                # The heartbeat is the fleet's iteration clock (search.kill
                # addresses "the Nth batch"): one beat per batch.
                heartbeat.beat("FLEET", payload=declare(batch))
                try:
                    launches.append(self._launch_batch(batch, shard, adm))
                except Exception as exc:  # noqa: BLE001 — attributed
                    launches.append(exc)  # through the bisection below
        finally:
            for adm in admissions:
                if adm is not None:
                    adm.release()
        njobs = 0
        for (shard, batch), launched in zip(assignments, launches):
            if len(assignments) > 1:
                # Narrow the declaration to the batch this collect blocks
                # on (a re-publish, not an iteration).
                heartbeat.phase_beat("FLEET", payload=declare(batch))
            with obs.span("fleet:dispatch", args={"jobs": len(batch)}):
                results = self._isolate_launched(batch, launched, shard)
            njobs += len(batch)
            obs.inc("fleet.batches")
            obs.inc("fleet.trees_evaluated", len(batch))
            self._apply_results(batch, results)
        dt = time.perf_counter() - t0
        obs.inc("fleet.eval_seconds", dt)
        # Throughput from warm, clean rounds only: a round whose wall held
        # an extension build or a bisection is no serving rate.
        if dt > 0 and obs.counter("fleet.bisect_dispatches") == bisects0 \
                and obs.counter("engine.compile_count") == compiles0:
            obs.gauge("fleet.trees_per_sec", round(njobs / dt, 3))
        # Memory telemetry over every lane's device, once a round.
        lanes = (self.shards.devices() if self.shards is not None else
                 [d for s in getattr(self.evaluator, "slices", ())
                  for d in lane_devices(s)])
        _programs.sample_memory(devices=lanes or None)

    def _admit(self, shard, batch: List[JobSpec]):
        """The lane's admission of a tree batch's arenas (None for
        bootstrap batches and for jobs one at a time)."""
        if shard is None or batch[0].kind == "bootstrap":
            return None
        return shard.admit([self._prepared[j.job_id] for j in batch])

    def _isolate_launched(self, batch: List[JobSpec], launched,
                          shard) -> List:
        """Resolve one launched batch through the quarantine ladder without
        re-running the clean path: the already-launched outcome (its
        collected rows, or the exception its launch or collect raised)
        stands in for the ladder's first dispatch
        (`quarantine.isolate_launched`), so the fault-hit counters tick
        as in the one-dispatch flow.  An allocator OOM of the whole batch
        is a memory-governor event: counted, the engines' caches evicted
        (and the caching allocator's blocks handed back), then the halving
        re-dispatch retries at a smaller shape."""
        if isinstance(launched, Exception):
            outcome = launched
        else:
            try:
                outcome = self._finish_batch(batch, launched)
            except Exception as exc:      # noqa: BLE001 — attributed below
                outcome = exc
        oomed = isinstance(outcome, Exception) and memgov.is_oom(outcome)
        if oomed:
            # Past the strike limit this raises MemoryBudgetExhausted,
            # which ends the run.
            memgov.oom_event(outcome, seam="fleet.dispatch")
            for eng in self.inst.engines.values():
                for shard in eng.shards:
                    memgov.evict_engine(shard)

        def evaluate(b, nested):
            try:
                return self._evaluate_batch(b, shard)
            except torch.cuda.OutOfMemoryError:
                # The halves need less memory: hand the cached blocks
                # back first.
                torch.cuda.empty_cache()
                raise

        results = quarantine.isolate_launched(batch, outcome, evaluate,
                                              self._evaluate_leaf)
        if oomed:
            memgov.oom_recovered()
        return results

    def _apply_results(self, batch: List[JobSpec], results: List) -> None:
        for job, row, err in results:
            if self._fenced(job):
                # The reaper owns this job: no attempt burned, no result
                # recorded; it completes once, on the reaper's rank, and
                # comes back here through the journals.
                continue
            if err is not None:
                cause = (quarantine.CAUSE_POISON
                         if isinstance(err, FloatingPointError)
                         else quarantine.CAUSE_ERROR)
                self._fail(job, cause, err)
                continue
            lnl = float(row.sum())
            if not np.isfinite(lnl):
                self._fail(job, quarantine.CAUSE_POISON, "non-finite lnL")
                continue
            job.lnl = lnl
            # A retried job that now succeeded is healthy: stale
            # cause/last_error of the failed attempt must not leak into
            # a "done" row (attempts stays — it IS the retry evidence).
            job.cause = None
            job.last_error = None
            job.cycles_done += 1
            obs.inc("fleet.cycles")
            if job.kind != "bootstrap":
                tree = self._trees.get(job.job_id)
                if tree is not None:
                    job.newick = tree.to_newick(
                        self.inst.alignment.taxon_names)
            if job.cycles_done >= job.cycles:
                job.done = True
                obs.inc("fleet.jobs_done_total")
                obs.ledger_event("job.done", job=job.job_id,
                                 job_kind=job.kind, lnl=round(lnl, 6),
                                 cycles=job.cycles_done)
                # Durable result BEFORE eviction: the journal record is
                # what a resume reconciles against the (older, per-batch)
                # checkpoint.
                self._journal_job(job)
                if self.leases is not None:
                    # Journal first, THEN release: a kill between the two
                    # leaves an expired lease whose reap finds the job in
                    # the journal, absorbed, never re-run.
                    self.leases.release(job.job_id)
                self._evict(job)

    # -- the evaluation seams (bisectable) -----------------------------------

    def _evaluate_batch(self, batch: List[JobSpec],
                        shard=None) -> np.ndarray:
        """One batch's per-job per-partition lnL [J, M], launched and
        collected at once (the bisection's re-dispatches)."""
        return self._finish_batch(batch, self._launch_batch(batch, shard))

    def _launch_batch(self, batch: List[JobSpec], shard=None,
                      admission=None):
        """Enqueue one batch on a lane.  The fleet's fault seams live here:
        `fleet.dispatch` before it, and per job `fleet.job.hang` and a
        synthetic OOM (`mem.oom`).  Returns a PendingBatch (collected in
        `_finish_batch`) or the host rows of the synchronous paths
        (bootstrap weights, jobs one at a time)."""
        faults.fire("fleet.dispatch")
        for job in batch:
            # A real sleep, not beat suppression: the deadline declared
            # just before the dispatch goes stale as in a genuine hang.
            faults.fire("fleet.job.hang", job=job.job_id)
            faults.fire("mem.oom", job=job.job_id)
        if batch[0].kind == "bootstrap":
            return self._dispatch_bootstrap(batch)
        return self._dispatch_trees(batch, shard, admission)

    def _finish_batch(self, batch: List[JobSpec], launched) -> np.ndarray:
        """Collect one launched batch (the lane's blocking read-back), then
        the per-job poison seam (`fleet.job.poison`)."""
        from examl_tpu_torch.fleet.batch import PendingBatch
        if isinstance(launched, PendingBatch):
            launched = launched.ev.collect(launched)
        per_part = np.array(launched, dtype=np.float64)
        for i, job in enumerate(batch):
            if faults.fire("fleet.job.poison", job=job.job_id):
                per_part[i] = np.nan
        return per_part

    def _evaluate_leaf(self, job: JobSpec) -> np.ndarray:
        """Bisection leaf: ONE job through the one-at-a-time path the
        batched tier is held against (its smoothing by `smooth_tree`), so
        a healthy job isolated out of a poisoned batch scores as in a
        clean run."""
        if job.kind == "bootstrap":
            row = self._sequential_weights(
                self._tree_for(job), [self._weights_for(job)])[0]
        else:
            self._smooth_if_due([job], batched=False)
            row = self._sequential_eval(self._tree_for(job))
        row = np.array(row, dtype=np.float64)
        if faults.fire("fleet.job.poison", job=job.job_id):
            row[:] = np.nan
        return row

    def _dispatch_bootstrap(self, batch: List[JobSpec]) -> np.ndarray:
        tree = self._tree_for(batch[0])
        weights = [self._weights_for(j) for j in batch]
        if self.evaluator is not None:
            return self.evaluator.eval_weights_batch(tree, weights)
        return self._sequential_weights(tree, weights)

    def _smooth_if_due(self, batch: List[JobSpec],
                       batched: bool = True) -> None:
        """Branch-length smoothing for jobs entering a later cycle — AT
        MOST ONCE per (job, cycle): smoothing mutates the tree's z, so a
        bisection re-dispatch or a retry running it again would
        double-smooth.  Batches smooth together (`smooth_batch`, the
        gradient route on the chunk tier); a raise there goes down the
        job-level ladder like any other.  A job alone (a bisection leaf),
        or an instance on the per-branch route or without the chunk
        tier, smooths through `smooth_tree`."""
        later = [j for j in batch if j.cycles_done > 0
                 and self._smoothed.get(j.job_id) != j.cycles_done]
        if not later:
            return
        from examl_tpu_torch.constants import SMOOTHINGS
        from examl_tpu_torch.optimize.branch import (grad_smooth_ineligible,
                                                     smooth_tree)
        remaining = list(later)
        if (batched and self.inst.grad_smooth
                and self.evaluator is not None and self.evaluator.fast
                and grad_smooth_ineligible(self.inst) is None):
            grouped = [j for j in later if j.job_id in self._prepared]
            if grouped:
                self.evaluator.smooth_batch(
                    [self._prepared[j.job_id] for j in grouped], SMOOTHINGS)
                for job in grouped:
                    self._smoothed[job.job_id] = job.cycles_done
                remaining = [j for j in later if j not in grouped]
        for job in remaining:
            tree = self._tree_for(job)
            # Smoothing reads the engines' live arenas: a full traversal
            # orients them to THIS tree first.
            self.inst.evaluate(tree, full=True)
            smooth_tree(self.inst, tree, SMOOTHINGS)
            self._smoothed[job.job_id] = job.cycles_done
        if self.evaluator is not None:
            # Re-prepare AFTER smoothing: the PreparedJobs captured at
            # grouping time hold the pre-smoothing z; the topology is
            # unchanged, so the launch table and the key survive.
            for job in later:
                self._prepared[job.job_id] = self.evaluator.prepare(
                    self._tree_for(job), self._prepared.get(job.job_id))

    def _dispatch_trees(self, batch: List[JobSpec], shard=None,
                        admission=None):
        # Later cycles smooth branch lengths before re-evaluating (the
        # multi-start refinement loop); cycle 0 scores the tree as is.
        # Smoothing runs on the primary evaluator, before the launch.
        self._smooth_if_due(batch)
        ev = shard if shard is not None else self.evaluator
        if ev is not None:
            return ev.launch_eval([self._prepared[j.job_id] for j in batch],
                                  admission)
        return np.stack([self._sequential_eval(self._tree_for(j))
                         for j in batch])

    # -- one at a time (SEV instances, bisection leaves) --------------------

    def _sequential_eval(self, tree) -> np.ndarray:
        self.inst.evaluate(tree, full=True)
        return np.array(self.inst.per_partition_lnl, copy=True)

    def _sequential_weights(self, tree, weights: List[list]) -> np.ndarray:
        """Each replicate's lnL with its weights swapped into the engines
        one at a time, after one CLV pass."""
        self.inst.evaluate(tree, full=True)
        out = []
        p = tree.centroid_branch()

        def swapped(eng, per_part):
            saved = eng.weights
            eng.weights = torch.as_tensor(
                _bootstrap.packed_weights(eng.bucket, per_part),
                dtype=eng.dtype, device=eng.device)
            try:
                return eng.evaluate(p.number, p.back.number, p.z)
            finally:
                eng.weights = saved

        for per_part in weights:
            row = np.full(len(self.inst.models), np.nan)
            for eng in self.inst.engines.values():
                # On every site shard at once: the evaluate reduces.
                vals = eng.on_shards(swapped, per_part)
                for li, gid in enumerate(eng.bucket.part_ids):
                    row[gid] = vals[li]
            out.append(row)
        return np.stack(out)
