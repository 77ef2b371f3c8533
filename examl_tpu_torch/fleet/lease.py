"""Durable per-rank job leases: the leased fleet's rank-level fault
domain.

The port of `examl_tpu/fleet/lease.py`, with its file format and POSIX
discipline, so either package's ranks read the other's leases.  A
site-parallel run is lockstep, and one dead rank stops the gang; a
fleet's jobs are INDEPENDENT, so the recovery unit is the lease.  Under
`--launch N` with a fleet mode, or ranks started by hand with `--nprocs
N --procid K`, every rank runs its own FleetDriver and leases jobs from
a shared on-disk board in the common workdir; a rank death costs exactly
its in-flight leases: the supervisor restarts only that rank (cause
`fleet-rank-death`), its leases expire, and the surviving or restarted
ranks reap them with blake2b-jittered backoff and re-dispatch ONLY those
jobs.

The board is a directory (`ExaML_fleetLeases.<run>/`) of one small JSON
record per leased job, `{job_id, rank, attempt, deadline, nonce}`,
staged to a tmp file and fsynced, then made visible ATOMICALLY: `os.link`
to acquire (it fails with EEXIST while another rank holds the lease, the
one race-free mutual exclusion POSIX gives) and `os.replace` to renew a
lease this rank holds.  Reads go through the ledger's torn-line-tolerant
reader (`obs.ledger.read_events`): a torn record reads as a held lease
without fields, which expires by file age.

Reaping an expired lease is a two-step steal: `os.rename` the lease file
AWAY to a reaper-private name (atomic: one of N concurrent reapers wins,
the others see ENOENT), then acquire through the `os.link` path (which
can still lose to a holder that woke up and renewed; ownership never
splits).  A lease that expired under a LIVE holder is lost to it: the
driver fences every completion (`still_mine`) before it journals a result
or emits `job.done`, so no interleaving counts a job twice.  Reaping
consults the merged results journal first: a job journaled before its
holder died is absorbed as done, never re-run.

The board imports no torch: the keepalive thread renews leases while
the driver's thread sits in a long batch of kernel B1, and it must never
wait on the card.  Fault points `fleet.lease.write` (a lease publish
fails: full disk, permissions) and `fleet.lease.reap` (a reap steal
fails midway) make both paths testable.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from examl_tpu_torch import obs
from examl_tpu_torch.obs import ledger as _ledger
from examl_tpu_torch.resilience import faults


def lease_dir(workdir: str, run_id: str) -> str:
    """The one naming rule for a run's lease board — shared by every
    rank (and by tests asserting which jobs a dead rank held)."""
    return os.path.join(workdir, f"ExaML_fleetLeases.{run_id}")


def reap_backoff(job_id: str, rank: int, attempt: int = 1,
                 base: float = 0.05, cap: float = 1.0) -> float:
    """Deterministic blake2b-jittered reap delay: N surviving ranks
    noticing the same expired lease at the same poll must not stampede
    the steal (only one can win the rename; the rest would burn I/O in
    lockstep forever).  Keyed on (job, rank, attempt) so each rank's
    schedule is reproducible and distinct ranks decorrelate."""
    h = int.from_bytes(hashlib.blake2b(
        f"{job_id}:{rank}:{attempt}".encode(), digest_size=8).digest(),
        "big")
    raw = min(cap, base * (2 ** max(0, attempt - 1)))
    return raw * (0.5 + 0.5 * h / 2.0 ** 64)


class LeaseBoard:
    """One rank's handle on the shared lease directory."""

    def __init__(self, path: str, rank: int, ttl_s: float,
                 attempt: int = 0):
        self.path = path
        self.rank = int(rank)
        self.ttl_s = float(ttl_s)
        self.attempt = int(attempt)     # supervisor restart count: a
        # restarted rank's fresh leases are distinguishable from its
        # dead incarnation's in the evidence trail.
        # The fabric's "SxT" (set by the driver when the rank dispatches on
        # a likelihood fabric): lease records then say which mesh shape
        # held a job.
        self.mesh: Optional[str] = None
        self._nonce = 0
        # job_id -> {nonce, deadline} we last published.  Guarded by
        # `_mu`: the KEEPALIVE thread (below) renews concurrently with
        # the driver thread acquiring/releasing.
        self._held: Dict[str, dict] = {}
        self._mu = threading.Lock()
        # Serializes whole renew() bodies: the keepalive thread and the
        # driver's drain-loop renew may target the same job, and an
        # interleaved publish/_held update would leave _held's nonce
        # behind the visible record — the rank would fence off its own
        # completed work.
        self._renew_mu = threading.Lock()
        self._keepalive: Optional[threading.Thread] = None
        self._stop = threading.Event()
        os.makedirs(path, exist_ok=True)

    # -- paths ---------------------------------------------------------------

    def _lease_path(self, job_id: str) -> str:
        return os.path.join(self.path, f"{job_id}.lease")

    def _tmp_path(self, job_id: str) -> str:
        return os.path.join(self.path,
                            f".{job_id}.tmp.r{self.rank}.{os.getpid()}")

    # -- the fsync-then-rename publish seam ---------------------------------

    def _record(self, job_id: str) -> dict:
        with self._mu:
            self._nonce += 1
            n = self._nonce
        nonce = f"r{self.rank}.{self.attempt}.{os.getpid()}.{n}"
        rec = {"job_id": job_id, "rank": self.rank,
               "attempt": self.attempt,
               "deadline": time.time() + self.ttl_s, "nonce": nonce}
        if self.mesh:
            rec["mesh"] = self.mesh
        return rec

    def _stage_fsync(self, job_id: str, rec: dict) -> str:
        """Write + fsync the record to a rank-private tmp: after this
        returns, the bytes survive a kill — the link/replace below only
        decides VISIBILITY."""
        faults.fire("fleet.lease.write")
        tmp = self._tmp_path(job_id)
        with open(tmp, "w") as f:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return tmp

    def acquire(self, job_id: str) -> bool:
        """Try to take the lease for `job_id`.  `os.link(tmp, path)` is
        the atomic claim: exactly one rank's link succeeds; EEXIST means
        another rank holds it.  Returns True when THIS rank now holds
        the lease (idempotent for a lease we already hold: renews)."""
        if job_id in self._held:
            return self.renew(job_id)
        rec = self._record(job_id)
        try:
            tmp = self._stage_fsync(job_id, rec)
        except (OSError, faults.FaultInjected) as exc:
            obs.inc("fleet.lease_errors")
            obs.log(f"EXAML: lease publish failed for {job_id} ({exc}); "
                    "the job stays unleased this round")
            return False
        try:
            os.link(tmp, self._lease_path(job_id))
        except FileExistsError:
            return False
        except OSError as exc:
            obs.inc("fleet.lease_errors")
            obs.log(f"EXAML: lease link failed for {job_id} ({exc})")
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        with self._mu:
            self._held[job_id] = {"nonce": rec["nonce"],
                                  "deadline": rec["deadline"]}
        obs.inc("fleet.leases_acquired")
        obs.ledger_event("lease.acquire", job=job_id, rank=self.rank,
                         lease_attempt=self.attempt)
        return True

    def renew(self, job_id: str, force: bool = False) -> bool:
        """Refresh the deadline of a lease we hold (`os.replace` — we
        own the path, so replacement is a renewal, not a claim).
        Skipped while more than half the ttl remains (unless `force`):
        renewing every loop iteration would fsync the board hundreds
        of times a second for deadlines still a minute away.  A
        renewal that discovers the lease was reaped out from under us
        returns False and forgets it (the fencing signal)."""
        with self._renew_mu:
            with self._mu:
                ent = self._held.get(job_id)
            if ent is None:
                return False
            if not force \
                    and ent["deadline"] - time.time() > self.ttl_s / 2:
                return True               # plenty of runway left
            if not self.still_mine(job_id):
                # Reaped while we were slow: ownership moved; do NOT
                # republish over the new holder's lease.
                with self._mu:
                    self._held.pop(job_id, None)
                obs.inc("fleet.leases_lost")
                return False
            rec = self._record(job_id)
            try:
                tmp = self._stage_fsync(job_id, rec)
                os.replace(tmp, self._lease_path(job_id))
            except (OSError, faults.FaultInjected) as exc:
                obs.inc("fleet.lease_errors")
                obs.log(f"EXAML: lease renew failed for {job_id} "
                        f"({exc})")
                return False
            with self._mu:
                self._held[job_id] = {"nonce": rec["nonce"],
                                      "deadline": rec["deadline"]}
            return True

    def release(self, job_id: str) -> None:
        """Drop a lease we hold (job finished or fenced off)."""
        with self._mu:
            if self._held.pop(job_id, None) is None:
                return
        try:
            os.unlink(self._lease_path(job_id))
        except OSError:
            pass
        obs.ledger_event("lease.release", job=job_id, rank=self.rank)

    # -- keepalive -----------------------------------------------------------

    def start_keepalive(self) -> None:
        """Renew held leases from a daemon thread every ttl/3: a long
        blocking dispatch (a first kernel build with nvcc, a deep batch)
        must not let this rank's in-flight leases
        expire under it (peers would reap live work and the fence
        would discard the whole round).  Idempotent."""
        if self._keepalive is not None and self._keepalive.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(max(0.05, self.ttl_s / 3.0)):
                with self._mu:
                    jobs = list(self._held)
                for jid in jobs:
                    try:
                        self.renew(jid)
                    except Exception:     # noqa: BLE001 — keepalive
                        pass              # must never kill the rank

        self._keepalive = threading.Thread(
            target=loop, name=f"lease-keepalive-r{self.rank}",
            daemon=True)
        self._keepalive.start()

    # -- reads (the ledger's one torn-line-tolerant path) --------------------

    def read(self, job_id: str) -> Optional[dict]:
        """The visible lease record for `job_id`, or None when no lease
        file exists.  A file whose record is torn/corrupt (a kill
        mid-publish can only tear the TMP, but a hostile fs may still
        serve garbage) reads as a held lease with no fields — callers
        fall back to file-age expiry."""
        path = self._lease_path(job_id)
        if not os.path.exists(path):
            return None
        recs = _ledger.read_events(path)
        if recs:
            return recs[0]
        return {"job_id": job_id}     # present but unreadable: held

    def holder(self, job_id: str) -> Optional[int]:
        rec = self.read(job_id)
        if rec is None:
            return None
        r = rec.get("rank")
        return int(r) if r is not None else -1

    def expired(self, job_id: str) -> Optional[bool]:
        """None = no lease; False = live; True = past its deadline (or
        unreadable AND older than 2x ttl by file age — the conservative
        fallback for a torn record)."""
        rec = self.read(job_id)
        if rec is None:
            return None
        dl = rec.get("deadline")
        if dl is not None:
            try:
                return time.time() > float(dl)
            except (TypeError, ValueError):
                pass
        try:
            mtime = os.stat(self._lease_path(job_id)).st_mtime
        except OSError:
            return None               # vanished: no lease
        return time.time() - mtime > 2.0 * self.ttl_s

    def still_mine(self, job_id: str) -> bool:
        """The commit fence: the visible lease record is the one WE
        published.  Checked before a leased job's result is journaled
        or its `job.done` emitted, so a lease lost to a reaper while we
        were slow can never double-count a job."""
        with self._mu:
            ent = self._held.get(job_id)
        if ent is None:
            return False
        rec = self.read(job_id) or {}
        return rec.get("nonce") == ent["nonce"]

    def held(self) -> List[str]:
        with self._mu:
            return list(self._held)

    # -- reaping -------------------------------------------------------------

    def stale_own(self, job_id: str) -> bool:
        """Is the visible lease a DEAD PREDECESSOR's — published by
        this rank slot but not by this process?  The rank contract (one
        process per slot; the supervisor kills before it restarts)
        makes such a lease reclaimable IMMEDIATELY: waiting out the ttl
        would idle the restarted rank exactly when it should be
        re-serving its lost jobs."""
        if job_id in self._held:
            return False
        rec = self.read(job_id)
        return rec is not None and rec.get("rank") == self.rank

    def reap(self, job_id: str, own: bool = False) -> bool:
        """Steal an EXPIRED lease: rename the lease file away to a
        reaper-private name (atomic — one winner among concurrent
        reapers), re-check the stolen record really was expired (a
        renewal may have raced our read), then acquire through the
        normal link path.  Returns True when THIS rank now holds the
        lease.  `own=True` reclaims a dead predecessor's lease (same
        rank slot) without the liveness re-check — see stale_own."""
        path = self._lease_path(job_id)
        stolen = os.path.join(
            self.path, f".{job_id}.reap.r{self.rank}.{os.getpid()}")
        try:
            faults.fire("fleet.lease.reap")
            os.rename(path, stolen)
        except FileNotFoundError:
            # Another reaper won (or the holder released): fall through
            # to a plain acquire attempt — if the job is genuinely free
            # we take it, if the winner already relinked we lose.
            return self.acquire(job_id)
        except (OSError, faults.FaultInjected) as exc:
            obs.inc("fleet.lease_errors")
            obs.log(f"EXAML: lease reap failed for {job_id} ({exc})")
            return False
        recs = _ledger.read_events(stolen)
        rec = recs[0] if recs else {}
        live = False
        dl = rec.get("deadline")
        if dl is not None:
            try:
                live = time.time() <= float(dl)
            except (TypeError, ValueError):
                live = False
        if own and rec.get("rank") == self.rank:
            live = False              # our own dead incarnation's lease
        if live:
            # Our expiry read raced a renewal: the holder is alive.
            # Put the lease BACK — via the EXCLUSIVE os.link, never a
            # rename: during the steal window the holder's keepalive
            # (os.replace) or another acquirer (os.link) may have
            # re-published at `path`, and a rename would clobber that
            # FRESH lease with this stale record, re-arming the very
            # expiry we are backing off from.  EEXIST = someone owns
            # it again; walk away.  Worst case the holder's next
            # still_mine sees the brief absence and fences itself off
            # — a re-dispatch, never a double-count.
            try:
                os.link(stolen, path)
            except OSError:
                pass
            try:
                os.unlink(stolen)
            except OSError:
                pass
            return False
        try:
            os.unlink(stolen)
        except OSError:
            pass
        obs.inc("fleet.leases_reaped")
        obs.ledger_event("lease.reap", job=job_id, rank=self.rank,
                         from_rank=rec.get("rank"),
                         from_attempt=rec.get("attempt"))
        return self.acquire(job_id)

    def scrub(self, job_id: str) -> None:
        """Remove a stale lease for a job that is KNOWN finished (its
        result is journaled): the job will never be dispatched again,
        so the lease file is pure noise.  Only an EXPIRED foreign lease
        is touched — a live one belongs to a rank that is about to
        fence itself off and release it."""
        if job_id in self._held:
            self.release(job_id)
            return
        if self.expired(job_id) is not True:
            return
        stolen = os.path.join(
            self.path, f".{job_id}.scrub.r{self.rank}.{os.getpid()}")
        try:
            os.rename(self._lease_path(job_id), stolen)
            os.unlink(stolen)
        except OSError:
            pass

    def close(self) -> None:
        """Stop the keepalive and release every lease this rank still
        holds (normal exit: the queue is drained, nothing is in
        flight — a lease left behind here would make peers wait out
        the ttl for jobs nobody owns)."""
        self._stop.set()
        if self._keepalive is not None:
            self._keepalive.join(timeout=2.0)
            self._keepalive = None
        for job_id in self.held():
            self.release(job_id)
