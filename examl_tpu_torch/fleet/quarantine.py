"""Job-level fault domains for the fleet tier.

The port of the single-process part of `examl_tpu/fleet/quarantine.py`:
one poison job (a non-finite lnL, a malformed spec) costs only itself,
never the batch or the run.

* **Poison-job bisection** (`isolate`): when a batched dispatch raises,
  re-dispatch by recursive halving; single-job leaves evaluate one at a
  time through the instance's normal path, so exactly the poison job(s)
  are attributed and every healthy cohabitant keeps a result
  bit-identical to a clean run (each job reads and writes only its own
  slice of the stacked arena).  Non-finite rows need no bisection: the
  batched result is per job, so the row IS the attribution.  A fault of
  a kernel or of the card (`device_fault`) is not a job's: it leaves the
  CUDA context unusable, so bisecting it would only hide it behind
  "quarantined" jobs, and `isolate` re-raises it.  An allocator
  out-of-memory error is a job fault: the halves need less memory.

* **Per-job retry and deadline ladder** (`JobFaultPolicy`): capped
  attempts with the supervisor's blake2b-jittered `backoff_delay` keyed
  on the job id, and a wall-clock per-batch deadline that the driver
  declares in its heartbeat: a `--supervise` parent kills a job-stuck
  attempt WITHOUT consuming a run-level retry and exports
  `EXAML_FLEET_HANG_ATTEMPTS` (`parse_hang_attempts`), so the resumed
  driver quarantines the repeat offender.

* **Dead-letter records** (`DeadLetters`): a quarantined job lands in
  `ExaML_fleetFailed.<run>` (one JSON object per line: cause, attempts,
  last error).

* **Durable results journal** (`ResultsJournal`): finished-job results
  append to an fsync'd per-run JSONL (`ExaML_fleetJournal.<run>`) whose
  reader skips a torn final line, so a kill loses at most the in-flight
  batch's compute, never a finished result; `-R` resume reconciles
  journal ∪ checkpoint (`reconcile_extras`).  Leased ranks write one
  journal each (`.r<k>`), read together (`read_all_journals`) or
  incrementally (`JournalTail`).

* **Admission control** (`admission_error`): `--serve` specs that parse
  but cannot run (bad tree strings, bootstrap without a starting tree)
  are rejected at admission instead of poisoning the queue.

`isolate` counts `fleet.bisect_dispatches`; the journal is the
`fleet.results.write` fault seam.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from examl_tpu_torch import obs
from examl_tpu_torch.ops._build import KernelError
from examl_tpu_torch.resilience import faults
from examl_tpu_torch.resilience.memgov import MemoryBudgetExhausted
from examl_tpu_torch.resilience.supervisor import backoff_delay

# Env var the supervisor exports to a retry after a fleet-job-stuck
# kill: "jobid=count,jobid=count"; the driver bumps those jobs' attempts
# and quarantines any at or past the policy cap.
ENV_HANG_ATTEMPTS = "EXAML_FLEET_HANG_ATTEMPTS"

# Quarantine cause taxonomy (the dead-letter record's `cause` and the
# results table's cause column):
CAUSE_POISON = "poison"     # non-finite lnL past the retry ladder
CAUSE_ERROR = "error"       # dispatch raised / job failed to materialize
CAUSE_HANG = "hang"         # per-job deadline kills (the supervisor's)


@dataclass
class JobFaultPolicy:
    """The per-job retry and deadline ladder: `max_attempts` caps how
    many times one job may fail (poison lnL, dispatch raise, deadline
    kill) before it is quarantined; between attempts the job backs off
    with jitter keyed on its id, so a queue of retrying jobs never
    synchronizes and a test can pin the exact delay sequence.
    `deadline_s` is the wall-clock budget of one batched dispatch before
    a `--supervise` parent declares the batch's jobs stuck (0: no
    declaration, the stall window applies)."""

    max_attempts: int = 2
    deadline_s: float = 0.0
    backoff_base: float = 0.25
    backoff_cap: float = 5.0

    def backoff(self, job_id: str, attempt: int) -> float:
        return backoff_delay(self.backoff_base, attempt, key=job_id,
                             cap=self.backoff_cap)


def parse_hang_attempts(text: Optional[str]) -> Dict[str, int]:
    """Parse the EXAML_FLEET_HANG_ATTEMPTS export ("id=n,id=n").
    Malformed entries are dropped: a garbled value degrades to no
    evidence, never a crashed resume."""
    out: Dict[str, int] = {}
    for item in (text or "").split(","):
        item = item.strip()
        if not item:
            continue
        jid, sep, val = item.partition("=")
        if not sep or not jid:
            continue
        try:
            n = int(val)
        except ValueError:
            continue
        if n > 0:
            out[jid] = n
    return out


def device_fault(exc: BaseException) -> bool:
    """True for a fault of a kernel or of the card, which no job caused:
    a kernel that did not build or launch (`KernelError`), or a CUDA
    runtime error.  An allocator out-of-memory error is a job's."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(exc, KernelError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)


# -- poison-job bisection ----------------------------------------------------


def isolate(batch: List, evaluate: Callable, leaf: Callable,
            _nested: bool = False) -> List[Tuple[object, object, object]]:
    """Dispatch `batch`, attributing any raise to exact jobs by
    recursive halving.  Returns [(job, row, error)] in batch order —
    `row` is the job's per-partition lnL ndarray (None on error),
    `error` the exception that killed its leaf (None on success).

    `evaluate(batch, nested)` runs one batched dispatch and may raise;
    `leaf(job)` evaluates ONE job through the one-at-a-time path.
    Healthy cohabitants of a poison job keep results bit-identical to a
    clean run.  A device fault (`device_fault`) or an exhausted memory
    budget is re-raised, never attributed to a job.  Every re-dispatch below the top level counts
    `fleet.bisect_dispatches`."""
    if _nested:
        obs.inc("fleet.bisect_dispatches")
    try:
        if len(batch) == 1 and _nested:
            return [(batch[0], leaf(batch[0]), None)]
        rows = evaluate(batch, _nested)
        return [(job, rows[i], None) for i, job in enumerate(batch)]
    except Exception as exc:          # noqa: BLE001 — attributed below
        if device_fault(exc) or isinstance(exc, MemoryBudgetExhausted):
            raise
        if len(batch) == 1:
            return [(batch[0], None, exc)]
    mid = (len(batch) + 1) // 2
    return (isolate(batch[:mid], evaluate, leaf, _nested=True)
            + isolate(batch[mid:], evaluate, leaf, _nested=True))


def isolate_launched(batch: List, outcome, evaluate: Callable,
                     leaf: Callable) -> List[Tuple[object, object, object]]:
    """`isolate` for a batch already launched and collected: `outcome`,
    its rows or the exception its launch or collect raised, stands in
    for the ladder's first top-level dispatch, so a clean batch is not
    run again and the bisection below a failed one (and its
    `fleet.bisect_dispatches`) runs as after a dispatch of its own."""
    first = [outcome]

    def dispatch(b, nested):
        if not nested and first:
            out = first.pop()
            if isinstance(out, BaseException):
                raise out
            return out
        return evaluate(b, nested)

    return isolate(batch, dispatch, leaf)


# -- durable results journal -------------------------------------------------


def journal_path(workdir: str, run_id: str,
                 rank: Optional[int] = None) -> str:
    """The results journal of a run: `ExaML_fleetJournal.<run>`, or a
    leased rank's own, `.r<k>` (concurrent ranks never interleave
    appends in one file; readers merge the set)."""
    base = os.path.join(workdir, f"ExaML_fleetJournal.{run_id}")
    return base if rank is None else f"{base}.r{rank}"


def _journal_paths(workdir: str, run_id: str) -> List[str]:
    """The base journal and every `.r<k>` rank journal (two globs: a bare
    `<run>*` would also match another run whose id extends this one)."""
    base = journal_path(workdir, run_id)
    return sorted(set(glob.glob(base) + glob.glob(base + ".r*")))


def read_all_journals(workdir: str, run_id: str) -> List[dict]:
    """Every rank's journal records, merged."""
    recs: List[dict] = []
    for p in _journal_paths(workdir, run_id):
        recs.extend(r for r in read_records(p) if r.get("job_id"))
    return recs


class JournalTail:
    """Incremental reader over a run's journals: a serving rank polls
    them twice a second for its whole life, and re-parsing every record
    from byte 0 each tick would be quadratic over a long run.  The
    journals are append-only, so this keeps a byte offset per file and
    parses only the tail; an incomplete final line (no newline yet: a
    read in the middle of an append) is NOT consumed.  A file that SHRANK
    (a fresh run recreated it) is re-read from 0; absorbing a record
    twice is harmless."""

    def __init__(self, workdir: str, run_id: str):
        self.workdir = workdir
        self.run_id = run_id
        self._offsets: Dict[str, int] = {}
        self._records: Dict[str, dict] = {}   # job_id -> newest record

    def records(self) -> List[dict]:
        for path in _journal_paths(self.workdir, self.run_id):
            off = self._offsets.get(path, 0)
            try:
                if os.path.getsize(path) < off:
                    off = 0               # truncated or recreated
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read()
            except OSError:
                continue
            if not chunk:
                continue
            complete, _, torn = chunk.rpartition(b"\n")
            if complete:
                for line in complete.split(b"\n"):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue          # a garbage line is consumed
                    if isinstance(rec, dict) and rec.get("job_id"):
                        self._records[rec["job_id"]] = rec
            self._offsets[path] = off + len(chunk) - len(torn)
        return list(self._records.values())


def read_records(path: str) -> List[dict]:
    """Every intact JSON object of a JSONL file, skipping a torn final
    line (the artifact of a writer killed mid-append) and other garbage
    lines; a missing file reads as empty."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _append_fsynced(f, rec: dict) -> None:
    f.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")
    f.flush()
    os.fsync(f.fileno())


class ResultsJournal:
    """Append-only fsync'd per-run JSONL of *finished* jobs (done or
    quarantined).  The checkpoint covers the whole job table but is
    written per batch; the journal is written per finished job, so a
    kill between a batch and its checkpoint loses compute, never a
    finished result."""

    def __init__(self, path: str, log=None):
        self.path = path
        self.log = log or (lambda *_: None)
        self._f = None

    def append(self, rec: dict) -> bool:
        """Append one finished-job record; fsync before returning.
        Returns False (and counts `fleet.journal_errors`) on an I/O
        failure — the checkpoint still covers the job, so a full disk
        degrades durability instead of killing a serving process.  The
        `fleet.results.write` fault point models exactly that failure
        (or, with `:signal=KILL`, dying mid-append)."""
        try:
            faults.fire("fleet.results.write")
            if self._f is None or self._f.closed:
                self._f = open(self.path, "a")
            _append_fsynced(self._f, rec)
            return True
        except (OSError, ValueError, faults.FaultInjected) as exc:
            obs.inc("fleet.journal_errors")
            self.log(f"fleet: results-journal append failed ({exc}); the "
                     "checkpoint remains the record for this job")
            return False

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def read(self) -> List[dict]:
        """Every intact record with a job id."""
        return [r for r in read_records(self.path) if r.get("job_id")]


def job_record(job) -> dict:
    """The journal/dead-letter serialization of one JobSpec — the field
    names `FleetDriver.restore_jobs` consumes, so a journal record can
    stand in for a checkpointed job entry."""
    rec = job.to_dict()
    rec["t"] = time.time()
    return rec


def reconcile_extras(extras: Optional[dict],
                     journal_records: List[dict]) -> dict:
    """Journal ∪ checkpoint: the resume job table where a job finished
    according to EITHER record is finished.  The journal is written per
    job and the checkpoint per batch, so the journal can only be AHEAD
    of the newest checkpoint — the union (the journal wins for jobs the
    checkpoint still thinks are pending) is exact.  `extras` is not
    mutated."""
    blob = json.loads(json.dumps(extras or {}, default=str))
    fleet = blob.setdefault("fleet", {})
    jobs = fleet.setdefault("jobs", [])
    by_id = {d.get("job_id"): d for d in jobs}
    for rec in journal_records:
        if not rec.get("done"):
            continue
        d = by_id.get(rec["job_id"])
        if d is None:
            d = {k: v for k, v in rec.items() if k != "t"}
            jobs.append(d)
            by_id[rec["job_id"]] = d
        elif not d.get("done"):
            for k in ("cycles_done", "lnl", "done", "failed", "newick",
                      "attempts", "cause", "last_error"):
                if k in rec:
                    d[k] = rec[k]
    return blob


# -- dead letters ------------------------------------------------------------


class DeadLetters:
    """`ExaML_fleetFailed.<run>`: one JSON line per quarantined job —
    cause, attempts and the last error."""

    def __init__(self, path: str, log=None):
        self.path = path
        self.log = log or (lambda *_: None)

    def append(self, job, cause: str, error: str) -> None:
        rec = job_record(job)
        rec["cause"] = cause
        rec["error"] = (error or "")[:400]
        try:
            with open(self.path, "a") as f:
                _append_fsynced(f, rec)
        except OSError as exc:
            self.log(f"fleet: dead-letter append failed ({exc})")

    def read(self) -> List[dict]:
        return read_records(self.path)


# -- admission control -------------------------------------------------------


def admission_error(spec, inst, start_tree,
                    tree_cache: Optional[dict] = None) -> Optional[str]:
    """None when `spec` can run on this serving process, else the
    rejection reason: the tree string parses (against the alignment's
    taxa), and bootstrap jobs have the fixed topology they resample.
    `tree_cache` (the driver's job_id -> Tree cache) receives the parsed
    tree, so admission is the one parse."""
    if spec.kind == "bootstrap" and start_tree is None:
        return ("bootstrap jobs resample weights on a fixed topology: "
                "this serving process has no starting tree (-t)")
    if spec.kind == "eval":
        try:
            tree = inst.tree_from_newick(spec.newick)
        except Exception as exc:      # noqa: BLE001 — reason, not crash
            return f"bad tree: {str(exc)[:160]}"
        if tree_cache is not None:
            tree_cache[spec.job_id] = tree
    return None
