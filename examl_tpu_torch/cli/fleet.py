"""Fleet modes (-b K / -N K / --serve) entry point.

The port of `examl_tpu/cli/main.py`'s `run_fleet`, `_serve_loop` and
`_write_fleet_results` for one process: the grouped batched job queue
(fleet/driver.py) with per-job checkpoints (state FLEET, `-R` resume
through the normal CheckpointManager, in the JAX package's format),
job-level fault domains (fleet/quarantine.py) and a durable per-job
results journal reconciled at resume.  Under a leased gang (`--launch N`
with a fleet mode, or ranks started by hand with `--nprocs N --procid
K`), every rank runs its own driver over the shared workdir: jobs are
held under per-rank leases (fleet/lease.py), each rank journals to its
own `.r<k>` file, and no checkpoints are written (the ranks are not in
lockstep; the fsynced journals are the record, and `-R` reconciles all
of them).  It writes the JAX package's result files: ExaML_fleet.RUN
(one row per job: id, kind, index, seed, cycles, lnL, status, cause,
attempts), ExaML_fleetTrees.RUN (each finished tree job's tree),
ExaML_fleetJournal.RUN and ExaML_fleetFailed.RUN.
"""

from __future__ import annotations

import glob
import os
import time


def run_fleet(args, inst, files) -> int:
    from examl_tpu_torch.cli.main import _read_trees, checkpoint_manager
    from examl_tpu_torch.fleet import jobs as jobs_mod
    from examl_tpu_torch.fleet import lease as lease_mod
    from examl_tpu_torch.fleet import quarantine
    from examl_tpu_torch.fleet.driver import FleetDriver

    gang = getattr(args, "_gang", None)
    rank, world, shared_dir = (gang if gang is not None
                               else (0, 1, args.workdir))
    leased = gang is not None
    board = None
    peer_journals = None
    if leased:
        mgr = None
        board = lease_mod.LeaseBoard(
            lease_mod.lease_dir(shared_dir, args.run_id), rank,
            ttl_s=args.fleet_lease_ttl,
            attempt=int(os.environ.get("EXAML_RESTART_COUNT", "0") or 0))
        # Incremental reads: the absorb loop polls the journals for the
        # rank's whole life.
        peer_journals = quarantine.JournalTail(shared_dir,
                                               args.run_id).records
        files.info(f"fleet: leased serving rank {rank} of {world} (lease "
                   f"board {board.path}, ttl {args.fleet_lease_ttl:.0f}s)")
    else:
        mgr = checkpoint_manager(args, files, keep_last=2)
    suffix = f".r{rank}" if leased else ""
    journal = quarantine.ResultsJournal(
        quarantine.journal_path(shared_dir, args.run_id,
                                rank if leased else None), log=files.info)
    deadletters = quarantine.DeadLetters(
        os.path.join(shared_dir, f"ExaML_fleetFailed.{args.run_id}{suffix}"),
        log=files.info)
    if not args.restart:
        # A fresh run reusing a run id must not inherit an abandoned
        # run's journal or dead letters: a later -R would reconcile the
        # old records as done and skip jobs whose inputs changed.
        stale_files = [journal.path, deadletters.path]
        if leased and rank == 0:
            # Rank 0 also clears what no rank of this world will write:
            # an unleased run's base files and the journals of ranks
            # beyond this world.  The other ranks clear their own.
            for pat in (f"ExaML_fleetJournal.{args.run_id}",
                        f"ExaML_fleetFailed.{args.run_id}"):
                stale_files.append(os.path.join(shared_dir, pat))
                for p in glob.glob(os.path.join(shared_dir, pat + ".r*")):
                    try:
                        r = int(p.rsplit(".r", 1)[1])
                    except ValueError:
                        continue
                    if r >= world:
                        stale_files.append(p)
        for stale in stale_files:
            try:
                os.unlink(stale)
            except OSError:
                pass
    policy = quarantine.JobFaultPolicy(
        max_attempts=args.fleet_job_attempts,
        deadline_s=args.fleet_job_deadline)
    start_tree = None
    if args.tree_file:
        start_tree = inst.tree_from_newick(_read_trees(args.tree_file)[0])
        inst.evaluate(start_tree, full=True)
        files.info(f"starting tree lnL {inst.likelihood:.6f}")
        files.log_lnl(inst.likelihood)
    resume = None
    if args.restart and leased:
        # A leased rank resumes from the merged journals alone (no
        # checkpoints exist on purpose); a rank restarted before any job
        # finished starts serving against the board.
        journal_recs = quarantine.read_all_journals(shared_dir, args.run_id)
        resume = quarantine.reconcile_extras({}, journal_recs)
        files.info(f"restart (leased rank {rank}): {len(journal_recs)} "
                   "journal record(s) reconciled across ranks")
    elif args.restart:
        scaffold = (start_tree if start_tree is not None
                    else inst.random_tree(seed=args.seed))
        # The journal is read here, before the driver's first checkpoint
        # write (the only place old checkpoints are pruned).
        res = mgr.restore(inst, scaffold)
        journal_recs = journal.read()
        if res is not None and res["state"] != "FLEET":
            files.info(f"checkpoint state {res['state']} is not a fleet "
                       "checkpoint")
            return 1
        if res is None and not journal_recs:
            if not os.path.exists(journal.path):
                files.info("no checkpoint found; cannot restart")
                return 1
            # A journal without an intact record (a kill inside its very
            # first append): nothing finished, so a fresh start is the
            # resume.
            files.info("no checkpoint and no intact journal record; "
                       "starting the fleet from scratch")
        # Journal ∪ checkpoint: a kill between a batch and its
        # checkpoint must not replay the batch's finished jobs.
        resume = quarantine.reconcile_extras(
            res["extras"] if res is not None else {}, journal_recs)
        files.info(
            "restart from fleet "
            + ("checkpoint" if res is not None else "results journal")
            + (f" (+ {len(journal_recs)} journal record(s) reconciled)"
               if journal_recs and res is not None else ""))
    driver = FleetDriver(inst, start_tree=start_tree,
                         batch_cap=args.fleet_batch,
                         cycles=args.fleet_cycles, mgr=mgr, log=files.info,
                         policy=policy, journal=journal,
                         deadletters=deadletters, leases=board,
                         peer_journals=peer_journals,
                         devices=args.fleet_devices)
    if board is not None:
        # Keepalive: a long batch must not let this rank's leases expire
        # under it.
        board.start_keepalive()
    try:
        if args.serve:
            jobs = serve_loop(args, driver, files, resume)
        else:
            if args.bootstrap:
                jobs = jobs_mod.make_jobs("bootstrap", args.bootstrap,
                                          args.seed, cycles=1)
                files.info(f"fleet: {len(jobs)} bootstrap replicates of "
                           "the starting topology")
                if args.fleet_cycles > 1:
                    files.info("note: --fleet-cycles applies to tree "
                               "jobs; bootstrap replicates are "
                               "weights-only (always 1 cycle)")
            else:
                jobs = jobs_mod.make_jobs("start", args.multi_start,
                                          args.seed,
                                          cycles=args.fleet_cycles)
                files.info(f"fleet: {len(jobs)} multi-start trees, "
                           f"{args.fleet_cycles} cycle(s) each")
            jobs = driver.run(jobs, resume)
    finally:
        if board is not None:
            # Release whatever this rank still holds (a stop line with
            # jobs in retry backoff, an exception): a lease left behind
            # would make the peers wait out the ttl for jobs nobody owns.
            board.close()
        journal.close()
    return write_fleet_results(args, files, jobs)


def _reject_job(files, job_id, reason: str) -> None:
    """Admission rejection: ledger event + counter + operator line — the
    driver never sees the spec, so a rejected job can neither crash the
    loop nor occupy the queue."""
    from examl_tpu_torch import obs
    obs.inc("fleet.rejected")
    obs.ledger_event("job.rejected", job=job_id, reason=reason[:200])
    files.info("fleet: job " + (f"{job_id!r} " if job_id else "")
               + f"REJECTED at admission ({reason})")


def serve_loop(args, driver, files, resume):
    """Drain and poll the jobs file until a stop line (or, with
    --serve-poll 0, until the current contents are drained).  Jobs are
    addressed by line index, so appends never re-seed earlier jobs and a
    resume re-parses the whole file and skips finished ones.  Specs that
    parse but cannot run (bad trees, duplicate ids, malformed lines) are
    rejected instead of joining the queue, and ingestion pauses while
    --serve-max-pending jobs are pending."""
    from examl_tpu_torch import obs
    from examl_tpu_torch.fleet import quarantine
    from examl_tpu_torch.fleet.jobs import parse_jobs_lines
    from examl_tpu_torch.resilience import heartbeat, preempt

    max_pending = max(1, int(getattr(args, "serve_max_pending", 10000)))
    processed = 0
    stop = False
    torn_prev = None
    driver.jobs = []
    while True:
        try:
            with open(args.serve) as f:
                lines = f.readlines()
        except OSError as exc:
            files.info(f"fleet: jobs file unreadable ({exc}); stopping")
            break
        # A torn final line (no trailing newline) waits for the next
        # poll to complete it; a line UNCHANGED across two polls is taken
        # as complete, so a producer that stops mid-write (or writes its
        # last line without a newline) cannot starve the queue.  In
        # drain-once mode no more appends are coming: take it as is.
        if lines and args.serve_poll > 0 and not lines[-1].endswith("\n"):
            if lines[-1] != torn_prev:
                torn_prev = lines[-1]
                lines = lines[:-1]
        else:
            torn_prev = None
        budget = max_pending - len(driver.pending())
        if len(lines) > processed and budget > 0:
            tail = lines[processed:]
            if any(ln.strip() and not ln.strip().startswith("#")
                   for ln in tail):
                errors = []
                specs, stop_seen = parse_jobs_lines(
                    tail, args.seed, default_cycles=args.fleet_cycles,
                    start_index=processed, on_error=errors.append)
                if len(specs) > budget:
                    # Cut at the first spec past the budget and re-parse
                    # only the consumed prefix (its errors reported once,
                    # a stop line before the cut honored); the rest
                    # re-parses at a later poll.
                    cut = specs[budget].index
                    errors = []
                    specs, stop_seen = parse_jobs_lines(
                        tail[:cut - processed], args.seed,
                        default_cycles=args.fleet_cycles,
                        start_index=processed, on_error=errors.append)
                    processed = cut
                else:
                    processed = len(lines)
                for msg in errors:
                    _reject_job(files, None, f"malformed line: {msg}")
                stop = stop or stop_seen
                # Duplicate ids, within a poll or across polls, would
                # alias the driver's per-job state: the first definition
                # wins.
                existing = {j.job_id for j in driver.jobs}
                fresh = []
                for s in specs:
                    if s.job_id in existing:
                        _reject_job(files, s.job_id, "duplicate job id")
                        continue
                    # The admission parse seeds the driver's tree cache,
                    # except on a resumed loop, where restore_jobs may
                    # replace the job's newick by its checkpointed tree.
                    reason = quarantine.admission_error(
                        s, driver.inst, driver.start_tree,
                        tree_cache=None if resume else driver._trees)
                    if reason is not None:
                        _reject_job(files, s.job_id, reason)
                        continue
                    existing.add(s.job_id)
                    fresh.append(s)
                if fresh:
                    driver.jobs.extend(fresh)
                    if resume:
                        # The snapshot applies to the FRESH specs only:
                        # each job sees it once, as it joins the queue.
                        driver.restore_jobs(resume, fresh)
                    driver.apply_hang_attempts(fresh)
                    files.info(f"fleet: {len(fresh)} new jobs from "
                               f"{args.serve} (queue {len(driver.jobs)})")
                obs.gauge("fleet.jobs_total", len(driver.jobs))
            else:
                processed = len(lines)        # whitespace/comments only
        if driver.pending():
            driver.drain()
            continue
        if stop:
            files.info("fleet: stop line seen and queue drained")
            break
        if args.serve_poll <= 0:
            break
        heartbeat.phase_beat("SERVE")
        preempt.check_after_checkpoint(log=files.info)
        time.sleep(args.serve_poll)
    return driver.jobs


def write_fleet_results(args, files, jobs) -> int:
    """The per-job results table and the finished trees (rank 0 only,
    like every output).  Failed rows carry their cause and attempt
    count; each quarantined job's full record is in
    ExaML_fleetFailed.<run>."""
    ok = [j for j in jobs if j.done and not j.failed]
    failed = [j for j in jobs if j.failed]
    files.info(f"fleet: {len(ok)} jobs done, {len(failed)} failed, "
               f"{len(jobs) - len(ok) - len(failed)} pending")
    if failed:
        files.info(f"fleet: {len(failed)} quarantined job(s) with cause/"
                   "attempts/last-error in "
                   + os.path.join(args.workdir,
                                  f"ExaML_fleetFailed.{args.run_id}"))
    if ok:
        best = max(ok, key=lambda j: j.lnl)
        files.info(f"fleet: best job {best.job_id} ({best.kind}) "
                   f"likelihood {best.lnl:.6f}")
        files.log_lnl(best.lnl)
    if files.primary:
        table = os.path.join(args.workdir, f"ExaML_fleet.{args.run_id}")
        with open(table, "w") as f:
            f.write("# job_id kind index seed cycles lnl status "
                    "cause attempts\n")
            for j in jobs:
                lnl = f"{j.lnl:.6f}" if j.lnl is not None else "nan"
                status = ("failed" if j.failed
                          else "done" if j.done else "pending")
                f.write(f"{j.job_id} {j.kind} {j.index} {j.seed} "
                        f"{j.cycles_done}/{j.cycles} {lnl} {status} "
                        f"{j.cause or '-'} {j.attempts}\n")
        files.info(f"fleet results -> {table}")
        trees = [j for j in ok if j.newick]
        if trees:
            tf = os.path.join(args.workdir,
                              f"ExaML_fleetTrees.{args.run_id}")
            with open(tf, "w") as f:
                for j in trees:
                    f.write(j.newick.strip() + "\n")
            files.info(f"{len(trees)} fleet trees -> {tf}")
    return 0 if ok or not jobs else 1
