"""The fleet's leased ranks (examl_tpu_torch/fleet/lease.py, the lease and
deadline parts of fleet/driver.py and fleet/quarantine.py) against the
JAX package's, on the CPU in f64.

* The port of tests/test_shard.py's lease cases: acquire is exclusive,
  renew and release; an expired lease is reaped and its old holder fenced;
  two reapers, one winner; a torn record holds until it is old; the
  `fleet.lease.write` and `fleet.lease.reap` seams are survivable;
  `reap_backoff` is deterministic and decorrelated; a job journaled before
  its holder died is absorbed, never re-run; a leased rank scores every
  job bit for bit as the unleased driver and releases every lease;
* against the JAX package: `reap_backoff` and `parse_hang_attempts`
  (garbage included) give equal results; `JournalTail` reads the same
  records from the same bytes, a torn final line included; JAX's
  `LeaseBoard` reads a lease the port acquired (holder, expiry) and reaps
  it once expired, and the other way round;
* `apply_hang_attempts`: a deadline suspect re-dispatches alone, a job at
  its cap is quarantined with cause `hang`;
* end to end (the child is the port's CLI on the CPU): (vi) two leased
  ranks by `--nprocs 2 --procid K` on `-N 6` split the queue, each job's
  lnL bit for bit the unleased fleet's, and (viii) within rtol 1e-10 of
  the JAX package's single-process `-N`; with rank 1 killed, every job
  lands exactly once; (vii) `--fleet-job-deadline` with `fleet.job.hang`
  on one job is killed as `fleet-job-stuck`, consumes no retry, the job is
  quarantined to ExaML_fleetFailed.RUN, and the other jobs are bit for
  bit.

Every wait is a poll with a deadline; the child processes' holds are
fault-injected hangs.
"""

import json
import os
import subprocess
import time

import pytest
import torch

from examl_tpu_torch import obs
from examl_tpu_torch.fleet import lease, quarantine
from examl_tpu_torch.fleet.driver import FleetDriver
from examl_tpu_torch.fleet.jobs import make_jobs
from examl_tpu_torch.obs import ledger
from examl_tpu_torch.resilience import exitcause, faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240            # seconds, per spawned rank


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in (faults.ENV_VAR, faults.ATTEMPT_VAR,
                quarantine.ENV_HANG_ATTEMPTS):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    obs.reset()
    yield
    faults.reset()
    obs.reset()
    torch.set_num_threads(n)


def _boards(tmp_path, ttl=0.3):
    d = str(tmp_path / "leases")
    return (lease.LeaseBoard(d, rank=0, ttl_s=ttl),
            lease.LeaseBoard(d, rank=1, ttl_s=ttl))


def _until(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "condition not reached in time"
        time.sleep(0.02)


# -- the board ----------------------------------------------------------------


def test_lease_acquire_excl_renew_release(tmp_path):
    a, b = _boards(tmp_path, ttl=5.0)
    assert a.acquire("j1") is True
    assert b.acquire("j1") is False          # os.link EXCL: one holder
    assert a.still_mine("j1") and not b.still_mine("j1")
    assert b.expired("j1") is False          # live foreign lease
    assert a.renew("j1", force=True) is True
    rec = b.read("j1")
    assert rec["rank"] == 0 and rec["job_id"] == "j1"
    a.release("j1")
    assert a.read("j1") is None
    assert b.acquire("j1") is True           # released -> free


def test_lease_expiry_reap_and_fencing(tmp_path):
    a, b = _boards(tmp_path, ttl=0.25)
    assert a.acquire("j1")
    _until(lambda: b.expired("j1") is True)
    assert b.reap("j1") is True              # steal the expired lease
    assert b.still_mine("j1")
    assert a.still_mine("j1") is False       # the old holder is fenced
    assert a.renew("j1") is False            # ... and never republishes
    assert b.still_mine("j1")


def test_lease_reap_single_winner(tmp_path):
    a, b = _boards(tmp_path, ttl=0.2)
    c = lease.LeaseBoard(str(tmp_path / "leases"), rank=2, ttl_s=0.2)
    assert a.acquire("j1")
    _until(lambda: b.expired("j1") is True)
    got = [b.reap("j1"), c.reap("j1")]
    assert sum(got) == 1
    assert len([x for x in (b, c) if x.still_mine("j1")]) == 1


def test_lease_torn_record_tolerated(tmp_path):
    a, b = _boards(tmp_path, ttl=0.2)
    path = os.path.join(a.path, "j9.lease")
    with open(path, "w") as f:
        f.write('{"job_id": "j9", "ran')     # torn mid-publish
    assert b.read("j9") == {"job_id": "j9"}
    assert b.expired("j9") is False          # young: conservative hold
    assert b.acquire("j9") is False          # the file exists: not free
    past = time.time() - 10.0
    os.utime(path, (past, past))
    assert b.expired("j9") is True           # 2 x ttl file-age fallback
    assert b.reap("j9") is True


def test_lease_write_fault_survivable(tmp_path, monkeypatch):
    a, _ = _boards(tmp_path, ttl=5.0)
    monkeypatch.setenv(faults.ENV_VAR, "fleet.lease.write")
    faults.reset()
    assert a.acquire("j1") is False
    assert obs.counter("fleet.lease_errors") == 1
    assert obs.counter("faults.fired.fleet.lease.write") == 1
    assert a.read("j1") is None              # nothing half-published
    assert not [n for n in os.listdir(a.path) if ".tmp." in n]
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    assert a.acquire("j1") is True


def test_lease_reap_fault_survivable(tmp_path, monkeypatch):
    a, b = _boards(tmp_path, ttl=0.2)
    assert a.acquire("j1")
    _until(lambda: b.expired("j1") is True)
    monkeypatch.setenv(faults.ENV_VAR, "fleet.lease.reap")
    faults.reset()
    assert b.reap("j1") is False
    assert obs.counter("fleet.lease_errors") == 1
    assert b.read("j1") is not None          # still on the board
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    assert b.reap("j1") is True


def test_keepalive_renews_under_a_long_batch(tmp_path):
    a, b = _boards(tmp_path, ttl=1.0)
    assert a.acquire("j1")
    a.start_keepalive()
    try:
        t_end = time.time() + 3.2            # > 3 x ttl without a renew
        while time.time() < t_end:            # by the holder's own thread
            assert b.expired("j1") is False
            time.sleep(0.02)
    finally:
        a.close()
    assert a.read("j1") is None              # close released it


def test_reap_backoff_deterministic_decorrelated_and_equal_to_jax():
    from examl_tpu.fleet.lease import reap_backoff as jreap
    a = [lease.reap_backoff("j1", 0, k) for k in (1, 2, 3)]
    assert a == [lease.reap_backoff("j1", 0, k) for k in (1, 2, 3)]
    assert all(0 < d <= 1.0 for d in a)
    assert a != [lease.reap_backoff("j1", 1, k) for k in (1, 2, 3)]
    for jid in ("j1", "start17", "", "ñ"):
        for rank in (0, 1, 5):
            for att in (0, 1, 2, 9):
                assert lease.reap_backoff(jid, rank, att) == \
                    jreap(jid, rank, att)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lease_files_readable_and_reapable_across_packages(tmp_path,
                                                          writer):
    from examl_tpu.fleet.lease import LeaseBoard as JBoard
    d = str(tmp_path / "leases")
    mk = {"port": lease.LeaseBoard, "jax": JBoard}
    holder = mk[writer](d, rank=3, ttl_s=0.3, attempt=2)
    other = mk["jax" if writer == "port" else "port"](d, rank=1,
                                                      ttl_s=0.3)
    assert holder.acquire("start4")
    rec = other.read("start4")
    assert other.holder("start4") == 3 and rec["attempt"] == 2
    assert abs(rec["deadline"] - (time.time() + 0.3)) < 0.3
    assert other.expired("start4") is False
    assert other.acquire("start4") is False
    _until(lambda: other.expired("start4") is True)
    assert other.reap("start4") is True
    assert holder.still_mine("start4") is False
    assert holder.read("start4")["rank"] == 1


HANG_TEXTS = ["a=2,b=1", None, "", "bad,=3,x=,y=z,ok=1,zero=0",
              " start1 = 2 , start1=3", "j=-1,k=1.5,l=0x2", ",,,", "=",
              "start0=1,start0=2,start9=7"]


@pytest.mark.parametrize("text", HANG_TEXTS)
def test_parse_hang_attempts_equals_jax(text):
    from examl_tpu.fleet import quarantine as jq
    assert quarantine.parse_hang_attempts(text) == \
        jq.parse_hang_attempts(text)


def test_journal_tail_reads_as_jax(tmp_path):
    from examl_tpu.fleet import quarantine as jq
    wd, run = str(tmp_path), "T"
    base = quarantine.journal_path(wd, run)
    assert base == jq.journal_path(wd, run)
    assert quarantine.journal_path(wd, run, 2) == jq.journal_path(wd, run, 2)
    ours, theirs = quarantine.JournalTail(wd, run), jq.JournalTail(wd, run)

    def same():
        a = sorted(ours.records(), key=lambda r: r["job_id"])
        b = sorted(theirs.records(), key=lambda r: r["job_id"])
        assert a == b
        return a

    with open(base + ".r0", "w") as f:
        f.write('{"job_id": "a", "done": true, "lnl": -1.5}\n'
                'garbage line\n{"job_id": "b", "lnl": -2')     # torn
    with open(base + ".r1", "w") as f:
        f.write('{"job_id": "c", "done": true}\n[1, 2]\n')
    with open(base + "X", "w") as f:                    # another run
        f.write('{"job_id": "z"}\n')
    assert [r["job_id"] for r in same()] == ["a", "c"]
    with open(base + ".r0", "a") as f:
        f.write('.5, "done": true}\n')                  # the tear lands
    assert [r["job_id"] for r in same()] == ["a", "b", "c"]
    assert same()[1]["lnl"] == -2.5
    with open(base + ".r1", "w") as f:                  # recreated
        f.write('{"job_id": "d"}\n')
    assert [r["job_id"] for r in same()] == ["a", "b", "c", "d"]
    assert sorted(r["job_id"] for r in
                  quarantine.read_all_journals(wd, run)) == \
        sorted(r["job_id"] for r in jq.read_all_journals(wd, run)) == \
        ["a", "b", "d"]


# -- the driver ---------------------------------------------------------------


def test_expired_but_journaled_job_never_reruns(tmp_path):
    from tests.test_torch_fleet import _port
    jobs = make_jobs("start", 4, 7)
    dead = lease.LeaseBoard(str(tmp_path / "leases"), rank=1, ttl_s=0.01)
    dead.acquire("start1")
    dead._held.clear()                       # rank 1 is gone
    peer = {"job_id": "start1", "kind": "start", "index": 1,
            "seed": jobs[1].seed, "cycles": 1, "cycles_done": 1,
            "lnl": -555.5, "done": True, "failed": False, "attempts": 1}
    board = lease.LeaseBoard(str(tmp_path / "leases"), rank=0, ttl_s=0.01)
    _until(lambda: board.expired("start1") is True)
    drv = FleetDriver(_port(), batch_cap=4, leases=board,
                      peer_journals=lambda: [peer])
    out = {j.job_id: j for j in drv.run(jobs)}
    assert out["start1"].done and out["start1"].lnl == -555.5
    assert obs.counter("fleet.jobs_absorbed") == 1
    assert "start1" not in drv._started      # never dispatched here
    assert board.read("start1") is None      # the stale lease scrubbed
    assert all(j.done for j in out.values())


def test_leased_rank_matches_unleased_bitwise(tmp_path):
    from tests.test_torch_fleet import _port
    ref = {j.job_id: j.lnl
           for j in FleetDriver(_port(), batch_cap=3).run(
               make_jobs("start", 6, 9))}
    board = lease.LeaseBoard(str(tmp_path / "leases"), rank=0, ttl_s=30.0)
    drv = FleetDriver(_port(), batch_cap=3, leases=board,
                      peer_journals=lambda: [])
    assert {j.job_id: j.lnl for j in drv.run(make_jobs("start", 6, 9))} \
        == ref
    assert board.held() == [] and os.listdir(board.path) == []


def test_apply_hang_attempts_solo_and_quarantine(tmp_path, monkeypatch):
    from tests.test_torch_fleet import _port
    monkeypatch.setenv(quarantine.ENV_HANG_ATTEMPTS,
                       "start0=1,start2=2,garbage,start9=4")
    dead = quarantine.DeadLetters(str(tmp_path / "failed"))
    drv = FleetDriver(_port(), batch_cap=4, deadletters=dead,
                      policy=quarantine.JobFaultPolicy(max_attempts=2))
    out = {j.job_id: j for j in drv.run(make_jobs("start", 4, 7))}
    assert out["start2"].failed and out["start2"].cause == \
        quarantine.CAUSE_HANG
    assert [r["job_id"] for r in dead.read()] == ["start2"]
    assert out["start0"].done and not out["start0"].failed
    assert out["start0"].attempts == 1       # its deadline evidence stays
    assert obs.counter("fleet.batches") == 2  # start0 alone, then the rest


# -- end to end ---------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_case(tmp_path_factory):
    from tests.test_torch_cli import _inputs
    from examl_tpu_torch.cli.main import main
    tmp = tmp_path_factory.mktemp("lease")
    aln, _ = _inputs(tmp)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main(["-s", aln, "-n", "F", "-w", str(tmp / "ref"), "-N",
                     "6", "--fleet-batch", "2"], device="cpu") == 0
    finally:
        torch.set_num_threads(n)
    ref = {r["job_id"]: r["lnl"] for r in quarantine.read_all_journals(
        str(tmp / "ref"), "F")}
    assert len(ref) == 6
    return {"tmp": tmp, "aln": aln, "ref": ref}


def _ranks(case, name, *extra):
    """Two leased ranks started by hand; returns their exit codes and the
    merged ledger's job.done events."""
    from tests.test_torch_supervisor import CHILD
    out = case["tmp"] / name
    procs = [subprocess.Popen(
        CHILD + ["-s", case["aln"], "-n", "F", "-w", str(out), "-N", "6",
                 "--fleet-batch", "2", "--nprocs", "2", "--procid", str(k),
                 "--ledger", str(out / "led"), "--fleet-lease-ttl", "2"]
        + list(extra), cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
        for k in range(2)]
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=RANK_TIMEOUT))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    ledger.merge(str(out / "led"))
    evs = ledger.read_events(str(out / "led" / "ledger.merged.jsonl"))
    return out, rcs, [e for e in evs if e["kind"] == "job.done"], evs


def test_two_leased_ranks_split_the_queue_bit_for_bit(fleet_case):
    # The rank that takes start0 holds that batch a moment: the other
    # takes the rest.
    out, rcs, done, _ = _ranks(
        fleet_case, "split", "--inject-fault",
        "fleet.job.hang:job=start0:hang=3")
    assert rcs == [0, 0]
    assert sorted(e["job"] for e in done) == sorted(fleet_case["ref"])
    assert {e["proc"] for e in done} == {0, 1}          # split
    got = {r["job_id"]: r["lnl"] for r in quarantine.read_all_journals(
        str(out), "F")}
    assert got == fleet_case["ref"]                       # bit for bit
    assert os.listdir(lease.lease_dir(str(out), "F")) == []
    assert not (out / ".proc1" / "ExaML_fleet.F").exists()
    rows = (out / "ExaML_fleet.F").read_text().splitlines()[1:]
    assert len(rows) == 6 and all(" done " in r for r in rows)
    fleet_case["leased"] = got


def test_leased_lnls_match_the_jax_single_process_fleet(fleet_case):
    from examl_tpu.cli.main import main as jmain
    from examl_tpu.fleet import quarantine as jq
    out = fleet_case["tmp"] / "jax"
    assert jmain(["-s", fleet_case["aln"], "-n", "F", "-w", str(out), "-N",
                  "6", "--fleet-batch", "2"]) == 0
    want = {r["job_id"]: r["lnl"] for r in jq.read_all_journals(str(out),
                                                               "F")}
    got = fleet_case.get("leased") or fleet_case["ref"]
    assert sorted(got) == sorted(want)
    for jid, lnl in got.items():
        assert lnl == pytest.approx(want[jid], rel=1e-10)


def test_a_killed_leased_rank_costs_only_its_leases(fleet_case):
    out, rcs, done, evs = _ranks(
        fleet_case, "kill", "--inject-fault",
        "fleet.job.hang:job=start0:hang=3",
        "--inject-fault", "search.kill@rank=1:after=1")
    assert rcs[0] == 0 and rcs[1] == -9
    # Every job lands exactly once, with its unleased bits.
    assert sorted(e["job"] for e in done) == sorted(fleet_case["ref"])
    got = {r["job_id"]: r["lnl"] for r in quarantine.read_all_journals(
        str(out), "F")}
    assert got == fleet_case["ref"]
    reaped = [e for e in evs if e["kind"] == "lease.reap"]
    assert reaped and all(e["proc"] == 0 and e["from_rank"] == 1
                          for e in reaped)


def test_job_deadline_kills_the_stuck_job_only(fleet_case):
    """start3 hangs in every attempt and blows the deadline: killed, no
    retry used (the budget is 0), the job pays an attempt; the resumed run
    quarantines it at its cap (one attempt) and finishes the others.  The
    re-dispatch of a stuck batch's jobs one at a time is
    test_apply_hang_attempts_solo_and_quarantine's."""
    from tests.test_torch_supervisor import CHILD
    from examl_tpu_torch.cli.main import build_argparser
    from examl_tpu_torch.resilience import supervisor as sup
    out = fleet_case["tmp"] / "deadline"
    argv = ["-s", fleet_case["aln"], "-n", "F", "-w", str(out), "-N", "6",
            "--fleet-batch", "1", "--fleet-job-attempts", "1",
            "--fleet-job-deadline", "2", "--supervise",
            "--supervise-retries", "0", "--supervise-backoff", "0.05",
            "--metrics", str(out / "m.json"), "--inject-fault",
            "fleet.job.hang:job=start3:attempt=*"]
    assert sup.supervise(argv, build_argparser().parse_args(argv),
                         log=lambda m: None, child_cmd=CHILD) == 0
    snap = json.loads((out / "m.json").read_text())
    att = snap["resilience"]["attempts"]
    assert [a["cause"] for a in att] == [exitcause.CAUSE_FLEET_JOB_STUCK,
                                         exitcause.CAUSE_OK]
    assert att[1]["resumed"] is True
    assert snap["resilience"]["fleet_hang_attempts"] == {"start3": 1}
    assert snap["counters"]["resilience.fleet_job_stuck_kills"] == 1
    assert not [k for k in snap["counters"]
                if k.startswith("resilience.exits.")]
    assert all(a["pins"] == {} for a in att)           # no rung either
    (failed,) = quarantine.DeadLetters(
        str(out / "ExaML_fleetFailed.F")).read()
    assert failed["job_id"] == "start3" and failed["cause"] == "hang"
    assert failed["attempts"] == 1
    got = {r["job_id"]: r["lnl"] for r in quarantine.read_all_journals(
        str(out), "F") if not r.get("failed")}
    assert got == {k: v for k, v in fleet_case["ref"].items()
                   if k != "start3"}                   # bit for bit
