"""The port's fleet tier (examl_tpu_torch/fleet/, cli/fleet.py) against
its own one-at-a-time path and against the JAX package (float64 on the
CPU, x64 on the JAX side).

* seeds, bootstrap weights, packed weights and the jobs-file parser
  equal the JAX package's, bit for bit and error for error (a torn last
  line included);
* the stacked launch table (`fastpath.stack_tables`): the plain version
  of kernel B1 over one table of four jobs of different layouts gives
  each job's arena rows and scalers bit for bit as its own traversal, at
  K = 4, 20 and 2 and with bfloat16 storage, and each job's wait bits are
  those of its own table (only inner children move);
* `BatchEvaluator` against the port's one-at-a-time evaluate, bit for
  bit: `eval_batch` under GAMMA, -M (two branch slots) and PSR, and
  `eval_weights_batch`; against the JAX package's `BatchEvaluator` on the
  same trees, rtol 1e-10;
* the driver: two cycles (smoothing between) bit for bit as the port's
  evaluate + smooth_tree + evaluate and rtol 1e-9 as the JAX package's
  FleetDriver, also when batched smoothing raises (the batch bisects and
  each job smooths alone); a batch too large for the card's free memory
  runs in parts; a resumed table dispatches only what is pending; a job
  that cannot parse and a job whose branch lengths are NaN each fail
  alone; `--serve` takes a torn final line; `restore_jobs` on a subset;
  a fault of the card is never a job's;
* the CLI: `-b 5 --fleet-batch 3`, `-N 4` and `--serve` against the JAX
  CLI's ExaML_fleet tables (ids, kinds, seeds, status; lnL within 1e-6,
  the tables print six decimals), the flag checks, and `-R` of a FLEET
  checkpoint across the packages both ways;
* on the card only (`@pytest.mark.cuda`): one stacked B1 launch against
  its plain version.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from examl_tpu_torch.fleet import bootstrap, jobs, quarantine, seeds
from examl_tpu_torch.fleet import batch as tbatch
from examl_tpu_torch.fleet.driver import FleetDriver
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data as tbuild
from examl_tpu_torch.io.partitions import PartitionSpec as TSpec
from examl_tpu_torch.ops import _build, fastpath, newview_chunk
from examl_tpu_torch.transfer import install_model_params

AA = "ARNDCQEGHILKMFPSTWYV"
NTAXA, WIDTH = 12, 240


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One intra-op thread (the suite runs on several xdist workers), both
    packages on their default smoothing route."""
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dna(ntaxa=NTAXA, width=WIDTH, seed=3):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, width)
    seqs = []
    for _ in range(ntaxa):
        cur = np.where(rng.random(width) < 0.18,
                       rng.integers(0, 4, width), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _specs(Spec, width=WIDTH):
    half = width // 2
    return [Spec("a", "DNA", "GTR", np.arange(half)),
            Spec("b", "DNA", "GTR", np.arange(half, width))]


def _params(nparts=2, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nparts):
        rates = rng.uniform(0.5, 4.0, 6)
        rates[-1] = 1.0
        out.append((rates, rng.dirichlet(np.ones(4) * 6),
                    rng.uniform(0.3, 1.4)))
    return out


def _port(**kw):
    names, seqs = _dna()
    inst = PhyloInstance(tbuild(names, seqs, _specs(TSpec)),
                         dtype=kw.pop("dtype", torch.float64), device="cpu",
                         **kw)
    install_model_params(inst, _params())
    return inst


def _J():
    """The JAX package's modules, imported inside the tests that use them
    (the card's machine, which runs the card case, has no JAX)."""
    from examl_tpu.cli.main import main
    from examl_tpu.fleet import batch, bootstrap, driver, jobs, seeds
    from examl_tpu.instance import PhyloInstance
    from examl_tpu.io.alignment import build_alignment_data
    from examl_tpu.io.bytefile import read_bytefile
    from examl_tpu.io.partitions import PartitionSpec
    from examl_tpu.models.gtr import build_model
    from examl_tpu.search import checkpoint
    import jax.numpy as jnp
    return SimpleNamespace(**locals())


def _jax(**kw):
    J = _J()
    names, seqs = _dna()
    inst = J.PhyloInstance(J.build_alignment_data(
        names, seqs, _specs(J.PartitionSpec)), dtype=J.jnp.float64, **kw)
    for gid, (part, (r, f, a)) in enumerate(zip(inst.alignment.partitions,
                                                 _params())):
        inst.models[gid] = J.build_model(part.datatype, f / f.sum(),
                                         rates=r, alpha=a, ncat=inst.ncat)
    inst.push_models()
    return inst


def _trees(inst, seeds_=(1, 2, 3, 4)):
    return [inst.random_tree(s) for s in seeds_]


# -- seeds, bootstrap, jobs ------------------------------------------------


def test_seeds_bootstrap_and_packing_equal_jax():
    J = _J()
    jseeds, jbootstrap = J.seeds, J.bootstrap
    for parent in (0, 1, 12345, 2 ** 63 - 1, 2 ** 64 + 5):
        for stream in seeds.STREAMS:
            for k in (0, 1, 7, 1000):
                assert seeds.derive(parent, stream, k) == \
                    jseeds.derive(parent, stream, k)
    for bad in ((1, "nope", 0), (1, "start", -1)):
        with pytest.raises(ValueError) as te:
            seeds.derive(*bad)
        with pytest.raises(ValueError) as je:
            jseeds.derive(*bad)
        assert str(te.value) == str(je.value)
    names, seqs = _dna()
    tdata = tbuild(names, seqs, _specs(TSpec))
    jdata = J.build_alignment_data(names, seqs, _specs(J.PartitionSpec))
    inst = PhyloInstance(tdata, dtype=torch.float64, device="cpu")
    (eng,) = inst.engines.values()
    jinst = J.PhyloInstance(jdata)
    (jeng,) = jinst.engines.values()
    for k in range(4):
        s = seeds.derive(77, "bootstrap", k)
        tw = bootstrap.bootstrap_weights(tdata, s)
        jw = jbootstrap.bootstrap_weights(jdata, s)
        assert all(np.array_equal(a, b) for a, b in zip(tw, jw))
        assert [w.sum() for w in tw] == [p.weights.sum()
                                         for p in tdata.partitions]
        assert np.array_equal(bootstrap.packed_weights(eng.bucket, tw),
                              jbootstrap.packed_weights(jeng.bucket, jw))
    own = [np.asarray(p.weights, np.float64) for p in tdata.partitions]
    assert np.array_equal(bootstrap.packed_weights(eng.bucket, own),
                          eng.weights.numpy())


JOB_LINES = [
    '{"kind": "start"}', "", "# comment",
    '{"kind": "eval", "newick": "(a,b);", "id": "mine"}',
    '{"kind": "bootstrap", "cycles": 5}',
    '{"kind": "start", "seed": 17, "cycles": 3}',
    "{bad", '{"kind": "nope"}', "[1, 2]", '"oops"',
    '{"kind": "start", "seed": "x"}', '{"kind": "start", "cycles": "two"}',
    '{"kind": "start", "seed": -1}', '{"kind": "start", "seed": NaN}',
    '{"kind": "eval"}', '{"kind": "start", "id": "job 1"}',
    '{"kind": "start", "newik": "(a,b);"}', '{"op": "pause"}',
    '{"kind": "start", "cycles": 0}', '{"op": "stop"}',
    '{"kind": "start", "id": "torn"']


def test_jobs_file_parsing_equals_jax():
    jjobs = _J().jobs

    def parse(mod, lines, **kw):
        errs = []
        specs, stop = mod.parse_jobs_lines(lines, 42, default_cycles=2,
                                           start_index=3,
                                           on_error=errs.append, **kw)
        return [s.to_dict() for s in specs], stop, errs

    port, jax_ = parse(jobs, JOB_LINES), parse(jjobs, JOB_LINES)
    assert port == jax_
    specs, stop, errs = port
    assert stop and len(errs) == 14 and len(specs) == 4
    assert "line 24" in errs[-1]       # the torn last line (3 + 21)
    for lines in (["{bad json"], ['{"kind": "eval"}'],
                  ['{"kind": "start", "id": "abc\\n"}']):
        with pytest.raises(ValueError) as te:
            jobs.parse_jobs_lines(lines, 42)
        with pytest.raises(ValueError) as je:
            jjobs.parse_jobs_lines(lines, 42)
        assert str(te.value) == str(je.value)
    assert [j.to_dict() for j in jobs.make_jobs("start", 3, 5, 2)] == \
        [j.to_dict() for j in jjobs.make_jobs("start", 3, 5, 2)]


# -- the stacked launch table ---------------------------------------------


def _mixed(storage):
    """DNA, amino-acid and binary partitions in one instance (engines at
    K = 4, 20 and 2), float64, or float32 with bfloat16 storage."""
    rng = np.random.default_rng(5)
    names = [f"t{i}" for i in range(NTAXA)]
    W = 64
    cols = {4: rng.integers(0, 4, W), 20: rng.integers(0, 20, W),
            2: rng.integers(0, 2, W)}
    seqs = {K: [] for K in cols}
    for _ in names:
        for K, cur in cols.items():
            cols[K] = np.where(rng.random(W) < 0.2,
                               rng.integers(0, K, W), cur)
            seqs[K].append("".join(("ACGT" if K == 4 else AA if K == 20
                                    else "01")[c] for c in cols[K]))
    ad = tbuild(names, seqs[4], [TSpec("d", "DNA", "GTR", np.arange(W))])
    ad.partitions += tbuild(names, seqs[20], [
        TSpec("w", "AA", "WAG", np.arange(W))]).partitions
    ad.partitions += tbuild(names, seqs[2], [
        TSpec("n", "BIN", "GTR", np.arange(W),
              empirical_freqs=True)]).partitions
    if storage is None:
        return PhyloInstance(ad, dtype=torch.float64, device="cpu")
    return PhyloInstance(ad, dtype=torch.float32, device="cpu",
                         clv_dtype=storage)


@pytest.mark.parametrize("storage", [None, torch.bfloat16],
                         ids=["f64", "bf16"])
def test_stacked_table_matches_each_jobs_traversal(storage):
    inst = _mixed(storage)
    assert sorted(inst.engines) == [2, 4, 20]
    ev = inst.batch_evaluator()
    trees = _trees(inst, (1, 2, 3, 4)) + [inst.tree_from_newick(
        "(t0,(t1,(t2,(t3,(t4,(t5,(t6,(t7,(t8,(t9,t10))))))))),t11);")]
    preps = [ev.prepare(t) for t in trees]
    assert len({p.st.launch.tobytes() for p in preps}) == len(preps)
    for eng in inst.engines.values():
        Rj = eng.num_rows
        table = fastpath.stack_tables([p.st for p in preps], Rj, "cpu")
        before = tbatch.TABLES
        clv, scaler = ev._traverse(eng, preps)
        assert tbatch.TABLES == before + 1
        for j, (tree, prep) in enumerate(zip(trees, preps)):
            # Only inner children move: each job's wait bits are those of
            # its own table.
            _, wait = fastpath.dataflow_table(prep.st.launch, prep.st.lidx,
                                              prep.st.ridx)
            s0, s1 = table.slot0[j], table.slot0[j + 1]
            assert np.array_equal(table.wait.numpy()[s0:s1], wait)
            inst.evaluate(tree, full=True)
            rows = torch.as_tensor(prep.st.row_of[NTAXA + 1:])
            assert torch.equal(clv[j * Rj + rows], eng.clv[rows])
            assert torch.equal(scaler[j * Rj + rows], eng.scaler[rows])
    assert np.isfinite(ev.eval_batch(preps)).all()


def test_stack_tables_refuses_a_layout_past_its_rows():
    inst = _port()
    ev = inst.batch_evaluator()
    st = ev.prepare(inst.random_tree(1)).st
    with pytest.raises(ValueError, match="writes row"):
        fastpath.stack_tables([st, st], st.max_write, "cpu")


# -- BatchEvaluator against one at a time and against JAX -------------------


def _per_partition(inst, tree):
    inst.evaluate(tree, full=True)
    return np.array(inst.per_partition_lnl, copy=True)


@pytest.mark.parametrize("case", ["gamma", "per_partition", "psr"])
def test_eval_batch_bitwise_and_against_jax(case):
    kw = {"gamma": {}, "per_partition": {"per_partition_branches": True},
          "psr": {"rate_model": "PSR"}}[case]
    inst, jinst = _port(**kw), _jax(**kw)
    if case == "psr":
        for k in (inst, jinst):
            for gid, part in enumerate(k.alignment.partitions):
                k.per_site_rates[gid] = np.array([0.5, 1.0, 2.2])
                k.rate_category[gid] = np.random.default_rng(gid).integers(
                    0, 3, len(part.weights)).astype(np.int32)
            k.push_site_rates()
    # Tree.random is the JAX package's, so both packages build the same
    # trees (a newick would round the branch lengths).
    trees, jtrees = _trees(inst), _trees(jinst)
    if case == "per_partition":
        rng = np.random.default_rng(1)
        for t, jt in zip(trees, jtrees):
            for (p, _), (jp, _) in zip(t.all_branches(), jt.all_branches()):
                p.z[:] = jp.z[:] = rng.uniform(0.6, 0.99, 2).tolist()
    ev = inst.batch_evaluator()
    assert ev.fast == (case != "psr")
    preps = [ev.prepare(t) for t in trees]
    groups = {}
    for p in preps:
        groups.setdefault(p.key, []).append(p)
    rows = {}
    for group in groups.values():
        for p, row in zip(group, ev.eval_batch(group)):
            rows[id(p)] = row
    if case != "psr":
        assert len(groups) == 1                   # one key, any topology
    for t, p in zip(trees, preps):
        assert np.array_equal(rows[id(p)], _per_partition(inst, t))
    # The JAX package's BatchEvaluator on the same trees.
    jev = _J().batch.BatchEvaluator(jinst)
    for jt, p in zip(jtrees, preps):
        jrow = jev.eval_batch([jev.prepare(jt)])[0]
        np.testing.assert_allclose(rows[id(p)], jrow, rtol=1e-10)


def test_weights_batch_bitwise_and_against_jax():
    inst, jinst = _port(), _jax()
    tree = inst.random_tree(3)
    reps = [bootstrap.bootstrap_weights(inst.alignment,
                                        seeds.derive(1, "bootstrap", k))
            for k in range(5)]
    ev = inst.batch_evaluator()
    got = ev.eval_weights_batch(tree, reps)
    seq = FleetDriver(inst)._sequential_weights(tree, reps)
    assert np.array_equal(got, seq)
    jt = jinst.random_tree(3)
    np.testing.assert_allclose(got, _J().batch.BatchEvaluator(
        jinst).eval_weights_batch(
        jt, reps), rtol=1e-10)


# -- the driver --------------------------------------------------------------


def test_driver_cycles_match_sequential_and_jax():
    from examl_tpu_torch.constants import SMOOTHINGS
    from examl_tpu_torch.optimize.branch import smooth_tree
    inst = _port()
    out = FleetDriver(inst, batch_cap=4, cycles=2).run(
        jobs.make_jobs("start", 3, 7, cycles=2))
    assert all(j.done and j.cycles_done == 2 for j in out)
    ref = _port()
    for j in out:
        t = ref.random_tree(seed=j.seed)
        ref.evaluate(t, full=True)
        before = ref.likelihood
        smooth_tree(ref, t, SMOOTHINGS)
        assert j.lnl == ref.evaluate(t, full=True)         # BITWISE
        assert j.lnl > before
    J = _J()
    jout = J.driver.FleetDriver(_jax(), batch_cap=4, cycles=2).run(
        J.jobs.make_jobs("start", 3, 7, cycles=2))
    np.testing.assert_allclose([j.lnl for j in out], [j.lnl for j in jout],
                               rtol=1e-9)


def test_driver_resume_skips_done_jobs(monkeypatch):
    inst = _port()
    tree = inst.random_tree(3)
    done = FleetDriver(inst, start_tree=tree, batch_cap=4).run(
        jobs.make_jobs("bootstrap", 4, 99))
    extras = FleetDriver(inst).extras()
    extras["fleet"]["jobs"] = [j.to_dict() for j in done]
    calls = []
    orig = FleetDriver._dispatch
    monkeypatch.setattr(FleetDriver, "_dispatch",
                        lambda self, b: (calls.append([j.job_id for j in b]),
                                         orig(self, b))[1])
    out = FleetDriver(inst, start_tree=tree, batch_cap=4).run(
        jobs.make_jobs("bootstrap", 4, 99), extras)
    assert calls == [] and [j.lnl for j in out] == [j.lnl for j in done]
    half = json.loads(json.dumps(extras))
    for d in half["fleet"]["jobs"][2:]:
        d["done"], d["lnl"], d["cycles_done"] = False, None, 0
    out = FleetDriver(inst, start_tree=tree, batch_cap=4).run(
        jobs.make_jobs("bootstrap", 4, 99), half)
    assert calls == [["bootstrap2", "bootstrap3"]]
    assert [j.lnl for j in out] == [j.lnl for j in done]


def test_batched_smoothing_raise_goes_down_the_job_ladder(monkeypatch):
    """A raise in batched smoothing is no quiet per-job fallback: the
    batch bisects, and each job alone smooths by smooth_tree and scores
    as the sequential evaluate + smooth_tree + evaluate."""
    from examl_tpu_torch.constants import SMOOTHINGS
    from examl_tpu_torch.optimize.branch import smooth_tree
    calls = []

    def broken(self, jobs, maxtimes):
        calls.append(len(jobs))
        raise ValueError("smoothing failed")

    monkeypatch.setattr(tbatch.BatchEvaluator, "smooth_batch", broken)
    inst = _port()
    out = FleetDriver(inst, batch_cap=4, cycles=2).run(
        jobs.make_jobs("start", 2, 7, cycles=2))
    assert calls == [2]
    ref = _port()
    for j in out:
        assert j.done and not j.failed and j.attempts == 0
        t = ref.random_tree(seed=j.seed)
        ref.evaluate(t, full=True)
        smooth_tree(ref, t, SMOOTHINGS)
        assert j.lnl == ref.evaluate(t, full=True)


def test_batch_runs_in_parts_when_its_arena_would_not_fit(monkeypatch):
    """On the card a batch whose stacked arena exceeds the free memory
    less the margin is cut in queue order, and says so."""
    eng = SimpleNamespace(device=torch.device("cuda"), B=4, lane=128, R=4,
                          K=4, num_rows=10,
                          clv=torch.zeros(1, dtype=torch.float32))
    per_job = 10 * 4 * 128 * (4 * 4 * 4 + 4)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda _d: (tbatch.ARENA_MARGIN + 3 * per_job, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda _d: per_job)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda _d: per_job)
    notes = []
    ev = tbatch.BatchEvaluator(_port(), log=notes.append)
    assert ev._parts(eng, list(range(8))) == [[0, 1, 2], [3, 4, 5], [6, 7]]
    assert len(notes) == 1 and "parts of 3 jobs" in notes[0]
    assert ev._parts(eng, [0, 1, 2]) == [[0, 1, 2]]


def test_poisoned_and_nan_jobs_fail_alone(tmp_path):
    inst = _port()
    specs = jobs.make_jobs("start", 3, 7)
    specs.append(jobs.JobSpec(job_id="bad", kind="eval", index=9, seed=0,
                              newick="((broken"))
    specs.append(jobs.JobSpec(job_id="nan", kind="start", index=10,
                              seed=123))
    dead = quarantine.DeadLetters(str(tmp_path / "failed"))
    journal = quarantine.ResultsJournal(str(tmp_path / "journal"))
    drv = FleetDriver(inst, batch_cap=8, deadletters=dead, journal=journal,
                      policy=quarantine.JobFaultPolicy(backoff_base=0.01))
    nan_tree = inst.random_tree(seed=123)
    for p, _ in nan_tree.all_branches():
        p.z[:] = [float("nan")]
    drv._trees["nan"] = nan_tree
    out = {j.job_id: j for j in drv.run(specs)}
    assert out["bad"].failed and out["bad"].cause == quarantine.CAUSE_ERROR
    assert out["nan"].failed and out["nan"].cause == quarantine.CAUSE_POISON
    assert out["nan"].attempts == 2
    for k in range(3):
        j = out[f"start{k}"]
        assert j.done and not j.failed and j.attempts == 0
        assert j.lnl == inst.evaluate(inst.random_tree(seed=j.seed),
                                      full=True)
    assert sorted(r["job_id"] for r in dead.read()) == ["bad", "nan"]
    assert len(journal.read()) == 5
    with open(journal.path, "a") as f:
        f.write('{"job_id": "torn", "done": tr')   # a torn final line
    assert len(journal.read()) == 5


def test_device_faults_are_not_job_faults():
    assert quarantine.device_fault(_build.KernelError("launch failed"))
    assert quarantine.device_fault(RuntimeError("CUDA error: an illegal "
                                                "memory access"))
    assert not quarantine.device_fault(torch.cuda.OutOfMemoryError("oom"))
    assert not quarantine.device_fault(ValueError("bad tree"))

    def evaluate(batch, nested):
        raise _build.KernelError("newview_chunk kernel launch failed")

    with pytest.raises(_build.KernelError):
        quarantine.isolate([1, 2, 3], evaluate, lambda j: None)
    inst = _port()
    drv = FleetDriver(inst, batch_cap=4)
    drv.evaluator.launch_eval = lambda preps, admission=None: (
        _ for _ in ()).throw(
        _build.KernelError("newview_chunk dataflow launch failed"))
    with pytest.raises(_build.KernelError):
        drv.run(jobs.make_jobs("start", 2, 7))


def test_serve_takes_a_torn_final_line(tmp_path, monkeypatch):
    from examl_tpu_torch.cli import fleet as cli_fleet
    inst = _port()
    jobs_file = tmp_path / "jobs.jsonl"
    jobs_file.write_text('{"kind": "start"}\n{"op": "stop"}')   # no \n
    args = SimpleNamespace(serve=str(jobs_file), seed=42, fleet_cycles=1,
                           serve_poll=0.02, serve_max_pending=100)
    files = SimpleNamespace(info=lambda *_: None)
    polls = []
    monkeypatch.setattr(cli_fleet.time, "sleep",
                        lambda _s: (polls.append(1), len(polls) < 20))
    out = cli_fleet.serve_loop(args, FleetDriver(inst, batch_cap=4), files,
                               None)
    assert [j.job_id for j in out] == ["start0"]
    assert out[0].done and not out[0].failed and len(polls) < 20


def test_restore_jobs_applies_to_the_given_subset_only():
    drv = FleetDriver.__new__(FleetDriver)
    snap = {"fleet": {"jobs": [
        {"job_id": "a", "kind": "start", "index": 0, "seed": 1,
         "cycles": 1, "cycles_done": 1, "lnl": -1.5, "done": True,
         "failed": False, "attempts": 1}]}}
    early = jobs.JobSpec("x", "start", 1, 2)
    drv.jobs = [early]
    assert drv.restore_jobs(snap, [early]) == 0
    late = jobs.JobSpec("a", "start", 0, 1)
    drv.jobs.append(late)
    assert drv.restore_jobs(snap, [late]) == 1
    assert late.done and late.lnl == -1.5 and late.attempts == 1
    assert not early.done


# -- the CLI -------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    from examl_tpu_torch.io.bytefile import write_bytefile
    d = tmp_path_factory.mktemp("fleetcli")
    names, seqs = _dna(10, 200, seed=11)
    aln = str(d / "aln.binary")
    write_bytefile(aln, tbuild(names, seqs, _specs(TSpec, 200)))
    start = str(d / "start.nwk")
    with open(start, "w") as f:
        f.write(PhyloInstance(tbuild(names, seqs, _specs(TSpec, 200)),
                              device="cpu").random_tree(3).to_newick(names)
                + "\n")
    jobs_file = d / "jobs.jsonl"
    jobs_file.write_text(
        json.dumps({"kind": "eval", "newick": open(start).read().strip()})
        + '\n{"kind": "start"}\n{"kind": "bootstrap"}\n{not json\n'
        + '{"op": "stop"}\n')
    return aln, start, str(jobs_file)


def _table(path):
    rows = {}
    for line in open(path):
        if line.startswith("#"):
            continue
        jid, kind, idx, seed, cyc, lnl, status, cause, att = line.split()
        rows[jid] = (kind, int(idx), int(seed), cyc, float(lnl), status,
                     cause, int(att))
    return rows


def _both_clis(argv, workdir):
    from examl_tpu_torch.cli.main import main
    assert _J().main(argv + ["-w", str(workdir / "jax")]) == 0
    assert main(argv + ["-w", str(workdir / "port")], device="cpu") == 0
    run = argv[argv.index("-n") + 1]
    return (_table(workdir / "jax" / f"ExaML_fleet.{run}"),
            _table(workdir / "port" / f"ExaML_fleet.{run}"))


@pytest.mark.parametrize("mode", ["bootstrap", "multistart", "serve"])
def test_cli_tables_match_jax(cli_inputs, tmp_path, mode):
    aln, start, jobs_file = cli_inputs
    argv = ["-s", aln, "-n", "F"] + {
        "bootstrap": ["-t", start, "-b", "5", "--fleet-batch", "3"],
        "multistart": ["-N", "4"],
        "serve": ["-t", start, "--serve", jobs_file, "--serve-poll",
                  "0"]}[mode]
    jt, pt = _both_clis(argv, tmp_path)
    assert sorted(pt) == sorted(jt)
    assert len(pt) == {"bootstrap": 5, "multistart": 4, "serve": 3}[mode]
    for jid, row in pt.items():
        assert row[:4] == jt[jid][:4] and row[5:] == jt[jid][5:]
        assert row[5] == "done"
        assert row[4] == pytest.approx(jt[jid][4], abs=1e-6)
    info = (tmp_path / "port" / "ExaML_info.F").read_text()
    if mode == "serve":
        assert "REJECTED at admission (malformed line: jobs file line 4" \
            in info
    else:
        trees = tmp_path / "port" / "ExaML_fleetTrees.F"
        assert (mode == "multistart") == trees.exists()


def test_cli_fleet_flag_checks(cli_inputs, tmp_path, capsys):
    from examl_tpu_torch.cli.main import main
    aln, start, _ = cli_inputs
    for argv in (["-b", "2", "-N", "2"], ["-b", "2"],
                 ["-b", "2", "-t", start, "-S"], ["-N", "2", "-f", "q"],
                 ["-b", "-5", "-t", start], ["-N", "2", "--fleet-batch", "0"],
                 ["-N", "2", "--fleet-job-deadline", "-1"],
                 ["-N", "2", "--fleet-lease-ttl", "0"],
                 ["-N", "2", "--coordinator", "127.0.0.1:1", "--nprocs",
                  "2"]):
        with pytest.raises(SystemExit):
            main(["-s", aln, "-n", "X", "-w", str(tmp_path)] + argv,
                 device="cpu")
        err = capsys.readouterr().err
        assert "error:" in err
    # A fleet over several processes is a set of leased ranks (JAX's
    # routing), each with its own explicit id.
    assert "every rank needs an explicit id" in err


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_restart_across_packages(cli_inputs, tmp_path, writer):
    """A FLEET checkpoint holding 2 of 6 multi-start jobs done, written by
    one package, resumes in the other's CLI: the done jobs keep their
    checkpointed rows, the rest run, and every lnL equals a fresh run's."""
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    aln, _, _ = cli_inputs
    argv = ["-s", aln, "-n", "R", "-N", "6", "--fleet-batch", "2"]
    fresh = tmp_path / "fresh"
    assert main(argv + ["-w", str(fresh)], device="cpu") == 0
    full = _table(fresh / "ExaML_fleet.R")
    table = [jobs.JobSpec(job_id=f"start{k}", kind="start", index=k,
                          seed=full[f"start{k}"][2]) for k in range(6)]
    for j in table[:2]:
        j.done, j.cycles_done, j.lnl = True, 1, full[j.job_id][4] - 1.0
    extras = {"fleet": {"jobs": [j.to_dict() for j in table], "cycles": 1}}
    work = tmp_path / "resume"
    J = _J()
    if writer == "jax":
        jinst = J.PhyloInstance(J.read_bytefile(aln), dtype=J.jnp.float64)
        J.checkpoint.CheckpointManager(str(work), "R").write(
            "FLEET", extras, jinst, jinst.random_tree(0))
        assert main(argv + ["-R", "-w", str(work)], device="cpu") == 0
    else:
        inst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                             device="cpu")
        CheckpointManager(str(work), "R").write(
            "FLEET", extras, inst, inst.random_tree(0))
        assert J.main(argv + ["-R", "-w", str(work)]) == 0
    got = _table(work / "ExaML_fleet.R")
    for jid, row in full.items():
        want = row[4] - 1.0 if jid in ("start0", "start1") else row[4]
        assert got[jid][5] == "done"
        assert got[jid][4] == pytest.approx(want, abs=1e-6)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_stacked_launch_matches_plain():
    """One stacked B1 launch over four jobs of different layouts (DNA,
    float32, 40 taxa) against the plain version on the same table, and
    each job's rows bit for bit as its own traversal on the engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    dev = torch.device("cuda")
    names, seqs = _dna(40, 2048, seed=4)
    inst = PhyloInstance(tbuild(names, seqs, _specs(TSpec, 2048)),
                         dtype=torch.float32, device=dev)
    install_model_params(inst, _params())
    (eng,) = inst.engines.values()
    ev = inst.batch_evaluator()
    trees = _trees(inst)
    preps = [ev.prepare(t) for t in trees]
    before = newview_chunk.LAUNCHES
    clv, scaler = ev._traverse(eng, preps)
    torch.cuda.synchronize()
    Rj = eng.num_rows
    assert newview_chunk.LAUNCHES == before + newview_chunk.table_launches(
        4, torch.float32, sum(len(p.st.launch) for p in preps))
    table = fastpath.stack_tables([p.st for p in preps], Rj, dev)
    zs = [fastpath.refresh_z_host(p.st, p.flat, 1) for p in preps]
    z = torch.as_tensor(np.stack([np.concatenate([a for a, _ in zs]),
                                  np.concatenate([b for _, b in zs])]),
                        dtype=torch.float32, device=dev)
    pmat = newview_chunk.chunk_operands(eng.models, z[0], z[1])
    c_ref = torch.zeros_like(clv)
    s_ref = torch.zeros_like(scaler)
    newview_chunk.chunk_apply_plain(
        c_ref, s_ref, eng.tips.codes, eng.tips.table, eng.block_part_i32,
        table.launch, table.lidx, table.ridx, table.lcode, table.rcode, pmat,
        eng.scale_exp)
    for j, (tree, prep) in enumerate(zip(trees, preps)):
        rows = torch.as_tensor(j * Rj + prep.st.row_of[41:], device=dev)
        assert torch.equal(scaler[rows], s_ref[rows])
        smax = c_ref[rows].abs().amax(dim=(3, 4), keepdim=True)
        assert bool(((clv[rows] - c_ref[rows]).abs() <= 1e-5 * smax).all())
        inst.evaluate(tree, full=True)
        own = torch.as_tensor(prep.st.row_of[41:], device=dev)
        assert torch.equal(clv[rows], eng.clv[own])
        assert torch.equal(scaler[rows], eng.scaler[own])
    lnl = ev.eval_batch(preps)
    for t, row in zip(trees, lnl):
        inst.evaluate(t, full=True)
        assert np.array_equal(row, inst.per_partition_lnl)


def test_engine_refuses_branch_slots_out_of_order():
    """The site sums take the partition-to-slot map as runs."""
    from examl_tpu_torch.ops.engine import LikelihoodEngine
    inst = _port()
    eng = next(iter(inst.engines.values()))
    models = [inst.models[g] for g in eng.bucket.part_ids]
    with pytest.raises(ValueError, match="branch_indices"):
        LikelihoodEngine(eng.bucket, models, eng.ntips, 2,
                         branch_indices=[1, 0], device="cpu")
