"""Site-parallel runs of the port over several processes on the CPU: two
ranks in a gloo group, float64, each rank a spawned process with a
timeout of its own, holding a block window of the packed site axis and
reducing every site sum over the group (parallel/sharding.py).

The JAX package's own sharded-equals-unsharded contract
(tests/test_sharding.py) makes its single-process value the reference,
so no JAX multi-process run is needed.  On ref49, per rank pair:

* per-partition lnL at rtol 1e-10 of JAX's single-process value and
  1e-12 of the port's one-process value, under GAMMA, PSR (a fixed
  per-site rate state in both packages) and `-S`;
* NR derivatives at rtol 1e-9, makenewz at 1e-10, whole-tree gradients
  at 1e-9, batched lazy candidates at 1e-10 (also from the `-S` pool),
  thorough lnLs at 1e-10 and their branch triplets at 1e-8, `-f q` rows
  at 1e-10, one pinned lazy SPR cycle with the same topology, and one PSR
  categorization round with the same categories (rates at 1e-9);
* an AUTO partition through the whole-read path (the same choice);
* both ranks end with identical results and issue the same number of
  collectives, and a gloo group of one gives the no-group results bit
  for bit.

Through the CLI, on an 8-taxon alignment: `-f e` and `-f d -i 2` over two
ranks end as the one-process CLI (same tree, lnL at rtol 1e-10); only
rank 0 writes run files; a checkpoint written at two ranks restores with
`-R` at one and the other way round; a rank that raises, and a group
that cannot form, end the run with a non-zero exit within seconds.
"""

import glob
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.bytefile import read_bytefile as jread_bytefile
from tests.refmodel import install_reference_params, parse_model_file
from tests.test_torch_cli import _inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF49 = os.path.join(REPO, "tests", "fixtures", "ref49")
PROC_TIMEOUT = 420            # seconds, per spawned rank

# One rank (or the one process) of a run.  argv: rank, size, port, task,
# argument; size "1g" is a gloo group of one.  Prints "RESULT {json}".
WORKER = r'''
import json, sys, time
rank, size, port, task, arg = sys.argv[1:6]
rank = int(rank)
import numpy as np
import torch
torch.set_num_threads(1)

if task in ("cli", "cli_short_timeout"):
    from examl_tpu_torch.cli.main import main
    if task == "cli_short_timeout":
        from examl_tpu_torch.parallel import launch
        launch.GROUP_TIMEOUT_MINUTES = 0.1
    t0 = time.time()
    rc = main(json.loads(arg), device="cpu")
    print("RESULT " + json.dumps({"rc": rc, "s": time.time() - t0}))
    sys.exit(rc)

from examl_tpu_torch.parallel.sharding import SINGLE, SiteGroup
if size == "1":
    group, n = SINGLE, 1
else:
    import torch.distributed as dist
    n = 1 if size == "1g" else int(size)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    group = SiteGroup(rank, n, dist.group.WORLD)

from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.bytefile import (read_bytefile,
                                         read_bytefile_for_process)
from examl_tpu_torch.search import batchscan, spr
from examl_tpu_torch.transfer import install_model_params, install_psr_state
from tests.refmodel import parse_model_file

REF49 = "tests/fixtures/ref49/"


def instance(path, sliced=True, **kw):
    if n > 1 and sliced:
        return PhyloInstance(read_bytefile_for_process(path, rank, n),
                             dtype=torch.float64, device="cpu",
                             local_window=(rank, n), group=group, **kw)
    return PhyloInstance(read_bytefile(path), dtype=torch.float64,
                         device="cpu", group=group, **kw)


def ref49(**kw):
    inst = instance(REF49 + "aln49.binary", **kw)
    install_model_params(inst, [(p.rates, p.freqs, p.alpha) for p in
                                parse_model_file(REF49 + "modelFile")])
    text = open(REF49 + "TreeFile").read()

    def tree():
        t = inst.tree_from_newick(text)
        inst.evaluate(t, full=True)
        return t
    return inst, tree


def pruned_plan(inst, tree, thorough, maxtrav):
    ctx = spr.SprContext(inst, thorough=thorough, do_cutoff=False)
    p = next(tree.nodep[k] for k in tree.inner_numbers()
             if not tree.is_tip(tree.nodep[k].next.back.number)
             and not tree.is_tip(tree.nodep[k].next.next.back.number))
    q1, q2 = p.next.back, p.next.next.back
    spr.remove_node(inst, tree, ctx, p)
    return batchscan.plan_for_endpoints(inst, tree, p, q1, q2, 1, maxtrav)


def psr_state(inst):
    rng = np.random.default_rng(5)
    cats, rates = [], []
    for part in inst.alignment.partitions:
        W = part.global_width if part.global_width is not None \
            else part.width
        cats.append(rng.integers(0, 4, W))
        rates.append(rng.uniform(0.3, 2.5, 4))
    return [r[c] for r, c in zip(rates, cats)], cats, rates


out = {}
checks = arg.split(",")
if task == "gamma":
    inst, mk = ref49()
    tree = mk()
    out["pp"] = inst.per_partition_lnl.tolist()
    p = tree.nodep[tree.ntips + 3]
    inst.new_view(tree, p)
    inst.new_view(tree, p.back)
    (eng,) = inst.engines.values()
    st = eng.make_sumtable(p.number, p.back.number)
    out["d"] = np.stack(eng.branch_derivatives(st, p.z)).tolist()
    q = tree.nodep[5]
    out["nr"] = inst.makenewz(tree, q, q.back, [0.3], maxiter=16).tolist()
    from examl_tpu_torch.optimize.branch import tree_gradients
    out["grad"] = np.stack(tree_gradients(inst, tree)[1:]).tolist()
    out["lazy"] = batchscan.run_plan(
        inst, (t := mk()), pruned_plan(inst, t, False, 5)).tolist()
    if "thorough" in checks:
        lnls, es = batchscan.run_plan_thorough(
            inst, (t := mk()), pruned_plan(inst, t, True, 3))
        out["thorough"] = lnls.tolist()
        out["triplets"] = np.asarray(es).tolist()
    if "fq" in checks:
        from examl_tpu_torch.search import quartets_batch as qb
        jobs = [j for s in ((1, 2, 3, 4), (5, 17, 30, 41), (2, 9, 33, 48))
                for j in qb.three_topology_jobs(*s)]
        out["fq"] = qb.score_jobs(inst, jobs).tolist()
    if "spr" in checks:
        from examl_tpu_torch.search.raxml_search import tree_optimize_rapid
        from examl_tpu_torch.search.snapshots import BestList, InfoList
        tree = mk()
        tree_optimize_rapid(inst, tree, spr.SprContext(inst), 1, 1,
                            BestList(20), None, InfoList(50))
        out["spr_lnl"] = inst.evaluate(tree, full=True)
        out["spr_tree"] = tree.to_newick(inst.alignment.taxon_names,
                                         with_lengths=False)
elif task == "psr":
    from examl_tpu_torch.optimize.psr import optimize_rate_categories
    inst, mk = ref49(rate_model="PSR")
    install_psr_state(inst, *psr_state(inst))
    tree = mk()
    out["pp"] = inst.per_partition_lnl.tolist()
    out["round"] = optimize_rate_categories(inst, tree)
    out["cats"] = [c.tolist() for c in inst.rate_category]
    out["rates"] = [r.tolist() for r in inst.per_site_rates]
elif task == "sev":
    inst, mk = ref49(save_memory=True)
    out["pp"] = (mk(), inst.per_partition_lnl.tolist())[1]
    out["lazy"] = batchscan.run_plan(
        inst, (t := mk()), pruned_plan(inst, t, False, 5)).tolist()
elif task == "auto":
    from examl_tpu_torch.models import protein
    from examl_tpu_torch.optimize.auto_protein import auto_protein
    from examl_tpu_torch.optimize.branch import tree_evaluate
    protein.AUTO_CANDIDATES = ["WAG", "LG", "JTT", "DAYHOFF"]
    inst = instance(arg, sliced=False)
    tree = inst.random_tree(2)
    tree_evaluate(inst, tree, 1.0)
    auto_protein(inst, tree, "bic")
    out["auto"] = [inst.auto_prot_models[0], inst.auto_prot_freqs[0]]
    out["lnl"] = inst.likelihood
    out["blocks"] = [b.local_num_blocks for b in inst.buckets.values()]
out["collectives"] = group.collectives
if group is not SINGLE:
    from examl_tpu_torch.parallel import launch
    launch.shutdown(group)
print("RESULT " + json.dumps(out))
'''


_PORTS = set()
# Rendezvous ports come from below the kernel's usual ephemeral range
# (32768-60999), so that no client socket of the many gloo connections
# these runs open can take one before its rank 0 listens on it.
_PORT_RANGE = (20000, 32000)


def _free_port() -> int:
    """A free port not handed out before in this process (two runs on one
    port would join each other's group)."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(*_PORT_RANGE))
        if port in _PORTS:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS.add(port)
        return port


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(runs):
    """Start every process of every run at once; runs maps a name to a
    list of worker argument lists."""
    return {name: [(time.time(), subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r[0]), str(r[1]), str(r[2]),
         r[3], r[4]], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for r in ranks]
        for name, ranks in runs.items()}


def _collect(procs, timeout=PROC_TIMEOUT):
    """name -> [(rc, result or None, stderr, seconds)] in rank order; a
    process still running at its timeout is killed."""
    out = {}
    try:
        for name, ps in procs.items():
            out[name] = []
            for t0, p in ps:
                o, e = p.communicate(
                    timeout=max(timeout - (time.time() - t0), 1))
                res = [json.loads(line[7:]) for line in o.splitlines()
                       if line.startswith("RESULT ")]
                out[name].append((p.returncode, res[0] if res else None, e,
                                  time.time() - t0))
    finally:
        for ps in procs.values():
            for _, p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def _results(runs, name):
    """The results of a run whose processes all ended with 0."""
    for rc, res, err, _ in runs[name]:
        assert rc == 0 and res is not None, f"{name}: rc {rc}\n{err[-3000:]}"
    return [res for _, res, _, _ in runs[name]]


def _pair(name, task, arg):
    """A run of two ranks and the one-process run of the same task."""
    port = _free_port()
    return {name: [(0, 2, port, task, arg), (1, 2, port, task, arg)],
            name + "1": [(0, 1, 0, task, arg)]}


def _jax_ref49(psr_state=None):
    """JAX's single-process per-partition lnL on ref49 (float64), under
    the reference's models, with `psr_state` installed under PSR."""
    params = parse_model_file(os.path.join(REF49, "modelFile"))
    inst = JaxInstance(jread_bytefile(os.path.join(REF49, "aln49.binary")),
                       dtype=jnp.float64,
                       rate_model="PSR" if psr_state else "GAMMA")
    install_reference_params(inst, params)
    if psr_state:
        inst.patrat, inst.rate_category, inst.per_site_rates = psr_state
        inst.push_site_rates()
    with open(os.path.join(REF49, "TreeFile")) as f:
        inst.evaluate(inst.tree_from_newick(f.read()), full=True)
    return np.asarray(inst.per_partition_lnl)


def _psr_state():
    """The worker's fixed PSR state (`psr_state` there)."""
    from examl_tpu_torch.io.bytefile import read_bytefile
    rng = np.random.default_rng(5)
    cats, rates = [], []
    for part in read_bytefile(os.path.join(REF49, "aln49.binary")).partitions:
        cats.append(rng.integers(0, 4, part.width).astype(np.int32))
        rates.append(rng.uniform(0.3, 2.5, 4))
    return [r[c] for r, c in zip(rates, cats)], cats, rates


@pytest.fixture(scope="module")
def auto_file(tmp_path_factory):
    """An 8-taxon amino-acid byteFile with one AUTO partition."""
    from examl_tpu_torch.io.alignment import build_alignment_data
    from examl_tpu_torch.io.bytefile import write_bytefile
    from examl_tpu_torch.io.partitions import PartitionSpec
    aa = "ARNDCQEGHILKMFPSTWYV"
    rng = np.random.default_rng(11)
    W = 300
    cur = rng.integers(0, 20, W)
    seqs = []
    for _ in range(8):
        cur = np.where(rng.random(W) < 0.3, rng.integers(0, 20, W), cur)
        seqs.append("".join(aa[c] for c in cur))
    path = str(tmp_path_factory.mktemp("auto") / "auto.binary")
    write_bytefile(path, build_alignment_data(
        [f"t{i}" for i in range(8)], seqs,
        [PartitionSpec(name="p1", datatype_name="AA", model_name="AUTO",
                       sites=np.arange(W), auto=True)]))
    return path


def _ref49_runs(auto_file):
    """Every ref49 run: two ranks, and one process."""
    runs = {}
    runs.update(_pair("gamma", "gamma", "thorough,fq,spr"))
    runs["gamma1g"] = [(0, "1g", _free_port(), "gamma", "")]
    runs.update(_pair("psr", "psr", ""))
    runs.update(_pair("sev", "sev", ""))
    runs.update(_pair("auto", "auto", auto_file))
    return runs


def _ranks_agree(runs, name):
    """The two ranks' results (collective counts included) are identical;
    returns rank 0's and the one process's."""
    r0, r1 = _results(runs, name)
    assert r0 == r1
    assert r0["collectives"] > 0
    (one,) = _results(runs, name + "1")
    assert one["collectives"] == 0
    return r0, one


def test_gamma_lnl_matches_jax_and_one_process(ref49_runs):
    runs, jax = ref49_runs
    two, one = _ranks_agree(runs, "gamma")
    np.testing.assert_allclose(two["pp"], jax["gamma"], rtol=1e-10)
    np.testing.assert_allclose(two["pp"], one["pp"], rtol=1e-12)


@pytest.mark.parametrize("key,rtol", [("d", 1e-9), ("nr", 1e-10),
                                      ("grad", 1e-9), ("lazy", 1e-10),
                                      ("thorough", 1e-10),
                                      ("triplets", 1e-8), ("fq", 1e-10)])
def test_gamma_site_sums_match_one_process(ref49_runs, key, rtol):
    runs, _ = ref49_runs
    two, one = _ranks_agree(runs, "gamma")
    np.testing.assert_allclose(two[key], one[key], rtol=rtol)


def test_pinned_spr_cycle_same_topology(ref49_runs):
    runs, _ = ref49_runs
    two, one = _ranks_agree(runs, "gamma")
    assert two["spr_tree"] == one["spr_tree"]
    assert two["spr_lnl"] == pytest.approx(one["spr_lnl"], rel=1e-10)


def test_group_of_one_is_bitwise_the_no_group_path(ref49_runs):
    runs, _ = ref49_runs
    (g1,) = _results(runs, "gamma1g")
    (one,) = _results(runs, "gamma1")
    assert g1["collectives"] == 0
    for key in ("pp", "d", "nr", "grad", "lazy"):
        assert g1[key] == one[key], key


def test_psr_matches_jax_and_one_process(ref49_runs):
    runs, jax = ref49_runs
    two, one = _ranks_agree(runs, "psr")
    np.testing.assert_allclose(two["pp"], jax["psr"], rtol=1e-10)
    np.testing.assert_allclose(two["pp"], one["pp"], rtol=1e-12)
    assert two["cats"] == one["cats"]
    for a, b in zip(two["rates"], one["rates"]):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    assert two["round"] == pytest.approx(one["round"], rel=1e-10)


def test_sev_pool_matches_jax_and_dense(ref49_runs):
    runs, jax = ref49_runs
    two, one = _ranks_agree(runs, "sev")
    np.testing.assert_allclose(two["pp"], jax["gamma"], rtol=1e-10)
    (dense,) = _results(runs, "gamma1")
    np.testing.assert_allclose(two["lazy"], dense["lazy"], rtol=1e-10)
    np.testing.assert_allclose(two["lazy"], one["lazy"], rtol=1e-10)


def test_auto_through_the_whole_read(ref49_runs):
    runs, _ = ref49_runs
    two, one = _ranks_agree(runs, "auto")
    assert two["auto"] == one["auto"]
    assert two["lnl"] == pytest.approx(one["lnl"], rel=1e-10)
    # Each rank holds half of the block count padded to a multiple of 2.
    assert two["blocks"][0] == -(-one["blocks"][0] // 2)


# -- through the CLI ----------------------------------------------------------


def _cli_ranks(name, argv, nprocs, rank_argv=None, task="cli"):
    """{name: [...]}: `argv` run as `nprocs` ranks (launch flags added;
    rank_argv replaces a rank's argv), or as one process for nprocs 0."""
    if nprocs == 0:
        return {name: [(0, 1, 0, task, json.dumps(argv))]}
    port = _free_port()
    return {name: [(r, nprocs, port, task, json.dumps(
        (rank_argv or {}).get(r, argv) + [
            "--coordinator", f"127.0.0.1:{port}", "--nprocs", str(nprocs),
            "--procid", str(r)])) for r in range(nprocs)]}


def _final(workdir, run_id):
    with open(os.path.join(workdir, f"ExaML_info.{run_id}")) as f:
        info = f.read()
    return info, [float(x) for x in re.findall(
        r"(?:Likelihood of best tree|Likelihood tree \d+): (\S+)", info)]


def _ckpts(workdir):
    return sorted(int(re.search(r"ckpt_(\d+)", p).group(1))
                  for p in glob.glob(os.path.join(
                      workdir, "ExaML_binaryCheckpoint.*.ckpt_*.json.gz")))


def _cli_runs(tmp):
    """The CLI runs' work dirs, the runs, and the -R runs across world
    sizes to start once the searches ended (from a middle checkpoint of
    each, `_restart_runs`)."""
    aln, trees = _inputs(tmp)
    base = {m: ["-s", aln, "-t", trees, "-n", "R", "-f", m]
            for m in ("e", "d", "q")}
    base["d"] += ["-i", "2"]
    base["q"] += ["-r", "12"]
    w = {k: str(tmp / k) for k in ("e2", "e1", "d2", "d1", "q2", "q1",
                                   "raise", "nogroup", "r21", "r12")}
    runs = {}
    for m in ("e", "d", "q"):
        runs.update(_cli_ranks(m + "2", base[m] + ["-w", w[m + "2"]], 2))
        runs.update(_cli_ranks(m + "1", base[m] + ["-w", w[m + "1"]], 0))
    # Rank 1 raises (its tree file is missing) while rank 0 waits in a
    # collective.
    good = base["e"] + ["-w", w["raise"]]
    bad = list(good)
    bad[bad.index("-t") + 1] = "/nonexistent/trees.nwk"
    runs.update(_cli_ranks("raise", good, 2, {1: bad}))
    # A group that cannot form: one rank of two, with the rendezvous
    # timeout cut to seconds.
    runs.update({"nogroup": _cli_ranks(
        "nogroup", base["e"] + ["-w", w["nogroup"]], 2,
        task="cli_short_timeout")["nogroup"][:1]})
    restart = ["-s", aln, "-n", "R", "-i", "2", "-R"]
    return w, runs, restart


def _restart_runs(w, restart):
    runs = {}
    for src, dst, n in (("d2", "r21", 0), ("d1", "r12", 2)):
        shutil.copytree(w[src], w[dst])
        ck = _ckpts(w[dst])
        for k in ck[len(ck) // 2 + 1:]:
            os.remove(os.path.join(
                w[dst], f"ExaML_binaryCheckpoint.R.ckpt_{k}.json.gz"))
        runs.update(_cli_ranks(dst, restart + ["-w", w[dst]], n))
    return runs


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory, auto_file):
    """Every run of this file started at once, JAX's values computed
    meanwhile, then the -R runs."""
    w, cli, restart = _cli_runs(tmp_path_factory.mktemp("cli"))
    procs = _start({**_ref49_runs(auto_file), **cli})
    jax = {"gamma": _jax_ref49(), "psr": _jax_ref49(_psr_state())}
    runs = _collect(procs)
    runs.update(_collect(_start(_restart_runs(w, restart))))
    return runs, jax, w


@pytest.fixture(scope="module")
def ref49_runs(all_runs):
    return all_runs[:2]


@pytest.fixture(scope="module")
def cli_runs(all_runs):
    return all_runs[0], all_runs[2]


def test_cli_two_ranks_match_one_process(cli_runs):
    runs, w = cli_runs
    for m in ("e", "d"):
        _results(runs, m + "2")
        _results(runs, m + "1")
        info2, l2 = _final(w[m + "2"], "R")
        _, l1 = _final(w[m + "1"], "R")
        assert "site-parallel: 2 ranks" in info2
        assert "loads only its site blocks" in info2
        np.testing.assert_allclose(l2, l1, rtol=1e-10)
        kind = "TreeFile" if m == "e" else "result"
        tree2, tree1 = (open(os.path.join(w[m + k], f"ExaML_{kind}.R"))
                        .read() for k in "21")
        strip = re.compile(r":[0-9.e+-]+")
        assert strip.sub("", tree2) == strip.sub("", tree1)


def test_cli_quartets_two_ranks_match_one_process(cli_runs):
    runs, w = cli_runs
    _results(runs, "q2")
    _results(runs, "q1")
    rows = []
    for k in "21":
        with open(os.path.join(w["q" + k], "ExaML_quartets.R")) as f:
            rows.append([line.rsplit(":", 1) for line in f
                         if " | " in line])
    assert len(rows[0]) == 36
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
    np.testing.assert_allclose([float(r[1]) for r in rows[0]],
                               [float(r[1]) for r in rows[1]], rtol=1e-10)


def test_cli_only_rank0_writes(cli_runs):
    runs, w = cli_runs
    written = {"e": ("info", "log", "modelFile", "TreeFile"),
               "d": ("info", "log", "modelFile", "result"),
               "q": ("info", "log", "quartets")}
    for m, names in written.items():
        assert runs[m + "2"][1][0] == 0
        shared = set(os.listdir(w[m + "2"]))
        assert {f"ExaML_{k}.R" for k in names} <= shared
        if m != "q":
            assert any(f.startswith("ExaML_binaryCheckpoint.R.")
                       for f in shared)
        proc1 = os.path.join(w[m + "2"], ".proc1")
        assert os.path.isdir(proc1)
        assert [f for f in os.listdir(proc1) if f.startswith("ExaML_")
                and not f.startswith("ExaML_binaryCheckpoint.")] == []


def test_cli_checkpoint_restores_across_world_sizes(cli_runs):
    runs, w = cli_runs
    for src, dst in (("d2", "r21"), ("d1", "r12")):
        _results(runs, dst)
        info, lnls = _final(w[dst], "R")
        assert "restart from state" in info
        _, cont = _final(w[src], "R")
        assert lnls[-1] == pytest.approx(cont[-1], rel=1e-10)


def test_cli_failed_rank_ends_the_run(cli_runs):
    runs, _ = cli_runs
    for name in ("raise", "nogroup"):
        for rc, res, err, seconds in runs[name]:
            assert rc != 0 and res is None, (name, err[-2000:])
            assert seconds < PROC_TIMEOUT
    assert "nonexistent" in runs["raise"][1][2]
