"""The port's SEV memory saving (`-S`) against the JAX package's (float64 on
the CPU).

Both packages build their trees from one newick text (slot order follows
build order), so the same traversal sequence allocates the same pool cells
in both.

* host bookkeeping: full traversal -> NNI -> partial traversal -> scan
  region leaves equal `cell_of`, gap bits, free lists, `next_cell`, slot
  maps and `stats()` in both packages;
* the pooled full traversal: lnL at rtol 1e-10 of JAX's `-S`, at rel
  1e-12 / abs 1e-8 of the port's dense engine (JAX `test_sev.py`'s
  bound), every data cell of the pool at rtol 1e-12 of JAX's with equal
  scalers, a saving above 0.2; no kernel tier is taken;
* partial traversals and Newton-Raphson (z rtol 1e-10); a topology
  change reallocates and still matches;
* the batched lazy scan and the batched thorough arm over the pool:
  candidate lnLs at rtol 1e-10 of JAX's `-S` batched scan and of the
  port's dense batched scan, the scan region carved from the pool;
* PSR under `-S`: one categorization round equals JAX's (categories
  equal, rates rtol 1e-9) with rate-scan grid chunks of at most 2;
* smoothing under `-S` takes the per-branch route (no gradient pass)
  and ends at JAX's endpoint (rel 1e-9);
* the CLI: `-S -f e`, `-S -f d -i 2` and `-f q -S` end where the JAX CLI
  ends, with the same SEV lines; `-R -S` restores across the packages
  both ways; `--newview whole -S` is refused;
* on the card (marked cuda): the pooled traversal in f64 equals the
  CPU's.
"""

import gzip
import json
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.bytefile import write_bytefile
from examl_tpu_torch.io.partitions import parse_partition_file
from examl_tpu_torch.ops import engine
from examl_tpu_torch.ops.sev import SCRATCH_CELL
from examl_tpu_torch.optimize import branch
from examl_tpu_torch.search import batchscan, spr
from examl_tpu_torch.tree.topology import hookup

GRAD_REASON = "-S SEV pools keep the per-branch Newton path"


def _jax():
    """The JAX package's modules, imported inside the tests that use them:
    the card's machine, which runs the cuda case, has no JAX."""
    import jax.numpy as jnp
    from examl_tpu.cli.main import main as jmain
    from examl_tpu.instance import PhyloInstance as Instance
    from examl_tpu.io.alignment import build_alignment_data as build
    from examl_tpu.io.partitions import parse_partition_file as parse
    from examl_tpu.optimize import branch as jbranch
    from examl_tpu.optimize.psr import optimize_rate_categories
    from examl_tpu.search import batchscan as jbatchscan
    from examl_tpu.search import checkpoint as jcheckpoint
    from examl_tpu.search import spr as jspr
    return SimpleNamespace(jnp=jnp, main=jmain, Instance=Instance,
                           build=build, parse=parse, branch=jbranch,
                           optimize_psr=optimize_rate_categories,
                           batchscan=jbatchscan, checkpoint=jcheckpoint,
                           spr=jspr)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """One torch intra-op thread (the suite runs on several xdist workers
    at once) and no route switch inherited by the JAX side."""
    for var in ("EXAML_BATCH_SCAN", "EXAML_BATCH_THOROUGH",
                "EXAML_GRAD_SMOOTH"):
        monkeypatch.delenv(var, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gappy_alignment(ntaxa=24, genes=3, gene_sites=384, seed=0):
    """Concatenation of `genes` genes; gene g covers only the taxa of its
    share of the taxon set, everyone else is all gap there (the JAX
    package's tests/test_sev.py fixture)."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    per = ntaxa // genes
    seqs = ["" for _ in range(ntaxa)]
    parts = []
    pos = 1
    for g in range(genes):
        covered = range(g * per, (g + 1) * per)
        for i in range(ntaxa):
            if i in covered:
                seqs[i] += "".join("ACGT"[b]
                                   for b in rng.integers(0, 4, gene_sites))
            else:
                seqs[i] += "-" * gene_sites
        parts.append(f"DNA, gene{g} = {pos}-{pos + gene_sites - 1}")
        pos += gene_sites
    return names, seqs, "\n".join(parts)


def _gappy(tmp_path_factory, **kw):
    names, seqs, text = _gappy_alignment(**kw)
    path = tmp_path_factory.mktemp("sev") / "parts.model"
    path.write_text(text + "\n")
    return SimpleNamespace(names=names, seqs=seqs, model=str(path))


@pytest.fixture(scope="module")
def gappy(tmp_path_factory):
    """24 taxa, 3 genes of 384 columns (JAX test_sev.py's fixture)."""
    return _gappy(tmp_path_factory)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """12 taxa, 2 genes of 128 columns (JAX test_sev.py's sharded-test
    fixture): the batched scans, PSR and the CLI in seconds."""
    return _gappy(tmp_path_factory, ntaxa=12, genes=2, gene_sites=128,
                  seed=5)


def _port(data, device="cpu", **kw):
    ad = build_alignment_data(data.names, data.seqs,
                              specs=parse_partition_file(data.model))
    return PhyloInstance(ad, dtype=torch.float64, device=device,
                         grad_smooth=False, **kw)


def _jax_inst(data, **kw):
    J = _jax()
    ad = J.build(data.names, data.seqs, specs=J.parse(data.model))
    return J.Instance(ad, dtype=J.jnp.float64, **kw)


def _newick(data, seed):
    return _jax_inst(data).random_tree(seed).to_newick(data.names)


def _eng(inst):
    (eng,) = inst.engines.values()
    return eng


def _assert_same_state(tsev, jsev):
    """Equal host bookkeeping and slot maps."""
    np.testing.assert_array_equal(tsev.cell_of, jsev.cell_of)
    np.testing.assert_array_equal(tsev.node_gap, jsev.node_gap)
    np.testing.assert_array_equal(tsev.tip_gap, jsev.tip_gap)
    assert tsev.free == jsev.free
    assert tsev.next_cell == jsev.next_cell
    assert tsev.num_rows == jsev.num_rows
    np.testing.assert_array_equal(tsev.slot_read.cpu().numpy(),
                                  np.asarray(jsev.slot_read))
    np.testing.assert_array_equal(tsev.slot_write.cpu().numpy(),
                                  np.asarray(jsev.slot_write))
    assert tsev.stats() == jsev.stats()


def _hookup(tree):
    """The hookup of the tree's own package (the JAX package's bumps the
    topology clock its traversal cache is validated against)."""
    return sys.modules[type(tree).__module__].hookup


def _nni(tree):
    """Swap two subtrees across the first inner branch (JAX
    test_sev.py's NNI)."""
    hookup = _hookup(tree)
    for p, q in tree.all_branches():
        if tree.is_tip(p.number) or tree.is_tip(q.number):
            continue
        a, b = p.next.back, q.next.back
        az, bz = list(a.z), list(b.z)
        hookup(p.next, b, bz)
        hookup(q.next, a, az)
        return


# -- the pool ----------------------------------------------------------------


def test_host_bookkeeping_matches_jax(gappy):
    """full traversal -> NNI -> partial traversal -> scan region."""
    tinst = _port(gappy, save_memory=True)
    jinst = _jax_inst(gappy, save_memory=True)
    newick = _newick(gappy, 11)
    trees = [inst.tree_from_newick(newick) for inst in (tinst, jinst)]
    tsev, jsev = _eng(tinst).sev, _eng(jinst).sev
    for inst, tree in zip((tinst, jinst), trees):
        inst.evaluate(tree, full=True)
    _assert_same_state(tsev, jsev)
    for inst, tree in zip((tinst, jinst), trees):
        _nni(tree)
        inst.evaluate(tree, tree.nodep[tree.ntips + 2])
    _assert_same_state(tsev, jsev)
    assert tsev.free or tsev.stats()["allocated_cells"] > 0
    assert _eng(tinst).ensure_scan_rows(5) == \
        _eng(jinst).ensure_scan_rows(5)
    _assert_same_state(tsev, jsev)
    assert _eng(tinst).scaler.shape[0] == tsev.num_rows


def test_full_traversal_matches_jax_and_dense(gappy):
    tinst = _port(gappy, save_memory=True)
    dense = _port(gappy)
    jinst = _jax_inst(gappy, save_memory=True)
    newick = _newick(gappy, 7)
    eng = _eng(tinst)
    assert eng.newview == engine.POOLED_TIER and eng.clv is None
    engine.POOLED_TRAVERSALS = engine.FULL_TRAVERSALS = 0
    lnl = tinst.evaluate(tinst.tree_from_newick(newick), full=True)
    assert (engine.POOLED_TRAVERSALS, engine.FULL_TRAVERSALS) == (1, 0)
    jl = jinst.evaluate(jinst.tree_from_newick(newick), full=True)
    dl = dense.evaluate(dense.tree_from_newick(newick), full=True)
    assert lnl == pytest.approx(jl, rel=1e-10)
    assert lnl == pytest.approx(dl, rel=1e-12, abs=1e-8)
    tsev, jsev = eng.sev, _eng(jinst).sev
    _assert_same_state(tsev, jsev)
    # Every cell but the scratch cell (whose content is never read).
    n = tsev.next_cell[0]
    cells = np.arange(n) != SCRATCH_CELL
    np.testing.assert_allclose(tsev.pool.numpy()[:n][cells],
                               np.asarray(jsev.pool)[:n][cells],
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(eng.scaler.numpy(),
                                  np.asarray(_eng(jinst).scaler))
    st = tsev.stats()
    assert st["allocated_cells"] < st["dense_cells"]
    assert st["saving_ratio"] > 0.2, st


def test_partial_traversals_and_newton(gappy):
    """JAX test_sev.py's partial-traversal and Newton case, on both
    packages' pools and the port's dense engine."""
    insts = [_port(gappy, save_memory=True), _jax_inst(gappy,
                                                       save_memory=True),
             _port(gappy)]
    newick = _newick(gappy, 3)
    trees = [inst.tree_from_newick(newick) for inst in insts]
    lnls, zs = [], []
    for inst, tree in zip(insts, trees):
        inst.evaluate(tree, full=True)
        p = tree.nodep[tree.ntips + 2]
        _hookup(tree)(p, p.back, [0.5] * len(p.z))
        lnls.append(inst.evaluate(tree, tree.nodep[tree.ntips + 2]))
        q = tree.nodep[5]
        zs.append(np.asarray(inst.makenewz(tree, q, q.back, q.z,
                                           maxiter=16), np.float64))
    assert lnls[0] == pytest.approx(lnls[1], rel=1e-10)
    assert lnls[0] == pytest.approx(lnls[2], rel=1e-12, abs=1e-8)
    np.testing.assert_allclose(zs[0], zs[1], rtol=1e-10)
    np.testing.assert_allclose(zs[0], zs[2], rtol=1e-10)
    _assert_same_state(_eng(insts[0]).sev, _eng(insts[1]).sev)


def test_topology_change_reallocates(gappy):
    insts = [_port(gappy, save_memory=True), _jax_inst(gappy,
                                                       save_memory=True),
             _port(gappy)]
    newick = _newick(gappy, 11)
    lnls = []
    for inst in insts:
        tree = inst.tree_from_newick(newick)
        inst.evaluate(tree, full=True)
        _nni(tree)
        lnls.append(inst.evaluate(tree, full=True))
    assert lnls[0] == pytest.approx(lnls[1], rel=1e-10)
    assert lnls[0] == pytest.approx(lnls[2], rel=1e-12, abs=1e-8)
    _assert_same_state(_eng(insts[0]).sev, _eng(insts[1]).sev)


# -- the batched SPR scan over the pool --------------------------------------


def _centroid_plan(mod_spr, mod_scan, inst, tree, thorough, maxtrav):
    ctx = mod_spr.SprContext(inst, thorough=thorough, do_cutoff=False)
    c = tree.centroid_branch()
    p = c if not tree.is_tip(c.number) else c.back
    q1, q2 = p.next.back, p.next.next.back
    mod_spr.remove_node(inst, tree, ctx, p)
    plan = mod_scan.plan_for_endpoints(inst, tree, p, q1, q2, 1, maxtrav)
    assert plan is not None and plan.candidates
    return plan


@pytest.mark.parametrize("thorough", [False, True],
                         ids=["lazy", "thorough"])
def test_batched_scan_over_pool_matches_jax(small, thorough):
    """Candidate lnLs (and the thorough arm's smoothed triplets) of one
    pruned node against JAX's -S batched scan and the port's dense
    batched scan."""
    J = _jax()
    newick = _newick(small, 3)
    maxtrav = 3 if thorough else 5
    tinst = _port(small, save_memory=True)
    dense = _port(small)
    jinst = _jax_inst(small, save_memory=True)
    out = []
    for inst, mod_spr, mod_scan in ((tinst, spr, batchscan),
                                    (dense, spr, batchscan),
                                    (jinst, J.spr, J.batchscan)):
        tree = inst.tree_from_newick(newick)
        inst.evaluate(tree, full=True)
        plan = _centroid_plan(mod_spr, mod_scan, inst, tree, thorough,
                              maxtrav)
        run = mod_scan.run_plan_thorough if thorough else mod_scan.run_plan
        res = run(inst, tree, plan)
        out.append(res if thorough else (res, None))
    (tl, te), (dl, de), (jl, je) = out
    assert len(tl) >= 3
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    np.testing.assert_allclose(tl, dl, rtol=1e-10)
    if thorough:
        np.testing.assert_allclose(te, je, rtol=1e-8)
        np.testing.assert_allclose(te, de, rtol=1e-8)
    tsev, jsev = _eng(tinst).sev, _eng(jinst).sev
    _assert_same_state(tsev, jsev)
    assert tsev.scan_cap > 0


def test_route_gates_under_sev(small):
    """-S keeps the CPU's sequential default and follows batch_scan= like
    the dense engine; the quartet scorer is sequential; the gradient route
    is ineligible with its reason; a kernel tier is refused."""
    inst = _port(small, save_memory=True)
    assert not spr.batched_scan_enabled(inst)
    assert spr.batched_scan_enabled(_port(small, save_memory=True,
                                          batch_scan=True))
    from examl_tpu_torch.search import quartets_batch
    assert not quartets_batch.batch_eligible(inst)
    assert quartets_batch.batch_eligible(_port(small))
    assert branch.grad_smooth_ineligible(inst) == GRAD_REASON
    assert branch.grad_smooth_ineligible(_port(small)) is None
    for tier in ("whole", "chunk"):
        with pytest.raises(ValueError, match="no pooled form"):
            _port(small, save_memory=True, newview=tier)
    with pytest.raises(RuntimeError, match="dense arena"):
        tree = inst.random_tree(1)
        flat = tree.flat_full_traversal(tree.centroid_branch())
        _eng(inst).whole_tree_gradients(flat, [0.9])


# -- PSR and smoothing -------------------------------------------------------


def test_psr_round_matches_jax(small, monkeypatch):
    from examl_tpu_torch.optimize.psr import optimize_rate_categories
    J = _jax()
    newick = _newick(small, 9)
    tinst = _port(small, save_memory=True, rate_model="PSR")
    jinst = _jax_inst(small, save_memory=True, rate_model="PSR")
    grids = []
    eng = _eng(tinst)
    scan = eng.rate_scan

    def spy(entries, p, q, z, grid):
        grids.append(grid.shape[2])
        return scan(entries, p, q, z, grid)

    monkeypatch.setattr(eng, "rate_scan", spy)
    ttree = tinst.tree_from_newick(newick)
    jtree = jinst.tree_from_newick(newick)
    tinst.evaluate(ttree, full=True)
    jinst.evaluate(jtree, full=True)
    tl = optimize_rate_categories(tinst, ttree)
    jl = J.optimize_psr(jinst, jtree)
    assert tl == pytest.approx(jl, rel=1e-10)
    assert max(grids) == 2
    for g in range(len(tinst.per_site_rates)):
        np.testing.assert_array_equal(tinst.rate_category[g],
                                      np.asarray(jinst.rate_category[g]))
        np.testing.assert_allclose(tinst.per_site_rates[g],
                                   jinst.per_site_rates[g], rtol=1e-9)


def test_smoothing_takes_per_branch_route(gappy, monkeypatch):
    """grad_smooth=True (the default route) under -S smooths branch by
    branch: no gradient pass runs, and the endpoint is JAX's -S one (its
    default route, which declines the gradient pass the same way)."""
    J = _jax()
    ad = build_alignment_data(gappy.names, gappy.seqs,
                              specs=parse_partition_file(gappy.model))
    tinst = PhyloInstance(ad, dtype=torch.float64, device="cpu",
                          save_memory=True)
    assert tinst.grad_smooth
    jinst = _jax_inst(gappy, save_memory=True)
    assert J.branch.grad_smooth_ineligible(jinst) == GRAD_REASON
    newick = _newick(gappy, 5)
    ttree = tinst.tree_from_newick(newick)
    jtree = jinst.tree_from_newick(newick)

    def no_pass(*a, **k):
        raise AssertionError("gradient pass under -S")

    monkeypatch.setattr(branch, "tree_gradients", no_pass)
    engine.GRAD_PASSES = 0
    branch.smooth_tree(tinst, ttree, 2)
    J.branch.smooth_tree(jinst, jtree, 2)
    assert engine.GRAD_PASSES == 0 and branch.GRAD_SWEEPS >= 0
    tl = tinst.evaluate(ttree, full=True)
    jl = jinst.evaluate(jtree, full=True)
    assert tl == pytest.approx(jl, rel=1e-9)


# -- the CLI -----------------------------------------------------------------


def _last_ckpt(workdir, run):
    """(state, likelihood) of a run's newest checkpoint."""
    files = [f for f in os.listdir(workdir)
             if f.startswith(f"ExaML_binaryCheckpoint.{run}.ckpt_")
             and f.endswith(".json.gz")]
    n = max(int(re.search(r"ckpt_(\d+)", f).group(1)) for f in files)
    with gzip.open(os.path.join(
            workdir, f"ExaML_binaryCheckpoint.{run}.ckpt_{n}.json.gz"),
            "rt") as f:
        blob = json.load(f)
    return blob["state"], blob["tree"]["likelihood"]


def _sev_lines(info):
    return [line for line in info.read_text().splitlines()
            if "SEV" in line]


def _shared_gene_alignment(ntaxa=8, width=128, seed=6, mut=0.3):
    """Three genes of `width` columns, each a correlated walk: one
    sequenced for every taxon, one for the first half of the taxa and one
    for the second half (all gap elsewhere).  The shared gene gives every
    topology its own lnL: with disjoint genes alone many moves tie
    exactly, and the two packages break such ties by their last bits, so
    their searches part."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]

    def walk(n):
        cur = rng.integers(0, 4, width)
        out = []
        for _ in range(n):
            flip = rng.random(width) < mut
            cur = np.where(flip, rng.integers(0, 4, width), cur)
            out.append("".join("ACGT"[c] for c in cur))
        return out

    h = ntaxa // 2
    gap = "-" * width
    genes = [walk(ntaxa), walk(h) + [gap] * (ntaxa - h),
             [gap] * h + walk(ntaxa - h)]
    seqs = ["".join(g[i] for g in genes) for i in range(ntaxa)]
    model = "\n".join(f"DNA, {n} = {k * width + 1}-{(k + 1) * width}"
                      for k, n in enumerate(("all", "left", "right")))
    return names, seqs, model


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """6 taxa (_shared_gene_alignment), each half-gene's taxa a clade of
    the start tree (the concatenation shape -S is for)."""
    names, seqs, model = _shared_gene_alignment(ntaxa=6)
    d = tmp_path_factory.mktemp("sevcli")
    (d / "parts.model").write_text(model + "\n")
    aln = str(d / "aln.binary")
    write_bytefile(aln, build_alignment_data(
        names, seqs, specs=parse_partition_file(str(d / "parts.model"))))
    trees = d / "tree.nwk"
    trees.write_text("((t0:0.1,t1:0.1):0.1,t2:0.1,((t3:0.1,t4:0.1):0.1,"
                     "t5:0.1):0.1);\n")
    return aln, str(trees)


@pytest.fixture(scope="module")
def cli_runs(cli_inputs, tmp_path_factory):
    """run(mode) -> (JAX workdir, port workdir) of `-S` + mode through
    both CLIs, each mode run once per module; the SPR scan sequential on
    both (EXAML_BATCH_SCAN=0, --batch-scan off)."""
    from examl_tpu_torch.cli.main import main
    aln, trees = cli_inputs
    done = {}

    def run(*mode):
        if mode not in done:
            J = _jax()
            d = tmp_path_factory.mktemp("run")
            argv = ["-s", aln, "-t", trees, "-n", "S", "-S"] + list(mode)
            os.environ["EXAML_BATCH_SCAN"] = "0"
            try:
                assert J.main(argv + ["-w", str(d / "jax"),
                                      "--single-device"]) == 0
            finally:
                del os.environ["EXAML_BATCH_SCAN"]
            assert main(argv + ["-w", str(d / "port"), "--batch-scan",
                                "off"], device="cpu") == 0
            done[mode] = (d / "jax", d / "port")
        return done[mode]

    return run


def _final_lnl(workdir):
    return float((workdir / "ExaML_log.S").read_text().split()[-1])


@pytest.mark.parametrize("mode", [("-f", "e"), ("-f", "d", "-i", "2")],
                         ids=["fe", "fd"])
def test_cli_matches_jax(cli_runs, mode):
    jdir, tdir = cli_runs(*mode)
    assert _final_lnl(tdir) == pytest.approx(_final_lnl(jdir), rel=1e-10)
    tc, jc = _last_ckpt(str(tdir), "S"), _last_ckpt(str(jdir), "S")
    assert tc[0] == jc[0] and tc[1] == pytest.approx(jc[1], rel=1e-10)
    lines = _sev_lines(tdir / "ExaML_info.S")
    assert lines == _sev_lines(jdir / "ExaML_info.S")
    assert lines[0] == "  SEV (-S) pool active for this bucket"
    saved = float(re.search(r"\(([\d.]+)% saved\)", lines[-1]).group(1))
    assert saved > 20.0


def test_cli_quartets_match_jax(cli_runs):
    jdir, tdir = cli_runs("-f", "q", "-r", "6", "-e", "1.0")

    def rows(d):
        return [line.split(": ") for line in
                (d / "ExaML_quartets.S").read_text().splitlines()
                if "|" in line]

    trows, jrows = rows(tdir), rows(jdir)
    assert [h for h, _ in trows] == [h for h, _ in jrows]
    assert len(trows) == 18
    np.testing.assert_allclose([float(v) for _, v in trows],
                               [float(v) for _, v in jrows], rtol=1e-10,
                               atol=1e-6)             # the printed digit
    assert "quartet scoring: sequential" in \
        (tdir / "ExaML_info.S").read_text()
    assert _sev_lines(tdir / "ExaML_info.S") == \
        _sev_lines(jdir / "ExaML_info.S")


def _ckpt_numbers(workdir):
    return sorted(int(re.search(r"ckpt_(\d+)", f).group(1))
                  for f in os.listdir(workdir) if ".ckpt_" in f)


def test_restart_across_packages(cli_inputs, cli_runs, tmp_path):
    """A -S search checkpoint of either package restores in the other with
    its lnL (rtol 1e-10), and `-R -S` of either CLI from the other's
    last-but-one checkpoint ends at least at the continuous run's lnL
    less 0.5 (tests/test_checkpoint.py's bound)."""
    import shutil
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.io.bytefile import read_bytefile
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    J = _jax()
    from examl_tpu.io.bytefile import read_bytefile as jread
    aln, trees = cli_inputs
    runs = dict(zip(("jax", "port"), cli_runs("-f", "d", "-i", "2")))
    for src, d in runs.items():
        _, lnl = _last_ckpt(str(d), "S")
        tinst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                              device="cpu", save_memory=True)
        CheckpointManager(str(d), "S").restore(tinst,
                                               tinst.random_tree(1))
        jinst = J.Instance(jread(aln), dtype=J.jnp.float64,
                           save_memory=True)
        J.checkpoint.CheckpointManager(str(d), "S").restore(
            jinst, jinst.random_tree(1))
        assert tinst.likelihood == pytest.approx(lnl, rel=1e-10)
        assert jinst.likelihood == pytest.approx(lnl, rel=1e-10)
    for src, resume in (("jax", "port"), ("port", "jax")):
        work = tmp_path / f"{src}_to_{resume}"
        shutil.copytree(runs[src], work)
        os.remove(work / f"ExaML_binaryCheckpoint.S.ckpt_"
                         f"{_ckpt_numbers(work)[-1]}.json.gz")
        argv = ["-s", aln, "-n", "S", "-S", "-R", "-i", "2", "-w",
                str(work)]
        if resume == "port":
            assert main(argv + ["--batch-scan", "off"], device="cpu") == 0
        else:
            assert J.main(argv + ["--single-device"]) == 0
        assert _final_lnl(work) >= _final_lnl(runs[src]) - 0.5


def test_cli_refuses_kernel_tier_with_sev(cli_inputs, tmp_path):
    from examl_tpu_torch.cli.main import main
    aln, trees = cli_inputs
    for tier in ("whole", "chunk"):
        with pytest.raises(SystemExit):
            main(["-s", aln, "-t", trees, "-n", "X", "-S", "-w",
                  str(tmp_path), "--newview", tier], device="cpu")


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_pooled_traversal_matches_cpu(cuda_device, small):
    """The pooled traversal on the card in f64 equals the CPU's (rel
    1e-12), through a full evaluate, a partial one and a lazy batched
    scan, with no newview kernel launched."""
    from examl_tpu_torch.ops import newview_chunk, newview_whole
    newick = _port(small).random_tree(3).to_newick(small.names)
    out = []
    for device in ("cpu", cuda_device):
        inst = _port(small, device=device, save_memory=True,
                     batch_scan=True)
        tree = inst.tree_from_newick(newick)
        b1, b2 = newview_chunk.LAUNCHES, newview_whole.LAUNCHES
        full = inst.evaluate(tree, full=True)
        p = tree.nodep[tree.ntips + 2]
        hookup(p, p.back, [0.5] * len(p.z))
        part = inst.evaluate(tree, tree.nodep[tree.ntips + 2])
        plan = _centroid_plan(spr, batchscan, inst, tree, False, 4)
        scans = batchscan.run_plan(inst, tree, plan)
        assert (newview_chunk.LAUNCHES, newview_whole.LAUNCHES) == (b1, b2)
        out.append((full, part, np.asarray(scans)))
    (cf, cp, cs), (gf, gp, gs) = out
    assert gf == pytest.approx(cf, rel=1e-12)
    assert gp == pytest.approx(cp, rel=1e-12)
    np.testing.assert_allclose(gs, cs, rtol=1e-12)
