"""The port's quartet evaluation (-f q) against the JAX package (float64 on
the CPU).

* the grouping parser: JAX's groups, JAX's errors;
* all quartets, `-r` random sampling and `-Y` groups: the port's rows and
  their order equal JAX's (row labels exactly, values to the printed
  digit), and the batched scorer's lnLs after the model optimization at
  rtol 1e-10 of JAX's;
* the batched scorer equals the sequential one (rtol 1e-10);
* a QUARTETS checkpoint written by either package restores in the other
  and finishes the output file as the continuous run wrote it;
* `-f q` through `cli.main(..., device="cpu")`, with the reference's
  flag-combination checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.search import quartets as jquartets
from examl_tpu.search import quartets_batch as jquartets_batch
from examl_tpu.search.checkpoint import CheckpointManager as JaxManager
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.search import quartets, quartets_batch
from examl_tpu_torch.search.checkpoint import CheckpointManager

NTAXA, NSITES = 8, 200


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs on several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _alignment():
    """tests/test_quartets.py's 8-taxon alignment, as names and sequences."""
    rng = np.random.default_rng(5)
    cur = rng.integers(0, 4, NSITES)
    seqs = []
    for _ in range(NTAXA):
        flip = rng.random(NSITES) < 0.2
        cur = np.where(flip, rng.integers(0, 4, NSITES), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(NTAXA)], seqs


def _jax_instance():
    names, seqs = _alignment()
    return JaxInstance(jbuild_alignment(names, seqs), dtype=jnp.float64)


def _port_instance():
    names, seqs = _alignment()
    return PhyloInstance(build_alignment_data(names, seqs),
                         dtype=torch.float64, device="cpu")


def _newick(seed=1):
    names, _ = _alignment()
    return _jax_instance().random_tree(seed=seed).to_newick(names)


def _rows(path):
    return [line.rstrip("\n").split(": ") for line in open(path)
            if "|" in line]


def _run_both(tmp_path, **opts):
    """compute_quartets on both packages from one newick: (JAX rows, port
    rows, JAX instance, port instance)."""
    jinst, tinst = _jax_instance(), _port_instance()
    nw = _newick()
    jout, tout = str(tmp_path / "jax.q"), str(tmp_path / "port.q")
    jn = jquartets.compute_quartets(jinst, jinst.tree_from_newick(nw),
                                    jquartets.QuartetOptions(**opts), jout)
    tn = quartets.compute_quartets(tinst, tinst.tree_from_newick(nw),
                                   quartets.QuartetOptions(**opts), tout)
    assert tn == jn
    assert open(tout).read().split("\n\n\n")[0] == \
        open(jout).read().split("\n\n\n")[0]          # the taxon header
    return _rows(jout), _rows(tout), jinst, tinst


def _assert_rows_equal(trows, jrows):
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    np.testing.assert_allclose([float(r[1]) for r in trows],
                               [float(r[1]) for r in jrows], rtol=1e-10,
                               atol=1e-6)             # the printed digit


def test_grouping_parser_matches_jax(tmp_path):
    names, _ = _alignment()
    path = tmp_path / "groups.txt"
    path.write_text("(t0, t1), (t2,t3), (t4), (t5, t6, t7)\n")
    groups = quartets.parse_grouping_file(str(path), names)
    assert groups == [[1, 2], [3, 4], [5], [6, 7, 8]]
    assert groups == jquartets.parse_grouping_file(str(path), names)
    for text, msg in (("(t0), (t1), (t0), (t2)", "two groups"),
                      ("(t0), (t1), (t2)", "exactly 4 groups"),
                      ("(t0), (t1), (t2), (x9)", "unknown taxon"),
                      ("(t0), (t1), (t2), ( )", "empty group")):
        bad = tmp_path / "bad.txt"
        bad.write_text(text)
        for parse in (quartets.parse_grouping_file,
                      jquartets.parse_grouping_file):
            with pytest.raises(ValueError, match=msg):
                parse(str(bad), names)


def test_all_quartets_match_jax(tmp_path):
    jrows, trows, jinst, tinst = _run_both(tmp_path, epsilon=1.0)
    assert len(trows) == 210                      # C(8, 4) sets x 3
    _assert_rows_equal(trows, jrows)
    assert tinst.likelihood == pytest.approx(jinst.likelihood, rel=1e-10)
    jobs = [j for s in [(1, 2, 3, 4), (2, 5, 7, 8), (1, 6, 7, 8)]
            for j in quartets_batch.three_topology_jobs(*s)]
    np.testing.assert_allclose(quartets_batch.score_jobs(tinst, jobs),
                               jquartets_batch.score_jobs(jinst, jobs),
                               rtol=1e-10)


@pytest.mark.parametrize("flavor", ["random", "grouped"])
def test_random_and_grouped_quartets_match_jax(tmp_path, flavor):
    if flavor == "random":
        opts = dict(random_samples=10, seed=7, epsilon=1.0)
        nrows = 30
    else:
        gfile = tmp_path / "groups.txt"
        gfile.write_text("(t0,t1),(t2),(t4),(t6,t7)")
        opts = dict(grouping_file=str(gfile), epsilon=1.0)
        nrows = 3 * 2 * 1 * 1 * 2
    jrows, trows, _, _ = _run_both(tmp_path, **opts)
    assert len(trows) == nrows
    _assert_rows_equal(trows, jrows)


def test_batched_scorer_matches_sequential():
    inst = _port_instance()
    tree = inst.tree_from_newick(_newick(seed=2))
    inst.evaluate(tree, full=True)
    assert quartets_batch.batch_eligible(inst)
    names, seqs = _alignment()
    assert not quartets_batch.batch_eligible(PhyloInstance(
        build_alignment_data(names, seqs), dtype=torch.float64,
        device="cpu", rate_model="PSR"))
    n = inst.alignment.ntaxa
    q1, q2 = tree.nodep[n + 1], tree.nodep[n + 2]
    sets = [(1, 2, 3, 4), (2, 5, 7, 8), (1, 6, 7, 8), (3, 4, 5, 6)]
    seq = []
    for s in sets:
        for a, b, c, d in quartets_batch.three_topology_jobs(*s):
            seq.append(quartets.quartet_likelihood(
                inst, tree, q1, q2, *(tree.nodep[t] for t in (a, b, c, d))))
    jobs = [j for s in sets for j in quartets_batch.three_topology_jobs(*s)]
    np.testing.assert_allclose(quartets_batch.score_jobs(inst, jobs), seq,
                               rtol=1e-10)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A run writing QUARTETS checkpoints every 30 sets; the other package
    restores the newest into a fresh instance and finishes the file: it
    equals the continuous run's."""
    w_inst, r_inst = ((_jax_instance(), _port_instance()) if writer == "jax"
                      else (_port_instance(), _jax_instance()))
    w_mod, r_mod = ((jquartets, quartets) if writer == "jax"
                    else (quartets, jquartets))
    w_mgr, r_mgr = ((JaxManager, CheckpointManager) if writer == "jax"
                    else (CheckpointManager, JaxManager))
    out = str(tmp_path / "q.out")
    mgr = w_mgr(str(tmp_path), "q")
    n = w_mod.compute_quartets(
        w_inst, w_inst.tree_from_newick(_newick()),
        w_mod.QuartetOptions(epsilon=1.0, checkpoint_interval=30,
                             checkpoint_mgr=mgr), out)
    assert n == 70 and mgr.counter >= 2
    continuous = open(out).read()
    tree = r_inst.random_tree(seed=9)
    resume = r_mgr(str(tmp_path), "q").restore(r_inst, tree)
    assert resume["state"] == "QUARTETS"
    assert resume["extras"]["quartet_counter"] == 60
    assert r_inst.likelihood == pytest.approx(w_inst.likelihood, rel=1e-10)
    n2 = r_mod.compute_quartets(r_inst, tree,
                                r_mod.QuartetOptions(epsilon=1.0,
                                                     resume=resume), out)
    assert n2 == 70
    resumed = _rows(out)
    cont = [r.split(": ") for r in continuous.splitlines() if "|" in r]
    _assert_rows_equal(resumed, cont)
    assert len(resumed) == 210


def test_cli_quartets(tmp_path):
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.io.bytefile import write_bytefile
    names, seqs = _alignment()
    aln = str(tmp_path / "aln.binary")
    write_bytefile(aln, build_alignment_data(names, seqs))
    start = tmp_path / "start.nwk"
    start.write_text(_newick() + "\n")
    gfile = tmp_path / "groups.txt"
    gfile.write_text("(t0,t1),(t2),(t4),(t6,t7)")
    work = str(tmp_path / "w")
    base = ["-s", aln, "-t", str(start), "-w", work]
    assert main(base + ["-n", "Q", "-f", "q", "-e", "1.0", "-Y",
                        str(gfile)], device="cpu") == 0
    rows = _rows(f"{work}/ExaML_quartets.Q")
    assert len(rows) == 12
    info = open(f"{work}/ExaML_info.Q").read()
    assert "quartet scoring: batched" in info
    assert "4 quartets written to" in info
    # The same sets through Python on the JAX package.
    jinst = _jax_instance()
    jout = str(tmp_path / "jax.q")
    jquartets.compute_quartets(
        jinst, jinst.tree_from_newick(_newick()),
        jquartets.QuartetOptions(grouping_file=str(gfile), epsilon=1.0),
        jout)
    _assert_rows_equal(rows, _rows(jout))
    # -Y and -r belong to -f q only and exclude each other.
    for extra in (["-f", "d", "-r", "5"], ["-f", "e", "-Y", str(gfile)],
                  ["-f", "q", "-r", "5", "-Y", str(gfile)]):
        with pytest.raises(SystemExit):
            main(base + ["-n", "X"] + extra, device="cpu")
