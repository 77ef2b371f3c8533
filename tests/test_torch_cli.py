"""The port's CLI end to end on the CPU: a tiny byteFile written by the
port, on both full-traversal tiers.

* `-f e` / `-f E`: the four output files exist; ExaML_TreeFile parses;
  ExaML_modelFile parses with tests/refmodel.py (the reference's
  `printModelParams` layout), and installing it and evaluating each
  written tree reproduces the logged lnL within 1e-3 (the files round to
  6 decimals).  MOD_OPT checkpoints are written, and `-R` from the one
  taken after the first tree resumes at the second tree.
* `-m PSR -f e`: the model file carries each partition's categories, and
  the written trees re-evaluate to the logged lnLs under the run's final
  model and per-site rates.
* `-f d -i 5 -B 3` (the default mode): the result, log, model and
  goodTrees files; the final lnL above the first, and the result tree
  re-evaluating to it under the written model.  `-R` from a middle
  checkpoint ends at least at the continuous run's lnL minus 0.5.
* `-f o -g -p -D -M`: the constraint's random resolution and the other
  search flags, with the per-partition branch-length trees.
* `--batch-scan on|off|auto`: the info file names the SPR scan's route
  (auto is sequential on the CPU), and the batched scan runs only on
  the route that says batched.
* `cli/parse.py` writes a byteFile byte-equal to the JAX package's parser
  on the same PHYLIP and partition file.
"""

import glob
import gzip
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from examl_tpu_torch.cli.main import main
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
from examl_tpu_torch.io.partitions import PartitionSpec
from examl_tpu_torch.search import batchscan
from examl_tpu_torch.transfer import install_model_params
from examl_tpu_torch.tree.topology import Tree
from tests.refmodel import parse_model_file


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test runs: the suite runs on several
    xdist workers at once, and a full pool per worker oversubscribes the
    cores so that the many small torch ops here spin (measured: 225 s
    instead of 4 s for one mod_opt parity case on 3 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(ntaxa=8, nsites=240):
    rng = np.random.default_rng(4)
    names = [f"t{i}" for i in range(ntaxa)]
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in names:
        flip = rng.random(nsites) < 0.2
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return names, seqs


def _inputs(tmp_path, ntaxa=8, nsites=240):
    names, seqs = _sequences(ntaxa, nsites)
    half = nsites // 2
    specs = [PartitionSpec("a", "DNA", "GTR", np.arange(0, half)),
             PartitionSpec("b", "DNA", "GTR", np.arange(half, nsites))]
    aln = str(tmp_path / "aln.binary")
    write_bytefile(aln, build_alignment_data(names, seqs, specs))
    trees = str(tmp_path / "trees.nwk")
    with open(trees, "w") as f:
        for seed in (1, 2):
            f.write(Tree.random(names, seed, 1).to_newick(names) + "\n")
    return aln, trees


@pytest.mark.parametrize("mode,newview", [("e", "whole"), ("E", "chunk")])
def test_tree_evaluation_end_to_end(tmp_path, mode, newview):
    aln, trees = _inputs(tmp_path)
    out = tmp_path / "out"
    rc = main(["-s", aln, "-t", trees, "-n", "T", "-w", str(out),
               "-f", mode, "--newview", newview], device="cpu")
    assert rc == 0
    files = {k: out / f"ExaML_{k}.T"
             for k in ("info", "log", "TreeFile", "modelFile")}
    assert all(p.exists() for p in files.values())
    logged = [float(line.split()[1])
              for line in files["log"].read_text().splitlines()]
    assert len(logged) == 2
    params = parse_model_file(str(files["modelFile"]))
    assert [p.name for p in params] == ["a", "b"]
    assert all(len(p.rates) == 6 and p.alpha is not None for p in params)
    inst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                         device="cpu")
    install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                for p in params])
    newicks = files["TreeFile"].read_text().split()
    assert len(newicks) == 2
    # -f e optimizes the model on the first tree only, so both trees sit
    # under the final model; -f E re-optimizes it for the last tree.
    check = range(2) if mode == "e" else [1]
    for i in check:
        tree = inst.tree_from_newick(newicks[i])
        assert inst.evaluate(tree, full=True) == pytest.approx(logged[i],
                                                               abs=1e-3)


def test_not_a_bytefile_is_refused(tmp_path):
    bad = tmp_path / "aln.phy"
    bad.write_text("2 4\na ACGT\nb ACGT\n")
    trees = tmp_path / "t.nwk"
    trees.write_text("(a,b);")
    rc = main(["-s", str(bad), "-t", str(trees), "-n", "T", "-w",
               str(tmp_path)], device="cpu")
    assert rc == 1
    assert "not a byteFile" in (tmp_path / "ExaML_info.T").read_text()


def _checkpoints(workdir, run="T"):
    """{number: (state, extras)} of a run's checkpoint files."""
    out = {}
    for path in glob.glob(os.path.join(workdir, f"ExaML_binaryCheckpoint."
                                       f"{run}.ckpt_*.json.gz")):
        with gzip.open(path, "rt") as f:
            blob = json.load(f)
        out[int(re.search(r"ckpt_(\d+)", path).group(1))] = (
            blob["state"], blob["extras"])
    return out


def _logged(workdir, run="T"):
    with open(os.path.join(workdir, f"ExaML_log.{run}")) as f:
        return [float(line.split()[1]) for line in f.read().splitlines()]


def _reevaluate(aln, workdir, run="T"):
    """The result tree's lnL under the written model file."""
    params = parse_model_file(os.path.join(workdir, f"ExaML_modelFile.{run}"))
    inst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                         device="cpu")
    install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                for p in params])
    with open(os.path.join(workdir, f"ExaML_result.{run}")) as f:
        return inst.evaluate(inst.tree_from_newick(f.read()), full=True)


def test_tree_evaluation_checkpoints_and_restart(tmp_path):
    aln, trees = _inputs(tmp_path)
    out = str(tmp_path / "out")
    assert main(["-s", aln, "-t", trees, "-n", "T", "-w", out, "-f", "e"],
                device="cpu") == 0
    ckpts = _checkpoints(out)
    assert len(ckpts) == 2                 # keep_last=2
    assert {state for state, _ in ckpts.values()} == {"MOD_OPT"}
    last = max(ckpts)
    assert ckpts[last][1]["tree_iteration"] == 2
    assert ckpts[last - 1][1]["tree_iteration"] == 1
    full = _logged(out)
    # Resume from the checkpoint taken after the first tree.
    os.remove(os.path.join(out, f"ExaML_binaryCheckpoint.T.ckpt_{last}"
                                ".json.gz"))
    assert main(["-s", aln, "-t", trees, "-n", "T", "-w", out, "-f", "e",
                 "-R"], device="cpu") == 0
    info = open(os.path.join(out, "ExaML_info.T")).read()
    assert "restart at tree 1" in info
    resumed = _logged(out)
    assert len(resumed) == 3               # appended: one more tree
    assert resumed[2] == pytest.approx(full[1], abs=1e-5)
    newicks = open(os.path.join(out, "ExaML_TreeFile.T")).read().split()
    assert len(newicks) == 2


@pytest.fixture(scope="module")
def search_run(tmp_path_factory):
    """One continuous `-f d -i 5 -B 3` run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tmp = tmp_path_factory.mktemp("fd")
        aln, trees = _inputs(tmp)
        out = str(tmp / "out")
        rc = main(["-s", aln, "-t", trees, "-n", "T", "-w", out, "-i", "5",
                   "-B", "3"], device="cpu")
    finally:
        torch.set_num_threads(n)
    return rc, aln, trees, out


def test_search_end_to_end(search_run):
    rc, aln, _, out = search_run
    assert rc == 0
    for name in ("info", "log", "result", "modelFile", "goodTrees"):
        assert os.path.exists(os.path.join(out, f"ExaML_{name}.T")), name
    logged = _logged(out)
    assert logged[-1] > logged[0]
    info = open(os.path.join(out, "ExaML_info.T")).read()
    final = float(re.search(r"Likelihood of best tree: (\S+)",
                            info).group(1))
    assert final == logged[-1]
    assert _reevaluate(aln, out) == pytest.approx(final, abs=1e-3)
    good = open(os.path.join(out, "ExaML_goodTrees.T")).read().split()
    assert len(good) == 3
    states = {state for state, _ in _checkpoints(out).values()}
    assert {"FAST_SPRS", "SLOW_SPRS"} <= states


def test_search_restart_from_middle_checkpoint(search_run, tmp_path):
    rc, aln, trees, out = search_run
    assert rc == 0
    ckpts = _checkpoints(out)
    mid = sorted(ckpts)[len(ckpts) // 2]
    rout = str(tmp_path / "restart")
    shutil.copytree(out, rout)
    for n in ckpts:
        if n > mid:
            os.remove(os.path.join(rout, f"ExaML_binaryCheckpoint.T.ckpt_{n}"
                                         ".json.gz"))
    assert main(["-s", aln, "-n", "T", "-w", rout, "-i", "5", "-R"],
                device="cpu") == 0
    info = open(os.path.join(rout, "ExaML_info.T")).read()
    assert f"restart from state {ckpts[mid][0]}" in info
    assert _logged(rout)[-1] >= _logged(out)[-1] - 0.5


@pytest.mark.parametrize("flag,route", [("on", "batched"),
                                        ("off", "sequential"),
                                        ("auto", "sequential")])
def test_search_batch_scan_flag(tmp_path, flag, route):
    aln, trees = _inputs(tmp_path, ntaxa=6, nsites=120)
    out = str(tmp_path / "out")
    calls = batchscan.SCAN_CALLS
    assert main(["-s", aln, "-t", trees, "-n", "T", "-w", out, "-i", "2",
                 "--batch-scan", flag], device="cpu") == 0
    info = open(os.path.join(out, "ExaML_info.T")).read()
    assert f"SPR lazy-arm scan: {route}" in info
    assert (batchscan.SCAN_CALLS > calls) == (route == "batched")


def test_search_flags_constraint_rf_per_partition(tmp_path):
    aln, _ = _inputs(tmp_path, ntaxa=7, nsites=120)
    names = [f"t{i}" for i in range(7)]
    cons = tmp_path / "cons.nwk"
    cons.write_text("((t0,t1,t2),(t3,t4),t5,t6);")
    out = str(tmp_path / "out")
    assert main(["-s", aln, "-n", "T", "-w", out, "-f", "o", "-g",
                 str(cons), "-p", "3", "-D", "-M", "-i", "3", "--newview",
                 "whole"], device="cpu") == 0
    info = open(os.path.join(out, "ExaML_info.T")).read()
    assert "constraint tree randomly resolved (seed 3)" in info
    per_gene = open(os.path.join(
        out, "ExaML_perGeneBranchLengths.T")).read().splitlines()
    assert per_gene[0] == "[partition 0 a]" and per_gene[2] == \
        "[partition 1 b]"
    # The result honors the constraint: both clades stay monophyletic.
    from examl_tpu_torch.search.snapshots import topology_key
    from examl_tpu_torch.tree.topology import Tree
    result = Tree.from_newick(open(os.path.join(
        out, "ExaML_result.T")).read(), names, 2)
    key = topology_key(result)
    for clade in ({1, 2, 3}, {4, 5}):
        assert frozenset(clade) in key or \
            frozenset(set(range(1, 8)) - clade) in key
    logged = _logged(out)
    assert logged[-1] > logged[0]


def test_parse_writes_jax_bytefile(tmp_path):
    from examl_tpu.cli import parse as jparse
    from examl_tpu_torch.cli import parse
    names, seqs = _sequences(8, 240)
    phy = tmp_path / "aln.phy"
    phy.write_text(f"{len(names)} {len(seqs[0])}\n" + "".join(
        f"{n} {s}\n" for n, s in zip(names, seqs)))
    part = tmp_path / "parts.txt"
    part.write_text("DNA, a = 1-100\nDNAX, b = 101-240\n")
    assert parse.main(["-s", str(phy), "-q", str(part), "-n",
                       str(tmp_path / "port")]) == 0
    assert jparse.main(["-s", str(phy), "-q", str(part), "-n",
                        str(tmp_path / "jax")]) == 0
    port = (tmp_path / "port.binary").read_bytes()
    assert port == (tmp_path / "jax.binary").read_bytes()
    data = read_bytefile(str(tmp_path / "port.binary"))
    assert [p.name for p in data.partitions] == ["a", "b"]


def test_psr_tree_evaluation_end_to_end(tmp_path):
    """-m PSR -f e: the model file carries each partition's categories and
    their rates, and the written tree under the run's final model and
    per-site rate state (restored from the run's last checkpoint)
    re-evaluates to the logged lnL."""
    from examl_tpu_torch.search.checkpoint import CheckpointManager
    aln, trees = _inputs(tmp_path)
    out = str(tmp_path / "out")
    rc = main(["-s", aln, "-t", trees, "-n", "T", "-w", out, "-f", "e",
               "-m", "PSR", "-c", "6"], device="cpu")
    assert rc == 0
    info = open(os.path.join(out, "ExaML_info.T")).read()
    assert "model: PSR" in info
    text = open(os.path.join(out, "ExaML_modelFile.T")).read()
    cats = [int(c) for c in re.findall(r"^categories: (\d+)$", text, re.M)]
    rates = re.findall(r"^category rates: (.*)$", text, re.M)
    assert len(cats) == len(rates) == 2
    assert all(1 <= c <= 6 for c in cats) and max(cats) > 1
    assert [len(r.split()) for r in rates] == cats
    assert "alpha:" not in text
    params = parse_model_file(os.path.join(out, "ExaML_modelFile.T"))
    assert all(len(p.rates) == 6 and p.alpha is None for p in params)
    logged = _logged(out)
    assert len(logged) == 2
    inst = PhyloInstance(read_bytefile(aln), dtype=torch.float64,
                         device="cpu", rate_model="PSR")
    scaffold = inst.random_tree(seed=5)
    resume = CheckpointManager(out, "T").restore(inst, scaffold)
    assert resume["extras"]["tree_iteration"] == 2
    newicks = open(os.path.join(out, "ExaML_TreeFile.T")).read().split()
    for i in range(2):
        tree = inst.tree_from_newick(newicks[i])
        assert inst.evaluate(tree, full=True) == pytest.approx(logged[i],
                                                               abs=1e-3)
