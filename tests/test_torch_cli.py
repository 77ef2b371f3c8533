"""The port's `-f e` / `-f E` entry point end to end on the CPU: a tiny byteFile
written by the port, two starting trees, both full-traversal tiers.

The four output files exist; ExaML_TreeFile parses; ExaML_modelFile
parses with tests/refmodel.py (the reference's `printModelParams`
layout), and installing it and evaluating each written tree reproduces
the logged lnL within 1e-3 (the files round to 6 decimals).
"""

import os

import numpy as np
import pytest
import torch

from examl_tpu_torch.cli.main import main
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
from examl_tpu_torch.io.partitions import PartitionSpec
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


def _inputs(tmp_path):
    rng = np.random.default_rng(4)
    names = [f"t{i}" for i in range(8)]
    cur = rng.integers(0, 4, 240)
    seqs = []
    for _ in names:
        flip = rng.random(240) < 0.2
        cur = np.where(flip, rng.integers(0, 4, 240), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    specs = [PartitionSpec("a", "DNA", "GTR", np.arange(0, 120)),
             PartitionSpec("b", "DNA", "GTR", np.arange(120, 240))]
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
