"""AUTO protein-model selection and the CLI on amino-acid and binary data,
the port against the JAX package (float64 on the CPU, x64 on the JAX
side).

* `auto_protein` picks JAX's matrix and frequencies under ML and BIC
  (tests/test_protein_models.py's data; the candidate list cut to four
  matrices on both sides, the same list, so both packages together run
  in well under a minute);
* `-f e` through the port's CLI on an AA + BIN byteFile (WAG, LG4X and an
  AUTO partition) ends at the JAX CLI's endpoint (`--single-device`, as
  the port runs; rel 1e-9); both model files name the same matrices,
  AUTO's choice included, and the port's prints LG4X's rates and weights.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild
from examl_tpu.io.partitions import PartitionSpec as JSpec
from examl_tpu.models import protein as jprotein
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data as tbuild
from examl_tpu_torch.io.partitions import PartitionSpec as TSpec
from examl_tpu_torch.models import protein
from tests.test_torch_protein import AA, _data

# AUTO's candidates in these tests, the same on both sides.
SHORT_CANDIDATES = ["WAG", "LG", "JTT", "DAYHOFF"]


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    """Both packages on their default smoothing route, AUTO's short
    candidate list, and one torch intra-op thread (the suite runs on
    several xdist workers at once)."""
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    monkeypatch.setattr(jprotein, "AUTO_CANDIDATES", SHORT_CANDIDATES)
    monkeypatch.setattr(protein, "AUTO_CANDIDATES", SHORT_CANDIDATES)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _auto_data(jax_side, W):
    """tests/test_protein_models.py's AUTO data: 8 taxa simulated under LG
    (seed 11), one AUTO partition of W columns."""
    from examl_tpu import datatypes
    from examl_tpu.models.gtr import build_model, transition_matrix
    rng = np.random.default_rng(11)
    rates, freqs = jprotein.get_matrix("LG")
    m = build_model(datatypes.AA, freqs, rates=rates, alpha=1.0, ncat=1)
    P = transition_matrix(m, 0.4)
    cur = rng.choice(20, W, p=freqs / freqs.sum())
    seqs = []
    for _ in range(8):
        cur = np.array([rng.choice(20, p=P[c] / P[c].sum()) for c in cur])
        seqs.append("".join(AA[c] for c in cur))
    build, spec = (jbuild, JSpec) if jax_side else (tbuild, TSpec)
    return build([f"t{i}" for i in range(8)], seqs, [spec(
        name="p1", datatype_name="AA", model_name="AUTO",
        sites=np.arange(W), auto=True)])


@pytest.mark.parametrize("criterion,W", [("ml", 300), ("bic", 120)])
def test_auto_protein_matches_jax(criterion, W):
    from examl_tpu.optimize import auto_protein as jauto
    from examl_tpu.optimize.branch import tree_evaluate as jtree_evaluate
    from examl_tpu_torch.optimize import auto_protein as tauto
    from examl_tpu_torch.optimize.branch import tree_evaluate
    jinst = JaxInstance(_auto_data(True, W), dtype=jnp.float64)
    tinst = PhyloInstance(_auto_data(False, W), dtype=torch.float64,
                          device="cpu")
    assert tinst.auto_prot_models == jinst.auto_prot_models == {0: "WAG"}
    newick = jinst.random_tree(seed=2).to_newick(jinst.alignment.taxon_names)
    jtree, ttree = jinst.tree_from_newick(newick), \
        tinst.tree_from_newick(newick)
    jtree_evaluate(jinst, jtree, 1.0)
    tree_evaluate(tinst, ttree, 1.0)
    l0 = tinst.likelihood
    jauto.auto_protein(jinst, jtree, criterion)
    tauto.auto_protein(tinst, ttree, criterion)
    assert tinst.auto_prot_models == jinst.auto_prot_models
    assert tinst.auto_prot_freqs == jinst.auto_prot_freqs
    assert tinst.likelihood >= l0 - 1e-9
    assert tinst.likelihood == pytest.approx(jinst.likelihood, rel=1e-9)
    if criterion == "ml":
        assert tinst.auto_prot_models[0] == "LG"
    else:
        assert tinst.auto_prot_freqs[0] == "fixed"


# -- the CLI -----------------------------------------------------------------


def _model_names(path):
    """Matrix name per amino-acid partition of a model file (either
    package's layout)."""
    text = open(path).read()
    return re.findall(r"Substitution (?:Matrix|model): (\S+)", text)


def test_cli_fe_aa_bin_matches_jax(tmp_path):
    from examl_tpu.cli.main import main as jmain
    from examl_tpu_torch.cli.main import main
    from examl_tpu_torch.io.bytefile import write_bytefile
    models = [("WAG", {}), ("LG4X", {"lg4": True}),
              ("AUTO", {"auto": True})]
    ad = _data(False, ntaxa=6, width=40, seed=8, models=models)
    aln = str(tmp_path / "aln.binary")
    write_bytefile(aln, ad)
    trees = tmp_path / "tree.nwk"
    trees.write_text(JaxInstance(_data(True, ntaxa=6, width=40, seed=8,
                                       models=models), dtype=jnp.float64)
                     .random_tree(seed=3).to_newick(ad.taxon_names) + "\n")
    argv = ["-s", aln, "-t", str(trees), "-f", "e", "-n", "E"]
    assert jmain(argv + ["-w", str(tmp_path / "jax"),
                         "--single-device"]) == 0
    assert main(argv + ["-w", str(tmp_path / "port")], device="cpu") == 0

    def final(d):
        with open(os.path.join(d, "ExaML_log.E")) as f:
            return float(f.read().split()[-1])

    assert final(tmp_path / "port") == pytest.approx(final(tmp_path / "jax"),
                                                     rel=1e-9)
    names = _model_names(tmp_path / "port" / "ExaML_modelFile.E")
    jnames = _model_names(tmp_path / "jax" / "ExaML_modelFile.E")
    assert names == jnames[:3]
    assert names[:2] == ["WAG", "LG4X"] and names[2] in SHORT_CANDIDATES
    text = (tmp_path / "port" / "ExaML_modelFile.E").read_text()
    assert "LG4X category rates:" in text and "LG4X category weights:" in text
