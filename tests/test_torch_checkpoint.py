"""The port's checkpoints against the JAX package's (float64 on the CPU).

* A checkpoint written by the port restores in the JAX package's
  CheckpointManager, and one written by the JAX package restores in the
  port: model, tree and lnL (rtol 1e-10) come across both ways, and the
  extras unchanged; so does a PSR checkpoint with its per-site rate
  state (categories, their rates, patrat), both ways;
* a configuration mismatch (a PSR checkpoint for a GAMMA run included)
  raises ValueError; an AUTO partition's choice restores (LG4 and AUTO
  checkpoints across the packages: tests/test_torch_protein.py);
* the counter resumes numbering, `keep_last` prunes, a corrupt newest file
  falls back to the next one;
* the RF-convergence blob round-trips through JSON and equals JAX's;
* a port search restarted from its second checkpoint ends at least at the
  continuous run's result minus 0.5 (tests/test_checkpoint.py's bound).
"""

import glob
import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.models.gtr import build_model as jbuild_model
from examl_tpu.search import checkpoint as jcheckpoint
from examl_tpu.search import convergence as jconvergence
from examl_tpu.search.snapshots import topology_key as jtopology_key
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.search import checkpoint, convergence
from examl_tpu_torch.search.raxml_search import (SearchOptions,
                                                 compute_big_rapid)
from examl_tpu_torch.search.snapshots import topology_key
from examl_tpu_torch.transfer import install_model_params

# Non-default GTR+G models for the two partitions.
PARAMS = [([1.3, 3.9, 0.8, 1.1, 4.2, 1.0], [0.3, 0.2, 0.2, 0.3], 0.45),
          ([0.7, 2.5, 1.6, 0.9, 3.1, 1.0], [0.25, 0.3, 0.2, 0.25], 1.7)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test runs: the suite runs on several
    xdist workers at once, and a full pool per worker oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dna(ntaxa, nsites, seed=42, mut=0.15):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < mut
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _port(ntaxa=10, nsites=120, seed=42):
    names, seqs = _dna(ntaxa, nsites, seed)
    from examl_tpu_torch.io.partitions import PartitionSpec
    half = nsites // 2
    specs = [PartitionSpec(f"p{g}", "DNA", "GTR",
                           np.arange(g * half, (g + 1) * half))
             for g in range(2)]
    return PhyloInstance(build_alignment_data(names, seqs, specs),
                         dtype=torch.float64, device="cpu")


def _jax(ntaxa=10, nsites=120, seed=42):
    names, seqs = _dna(ntaxa, nsites, seed)
    from examl_tpu.io.partitions import PartitionSpec
    half = nsites // 2
    specs = [PartitionSpec(f"p{g}", "DNA", "GTR",
                           np.arange(g * half, (g + 1) * half))
             for g in range(2)]
    return JaxInstance(jbuild_alignment(names, seqs, specs),
                       dtype=jnp.float64)


def _written_by_port(path):
    inst = _port()
    install_model_params(inst, PARAMS)
    tree = inst.random_tree(seed=3)
    for i, (p, _) in enumerate(tree.all_branches()):
        p.z[:] = [0.5 + 0.02 * i]
        p.back.z[:] = [0.5 + 0.02 * i]
    inst.evaluate(tree, full=True)
    mgr = checkpoint.CheckpointManager(str(path), "run")
    mgr.write("FAST_SPRS", {"impr": True, "best_trav": 5}, inst, tree)
    return inst, tree


def _written_by_jax(path):
    inst = _jax()
    for gid, (rates, freqs, alpha) in enumerate(PARAMS):
        inst.models[gid] = jbuild_model(
            inst.alignment.partitions[gid].datatype, np.asarray(freqs),
            rates=np.asarray(rates), alpha=alpha)
    inst.push_models()
    tree = inst.random_tree(seed=3)
    inst.evaluate(tree, full=True)
    mgr = jcheckpoint.CheckpointManager(str(path), "run")
    mgr.write("SLOW_SPRS", {"impr": False, "best_trav": 7}, inst, tree)
    return inst, tree


def test_port_checkpoint_restores_in_jax(tmp_path):
    inst, tree = _written_by_port(tmp_path)
    jinst = _jax()
    jtree = jinst.random_tree(seed=8)
    resume = jcheckpoint.CheckpointManager(str(tmp_path), "run").restore(
        jinst, jtree)
    assert resume == {"state": "FAST_SPRS",
                      "extras": {"impr": True, "best_trav": 5}}
    assert jtopology_key(jtree) == topology_key(tree)
    assert jinst.likelihood == pytest.approx(inst.likelihood, rel=1e-10)
    for jm, m in zip(jinst.models, inst.models):
        np.testing.assert_allclose(jm.rates, m.rates, rtol=1e-15)
        np.testing.assert_allclose(jm.freqs, m.freqs, rtol=1e-15)
        assert jm.alpha == m.alpha


def test_jax_checkpoint_restores_in_port(tmp_path):
    jinst, jtree = _written_by_jax(tmp_path)
    inst = _port()
    tree = inst.random_tree(seed=8)
    resume = checkpoint.CheckpointManager(str(tmp_path), "run").restore(
        inst, tree)
    assert resume == {"state": "SLOW_SPRS",
                      "extras": {"impr": False, "best_trav": 7}}
    assert topology_key(tree) == jtopology_key(jtree)
    assert inst.likelihood == pytest.approx(jinst.likelihood, rel=1e-10)
    for jm, m in zip(jinst.models, inst.models):
        np.testing.assert_allclose(m.rates, jm.rates, rtol=1e-15)
        assert m.alpha == jm.alpha


def test_same_sections_as_jax(tmp_path):
    _written_by_port(tmp_path / "port")
    _written_by_jax(tmp_path / "jax")

    def blob(d):
        (path,) = glob.glob(str(d / "ExaML_binaryCheckpoint.run.ckpt_0"
                                ".json.gz"))
        with gzip.open(path, "rt") as f:
            return json.load(f)

    tb, jb = blob(tmp_path / "port"), blob(tmp_path / "jax")
    assert tb.keys() == jb.keys()
    assert (tb["magic"], tb["version"]) == (jb["magic"], jb["version"])
    assert tb["fingerprint"] == jb["fingerprint"]
    assert [m.keys() for m in tb["models"]] == \
        [m.keys() for m in jb["models"]]
    assert tb["tree"].keys() == jb["tree"].keys()


def test_mismatch_and_missing_model_refused(tmp_path):
    _written_by_port(tmp_path)
    other = _port(nsites=140)
    with pytest.raises(ValueError, match="different run configuration"):
        checkpoint.CheckpointManager(str(tmp_path), "run").restore(
            other, other.random_tree(seed=1))
    (path,) = glob.glob(str(tmp_path / "*.json.gz"))
    with gzip.open(path, "rt") as f:
        blob = json.load(f)
    blob["models"][1]["auto_name"] = "WAG"
    with gzip.open(path, "wt") as f:
        json.dump(blob, f)
    # An automatic protein model's choice is no longer a model the port
    # lacks: the section restores, its choice carried as the JAX package
    # carries it.
    inst = _port()
    checkpoint.CheckpointManager(str(tmp_path), "run").restore(
        inst, inst.random_tree(seed=1))
    assert inst.auto_prot_models == {1: "WAG"}


def test_counter_keep_last_and_corrupt_fallback(tmp_path):
    inst = _port()
    tree = inst.random_tree(seed=0)
    inst.evaluate(tree, full=True)
    mgr = checkpoint.CheckpointManager(str(tmp_path), "r")
    for i in range(3):
        mgr.write("FAST_SPRS", {"i": i}, inst, tree)
    mgr2 = checkpoint.CheckpointManager(str(tmp_path), "r", keep_last=2)
    assert mgr2.counter == 3               # continues, never overwrites
    mgr2.write("FAST_SPRS", {"i": 3}, inst, tree)
    nums = sorted(int(p.split("ckpt_")[1].split(".")[0])
                  for p in glob.glob(str(tmp_path / "*.json.gz")))
    assert nums == [2, 3]                  # everything older swept
    with open(mgr2.path_for(3), "wb") as f:
        f.write(b"\x1f\x8b truncated")
    logged = []
    resume = checkpoint.CheckpointManager(
        str(tmp_path), "r", log=logged.append).restore(
            inst, inst.random_tree(seed=4))
    assert resume["extras"] == {"i": 2}
    assert any("unreadable" in m for m in logged)
    with pytest.raises(checkpoint.CorruptCheckpoint):
        mgr2.restore(inst, tree, path=mgr2.path_for(3))


def test_rf_blob_roundtrip_matches_jax():
    jinst = _jax()
    inst = _port()
    newick = jinst.random_tree(seed=1).to_newick(
        jinst.alignment.taxon_names)
    t, jt = inst.tree_from_newick(newick), jinst.tree_from_newick(newick)
    conv, jconv = convergence.RfConvergence(10), jconvergence.RfConvergence(10)
    assert not conv(t, "fast", 0) and not jconv(jt, "fast", 0)
    blob = json.loads(json.dumps(conv.to_blob()))
    assert blob == json.loads(json.dumps(jconv.to_blob()))
    again = convergence.RfConvergence(10)
    again.load_blob(blob)
    assert again(t, "fast", 1)             # identical tree: rrf == 0
    moved = convergence.RfConvergence(10)
    moved.load_blob(blob)
    assert not moved(inst.random_tree(seed=2), "fast", 1)
    assert moved.last_rrf == convergence.relative_rf(
        topology_key(t), topology_key(inst.random_tree(seed=2)), 10)


def test_restart_reaches_continuous_result(tmp_path):
    inst = _port(8, 150)
    tree = inst.random_tree(seed=7)
    inst.evaluate(tree, full=True)
    mgr = checkpoint.CheckpointManager(str(tmp_path), "cont")
    opts = dict(initial_set=True, initial=5)
    res = compute_big_rapid(
        inst, tree, SearchOptions(**opts),
        checkpoint_cb=lambda state, extras: mgr.write(state, extras, inst,
                                                      tree))
    assert mgr.counter >= 3
    inst2 = _port(8, 150)
    tree2 = inst2.random_tree(seed=99)     # overwritten by restore
    resume = checkpoint.CheckpointManager(str(tmp_path), "cont").restore(
        inst2, tree2, path=mgr.path_for(1))
    assert resume["state"] in ("FAST_SPRS", "SLOW_SPRS")
    res2 = compute_big_rapid(inst2, tree2, SearchOptions(**opts),
                             resume=resume)
    assert res2.likelihood >= res.likelihood - 0.5


def _psr_pair(seed=5):
    """A port and a JAX PSR instance on one two-partition alignment, each
    with its own per-site rate state drawn from `seed` (categories, their
    rates and patrat differ between the two, so a restore has to carry
    them)."""
    names, seqs = _dna(10, 120)
    from examl_tpu.io.partitions import PartitionSpec as JSpec
    from examl_tpu_torch.io.partitions import PartitionSpec
    cols = [np.arange(0, 60), np.arange(60, 120)]
    tinst = PhyloInstance(build_alignment_data(names, seqs, [
        PartitionSpec(f"p{g}", "DNA", "GTR", cols[g]) for g in range(2)]),
        dtype=torch.float64, device="cpu", rate_model="PSR")
    jinst = JaxInstance(jbuild_alignment(names, seqs, [
        JSpec(f"p{g}", "DNA", "GTR", cols[g]) for g in range(2)]),
        dtype=jnp.float64, rate_model="PSR")
    rng = np.random.default_rng(seed)
    for inst in (tinst, jinst):
        for gid, part in enumerate(inst.alignment.partitions):
            inst.per_site_rates[gid] = np.sort(rng.uniform(0.1, 3.0, 4))
            inst.rate_category[gid] = rng.integers(
                0, 4, part.width).astype(np.int32)
            inst.patrat[gid] = rng.uniform(0.1, 3.0, part.width)
        inst.push_site_rates()
    install_model_params(tinst, PARAMS)
    for gid, (rates, freqs, alpha) in enumerate(PARAMS):
        jinst.models[gid] = jbuild_model(
            jinst.alignment.partitions[gid].datatype, np.asarray(freqs),
            rates=np.asarray(rates), alpha=alpha, ncat=1)
    jinst.push_models()
    return tinst, jinst


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_psr_checkpoint_crosses_both_ways(tmp_path, writer):
    tinst, jinst = _psr_pair()
    other_port, other_jax = _psr_pair(seed=9)
    port = (tinst, checkpoint.CheckpointManager, topology_key)
    jax_ = (jinst, jcheckpoint.CheckpointManager, jtopology_key)
    if writer == "port":
        (src, src_mgr, src_key), (_, dst_mgr, dst_key) = port, jax_
        dst = other_jax
    else:
        (src, src_mgr, src_key), (_, dst_mgr, dst_key) = jax_, port
        dst = other_port
    src_tree = src.random_tree(seed=3)
    lnl = src.evaluate(src_tree, full=True)
    src_mgr(str(tmp_path), "psr").write("MOD_OPT", {"tree_iteration": 1},
                                        src, src_tree)
    dst_tree = dst.random_tree(seed=8)
    resume = dst_mgr(str(tmp_path), "psr").restore(dst, dst_tree)
    assert resume["state"] == "MOD_OPT"
    assert dst.likelihood == pytest.approx(lnl, rel=1e-10)
    assert dst_key(dst_tree) == src_key(src_tree)
    for gid in range(2):
        np.testing.assert_array_equal(dst.rate_category[gid],
                                      src.rate_category[gid])
        np.testing.assert_array_equal(dst.per_site_rates[gid],
                                      src.per_site_rates[gid])
        np.testing.assert_array_equal(dst.patrat[gid], src.patrat[gid])
    (path,) = glob.glob(str(tmp_path / "*.json.gz"))
    with gzip.open(path, "rt") as f:
        blob = json.load(f)
    assert blob["fingerprint"]["rate_model"] == "PSR"
    assert {"rate_category", "per_site_rates", "patrat"} <= \
        blob["models"][0].keys()


def test_psr_checkpoint_refused_by_gamma_run(tmp_path):
    tinst, _ = _psr_pair()
    tree = tinst.random_tree(seed=3)
    tinst.evaluate(tree, full=True)
    checkpoint.CheckpointManager(str(tmp_path), "r").write(
        "MOD_OPT", {}, tinst, tree)
    gamma = _port()
    with pytest.raises(ValueError, match="rate_model"):
        checkpoint.CheckpointManager(str(tmp_path), "r").restore(
            gamma, gamma.random_tree(seed=1))
