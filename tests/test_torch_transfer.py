"""examl_tpu_torch.transfer: engine state, model parameters and PSR
per-site rate state carried from the JAX package into the port as numpy
arrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.ops import kernels
from examl_tpu_torch.transfer import (MODEL_FIELDS, install_model_params,
                                      state_from_numpy)

CPU = torch.device("cpu")


def _data(seed=5, ntaxa=14, nsites=300):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, nsites))
            for _ in names]
    return names, seqs


def _jax_engine_state():
    names, seqs = _data()
    jinst = JaxInstance(jbuild(names, seqs), dtype=jnp.float64)
    jinst.models[0] = dataclasses.replace(
        jinst.models[0], gamma_rates=np.array([0.1, 0.5, 1.1, 2.3]))
    jinst.push_models()
    tree = jinst.random_tree(5)
    lnl = jinst.evaluate(tree, full=True)
    eng = jinst.engines[4]
    arrays = {k: np.asarray(getattr(eng.models, k)) for k in MODEL_FIELDS}
    arrays.update(codes=np.asarray(eng.tips.codes),
                  table=np.asarray(eng.tips.table),
                  block_part=np.asarray(eng.block_part),
                  weights=np.asarray(eng.weights))
    return jinst, tree, eng, arrays, lnl


def test_state_from_numpy_round_trips():
    _, _, _, arrays, _ = _jax_engine_state()
    models, tips, block_part, weights = state_from_numpy(arrays, CPU)
    for k in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(models, k).numpy(), arrays[k])
    assert models.part_branch.dtype == torch.int64
    assert tips.codes.dtype == torch.uint8
    np.testing.assert_array_equal(tips.codes.numpy(), arrays["codes"])
    np.testing.assert_array_equal(tips.table.numpy(), arrays["table"])
    np.testing.assert_array_equal(block_part.numpy(), arrays["block_part"])
    np.testing.assert_array_equal(weights.numpy(), arrays["weights"])
    f32 = state_from_numpy(arrays, CPU, torch.float32)
    assert f32[0].ev.dtype == torch.float32
    assert f32[3].dtype == torch.float32


def test_root_lnl_from_transferred_state_matches():
    """The port's root evaluation over the JAX engine's own arena and
    transferred state gives the JAX lnL."""
    jinst, tree, eng, arrays, lnl = _jax_engine_state()
    models, tips, block_part, weights = state_from_numpy(arrays, CPU)
    p = tree.centroid_branch()
    got = kernels.root_log_likelihood(
        models, block_part, weights, tips,
        torch.as_tensor(np.array(eng.clv)),
        torch.as_tensor(np.array(eng.scaler)), eng._gidx(p.number),
        eng._gidx(p.back.number), torch.as_tensor(np.asarray(p.z)),
        eng.num_parts, eng.scale_exp, eng.ntips)
    assert float(got.sum()) == pytest.approx(lnl, rel=1e-12)


@pytest.mark.parametrize("form", ["fields", "triples"])
def test_install_model_params_matches_jax(form):
    names, seqs = _data(6)
    jinst = JaxInstance(jbuild(names, seqs), dtype=jnp.float64)
    rates = np.array([1.3, 4.1, 0.7, 0.9, 5.2, 1.0])
    freqs = np.array([0.3, 0.2, 0.25, 0.25])
    from examl_tpu.models.gtr import build_model
    jinst.models[0] = build_model(jinst.alignment.partitions[0].datatype,
                                  freqs, rates=rates, alpha=0.4)
    jinst.push_models()
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu")
    params = ([dataclasses.asdict(jinst.models[0])] if form == "fields"
              else [(rates, freqs, 0.4)])
    install_model_params(tinst, params)
    np.testing.assert_allclose(tinst.models[0].ev, jinst.models[0].ev,
                               rtol=1e-14, atol=1e-15)
    jtree = jinst.random_tree(2)
    newick = jtree.to_newick(jinst.alignment.taxon_names)
    jtree = jinst.tree_from_newick(newick)
    ttree = tinst.tree_from_newick(newick)
    assert tinst.evaluate(ttree, full=True) == pytest.approx(
        jinst.evaluate(jtree, full=True), rel=1e-10)
    with pytest.raises(ValueError):
        install_model_params(tinst, params * 2)


def test_install_psr_state_carries_jax_state():
    """A JAX PSR instance's per-site rate state carried into the port
    gives the JAX lnL on the same tree."""
    from examl_tpu_torch.transfer import install_psr_state
    names, seqs = _data(8, 10, 160)
    jinst = JaxInstance(jbuild(names, seqs), dtype=jnp.float64,
                        rate_model="PSR")
    rng = np.random.default_rng(2)
    W = jinst.alignment.partitions[0].width
    jinst.per_site_rates[0] = np.array([0.2, 0.9, 1.7, 3.1])
    jinst.rate_category[0] = rng.integers(0, 4, W).astype(np.int32)
    jinst.patrat[0] = rng.uniform(0.1, 3.0, W)
    jinst.push_site_rates()
    newick = jinst.random_tree(3).to_newick(names)
    jtree = jinst.tree_from_newick(newick)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu",
                          rate_model="PSR")
    assert tinst.ncat == 1
    install_psr_state(tinst, jinst.patrat, jinst.rate_category,
                      jinst.per_site_rates)
    np.testing.assert_array_equal(tinst.rate_category[0],
                                  jinst.rate_category[0])
    np.testing.assert_array_equal(tinst.patrat[0], jinst.patrat[0])
    ttree = tinst.tree_from_newick(newick)
    assert tinst.evaluate(ttree, full=True) == pytest.approx(
        jinst.evaluate(jtree, full=True), rel=1e-10)
    with pytest.raises(ValueError, match="patterns"):
        install_psr_state(tinst, [jinst.patrat[0][:-1]],
                          jinst.rate_category, jinst.per_site_rates)
    with pytest.raises(ValueError, match="out of range"):
        install_psr_state(tinst, jinst.patrat, jinst.rate_category,
                          [jinst.per_site_rates[0][:1]])
    gamma = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="PSR"):
        install_psr_state(gamma, jinst.patrat, jinst.rate_category,
                          jinst.per_site_rates)
