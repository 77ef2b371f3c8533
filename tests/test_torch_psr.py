"""The port's PSR (per-site rate / CAT) model against the JAX package and
the numpy oracle, float64 on the CPU.

* forms: `psr_decay`, `apply_p_factorized` and `per_rate_site_lnls` equal
  JAX's on the same random inputs (rtol 1e-12);
* likelihood: the PSR lnL under non-uniform per-site rates equals
  tests/oracle.py's pruning (rel 1e-9); `rate_scan` equals installing
  each grid rate and evaluating (rel 1e-9);
* categorization: `_categorize_partition` returns JAX's arrays exactly;
* one round: `optimize_rate_categories` gives JAX's patrat and categories
  exactly, its category rates at rtol 1e-9 and its lnL at rtol 1e-9;
* endpoints: `refine_category_rates` and a small PSR `mod_opt` (both on
  the default gradient smoothing route) end at JAX's lnL, rtol 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu import datatypes as jdt
from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild_alignment
from examl_tpu.models.gtr import build_model as jbuild_model
from examl_tpu.ops import kernels as jk
from examl_tpu.ops.engine import stack_models as jstack
from examl_tpu.optimize import model_opt as jmodel_opt
from examl_tpu.optimize import psr as jpsr
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.ops import kernels as tk
from examl_tpu_torch.optimize import model_opt, psr
from examl_tpu_torch.transfer import install_psr_state, state_from_numpy
from tests.oracle import oracle_lnl

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    """The JAX package on its default routes (gradient smoothing, the
    category refinement), and one torch intra-op thread (the suite runs on
    several xdist workers at once)."""
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    monkeypatch.delenv("EXAML_PSR_REFINE", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(ntaxa=10, nsites=240, seed=7):
    """tests/test_psr.py's alignment."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in range(ntaxa):
        flip = rng.random(nsites) < 0.2
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return [f"t{i}" for i in range(ntaxa)], seqs


def _pair(ntaxa=10, nsites=240, seed=7, tree_seed=3, **kw):
    names, seqs = _sequences(ntaxa, nsites, seed)
    jinst = JaxInstance(jbuild_alignment(names, seqs), dtype=jnp.float64,
                        rate_model="PSR", **kw)
    tinst = PhyloInstance(build_alignment_data(names, seqs),
                          dtype=torch.float64, device="cpu",
                          rate_model="PSR", **kw)
    newick = jinst.random_tree(seed=tree_seed).to_newick(names)
    return (jinst, jinst.tree_from_newick(newick), tinst,
            tinst.tree_from_newick(newick))


# -- forms -------------------------------------------------------------------


def _forms_state(seed=4, B=2, lane=128, G=3):
    rng = np.random.default_rng(seed)
    models = []
    for _ in range(2):
        rates = rng.uniform(0.3, 6.0, 6)
        rates[-1] = 1.0
        models.append(jbuild_model(jdt.DNA, rng.dirichlet(np.ones(4) * 5),
                                   rates=rates, ncat=1))
    jm = jstack(models, [0, 1], jnp.float64, psr=True)
    ntips = 6
    codes = rng.choice([1, 2, 4, 8, 15, 5], (ntips, B, lane)).astype(
        np.uint8)
    block_part = np.array([0, 1], np.int32)
    arrays = {k: np.asarray(getattr(jm, k)) for k in jm._fields}
    arrays.update(codes=codes, table=jdt.DNA.tip_indicator_table(),
                  block_part=block_part, weights=np.ones((B, lane)))
    tm, tt, tbp, _ = state_from_numpy(arrays, CPU)
    jt = jk.TipState(codes=jnp.asarray(codes),
                     table=jnp.asarray(arrays["table"]))
    grid = rng.uniform(0.05, 4.0, (B, lane, G))
    z = rng.uniform(0.05, 0.95, 2)
    clv = rng.uniform(0.01, 1.0, (4, B, lane, G, 4)) * 2.0 ** -100
    scaler = rng.integers(0, 3, (4, B, lane)).astype(np.int32)
    return dict(jm=jm, jt=jt, tm=tm, tt=tt, bp=block_part, tbp=tbp,
                grid=grid, z=z, clv=clv, scaler=scaler, ntips=ntips)


def test_psr_forms_match_jax():
    d = _forms_state()
    jbp = jnp.asarray(d["bp"])
    ref_d = np.asarray(jk.psr_decay(d["jm"], jbp, jnp.asarray(d["grid"]),
                                    jnp.asarray(d["z"])))
    got_d = tk.psr_decay(d["tm"], d["tbp"], torch.as_tensor(d["grid"]),
                         torch.as_tensor(d["z"]))
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=1e-12, atol=0)
    x = d["clv"][1]
    ref_y = np.asarray(jk.apply_p_factorized(d["jm"], jbp,
                                             jnp.asarray(ref_d),
                                             jnp.asarray(x)))
    got_y = tk.apply_p_factorized(d["tm"], d["tbp"], got_d,
                                  torch.as_tensor(x))
    scale = np.abs(ref_y).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got_y.numpy() - ref_y) <= 1e-12 * scale)
    for p_idx, q_idx in ((d["ntips"] + 1, d["ntips"] + 3), (2, 7), (0, 4)):
        ref = np.asarray(jk.per_rate_site_lnls(
            d["jm"], jbp, d["jt"], jnp.asarray(d["clv"]),
            jnp.asarray(d["scaler"]), p_idx, q_idx, jnp.asarray(d["z"]),
            jnp.asarray(d["grid"]), 256, d["ntips"]))
        got = tk.per_rate_site_lnls(
            d["tm"], d["tbp"], d["tt"], torch.as_tensor(d["clv"]),
            torch.as_tensor(d["scaler"]), p_idx, q_idx,
            torch.as_tensor(d["z"]), torch.as_tensor(d["grid"]), 256,
            d["ntips"])
        assert got.shape == ref.shape == d["grid"].shape
        # atol: a tip/tip site whose likelihood rounds to 1 has lnL ~ 1e-16
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


# -- likelihood --------------------------------------------------------------


def test_psr_lnl_matches_oracle_and_jax():
    jinst, jtree, tinst, ttree = _pair()
    rng = np.random.default_rng(0)
    W = tinst.alignment.partitions[0].width
    cats = rng.integers(0, 5, W)
    rates = np.array([0.1, 0.5, 1.0, 2.0, 4.0])[cats]
    w = tinst.alignment.partitions[0].weights
    rates = rates / (float(w @ rates) / float(w.sum()))
    kept = np.unique(rates)
    cat = np.searchsorted(kept, rates).astype(np.int32)
    install_psr_state(tinst, [rates], [cat], [kept])
    jinst.patrat[0], jinst.rate_category[0] = rates, cat
    jinst.per_site_rates[0] = kept
    jinst.push_site_rates()
    lnl = tinst.evaluate(ttree, full=True)
    ref = oracle_lnl(ttree, tinst.alignment, tinst.models,
                     site_rates=[rates])
    assert lnl == pytest.approx(ref, rel=1e-9)
    assert lnl == pytest.approx(jinst.evaluate(jtree, full=True), rel=1e-10)
    # Uniform rates reproduce the single-rate model.
    install_psr_state(tinst, [np.ones(W)], [np.zeros(W, np.int32)],
                      [np.ones(1)])
    ref1 = oracle_lnl(ttree, tinst.alignment, tinst.models,
                      site_rates=[np.ones(W)])
    assert tinst.evaluate(ttree, full=True) == pytest.approx(ref1, rel=1e-9)


def test_rate_scan_matches_direct_evaluation():
    _, _, tinst, ttree = _pair()
    tinst.evaluate(ttree, full=True)
    (eng,) = tinst.engines.values()
    bucket = tinst.buckets[4]
    p, entries = ttree.full_traversal()
    W = tinst.alignment.partitions[0].width
    w = tinst.alignment.partitions[0].weights
    grid = np.concatenate([np.full((bucket.num_blocks, bucket.lane, 1), r)
                           for r in (0.5, 2.0, 3.5)], axis=2)
    lnls = eng.rate_scan(entries, p.number, p.back.number, p.z, grid)
    assert lnls.shape == grid.shape
    for g, rate in enumerate((0.5, 2.0, 3.5)):
        install_psr_state(tinst, [np.full(W, rate)],
                          [np.zeros(W, np.int32)], [np.array([rate])])
        direct = tinst.evaluate(ttree, full=True)
        got = float(w @ lnls.reshape(-1, 3)[bucket.site_indices(0), g])
        assert got == pytest.approx(direct, rel=1e-9)


# -- categorization and one round ---------------------------------------------


def test_categorize_partition_equals_jax():
    rng = np.random.default_rng(3)
    patrat = np.round(rng.uniform(0.0, 4.0, 3000), 3)
    patrat[::7] += rng.uniform(0.0, 0.002, patrat[::7].shape)
    lhs = -rng.uniform(0.1, 30.0, 3000)
    for ncat in (1, 4, 25):
        cat, kept = psr._categorize_partition(patrat, lhs, ncat)
        jcat, jkept = jpsr._categorize_partition(patrat, lhs, ncat)
        np.testing.assert_array_equal(cat, jcat)
        np.testing.assert_array_equal(kept, jkept)
        assert cat.dtype == jcat.dtype and len(kept) <= ncat


@pytest.fixture(scope="module")
def smoothed_pair():
    """A PSR pair whose branches the JAX package smoothed; the port tree
    comes from the JAX tree's newick, so both start equal."""
    jinst, jtree, tinst, _ = _pair(seed=11, tree_seed=1)
    jmodel_opt.tree_evaluate(jinst, jtree, 1.0)
    newick = jtree.to_newick(jinst.alignment.taxon_names)
    return jinst, jinst.tree_from_newick(newick), tinst, \
        tinst.tree_from_newick(newick)


def test_optimize_rate_categories_matches_jax(smoothed_pair):
    jinst, jtree, tinst, ttree = smoothed_pair
    l0 = tinst.evaluate(ttree, full=True)
    assert l0 == pytest.approx(jinst.evaluate(jtree, full=True), rel=1e-10)
    jl = jpsr.optimize_rate_categories(jinst, jtree)
    tl = psr.optimize_rate_categories(tinst, ttree)
    assert tl >= l0 - 1e-9
    assert tl == pytest.approx(jl, rel=1e-9)
    assert tinst.psr_invocations == jinst.psr_invocations == 1
    np.testing.assert_array_equal(tinst.patrat[0], jinst.patrat[0])
    np.testing.assert_array_equal(tinst.rate_category[0],
                                  jinst.rate_category[0])
    np.testing.assert_allclose(tinst.per_site_rates[0],
                               jinst.per_site_rates[0], rtol=1e-9)
    assert 1 < len(tinst.per_site_rates[0]) <= 25
    part = tinst.alignment.partitions[0]
    mean = float(part.weights @ tinst.per_site_rates[0][
        tinst.rate_category[0]]) / float(part.weights.sum())
    assert mean == pytest.approx(1.0, abs=1e-9)
    # The continuous refinement of the frozen categories, from the same
    # state in both packages.
    jl = jpsr.refine_category_rates(jinst, jtree)
    tl2 = psr.refine_category_rates(tinst, ttree)
    assert tl2 >= tl - 1e-9
    assert tl2 == pytest.approx(jl, rel=1e-8)
    assert tinst.evaluate(ttree, full=True) == pytest.approx(tl2, abs=1e-6)


def test_psr_mod_opt_matches_jax():
    jinst, jtree, tinst, ttree = _pair(ntaxa=8, nsites=160, seed=5,
                                       tree_seed=2)
    l0 = tinst.evaluate(ttree, full=True)
    jl = jmodel_opt.mod_opt(jinst, jtree, 0.1, max_rounds=2)
    tl = model_opt.mod_opt(tinst, ttree, 0.1, max_rounds=2)
    assert tl > l0 + 1.0
    assert tl == pytest.approx(jl, rel=1e-8)
    assert tinst.cat_opt_rounds == jinst.cat_opt_rounds
    np.testing.assert_array_equal(tinst.rate_category[0],
                                  jinst.rate_category[0])


def test_lg4_under_psr_is_refused():
    from examl_tpu_torch.io.partitions import PartitionSpec
    names, seqs = _sequences(5, 30)
    aa = ["".join("ARNDCQEGHILKMFPSTWYV"[ord(c) % 20] for c in s)
          for s in seqs]
    data = build_alignment_data(names, aa, [PartitionSpec(
        "p", "AA", "LG4M", np.arange(30), lg4=True)])
    assert data.partitions[0].lg4
    with pytest.raises(ValueError, match="PSR"):
        PhyloInstance(data, device="cpu", rate_model="PSR")
    # Under GAMMA the same partition builds its four-matrix model.
    inst = PhyloInstance(data, device="cpu")
    assert type(inst.models[0]).__name__ == "LG4Params"
