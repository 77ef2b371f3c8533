"""Amino-acid and binary data in the port against the JAX package (float64
on the CPU, x64 on the JAX side).

* data: `protein.get_matrix` / `get_lg4` equal the JAX package's for all 19
  matrices and both LG4 sets; `build_lg4`, `lg4_with_alpha`,
  `lg4x_with_rates`, `lg4x_with_weights` and `normalize_lg4x` equal its
  results (rtol 1e-12);
* likelihood: one instance with WAG, LG+F, LG4M and LG4X partitions and a
  binary one, models carried over by `transfer` (LG4 as name, alpha, four
  rates and four weights), on the chunk and the whole tier: lnL and
  per-partition lnL rtol 1e-10; every inner node's arena row within
  1e-12 of each site's max, with equal scalers (the plain versions of
  kernels B1 and B2 on the CPU; an element far below its site's max may
  differ by more relative to itself: the P matrices' small entries come
  from sums with cancellation, taken in another order in each package);
* `mod_opt` on that alignment (one round, both packages on their default
  gradient smoothing route): lnL rtol 1e-9, alphas rtol 1e-6, LG4X's
  category rates and weights rtol 1e-9;
* checkpoints with an LG4X and an AUTO partition restore across the
  packages both ways (lnL rtol 1e-10);
* PSR on an amino-acid GTR partition: one categorization round gives
  JAX's categories, rates rtol 1e-9; LG4 under PSR raises in both;
* the tier choice: kernels B1 and B2 have instances for (R, K) = (4, 2),
  (4, 4) and (4, 20), and an engine on the card without one is refused
  when it is built.

AUTO selection and the CLI are in tests/test_torch_autoprot.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu.instance import PhyloInstance as JaxInstance
from examl_tpu.io.alignment import build_alignment_data as jbuild
from examl_tpu.io.partitions import PartitionSpec as JSpec
from examl_tpu.models import lg4 as jlg4
from examl_tpu.models.gtr import with_alpha as jwith_alpha
from examl_tpu.models import protein as jprotein
from examl_tpu.optimize import model_opt as jmodel_opt
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data as tbuild
from examl_tpu_torch.io.partitions import PartitionSpec as TSpec
from examl_tpu_torch.models import lg4, protein
from examl_tpu_torch.ops import newview_chunk, newview_whole
from examl_tpu_torch.optimize import model_opt
from examl_tpu_torch.transfer import install_model_params

AA = "ARNDCQEGHILKMFPSTWYV"
# The amino-acid partitions of the mixed alignment: (matrix, spec flags).
AA_MODELS = [("WAG", {}), ("LG", {"empirical_freqs": True}),
             ("LG4M", {"lg4": True}), ("LG4X", {"lg4": True})]


@pytest.fixture(autouse=True)
def _default_routes(monkeypatch):
    """Both packages on their default smoothing route, and one torch
    intra-op thread (the suite runs on several xdist workers at once)."""
    monkeypatch.delenv("EXAML_GRAD_SMOOTH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(ntaxa, width, nparts, seed):
    """Correlated amino-acid columns (nparts * width) and binary columns
    (width), per taxon."""
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 20, nparts * width)
    bcur = rng.integers(0, 2, width)
    aa, bn = [], []
    for _ in range(ntaxa):
        cur = np.where(rng.random(cur.size) < 0.2,
                       rng.integers(0, 20, cur.size), cur)
        bcur = np.where(rng.random(width) < 0.15,
                        rng.integers(0, 2, width), bcur)
        aa.append("".join(AA[c] for c in cur))
        bn.append("".join("01"[c] for c in bcur))
    return [f"t{i}" for i in range(ntaxa)], aa, bn


def _data(jax_side, ntaxa=10, width=60, seed=3, models=AA_MODELS,
          binary=True):
    """The mixed alignment in one package: an amino-acid partition per
    entry of `models`, then (binary=True) one binary partition."""
    build, spec = (jbuild, JSpec) if jax_side else (tbuild, TSpec)
    names, aa, bn = _sequences(ntaxa, width, len(models), seed)
    ad = build(names, aa, [spec(f"a{i}", "AA", m,
                                np.arange(i * width, (i + 1) * width), **kw)
                           for i, (m, kw) in enumerate(models)])
    if binary:
        ad.partitions += build(names, bn, [spec(
            "bin", "BIN", "GTR", np.arange(width),
            empirical_freqs=True)]).partitions
    return ad


def _carried(jmodel):
    """A JAX model as the port's transfer takes it: LG4 by name, alpha,
    rates and weights; any other model with every field (eigensystems
    carried exactly)."""
    if isinstance(jmodel, jlg4.LG4Params):
        return {"lg4": jmodel.name, "alpha": jmodel.alpha,
                "gamma_rates": jmodel.gamma_rates,
                "rate_weights": jmodel.rate_weights}
    return dataclasses.asdict(jmodel)


def _pair(newview="chunk", **kw):
    """A JAX instance with non-default models (alphas; LG4X's rates and
    weights), the port's instance holding the same models, and both
    packages' trees from one newick text."""
    jinst = JaxInstance(_data(True, **kw), dtype=jnp.float64)
    tinst = PhyloInstance(_data(False, **kw), dtype=torch.float64,
                          device="cpu", newview=newview)
    alphas = [0.4, 1.7, 0.8, 1.0, 0.6]
    for gid, m in enumerate(jinst.models):
        if isinstance(m, jlg4.LG4Params):
            m = jlg4.lg4_with_alpha(m, alphas[gid])
            if m.is_lg4x:
                m = jlg4.lg4x_with_weights(m, np.array([0.4, 0.3, 0.2, 0.1]))
                m = jlg4.lg4x_with_rates(m, np.array([0.2, 0.6, 1.4, 3.0]))
        else:
            m = jwith_alpha(m, alphas[gid])
        jinst.models[gid] = m
    jinst.push_models()
    install_model_params(tinst, [_carried(m) for m in jinst.models])
    newick = jinst.random_tree(seed=5).to_newick(jinst.alignment.taxon_names)
    return (jinst, jinst.tree_from_newick(newick), tinst,
            tinst.tree_from_newick(newick))


# -- data ------------------------------------------------------------------


def test_protein_data_matches_jax():
    assert protein.MATRICES == jprotein.MATRICES
    assert protein.LG4_MODELS == jprotein.LG4_MODELS
    assert len(protein.MATRICES) == 19
    for name in protein.MATRICES:
        for ours, theirs in zip(protein.get_matrix(name),
                                jprotein.get_matrix(name)):
            np.testing.assert_array_equal(ours, theirs)
    for name in protein.LG4_MODELS:
        for ours, theirs in zip(protein.get_lg4(name),
                                jprotein.get_lg4(name)):
            assert len(ours) == len(theirs) == 4
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
    with open(protein._DATA_PATH, "rb") as f, \
            open(jprotein._DATA_PATH, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", ["LG4M", "LG4X"])
def test_lg4_builders_match_jax(name):
    def same(m, jm):
        for f in ("gamma_rates", "rate_weights"):
            np.testing.assert_allclose(getattr(m, f), getattr(jm, f),
                                       rtol=1e-12)
        for f in ("eign_list", "ev_list", "ei_list", "freqs_list",
                  "rates_list"):
            for a, b in zip(getattr(m, f), getattr(jm, f)):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
        assert (m.name, m.alpha, m.ncat) == (jm.name, jm.alpha, jm.ncat)

    m, jm = lg4.build_lg4(name, alpha=0.7), jlg4.build_lg4(name, alpha=0.7)
    same(m, jm)
    same(lg4.lg4_with_alpha(m, 2.3), jlg4.lg4_with_alpha(jm, 2.3))
    w = np.array([0.1, 0.2, 0.3, 0.4])
    same(lg4.lg4x_with_weights(m, w), jlg4.lg4x_with_weights(jm, w))
    r = np.array([0.05, 0.5, 1.5, 12.0])            # 12 clips to 10
    same(lg4.lg4x_with_rates(m, r), jlg4.lg4x_with_rates(jm, r))
    np.testing.assert_allclose(lg4.normalize_lg4x(r, w),
                               jlg4.normalize_lg4x(r, w), rtol=1e-12)


def test_initial_models_match_jax():
    """The instance's model branches: empirical matrices with their own or
    the data's frequencies, LG4 sets, binary GTR."""
    jinst = JaxInstance(_data(True), dtype=jnp.float64)
    tinst = PhyloInstance(_data(False), dtype=torch.float64, device="cpu")
    assert sorted(tinst.engines) == sorted(jinst.engines) == [2, 20]
    for m, jm in zip(tinst.models, jinst.models):
        assert type(m).__name__ == type(jm).__name__
        for f in ("gamma_rates", "rates", "freqs"):
            np.testing.assert_allclose(getattr(m, f), getattr(jm, f),
                                       rtol=1e-12)
    np.testing.assert_array_equal(tinst.models[1].freqs,
                                  tinst.alignment.partitions[1]
                                  .empirical_freqs)


# -- likelihood --------------------------------------------------------------


@pytest.mark.parametrize("newview", ["chunk", "whole"])
def test_lnl_and_rows_match_jax(newview):
    jinst, jtree, tinst, ttree = _pair(newview)
    before = (newview_chunk.LAUNCHES, newview_whole.LAUNCHES)
    jl = jinst.evaluate(jtree, full=True)
    tl = tinst.evaluate(ttree, full=True)
    assert (newview_chunk.LAUNCHES, newview_whole.LAUNCHES) == before
    assert tl == pytest.approx(jl, rel=1e-10)
    np.testing.assert_allclose(tinst.per_partition_lnl,
                               np.asarray(jinst.per_partition_lnl),
                               rtol=1e-10)
    for states in (20, 2):
        jeng, teng = jinst.engines[states], tinst.engines[states]
        jclv, jsc = np.asarray(jeng.clv), np.asarray(jeng.scaler)
        tclv, tsc = teng.clv.numpy(), teng.scaler.numpy()
        for num in range(tinst.alignment.ntaxa + 1,
                         2 * tinst.alignment.ntaxa - 1):
            jrow, trow = jeng.row_map[num], teng.row_map[num]
            np.testing.assert_array_equal(tsc[trow], jsc[jrow])
            smax = np.abs(jclv[jrow]).max(axis=(2, 3), keepdims=True)
            assert np.all(np.abs(tclv[trow] - jclv[jrow]) <= 1e-12 * smax)
    # makenewz across the two buckets (the host Newton loop).
    p = ttree.nodep[ttree.ntips + 3]
    jp = jtree.nodep[jtree.ntips + 3]
    tz = tinst.makenewz(ttree, p, p.back, list(p.z), maxiter=30)
    jz = jinst.makenewz(jtree, jp, jp.back, list(jp.z), maxiter=30)
    np.testing.assert_allclose(tz, jz, rtol=1e-8)


def test_mod_opt_matches_jax():
    jinst, jtree, tinst, ttree = _pair(ntaxa=8, width=40)
    l0 = tinst.evaluate(ttree, full=True)
    jl = jmodel_opt.mod_opt(jinst, jtree, 0.1, max_rounds=1)
    tl = model_opt.mod_opt(tinst, ttree, 0.1, max_rounds=1)
    assert tl > l0 + 1.0                        # the model moved
    assert tl == pytest.approx(jl, rel=1e-9)
    for m, jm in zip(tinst.models, jinst.models):
        assert m.alpha == pytest.approx(jm.alpha, rel=1e-6)
    m, jm = tinst.models[3], jinst.models[3]
    assert m.is_lg4x
    np.testing.assert_allclose(m.gamma_rates, jm.gamma_rates, rtol=1e-9)
    np.testing.assert_allclose(m.rate_weights, jm.rate_weights, rtol=1e-9)
    assert not np.allclose(m.rate_weights, 0.25)
    assert float(m.rate_weights @ m.gamma_rates) == pytest.approx(1.0)


# -- checkpoints -------------------------------------------------------------


def _ckpt_instance(jax_side):
    """An LG4X and an AUTO partition plus a binary one; LG4X with free
    rates and weights, AUTO resolved to LG with the data's frequencies."""
    models = [("LG4X", {"lg4": True}), ("AUTO", {"auto": True})]
    ad = _data(jax_side, ntaxa=8, width=40, models=models)
    if jax_side:
        from examl_tpu.models.gtr import build_model
        inst, L = JaxInstance(ad, dtype=jnp.float64), jlg4
    else:
        from examl_tpu_torch.models.gtr import build_model
        inst, L = PhyloInstance(ad, dtype=torch.float64, device="cpu"), lg4
    m = L.lg4x_with_weights(inst.models[0], np.array([0.1, 0.2, 0.3, 0.4]))
    inst.models[0] = L.lg4x_with_rates(m, np.array([0.3, 0.7, 1.1, 2.5]))
    part = ad.partitions[1]
    rates, _ = (jprotein if jax_side else protein).get_matrix("LG")
    inst.models[1] = build_model(part.datatype, part.empirical_freqs,
                                 rates=rates, alpha=0.9)
    inst.auto_prot_models[1] = "LG"
    inst.auto_prot_freqs[1] = "empirical"
    inst.push_models()
    tree = inst.random_tree(seed=4)
    inst.evaluate(tree, full=True)
    return inst, tree


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_lg4x_and_auto_across_packages(tmp_path, writer):
    from examl_tpu.search import checkpoint as jcheckpoint
    from examl_tpu_torch.search import checkpoint
    src_inst, src_tree = _ckpt_instance(writer == "jax")
    mgr = (jcheckpoint if writer == "jax" else checkpoint).CheckpointManager
    mgr(str(tmp_path), "run").write("FAST_SPRS", {"k": 1}, src_inst,
                                    src_tree)
    dst_inst = (PhyloInstance(_data(False, ntaxa=8, width=40, models=[
        ("LG4X", {"lg4": True}), ("AUTO", {"auto": True})]),
        dtype=torch.float64, device="cpu") if writer == "jax" else
        JaxInstance(_data(True, ntaxa=8, width=40, models=[
            ("LG4X", {"lg4": True}), ("AUTO", {"auto": True})]),
            dtype=jnp.float64))
    rmgr = (checkpoint if writer == "jax" else jcheckpoint).CheckpointManager
    dst_tree = dst_inst.random_tree(seed=9)
    resume = rmgr(str(tmp_path), "run").restore(dst_inst, dst_tree)
    assert resume == {"state": "FAST_SPRS", "extras": {"k": 1}}
    assert dst_inst.likelihood == pytest.approx(src_inst.likelihood,
                                                rel=1e-10)
    assert dst_inst.auto_prot_models == {1: "LG"}
    assert dst_inst.auto_prot_freqs == {1: "empirical"}
    m, sm = dst_inst.models[0], src_inst.models[0]
    assert m.is_lg4x and type(m).__name__ == "LG4Params"
    np.testing.assert_allclose(m.gamma_rates, sm.gamma_rates, rtol=1e-15)
    np.testing.assert_allclose(m.rate_weights, sm.rate_weights, rtol=1e-15)
    np.testing.assert_allclose(dst_inst.models[1].freqs,
                               src_inst.models[1].freqs, rtol=1e-15)


# -- PSR ---------------------------------------------------------------------


def test_psr_round_on_aa_gtr_matches_jax():
    from examl_tpu.optimize import psr as jpsr
    from examl_tpu_torch.optimize import psr
    models = [("GTR", {"empirical_freqs": True})]
    jinst = JaxInstance(_data(True, ntaxa=8, width=120, models=models,
                              binary=False),
                        dtype=jnp.float64, rate_model="PSR")
    tinst = PhyloInstance(_data(False, ntaxa=8, width=120, models=models,
                                binary=False),
                          dtype=torch.float64, device="cpu",
                          rate_model="PSR")
    newick = jinst.random_tree(seed=1).to_newick(jinst.alignment.taxon_names)
    jtree = jinst.tree_from_newick(newick)
    jmodel_opt.tree_evaluate(jinst, jtree, 1.0)
    newick = jtree.to_newick(jinst.alignment.taxon_names)
    jtree, ttree = jinst.tree_from_newick(newick), \
        tinst.tree_from_newick(newick)
    l0 = tinst.evaluate(ttree, full=True)
    assert l0 == pytest.approx(jinst.evaluate(jtree, full=True), rel=1e-10)
    jl = jpsr.optimize_rate_categories(jinst, jtree)
    tl = psr.optimize_rate_categories(tinst, ttree)
    assert tl >= l0 - 1e-9
    assert tl == pytest.approx(jl, rel=1e-9)
    np.testing.assert_array_equal(tinst.rate_category[0],
                                  jinst.rate_category[0])
    np.testing.assert_allclose(tinst.per_site_rates[0],
                               jinst.per_site_rates[0], rtol=1e-9)
    assert 1 < len(tinst.per_site_rates[0]) <= 25


@pytest.mark.parametrize("kw,match", [({"rate_model": "PSR"}, "PSR"),
                                      ({"ncat": 3}, "4 rate categories")])
def test_lg4_refusals_match_jax(kw, match):
    models = [("LG4M", {"lg4": True})]
    with pytest.raises(ValueError, match=match):
        JaxInstance(_data(True, ntaxa=5, width=30, models=models,
                          binary=False), **kw)
    with pytest.raises(ValueError, match=match):
        PhyloInstance(_data(False, ntaxa=5, width=30, models=models,
                            binary=False), device="cpu", **kw)


# -- the tier choice ---------------------------------------------------------


def test_kernel_instances():
    for mod in (newview_chunk, newview_whole):
        for rk in ((4, 2), (4, 4), (4, 20)):
            assert mod.supported(*rk)
        for rk in ((1, 4), (3, 20), (4, 3), (4, 61)):
            assert not mod.supported(*rk)


@pytest.mark.parametrize("newview", ["chunk", "whole"])
def test_engine_without_kernel_instance_is_refused_on_cuda(monkeypatch,
                                                           newview):
    """ncat = 3 has no B1/B2 instance: an engine on the card is refused
    when it is built (the device check stubbed: no card here), and the
    same engine on the CPU, where the plain versions serve any (R, K),
    gives the JAX package's lnL."""
    from examl_tpu_torch import config
    ad = _data(False, ntaxa=6, width=30, models=AA_MODELS[:2])
    monkeypatch.setattr(config, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(ValueError, match=r"no instance for \(R, K\) = "
                                         r"\(3, (20|2)\)"):
        PhyloInstance(ad, ncat=3, newview=newview)
    monkeypatch.undo()
    tinst = PhyloInstance(ad, ncat=3, dtype=torch.float64, device="cpu",
                          newview=newview)
    jinst = JaxInstance(_data(True, ntaxa=6, width=30,
                              models=AA_MODELS[:2]), ncat=3,
                        dtype=jnp.float64)
    newick = jinst.random_tree(seed=2).to_newick(jinst.alignment.taxon_names)
    assert tinst.evaluate(tinst.tree_from_newick(newick), full=True) == \
        pytest.approx(jinst.evaluate(jinst.tree_from_newick(newick),
                                     full=True), rel=1e-10)
