"""bfloat16 CLV storage (`clv_dtype=torch.bfloat16`, the CLI's
`--clv-dtype bf16`) against the JAX package's EXAML_CLV_DTYPE=bf16, on the
CPU, both in float32 compute (JAX with x64 on, so its root sums are
float64 like the port's).  Arena and pool values are compared as float32
on both sides (the upcast from bfloat16 is exact).

Tolerances, with the gaps measured when they were set:

* arena rows after a full traversal (the chunk tier, kernel B1's plain
  version; JAX's XLA chunk program) and after a partial one (the
  wave-scan tier) on ref49: scalers equal; every cell within 2^-5 of its
  site's maximum (measured 0.0072 and 0.0087, about one bfloat16 ulp);
  at least 90% of the cells bitwise equal (measured 94.5% and 95.0%).
  Bitwise agreement cannot reach 99% across the packages: they build P
  and sum the products in other orders, so their float32 values part in
  the last bits (with float32 storage too), a bfloat16 rounding that
  goes the other way changes a cell by one ulp, and the change travels
  up the tree;
* the port's chunk rows, each launch recomputed in float64 from the same
  bfloat16 child rows: at least 99.9% of the cells are the float64
  result rounded to nearest (measured 99.997% on ref49), the rest one
  ulp off (a float32 sum on the other side of a rounding boundary);
* root and per-partition lnL rel 1e-5 (measured on ref49 8.1e-7 full,
  per partition 1.5e-6; 8.4e-7 partial);
* each package's bfloat16 lnL against its own float32 lnL: on the 8-taxon
  fixture within 4.0, the bound tests/test_numerics.py holds the JAX
  package to on testData/49 (measured 0.19 full, 0.13 partial, in both
  packages); on ref49 under the reference's model both packages sit 5.19
  below their float32 lnL (rel 3.2e-4), beyond that bound, so there the
  port's gap is held to JAX's within 0.05 and both below rel 1e-3 of the
  lnL;
* whole-tree d1 / d2 on ref49: within 5e-4 of the largest |d1| / |d2|
  (measured 7.1e-5 / 8.2e-5);
* PSR: lnL rel 1e-5 (measured 3.0e-10; the synthetic tree is shallow),
  the rate scan (whose scratch arena stays float32 in both packages)
  every per-site lnL within 1e-5 of the largest |value| (measured
  2.3e-7);
* the batched lazy scan's candidates rel 1e-5 (measured 4.4e-9);
* -S: the same cell ids, slot maps and statistics as JAX, the lnL rel
  1e-5 (measured 2.3e-9), pool cells as the arena rows above (measured
  97.7% bitwise equal).

The `cuda` cases hold each bfloat16-storage instance of kernel B1 (K = 4,
20, 2; kinds 0/1/2; a forced rescale) to its plain version on the card:
scalers equal, every cell within one bfloat16 ulp of its site's maximum.
They import no JAX: `python -m pytest --noconftest -m cuda
tests/test_torch_bf16.py`.
"""

import contextlib
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from examl_tpu_torch import config
from examl_tpu_torch.cli.main import main
from examl_tpu_torch.instance import PhyloInstance
from examl_tpu_torch.io.alignment import build_alignment_data
from examl_tpu_torch.io.bytefile import read_bytefile, write_bytefile
from examl_tpu_torch.io.partitions import PartitionSpec, parse_partition_file
from examl_tpu_torch.ops import fastpath, newview_chunk, newview_whole
from examl_tpu_torch.optimize import branch
from examl_tpu_torch.search import batchscan, spr
from examl_tpu_torch.transfer import install_model_params
from examl_tpu_torch.tree.topology import Tree

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "ref49")
BF16 = torch.bfloat16
F32 = torch.float32


def _jax():
    """The JAX package's modules, imported inside the tests that use them:
    the card's machine, which runs the cuda cases, has no JAX."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as Instance
    from examl_tpu.io.alignment import build_alignment_data as build
    from examl_tpu.io.bytefile import read_bytefile as read
    from examl_tpu.io.partitions import parse_partition_file as parse
    from examl_tpu.optimize import branch as jbranch
    from examl_tpu.search import batchscan as jbatchscan
    from examl_tpu.search import spr as jspr
    return SimpleNamespace(jnp=jnp, Instance=Instance, build=build,
                           read=read, parse=parse, branch=jbranch,
                           batchscan=jbatchscan, spr=jspr)


@pytest.fixture(autouse=True)
def _routes(monkeypatch):
    """One torch intra-op thread (the suite runs on several xdist workers
    at once); the JAX package on bfloat16 storage and per-branch
    smoothing, with no batching switch inherited."""
    monkeypatch.setenv("EXAML_CLV_DTYPE", "bf16")
    monkeypatch.setenv("EXAML_GRAD_SMOOTH", "0")
    monkeypatch.delenv("EXAML_BATCH_SCAN", raising=False)
    monkeypatch.delenv("EXAML_BATCH_THOROUGH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eng(inst):
    (eng,) = inst.engines.values()
    return eng


@contextlib.contextmanager
def _clv_env(value):
    """EXAML_CLV_DTYPE set to `value` (None: unset) while the JAX package
    builds an instance (its engine reads it at construction)."""
    old = os.environ.pop("EXAML_CLV_DTYPE", None)
    if value is not None:
        os.environ["EXAML_CLV_DTYPE"] = value
    try:
        yield
    finally:
        os.environ.pop("EXAML_CLV_DTYPE", None)
        if old is not None:
            os.environ["EXAML_CLV_DTYPE"] = old


def _f32(t) -> np.ndarray:
    """A tensor or JAX array as float32 numpy (exact from bfloat16)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(np.float32))


def _compare_cells(tc, jc, ts=None, js=None, what=""):
    """Cells [..., R, K] of the two packages: scalers equal, >= 90% of the
    values bitwise equal, every value within 2^-5 of its site's max."""
    if ts is not None:
        np.testing.assert_array_equal(ts, js)
    same = float((tc == jc).mean())
    assert same >= 0.9, (what, same)
    smax = np.abs(jc).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(tc - jc) <= 2.0 ** -5 * smax), what
    return same


def _compare_arenas(tinst, jinst, ntips):
    """Every inner node's current row in both arenas, through each
    engine's own row map."""
    teng, jeng = _eng(tinst), _eng(jinst)
    nums = np.arange(ntips + 1, 2 * ntips - 1)
    trows, jrows = teng.row_map[nums], np.asarray(jeng.row_map)[nums]
    return _compare_cells(_f32(teng.clv)[trows], _f32(jeng.clv)[jrows],
                          teng.scaler.numpy()[trows],
                          np.asarray(jeng.scaler)[jrows], "arena")


def _ref49(bf16=True):
    """(JAX instance, JAX tree, port instance, port tree) on ref49 under
    the reference's model, float32 compute, bfloat16 storage or not."""
    from tests.refmodel import install_reference_params, parse_model_file
    J = _jax()
    params = parse_model_file(os.path.join(FIX, "modelFile"))
    with open(os.path.join(FIX, "TreeFile")) as f:
        newick = f.read()
    path = os.path.join(FIX, "aln49.binary")
    with _clv_env("bf16" if bf16 else None):
        jinst = J.Instance(J.read(path), dtype=J.jnp.float32)
    install_reference_params(jinst, params)
    tinst = PhyloInstance(read_bytefile(path), dtype=F32, device="cpu",
                          clv_dtype=BF16 if bf16 else None,
                          grad_smooth=False)
    install_model_params(tinst, [(p.rates, p.freqs, p.alpha)
                                 for p in params])
    return (jinst, jinst.tree_from_newick(newick), tinst,
            tinst.tree_from_newick(newick))


@pytest.fixture(scope="module")
def ref49_f32():
    """Each package's float32-storage lnL of ref49 (full traversal)."""
    jinst, jtree, tinst, ttree = _ref49(bf16=False)
    return jinst.evaluate(jtree, full=True), tinst.evaluate(ttree, full=True)


def _sequences(ntaxa=8, nsites=240, seed=4):
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    cur = rng.integers(0, 4, nsites)
    seqs = []
    for _ in names:
        flip = rng.random(nsites) < 0.2
        cur = np.where(flip, rng.integers(0, 4, nsites), cur)
        seqs.append("".join("ACGT"[c] for c in cur))
    return names, seqs


def _pair(ntaxa=8, nsites=240, seed=4, **kw):
    """(JAX instance, JAX tree, port instance, port tree) on a correlated
    synthetic alignment and JAX's random tree, bfloat16 storage."""
    J = _jax()
    names, seqs = _sequences(ntaxa, nsites, seed)
    jinst = J.Instance(J.build(names, seqs), dtype=J.jnp.float32, **kw)
    tinst = PhyloInstance(build_alignment_data(names, seqs), dtype=F32,
                          device="cpu", clv_dtype=BF16, grad_smooth=False,
                          **kw)
    newick = jinst.random_tree(seed).to_newick(names)
    return (jinst, jinst.tree_from_newick(newick), tinst,
            tinst.tree_from_newick(newick))


# -- storage and refusals -----------------------------------------------------


def test_storage_dtypes():
    """The arena, its scan region and the SEV pool store bfloat16 in both
    packages; the scaler stays int32, the outroot arena float32."""
    jinst, _, tinst, ttree = _pair()
    teng, jeng = _eng(tinst), _eng(jinst)
    assert tinst.storage_dtype == teng.storage_dtype == BF16
    assert teng.dtype == F32 and teng.scale_exp == 32
    assert teng.clv.dtype == BF16 and teng.scaler.dtype == torch.int32
    assert jeng.clv.dtype == _jax().jnp.bfloat16
    teng.ensure_scan_rows(3)
    assert teng.clv.dtype == BF16 and teng.clv.shape[0] > teng.num_rows
    tinst.evaluate(ttree, full=True)
    assert teng._outroot_arena().dtype == F32
    sev = PhyloInstance(build_alignment_data(*_sequences()), dtype=F32,
                        device="cpu", clv_dtype="bf16", save_memory=True)
    sev.evaluate(sev.random_tree(1), full=True)
    assert _eng(sev).sev.pool.dtype == BF16
    assert _eng(sev).sev.stats()["cell_bytes"] == 128 * 4 * 4 * 2


def test_refusals():
    """float64 + bfloat16 and the whole tier + bfloat16 raise when built;
    the kernel instances list bfloat16 for B1 only."""
    assert config.clv_storage_dtype(F32, None) == F32
    assert config.clv_storage_dtype(torch.float64, "same") == torch.float64
    assert config.clv_storage_dtype(F32, "bf16") == BF16
    with pytest.raises(ValueError, match="float32 compute"):
        config.clv_storage_dtype(torch.float64, BF16)
    with pytest.raises(ValueError, match="expected one of"):
        config.clv_storage_dtype(F32, "fp8")
    ad = build_alignment_data(*_sequences())
    with pytest.raises(ValueError, match="float32 compute"):
        PhyloInstance(ad, dtype=torch.float64, device="cpu", clv_dtype=BF16)
    with pytest.raises(ValueError, match="kernel B2 has no such instance"):
        PhyloInstance(ad, dtype=F32, device="cpu", clv_dtype=BF16,
                      newview="whole")
    for K in (2, 4, 20):
        assert newview_chunk.supported(4, K, BF16)
        assert not newview_whole.supported(4, K, BF16)
        assert newview_whole.supported(4, K, F32)
    assert not newview_chunk.supported(4, K, torch.float16)


# -- the two tiers on ref49 ---------------------------------------------------


def test_chunk_tier_matches_jax(ref49_f32):
    """A full traversal on the chunk tier (kernel B1's plain version on the
    CPU) against JAX's chunk program with bfloat16 storage."""
    jinst, jtree, tinst, ttree = _ref49()
    jl = jinst.evaluate(jtree, full=True)
    tl = tinst.evaluate(ttree, full=True)
    _compare_arenas(tinst, jinst, ttree.ntips)
    assert tl == pytest.approx(jl, rel=1e-5)
    np.testing.assert_allclose(tinst.per_partition_lnl,
                               jinst.per_partition_lnl, rtol=1e-5)
    jf, tf = ref49_f32
    assert abs((tl - tf) - (jl - jf)) < 0.05
    assert abs(tl - tf) < 1e-3 * abs(tf) and abs(jl - jf) < 1e-3 * abs(jf)


def test_chunk_rows_round_to_nearest():
    """Each launch of the port's ref49 chunk tier recomputed in float64
    from the same bfloat16 child rows and the same P: the stored rows are
    that result rounded to nearest, scalers equal."""
    from examl_tpu_torch.ops import fastpath
    _, _, tinst, ttree = _ref49()
    tinst.evaluate(ttree, full=True)
    eng = _eng(tinst)
    flat = ttree.flat_full_traversal(ttree.centroid_branch())
    st = eng._structure(flat)
    zl, zr = fastpath.refresh_z(st, flat, 1, F32, eng.device)
    pmat = newview_chunk.chunk_operands(eng.models, zl, zr).double()
    table = eng.tips.table.double()
    same = []
    for row in st.launch.tolist():
        c, s = eng.clv.double(), eng.scaler.clone()
        newview_chunk.chunk_apply_plain(
            c, s, eng.tips.codes, table, eng.block_part_i32,
            np.asarray([row], np.int32), st.lidx, st.ridx, st.lcode,
            st.rcode, pmat, eng.scale_exp)
        rows = slice(row[1], row[1] + row[3])
        assert torch.equal(s[rows], eng.scaler[rows])
        near = c[rows].to(BF16)
        same.append((near == eng.clv[rows]).reshape(-1))
        diff = (near.float() - eng.clv[rows].float()).abs()
        smax = c[rows].abs().amax(dim=(3, 4), keepdim=True).float()
        assert bool((diff <= 2.0 ** -7 * smax).all())
    assert float(torch.cat(same).double().mean()) >= 0.999


def test_wave_scan_tier_matches_jax():
    """A partial traversal (the wave-scan tier) after the full one."""
    jinst, jtree, tinst, ttree = _ref49()
    jinst.evaluate(jtree, full=True)
    tinst.evaluate(ttree, full=True)
    num = ttree.ntips + 5
    jl = jinst.evaluate(jtree, jtree.nodep[num])
    tl = tinst.evaluate(ttree, ttree.nodep[num])
    _compare_arenas(tinst, jinst, ttree.ntips)
    assert tl == pytest.approx(jl, rel=1e-5)
    np.testing.assert_allclose(tinst.per_partition_lnl,
                               jinst.per_partition_lnl, rtol=1e-5)


def test_gap_to_float32_storage():
    """On the 8-taxon fixture each package's bfloat16 lnL lies within 4.0
    of its own float32 lnL, full and partial traversals."""
    jinst, jtree, tinst, ttree = _pair()
    J = _jax()
    names, seqs = _sequences()
    with _clv_env(None):
        jref = J.Instance(J.build(names, seqs), dtype=J.jnp.float32)
    tref = PhyloInstance(build_alignment_data(names, seqs), dtype=F32,
                         device="cpu")
    newick = jtree.to_newick(names)
    for inst, ref in ((jinst, jref), (tinst, tref)):
        tree, rtree = inst.tree_from_newick(newick), \
            ref.tree_from_newick(newick)
        assert abs(inst.evaluate(tree, full=True)
                   - ref.evaluate(rtree, full=True)) < 4.0
        num = tree.ntips + 3
        assert abs(inst.evaluate(tree, tree.nodep[num])
                   - ref.evaluate(rtree, rtree.nodep[num])) < 4.0


def test_whole_tree_gradients_match_jax():
    jinst, jtree, tinst, ttree = _ref49()
    jinst.evaluate(jtree, full=True)
    tinst.evaluate(ttree, full=True)
    jslots, jd1, jd2 = _jax().branch.tree_gradients(jinst, jtree)
    tslots, td1, td2 = branch.tree_gradients(tinst, ttree)
    assert [s.number for s in tslots] == [s.number for s in jslots]
    np.testing.assert_allclose(td1, jd1, rtol=0,
                               atol=5e-4 * np.abs(jd1).max())
    np.testing.assert_allclose(td2, jd2, rtol=0,
                               atol=5e-4 * np.abs(jd2).max())


# -- PSR, the batched scan, -S ------------------------------------------------


def test_psr_rate_scan_matches_jax():
    """PSR over a bfloat16 arena (every traversal on the wave-scan tier),
    then one rate-scan chunk of three rates."""
    jinst, jtree, tinst, ttree = _pair(10, 240, 7, rate_model="PSR")
    assert tinst.evaluate(ttree, full=True) == \
        pytest.approx(jinst.evaluate(jtree, full=True), rel=1e-5)
    _compare_arenas(tinst, jinst, ttree.ntips)
    bucket = tinst.buckets[4]
    grid = np.concatenate([np.full((bucket.num_blocks, bucket.lane, 1), r)
                           for r in (0.5, 2.0, 3.5)], axis=2)
    out = []
    for inst, tree in ((jinst, jtree), (tinst, ttree)):
        p, entries = tree.full_traversal()
        out.append(np.asarray(_eng(inst).rate_scan(
            entries, p.number, p.back.number, p.z, grid)))
    np.testing.assert_allclose(out[1], out[0], rtol=0,
                               atol=1e-5 * np.abs(out[0]).max())


def test_batched_lazy_scan_matches_jax():
    """batchscan.run_plan over the bfloat16 arena and its scan region
    against JAX's."""
    J = _jax()
    jinst, jtree, tinst, ttree = _pair(14, 300, 1)
    jinst.evaluate(jtree, full=True)
    tinst.evaluate(ttree, full=True)
    plans = []
    for mod, bmod, inst, tree in ((J.spr, J.batchscan, jinst, jtree),
                                  (spr, batchscan, tinst, ttree)):
        ctx = mod.SprContext(inst, thorough=False, do_cutoff=False)
        p = next(tree.nodep[n] for n in tree.inner_numbers()
                 if not tree.is_tip(tree.nodep[n].next.back.number)
                 and not tree.is_tip(tree.nodep[n].next.next.back.number))
        q1, q2 = p.next.back, p.next.next.back
        mod.remove_node(inst, tree, ctx, p)
        plans.append(bmod.plan_for_endpoints(inst, tree, p, q1, q2, 1, 5))
    assert len(plans[1].candidates) >= 8
    jl = J.batchscan.run_plan(jinst, jtree, plans[0])
    tl = batchscan.run_plan(tinst, ttree, plans[1])
    assert _eng(tinst).clv.dtype == BF16
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def _gappy(ntaxa=12, genes=2, gene_sites=128, seed=5):
    """The JAX package's tests/test_sev.py shape: gene g sequenced for
    its share of the taxa, all gap elsewhere."""
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    per = ntaxa // genes
    seqs = ["" for _ in names]
    parts, pos = [], 1
    for g in range(genes):
        for i in range(ntaxa):
            seqs[i] += ("".join("ACGT"[b] for b in
                                rng.integers(0, 4, gene_sites))
                        if g * per <= i < (g + 1) * per
                        else "-" * gene_sites)
        parts.append(f"DNA, gene{g} = {pos}-{pos + gene_sites - 1}")
        pos += gene_sites
    return names, seqs, "\n".join(parts) + "\n"


def test_sev_pool_matches_jax(tmp_path):
    """-S with bfloat16 storage: the same cell ids, slot maps and
    statistics as JAX, the pool cells and the lnL as the arena above."""
    from examl_tpu_torch.ops.sev import SCRATCH_CELL
    J = _jax()
    names, seqs, text = _gappy()
    model = tmp_path / "parts.model"
    model.write_text(text)
    jinst = J.Instance(J.build(names, seqs, specs=J.parse(str(model))),
                       dtype=J.jnp.float32, save_memory=True)
    tinst = PhyloInstance(build_alignment_data(
        names, seqs, specs=parse_partition_file(str(model))), dtype=F32,
        device="cpu", clv_dtype=BF16, save_memory=True, grad_smooth=False)
    newick = jinst.random_tree(7).to_newick(names)
    jl = jinst.evaluate(jinst.tree_from_newick(newick), full=True)
    tl = tinst.evaluate(tinst.tree_from_newick(newick), full=True)
    assert tl == pytest.approx(jl, rel=1e-5)
    tsev, jsev = _eng(tinst).sev, _eng(jinst).sev
    np.testing.assert_array_equal(tsev.cell_of, jsev.cell_of)
    np.testing.assert_array_equal(tsev.slot_read.numpy(),
                                  np.asarray(jsev.slot_read))
    np.testing.assert_array_equal(tsev.slot_write.numpy(),
                                  np.asarray(jsev.slot_write))
    assert tsev.stats() == jsev.stats()
    assert tsev.pool.dtype == BF16
    assert jsev.pool.dtype == J.jnp.bfloat16
    n = tsev.next_cell[0]
    cells = np.arange(n) != SCRATCH_CELL
    _compare_cells(_f32(tsev.pool)[:n][cells],
                   _f32(jsev.pool)[:n][cells], what="pool")
    np.testing.assert_array_equal(_eng(tinst).scaler.numpy(),
                                  np.asarray(_eng(jinst).scaler))


# -- the CLI ------------------------------------------------------------------


def _cli_inputs(tmp_path):
    names, seqs = _sequences()
    specs = [PartitionSpec("a", "DNA", "GTR", np.arange(0, 120)),
             PartitionSpec("b", "DNA", "GTR", np.arange(120, 240))]
    aln = str(tmp_path / "aln.binary")
    write_bytefile(aln, build_alignment_data(names, seqs, specs))
    trees = str(tmp_path / "trees.nwk")
    with open(trees, "w") as f:
        for seed in (1, 2):
            f.write(Tree.random(names, seed, 1).to_newick(names) + "\n")
    return aln, trees


def _logged(out, run="T"):
    with open(os.path.join(out, f"ExaML_log.{run}")) as f:
        return [float(line.split()[1]) for line in f.read().splitlines()]


def test_cli_tree_evaluation(tmp_path):
    """`-f e --clv-dtype bf16` in float32: the info line names the storage;
    the endpoint re-evaluates with float32 storage within 4.0 of the
    logged lnL; `-R` from the checkpoint after the first tree rebuilds the
    arena in bfloat16 (checkpoints hold no CLVs) and ends where the
    continuous run did; --newview whole and a float64 run are refused."""
    from tests.refmodel import parse_model_file
    aln, trees = _cli_inputs(tmp_path)
    out = str(tmp_path / "out")
    argv = ["-s", aln, "-t", trees, "-n", "T", "-w", out, "-f", "e",
            "--clv-dtype", "bf16"]
    assert main(argv, device="cpu", dtype=F32) == 0
    info = open(os.path.join(out, "ExaML_info.T")).read()
    assert "dtype: torch.float32  clv storage: bfloat16" in info
    logged = _logged(out)
    params = parse_model_file(os.path.join(out, "ExaML_modelFile.T"))
    inst = PhyloInstance(read_bytefile(aln), dtype=F32, device="cpu")
    install_model_params(inst, [(p.rates, p.freqs, p.alpha)
                                for p in params])
    newicks = open(os.path.join(out, "ExaML_TreeFile.T")).read().split()
    for i in range(2):
        lnl = inst.evaluate(inst.tree_from_newick(newicks[i]), full=True)
        assert abs(lnl - logged[i]) < 4.0
    ckpts = sorted(int(f.split("ckpt_")[1].split(".")[0])
                   for f in os.listdir(out) if "ckpt_" in f)
    os.remove(os.path.join(out, f"ExaML_binaryCheckpoint.T.ckpt_"
                                f"{ckpts[-1]}.json.gz"))
    assert main(argv + ["-R"], device="cpu", dtype=F32) == 0
    info = open(os.path.join(out, "ExaML_info.T")).read()
    assert "restart at tree 1" in info
    assert info.count("clv storage: bfloat16") == 2
    assert _logged(out)[2] == pytest.approx(logged[1], abs=1e-5)
    for bad, kw in ((["--newview", "whole"], dict(dtype=F32)), ([], {})):
        with pytest.raises(SystemExit) as exc:
            main(argv + bad, device="cpu", **kw)
        assert exc.value.code == 2


# -- the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


def _case(dev, K, C, launch, seed, W=16, B=8):
    """Random inputs of a launch table over slots [0, 2W): a bfloat16
    arena and a float32 tip table whose values sit around 2^-17 (so
    products straddle 2^-32 and some sites of every kind rescale),
    float32 P."""
    rng = np.random.default_rng(seed)
    L, M, ntips = 128, 2, 6
    rows = 4 * W + 1
    f32 = dict(dtype=F32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pmat = torch.as_tensor(rng.uniform(0, 1, (2 * W, 2, M, 4, K, K)) * 4 / K,
                           **f32)
    table = torch.as_tensor(rng.uniform(0, 1, (C, K)), **f32) * 2.0 ** -17
    clv = (torch.as_tensor(rng.uniform(0, 1, (rows, B, L, 4, K)), **f32)
           * 2.0 ** -17).to(BF16)
    scaler = torch.as_tensor(rng.integers(0, 3, (rows, B, L)), **i32)
    codes = torch.as_tensor(rng.integers(0, C, (ntips, B, L)),
                            dtype=torch.uint8, device=dev)
    lidx = np.concatenate([rng.permutation(W), 2 * W + rng.permutation(W)])
    ridx = np.concatenate([W + rng.permutation(W),
                           2 * W + rng.permutation(W)])
    args = (codes, table, torch.as_tensor(rng.integers(0, M, B), **i32),
            np.asarray(launch, np.int32), torch.as_tensor(lidx, **i32),
            torch.as_tensor(ridx, **i32),
            torch.as_tensor(rng.integers(0, ntips, 2 * W), **i32),
            torch.as_tensor(rng.integers(0, ntips, 2 * W), **i32), pmat, 32)
    return clv, scaler, args


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=F32), e - 8)


def _assert_matches_plain(clv, scaler, args, launches):
    c_ref, s_ref = clv.clone(), scaler.clone()
    newview_chunk.chunk_apply_plain(c_ref, s_ref, *args)
    c_k, s_k = clv.clone(), scaler.clone()
    before = newview_chunk.LAUNCHES_BY_DTYPE.get("bfloat16", 0)
    newview_chunk.chunk_apply(c_k, s_k, *args, fastpath.dataflow(
        args[3], args[4], args[5], clv.device))
    torch.cuda.synchronize()
    assert newview_chunk.LAUNCHES_BY_DTYPE["bfloat16"] == before + (
        newview_chunk.table_launches(clv.shape[-1], BF16, launches))
    assert torch.equal(s_k, s_ref)
    lidx, ridx = args[4].long(), args[5].long()
    rescaled = 0
    for kind, base, slot, real in np.asarray(args[3]).tolist():
        rows, slots = slice(base, base + real), slice(slot, slot + real)
        children = ((s_ref[lidx[slots]] if kind == 2 else 0)
                    + (s_ref[ridx[slots]] if kind >= 1 else 0))
        rescaled += int((s_ref[rows] > children).sum())
    assert rescaled > 0
    smax = c_ref.float().abs().amax(dim=(3, 4), keepdim=True)
    diff = (c_k.float() - c_ref.float()).abs()
    assert bool((diff <= _bf16_ulp(smax)).all())
    written = np.zeros(clv.shape[0], bool)
    for _, base, _, real in np.asarray(args[3]).tolist():
        written[base:base + real] = True
    keep = torch.as_tensor(np.flatnonzero(~written), device=clv.device)
    assert torch.equal(c_k[keep], clv[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("K,C", [(4, 16), (20, 23), (2, 4)])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_cuda_bf16_instances_match_plain(cuda_device, K, C, kind):
    """Each bfloat16-storage instance: a chunk of 1 and of 5 of 16 entries,
    then a chain of launches reading their predecessors' rows."""
    W = 16
    for real in (1, 5):
        clv, scaler, args = _case(cuda_device, K, C,
                                  [(kind, 2 * W, 0, real)], kind + K + real)
        _assert_matches_plain(clv, scaler, args, 1)
    launch = [(kind, 2 * W, 0, W), (2, 3 * W, W, 3), (2, 3 * W + 3, W + 3, 1)]
    clv, scaler, args = _case(cuda_device, K, C, launch, K)
    lidx = args[4].cpu().numpy()
    lidx[W:W + 3] = 2 * W + np.arange(3)
    lidx[W + 3] = 3 * W + 1
    args = args[:4] + (torch.as_tensor(lidx, device=cuda_device),) + args[5:]
    _assert_matches_plain(clv, scaler, args, 3)


@pytest.mark.cuda
def test_cuda_instance_runs_bf16_b1(cuda_device):
    """An instance on the card with a bfloat16 arena evaluates through the
    bfloat16 instance of B1, within rel 1e-5 of the same instance on the
    CPU (the plain version)."""
    names, seqs = _sequences(12, 600, 2)
    lnl = {}
    for dev in ("cpu", cuda_device):
        inst = PhyloInstance(build_alignment_data(names, seqs), dtype=F32,
                             device=dev, clv_dtype=BF16)
        assert _eng(inst).clv.dtype == BF16
        before = newview_chunk.LAUNCHES_BY_DTYPE.get("bfloat16", 0)
        lnl[str(dev)] = inst.evaluate(inst.random_tree(3), full=True)
    assert newview_chunk.LAUNCHES_BY_DTYPE["bfloat16"] > before
    assert lnl["cuda"] == pytest.approx(lnl["cpu"], rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["random", "caterpillar"])
@pytest.mark.parametrize("K", [4, 20, 2])
def test_cuda_bf16_flow_full_traversal_matches_plain(cuda_device, K, shape):
    """A whole 512-taxon traversal with a bfloat16 arena (a random tree
    and a caterpillar), every tip/tip product rescaled, against the plain
    version: scalers equal, within one bfloat16 ulp of each site's max."""
    from test_torch_newview import flow_case_matches_plain
    flow_case_matches_plain(cuda_device, BF16, K, shape, K + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 20, 2])
def test_cuda_bf16_flow_repeats_bitwise_and_epochs(cuda_device, K):
    """20 runs bitwise equal; a second traversal on the same arena and
    flags matches its plain version."""
    from test_torch_newview import flow_repeats_and_epochs
    flow_repeats_and_epochs(cuda_device, BF16, K, K + 5)
