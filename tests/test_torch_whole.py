"""Kernel B2's schedule and plain version, and the engine's whole tier,
against the JAX package; on a card, the CUDA kernel against its plain
version.

* `build_flat` equals `examl_tpu.ops.pallas_whole.build_flat` exactly
  (meta, codes, zl/zr, row_of) on random topologies and a caterpillar,
  and the cached structure's `refresh_z` equals a fresh build;
* f32: `whole_apply_plain` against `pallas_whole.run_flat(interpret=True)`
  on DNA, AA and binary data (scalers equal; rows at rtol 1e-5 of each
  site's max for DNA and binary, 1e-4 for AA: with K = 20 the JAX f32 rows
  themselves lie 1.7e-5 from the port's f64 rows after 9 waves, and 1e-4
  is the bound tests/test_pallas.py holds the JAX B2 to against its chunk
  tier);
* f64: the same against the JAX scan tier (`kernels.traverse`, rows by
  the engine's row map) at rtol 1e-12, with a forced-rescale case;
* the engine with `newview="whole"`: lnL against the JAX engine (f64 rtol
  1e-10; f32 against EXAML_PALLAS=whole in interpret mode, rtol 1e-6),
  then makenewz through B2's row map (z rtol 1e-8).

The JAX package is imported inside the tests that use it, so that the
card-only case runs on a machine without JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_whole.py`.
"""

import numpy as np
import pytest
import torch

from examl_tpu_torch.ops import newview_whole
from examl_tpu_torch.transfer import state_from_numpy
from examl_tpu_torch.tree.topology import Tree

CPU = torch.device("cpu")


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


def _caterpillar(n):
    text = "t0"
    for i in range(1, n):
        text = f"({text},t{i})"
    return text + ";"


def _trees(ntaxa, seed, shape):
    """The same topology in both packages, with the same random lengths."""
    from examl_tpu.tree.topology import Tree as JTree
    names = [f"t{i}" for i in range(ntaxa)]
    if shape == "caterpillar":
        jt = JTree.from_newick(_caterpillar(ntaxa), names, 1)
        tt = Tree.from_newick(_caterpillar(ntaxa), names, 1)
    else:
        jt = JTree.random(names, seed, 1)
        tt = Tree.random(names, seed, 1)
    _lengths(jt, tt, seed)
    return jt, tt


def _lengths(jt, tt, seed):
    rng = np.random.default_rng(seed)
    for (jp, _), (tp, _) in zip(jt.all_branches(), tt.all_branches()):
        z = float(rng.uniform(0.05, 0.98))
        jp.z[:] = [z]
        tp.z[:] = [z]


@pytest.mark.parametrize("ntaxa,seed,shape", [
    (8, 0, "random"), (37, 1, "random"), (128, 2, "random"),
    (512, 3, "random"), (64, 0, "caterpillar")])
def test_build_flat_matches_jax(ntaxa, seed, shape):
    from examl_tpu.ops import pallas_whole
    jt, tt = _trees(ntaxa, seed, shape)
    # The caterpillar is rooted at its first tip: one entry per wave.
    jroot, troot = ((jt.start, tt.start) if shape == "caterpillar"
                    else (jt.centroid_branch(), tt.centroid_branch()))
    jflat = jt.flat_full_traversal(jroot)
    tflat = tt.flat_full_traversal(troot)
    js = pallas_whole.build_flat(jflat.to_entries(), ntaxa, 1)
    ts = newview_whole.build_flat(tflat.to_entries(), ntaxa, 1)
    assert ts.e_real == js.e_real == ntaxa - 2
    for name in ("meta", "l_code", "r_code", "zl", "zr"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert ts.row_of == js.row_of
    st = newview_whole.build_structure(tflat, ntaxa, 1, CPU)
    np.testing.assert_array_equal(st.wave_start.numpy(),
                                  newview_whole.wave_bounds(js.meta))
    if shape == "caterpillar":
        assert st.wave_start.shape[0] - 1 == ntaxa - 2
    # New lengths on the same topology: the cached structure's refresh
    # equals a fresh schedule.
    _lengths(jt, tt, seed + 7)
    tflat2 = tt.flat_full_traversal(troot)
    assert tflat2.topo_key == tflat.topo_key
    fresh = newview_whole.build_flat(tflat2.to_entries(), ntaxa, 1)
    zl, zr = newview_whole.refresh_z(st, tflat2, 1)
    np.testing.assert_array_equal(zl, fresh.zl)
    np.testing.assert_array_equal(zr, fresh.zr)


def _jax_instance(datatype, ntaxa, nsites, seed, dtype):
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.io.alignment import build_alignment_data
    rng = np.random.default_rng(seed)
    alphabet = {"AA": "ARNDCQEGHILKMFPSTWYV", "DNA": "ACGT",
                "BIN": "01"}[datatype]
    names = [f"t{i}" for i in range(ntaxa)]
    seqs = ["".join(alphabet[c]
                    for c in rng.integers(0, len(alphabet), nsites))
            for _ in names]
    return JaxInstance(build_alignment_data(names, seqs,
                                            datatype_name=datatype),
                       dtype=dtype)


def _port_state(eng, tdt):
    arrays = {k: np.asarray(getattr(eng.models, k))
              for k in eng.models._fields}
    arrays.update(codes=np.asarray(eng.tips.codes),
                  table=np.asarray(eng.tips.table),
                  block_part=np.asarray(eng.block_part),
                  weights=np.asarray(eng.weights))
    return state_from_numpy(arrays, CPU, tdt)


def _port_whole(eng, tdt, tflat):
    """One whole traversal through the plain version, on an arena shaped
    like the JAX engine's."""
    tm, tt, tbp, _ = _port_state(eng, tdt)
    st = newview_whole.build_structure(tflat, eng.ntips, 1, CPU)
    zl, zr = newview_whole.refresh_z(st, tflat, 1)
    pmat = newview_whole.whole_operands(tm, zl, zr, tdt, CPU)
    clv = torch.zeros(tuple(eng.clv.shape), dtype=tdt)
    scaler = torch.zeros(tuple(eng.scaler.shape), dtype=torch.int32)
    newview_whole.whole_apply(clv, scaler, tt.codes, tt.table,
                              tbp.to(torch.int32), st.meta, st.l_code,
                              st.r_code, st.wave_start, pmat, eng.scale_exp)
    return st, clv.numpy(), scaler.numpy()


def _compare_rows(pairs, tclv, tsc, jclv, jsc, rtol):
    for trow, jrow in pairs:
        np.testing.assert_array_equal(tsc[trow], jsc[jrow])
        smax = np.abs(jclv[jrow]).max(axis=(2, 3), keepdims=True)
        assert np.all(np.abs(tclv[trow] - jclv[jrow]) <= rtol * smax)


@pytest.mark.parametrize("datatype,ntaxa,nsites,seed,rtol", [
    ("DNA", 20, 500, 5, 1e-5), ("AA", 24, 300, 1, 1e-4),
    ("BIN", 24, 300, 2, 1e-5)])
def test_plain_matches_pallas_whole_interpret_f32(datatype, ntaxa, nsites,
                                                  seed, rtol):
    import jax.numpy as jnp
    from examl_tpu.ops import pallas_whole
    jinst = _jax_instance(datatype, ntaxa, nsites, seed, jnp.float32)
    eng = jinst.engines[max(jinst.engines)]
    jt, tt = _trees(ntaxa, seed, "random")
    jflat = jt.flat_full_traversal(jt.centroid_branch())
    sched = pallas_whole.build_flat(jflat.to_entries(), ntaxa, 1)
    jclv, jsc = pallas_whole.run_flat(
        eng.models, eng.block_part, eng.tips, jnp.array(eng.clv),
        jnp.array(eng.scaler), sched, eng.scale_exp, interpret=True)
    st, tclv, tsc = _port_whole(eng, torch.float32,
                                tt.flat_full_traversal(tt.centroid_branch()))
    pairs = [(st.row_of[num], row) for num, row in sched.row_of.items()]
    _compare_rows(pairs, tclv, tsc, np.asarray(jclv), np.asarray(jsc), rtol)


@pytest.mark.parametrize("ntaxa,z,table_scale", [
    (30, None, 1.0), (40, 0.05, 2.0 ** -60)])
def test_plain_matches_jax_scan_tier_f64(ntaxa, z, table_scale):
    """f64 rows against the JAX scan tier.  The second case is the forced
    rescale: z = 0.05 everywhere and a tip table scaled by 2^-60 (f64 rows
    stay far above 2^-256 otherwise)."""
    import jax.numpy as jnp
    jinst = _jax_instance("DNA", ntaxa, 256, 3, jnp.float64)
    eng = jinst.engines[4]
    jt, tt = _trees(ntaxa, 3, "random")
    if z is not None:
        for (jp, _), (tp, _) in zip(jt.all_branches(), tt.all_branches()):
            jp.z[:] = [z]
            tp.z[:] = [z]
    eng.tips = eng.tips._replace(table=eng.tips.table * table_scale)
    jflat = jt.flat_full_traversal(jt.centroid_branch())
    eng.run_traversal(jflat.to_entries())            # the scan tier
    st, tclv, tsc = _port_whole(eng, torch.float64,
                                tt.flat_full_traversal(tt.centroid_branch()))
    if table_scale != 1.0:
        assert tsc.sum() > 0
    pairs = [(st.row_of[num], eng.row_map[num])
             for num in jflat.parent.tolist()]
    _compare_rows(pairs, tclv, tsc, np.asarray(eng.clv),
                  np.asarray(eng.scaler), 1e-12)


def _instances(jdtype, tdtype, seed=5):
    from examl_tpu.instance import PhyloInstance as JaxInstance
    from examl_tpu.io.alignment import build_alignment_data as jbuild
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import build_alignment_data
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(20)]
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 500))
            for _ in names]
    jinst = JaxInstance(jbuild(names, seqs), dtype=jdtype)
    tinst = PhyloInstance(build_alignment_data(names, seqs), dtype=tdtype,
                          device="cpu", newview="whole")
    jt, tt = jinst.random_tree(seed), tinst.random_tree(seed)
    _lengths(jt, tt, seed)
    return jinst, jt, tinst, tt


def test_engine_whole_tier_f64_and_makenewz():
    import jax.numpy as jnp
    jinst, jt, tinst, tt = _instances(jnp.float64, torch.float64)
    before = newview_whole.LAUNCHES
    jl = jinst.evaluate(jt, full=True)
    tl = tinst.evaluate(tt, full=True)
    assert tl == pytest.approx(jl, rel=1e-10)
    assert newview_whole.LAUNCHES == before     # CPU: the plain version
    eng = tinst.engines[4]
    assert sorted(eng.row_map[21:].tolist()) == list(range(18))
    # makenewz after the whole traversal reads through B2's row map.
    for num in (30, 7, 25):
        jp, tp = jt.nodep[num], tt.nodep[num]
        jz = jinst.makenewz(jt, jp, jp.back, list(jp.z), maxiter=30)
        tz = tinst.makenewz(tt, tp, tp.back, list(tp.z), maxiter=30)
        np.testing.assert_allclose(tz, jz, rtol=1e-8)
        jp.z[:] = list(jz)
        tp.z[:] = list(tz)
    assert tinst.evaluate(tt) == pytest.approx(jinst.evaluate(jt), rel=1e-10)
    assert tinst.evaluate(tt, full=True) == pytest.approx(
        jinst.evaluate(jt, full=True), rel=1e-10)


def test_engine_whole_tier_f32_matches_pallas_whole(monkeypatch):
    import jax.numpy as jnp
    monkeypatch.setenv("EXAML_PALLAS", "whole")
    monkeypatch.setenv("EXAML_PALLAS_INTERPRET", "1")
    jinst, jt, tinst, tt = _instances(jnp.float32, torch.float32)
    assert jinst.engines[4].pallas_whole
    jl = jinst.evaluate(jt, full=True)
    tl = tinst.evaluate(tt, full=True)
    assert tl == pytest.approx(jl, rel=1e-6)


def test_unknown_tier_is_refused():
    from examl_tpu_torch.instance import PhyloInstance
    from examl_tpu_torch.io.alignment import build_alignment_data
    ad = build_alignment_data(["a", "b", "c", "d"], ["ACGT"] * 4)
    with pytest.raises(ValueError, match="newview"):
        PhyloInstance(ad, device="cpu", newview="wave")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ntaxa,shape", [(64, "random"),
                                         (24, "caterpillar")])
def test_cuda_kernel_matches_plain(cuda_device, dtype, ntaxa, shape):
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.models.gtr import build_model
    from examl_tpu_torch.ops.engine import stack_models
    dev = cuda_device
    rng = np.random.default_rng(ntaxa)
    E = 256 if dtype == torch.float64 else 32
    B, L, M = 8, 128, 2
    names = [f"t{i}" for i in range(ntaxa)]
    tree = (Tree.from_newick(_caterpillar(ntaxa), names, 1)
            if shape == "caterpillar" else Tree.random(names, 1, 1))
    for p, _ in tree.all_branches():
        p.z[:] = [float(rng.uniform(0.05, 0.98))]
    flat = tree.flat_full_traversal(tree.centroid_branch())
    models = [build_model(datatypes.DNA, rng.dirichlet(np.ones(4) * 5),
                          alpha=float(rng.uniform(0.2, 1.5)))
              for _ in range(M)]
    dm = stack_models(models, [0] * M, dtype, dev)
    st = newview_whole.build_structure(flat, ntaxa, 1, dev)
    zl, zr = newview_whole.refresh_z(st, flat, 1)
    pmat = newview_whole.whole_operands(dm, zl, zr, dtype, dev)
    table = torch.as_tensor(datatypes.DNA.tip_indicator_table(),
                            dtype=dtype, device=dev) * 0.75 * 2.0 ** (-E / 2)
    rows = ntaxa + 2
    clv = torch.as_tensor(rng.uniform(0, 1, (rows, B, L, 4, 4)),
                          dtype=dtype, device=dev)
    scaler = torch.as_tensor(rng.integers(0, 3, (rows, B, L)),
                             dtype=torch.int32, device=dev)
    codes = torch.as_tensor(rng.choice([1, 2, 4, 8, 15, 5], (ntaxa, B, L)),
                            dtype=torch.uint8, device=dev)
    args = (codes, table, torch.as_tensor(rng.integers(0, M, B),
                                          dtype=torch.int32, device=dev),
            st.meta, st.l_code, st.r_code, st.wave_start, pmat, E)
    c_ref, s_ref = clv.clone(), scaler.clone()
    newview_whole.whole_apply_plain(c_ref, s_ref, *args)
    before = newview_whole.LAUNCHES
    newview_whole.whole_apply(clv, scaler, *args)
    torch.cuda.synchronize()
    assert newview_whole.LAUNCHES == before + 1
    assert torch.equal(scaler, s_ref)
    n = flat.n
    assert int(s_ref[:n].sum()) > 0                  # rescaling happened
    assert torch.equal(clv[n:], c_ref[n:])
    smax = c_ref[:n].abs().amax(dim=(3, 4), keepdim=True)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert bool(((clv[:n] - c_ref[:n]).abs() <= rtol * smax).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K,codes", [(20, list(range(23))), (2, [1, 2, 3])])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain_aa_and_binary(cuda_device, K, codes,
                                                  dtype):
    """The K = 20 and K = 2 instances on a random 64-taxon tree, a 24-taxon
    caterpillar rooted at its centroid and one rooted at its first tip
    (every wave a single entry), every tip code drawn (ambiguity codes
    included), every tip/tip site forced to rescale."""
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.models.gtr import build_model, n_exchange
    from examl_tpu_torch.ops.engine import stack_models
    dev = cuda_device
    dt = {20: datatypes.AA, 2: datatypes.BINARY}[K]
    E = 256 if dtype == torch.float64 else 32
    B, L, M = 4, 128, 2
    for ntaxa, shape in ((64, "random"), (24, "caterpillar"),
                         (24, "caterpillar from a tip")):
        rng = np.random.default_rng(ntaxa + K)
        names = [f"t{i}" for i in range(ntaxa)]
        tree = (Tree.random(names, 1, 1) if shape == "random"
                else Tree.from_newick(_caterpillar(ntaxa), names, 1))
        for p, _ in tree.all_branches():
            p.z[:] = [float(rng.uniform(0.05, 0.98))]
        flat = tree.flat_full_traversal(tree.start if shape.endswith("tip")
                                        else tree.centroid_branch())
        models = [build_model(dt, rng.dirichlet(np.ones(K) * 5),
                              rates=rng.uniform(0.3, 6.0, n_exchange(K)),
                              alpha=float(rng.uniform(0.2, 1.5)))
                  for _ in range(M)]
        dm = stack_models(models, [0] * M, dtype, dev)
        st = newview_whole.build_structure(flat, ntaxa, 1, dev)
        zl, zr = newview_whole.refresh_z(st, flat, 1)
        pmat = newview_whole.whole_operands(dm, zl, zr, dtype, dev)
        table = torch.as_tensor(dt.tip_indicator_table(), dtype=dtype,
                                device=dev) * 0.75 * 2.0 ** (-E / 2)
        rows = ntaxa + 2
        clv = torch.as_tensor(rng.uniform(0, 1, (rows, B, L, 4, K)),
                              dtype=dtype, device=dev)
        scaler = torch.as_tensor(rng.integers(0, 3, (rows, B, L)),
                                 dtype=torch.int32, device=dev)
        tips = torch.as_tensor(rng.choice(codes, (ntaxa, B, L)),
                               dtype=torch.uint8, device=dev)
        args = (tips, table, torch.as_tensor(rng.integers(0, M, B),
                                             dtype=torch.int32, device=dev),
                st.meta, st.l_code, st.r_code, st.wave_start, pmat, E)
        c_ref, s_ref = clv.clone(), scaler.clone()
        newview_whole.whole_apply_plain(c_ref, s_ref, *args)
        before = newview_whole.LAUNCHES
        newview_whole.whole_apply(clv, scaler, *args)
        torch.cuda.synchronize()
        assert newview_whole.LAUNCHES == before + 1
        assert torch.equal(scaler, s_ref)
        n = flat.n
        assert int(s_ref[:n].sum()) > 0
        assert torch.equal(clv[n:], c_ref[n:])
        smax = c_ref[:n].abs().amax(dim=(3, 4), keepdim=True)
        rtol = 1e-12 if dtype == torch.float64 else 1e-5
        assert bool(((clv[:n] - c_ref[:n]).abs() <= rtol * smax).all())


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA entry point never falls back: CPU tensors are refused
    before any build or launch."""
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        newview_whole.whole_apply_cuda(
            torch.zeros((4, 1, 128, 4, 4)),
            torch.zeros((4, 1, 128), dtype=torch.int32),
            torch.zeros((3, 1, 128), dtype=torch.uint8),
            torch.zeros((16, 4)), torch.zeros(1, dtype=torch.int32),
            torch.zeros((2, 8), dtype=torch.int32), i32, i32, i32,
            torch.zeros((2, 2, 1, 4, 4, 4)), 32)
