"""Kernel B1's plain version and the port's chunk tier against the JAX
package, the chunk layout's race-freedom promise, and (on a card) the
CUDA kernel against its plain version.

* f64: the port's chunk tier (one batched operand build, then
  `chunk_apply_plain` over the launch table) against
  `examl_tpu.ops.fastpath.run_chunks` (rtol 1e-12, scalers equal);
* f32: the same against the Pallas kernel in interpret mode,
  `pallas_newview.run_chunks(interpret=True)` (rtol 1e-6, atol 1e-7, as
  tests/test_pallas.py holds it); at K = 20 and K = 2 rows within 1e-4
  (AA) and 1e-5 (binary) of each site's max, scalers equal;
* every slot of every chunk of the bounded layout, padding and replay
  slots included, reads only rows outside the rows its chunk writes —
  the property that lets a chunk's entries run concurrently on the card.

The JAX package is imported inside the tests that use it, so that the
card-only cases run on a machine without JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_newview.py`.
"""

import numpy as np
import pytest
import torch

from examl_tpu_torch.ops import fastpath as tfast
from examl_tpu_torch.ops import newview_chunk
from examl_tpu_torch.transfer import state_from_numpy
from examl_tpu_torch.tree.topology import Tree

CPU = torch.device("cpu")


# Alphabet of the synthetic alignments by data type, the gap last.
ALPHABETS = {"DNA": "ACGT-", "AA": "ARNDCQEGHILKMFPSTWYV-", "BIN": "01-"}


def _alignment(ntaxa, nsites, seed, datatype="DNA"):
    from examl_tpu.io.alignment import build_alignment_data
    rng = np.random.default_rng(seed)
    names = [f"t{i}" for i in range(ntaxa)]
    chars = ALPHABETS[datatype]
    n = len(chars) - 1
    seqs = ["".join(chars[c] for c in rng.choice(n + 1, nsites,
                                                 p=[.96 / n] * n + [.04]))
            for _ in names]
    return build_alignment_data(names, seqs, datatype_name=datatype)


def _random_lengths(trees, seed):
    """Give the same random branch lengths to structurally identical
    trees (same construction, so all_branches() orders agree)."""
    rng = np.random.default_rng(seed)
    branch_lists = [t.all_branches() for t in trees]
    for i in range(len(branch_lists[0])):
        z = float(rng.uniform(0.05, 0.98))
        for bl in branch_lists:
            bl[i][0].z[:] = [z]


def _paired(dtype, ntaxa, nsites, seed, datatype="DNA"):
    """A JAX engine, a JAX tree, the port's state from that engine, and the
    port tree built the same way."""
    import jax.numpy as jnp
    from examl_tpu.instance import PhyloInstance as JaxInstance
    jinst = JaxInstance(_alignment(ntaxa, nsites, seed, datatype),
                        dtype=dtype)
    (eng,) = jinst.engines.values()
    jtree = jinst.random_tree(seed)
    ttree = Tree.random(jinst.alignment.taxon_names, seed, 1)
    _random_lengths([jtree, ttree], seed)
    arrays = {k: np.asarray(getattr(eng.models, k))
              for k in eng.models._fields}
    arrays.update(codes=np.asarray(eng.tips.codes),
                  table=np.asarray(eng.tips.table),
                  block_part=np.asarray(eng.block_part),
                  weights=np.asarray(eng.weights))
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    tm, tt, tbp, _ = state_from_numpy(arrays, CPU, tdt)
    return eng, jtree, (tm, tt, tbp, tdt), ttree


def _port_full_traversal(eng, state, ttree):
    tm, tt, tbp, tdt = state
    flat = ttree.flat_full_traversal(ttree.centroid_branch())
    st = tfast.build_structure(flat, eng.ntips, CPU)
    zl, zr = tfast.refresh_z(st, flat, 1, tdt, CPU)
    clv = torch.zeros(tuple(eng.clv.shape), dtype=tdt)
    scaler = torch.zeros(tuple(eng.scaler.shape), dtype=torch.int32)
    pmat = newview_chunk.chunk_operands(tm, zl, zr)
    newview_chunk.chunk_apply(clv, scaler, tt.codes, tt.table,
                              tbp.to(torch.int32), st.launch, st.lidx,
                              st.ridx, st.lcode, st.rcode, pmat,
                              eng.scale_exp)
    return st, clv.numpy(), scaler.numpy()


def _jax_schedule(eng, jtree):
    from examl_tpu.ops import fastpath as jfast
    flat = jtree.flat_full_traversal(jtree.centroid_branch())
    return jfast.build_schedule(flat.to_entries(), eng.ntips, 1, eng.dtype)


def _compare_rows(st, tclv, tsc, sched, jclv, jsc, **tol):
    for num, jrow in sched.row_of.items():
        trow = st.row_of[num]
        np.testing.assert_array_equal(tsc[trow], jsc[jrow])
        np.testing.assert_allclose(tclv[trow], jclv[jrow], **tol)


def test_chunk_program_matches_jax_fastpath_f64():
    import jax.numpy as jnp
    from examl_tpu.ops import fastpath as jfast
    eng, jtree, state, ttree = _paired(jnp.float64, 24, 600, 0)
    sched = _jax_schedule(eng, jtree)
    jclv, jsc = jfast.run_chunks(eng.models, eng.block_part, eng.tips,
                                 eng.clv, eng.scaler, sched.chunks,
                                 eng.scale_exp, eng.fast_precision)
    st, tclv, tsc = _port_full_traversal(eng, state, ttree)
    assert st.profile == sched.profile
    _compare_rows(st, tclv, tsc, sched, np.asarray(jclv), np.asarray(jsc),
                  rtol=1e-12, atol=0)


def test_chunk_program_forced_rescale_matches_jax_f64():
    """Short branches everywhere over 24 taxa: f64 rows stay above 2^-256,
    so the tip table is scaled down to force rescale events."""
    import jax.numpy as jnp
    from examl_tpu.ops import fastpath as jfast
    eng, jtree, (tm, tt, tbp, tdt), ttree = _paired(jnp.float64, 24, 300, 1)
    scale = 2.0 ** -60
    eng.tips = eng.tips._replace(table=eng.tips.table * scale)
    tt = tt._replace(table=tt.table * scale)
    sched = _jax_schedule(eng, jtree)
    jclv, jsc = jfast.run_chunks(eng.models, eng.block_part, eng.tips,
                                 eng.clv, eng.scaler, sched.chunks,
                                 eng.scale_exp, eng.fast_precision)
    st, tclv, tsc = _port_full_traversal(eng, (tm, tt, tbp, tdt), ttree)
    assert tsc.sum() > 0
    _compare_rows(st, tclv, tsc, sched, np.asarray(jclv), np.asarray(jsc),
                  rtol=1e-12, atol=0)


def test_chunk_program_matches_pallas_interpret_f32():
    import jax.numpy as jnp
    from examl_tpu.ops import pallas_newview
    eng, jtree, state, ttree = _paired(jnp.float32, 20, 400, 2)
    sched = _jax_schedule(eng, jtree)
    jclv, jsc = pallas_newview.run_chunks(
        eng.models, eng.block_part, eng.tips, jnp.array(eng.clv),
        jnp.array(eng.scaler), sched.chunks, eng.scale_exp, interpret=True)
    st, tclv, tsc = _port_full_traversal(eng, state, ttree)
    _compare_rows(st, tclv, tsc, sched, np.asarray(jclv), np.asarray(jsc),
                  rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("datatype,rtol", [("AA", 1e-4), ("BIN", 1e-5)])
def test_chunk_program_matches_pallas_interpret_f32_aa_and_binary(datatype,
                                                                  rtol):
    """The K = 20 and K = 2 domains of the Pallas kernel: rows within rtol
    of each site's max (AA 1e-4 as tests/test_torch_whole.py holds the
    whole tier; binary 1e-5 as DNA), scalers equal."""
    import jax.numpy as jnp
    from examl_tpu.ops import pallas_newview
    eng, jtree, state, ttree = _paired(jnp.float32, 24, 300, 1, datatype)
    assert eng.clv.shape[-1] == {"AA": 20, "BIN": 2}[datatype]
    sched = _jax_schedule(eng, jtree)
    jclv, jsc = pallas_newview.run_chunks(
        eng.models, eng.block_part, eng.tips, jnp.array(eng.clv),
        jnp.array(eng.scaler), sched.chunks, eng.scale_exp, interpret=True)
    st, tclv, tsc = _port_full_traversal(eng, state, ttree)
    jclv, jsc = np.asarray(jclv), np.asarray(jsc)
    for num, jrow in sched.row_of.items():
        trow = st.row_of[num]
        np.testing.assert_array_equal(tsc[trow], jsc[jrow])
        smax = np.abs(jclv[jrow]).max(axis=(2, 3), keepdims=True)
        assert np.all(np.abs(tclv[trow] - jclv[jrow]) <= rtol * smax)


@pytest.mark.parametrize("ntaxa,seed", [(12, 0), (37, 1), (100, 2),
                                        (512, 3), (512, 4)])
def test_layout_chunks_never_read_their_own_rows(ntaxa, seed):
    tree = Tree.random([f"t{i}" for i in range(ntaxa)], seed, 1)
    flat = tree.flat_full_traversal(tree.centroid_branch())
    (layout, row_of, base, lidx, ridx, lcode, rcode, _zs,
     _zw) = tfast.structure_arrays(flat, ntaxa)
    off = 0
    n_rows = ntaxa - 2 + tfast.slack_rows(ntaxa)
    for cidx, (kind, W) in enumerate(tfast.iter_profile_chunks(
            layout.profile)):
        b = int(base[cidx])
        assert 0 <= b and b + W <= n_rows
        reads = []
        if kind == 2:
            reads.append(lidx[off:off + W])
        if kind >= 1:
            reads.append(ridx[off:off + W])
        for r in reads:
            assert not np.any((r >= b) & (r < b + W)), (kind, W, b)
            assert np.all((r >= 0) & (r < n_rows))
        for c in (lcode[off:off + W], rcode[off:off + W]):
            assert np.all((c >= 0) & (c < ntaxa))
        off += W
    assert off == lidx.shape[0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda unavailable)")
    return torch.device("cuda")


def _kernel_case(dev, dtype, W, launch, seed, K=4, C=16):
    """Random inputs for a launch table over packed slots [0, 2W): the
    first W slots read rows [0, 2W) and write from row 2W; the next W
    read the rows the first W wrote.  K states, C tip codes."""
    rng = np.random.default_rng(seed)
    E = 256 if dtype == torch.float64 else 32
    B, L, M, ntips = 8, 128, 2, 6
    rows = 4 * W + 1
    pmat = torch.as_tensor(rng.uniform(0, 1, (2 * W, 2, M, 4, K, K)) * 4 / K,
                           dtype=dtype, device=dev)
    table = torch.as_tensor(rng.uniform(0, 1, (C, K)), dtype=dtype,
                            device=dev)
    clv = torch.as_tensor(rng.uniform(0, 1, (rows, B, L, 4, K)), dtype=dtype,
                          device=dev) * 2.0 ** (-E / 2)
    scaler = torch.as_tensor(rng.integers(0, 3, (rows, B, L)),
                             dtype=torch.int32, device=dev)
    codes = torch.as_tensor(rng.integers(0, C, (ntips, B, L)),
                            dtype=torch.uint8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    lidx = np.concatenate([rng.permutation(W), 2 * W + rng.permutation(W)])
    ridx = np.concatenate([W + rng.permutation(W), 2 * W + rng.permutation(W)])
    args = (codes, table, torch.as_tensor(rng.integers(0, M, B), **i32),
            np.asarray(launch, np.int32), torch.as_tensor(lidx, **i32),
            torch.as_tensor(ridx, **i32),
            torch.as_tensor(rng.integers(0, ntips, 2 * W), **i32),
            torch.as_tensor(rng.integers(0, ntips, 2 * W), **i32), pmat, E)
    return clv, scaler, args


def _assert_kernel_matches_plain(clv, scaler, args, dtype, launches):
    c_ref, s_ref = clv.clone(), scaler.clone()
    newview_chunk.chunk_apply_plain(c_ref, s_ref, *args)
    c_k, s_k = clv.clone(), scaler.clone()
    before = newview_chunk.LAUNCHES
    newview_chunk.chunk_apply(c_k, s_k, *args, tfast.dataflow(
        args[3], args[4], args[5], clv.device))
    torch.cuda.synchronize()
    assert newview_chunk.LAUNCHES == before + newview_chunk.table_launches(
        clv.shape[-1], clv.dtype, launches)
    assert torch.equal(s_k, s_ref)
    smax = c_ref.abs().amax(dim=(3, 4), keepdim=True)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert bool(((c_k - c_ref).abs() <= rtol * smax).all())
    written = np.zeros(clv.shape[0], bool)
    for _, base, _, real in np.asarray(args[3]).tolist():
        written[base:base + real] = True
    keep = torch.as_tensor(np.flatnonzero(~written), device=clv.device)
    assert torch.equal(c_k[keep], clv[keep])
    assert torch.equal(s_k[keep], scaler[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("real", [1, 5, 16])
def test_cuda_kernel_matches_plain(cuda_device, kind, dtype, real):
    """One chunk of `real` entries in a layout of width 16: rows past the
    real ones stay bit for bit untouched."""
    W = 16
    clv, scaler, args = _kernel_case(cuda_device, dtype, W,
                                     [(kind, 2 * W, 0, real)], kind + real)
    _assert_kernel_matches_plain(clv, scaler, args, dtype, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_chained_launches_match_plain(cuda_device, dtype):
    """Each launch reads the rows the launch before it wrote."""
    W = 16
    launch = [(1, 2 * W, 0, W), (2, 3 * W, W, 3), (2, 3 * W + 3, W + 3, 1)]
    clv, scaler, args = _kernel_case(cuda_device, dtype, W, launch, 7)
    lidx = args[4].cpu().numpy()
    ridx = args[5].cpu().numpy()
    # Slots W..W+3 read rows 2W.. (written by the first launch); slot W+3
    # reads a row of the second launch.
    lidx[W:W + 3] = 2 * W + np.arange(3)
    lidx[W + 3] = 3 * W + 1
    ridx[W + 3] = 3 * W
    dev = cuda_device
    args = args[:4] + (torch.as_tensor(lidx, device=dev),
                       torch.as_tensor(ridx, device=dev)) + args[6:]
    _assert_kernel_matches_plain(clv, scaler, args, dtype, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("K,C", [(20, 23), (2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_cuda_kernel_matches_plain_aa_and_binary(cuda_device, K, C, dtype,
                                                  kind):
    """The K = 20 and K = 2 instances, every tip code drawn (ambiguity
    codes included): a chunk of 1 and of 5 of 16 entries, then a chain of
    launches reading their predecessors' rows; the children's values sit
    around 2^-E/2, so some sites rescale and some do not."""
    W = 16
    for real in (1, 5):
        clv, scaler, args = _kernel_case(cuda_device, dtype, W,
                                         [(kind, 2 * W, 0, real)],
                                         kind + K + real, K, C)
        _assert_kernel_matches_plain(clv, scaler, args, dtype, 1)
    launch = [(kind, 2 * W, 0, W), (2, 3 * W, W, 3), (2, 3 * W + 3, W + 3, 1)]
    clv, scaler, args = _kernel_case(cuda_device, dtype, W, launch, K, K, C)
    lidx = args[4].cpu().numpy()
    lidx[W:W + 3] = 2 * W + np.arange(3)
    lidx[W + 3] = 3 * W + 1
    args = args[:4] + (torch.as_tensor(lidx, device=cuda_device),) + args[5:]
    _assert_kernel_matches_plain(clv, scaler, args, dtype, 3)


def _caterpillar_newick(n: int) -> str:
    s = "(t0,t1)"
    for i in range(2, n - 1):
        s = f"({s},t{i})"
    return f"({s},t{n - 1});"


def layout_case(dev, storage, K, shape, seed, ntaxa=512, B=2):
    """A full traversal's launch table on the card: a random tree or a
    caterpillar (one entry a wave) of `ntaxa` taxa, rooted at its
    centroid, its fastpath structure (the engine's Dataflow operands
    included), random GTR+G models of K states in two partitions (float32
    compute for a bfloat16 arena), and a tip table scaled by 2^-(E/2 + 1)
    so every tip/tip product rescales.  Returns (clv, scaler, args, flow,
    rows written)."""
    from examl_tpu_torch import datatypes
    from examl_tpu_torch.models.gtr import build_model, n_exchange
    from examl_tpu_torch.ops.engine import stack_models
    compute = torch.float32 if storage == torch.bfloat16 else storage
    E = 256 if compute == torch.float64 else 32
    dt = {4: datatypes.DNA, 20: datatypes.AA, 2: datatypes.BINARY}[K]
    names = [f"t{i}" for i in range(ntaxa)]
    tree = (Tree.from_newick(_caterpillar_newick(ntaxa), names, 1)
            if shape == "caterpillar" else Tree.random(names, seed, 1))
    rng = np.random.default_rng(seed)
    for p, _ in tree.all_branches():
        p.z[:] = [float(rng.uniform(0.05, 0.98))]
    flat = tree.flat_full_traversal(tree.centroid_branch())
    st = tfast.build_structure(flat, ntaxa, dev)
    models = []
    for _ in range(2):
        rates = rng.uniform(0.3, 6.0, n_exchange(K))
        rates[-1] = 1.0
        models.append(build_model(dt, rng.dirichlet(np.ones(K) * 5),
                                  rates=rates, alpha=rng.uniform(0.2, 1.5),
                                  ncat=4))
    dm = stack_models(models, [0, 0], compute, dev)
    zl, zr = tfast.refresh_z(st, flat, 1, compute, dev)
    pmat = newview_chunk.chunk_operands(dm, zl, zr)
    table = torch.as_tensor(dt.tip_indicator_table(), dtype=compute,
                            device=dev) * 2.0 ** -(E // 2 + 1)
    L = 128
    rows = ntaxa - 2 + tfast.slack_rows(ntaxa) + 1
    clv = torch.zeros((rows, B, L, 4, K), dtype=storage, device=dev)
    scaler = torch.zeros((rows, B, L), dtype=torch.int32, device=dev)
    codes = torch.as_tensor(rng.integers(0, dt.num_codes, (ntaxa, B, L)),
                            dtype=torch.uint8, device=dev)
    bp = torch.as_tensor([0, 1][:B] + [1] * (B - 2), dtype=torch.int32,
                         device=dev)
    args = (codes, table, bp, st.launch, st.lidx, st.ridx, st.lcode,
            st.rcode, pmat, E)
    flow = newview_chunk.Dataflow(st.flow_rows, st.wait,
                                  newview_chunk.Ready())
    written = torch.as_tensor(np.sort(st.row_of[st.row_of >= 0]),
                              device=dev)
    return clv, scaler, args, flow, written


def assert_rows_match(c_k, s_k, c_ref, s_ref, rows) -> int:
    """Scalers equal, every written row within the storage type's bound of
    its site's maximum (rel 1e-5 f32, 1e-12 f64, one bfloat16 ulp), at
    least one site rescaled; returns the differing cells."""
    assert torch.equal(s_k[rows], s_ref[rows])
    assert int(s_ref[rows].sum()) > 0
    ck, cp = c_k[rows].double(), c_ref[rows].double()
    smax = cp.abs().amax(dim=(3, 4), keepdim=True)
    diff = (ck - cp).abs()
    if c_k.dtype == torch.bfloat16:
        _, e = torch.frexp(smax)
        bound = torch.ldexp(torch.ones_like(smax), e - 8)
    else:
        bound = (1e-12 if c_k.dtype == torch.float64 else 1e-5) * smax
    assert bool((diff <= bound).all())
    return int((diff > 0).sum())


def flow_case_matches_plain(dev, storage, K, shape, seed):
    clv, scaler, args, flow, rows = layout_case(dev, storage, K, shape, seed)
    c_ref, s_ref = clv.clone(), scaler.clone()
    newview_chunk.chunk_apply_plain(c_ref, s_ref, *args)
    before = newview_chunk.LAUNCHES
    newview_chunk.chunk_apply(clv, scaler, *args, flow)
    torch.cuda.synchronize()
    assert newview_chunk.LAUNCHES == before + newview_chunk.table_launches(
        K, storage, len(args[3]))
    assert_rows_match(clv, scaler, c_ref, s_ref, rows)


def flow_repeats_and_epochs(dev, storage, K, seed):
    """20 runs of one table from the same inputs are bitwise equal (a race
    would show as an occasional difference); then a second traversal with
    other P on the same arena and the same Ready flags: the first
    traversal's flags must not satisfy its waits, so it matches its plain
    version (on the per-chunk route no flag is used)."""
    clv0, sc0, args, flow, rows = layout_case(dev, storage, K, "random",
                                              seed)
    first = None
    for _ in range(20):
        clv, scaler = clv0.clone(), sc0.clone()
        newview_chunk.chunk_apply(clv, scaler, *args, flow)
        if first is None:
            first = (clv, scaler)
        else:
            assert torch.equal(clv, first[0])
            assert torch.equal(scaler, first[1])
    clv, scaler = first
    c_ref, s_ref = clv.clone(), scaler.clone()
    args2 = args[:8] + ((args[8] * 0.9).contiguous(), args[9])
    newview_chunk.chunk_apply_plain(c_ref, s_ref, *args2)
    newview_chunk.chunk_apply(clv, scaler, *args2, flow)
    torch.cuda.synchronize()
    flows = newview_chunk.ROUTE[(K, storage)] == "flow"
    assert flow.ready.epoch == (21 if flows else 0)
    assert_rows_match(clv, scaler, c_ref, s_ref, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["random", "caterpillar"])
@pytest.mark.parametrize("K", [4, 20, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_flow_full_traversal_matches_plain(cuda_device, dtype, K,
                                                shape):
    """A whole 512-taxon traversal (a random tree, and a caterpillar: one
    entry a wave) through the instance's route, every tip/tip product
    rescaled, against the plain version."""
    flow_case_matches_plain(cuda_device, dtype, K, shape, K + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 20, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_flow_repeats_bitwise_and_epochs(cuda_device, dtype, K):
    flow_repeats_and_epochs(cuda_device, dtype, K, K + 5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The CUDA entry point never falls back: CPU tensors are refused
    before any build or launch."""
    z = torch.zeros((4, 1, 128, 4, 4))
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        newview_chunk.chunk_apply_cuda(
            z, torch.zeros((4, 1, 128), dtype=torch.int32),
            torch.zeros((3, 1, 128), dtype=torch.uint8), torch.zeros((16, 4)),
            torch.zeros(1, dtype=torch.int32),
            np.asarray([(2, 2, 0, 2)], np.int32), i32, i32, i32, i32,
            torch.zeros((2, 2, 1, 4, 4, 4)), 32)


def test_build_is_keyed_on_source_hash():
    from examl_tpu_torch.ops import _build
    assert _build.sources() == ["newview_chunk", "newview_whole"]
    path = _build._lib_path("newview_chunk")
    assert path == _build._lib_path("newview_chunk")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libnewview_chunk-")
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.FLAGS


def test_ctypes_signatures_match_the_c_sources():
    """Every exported function's ctypes argument list matches its C
    declaration, parameter by parameter (a pointer, int, double or int*),
    so a changed C interface cannot be called with a stale one."""
    import ctypes
    import re

    from examl_tpu_torch.ops import _build
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "double": ctypes.c_double, "int*": ctypes.POINTER(ctypes.c_int)}
    for name, fns in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        for fn, (argtypes, _) in fns.items():
            decl = re.search(rf"\b{fn}\(([^)]*)\)\s*{{", text)
            assert decl, fn
            params = [re.sub(r"\bconst\b|\s+\w+$|\s", "",
                             p.strip()).replace("char*", "void*")
                      for p in decl.group(1).split(",")]
            assert [kinds[p] for p in params] == list(argtypes), fn
