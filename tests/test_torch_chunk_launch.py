"""The chunk tier's launch table: what kernel B1 is asked to execute.

* the compact run (only the real slots of the chunks with real entries,
  `fastpath.launch_table`) leaves every `row_of` row and its scaler bit
  for bit equal to the padded run (every slot of every chunk of the
  bounded layout, pads and replay steps included, in the JAX program's
  order), in f64 with forced rescale;
* launch-table properties: real widths sum to the entry count, the
  skipped chunks are exactly the pads and the replay steps, every row
  0..n-1 is written exactly once, and no launch reads a row it writes;
* the batched operand build's slice for a chunk equals a per-chunk
  `p_matrices_wave` exactly;
* the CUDA wrapper's launch-table check refuses rows outside the arena
  or the packed arrays and a row written twice, and the dataflow table a
  read of a row that the same or a later table row writes;
* the dataflow table (`fastpath.dataflow_table`): each row's first entry
  and every slot's wait bits, on random trees, caterpillars and chained
  and unchained hand-made tables; and a numpy simulation of the dataflow
  launch's claim-and-wait protocol (a few CTAs claiming groups of tiles
  in table order, each waiting on its children's groups over the same
  sites) that never waits on a later claim and always finishes.

No JAX here: the layout is the port's own copy of the JAX package's, and
tests/test_torch_newview.py holds the chunk tier against JAX.
"""

import numpy as np
import pytest
import torch

from examl_tpu_torch import datatypes
from examl_tpu_torch.models.gtr import build_model
from examl_tpu_torch.ops import fastpath, kernels, newview_chunk
from examl_tpu_torch.ops.engine import stack_models
from examl_tpu_torch.tree.topology import Tree

CPU = torch.device("cpu")
SCALE_EXP = 256                  # f64


def _tree(ntaxa, seed):
    tree = Tree.random([f"t{i}" for i in range(ntaxa)], seed, 1)
    rng = np.random.default_rng(seed)
    for p, _ in tree.all_branches():
        p.z[:] = [float(rng.uniform(0.05, 0.98))]
    return tree, tree.flat_full_traversal(tree.centroid_branch())


def _models(M, seed):
    rng = np.random.default_rng(seed)
    models = []
    for _ in range(M):
        rates = rng.uniform(0.3, 6.0, 6)
        rates[-1] = 1.0
        models.append(build_model(datatypes.DNA, rng.dirichlet(np.ones(4) * 5),
                                  rates=rates, alpha=rng.uniform(0.2, 1.5),
                                  ncat=4))
    return stack_models(models, [0] * M, torch.float64, CPU)


def _padded_run(st, clv, scaler, codes, table, bp, pmat):
    """Every chunk of the bounded layout at its full width, pads and
    replay steps included, in execution order: the padded program."""
    for ch in fastpath.iter_chunks(st.profile, st.base):
        newview_chunk.apply_chunk_plain(clv, scaler, codes, table, bp,
                                        ch.kind, ch.base, ch.slot, ch.width,
                                        st.lidx, st.ridx, st.lcode, st.rcode,
                                        pmat, SCALE_EXP)


@pytest.mark.parametrize("ntaxa,seed", [(24, 0), (100, 1), (512, 2)])
def test_compact_run_equals_padded_run_bitwise(ntaxa, seed):
    """f64, tip table scaled by 2^-130 so tip/tip products fall under
    2^-256 and rescale; B = 2 blocks of 128 sites in two partitions."""
    _, flat = _tree(ntaxa, seed)
    rng = np.random.default_rng(seed + 10)
    B, L, M = 2, 128, 2
    dm = _models(M, seed)
    st = fastpath.build_structure(flat, ntaxa, CPU)
    zl, zr = fastpath.refresh_z(st, flat, 1, torch.float64, CPU)
    pmat = newview_chunk.chunk_operands(dm, zl, zr)
    table = torch.as_tensor(datatypes.DNA.tip_indicator_table(),
                            dtype=torch.float64) * 2.0 ** -130
    codes = torch.as_tensor(rng.choice([1, 2, 4, 8, 15, 5], (ntaxa, B, L)),
                            dtype=torch.uint8)
    bp = torch.as_tensor([0, 1], dtype=torch.int32)
    rows = ntaxa - 2 + fastpath.slack_rows(ntaxa) + 1
    assert st.max_write <= rows - 1
    clv0 = torch.as_tensor(rng.uniform(0, 1, (rows, B, L, 4, 4)))
    sc0 = torch.as_tensor(rng.integers(0, 3, (rows, B, L)),
                          dtype=torch.int32)
    c_pad, s_pad = clv0.clone(), sc0.clone()
    _padded_run(st, c_pad, s_pad, codes, table, bp, pmat)
    c_cmp, s_cmp = clv0.clone(), sc0.clone()
    newview_chunk.chunk_apply(c_cmp, s_cmp, codes, table, bp, st.launch,
                              st.lidx, st.ridx, st.lcode, st.rcode, pmat,
                              SCALE_EXP)
    real = torch.as_tensor(np.sort(st.row_of[st.row_of >= 0]))
    assert real.shape[0] == flat.n
    assert int((s_cmp[real] - sc0[real]).sum()) > 0    # rescale happened
    assert torch.equal(s_cmp[real], s_pad[real])
    assert torch.equal(c_cmp[real], c_pad[real])
    # The compact run writes nothing outside the real rows.
    rest = torch.as_tensor(np.setdiff1d(np.arange(rows), real.numpy()))
    assert torch.equal(c_cmp[rest], clv0[rest])
    assert torch.equal(s_cmp[rest], sc0[rest])


@pytest.mark.parametrize("ntaxa,seed", [(12, 0), (37, 1), (100, 2),
                                        (512, 3), (512, 4)])
def test_launch_table_properties(ntaxa, seed):
    _, flat = _tree(ntaxa, seed)
    (layout, row_of, base, lidx, ridx, lcode, rcode, _zs,
     _zw) = fastpath.structure_arrays(flat, ntaxa)
    launch = fastpath.launch_table(layout)
    n = flat.n
    assert launch.dtype == np.int32 and launch.shape[1] == 4
    kind, lbase, slot, real = launch.T
    assert int(real.sum()) == n and (real >= 1).all()
    # Skipped chunks are exactly the pads and the replay steps.
    kept = [(c.kind, c.base, c.slot, c.real) for c in layout.chunks
            if not c.pad and c.replay_of is None]
    assert [tuple(r) for r in launch.tolist()] == kept
    assert len(layout.chunks) - len(kept) == sum(
        1 for c in layout.chunks if c.pad or c.replay_of is not None)
    # Every row 0..n-1 is written exactly once, in order.
    written = np.concatenate([np.arange(b, b + r) for b, r in
                              zip(lbase, real)])
    np.testing.assert_array_equal(written, np.arange(n))
    np.testing.assert_array_equal(np.sort(row_of[row_of >= 0]), np.arange(n))
    # No launch reads a row it writes; every inner read was written by an
    # earlier launch.
    done = 0
    for k, b, s, r in launch.tolist():
        reads = []
        if k == 2:
            reads.append(lidx[s:s + r])
        if k >= 1:
            reads.append(ridx[s:s + r])
        for rd in reads:
            assert not np.any((rd >= b) & (rd < b + r)), (k, b, r)
            assert np.all(rd < done)
        for c in (lcode[s:s + r], rcode[s:s + r]):
            assert np.all((c >= 0) & (c < ntaxa))
        done = b + r


def test_launch_table_is_cached_with_the_structure():
    _, flat = _tree(64, 5)
    st = fastpath.build_structure(flat, 64, CPU)
    layout = fastpath.structure_arrays(flat, 64)[0]
    np.testing.assert_array_equal(st.launch, fastpath.launch_table(layout))
    assert st.launch.shape[0] < sum(1 for _ in fastpath.iter_chunks(
        st.profile, st.base))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_operands_equal_per_chunk_build(dtype):
    _, flat = _tree(100, 6)
    dm = _models(3, 6)
    dm = dm._replace(**{k: getattr(dm, k).to(dtype) for k in
                        ("eign", "ev", "ei", "freqs", "gamma_rates",
                         "rate_weights")})
    st = fastpath.build_structure(flat, 100, CPU)
    zl, zr = fastpath.refresh_z(st, flat, 1, dtype, CPU)
    pmat = newview_chunk.chunk_operands(dm, zl, zr)
    assert pmat.shape == (zl.shape[0], 2, 3, 4, 4, 4) and pmat.is_contiguous()
    for _, _, s, r in st.launch.tolist():
        assert torch.equal(pmat[s:s + r, 0],
                           kernels.p_matrices_wave(dm, zl[s:s + r]))
        assert torch.equal(pmat[s:s + r, 1],
                           kernels.p_matrices_wave(dm, zr[s:s + r]))


@pytest.mark.parametrize("row", [(3, 0, 0, 1), (2, 0, 0, 0), (2, 7, 0, 2),
                                 (2, 0, 5, 2), (2, -1, 0, 1)])
def test_check_launch_refuses_rows_outside_the_arena(row):
    """A bad kind, an empty chunk, rows past the arena (8 rows), slots
    past the packed arrays (6 slots) or a negative base are refused
    before anything is launched."""
    ok = np.asarray([(0, 0, 0, 2), (2, 2, 2, 3)], np.int32)
    np.testing.assert_array_equal(newview_chunk.check_launch(ok, 8, 6), ok)
    with pytest.raises(ValueError, match="launch table row 1"):
        newview_chunk.check_launch(np.asarray([ok[0], row]), 8, 6)


@pytest.mark.parametrize("row,what", [
    ((2, 1, 2, 2), "writes a row an other"),     # rows 1..2 written twice
    ((2, 4, 2, 2), "reads a row that it or a later")])
def test_check_launch_refuses_double_writes_and_reads_of_later_rows(row,
                                                                   what):
    """Rows 0-1 tip/tip, then a second row that writes row 1 again, or
    whose slot 2 reads row 4, which that row writes itself: the double
    write refused by check_launch (and so by the dataflow table), the read
    by the dataflow table, which has the children."""
    lidx = np.asarray([0, 0, 4, 5], np.int32)
    ridx = np.asarray([0, 0, 0, 1], np.int32)
    table = np.asarray([(0, 0, 0, 2), row], np.int32)
    with pytest.raises(ValueError, match=what):
        fastpath.dataflow_table(table, lidx, ridx)
    if "later" in what:
        np.testing.assert_array_equal(
            newview_chunk.check_launch(table, 8, 4), table)
        # A read of a row a later table row writes is refused as well.
        later = np.asarray([(2, 2, 2, 2), (0, 4, 0, 2)], np.int32)
        with pytest.raises(ValueError, match="row 0"):
            fastpath.dataflow_table(later, lidx, ridx)
    else:
        with pytest.raises(ValueError, match=what):
            newview_chunk.check_launch(table, 8, 4)


def _caterpillar(ntaxa):
    s = "(t0,t1)"
    for i in range(2, ntaxa - 1):
        s = f"({s},t{i})"
    tree = Tree.from_newick(f"({s},t{ntaxa - 1});",
                            [f"t{i}" for i in range(ntaxa)], 1)
    return tree, tree.flat_full_traversal(tree.centroid_branch())


def _flow_arrays(shape, ntaxa, seed):
    _, flat = _caterpillar(ntaxa) if shape == "caterpillar" else _tree(
        ntaxa, seed)
    (layout, _, _, lidx, ridx, _, _, _, _) = fastpath.structure_arrays(
        flat, ntaxa)
    launch = fastpath.launch_table(layout)
    rows, wait = fastpath.dataflow_table(launch, lidx, ridx)
    return flat, launch, lidx, ridx, rows, wait


@pytest.mark.parametrize("shape,ntaxa,seed", [
    ("random", 12, 0), ("random", 100, 1), ("random", 512, 2),
    ("caterpillar", 40, 0), ("caterpillar", 512, 0)])
def test_dataflow_table_first_entries_and_wait_bits(shape, ntaxa, seed):
    """rows = the table with each row's first entry (prefix sums of real)
    and a last row holding the entry count; in a full traversal every
    inner child of a table row waits and no tip does, and slots outside
    the table's rows (padding, replays) wait for nothing."""
    flat, launch, lidx, ridx, rows, wait = _flow_arrays(shape, ntaxa, seed)
    assert rows.dtype == np.int32 and rows.shape == (launch.shape[0] + 1, 4)
    np.testing.assert_array_equal(rows[:-1, :3], launch[:, :3])
    np.testing.assert_array_equal(
        rows[:, 3], np.concatenate([[0], np.cumsum(launch[:, 3])]))
    assert rows[-1, 3] == flat.n
    expect = np.zeros_like(wait)
    for k, _, s, r in launch.tolist():
        expect[s:s + r] = (1 if k == 2 else 0) | (2 if k >= 1 else 0)
    np.testing.assert_array_equal(wait, expect)
    if shape == "caterpillar":
        # Rooted at its centroid, one entry a wave on each side: most
        # rows have real <= 2.
        assert (launch[:, 3] <= 2).sum() > launch.shape[0] // 2


def test_dataflow_table_of_chained_and_unchained_tables():
    """chip_smoke.py's b1_case shape: launch 0 reads a region that no row
    writes (no waits); a chained launch reads its predecessor's rows (its
    inner children wait); an unchained one reads the region again."""
    W = 4
    rng = np.random.default_rng(0)
    spec = [(0, W), (1, 3), (2, 2), (2, W)]
    launch, lidx, ridx = [], [], []
    row, slot, prev = 2 * W, 0, None
    for i, (kind, real) in enumerate(spec):
        chained = i in (1, 2)
        src = (np.arange(prev[0], prev[0] + prev[1]) if chained
               else np.arange(2 * W))
        lidx.append(rng.choice(src, real))
        ridx.append(rng.choice(src, real))
        launch.append((kind, row, slot, real))
        prev = (row, real)
        row += real
        slot += real
    launch = np.asarray(launch, np.int32)
    lidx, ridx = np.concatenate(lidx), np.concatenate(ridx)
    rows, wait = fastpath.dataflow_table(launch, lidx, ridx)
    np.testing.assert_array_equal(rows[:, 3], [0, 4, 7, 9, 13])
    np.testing.assert_array_equal(wait, [0] * 4 + [2] * 3 + [3] * 2
                                  + [0] * 4)


def _simulate(launch, lidx, ridx, wait, ng, ctas, hold, seed):
    """The dataflow launch's protocol in numpy: `ctas` CTAs claim groups
    q = entry x ng + g in table order, one at a time, each holding up to
    `hold` claims (the kernel claims the next group while it stages the
    current one's last tile), and complete their claims in order; a group
    can complete once the groups (writer entry of each waited child, g)
    are complete.  CTAs run in a random order.  Fails on a wait for a
    later claim or on a deadlock."""
    rng = np.random.default_rng(seed)
    entries = int(launch[:, 3].sum())
    writer = {}                     # arena row -> its entry
    slot_of = np.empty(entries, np.int64)
    e = 0
    for _, b, s, r in launch.tolist():
        for w in range(r):
            writer[b + w] = e
            slot_of[e] = s + w
            e += 1
    groups = entries * ng
    deps = []
    for q in range(groups):
        e, g = divmod(q, ng)
        sl = slot_of[e]
        d = []
        if wait[sl] & 1:
            d.append(writer[int(lidx[sl])] * ng + g)
        if wait[sl] & 2:
            d.append(writer[int(ridx[sl])] * ng + g)
        assert all(x < q for x in d), "a group waits on a later claim"
        deps.append(d)
    done = np.zeros(groups, bool)
    counter, queues, steps = 0, [[] for _ in range(ctas)], 0
    live = list(range(ctas))
    while live:
        steps += 1
        assert steps < 50 * groups + 1000, "deadlock"
        c = live[rng.integers(len(live))]
        q = queues[c]
        if len(q) < hold and counter < groups and rng.integers(2):
            q.append(counter)
            counter += 1
        if not q:
            if counter >= groups:
                live.remove(c)
            continue
        if all(done[x] for x in deps[q[0]]):
            done[q.pop(0)] = True
    assert done.all()


@pytest.mark.parametrize("shape,ntaxa,ng,ctas,hold", [
    ("random", 100, 3, 5, 1), ("random", 100, 4, 7, 2),
    ("caterpillar", 64, 2, 4, 1), ("caterpillar", 64, 8, 9, 2)])
def test_dataflow_protocol_simulation(shape, ntaxa, ng, ctas, hold):
    """Every inner child a table row writes is waited on, no tile waits on
    a later claim, and CTAs that hold their claims in order always
    finish, whatever order they run in."""
    _, launch, lidx, ridx, _, wait = _flow_arrays(shape, ntaxa, 0)
    written = np.zeros(int((launch[:, 1] + launch[:, 3]).max()), bool)
    for _, b, _, r in launch.tolist():
        written[b:b + r] = True
    for k, _, s, r in launch.tolist():
        for sl in range(s, s + r):
            if k == 2:
                assert bool(wait[sl] & 1) == bool(written[lidx[sl]])
            if k >= 1:
                assert bool(wait[sl] & 2) == bool(written[ridx[sl]])
    for seed in range(3):
        _simulate(launch, lidx, ridx, wait, ng, ctas, hold, seed)
