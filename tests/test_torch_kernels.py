"""Port kernels (examl_tpu_torch.ops.kernels) against examl_tpu.ops.kernels.

The same inputs, made with numpy from a seed, go through both packages in
float64 on the CPU: arena rows at rtol 1e-12, lnL and derivative sums at
rtol 1e-10, scalers exactly equal (including a forced-rescale case); the
SEV pool's traversal and gather through a random cell map likewise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu import datatypes as jdt
from examl_tpu.models.gtr import build_model as jbuild
from examl_tpu.ops import kernels as jk
from examl_tpu.ops.engine import stack_models as jstack
from examl_tpu_torch.ops import kernels as tk
from examl_tpu_torch.transfer import state_from_numpy
from examl_tpu_torch.tree.topology import Tree

NTIPS, B, LANE = 10, 3, 128
CPU = torch.device("cpu")


def _state(seed, num_slots=1, table_scale=1.0):
    """(jax models, jax tips, port models, port tips, block_part, weights)
    for M=2 random GTR+G4 partitions over B blocks."""
    rng = np.random.default_rng(seed)
    models = []
    for _ in range(2):
        rates = rng.uniform(0.3, 6.0, 6)
        rates[-1] = 1.0
        models.append(jbuild(jdt.DNA, rng.dirichlet(np.ones(4) * 5),
                             rates=rates, alpha=rng.uniform(0.2, 1.5)))
    part_branch = [0, 1] if num_slots == 2 else [0, 0]
    jm = jstack(models, part_branch, jnp.float64)
    codes = rng.choice([1, 2, 4, 8, 15, 5, 10], (NTIPS, B, LANE)).astype(
        np.uint8)
    table = jdt.DNA.tip_indicator_table() * table_scale
    block_part = np.array([0, 1, 1], np.int32)
    weights = rng.integers(0, 4, (B, LANE)).astype(np.float64)
    arrays = {k: np.asarray(getattr(jm, k)) for k in jm._fields}
    arrays.update(codes=codes, table=table, block_part=block_part,
                  weights=weights)
    jt = jk.TipState(codes=jnp.asarray(codes), table=jnp.asarray(table))
    tm, tt, tbp, tw = state_from_numpy(arrays, CPU)
    return jm, jt, tm, tt, block_part, tbp, weights, tw


def _traversal(seed, num_slots, z=None):
    """A full wave-scheduled traversal of a random tree as numpy arrays
    (rows = node - ntips - 1, gather indices as the engines use)."""
    rng = np.random.default_rng(seed)
    tree = Tree.random([f"t{i}" for i in range(NTIPS)], seed, num_slots)
    p = tree.nodep[NTIPS + 1]
    entries = tree.compute_traversal(p, True) + tree.compute_traversal(
        p.back, True)
    waves = Tree.schedule_waves(entries)
    L, W = len(waves), max(len(w) for w in waves)
    scratch = NTIPS - 2
    par = np.full((L, W), scratch, np.int32)
    lft = np.zeros((L, W), np.int32)
    rgt = np.zeros((L, W), np.int32)
    zl = np.ones((L, W, num_slots))
    zr = np.ones((L, W, num_slots))

    def gidx(n):
        return n - 1 if n <= NTIPS else NTIPS + n - NTIPS - 1

    for li, wave in enumerate(waves):
        for wi, e in enumerate(wave):
            par[li, wi] = e.parent - NTIPS - 1
            lft[li, wi] = gidx(e.left)
            rgt[li, wi] = gidx(e.right)
            zl[li, wi] = z if z is not None else rng.uniform(0.3, 0.99,
                                                              num_slots)
            zr[li, wi] = z if z is not None else rng.uniform(0.3, 0.99,
                                                              num_slots)
    return (par, lft, rgt, zl, zr), gidx(p.number), gidx(p.back.number)


def _run_both(seed, num_slots=1, table_scale=1.0, z=None):
    jm, jt, tm, tt, bp, tbp, w, tw = _state(seed, num_slots, table_scale)
    (par, lft, rgt, zl, zr), pi, qi = _traversal(seed, num_slots, z)
    rows = NTIPS - 1
    shape = (rows, B, LANE, 4, 4)
    jtv = jk.Traversal(*(jnp.asarray(a) for a in (par, lft, rgt, zl, zr)))
    jclv, jsc = jk.traverse(jm, jnp.asarray(bp), jt,
                            jnp.zeros(shape, jnp.float64),
                            jnp.zeros(shape[:3], jnp.int32), jtv, 256, NTIPS)
    ttv = tk.Traversal(*(torch.as_tensor(a).long() for a in (par, lft, rgt)),
                       torch.as_tensor(zl), torch.as_tensor(zr))
    tclv, tsc = tk.traverse(tm, tbp, tt, torch.zeros(shape, dtype=torch.float64),
                            torch.zeros(shape[:3], dtype=torch.int32), ttv,
                            256, NTIPS)
    return dict(j=(jm, jt, jclv, jsc), t=(tm, tt, tclv, tsc), bp=bp, tbp=tbp,
                w=w, tw=tw, pq=(pi, qi))


def _assert_close_per_site(got, ref, rtol):
    """|got - ref| <= rtol * (max |ref| over each site's (rate, state)
    entries): sumtable entries are eigenvector sums that cancel to near
    zero, so an elementwise relative bound would measure only rounding
    of the cancellation."""
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(got - ref) <= rtol * scale)


def test_p_matrices_wave_matches():
    jm, _, tm, *_ = _state(0, num_slots=2)
    z = np.random.default_rng(1).uniform(0.01, 0.99, (7, 2))
    ref = np.asarray(jk.p_matrices_wave(jm, jnp.asarray(z)))
    got = tk.p_matrices_wave(tm, torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        tk.p_matrices(tm, torch.as_tensor(z[0])).numpy(),
        np.asarray(jk.p_matrices(jm, jnp.asarray(z[0]))), rtol=1e-12,
        atol=1e-15)


@pytest.mark.parametrize("case", ["plain", "forced_rescale"])
def test_traverse_rows_and_scalers_match(case):
    rescale = case == "forced_rescale"
    r = _run_both(2, table_scale=2.0 ** -90 if rescale else 1.0)
    _, _, jclv, jsc = r["j"]
    _, _, tclv, tsc = r["t"]
    real = slice(0, NTIPS - 2)              # scratch row excluded
    np.testing.assert_array_equal(tsc.numpy()[real], np.asarray(jsc)[real])
    np.testing.assert_allclose(tclv.numpy()[real], np.asarray(jclv)[real],
                               rtol=1e-12, atol=0)
    if rescale:
        assert int(tsc.sum()) > 0


@pytest.mark.parametrize("case", ["plain", "forced_rescale"])
def test_traverse_pooled_matches(case):
    """The SEV pool's traversal and gather (`traverse_pooled`,
    `gather_child_pooled`) on one random cell map: a third of the (row,
    block) cells unmapped (read as the all-ones cell 0, written to the
    scratch cell 1), every data cell at rtol 1e-12 of JAX's, scalers
    equal."""
    rescale = case == "forced_rescale"
    jm, jt, tm, tt, bp, tbp, _, _ = _state(
        3, table_scale=2.0 ** -90 if rescale else 1.0)
    (par, lft, rgt, zl, zr), pi, qi = _traversal(3, 1)
    rows = NTIPS - 1
    rng = np.random.default_rng(4)
    mapped = rng.random((rows, B)) < 2 / 3
    cell_of = np.where(mapped, np.cumsum(mapped).reshape(rows, B) + 1, -1)
    slot_read = np.where(mapped, cell_of, 0)
    slot_write = np.where(mapped, cell_of, 1)
    cells = int(mapped.sum()) + 2
    pool = np.zeros((cells, LANE, 4, 4))
    pool[0] = 1.0
    jtv = jk.Traversal(*(jnp.asarray(a) for a in (par, lft, rgt, zl, zr)))
    jpool, jsc = jk.traverse_pooled(
        jm, jnp.asarray(bp), jt, jnp.asarray(pool), jnp.asarray(slot_read),
        jnp.asarray(slot_write), jnp.zeros((rows, B, LANE), jnp.int32), jtv,
        256, NTIPS)
    ttv = tk.Traversal(*(torch.as_tensor(a).long() for a in (par, lft, rgt)),
                       torch.as_tensor(zl), torch.as_tensor(zr))
    tslot_read = torch.as_tensor(slot_read)
    tpool, tsc = tk.traverse_pooled(
        tm, tbp, tt, torch.as_tensor(pool), tslot_read,
        torch.as_tensor(slot_write), torch.zeros((rows, B, LANE),
                                                 dtype=torch.int32), ttv,
        256, NTIPS)
    data = np.arange(cells) != 1            # the scratch cell excluded
    np.testing.assert_allclose(tpool.numpy()[data], np.asarray(jpool)[data],
                               rtol=1e-12, atol=0)
    real = slice(0, NTIPS - 2)
    np.testing.assert_array_equal(tsc.numpy()[real], np.asarray(jsc)[real])
    if rescale:
        assert int(tsc.sum()) > 0
    for idx in (pi, qi):
        jx, js = jk.gather_child_pooled(jt, jpool, jnp.asarray(slot_read),
                                        jsc, idx, NTIPS)
        tx, ts = tk.gather_child_pooled(tt, tpool, tslot_read, tsc, idx,
                                        NTIPS)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-12,
                                   atol=0)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_newview_wave_matches():
    jm, _, tm, _, bp, tbp, *_ = _state(3)
    rng = np.random.default_rng(3)
    # per-site magnitudes around 2^-128, so products straddle 2^-256
    mag = 2.0 ** rng.uniform(-136, -120, (2, 5, B, LANE, 1, 1))
    xl, xr = rng.uniform(0, 1, (2, 5, B, LANE, 4, 4)) * mag
    zl, zr = rng.uniform(0.05, 0.99, (2, 5, 1))
    jv, jinc = jk.newview_wave(jm, jnp.asarray(bp), jnp.asarray(xl),
                               jnp.asarray(xr), jnp.asarray(zl),
                               jnp.asarray(zr), 256)
    tv, tinc = tk.newview_wave(tm, tbp, torch.as_tensor(xl),
                               torch.as_tensor(xr), torch.as_tensor(zl),
                               torch.as_tensor(zr), 256)
    np.testing.assert_array_equal(tinc.numpy(), np.asarray(jinc))
    assert 0 < int(tinc.sum()) < tinc.numel()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12)


@pytest.mark.parametrize("num_slots", [1, 2])
def test_root_lnl_sumtable_and_derivatives_match(num_slots):
    r = _run_both(4, num_slots=num_slots)
    jm, jt, jclv, jsc = r["j"]
    tm, tt, tclv, tsc = r["t"]
    pi, qi = r["pq"]
    z = np.array([0.7, 0.4])[:num_slots]
    jl = np.asarray(jk.root_log_likelihood(
        jm, jnp.asarray(r["bp"]), jnp.asarray(r["w"]), jt, jclv, jsc, pi, qi,
        jnp.asarray(z), 2, 256, NTIPS))
    tl = tk.root_log_likelihood(tm, r["tbp"], r["tw"], tt, tclv, tsc, pi, qi,
                                torch.as_tensor(z), 2, 256, NTIPS).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-10)

    jxp, _ = jk.gather_child(jt, jclv, jsc, pi, NTIPS)
    jxq, _ = jk.gather_child(jt, jclv, jsc, qi, NTIPS)
    jst = jk.sumtable(jm, jnp.asarray(r["bp"]), jxp, jxq)
    txp, _ = tk.gather_child(tt, tclv, tsc, pi, NTIPS)
    txq, _ = tk.gather_child(tt, tclv, tsc, qi, NTIPS)
    tst = tk.sumtable(tm, r["tbp"], txp, txq)
    _assert_close_per_site(tst.numpy(), np.asarray(jst), 1e-12)

    jd = jk.nr_derivatives(jm, jnp.asarray(r["bp"]), jnp.asarray(r["w"]), jst,
                           jnp.asarray(z), num_slots)
    td = tk.nr_derivatives(tm, r["tbp"], r["tw"], tst, torch.as_tensor(z),
                           num_slots)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)

    z0 = np.full(num_slots, 0.9)
    jz = np.asarray(jk.newton_raphson_branch(
        jm, jnp.asarray(r["bp"]), jnp.asarray(r["w"]), jst, jnp.asarray(z0),
        jnp.full(num_slots, 30, jnp.int32), jnp.zeros(num_slots, bool),
        num_slots))
    tz = tk.newton_raphson_branch(tm, r["tbp"], r["tw"], tst, z0,
                                  np.full(num_slots, 30),
                                  np.zeros(num_slots, bool), num_slots)
    np.testing.assert_allclose(tz, jz, rtol=1e-10)
    assert np.all(np.abs(tz - z0) > 1e-6)      # the NR actually moved


@pytest.mark.parametrize("lanes", [(), (1,), (5,), (3, 4)])
def test_segment_sum_adds_each_run_in_index_order(lanes):
    """The site sum: per segment (a run of the nondecreasing ids, empty
    runs included) the values added one after another from 0, which is
    index_add_'s order on the CPU, and each lane's bits the same whatever
    leading axes it shares the call with."""
    rng = np.random.default_rng(17)
    seg = torch.as_tensor(np.sort(rng.choice([0, 1, 3, 4], 300)))
    v = torch.as_tensor(rng.standard_normal(lanes + (300,)) * 1e3)
    got = tk._segment_sum(v, seg, 6)
    ref = torch.zeros(lanes + (6,), dtype=v.dtype).index_add_(v.dim() - 1,
                                                              seg, v)
    assert got.shape == lanes + (6,)
    assert torch.equal(got, ref)
    assert not got[..., 2].any() and not got[..., 5].any()
    if lanes:
        one = tk._segment_sum(v.reshape(-1, 300)[-1], seg, 6)
        assert torch.equal(got.reshape(-1, 6)[-1], one)

