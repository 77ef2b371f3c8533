"""The tip-product operand of kernels B1 and B2 against the JAX package.

`newview_chunk.tip_products(pmat, table)` builds, once per traversal,
u[s, side, m, c, r, a] = sum_k P[s, side, m, r, a, k] * table[c, k]: the
y of a tip child for every tip code.  The JAX package builds the same
table per chunk for its Pallas kernel (`pallas_newview._ump`, a plain
einsum at HIGHEST precision, [W, B, C, R*K] after indexing by
block_part).  f64 on the CPU, rtol 1e-12: both are one contraction of K
terms in f64.  Every tip code of the data type is in the table, the
ambiguity codes (DNA N and the IUPAC codes, amino-acid B, Z and X, the
gap) included; their rows are also checked to be the sum of P over the
states they allow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examl_tpu_torch import datatypes
from examl_tpu_torch.ops import newview_chunk


@pytest.mark.parametrize("K,ambiguous", [(4, "NRYKMSWBDHV-"),
                                         (20, "BZX-"), (2, "-")])
def test_tip_products_match_jax_ump(K, ambiguous):
    from examl_tpu.ops.pallas_newview import _ump
    dt = {4: datatypes.DNA, 20: datatypes.AA, 2: datatypes.BINARY}[K]
    rng = np.random.default_rng(K)
    P, M, R, B = 5, 3, 4, 6
    pmat = rng.uniform(0.0, 1.0, (P, 2, M, R, K, K))
    table = dt.tip_indicator_table()
    C = table.shape[0]
    bp = rng.integers(0, M, B)
    u = newview_chunk.tip_products(torch.as_tensor(pmat),
                                   torch.as_tensor(table))
    assert u.shape == (P, 2, M, C, R, K) and u.is_contiguous()
    u = u.numpy()
    for side in (0, 1):
        ref = np.asarray(_ump(jnp.asarray(pmat[:, side]), jnp.asarray(table),
                              jnp.asarray(bp)))             # [P, B, C, RK]
        got = u[:, side][:, bp].reshape(P, B, C, R * K)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    for c in dt.encode(ambiguous):
        allowed = table[c] > 0
        assert allowed.sum() > 1, (K, c)
        np.testing.assert_allclose(u[:, :, :, c],
                                   pmat[..., allowed].sum(-1), rtol=1e-12)
