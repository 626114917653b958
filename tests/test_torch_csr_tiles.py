"""The host side of the port's block-CSR aggregation against the JAX one, on
the CPU, on tests/test_spmm_csr.py's numpy-seeded graphs: ``build_block_csr``
gives equal arrays (tiles of A and Aᵀ, tile rows and columns, with and
without ``pad_to``), and ``rcm_order`` the same permutation, which cuts the
tile count. The aggregation itself is in ``test_torch_spmm_csr.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch.ops import spmm_csr
from test_torch_spmm_csr import coo_ref, graph, jax_csr, t

torch.set_num_threads(1)


# (seed, nodes, edges, masked edges, pad_to): the graphs of tests/test_spmm_csr.py.
GRAPHS = [(0, 300, 900, 50, None), (1, 200, 100, 0, 64), (2, 260, 700, 0, None),
          (3, 520, 2000, 200, None), (7, 256, 300, 0, 16), (8, 256, 500, 0, 16)]


@pytest.mark.parametrize("seed,n,e,masked,pad_to", GRAPHS)
def test_build_block_csr_equals_jax(seed, n, e, masked, pad_to):
    s, r, m, _ = graph(seed, n, e, masked)
    want = jax_csr.build_block_csr(s, r, m, n, pad_to=pad_to)
    got = spmm_csr.build_block_csr(s, r, m, n, pad_to=pad_to)
    for name in ("vals", "rows", "cols", "vals_t", "rows_t", "cols_t"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.num_nodes, got.bm, got.bk) == (want.num_nodes, want.bm, want.bk)
    if pad_to is not None:
        assert got.nnzb == got.vals_t.shape[0] == pad_to
    # row_ptr: where each tile row's run starts; pad tiles join the last row.
    for rows, ptr in ((got.rows, got.row_ptr), (got.rows_t, got.row_ptr_t)):
        rows, ptr = rows.numpy(), ptr.numpy()
        assert ptr.dtype == np.int32 and ptr[0] == 0 and ptr[-1] == len(rows)
        for i in range(len(ptr) - 1):
            assert ptr[i + 1] > ptr[i]                  # no tile row is empty
            assert (rows[ptr[i]:ptr[i + 1]] == i).all()


def test_rcm_order_equals_jax_and_cuts_tiles():
    """tests/test_spmm_csr.py's scrambled ring: the same permutation, fewer
    tiles, and the aggregation in the new labelling is the permuted one."""
    rng = np.random.default_rng(9)
    n = 1024
    base_s = np.arange(n, dtype=np.int32)
    base_r = ((base_s + 1 + rng.integers(0, 8, n)) % n).astype(np.int32)
    scramble = rng.permutation(n).astype(np.int32)
    s, r = scramble[base_s], scramble[base_r]
    m = np.ones(n, np.float32)
    h = rng.normal(size=(n, 32)).astype(np.float32)

    perm = spmm_csr.rcm_order(s, r, n)
    np.testing.assert_array_equal(perm, jax_csr.rcm_order(s, r, n))
    inv = np.argsort(perm).astype(np.int32)
    raw = spmm_csr.build_block_csr(s, r, m, n)
    bsr = spmm_csr.build_block_csr(inv[s], inv[r], m, n)
    assert bsr.nnzb < raw.nnzb
    got = spmm_csr.spmm_csr(bsr, t(h[perm]), 0.2, "highest")
    np.testing.assert_allclose(got.numpy(), coo_ref(h, s, r, m, 0.2)[perm],
                               rtol=1e-5, atol=1e-5)
