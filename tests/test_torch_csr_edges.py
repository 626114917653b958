"""K3's operands and plain version: the edge CSRs of ``BlockCSR`` against its tiles.

``build_block_csr`` describes A twice from the same masked edges: as the
nonzero 128 × 128 tiles of A and Aᵀ (byte-equal to the JAX package's, held
in tests/test_torch_spmm_csr.py) and as a CSR of A by destination row and of
Aᵀ by source row, which kernel K3 reads. Here, on tests/test_spmm_csr.py's
graphs with duplicated edges added:

  * each CSR gives exactly the dense matrix of its tiles (masked edges
    dropped, duplicates summed, rows and tile rows without edges, ``pad_to``);
  * ``csr_edges_reference`` (K3's plain version) equals the tile oracle
    ``csr_matvec_reference`` in every mode within 1e-6 of max |ref|: both
    round alike, only the order of f32 sums differs
    (``test_torch_csr_edges_oracle.py`` and ``_oracle_large.py``);
  * ``BlockCSR.to`` moves the edge CSRs and leaves the tiles where they are.

No JAX here: the JAX side of both descriptions is held in
tests/test_torch_spmm_csr.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch.ops import spmm_csr

# Small CPU shapes: one intra-op thread per test process.
torch.set_num_threads(1)

MODES = ("highest", "split", "bf16")
# (seed, nodes, edges, masked edges, pad_to): the graphs of tests/test_spmm_csr.py.
GRAPHS = [(0, 300, 900, 50, None), (1, 200, 100, 0, 64), (2, 260, 700, 0, None),
          (3, 520, 2000, 200, None), (7, 256, 300, 0, 16), (8, 256, 500, 0, 16)]
EDGE_FIELDS = ("indptr", "indices", "data", "indptr_t", "indices_t", "data_t")
TILE_FIELDS = ("vals", "rows", "cols", "vals_t", "rows_t", "cols_t", "row_ptr",
               "row_ptr_t")


def graph(seed, n, e, masked=0):
    """tests/test_spmm_csr.py:_graph, then its first tenth of edges again
    (duplicates, some of them masked)."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = rng.integers(0, n, e).astype(np.int32)
    mask = np.ones(e, np.float32)
    if masked:
        mask[rng.choice(e, masked, replace=False)] = 0.0
    d = e // 10
    return (np.concatenate([senders, senders[:d]]),
            np.concatenate([receivers, receivers[:d]]),
            np.concatenate([mask, mask[:d]]))


def dense_of_tiles(vals, rows, cols, n):
    bm, bk = vals.shape[1:]
    n_pad = -(-n // max(bm, bk)) * max(bm, bk)
    out = np.zeros((n_pad, n_pad), np.float32)
    for v, r, c in zip(vals.numpy(), rows.numpy(), cols.numpy()):
        out[r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] += v
    assert not out[n:].any() and not out[:, n:].any()
    return out[:n, :n]


def dense_of_csr(indptr, indices, data, n):
    indptr, indices, data = indptr.numpy(), indices.numpy(), data.numpy()
    assert indptr.dtype == indices.dtype == np.int32 and data.dtype == np.float32
    assert indptr.shape == (n + 1,) and indptr[0] == 0 and indptr[-1] == len(indices)
    assert (np.diff(indptr) >= 0).all()
    out = np.zeros((n, n), np.float32)
    for row in range(n):
        cols = indices[indptr[row]:indptr[row + 1]]
        assert (np.diff(cols) > 0).all()        # sorted, each column once
        out[row, cols] = data[indptr[row]:indptr[row + 1]]
    return out


@pytest.mark.parametrize("transpose", [False, True], ids=["A", "At"])
@pytest.mark.parametrize("seed,n,e,masked,pad_to", GRAPHS)
def test_edge_csr_is_the_dense_matrix_of_the_tiles(seed, n, e, masked, pad_to, transpose):
    s, r, m = graph(seed, n, e, masked)
    bsr = spmm_csr.build_block_csr(s, r, m, n, pad_to=pad_to)
    sfx = "_t" if transpose else ""
    tiles = dense_of_tiles(*(getattr(bsr, k + sfx) for k in ("vals", "rows", "cols")), n)
    edges = dense_of_csr(*(getattr(bsr, k + sfx) for k in ("indptr", "indices", "data")), n)
    np.testing.assert_array_equal(edges, tiles)
    want = np.zeros((n, n), np.float32)
    np.add.at(want, (r, s), m)                  # A[dst, src], duplicates summed
    np.testing.assert_array_equal(edges, want.T if transpose else want)
    assert bsr.nnz == np.count_nonzero(want) and bsr.nnz == bsr.indices_t.shape[0]
    if n == 200:                                # 100 edges: rows without any
        assert (np.diff(bsr.indptr.numpy()) == 0).any()


def test_to_moves_the_edges_and_no_tiles():
    s, r, m = graph(0, 300, 900, 50)
    bsr = spmm_csr.build_block_csr(s, r, m, 300)
    moved = bsr.to("meta")
    for name in EDGE_FIELDS:
        assert getattr(moved, name).device.type == "meta", name
    for name in TILE_FIELDS:
        assert getattr(moved, name) is getattr(bsr, name), name
    assert (moved.num_nodes, moved.nnz, moved.nnzb) == (bsr.num_nodes, bsr.nnz, bsr.nnzb)
    with pytest.raises(ValueError, match="unknown mode"):
        spmm_csr.csr_edges_reference(bsr.indptr, bsr.indices, bsr.data,
                                     torch.zeros(300, 8), 0.0, "tf32")
    with pytest.raises(ValueError, match="does not match"):
        spmm_csr.csr_edges_reference(bsr.indptr, bsr.indices, bsr.data,
                                     torch.zeros(299, 8), 0.0, "split")
