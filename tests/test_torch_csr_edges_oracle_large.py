"""K3's plain version against the tile oracle, on the last three graphs of
``tests/test_torch_csr_edges.py`` (520 nodes with masked edges, and two
256-node graphs at ``pad_to`` 16; the first three are in
``test_torch_csr_edges_oracle.py``): ``csr_edges_reference`` equals
``csr_matvec_reference`` in every mode within 1e-6 of max |ref|, both
directions; both round alike, only the order of f32 sums differs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch.ops import spmm_csr
from test_torch_csr_edges import GRAPHS, MODES, graph

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,n,e,masked,pad_to", GRAPHS[3:])
def test_edges_reference_equals_the_tile_oracle(seed, n, e, masked, pad_to, mode):
    s, r, m = graph(seed, n, e, masked)
    bsr = spmm_csr.build_block_csr(s, r, m, n, pad_to=pad_to)
    h = torch.from_numpy(np.random.default_rng(seed + 100).normal(
        size=(n, 40)).astype(np.float32))
    for edges, tiles in (((bsr.indptr, bsr.indices, bsr.data),
                          (bsr.vals, bsr.rows, bsr.cols)),
                         ((bsr.indptr_t, bsr.indices_t, bsr.data_t),
                          (bsr.vals_t, bsr.rows_t, bsr.cols_t))):
        got = spmm_csr.csr_edges_reference(*edges, h, 0.3, mode)
        want = spmm_csr.csr_matvec_reference(*tiles, h, 0.3, mode, n)
        assert got.shape == want.shape == (n, 40) and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
