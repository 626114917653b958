"""Host-side preparation of a single-graph domain for ``aggregation="csr"``.

Port of ``_csr_graph_aux`` in ``gnn_pretraining_tpu/finetune/runners.py``.
The scan-fused runner of that module (whole epochs per device dispatch, the
best-epoch replay) is not ported: it exists to cut TPU dispatches. The
port's ``finetune()`` runs its per-step loop, saves the best state at each
improvement, and writes the fused runner's summary keys (the ``fidelity/*``
block and the steady rates).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_pretraining_tpu_torch.data.batch import GraphBatch
from gnn_pretraining_tpu_torch.ops.spmm_csr import (
    BlockCSR,
    build_block_csr,
    rcm_order,
)


def csr_graph_aux(g: GraphBatch) -> tuple[GraphBatch, BlockCSR, np.ndarray]:
    """RCM-reorder the domain graph and build its ``BlockCSR`` on the host.

    Returns the permuted graph (node rows reordered, edge endpoints
    relabelled, edge order kept), the BlockCSR over the permuted edges and
    ``inv`` (old node id → new node id) for remapping split node indices and
    scored edges. The relabelling gathers the edges near the diagonal, so
    fewer 128 × 128 tiles are nonzero, and it is undone exactly by remapping
    every node-indexed array: losses and metrics equal the unpermuted run up
    to the order of float sums."""
    sen = g.senders.cpu().numpy()
    rec = g.receivers.cpu().numpy()
    em = g.edge_mask.cpu().numpy().astype(np.float32)
    n = g.num_nodes
    valid = em != 0
    perm = rcm_order(sen[valid], rec[valid], n)     # perm[new] = old
    inv = np.argsort(perm).astype(np.int32)         # inv[old] = new
    sen2, rec2 = inv[sen], inv[rec]
    p = torch.from_numpy(perm)
    graph = dataclasses.replace(
        g, x=g.x[p], node_mask=g.node_mask[p], node_graph=g.node_graph[p],
        senders=torch.from_numpy(sen2).to(g.senders.dtype),
        receivers=torch.from_numpy(rec2).to(g.receivers.dtype))
    return graph, build_block_csr(sen2, rec2, em, n), inv
