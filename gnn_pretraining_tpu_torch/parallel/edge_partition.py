"""Edge-partitioned message passing over the ranks of a data axis.

Port of ``gnn_pretraining_tpu/parallel/edge_partition.py``. The graph's COO
edge list is padded to a multiple of the axis's size (``shard_edges``) and
rank r holds its r-th contiguous block, as ``P("edge")`` hands each device
its block. Each rank gathers its senders' rows from the (replicated) node
array and sums a partial aggregation over its own edges, with the masked
``index_add_`` of one device; the partials are summed over the ranks (one
all-reduce, ``DataAxis.psum``: exact, the aggregation is additive over
edges), and the ``(1+eps)·h`` term is added once after the sum. The
all-reduce's backward is an all-reduce of the gradient, as JAX transposes
``psum``, so the backward also runs over each rank's edges only.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_pretraining_tpu_torch.data.batch import round_up
from gnn_pretraining_tpu_torch.ops.spmm import gin_aggregate_coo
from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis


def shard_edges(senders, receivers, edge_mask, n_shards: int):
    """Pad the edge list to a multiple of ``n_shards`` (host-side numpy)."""
    e = np.asarray(senders).shape[0]
    pad = round_up(e, n_shards) - e
    senders, receivers, edge_mask = (np.asarray(a) for a in (senders, receivers, edge_mask))
    if pad:
        senders = np.pad(senders, (0, pad))
        receivers = np.pad(receivers, (0, pad))
        edge_mask = np.pad(edge_mask, (0, pad))
    return senders, receivers, edge_mask


def rank_block(a, axis: DataAxis):
    """This rank's contiguous block of ``a``'s dim 0 (a multiple of the
    axis's size long)."""
    n = a.shape[0] // axis.size
    return a[axis.rank * n:(axis.rank + 1) * n]


def local_edges(senders, receivers, edge_mask, axis: DataAxis):
    """This rank's block of the padded edge list, as numpy."""
    return tuple(rank_block(a, axis)
                 for a in shard_edges(senders, receivers, edge_mask, axis.size))


def edge_partitioned_aggregate(axis: DataAxis, h: torch.Tensor, senders: torch.Tensor,
                               receivers: torch.Tensor, edge_mask: torch.Tensor,
                               eps) -> torch.Tensor:
    """``Σ_{j∈N(i)} h_j + (1+eps) h`` with the edges (padded to a multiple of
    the axis's size) split over the ranks; ``h`` and the result replicated."""
    s, r, m = (rank_block(a, axis) for a in (senders, receivers, edge_mask))
    return gin_aggregate_coo(h, s, r, m, eps, edge_axis=axis)


def make_edge_partitioned_gin_fn(axis: DataAxis):
    """Aggregation callable with ``ops.spmm.gin_aggregate_coo``'s signature,
    bound to ``axis``."""

    def agg(h, senders, receivers, edge_mask, eps):
        return edge_partitioned_aggregate(axis, h, senders, receivers, edge_mask, eps)

    return agg
