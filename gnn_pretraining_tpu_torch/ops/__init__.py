"""Compute ops: segment reductions, the GIN aggregation (kernel K1) and the
fused NT-Xent (kernel K2, ``ops.ntxent``).

The aggregation entry ``spmm`` is reached as ``ops.spmm.spmm``: the package
attribute ``spmm`` is its module."""

from gnn_pretraining_tpu_torch.ops.segment import (
    segment_count,
    segment_max,
    segment_mean,
    segment_sum,
)
from gnn_pretraining_tpu_torch.ops.spmm import (
    build_dense_adjacency,
    gin_aggregate,
    gin_aggregate_coo,
    gin_aggregate_dense,
    gin_spmm_bwd,
    gin_spmm_fwd,
    spmm_bwd_reference,
    spmm_reference,
)
