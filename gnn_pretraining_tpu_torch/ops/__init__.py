"""Compute ops: segment reductions, the GIN aggregation (kernel K1, and
kernel K3 over the adjacency's nonzeros) and the fused NT-Xent (kernel K2,
``ops.ntxent``).

The aggregation entries ``spmm`` and ``spmm_csr`` are reached as
``ops.spmm.spmm`` and ``ops.spmm_csr.spmm_csr``: the package attributes of
those names are their modules."""

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
from gnn_pretraining_tpu_torch.ops.spmm_csr import (
    BlockCSR,
    build_block_csr,
    csr_edges_reference,
    csr_matvec_reference,
    csr_spmm_bwd,
    csr_spmm_fwd,
    gin_aggregate_csr,
    rcm_order,
)
