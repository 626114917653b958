"""Parallelism over ``torch.distributed``: the data axis, the data-parallel
pretrain step and its sharded sampler, and the edge- and node-partitioned
aggregations of one graph over the axis's ranks. Port of
``gnn_pretraining_tpu/parallel`` but for its tensor-parallel mode."""

from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis, make_mesh

__all__ = ["DataAxis", "make_mesh"]
