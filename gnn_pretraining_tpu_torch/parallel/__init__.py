"""Data parallelism over ``torch.distributed``: the data axis, the
data-parallel pretrain step and its sharded sampler. Port of the
data-parallel half of ``gnn_pretraining_tpu/parallel`` (the edge- and
node-partitioned and tensor-parallel modes are not ported yet)."""

from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis, make_mesh

__all__ = ["DataAxis", "make_mesh"]
