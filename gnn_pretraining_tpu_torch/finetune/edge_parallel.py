"""Edge-partitioned fine-tuning steps for the full-graph task families.

Port of ``gnn_pretraining_tpu/finetune/edge_parallel.py``. Node
classification and link prediction run one whole-graph forward per step;
these steps are ``finetune.make_nc_steps`` / ``make_lp_steps`` with the
graph's COO edge list split over the ranks of a data axis
(``parallel/edge_partition.py``: rank r holds the r-th block):

  * the model is a ``coo`` ``FinetuneGNN`` built with ``edge_axis``: every
    aggregation sums this rank's partial over the ranks;
  * the node arrays, the parameters and the optimizer state are replicated;
    the BatchNorms see every node, so they need no sum; dropout draws from
    the same seed on every rank and the miner from the same generator seed,
    so the ranks' activations are equal bit for bit;
  * the gradients of the replicated loss are averaged over the ranks (each
    rank's is n times its share: the all-reduce's backward is an
    all-reduce), then the same AdamW step runs on every rank
    (``finetune._update`` with the axis, JAX ``_replicated_update``).

The steps have the call signatures of ``make_nc_steps`` / ``make_lp_steps``.
"""

from __future__ import annotations

import dataclasses

import torch

from gnn_pretraining_tpu_torch.parallel.edge_partition import local_edges
from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis


def local_edge_graph(graph, axis: DataAxis):
    """``graph`` (a ``GraphBatch``, on any device) with this rank's block of
    its padded edge list in place of the whole list."""
    s, r, m = local_edges(graph.senders.cpu().numpy(), graph.receivers.cpu().numpy(),
                          graph.edge_mask.cpu().numpy(), axis)
    on = lambda a: torch.from_numpy(a.copy()).to(graph.senders.device)  # noqa: E731
    return dataclasses.replace(graph, senders=on(s), receivers=on(r), edge_mask=on(m),
                               edge_graph=torch.zeros_like(on(s)))


def make_nc_steps_edge_parallel(model, cfg, optimizer, labels, graph, axis: DataAxis):
    """``make_nc_steps`` over this rank's block of ``graph``'s edges
    (``model`` built with ``aggregation="coo", edge_axis=axis``)."""
    from gnn_pretraining_tpu_torch.finetune.finetune import make_nc_steps

    return make_nc_steps(model, cfg, optimizer, labels, local_edge_graph(graph, axis),
                         None, axis=axis)


def make_lp_steps_edge_parallel(model, cfg, optimizer, labels, graph, axis: DataAxis,
                                forbidden, num_hard: int, generator=None):
    """``make_lp_steps`` over this rank's block of the train graph's edges;
    mining and scoring replicated (``generator`` seeded alike on every
    rank)."""
    from gnn_pretraining_tpu_torch.finetune.finetune import make_lp_steps

    return make_lp_steps(model, cfg, optimizer, labels, local_edge_graph(graph, axis), None,
                         forbidden, num_hard, generator, axis=axis)
