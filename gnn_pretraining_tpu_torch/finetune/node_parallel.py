"""Node-partitioned (halo-exchange) fine-tuning steps for full-graph tasks.

Port of ``gnn_pretraining_tpu/finetune/node_parallel.py``.
``finetune/edge_parallel.py`` splits only the edge list and sums a full
``[N, F]`` partial over the ranks in every GIN layer. These steps split the
node rows themselves (``parallel/node_partition.py``): the activations in
the backbone are never replicated, and each layer exchanges only the halo
rows.

  * ``x`` and ``node_mask`` are laid out in the plan's ``[n_dev * n_loc, ·]``
    rows and each rank holds its ``n_loc`` (``NodeShard``); every GIN
    layer's aggregation is the halo exchange (``HaloAggregate``, the
    model's ``aggregate_fn``);
  * every BatchNorm is a SyncBN over the axis, so it normalizes with the
    statistics of the whole graph;
  * dropout in the encoder and the backbone draws from the rank's own seed
    (``rank_seed``, JAX's ``fold_in`` of the device index), so the ranks'
    rows draw independent noise;
  * the logits (NC) or the final embeddings (LP) are gathered rank-major
    (``DataAxis.gather_rows``), after which the loss, the mining and the
    scoring are the single-device ones, replicated; the link predictor's
    dropout draws from a source seeded alike on every rank
    (``replicate_head_dropout``);
  * the loss is replicated, so each rank's gradient is n times its share
    (the gather's backward sums over the ranks); averaging them over the
    ranks gives the gradient of the whole graph, and the same AdamW step
    runs on every rank (``finetune._update`` with the axis).

The steps take the rank's shard as an argument (``train_step(..., shard)``)
rather than closing over it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.finetune.mining import mine_hard_negatives
from gnn_pretraining_tpu_torch.models.gnn import DropoutSource, share_dropout_source
from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis
from gnn_pretraining_tpu_torch.parallel.node_partition import (
    build_node_partition_plan,
    halo_aggregate_local,
    pad_node_rows,
    plan_tensors,
)
from gnn_pretraining_tpu_torch.utils.losses import masked_bce_with_logits_mean


@dataclasses.dataclass
class NodeShard:
    """One rank's rows of the graph and its slices of the plan."""

    x: torch.Tensor                # [n_loc, D]
    node_mask: torch.Tensor        # [n_loc]
    plan: tuple                    # the plan's arrays, node_partition.PLAN_ARRAYS order

    def to(self, device) -> "NodeShard":
        return NodeShard(self.x.to(device), self.node_mask.to(device),
                         tuple(a.to(device) for a in self.plan))


def prepare(graph, axis: DataAxis, device) -> tuple:
    """``(plan, shard)``: the graph's plan over the axis's ranks and this
    rank's ``NodeShard`` on ``device`` (``graph`` a ``GraphBatch``)."""
    senders, receivers, edge_mask, x, node_mask = (
        a.cpu().numpy() for a in (graph.senders, graph.receivers, graph.edge_mask,
                                  graph.x, graph.node_mask))
    plan = build_node_partition_plan(senders, receivers, edge_mask, x.shape[0], axis.size)
    x = pad_node_rows(x, plan)
    nm = np.zeros(plan.n_dev * plan.n_loc, np.float32)
    nm[:len(node_mask)] = node_mask
    rows = slice(axis.rank * plan.n_loc, (axis.rank + 1) * plan.n_loc)
    shard = NodeShard(torch.from_numpy(np.ascontiguousarray(x[rows])).to(device),
                      torch.from_numpy(nm[rows]).to(device),
                      plan_tensors(plan, axis.rank, device))
    return plan, shard


class HaloAggregate:
    """A node-partitioned model's ``aggregate_fn``: this rank's halo-exchange
    aggregation over the plan slices of the shard bound last (``bind``, which
    every step calls with the shard it is given)."""

    def __init__(self, axis: DataAxis):
        self.axis = axis
        self.shard: Optional[NodeShard] = None

    def bind(self, shard: NodeShard) -> None:
        self.shard = shard

    def __call__(self, h: torch.Tensor, eps) -> torch.Tensor:
        if self.shard is None:
            raise RuntimeError("HaloAggregate has no shard: a node-partitioned step "
                               "binds it before the forward")
        return halo_aggregate_local(h, eps, *self.shard.plan, self.axis)


def replicate_head_dropout(model, seed: int) -> DropoutSource:
    """Give the task head's dropout a source of its own, seeded ``seed`` on
    every rank: the head runs replicated on the gathered rows."""
    return share_dropout_source(model.classification_head, model.dropout.device, seed)


def _halo(model) -> HaloAggregate:
    halo = model.gnn_backbone.aggregate_fn
    if not isinstance(halo, HaloAggregate):
        raise ValueError("a node-partitioned step needs a model built with "
                         "aggregate_fn=HaloAggregate(axis)")
    return halo


def make_nc_steps_node_parallel(model, cfg, optimizer, labels, axis: DataAxis):
    """Node-partitioned ``make_nc_steps``: ``train_step(node_idx, y, shard)``
    and ``eval_step(node_idx, y, shard)`` (``model`` a ``coo`` model with
    SyncBN on ``axis`` and ``aggregate_fn=HaloAggregate(axis)``; ``node_idx``
    global node ids)."""
    from gnn_pretraining_tpu_torch.finetune.finetune import (
        _class_loss,
        _classification_outputs,
        _update,
    )

    binary = config.NUM_CLASSES[cfg.domain_name] == 2
    halo = _halo(model)

    def loss_from_logits(shard, node_idx, y):
        halo.bind(shard)
        logits = axis.gather_rows(model(shard.x, shard.node_mask))
        sel = logits[node_idx.long()]
        return _class_loss(sel, y, binary).mean(), sel

    def train_step(node_idx, y, shard):
        model.train()
        loss, sel = loss_from_logits(shard, node_idx, y)
        gnorm = _update(model, optimizer, labels, loss, axis)
        probs, preds = _classification_outputs(sel.detach())
        return loss.detach(), y, preds, probs, gnorm

    @torch.no_grad()
    def eval_step(node_idx, y, shard):
        model.eval()
        loss, sel = loss_from_logits(shard, node_idx, y)
        probs, preds = _classification_outputs(sel)
        return loss, y, preds, probs

    return train_step, eval_step


def make_lp_steps_node_parallel(model, cfg, optimizer, labels, axis: DataAxis, forbidden,
                                num_hard: int, generator: Optional[torch.Generator] = None):
    """Node-partitioned ``make_lp_steps``: message passing over the
    partitioned train edges, mining and scoring replicated on the gathered
    final embeddings. ``train_step(pos_edges, edge_mask, shard, *,
    gumbel=None, negatives=None)`` and ``eval_step(edges, y, edge_mask,
    shard)``; ``generator`` seeded alike on every rank."""
    from gnn_pretraining_tpu_torch.finetune.finetune import _lp_outputs, _update

    halo = _halo(model)
    head = model.classification_head
    num_nodes = forbidden.shape[0]

    def embed_full(shard):
        return axis.gather_rows(model.embed(shard.x, shard.node_mask))

    def train_step(pos_edges, edge_mask, shard, *, gumbel=None, negatives=None):
        model.train()
        halo.bind(shard)
        b = pos_edges.shape[1]
        # The no-grad train-mode embedding (BN statistics updated, dropout
        # on) feeds the miner, as in make_lp_steps.
        with torch.no_grad():
            emb = embed_full(shard)[:num_nodes]
            if negatives is None:
                negatives = mine_hard_negatives(
                    emb, forbidden, num_negatives=b, num_hard=num_hard,
                    generator=generator, gumbel=gumbel)
        neg_s, neg_r = train_step.last_negatives = negatives
        s = torch.cat([pos_edges[0], neg_s.to(pos_edges.dtype)])
        r = torch.cat([pos_edges[1], neg_r.to(pos_edges.dtype)])
        y = torch.cat([torch.ones(b, device=s.device), torch.zeros(b, device=s.device)])
        mask = torch.cat([edge_mask, edge_mask])

        z = head(embed_full(shard), s, r, return_logits=True)
        loss = masked_bce_with_logits_mean(z, y, mask)
        gnorm = _update(model, optimizer, labels, loss, axis)
        return (loss.detach(), *_lp_outputs(z.detach(), y), mask, gnorm)

    train_step.last_negatives = None

    @torch.no_grad()
    def eval_step(edges, y, edge_mask, shard):
        model.eval()
        halo.bind(shard)
        z = head(embed_full(shard), edges[0], edges[1], return_logits=True)
        loss = masked_bce_with_logits_mean(z, y, edge_mask)
        return (loss, *_lp_outputs(z, y))

    return train_step, eval_step

