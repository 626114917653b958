"""Pretraining task losses over dicts of per-domain padded batches.

Port of ``gnn_pretraining_tpu/pretrain/tasks.py`` (reference
src/pretrain/tasks.py:61-343) for the contrastive tasks. Each task computes,
for ``{domain: GraphBatch}``, ``(scalar_loss, {domain: loss})`` with the
reference's size-weighted aggregation: scalar = Σ per-domain loss sums /
Σ element counts. The model's BatchNorms update their running statistics in
place as the forwards run, in the JAX order: tasks outer (the caller), domains
inner, view 1 before view 2. The domains go in sorted order: the JAX step is
jitted, and jit hands its traced function the batch dict with sorted keys,
so that is the order of the JAX step's BatchNorm updates and random draws.

  * ``node_contrast``: two augmented views of each batch, the per-domain
    node projection head, NT-Xent over the nodes both views keep; a domain
    with fewer than 2 such nodes adds nothing;
  * ``graph_contrast``: [mean ; max] pooling of each view over the nodes it
    keeps, the per-domain graph projection head, NT-Xent over the graphs; a
    domain with fewer than 2 graphs adds nothing.

``_nt_xent`` takes the fused NT-Xent (kernel K2, ``ops/ntxent.py``) from
``config.FUSED_NTXENT_MIN_ROWS`` rows on, else the plain formula. Node-feature
masking, link prediction, graph properties and domain-adversarial are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphBatch
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.ops.ntxent import nt_xent
from gnn_pretraining_tpu_torch.ops.sddmm import nt_xent_loss
from gnn_pretraining_tpu_torch.ops.segment import segment_max, segment_mean
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.pretrain.augmentations import GraphView, ViewSource


class TaskContext(NamedTuple):
    """What a task reads besides the model and the batches; train or eval is
    the model's mode, which the caller sets."""
    temperature: torch.Tensor   # [1] f32 on the batches' device
    views: ViewSource           # the contrastive tasks' augmented views


def _nt_xent(z1, z2, temperature, valid):
    if config.FUSED_NTXENT and z1.shape[0] >= config.FUSED_NTXENT_MIN_ROWS:
        return nt_xent(z1, z2, temperature, valid)
    return nt_xent_loss(z1, z2, temperature, valid)


def _safe_div(a, b):
    return a / torch.clamp(b, min=1.0)


def _view_forward(model: PretrainableGNN, batch: GraphBatch, view: GraphView,
                  domain: str) -> torch.Tensor:
    """Encoder + backbone over the view's kept nodes and edges (the adjacency
    is built from the view's edge mask; bf16 and exact for K1)."""
    dtype = torch.bfloat16 if model.aggregation == "pallas" else torch.float32
    adj = build_dense_adjacency(batch.senders, batch.receivers, view.edge_keep,
                                batch.num_nodes, dtype=dtype)
    return model(view.x, view.node_keep, domain, adj=adj, senders=batch.senders,
                 receivers=batch.receivers, edge_mask=view.edge_keep)


def node_contrast_loss(model, domain_batches: Dict[str, GraphBatch], ctx: TaskContext):
    """Reference: tasks.py:130-213."""
    total_loss = total_size = 0.0
    per_domain = {}
    for domain, batch in sorted(domain_batches.items()):
        v1, v2, common = ctx.views.two_views(batch)
        h1 = _view_forward(model, batch, v1, domain)
        h2 = _view_forward(model, batch, v2, domain)
        z1 = model.head("node_contrast", domain, h1)
        z2 = model.head("node_contrast", domain, h2)
        loss_sum, rows = _nt_xent(z1, z2, ctx.temperature, common)
        valid = (common.sum() >= 2).to(torch.float32)     # (:173-175)
        loss_sum, rows = loss_sum * valid, rows * valid
        total_loss = total_loss + loss_sum
        total_size = total_size + rows
        per_domain[domain] = _safe_div(loss_sum, rows)
    return _safe_div(total_loss, total_size), per_domain


def _pool(h: torch.Tensor, batch: GraphBatch, view: GraphView) -> torch.Tensor:
    g = batch.num_graphs
    return torch.cat([segment_mean(h, batch.node_graph, g, view.node_keep),
                      segment_max(h, batch.node_graph, g, view.node_keep)], dim=1)


def graph_contrast_loss(model, domain_batches: Dict[str, GraphBatch], ctx: TaskContext):
    """Reference: tasks.py:216-287."""
    total_loss = total_size = 0.0
    per_domain = {}
    for domain, batch in sorted(domain_batches.items()):
        v1, v2, _ = ctx.views.two_views(batch)
        h1 = _view_forward(model, batch, v1, domain)
        h2 = _view_forward(model, batch, v2, domain)
        z1 = model.head("graph_contrast", domain, _pool(h1, batch, v1))
        z2 = model.head("graph_contrast", domain, _pool(h2, batch, v2))
        loss_sum, rows = _nt_xent(z1, z2, ctx.temperature, batch.graph_mask)
        valid = (batch.graph_mask.sum() >= 2).to(torch.float32)   # (:231-234)
        loss_sum, rows = loss_sum * valid, rows * valid
        total_loss = total_loss + loss_sum
        total_size = total_size + rows
        per_domain[domain] = _safe_div(loss_sum, rows)
    return _safe_div(total_loss, total_size), per_domain


TASK_FNS: Dict[str, Callable] = {
    "node_contrast": node_contrast_loss,
    "graph_contrast": graph_contrast_loss,
}


def compute_task_loss(task_name: str, model, domain_batches: Dict[str, GraphBatch],
                      ctx: TaskContext) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if task_name not in TASK_FNS:
        raise NotImplementedError(
            f"pretraining task {task_name!r} is not ported yet: ROADMAP queue 1")
    return TASK_FNS[task_name](model, domain_batches, ctx)
