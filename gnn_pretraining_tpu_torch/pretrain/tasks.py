"""The six pretraining task losses over dicts of per-domain padded batches.

Port of ``gnn_pretraining_tpu/pretrain/tasks.py`` (reference
src/pretrain/tasks.py:61-343). Each task computes, for ``{domain:
GraphBatch}``, ``(scalar_loss, {domain: loss})`` with the reference's
size-weighted aggregation: scalar = Σ per-domain loss sums / Σ element
counts. The model's BatchNorms update their running statistics in place as
the forwards run, in the JAX order: tasks outer (the caller), domains inner,
view 1 before view 2. The domains go in sorted order: the JAX step is jitted,
and jit hands its traced function the batch dict with sorted keys, so that is
the order of the JAX step's BatchNorm updates and random draws.

  * ``node_feat_mask``: the encoder without a gradient (its BatchNorm still
    updates in train mode), ``max(1, ⌊0.15·n⌋)`` nodes of each graph with at
    least 3 replaced by the mask token, the backbone, the per-domain head;
    squared error on the masked rows;
  * ``link_pred``: one negative pair per positive edge slot
    (``ops/sampling.batched_negative_sampling`` against (A + Aᵀ) > 0), the
    shared link predictor, BCE from logits;
  * ``node_contrast``: two augmented views of each batch, the per-domain
    node projection head, NT-Xent over the nodes both views keep; a domain
    with fewer than 2 such nodes adds nothing;
  * ``graph_contrast``: [mean ; max] pooling of each view over the nodes it
    keeps, the per-domain graph projection head, NT-Xent over the graphs; a
    domain with fewer than 2 graphs adds nothing;
  * ``graph_prop``: mean pooling, the per-domain head, squared error against
    the 12 standardized graph properties;
  * ``domain_adv``: mean pooling, the gradient reversal with λ and the
    shared domain classifier, cross-entropy against the domain's index in
    ``model.domain_names``.

``_nt_xent`` takes the fused NT-Xent (kernel K2, ``ops/ntxent.py``) from
``config.FUSED_NTXENT_MIN_ROWS`` rows on, else the plain formula. The random
choices come from the context: views from a ``ViewSource``, mask scores and
negative-sampling uniforms from a ``TaskDraws``; both draw from generators on
the batches' device or hand out draws injected by a test.

With a data axis in the context (``TaskContext.axis``, a
``parallel.mesh.DataAxis``, the JAX context's ``axis_name``) each rank holds
its share of every domain's graphs, and a task computes the loss of the
global batch on every rank: the additive tasks sum their per-domain loss
sums and sizes over the ranks (``_preduce``), and the contrastive tasks
gather their projections over the ranks and compute NT-Xent over all the
rows, through K2 as on one device (the JAX package takes its plain formula
under an axis); the model's BatchNorms are then SyncBNs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphBatch
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.ops.ntxent import nt_xent
from gnn_pretraining_tpu_torch.ops.sampling import (
    NegativeDraws,
    batched_negative_sampling,
    draw_negatives,
    masked_randperm_select,
)
from gnn_pretraining_tpu_torch.ops.sddmm import gather_pairs, nt_xent_loss
from gnn_pretraining_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_softmax_ce,
)
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.pretrain.augmentations import GraphView, ViewSource
from gnn_pretraining_tpu_torch.utils.losses import bce_with_logits

H = config.GNN_HIDDEN_DIM


class TaskDraws:
    """Where node-feature masking and link prediction get their uniforms.

    ``generator`` is an explicit ``torch.Generator`` on the batches' device;
    ``seed(s)`` makes or reseeds it. ``inject(mask_scores, negatives)``
    queues draws that the next calls return, in call order, before any is
    drawn: [N] node scores for ``mask_scores``, ``NegativeDraws`` for
    ``negatives``."""

    def __init__(self, device=None, seed: Optional[int] = None):
        self.device = torch.device(device) if device is not None else None
        self.generator: Optional[torch.Generator] = None
        self.injected_masks: List[torch.Tensor] = []
        self.injected_negatives: List[NegativeDraws] = []
        if seed is not None:
            self.seed(seed)

    def seed(self, seed: int) -> None:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device or "cpu")
        self.generator.manual_seed(int(seed))

    def inject(self, mask_scores=(), negatives=()) -> None:
        self.injected_masks = list(mask_scores)
        self.injected_negatives = list(negatives)

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError("masking and negative sampling need a seeded "
                               "generator: call TaskDraws.seed() first")
        return self.generator

    def mask_scores(self, batch: GraphBatch) -> torch.Tensor:
        if self.injected_masks:
            return self.injected_masks.pop(0)
        return torch.rand(batch.num_nodes, generator=self._generator(),
                          device=batch.x.device)

    def negatives(self, batch: GraphBatch) -> NegativeDraws:
        if self.injected_negatives:
            return self.injected_negatives.pop(0)
        return draw_negatives(batch.num_edges, self._generator(), batch.x.device)


class TaskContext(NamedTuple):
    """What a task reads besides the model and the batches; train or eval is
    the model's mode, which the caller sets."""
    temperature: torch.Tensor   # [1] f32 on the batches' device
    views: ViewSource           # the contrastive tasks' augmented views
    grl_lambda: torch.Tensor    # [1] f32: domain-adversarial gradient reversal
    draws: TaskDraws            # node-feature masks and negative pairs
    axis: Optional[object] = None   # a parallel.mesh.DataAxis: data parallelism


def _nt_xent(z1, z2, temperature, valid, axis):
    z1, z2, valid = gather_pairs(z1, z2, valid, axis)
    if config.FUSED_NTXENT and z1.shape[0] >= config.FUSED_NTXENT_MIN_ROWS:
        return nt_xent(z1, z2, temperature, valid)
    return nt_xent_loss(z1, z2, temperature, valid)


def _preduce(x, axis):
    """``x`` summed over the ranks of ``axis``; as given without one."""
    return axis.psum(x) if axis is not None else x


def _safe_div(a, b):
    return a / torch.clamp(b, min=1.0)


def _adjacency(model: PretrainableGNN, batch: GraphBatch, edge_mask) -> torch.Tensor:
    """The dense adjacency of the edges ``edge_mask`` keeps (bf16 and exact
    for K1)."""
    dtype = torch.bfloat16 if model.aggregation == "pallas" else torch.float32
    return build_dense_adjacency(batch.senders, batch.receivers, edge_mask,
                                 batch.num_nodes, dtype=dtype)


def _forward(model: PretrainableGNN, batch: GraphBatch, domain: str,
             adj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder + backbone over the whole batch."""
    if adj is None:
        adj = _adjacency(model, batch, batch.edge_mask)
    return model(batch.x, batch.node_mask, domain, adj=adj, senders=batch.senders,
                 receivers=batch.receivers, edge_mask=batch.edge_mask)


def _view_forward(model: PretrainableGNN, batch: GraphBatch, view: GraphView,
                  domain: str) -> torch.Tensor:
    """Encoder + backbone over the view's kept nodes and edges."""
    adj = _adjacency(model, batch, view.edge_keep)
    return model(view.x, view.node_keep, domain, adj=adj, senders=batch.senders,
                 receivers=batch.receivers, edge_mask=view.edge_keep)


def _over_domains(per_domain: Callable) -> Callable:
    """A task over ``{domain: batch}`` from its per-domain ``(loss_sum,
    size)``, with the size-weighted aggregation."""

    def task(model, domain_batches: Dict[str, GraphBatch], ctx: TaskContext):
        total_loss = total_size = 0.0
        losses = {}
        for domain, batch in sorted(domain_batches.items()):
            loss_sum, size = per_domain(model, domain, batch, ctx)
            total_loss = total_loss + loss_sum
            total_size = total_size + size
            losses[domain] = _safe_div(loss_sum, size)
        return _safe_div(total_loss, total_size), losses

    task.__doc__ = per_domain.__doc__
    return task


def _node_feat_mask(model, domain, batch, ctx):
    """Reference: tasks.py:70-94 + pretrain_model.py:67-88."""
    with torch.no_grad():                 # BN statistics still update (:68-69)
        h0 = model.encode(batch.x, batch.node_mask, domain)
    n = batch.n_node
    num_mask = torch.where(
        n >= config.NODE_FEATURE_MASKING_MIN_NUM_NODES,
        torch.clamp((n.to(torch.float32) * config.NODE_FEATURE_MASKING_MASK_RATE)
                    .to(torch.int32), min=1),
        torch.zeros_like(n))
    mask = masked_randperm_select(batch.node_graph, batch.node_mask, num_mask,
                                  scores=ctx.draws.mask_scores(batch))
    masked_h0 = torch.where(mask[:, None], model.mask_token[None, :], h0)
    h = model.run_backbone(masked_h0, batch.node_mask,
                           adj=_adjacency(model, batch, batch.edge_mask),
                           senders=batch.senders, receivers=batch.receivers,
                           edge_mask=batch.edge_mask)
    rec = model.head("node_feat_mask", domain, h)
    mask_f = mask.to(torch.float32)
    return (_preduce((((rec - h0) ** 2).sum(dim=1) * mask_f).sum(), ctx.axis),
            _preduce(mask_f.sum(), ctx.axis) * H)


def _link_pred(model, domain, batch, ctx):
    """Reference: tasks.py:97-127."""
    adj = _adjacency(model, batch, batch.edge_mask)
    # Nonnegative edge counts: the sum is > 0 exactly where either is, in bf16 too.
    undirected = (adj + adj.t()) > 0
    neg_s, neg_r = batched_negative_sampling(
        undirected, batch.edge_graph, batch.edge_mask, batch.node_start, batch.n_node,
        draws=ctx.draws.negatives(batch))
    h = _forward(model, batch, domain, adj)
    e = batch.num_edges
    senders = torch.cat([batch.senders.long(), neg_s])
    receivers = torch.cat([batch.receivers.long(), neg_r])
    labels = torch.cat([torch.ones(e, device=h.device), torch.zeros(e, device=h.device)])
    mask = torch.cat([batch.edge_mask, batch.edge_mask])
    z = model.heads_link_pred(h, senders, receivers, return_logits=True)
    return (_preduce((bce_with_logits(z, labels) * mask).sum(), ctx.axis),
            _preduce(mask.sum(), ctx.axis))


def _node_contrast(model, domain, batch, ctx):
    """Reference: tasks.py:130-213."""
    v1, v2, common = ctx.views.two_views(batch)
    h1 = _view_forward(model, batch, v1, domain)
    h2 = _view_forward(model, batch, v2, domain)
    z1 = model.head("node_contrast", domain, h1)
    z2 = model.head("node_contrast", domain, h2)
    loss_sum, rows = _nt_xent(z1, z2, ctx.temperature, common, ctx.axis)
    valid = (_preduce(common.sum(), ctx.axis) >= 2).to(torch.float32)     # (:173-175)
    return loss_sum * valid, rows * valid


def _pool(h: torch.Tensor, batch: GraphBatch, view: GraphView) -> torch.Tensor:
    g = batch.num_graphs
    return torch.cat([segment_mean(h, batch.node_graph, g, view.node_keep),
                      segment_max(h, batch.node_graph, g, view.node_keep)], dim=1)


def _graph_contrast(model, domain, batch, ctx):
    """Reference: tasks.py:216-287."""
    v1, v2, _ = ctx.views.two_views(batch)
    h1 = _view_forward(model, batch, v1, domain)
    h2 = _view_forward(model, batch, v2, domain)
    z1 = model.head("graph_contrast", domain, _pool(h1, batch, v1))
    z2 = model.head("graph_contrast", domain, _pool(h2, batch, v2))
    loss_sum, rows = _nt_xent(z1, z2, ctx.temperature, batch.graph_mask, ctx.axis)
    valid = (_preduce(batch.graph_mask.sum(), ctx.axis) >= 2).to(torch.float32)  # (:231-234)
    return loss_sum * valid, rows * valid


def _graph_prop(model, domain, batch, ctx):
    """Reference: tasks.py:290-312."""
    h = _forward(model, batch, domain)
    graph_emb = segment_mean(h, batch.node_graph, batch.num_graphs, batch.node_mask)
    preds = model.head("graph_prop", domain, graph_emb)
    sq = ((preds - batch.graph_properties) ** 2).sum(dim=1) * batch.graph_mask
    return (_preduce(sq.sum(), ctx.axis),
            _preduce(batch.graph_mask.sum(), ctx.axis) * config.GRAPH_PROPERTY_DIM)


def _domain_adv(model, domain, batch, ctx):
    """Reference: tasks.py:315-343. The label is the domain's index in
    ``model.domain_names`` (the scheme's domain tuple), never its position
    in the batch dict: an eval call passes one domain at a time."""
    h = _forward(model, batch, domain)
    graph_emb = segment_mean(h, batch.node_graph, batch.num_graphs, batch.node_mask)
    logits = model.heads_domain_adv(graph_emb, ctx.grl_lambda)
    labels = torch.full((batch.num_graphs,), model.domain_names.index(domain),
                        dtype=torch.long, device=h.device)
    loss_sum, _ = segment_softmax_ce(logits, labels, batch.graph_mask)
    return _preduce(loss_sum, ctx.axis), _preduce(batch.graph_mask.sum(), ctx.axis)


node_feat_mask_loss = _over_domains(_node_feat_mask)
link_pred_loss = _over_domains(_link_pred)
node_contrast_loss = _over_domains(_node_contrast)
graph_contrast_loss = _over_domains(_graph_contrast)
graph_prop_loss = _over_domains(_graph_prop)
domain_adv_loss = _over_domains(_domain_adv)

TASK_FNS: Dict[str, Callable] = {
    "node_feat_mask": node_feat_mask_loss,
    "link_pred": link_pred_loss,
    "node_contrast": node_contrast_loss,
    "graph_contrast": graph_contrast_loss,
    "graph_prop": graph_prop_loss,
    "domain_adv": domain_adv_loss,
}


def compute_task_loss(task_name: str, model, domain_batches: Dict[str, GraphBatch],
                      ctx: TaskContext) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return TASK_FNS[task_name](model, domain_batches, ctx)
