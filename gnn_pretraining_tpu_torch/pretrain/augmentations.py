"""Graph augmentations as masks on fixed shapes.

Port of ``gnn_pretraining_tpu/pretrain/augmentations.py:39-96`` (reference
src/pretrain/augmentations.py:17-111). A view is the padded batch plus masks:

  * node drop: always, ``max(1, ⌊0.2·n⌋)`` nodes of each graph with at least 3;
  * edge drop: gated per graph (p = 0.2), ``max(1, ⌊0.2·e⌋)`` of the e edges
    that survive node drop, for graphs with at least 3 of them;
  * attribute mask: gated per graph (p = 0.2), ``max(1, ⌊0.2·D⌋)`` feature
    columns zeroed, for at least 3 features.

A node is a contrastive pair iff both views keep it (same row slot). The
uniform draws come from a ``torch.Generator`` on the batch's device, or are
given as a ``Draws``; ``ViewSource`` hands the tasks their views and takes
views injected by a test, as ``models.gnn.DropoutSource`` does for dropout.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphBatch
from gnn_pretraining_tpu_torch.ops.sampling import masked_randperm_select
from gnn_pretraining_tpu_torch.ops.segment import segment_sum


class GraphView(NamedTuple):
    x: torch.Tensor          # [N, D] (attribute-masked) features
    node_keep: torch.Tensor  # [N] f32: valid and kept by node drop
    edge_keep: torch.Tensor  # [E] f32: valid, both ends kept, not edge-dropped


class Draws(NamedTuple):
    """The uniform draws of one view, in [0, 1)."""
    node: torch.Tensor       # [N] node-drop scores
    edge_gate: torch.Tensor  # [G]
    edge_drop: torch.Tensor  # [E] edge-drop scores
    attr_gate: torch.Tensor  # [G]
    attr_cols: torch.Tensor  # [G, D] column scores


def draw(batch: GraphBatch, generator: Optional[torch.Generator]) -> Draws:
    n, e, g, d = batch.num_nodes, batch.num_edges, batch.num_graphs, batch.x.shape[1]
    u = lambda *shape: torch.rand(shape, generator=generator,  # noqa: E731
                                  device=batch.x.device)
    return Draws(u(n), u(g), u(e), u(g), u(g, d))


def augment_view(batch: GraphBatch, generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None) -> GraphView:
    """One augmented view (reference _create_augmented_view, :63-74)."""
    if draws is None:
        draws = draw(batch, generator)
    g = batch.num_graphs
    node_valid = batch.node_mask.bool()
    edge_valid = batch.edge_mask.bool()

    # node drop (always; :44-60)
    n_node = batch.n_node
    num_drop = torch.where(
        n_node >= config.NODE_DROP_MIN_NUM_NODES,
        torch.clamp((n_node.to(torch.float32) * config.NODE_DROP_RATE).to(torch.int32),
                    min=1),
        torch.zeros_like(n_node))
    dropped = masked_randperm_select(batch.node_graph, batch.node_mask, num_drop,
                                     scores=draws.node)
    node_keep = node_valid & ~dropped
    edge_keep = (edge_valid & node_keep[batch.senders.long()]
                 & node_keep[batch.receivers.long()])

    # edge drop (gated per graph; :30-41, 68-69)
    gate_e = draws.edge_gate < config.EDGE_DROP_PROB
    e_count = segment_sum(edge_keep.to(torch.float32), batch.edge_graph, g).to(torch.int32)
    num_edrop = torch.where(
        gate_e & (e_count >= config.EDGE_DROP_MIN_NUM_EDGES),
        torch.clamp((e_count.to(torch.float32) * config.EDGE_DROP_RATE).to(torch.int32),
                    min=1),
        torch.zeros_like(e_count))
    edropped = masked_randperm_select(batch.edge_graph, edge_keep.to(torch.float32),
                                      num_edrop, scores=draws.edge_drop)
    edge_keep = edge_keep & ~edropped

    # attribute mask (gated per graph; :17-27, 71-72)
    x = batch.x
    d = x.shape[1]
    if d >= config.ATTR_MASK_MIN_NUM_FEATURES:
        num_cols = max(1, int(d * config.ATTR_MASK_RATE))
        gate_a = draws.attr_gate < config.ATTR_MASK_PROB
        # the num_cols smallest scores of each graph are its masked columns
        kth = torch.sort(draws.attr_cols, dim=1).values[:, num_cols - 1][:, None]
        col_masked = (draws.attr_cols <= kth) & gate_a[:, None]
        x = x * (1.0 - col_masked[batch.node_graph.long()].to(x.dtype))

    return GraphView(x=x, node_keep=node_keep.to(torch.float32),
                     edge_keep=edge_keep.to(torch.float32))


def create_two_views(batch: GraphBatch, generator: Optional[torch.Generator] = None,
                     draws: Optional[Tuple[Draws, Draws]] = None
                     ) -> Tuple[GraphView, GraphView, torch.Tensor]:
    """Two independent views and the common-node pair mask (reference :88-111)."""
    v1 = augment_view(batch, generator, draws[0] if draws else None)
    v2 = augment_view(batch, generator, draws[1] if draws else None)
    return v1, v2, v1.node_keep * v2.node_keep


class ViewSource:
    """Where the contrastive tasks get their two views of a batch.

    ``generator`` is an explicit ``torch.Generator`` on the batches' device;
    ``seed(s)`` makes or reseeds it. ``inject(views)`` queues
    ``(v1, v2, common)`` triples that the next ``two_views`` calls return, in
    call order, before any is drawn."""

    def __init__(self, device=None, seed: Optional[int] = None):
        self.device = torch.device(device) if device is not None else None
        self.generator: Optional[torch.Generator] = None
        self.injected: List[Tuple[GraphView, GraphView, torch.Tensor]] = []
        if seed is not None:
            self.seed(seed)

    def seed(self, seed: int) -> None:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device or "cpu")
        self.generator.manual_seed(int(seed))

    def inject(self, views) -> None:
        self.injected = list(views)

    def two_views(self, batch: GraphBatch):
        if self.injected:
            return self.injected.pop(0)
        if self.generator is None:
            raise RuntimeError("augmentations need a seeded generator: call "
                               "ViewSource.seed() first")
        return create_two_views(batch, self.generator)
