"""PretrainableGNN: per-domain encoders + shared backbone + task heads.

Port of ``gnn_pretraining_tpu/models/pretrain_model.py`` (reference
src/models/pretrain_model.py:23-99). Heads, for the tasks the scheme has:
node-feature masking [256→256→256] per domain, the shared link predictor,
node contrast [256→256→128] per domain, graph contrast [512→256→128] per
domain, graph properties [256→512→12] per domain; plus the learnable mask
token (N(0, 0.1²)), the shared domain classifier behind a gradient
reversal. Attribute names give the reference's ``state_dict`` keys
(``input_encoders.MUTAG.linear.weight``, ``heads_node_contrast.MUTAG.mlp.0.
weight``, ``heads_link_pred.predictor.mlp.0.weight``, ...); ``utils.convert``
maps them to the JAX package's flax tree and back.

Node-feature masking (reference :67-88) lives in the task layer
(``pretrain/tasks.py``), which calls ``encode`` and ``run_backbone`` apart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.gnn import (
    GINBackbone,
    InputEncoder,
    init_generator,
    share_dropout_source,
)
from gnn_pretraining_tpu_torch.models.heads import (
    DomainClassifierHead,
    MLPHead,
    MLPLinkPredictor,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device

H = config.GNN_HIDDEN_DIM
P = config.CONTRASTIVE_PROJ_DIM

# Per-domain MLP heads by task: their layer widths.
HEAD_DIMS = {
    "node_feat_mask": (H, H, H),
    "node_contrast": (H, H, P),
    "graph_contrast": (2 * H, H, P),
    "graph_prop": (H, config.GRAPH_PROP_HIDDEN_DIM, config.GRAPH_PROPERTY_DIM),
}
# Heads shared by every domain.
SHARED_HEADS = {"link_pred": MLPLinkPredictor, "domain_adv": DomainClassifierHead}


class PretrainableGNN(nn.Module):
    """``aggregation`` as in ``FinetuneGNN`` (``"pallas"`` is K1). Train-mode
    dropout draws from ``self.dropout`` (a ``DropoutSource`` on the model's
    device, seeded 0 until ``seed_dropout``). ``axis`` (a
    ``parallel.mesh.DataAxis``) makes every BatchNorm a SyncBN."""

    def __init__(self, domain_names: Sequence[str], task_names: Sequence[str],
                 aggregation: str = "pallas", *,
                 generator: Optional[torch.Generator] = None, device=None, axis=None):
        super().__init__()
        unknown = set(task_names) - set(HEAD_DIMS) - set(SHARED_HEADS)
        if unknown:
            raise ValueError(f"unknown pretraining tasks {sorted(unknown)}")
        device = resolve_device(device)
        gen = init_generator(generator)
        self.domain_names = tuple(domain_names)
        self.task_names = tuple(task_names)
        self.aggregation = aggregation
        self.input_encoders = nn.ModuleDict({
            d: InputEncoder(config.DOMAIN_DIMENSIONS[d], generator=gen, device=device,
                            axis=axis)
            for d in self.domain_names})
        self.mask_token = nn.Parameter(
            (config.MASK_TOKEN_INIT_STD * torch.randn(H, generator=gen)).to(device))
        self.gnn_backbone = GINBackbone(aggregation, generator=gen, device=device,
                                        axis=axis)
        for task, dims in HEAD_DIMS.items():
            if task in self.task_names:
                setattr(self, f"heads_{task}", nn.ModuleDict({
                    d: MLPHead(dims, generator=gen, device=device)
                    for d in self.domain_names}))
        for task, head in SHARED_HEADS.items():
            if task in self.task_names:
                setattr(self, f"heads_{task}", head(generator=gen, device=device))
        self.dropout = share_dropout_source(self, device)

    def seed_dropout(self, seed: int) -> None:
        self.dropout.seed(seed)

    def encode(self, x, node_mask, domain: str) -> torch.Tensor:
        return self.input_encoders[domain](x, node_mask)

    def run_backbone(self, h0, node_mask, *, adj=None, senders=None,
                     receivers=None, edge_mask=None) -> torch.Tensor:
        return self.gnn_backbone(h0, node_mask, adj=adj, senders=senders,
                                 receivers=receivers, edge_mask=edge_mask)

    def forward(self, x, node_mask, domain: str, *, adj=None, senders=None,
                receivers=None, edge_mask=None) -> torch.Tensor:
        """Encoder of ``domain`` + backbone → [N, 256] node embeddings."""
        return self.run_backbone(self.encode(x, node_mask, domain), node_mask,
                                 adj=adj, senders=senders, receivers=receivers,
                                 edge_mask=edge_mask)

    def head(self, task: str, domain: str, z: torch.Tensor) -> torch.Tensor:
        """A per-domain head of ``HEAD_DIMS``."""
        return getattr(self, f"heads_{task}")[domain](z)
