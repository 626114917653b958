"""FinetuneGNN: single-domain encoder + backbone + task head.

Port of ``gnn_pretraining_tpu/models/finetune_model.py`` (reference
src/models/finetune_model.py:20-80). The transfer of pretrained weights into
it is ``utils.convert.load_pretrained_into_finetune``; the freeze rules of
fine-tuning (encoder frozen for ENZYMES, backbone frozen for linear_probe,
per-group learning rates) are ``finetune.finetune.create_finetune_optimizer``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.gnn import (
    GINBackbone,
    InputEncoder,
    init_generator,
    share_dropout_source,
)
from gnn_pretraining_tpu_torch.models.heads import MLPHead, MLPLinkPredictor
from gnn_pretraining_tpu_torch.ops.segment import segment_mean
from gnn_pretraining_tpu_torch.utils.device import resolve_device

H = config.GNN_HIDDEN_DIM


class FinetuneGNN(nn.Module):
    """``aggregation``: ``"pallas"`` is kernel K1 (its plain version on the
    CPU), ``"dense"`` one f32 matmul, ``"coo"`` gather + scatter-add,
    ``"csr"`` kernel K3 over the ``BlockCSR`` passed as ``bsr``.

    Train-mode dropout draws from ``self.dropout`` (a ``DropoutSource`` on
    the model's device, seeded 0 until ``seed_dropout``). ``axis`` (a
    ``parallel.mesh.DataAxis``) makes every BatchNorm a SyncBN;
    ``edge_axis`` and ``aggregate_fn`` reach every ``GINLayer``
    (``models/gnn.py``)."""

    def __init__(self, domain_name: str, aggregation: str = "pallas", *,
                 generator: Optional[torch.Generator] = None, device=None, axis=None,
                 edge_axis=None, aggregate_fn=None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        self.domain_name = domain_name
        self.aggregation = aggregation
        self.task_type = config.TASK_TYPES[domain_name]
        self.input_encoder = InputEncoder(config.DOMAIN_DIMENSIONS[domain_name],
                                          generator=gen, device=device, axis=axis)
        self.gnn_backbone = GINBackbone(aggregation, generator=gen, device=device,
                                        axis=axis, edge_axis=edge_axis,
                                        aggregate_fn=aggregate_fn)
        c = config.NUM_CLASSES[domain_name]
        if self.task_type == "graph_classification":
            self.classification_head = MLPHead((H, config.FINETUNE_HIDDEN_DIM, c),
                                               generator=gen, device=device)
        elif self.task_type == "node_classification":
            self.classification_head = MLPHead((H, c), generator=gen,
                                               device=device)  # no hidden layer
        else:
            self.classification_head = MLPLinkPredictor(generator=gen, device=device)
        self.dropout = share_dropout_source(self, device)

    def seed_dropout(self, seed: int) -> None:
        self.dropout.seed(seed)

    def embed(self, x, node_mask, *, adj=None, senders=None, receivers=None,
              edge_mask=None, bsr=None) -> torch.Tensor:
        """Encoder + backbone → [N, 256] node embeddings."""
        h0 = self.input_encoder(x, node_mask)
        return self.gnn_backbone(h0, node_mask, adj=adj, senders=senders,
                                 receivers=receivers, edge_mask=edge_mask,
                                 bsr=bsr)

    def forward(self, x, node_mask, *, adj=None, senders=None, receivers=None,
                edge_mask=None, bsr=None, node_graph=None,
                num_graphs: Optional[int] = None, score_senders=None,
                score_receivers=None, return_logits: bool = False) -> torch.Tensor:
        h = self.embed(x, node_mask, adj=adj, senders=senders,
                       receivers=receivers, edge_mask=edge_mask, bsr=bsr)
        if self.task_type == "graph_classification":
            graph_emb = segment_mean(h, node_graph, num_graphs, node_mask)
            return self.classification_head(graph_emb)
        if self.task_type == "node_classification":
            return self.classification_head(h)
        return self.classification_head(h, score_senders, score_receivers,
                                        return_logits)
