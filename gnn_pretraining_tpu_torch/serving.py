"""Serving: eval-mode inference functions over a fine-tune model.

Port of ``gnn_pretraining_tpu/serving.py:41-108``. The functions take the same
positional inputs as the JAX ones (padded static-shape tensors) and return
the same outputs:

  * graph_classification: (x, node_mask, senders, receivers, edge_mask,
    node_graph) -> [num_graphs, C] logits
  * node_classification:  (x, node_mask, senders, receivers, edge_mask)
    -> [N, C] logits
  * link_prediction:      (x, node_mask, senders, receivers, edge_mask,
    score_senders, score_receivers) -> [S] probabilities
  * embedding:            (x, node_mask, senders, receivers, edge_mask)
    -> [N, 256] node embeddings

Each call builds the dense adjacency once (bf16 for kernel K1, as the JAX
fine-tune eval step builds it) and passes it to every GIN layer, so the
``pallas`` aggregation always runs on the kernel. The JAX package's
StableHLO export has no counterpart here yet (ROADMAP).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Tuple

import torch

from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.utils.checkpoint import load_transfer_artifact
from gnn_pretraining_tpu_torch.utils.convert import (
    load_pretrained_into_finetune,
    variables_to_state_dict,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device

GRAPH = ("x", "node_mask", "senders", "receivers", "edge_mask")


def _graph_kwargs(model: FinetuneGNN, x, senders, receivers, edge_mask) -> dict:
    kwargs = dict(senders=senders, receivers=receivers, edge_mask=edge_mask)
    if model.aggregation in ("pallas", "dense"):
        dtype = torch.bfloat16 if model.aggregation == "pallas" else torch.float32
        kwargs["adj"] = build_dense_adjacency(senders, receivers, edge_mask,
                                              x.shape[0], dtype=dtype)
    return kwargs


def make_serving_fn(model: FinetuneGNN) -> Tuple[Callable, Tuple[str, ...]]:
    """Eval-mode inference function over ``model``'s weights + its positional
    input names. For graph classification the first element is a factory
    ``make(num_graphs) -> fn`` (the padded graph count fixes an output shape),
    as in the JAX package."""
    model.eval()

    if model.task_type == "graph_classification":
        def make(num_graphs: int):
            @torch.inference_mode()
            def fn(x, node_mask, senders, receivers, edge_mask, node_graph):
                return model(x, node_mask, node_graph=node_graph,
                             num_graphs=num_graphs,
                             **_graph_kwargs(model, x, senders, receivers, edge_mask))
            return fn

        return make, GRAPH + ("node_graph",)

    if model.task_type == "node_classification":
        @torch.inference_mode()
        def fn(x, node_mask, senders, receivers, edge_mask):
            return model(x, node_mask,
                         **_graph_kwargs(model, x, senders, receivers, edge_mask))

        return fn, GRAPH

    @torch.inference_mode()
    def fn(x, node_mask, senders, receivers, edge_mask, score_senders,
           score_receivers):
        return model(x, node_mask, score_senders=score_senders,
                     score_receivers=score_receivers,
                     **_graph_kwargs(model, x, senders, receivers, edge_mask))

    return fn, GRAPH + ("score_senders", "score_receivers")


def make_embedding_fn(model: FinetuneGNN) -> Tuple[Callable, Tuple[str, ...]]:
    """Representation serving: encoder + backbone → [N, 256] embeddings."""
    model.eval()

    @torch.inference_mode()
    def fn(x, node_mask, senders, receivers, edge_mask):
        return model.embed(x, node_mask,
                           **_graph_kwargs(model, x, senders, receivers, edge_mask))

    return fn, GRAPH


def load_serving_model(domain: str, transfer_artifact, device=None,
                       seed: int = 0) -> FinetuneGNN:
    """A ``FinetuneGNN`` for ``domain`` in eval mode on ``device`` (the card
    unless ``device="cpu"``): encoder and head from a seeded init, then the
    backbone (and for ENZYMES the encoder) from a JAX transfer artifact
    (``artifacts/transfer/backbone_<scheme>_<seed>.msgpack``)."""
    device = resolve_device(device)
    model = FinetuneGNN(domain, "pallas",
                        generator=torch.Generator().manual_seed(seed),
                        device=device)
    art = load_transfer_artifact(Path(transfer_artifact))
    merged = load_pretrained_into_finetune(
        model.state_dict(), variables_to_state_dict(art), domain)
    model.load_state_dict(merged)
    return model.eval()
