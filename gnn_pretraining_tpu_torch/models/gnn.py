"""Shared GNN building blocks: InputEncoder, GINLayer, GINBackbone.

Port of ``gnn_pretraining_tpu/models/gnn.py`` on padded masked batches:

  * InputEncoder: Linear(d→256) → BatchNorm → ReLU → Dropout(0.2)
  * GINLayer: GINConv(MLP[256→512(+BN+ReLU)→256], train_eps) with residual,
    then BN → ReLU → Dropout(0.2).
  * GINBackbone: 5 stacked GINLayers, hidden 256.

Attribute names are the reference PyTorch model's (``gin_conv.nn.{0,1,3}``,
``gin_conv.eps``, ``layers.{i}``), so a ``state_dict`` has its keys.
Parameters are drawn from an explicit ``torch.Generator`` with
torch.nn.Linear's U(±1/√fan_in) rule for weight and bias. Train/eval is the
module's ``training`` flag.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.norm import MaskedBatchNorm
from gnn_pretraining_tpu_torch.ops.spmm import (
    gin_aggregate_coo,
    gin_aggregate_dense,
    spmm,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device

H = config.GNN_HIDDEN_DIM


def init_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The caller's CPU generator for parameter init, else one seeded 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


class TorchLinear(nn.Module):
    """``x @ weight.T + bias`` with both drawn from U(±1/√in_features)."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        bound = 1.0 / math.sqrt(in_features)
        weight = torch.empty(out_features, in_features).uniform_(
            -bound, bound, generator=gen)
        bias = torch.empty(out_features).uniform_(-bound, bound, generator=gen)
        self.weight = nn.Parameter(weight.to(device))
        self.bias = nn.Parameter(bias.to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class InputEncoder(nn.Module):
    """Per-domain projector (reference: src/models/gnn.py:11-23)."""

    def __init__(self, in_features: int, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.linear = TorchLinear(in_features, H, generator=generator, device=device)
        self.batch_norm = MaskedBatchNorm(H, device=device)
        self.dropout = nn.Dropout(config.DROPOUT_RATE)

    def forward(self, x: torch.Tensor, node_mask: torch.Tensor | None) -> torch.Tensor:
        h = self.batch_norm(self.linear(x), node_mask)
        return self.dropout(F.relu(h))


def _aggregate(h: torch.Tensor, eps: torch.Tensor, adj, senders, receivers,
               edge_mask, impl: str) -> torch.Tensor:
    if impl == "csr":
        raise NotImplementedError(
            "block-CSR aggregation (K3) is not ported yet: ROADMAP queue 2")
    # As in the JAX model, no adjacency means COO whatever ``impl`` says; the
    # serving functions always pass one.
    if impl == "coo" or adj is None:
        return gin_aggregate_coo(h, senders, receivers, edge_mask, eps)
    if impl == "pallas":
        return spmm(adj, h, eps)
    return gin_aggregate_dense(h, adj, eps)


class GINConv(nn.Module):
    """MLP((1+ε)·h_i + Σ_{j→i} h_j) with a learnable ε (PyG GINConv,
    train_eps=True, starting at 0); the MLP is 256 → 512 (+BN+ReLU) → 256."""

    def __init__(self, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        self.eps = nn.Parameter(torch.zeros(1, device=device))
        self.nn = nn.Sequential(
            TorchLinear(H, 2 * H, generator=gen, device=device),
            MaskedBatchNorm(2 * H, device=device),
            nn.ReLU(),
            TorchLinear(2 * H, H, generator=gen, device=device))

    def forward(self, h, node_mask, aggregation: str, *, adj=None, senders=None,
                receivers=None, edge_mask=None) -> torch.Tensor:
        z = _aggregate(h, self.eps, adj, senders, receivers, edge_mask, aggregation)
        z = self.nn[1](self.nn[0](z), node_mask)
        return self.nn[3](self.nn[2](z))


class GINLayer(nn.Module):
    """GINConv + residual + BN + ReLU + Dropout (reference: gnn.py:26-43)."""

    def __init__(self, aggregation: str = "dense", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.aggregation = aggregation   # "dense" | "pallas" | "coo"
        self.gin_conv = GINConv(generator=generator, device=device)
        self.batch_norm = MaskedBatchNorm(H, device=device)
        self.dropout = nn.Dropout(config.DROPOUT_RATE)

    def forward(self, h, node_mask, *, adj=None, senders=None, receivers=None,
                edge_mask=None) -> torch.Tensor:
        z = self.gin_conv(h, node_mask, self.aggregation, adj=adj,
                          senders=senders, receivers=receivers,
                          edge_mask=edge_mask)
        z = self.batch_norm(z + h, node_mask)   # residual before the BN
        return self.dropout(F.relu(z))


class GINBackbone(nn.Module):
    """5 stacked GINLayers (reference: gnn.py:46-54)."""

    def __init__(self, aggregation: str = "dense", *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        self.layers = nn.ModuleList(
            GINLayer(aggregation, generator=gen, device=device)
            for _ in range(config.GNN_NUM_LAYERS))

    def forward(self, h, node_mask, *, adj=None, senders=None, receivers=None,
                edge_mask=None) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h, node_mask, adj=adj, senders=senders,
                      receivers=receivers, edge_mask=edge_mask)
        return h
