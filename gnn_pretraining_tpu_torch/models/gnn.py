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
module's ``training`` flag. ``axis`` (a ``parallel.mesh.DataAxis``, the JAX
modules' ``axis_name``) reaches every BatchNorm, which then runs as SyncBN;
it adds no parameter or buffer. ``edge_axis`` (the JAX modules' field of
that name) makes the ``coo`` aggregation edge-partitioned over the axis's
ranks (``ops.spmm.gin_aggregate_coo``), and ``aggregate_fn(h, eps) -> z``
replaces the aggregation outright (the node-partitioned halo exchange,
``finetune/node_parallel.py``), leaving the MLP, BatchNorms and residual as
they are; neither adds a parameter or buffer. Every ReLU is an ``nn.ReLU``
module, so that ``utils.relu_branches`` can record and replay the side of
the kink each unit takes. Dropout never reads torch's global generator: every
``Dropout`` draws from the explicit generator of its ``DropoutSource`` (one
per model, on the model's device), or takes keep-masks injected there.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

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
from gnn_pretraining_tpu_torch.ops.spmm_csr import gin_aggregate_csr
from gnn_pretraining_tpu_torch.utils.device import resolve_device

H = config.GNN_HIDDEN_DIM


def init_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The caller's CPU generator for parameter init, else one seeded 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


class DropoutSource:
    """Where a model's dropout layers get their keep-masks.

    ``generator`` is an explicit ``torch.Generator`` on the device of the
    activations; ``seed(s)`` makes or reseeds it. ``inject(masks)`` queues
    keep-masks (1 = keep) that the next train-mode dropout calls take, in call
    order, before any is drawn: a parity test hands over another
    implementation's draws this way."""

    def __init__(self, device=None, seed: Optional[int] = None):
        self.device = torch.device(device) if device is not None else None
        self.generator: Optional[torch.Generator] = None
        self.injected: List[torch.Tensor] = []
        if seed is not None:
            self.seed(seed)

    def seed(self, seed: int) -> None:
        if self.generator is None:
            self.generator = torch.Generator(device=self.device or "cpu")
        self.generator.manual_seed(int(seed))

    def inject(self, masks: Sequence[torch.Tensor]) -> None:
        self.injected = list(masks)

    def keep_mask(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.injected:
            keep = self.injected.pop(0)
            if keep.shape != x.shape:
                raise ValueError(f"injected keep-mask {tuple(keep.shape)} does "
                                 f"not fit activations {tuple(x.shape)}")
            return keep.to(device=x.device, dtype=x.dtype)
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs a seeded generator: "
                               "call DropoutSource.seed() (the model's "
                               "seed_dropout) first")
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return (u >= rate).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout, ``x * keep / (1 - rate)``, identity in eval mode and
    at rate 0; ``keep`` comes from ``source`` (see ``DropoutSource``)."""

    def __init__(self, rate: float, source: Optional[DropoutSource] = None):
        super().__init__()
        self.rate = float(rate)
        self.source = source if source is not None else DropoutSource()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return x * self.source.keep_mask(x, self.rate) / (1.0 - self.rate)


def share_dropout_source(model: nn.Module, device, seed: int = 0) -> DropoutSource:
    """Give every ``Dropout`` under ``model`` one source seeded on ``device``."""
    source = DropoutSource(device, seed)
    for module in model.modules():
        if isinstance(module, Dropout):
            module.source = source
    return source


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
                 generator: Optional[torch.Generator] = None, device=None, axis=None):
        super().__init__()
        device = resolve_device(device)
        self.linear = TorchLinear(in_features, H, generator=generator, device=device)
        self.batch_norm = MaskedBatchNorm(H, device=device, axis=axis)
        self.relu = nn.ReLU()
        self.dropout = Dropout(config.DROPOUT_RATE)

    def forward(self, x: torch.Tensor, node_mask: torch.Tensor | None) -> torch.Tensor:
        h = self.batch_norm(self.linear(x), node_mask)
        return self.dropout(self.relu(h))


def _aggregate(h: torch.Tensor, eps: torch.Tensor, adj, senders, receivers,
               edge_mask, impl: str, bsr=None, edge_axis=None) -> torch.Tensor:
    if impl == "csr" or bsr is not None:
        if bsr is None:
            raise ValueError(
                "aggregation='csr' requires a prebuilt BlockCSR passed as bsr= "
                "(host-side, ops/spmm_csr.build_block_csr); the batch loaders "
                "only feed adj/COO operands")
        return gin_aggregate_csr(h, bsr, eps)
    # As in the JAX model, no adjacency means COO whatever ``impl`` says; the
    # serving functions always pass one.
    if impl == "coo" or adj is None:
        return gin_aggregate_coo(h, senders, receivers, edge_mask, eps, edge_axis)
    if impl == "pallas":
        return spmm(adj, h, eps)
    return gin_aggregate_dense(h, adj, eps)


class GINConv(nn.Module):
    """MLP((1+ε)·h_i + Σ_{j→i} h_j) with a learnable ε (PyG GINConv,
    train_eps=True, starting at 0); the MLP is 256 → 512 (+BN+ReLU) → 256."""

    def __init__(self, *, generator: Optional[torch.Generator] = None, device=None,
                 axis=None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        self.eps = nn.Parameter(torch.zeros(1, device=device))
        self.nn = nn.Sequential(
            TorchLinear(H, 2 * H, generator=gen, device=device),
            MaskedBatchNorm(2 * H, device=device, axis=axis),
            nn.ReLU(),
            TorchLinear(2 * H, H, generator=gen, device=device))

    def forward(self, h, node_mask, aggregation: str, *, adj=None, senders=None,
                receivers=None, edge_mask=None, bsr=None, edge_axis=None,
                aggregate_fn=None) -> torch.Tensor:
        if aggregate_fn is not None:
            z = aggregate_fn(h, self.eps)
        else:
            z = _aggregate(h, self.eps, adj, senders, receivers, edge_mask,
                           aggregation, bsr, edge_axis)
        z = self.nn[1](self.nn[0](z), node_mask)
        return self.nn[3](self.nn[2](z))


class GINLayer(nn.Module):
    """GINConv + residual + BN + ReLU + Dropout (reference: gnn.py:26-43)."""

    def __init__(self, aggregation: str = "dense", *,
                 generator: Optional[torch.Generator] = None, device=None, axis=None,
                 edge_axis=None, aggregate_fn: Optional[Callable] = None):
        super().__init__()
        device = resolve_device(device)
        self.aggregation = aggregation   # "dense" | "pallas" | "coo" | "csr"
        self.edge_axis = edge_axis       # edge-partitioned coo over its ranks
        self.aggregate_fn = aggregate_fn  # (h, eps) -> z, replaces the aggregation
        self.gin_conv = GINConv(generator=generator, device=device, axis=axis)
        self.batch_norm = MaskedBatchNorm(H, device=device, axis=axis)
        self.relu = nn.ReLU()
        self.dropout = Dropout(config.DROPOUT_RATE)

    def forward(self, h, node_mask, *, adj=None, senders=None, receivers=None,
                edge_mask=None, bsr=None) -> torch.Tensor:
        z = self.gin_conv(h, node_mask, self.aggregation, adj=adj,
                          senders=senders, receivers=receivers,
                          edge_mask=edge_mask, bsr=bsr, edge_axis=self.edge_axis,
                          aggregate_fn=self.aggregate_fn)
        z = self.batch_norm(z + h, node_mask)   # residual before the BN
        return self.dropout(self.relu(z))


class GINBackbone(nn.Module):
    """5 stacked GINLayers (reference: gnn.py:46-54)."""

    def __init__(self, aggregation: str = "dense", *,
                 generator: Optional[torch.Generator] = None, device=None, axis=None,
                 edge_axis=None, aggregate_fn: Optional[Callable] = None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        self.aggregate_fn = aggregate_fn
        self.layers = nn.ModuleList(
            GINLayer(aggregation, generator=gen, device=device, axis=axis,
                     edge_axis=edge_axis, aggregate_fn=aggregate_fn)
            for _ in range(config.GNN_NUM_LAYERS))

    def forward(self, h, node_mask, *, adj=None, senders=None, receivers=None,
                edge_mask=None, bsr=None) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h, node_mask, adj=adj, senders=senders,
                      receivers=receivers, edge_mask=edge_mask, bsr=bsr)
        return h
