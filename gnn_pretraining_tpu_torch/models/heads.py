"""Prediction heads and the gradient-reversal layer.

Port of ``gnn_pretraining_tpu/models/heads.py``: the generic MLP head, the
link predictor, and the domain classifier behind a gradient reversal.
``MLPHead.mlp`` is an ``nn.Sequential`` of Linear / ReLU / Dropout, so its
Linear layers sit at indices 0, 3, 6, ... as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.gnn import Dropout, TorchLinear, init_generator
from gnn_pretraining_tpu_torch.utils.device import resolve_device


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.save_for_backward(lam)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (lam,) = ctx.saved_tensors
        return -lam * g, None


def grad_reverse(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Identity forward, ``-λ·g`` backward (JAX ``grad_reverse``, a
    ``custom_vjp``; reference heads.py:16-32). ``lam`` is a device tensor
    (shape [] or [1]), so the backward needs no host value."""
    return _GradReverse.apply(x, lam)


class MLPHead(nn.Module):
    """[dims...] MLP; ReLU+Dropout between hidden layers (ref heads.py:35-50)."""

    def __init__(self, dims: Sequence[int],
                 dropout_rates: Optional[Sequence[float]] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        gen = init_generator(generator)
        n = len(dims) - 1
        layers = []
        for i in range(n):
            layers.append(TorchLinear(dims[i], dims[i + 1], generator=gen,
                                      device=device))
            if i < n - 1:
                rate = (dropout_rates[i] if dropout_rates is not None
                        else config.DROPOUT_RATE)
                layers += [nn.ReLU(), Dropout(rate)]
        self.mlp = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class MLPLinkPredictor(nn.Module):
    """Edge scorer: [h_u+h_v ; h_u⊙h_v ; |h_u−h_v|] → MLP[768→256→1] → sigmoid
    (reference: heads.py:53-67). ``return_logits=True`` skips the sigmoid."""

    def __init__(self, *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        hd = config.GNN_HIDDEN_DIM
        self.predictor = MLPHead((3 * hd, hd, 1), generator=generator,
                                 device=device)

    def forward(self, h: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, return_logits: bool = False) -> torch.Tensor:
        h_src = h[senders.long()]
        h_dst = h[receivers.long()]
        feats = torch.cat([h_src + h_dst, h_src * h_dst, (h_src - h_dst).abs()], dim=1)
        logits = self.predictor(feats)[:, 0]
        return logits if return_logits else torch.sigmoid(logits)


class DomainClassifierHead(nn.Module):
    """GRL → MLP[256→128→4] with dropout 0.5 on its hidden layer (reference:
    heads.py:70-82)."""

    def __init__(self, num_domains: int = len(config.PRETRAIN_TUDATASETS), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.classifier = MLPHead(
            (config.GNN_HIDDEN_DIM, config.DOMAIN_CLASSIFIER_HIDDEN_DIM, num_domains),
            dropout_rates=(config.DOMAIN_CLASSIFIER_DROPOUT_RATE,),
            generator=generator, device=device)

    def forward(self, x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
        return self.classifier(grad_reverse(x, lam))
