"""Prediction heads: the generic MLP head and the link predictor.

Port of ``gnn_pretraining_tpu/models/heads.py:37-78``. ``MLPHead.mlp`` is an
``nn.Sequential`` of Linear / ReLU / Dropout, so its Linear layers sit at
indices 0, 3, 6, ... as in the reference. The gradient-reversal layer and the
domain classifier come with the domain-adversarial pretraining task.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.gnn import Dropout, TorchLinear, init_generator
from gnn_pretraining_tpu_torch.utils.device import resolve_device


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
