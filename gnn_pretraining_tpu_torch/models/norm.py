"""Masked BatchNorm with torch.nn.BatchNorm1d semantics on padded batches.

Port of ``gnn_pretraining_tpu/models/norm.py``. Statistics are computed over
the valid rows only, so they equal the reference's (same rows, same sums):

  * train: normalize with the biased batch variance (two-pass); update the
    running stats with momentum 0.1, using the *unbiased* variance;
  * eval: normalize with the running stats.

The output is multiplied by the mask, so padding rows stay 0. Parameter and
buffer names are BatchNorm1d's (``weight``, ``bias``, ``running_mean``,
``running_var``).

``axis`` (a ``parallel.mesh.DataAxis``) turns on SyncBN, the JAX module's
``axis_name``: the count n, Σx and Σ(x − mean)² each get one all-reduce over
the axis (differentiable), so a data-parallel step normalizes with the
statistics of the global batch, keeps the two-pass variance, and updates
the running statistics identically on every rank.
"""

from __future__ import annotations

import torch
from torch import nn

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.utils.device import resolve_device


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = config.BN_MOMENTUM,
                 eps: float = config.BN_EPS, *, device=None, axis=None):
        super().__init__()
        device = resolve_device(device)
        self.axis = axis
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        if self.training:
            if mask is not None:
                m = mask.to(x.dtype)[:, None]
                n = m.sum()
                sum_x = (x * m).sum(0)
            else:
                m = None
                # Filled on the card: no host value to copy (a CUDA graph
                # capture refuses a copy from pageable host memory).
                n = torch.full((), float(x.shape[0]), dtype=x.dtype, device=x.device)
                sum_x = x.sum(0)
            if self.axis is not None:
                n, sum_x = self.axis.psum(n), self.axis.psum(sum_x)
            n = torch.clamp(n, min=1.0)
            mean = sum_x / n
            dev = x - mean
            sq = dev * dev if m is None else dev * dev * m
            sum_sq = sq.sum(0)
            if self.axis is not None:
                sum_sq = self.axis.psum(sum_sq)
            var = sum_sq / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var

        y = (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        if mask is not None:
            y = y * mask.to(y.dtype)[:, None]
        return y
