"""Numerically stable loss primitives shared by the training steps.

Port of ``gnn_pretraining_tpu/utils/losses.py``. The reference computes
link-prediction losses as BCE on sigmoid *probabilities*; its gradient
-y/p + (1-y)/(1-p) overflows f32 once the sigmoid saturates. The model keeps
its sigmoid-probability API for metrics, and every BCE *loss* is computed from
logits with the fused stable form, whose gradient is sigmoid(z) - y. Values
equal the reference's except where torch's -100 clamp of the log terms binds
(|z| > 100).
"""

from __future__ import annotations

import torch

_LOG_CLAMP = -100.0  # torch.binary_cross_entropy clamps log terms at -100


def bce_with_logits(z: torch.Tensor, y: torch.Tensor,
                    clamp: bool = True) -> torch.Tensor:
    """Elementwise stable BCE from logits: max(z,0) - z·y + log1p(e^-|z|).

    ``clamp=True`` (the LP paths) caps the per-element loss at 100, the value
    of torch's clamped BCE-on-probabilities wherever |z| ≤ 100.
    ``clamp=False`` is plain ``F.binary_cross_entropy_with_logits`` (the binary
    graph/node-classification loss), which torch does not clamp."""
    yf = y.to(torch.float32)
    zf = z.to(torch.float32)
    per = torch.clamp(zf, min=0.0) - zf * yf + torch.log1p(torch.exp(-zf.abs()))
    return torch.clamp(per, max=-_LOG_CLAMP) if clamp else per


def masked_bce_with_logits_mean(z: torch.Tensor, y: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Mask-weighted mean of ``bce_with_logits`` (sum / valid count)."""
    per = bce_with_logits(z, y)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
