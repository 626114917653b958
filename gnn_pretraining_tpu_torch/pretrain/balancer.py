"""Adaptive loss balancer.

Port of ``gnn_pretraining_tpu/pretrain/balancer.py`` (reference
src/pretrain/adaptive_loss_balancer.py:14-53) and of its host mirror
``_np_balance`` (JAX ``pretrain/pretrain.py:371-384``):

  * one task: passthrough, the step count does not move;
  * the first 100 calls: equal weights 1/K;
  * after: w_i ∝ 1/(|L_i| + 1e-8) over the detached losses, summing to 1;
  * total = max(Σ w_i·L_i, 1e-6).

The train step's count is a device tensor (the reference increments it on
eval calls too, where the host mirror ``np_balance`` counts): the warm-up
switch is a ``torch.where`` on it, as the JAX balancer's ``jnp.where``, so
the choice needs no host value and a step replayed from a CUDA graph makes
it anew.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config


def balance_losses(task_losses: Dict[str, torch.Tensor], step_count
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (total_loss, weights, new_step_count). ``step_count`` is an
    integer tensor on the losses' device (or a host int); the new count is a
    tensor there, one more unless there is one task."""
    names = list(task_losses)
    if len(names) == 1:
        only = task_losses[names[0]]
        return only, {names[0]: torch.ones((), device=only.device)}, step_count
    losses = torch.stack([task_losses[n] for n in names])
    step_count = torch.as_tensor(step_count, device=losses.device) + 1
    inv = 1.0 / (losses.detach().abs() + config.BALANCER_EPSILON)
    adaptive = inv / inv.sum()
    equal = torch.full((len(names),), 1.0 / len(names), device=losses.device)
    w = torch.where(step_count > config.BALANCER_WARMUP_STEPS, adaptive, equal)
    total = torch.clamp((w * losses).sum(), min=config.BALANCER_MIN_TOTAL_LOSS)
    return total, {n: w[i] for i, n in enumerate(names)}, step_count


def np_balance(task_losses: Dict[str, float], step_count: int) -> Tuple[float, int]:
    """Host-side mirror of the balancer for eval totals (same semantics)."""
    names = list(task_losses)
    if len(names) == 1:
        return float(task_losses[names[0]]), step_count
    step_count += 1
    vals = np.array([task_losses[n] for n in names])
    if step_count > config.BALANCER_WARMUP_STEPS:
        inv = 1.0 / (np.abs(vals) + config.BALANCER_EPSILON)
        w = inv / inv.sum()
    else:
        w = np.full(len(names), 1.0 / len(names))
    return float(max((w * vals).sum(), config.BALANCER_MIN_TOTAL_LOSS)), step_count
