"""Task-specific AdamW and torch-style gradient clipping.

Port of ``gnn_pretraining_tpu/pretrain/optimizers.py`` (reference
src/pretrain/optimizers.py:18-75): a parameter under ``heads_{task}`` gets
that task's learning rate (LP 5e-7, NFM/NC/GC/GP 1e-5, DA 5e-6); everything
else (encoders, mask token, backbone) the default group's (1e-5); weight decay
1e-5 everywhere; β = (0.9, 0.999), eps = 1e-8, decoupled decay scaled by lr,
as ``optax.adamw``.

Every parameter must be handed a gradient, zeros where no task reached it:
``torch.optim.AdamW`` skips a parameter whose ``grad`` is None, while optax
decays it and moves its moments toward zero.

On the card the AdamW is ``capturable``: its step counts live on the card
beside the moments and its bias corrections are computed there, so a train
step that holds ``optimizer.step()`` can be captured in a CUDA graph and
replayed (``pretrain.make_chunked_train_step``). On the CPU it is not.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from gnn_pretraining_tpu_torch import config


def label_for(top_key: str, active_tasks: Sequence[str]) -> str:
    for task in active_tasks:
        if top_key == f"heads_{task}" or top_key.startswith(f"heads_{task}_"):
            return task
    return "default"


def param_labels(model: torch.nn.Module, active_tasks: Sequence[str]) -> Dict[str, str]:
    """Parameter name -> optimizer label, by the name's top-level key."""
    return {name: label_for(name.split(".")[0], active_tasks)
            for name, _ in model.named_parameters()}


def create_task_specific_optimizer(model: torch.nn.Module,
                                   active_tasks: Sequence[str]):
    """(optimizer, labels, lrs): one AdamW parameter group per label that has
    a parameter (``default`` and each task's heads); ``capturable`` where the
    parameters are on the card."""
    labels = param_labels(model, active_tasks)
    lrs = {"default": config.DEFAULT_LR,
           **{t: config.TASK_SPECIFIC_LR[t] for t in active_tasks}}
    groups = []
    for label, lr in lrs.items():
        members = [p for name, p in model.named_parameters() if labels[name] == label]
        if members:
            groups.append({"params": members, "lr": lr, "name": label})
    on_card = next(model.parameters()).device.type == "cuda"
    optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=config.DEFAULT_WEIGHT_DECAY,
                                  capturable=on_card)
    return optimizer, labels, {g["name"]: g["lr"] for g in groups}


def clip_grads_torch(grads: List[torch.Tensor], max_norm: float = config.MAX_GRAD_NORM
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``clip_grad_norm_`` semantics: scale by max_norm/(norm + 1e-6) if that
    is below 1. Returns (clipped grads, pre-clip global norm)."""
    total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return list(torch._foreach_mul(grads, coef)), total
