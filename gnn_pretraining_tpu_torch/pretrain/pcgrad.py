"""PCGrad gradient surgery with per-leaf projections.

Port of ``gnn_pretraining_tpu/pretrain/pcgrad.py`` (reference
src/pretrain/gradient_surgery.py:41-103), with its semantics:

  * the task order is shuffled every step (a permutation drawn from a
    ``torch.Generator``, or given);
  * task i's gradient is projected against the *original* gradient of every
    earlier task j in that order, per parameter tensor (leaf), only where
    ⟨g_i, g_j⟩ < 0 and both norms are nonzero;
  * the combined gradient of a leaf is the mean over the tasks that
    participate in it (``task_participates``: a task's heads, the mask token
    for node-feature masking, the encoders for every task but it, the
    backbone for all);
  * ``gradient_surgery/total_conflicts``, ``total_projections`` and
    ``conflict_ratio``.

Each task's leaves are laid end to end in one vector, and a per-leaf dot
product is one ``index_add_`` over the leaf ids, so a step costs a few
kernels per task pair, not a few per leaf. (The JAX package pads each leaf
to 512-wide blocks for the TPU; that layout is not needed here.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def task_participates(top_key: str, task: str) -> bool:
    """Whether a top-level parameter subtree receives gradients from ``task``."""
    if top_key.startswith("heads_"):
        return top_key == f"heads_{task}" or top_key.startswith(f"heads_{task}_")
    if top_key == "mask_token":
        return task == "node_feat_mask"
    if top_key.startswith("input_encoders"):
        return task != "node_feat_mask"  # NFM encodes without a gradient
    return True                          # gnn_backbone and anything shared


def apply_pcgrad(task_grads: Dict[str, List[torch.Tensor]], top_keys: Sequence[str],
                 *, generator: Optional[torch.Generator] = None,
                 perm: Optional[Sequence[int]] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Combine per-task gradient lists (one tensor per leaf, zeros where the
    task does not reach it; ``top_keys[l]`` names leaf l's top-level key).
    ``perm`` is the shuffled order of the sorted task names; without it, it
    is drawn from ``generator`` (a CPU generator). Returns (combined leaves,
    metrics)."""
    # The task list is sorted, as it is in the jitted JAX step (jit hands it
    # the gradient dict with sorted keys): ``perm`` permutes that list.
    names = sorted(task_grads)
    k = len(names)
    if k <= 1:
        return list(task_grads[names[0]]), {}
    first = task_grads[names[0]]
    device = first[0].device
    sizes = [g.numel() for g in first]
    leaf_id = torch.repeat_interleave(
        torch.arange(len(sizes)), torch.tensor(sizes)).to(device)
    part = torch.tensor([[float(task_participates(key, t)) for key in top_keys]
                         for t in names], device=device)              # [K, L]
    flat = torch.stack([torch.cat([g.reshape(-1) for g in task_grads[t]])
                        for t in names])                             # [K, P]

    if perm is None:
        perm = torch.randperm(k, generator=generator)
    perm = torch.as_tensor(perm, dtype=torch.long).to(device)
    g_orig = flat[perm]
    part_p = part[perm]

    def leaf_dot(a, b):
        return torch.zeros(len(sizes), device=device).index_add_(0, leaf_id, a * b)

    modified = [g_orig[i] for i in range(k)]
    conflicts = torch.zeros((), device=device)
    projections = torch.zeros((), device=device)
    for i in range(k):
        for j in range(i):
            gi, gj = modified[i], g_orig[j]
            dot, ni2, nj2 = leaf_dot(gi, gj), leaf_dot(gi, gi), leaf_dot(gj, gj)
            valid = (ni2 > 0) & (nj2 > 0)
            conflict = valid & (dot < 0)
            coef = torch.where(conflict, dot / torch.where(nj2 > 0, nj2, 1.0), 0.0)
            modified[i] = gi - coef[leaf_id] * gj
            conflicts = conflicts + conflict.sum()
            projections = projections + valid.sum()

    denom = torch.clamp(part_p.sum(0), min=1.0)                      # [L]
    acc = sum(modified[i] * part_p[i][leaf_id] for i in range(k))
    combined = acc / denom[leaf_id]
    leaves = [c.view_as(g) for c, g in zip(torch.split(combined, sizes), first)]
    metrics = {
        "gradient_surgery/total_conflicts": conflicts,
        "gradient_surgery/total_projections": projections,
        "gradient_surgery/conflict_ratio": conflicts / torch.clamp(projections, min=1.0),
    }
    return leaves, metrics
