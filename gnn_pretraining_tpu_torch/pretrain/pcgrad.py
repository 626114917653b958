"""PCGrad gradient surgery with per-leaf projections.

Port of ``gnn_pretraining_tpu/pretrain/pcgrad.py`` (reference
src/pretrain/gradient_surgery.py:41-103), with its semantics:

  * the task order is shuffled every step: a permutation of the sorted
    task names, given as a tensor on the gradients' device (the train step
    reads it from its input buffer, where the host put the draw of the
    run's PCGrad generator, ``streams["pcgrad"]``), or drawn here from a
    CPU ``torch.Generator``;
  * task i's gradient is projected against the *original* gradient of every
    earlier task j in that order, per parameter tensor (leaf), only where
    ⟨g_i, g_j⟩ < 0 and both norms are nonzero;
  * the combined gradient of a leaf is the mean over the tasks that
    participate in it (``task_participates``: a task's heads, the mask token
    for node-feature masking, the encoders for every task but it, the
    backbone for all);
  * ``gradient_surgery/total_conflicts``, ``total_projections`` and
    ``conflict_ratio``.

Each task's leaves are laid end to end in one vector, every leaf padded with
zeros to a multiple of ``_BLOCK``, as the JAX package lays them out, and the
vector is viewed as [blocks, _BLOCK]: a per-leaf dot product is a row sum
over the blocks and one [leaves, blocks] 0/1 matrix product, so a step costs
a few kernels per task pair, not a few per leaf. Neither uses atomics, so
the result is the same bit for bit on every call with the same inputs, on
the card too: every rank of a data-parallel step combines its (all-reduced,
equal) gradients alike and the ranks' parameters stay equal. The layout
(``PCGradLayout``: block ids, the one-hot and the participation matrix)
depends only on the model and the task set; the train step builds it once,
so a step makes nothing from host lists and can be replayed from a CUDA
graph.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_BLOCK = 512   # every leaf is padded to a multiple of it


def task_participates(top_key: str, task: str) -> bool:
    """Whether a top-level parameter subtree receives gradients from ``task``."""
    if top_key.startswith("heads_"):
        return top_key == f"heads_{task}" or top_key.startswith(f"heads_{task}_")
    if top_key == "mask_token":
        return task == "node_feat_mask"
    if top_key.startswith("input_encoders"):
        return task != "node_feat_mask"  # NFM encodes without a gradient
    return True                          # gnn_backbone and anything shared


class PCGradLayout(NamedTuple):
    """What PCGrad needs besides the gradients, for one model and task set:
    each leaf's size and blocks, the block -> leaf ids [B], the [L, B]
    one-hot of them and the [K, L] participation of the sorted tasks."""
    sizes: List[int]
    blocks: List[int]
    blk_id: torch.Tensor
    onehot: torch.Tensor
    part: torch.Tensor


def pcgrad_layout(shapes: Sequence[torch.Size], top_keys: Sequence[str],
                  task_names: Sequence[str], device,
                  dtype: torch.dtype = torch.float32) -> PCGradLayout:
    """The layout of leaves of ``shapes`` (``top_keys[l]`` names leaf l's
    top-level key) for the tasks ``task_names``, built on the host and moved
    to ``device`` once."""
    names = sorted(task_names)
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    blocks = [-(-n // _BLOCK) for n in sizes]
    blk_id = torch.repeat_interleave(torch.arange(len(sizes)), torch.tensor(blocks))  # [B]
    onehot = (blk_id[None, :] == torch.arange(len(sizes))[:, None]).to(dtype)       # [L, B]
    part = torch.tensor([[float(task_participates(key, t)) for key in top_keys]
                         for t in names])                                            # [K, L]
    return PCGradLayout(sizes, blocks, blk_id.to(device), onehot.to(device),
                        part.to(device))


def apply_pcgrad(task_grads: Dict[str, List[torch.Tensor]], top_keys: Sequence[str],
                 *, generator: Optional[torch.Generator] = None,
                 perm=None, layout: Optional[PCGradLayout] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Combine per-task gradient lists (one tensor per leaf, zeros where the
    task does not reach it; ``top_keys[l]`` names leaf l's top-level key).
    ``perm`` is the shuffled order of the sorted task names (a sequence, or
    an integer tensor on the gradients' device); without it, it is drawn
    from ``generator`` (a CPU generator). ``layout`` (``pcgrad_layout``) is
    built here when not given. Returns (combined leaves, metrics)."""
    # The task list is sorted, as it is in the jitted JAX step (jit hands it
    # the gradient dict with sorted keys): ``perm`` permutes that list.
    names = sorted(task_grads)
    k = len(names)
    if k <= 1:
        return list(task_grads[names[0]]), {}
    first = task_grads[names[0]]
    device = first[0].device
    if layout is None:
        layout = pcgrad_layout([g.shape for g in first], top_keys, names, device,
                               first[0].dtype)
    sizes, blocks, blk_id, onehot, part = layout
    flat = torch.stack([torch.cat([F.pad(g.reshape(-1), (0, b * _BLOCK - n))
                                   for g, n, b in zip(task_grads[t], sizes, blocks)])
                        for t in names]).view(k, -1, _BLOCK)          # [K, B, T]

    if perm is None:
        perm = torch.randperm(k, generator=generator)
    if not (torch.is_tensor(perm) and perm.device == device):
        perm = torch.as_tensor(perm).to(device)
    perm = perm.long()
    g_orig = flat[perm]
    part_p = part[perm]

    def leaf_dot(a, b):
        return onehot @ (a * b).sum(1)

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
            modified[i] = gi - coef[blk_id][:, None] * gj
            conflicts = conflicts + conflict.sum()
            projections = projections + valid.sum()

    denom = torch.clamp(part_p.sum(0), min=1.0)                      # [L]
    acc = sum(modified[i] * part_p[i][blk_id][:, None] for i in range(k))
    combined = torch.split((acc / denom[blk_id][:, None]).reshape(-1),
                           [b * _BLOCK for b in blocks])
    leaves = [c[:n].view_as(g) for c, n, g in zip(combined, sizes, first)]
    metrics = {
        "gradient_surgery/total_conflicts": conflicts,
        "gradient_surgery/total_projections": projections,
        "gradient_surgery/conflict_ratio": conflicts / torch.clamp(projections, min=1.0),
    }
    return leaves, metrics
