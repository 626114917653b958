"""Masked segment reductions (PyG ``global_*_pool`` on padded batches).

Port of ``gnn_pretraining_tpu/ops/segment.py``. Padding rows carry
``mask == 0``; they contribute nothing to any segment.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets; masked rows contribute 0."""
    if mask is not None:
        data = data * mask.to(data.dtype)[..., None]
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    if mask is not None:
        ones = ones * mask.to(torch.float32)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-segment mean over valid rows (== torch_geometric global_mean_pool)."""
    sums = segment_sum(data, segment_ids, num_segments, mask)
    counts = segment_count(segment_ids, num_segments, mask)
    return sums / torch.clamp(counts, min=1.0)[..., None]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-segment max over valid rows (== global_max_pool). Empty segments -> 0."""
    if mask is not None:
        data = torch.where(mask.bool()[..., None], data,
                           torch.full_like(data, _NEG_INF))
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), _NEG_INF)
    index = segment_ids.long().view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    out = out.scatter_reduce(0, index, data, reduce="amax", include_self=True)
    return torch.where(out <= _NEG_INF / 2, torch.zeros_like(out), out)


def segment_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                       row_mask: torch.Tensor):
    """Row-wise softmax cross-entropy summed over the rows where ``row_mask``
    is set; returns ``(loss_sum, num_rows)``.

    Matches ``F.cross_entropy(logits, labels, reduction='sum')`` over those
    rows (reference: src/pretrain/tasks.py:211). Masked rows are set to 0
    first, so a row of masked logits cannot turn the sum into NaN; the row max
    is subtracted without a gradient, as in the JAX function."""
    mask = row_mask.bool()[:, None]
    logits = torch.where(mask, logits, torch.zeros_like(logits))
    row_max = logits.max(dim=-1, keepdim=True).values
    shifted = logits - row_max.detach()
    log_z = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = shifted.gather(-1, labels.long()[:, None])[:, 0]
    losses = (log_z - label_logit) * row_mask.to(logits.dtype)
    return losses.sum(), row_mask.to(torch.float32).sum()
