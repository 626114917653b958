"""Static-shape random selection.

Port of ``gnn_pretraining_tpu/ops/sampling.py:22-61``: a per-group
"randperm[:k]" selection as a boolean mask over a padded row axis (node drop,
edge drop, node masking). The draws come from an explicit
``torch.Generator`` on the rows' device, or are given (``scores``), so that a
test can hand over another implementation's draws. Negative sampling for link
prediction (``batched_negative_sampling``) comes with that task.
"""

from __future__ import annotations

from typing import Optional

import torch


def masked_randperm_select(group_ids: torch.Tensor, row_mask: torch.Tensor,
                           num_select: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None,
                           scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Select ``num_select[g]`` uniformly random valid rows of each group.

    ``group_ids`` [R] ints in [0, G) (padding rows may carry any id but must
    have ``row_mask`` 0), ``row_mask`` [R], ``num_select`` [G]. ``scores`` [R]
    are the uniform draws in [0, 1); without them they are drawn from
    ``generator``. Returns the [R] bool selection (a subset of ``row_mask``)."""
    r = group_ids.shape[0]
    device = group_ids.device
    if scores is None:
        scores = torch.rand(r, generator=generator, device=device)
    valid = row_mask.bool()
    # Sort key (valid first, group ascending, score ascending), in f32 as in JAX.
    sort_key = torch.where(valid, group_ids.to(torch.float32) * 2.0 + scores,
                           torch.full((r,), 1e9, device=device))
    order = torch.argsort(sort_key, stable=True)
    inv = torch.empty(r, dtype=torch.long, device=device)
    inv[order] = torch.arange(r, device=device)

    num_groups = num_select.shape[0]
    gid = group_ids.long().clamp(0, num_groups - 1)
    counts = torch.zeros(num_groups, dtype=torch.long, device=device).index_add_(
        0, gid, valid.long())
    starts = torch.cumsum(counts, 0) - counts
    rank = inv - starts[gid]
    return (rank < num_select.long()[gid]) & valid
