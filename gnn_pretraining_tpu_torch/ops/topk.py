"""Exact top-k over long vectors.

Port of ``gnn_pretraining_tpu/ops/topk.py``: the JAX package splits the vector
into blocks because a flat top-k is slow on its device; that two-stage
structure is not carried over, only the result is. Values are exact; the order
of indices among exactly tied values is unspecified, as there.
"""

from __future__ import annotations

from typing import Tuple

import torch


def exact_top_k(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of a 1-D tensor,
    values descending."""
    return torch.topk(v, k)
