"""Dense similarity ops: row normalisation and the cosine-similarity matrix.

Port of ``gnn_pretraining_tpu/ops/sddmm.py:20-30``. The similarity matrix is
one plain f32 matrix product (full f32 while
``torch.backends.cuda.matmul.allow_tf32`` is False). ``nt_xent_loss`` belongs
to pretraining and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

_L2_NORM_EPS = 1e-12  # torch F.normalize default eps


def l2_normalize(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Row-normalize like ``F.normalize(z, dim=1)`` (eps=1e-12, clamped norm)."""
    norm = torch.linalg.vector_norm(z, dim=dim, keepdim=True)
    return z / torch.clamp(norm, min=_L2_NORM_EPS)


def cosine_similarity_matrix(a: torch.Tensor,
                             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cosine similarity a_i · b_j over L2-normalized rows."""
    a = l2_normalize(a)
    b = a if b is None else l2_normalize(b)
    return a @ b.t()
