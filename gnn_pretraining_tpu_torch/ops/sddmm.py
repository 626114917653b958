"""Dense similarity ops and the NT-Xent contrastive loss as a plain formula.

Port of ``gnn_pretraining_tpu/ops/sddmm.py``. The similarity matrix is one
plain f32 matrix product (full f32 while
``torch.backends.cuda.matmul.allow_tf32`` is False). ``nt_xent_loss`` is the
single-device formula: it materializes the [2N, 2N] similarity matrix, and it
is the plain version of the whole function that kernel K2 computes without
it (``ops/ntxent.py``). The multi-device row gather of the JAX function
(``axis_name``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnn_pretraining_tpu_torch.ops.segment import segment_softmax_ce

_L2_NORM_EPS = 1e-12  # torch F.normalize default eps
_MASKED_LOGIT = -1e30


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


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature,
                 valid: torch.Tensor):
    """SimCLR NT-Xent over padded pair batches; returns (sum_loss, num_rows).

    Reference semantics on the valid rows (src/pretrain/tasks.py:192-213):
    rows = [z1; z2], similarity = normalized dot / τ with the diagonal and the
    invalid columns masked out, positives at offset N, cross-entropy summed
    over the 2N valid rows. ``valid`` is the shared row validity of z1/z2."""
    n = z1.shape[0]
    z = torch.cat([l2_normalize(z1), l2_normalize(z2)], dim=0)
    vv = torch.cat([valid, valid], dim=0).bool()
    sim = z @ z.t() / temperature
    diag = torch.eye(2 * n, dtype=torch.bool, device=z.device)
    sim = torch.where(diag | ~vv[None, :], torch.full_like(sim, _MASKED_LOGIT), sim)
    labels = torch.cat([torch.arange(n, 2 * n, device=z.device),
                        torch.arange(0, n, device=z.device)])
    return segment_softmax_ce(sim, labels, row_mask=vv)
