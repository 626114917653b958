"""Dense similarity ops and the NT-Xent contrastive loss as a plain formula.

Port of ``gnn_pretraining_tpu/ops/sddmm.py``. The similarity matrix is one
plain f32 matrix product (full f32 while
``torch.backends.cuda.matmul.allow_tf32`` is False). ``nt_xent_loss`` is the
single-device formula: it materializes the [2N, 2N] similarity matrix, and it
is the plain version of the whole function that kernel K2 computes without
it (``ops/ntxent.py``). With ``axis`` (a ``parallel.mesh.DataAxis``, the JAX
function's ``axis_name``) the rows of every rank are gathered first, so that
each rank computes the loss over the global pair set.
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


def gather_pairs(z1: torch.Tensor, z2: torch.Tensor, valid: torch.Tensor, axis):
    """``z1``, ``z2`` and ``valid`` (as f32) of every rank of ``axis``, stacked
    rank-major (JAX sddmm.py:48-51); as given without an axis."""
    if axis is None:
        return z1, z2, valid
    return (axis.gather_rows(z1), axis.gather_rows(z2),
            axis.gather_rows(valid.to(torch.float32)))


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature,
                 valid: torch.Tensor, axis=None):
    """SimCLR NT-Xent over padded pair batches; returns (sum_loss, num_rows).

    Reference semantics on the valid rows (src/pretrain/tasks.py:192-213):
    rows = [z1; z2], similarity = normalized dot / τ with the diagonal and the
    invalid columns masked out, positives at offset N, cross-entropy summed
    over the 2N valid rows. ``valid`` is the shared row validity of z1/z2;
    with ``axis`` over the rows of every rank (``gather_pairs``)."""
    z1, z2, valid = gather_pairs(z1, z2, valid, axis)
    n = z1.shape[0]
    z = torch.cat([l2_normalize(z1), l2_normalize(z2)], dim=0)
    vv = torch.cat([valid, valid], dim=0).bool()
    sim = z @ z.t() / temperature
    diag = torch.eye(2 * n, dtype=torch.bool, device=z.device)
    sim = torch.where(diag | ~vv[None, :], torch.full_like(sim, _MASKED_LOGIT), sim)
    labels = torch.cat([torch.arange(n, 2 * n, device=z.device),
                        torch.arange(0, n, device=z.device)])
    return segment_softmax_ce(sim, labels, row_mask=vv)
