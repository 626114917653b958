"""Fused NT-Xent: kernel K2 (``csrc/ntxent.cu``) and its plain versions.

Port of ``gnn_pretraining_tpu/ops/ntxent_pallas.py``. ``nt_xent`` computes
what ``ops.sddmm.nt_xent_loss`` computes, ``(loss_sum, num_rows)``, without a
[2N, 2N] similarity matrix in memory:

  * ``_prep`` stacks ``[z1; z2]``, row-normalizes it and zeroes invalid rows
    (Ẑ); the normalization and its VJP stay in PyTorch, as in JAX;
  * ``ntxent_fwd`` (K2 fwd) returns per row the loss, the max and the
    softmax denominator of the masked similarity row S = ẐẐᵀ/τ;
  * ``ntxent_bwd`` (K2 bwd) returns dẐ = G·Ẑ + Gᵀ·Ẑ in one pass over S, with
    G = (softmax(S) − onehot(positive))·g_row/τ recomputed from the saved
    max and denominator.

Each launch wrapper takes CUDA tensors only and counts its launches
(``ntxent_fwd.launches``, ``ntxent_bwd.launches``); each has a plain PyTorch
version (``*_reference``) that computes the same function through the full
matrix; ``ntxent_bwd_reference`` is the sum of the plain versions of the
TPU's two backward kernels, ``ntxent_bwd_rows_reference`` (G·Ẑ) and
``ntxent_bwd_cols_reference`` (Gᵀ·Ẑ). ``plan`` is the kernels' grid. ``nt_xent``
is one ``torch.autograd.Function``: on CUDA tensors it launches the kernels
(or raises), on CPU tensors it runs the plain versions. τ gets no gradient:
it comes from a schedule.
"""

from __future__ import annotations

import torch

from gnn_pretraining_tpu_torch.ops import _build

_MASKED = -1e30
_NORM_EPS = 1e-12
D_MAX = 128                    # the widest projection the kernels take


def _prep(z1: torch.Tensor, z2: torch.Tensor, valid: torch.Tensor):
    """(Ẑ, vv, norm): the stacked rows normalized, invalid rows zeroed (their
    columns are masked anyway), the doubled validity and the clamped norms."""
    z = torch.cat([z1, z2], dim=0).to(torch.float32)
    norm = torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True),
                       min=_NORM_EPS)
    vv = torch.cat([valid, valid]).to(torch.float32)
    zhat = (z / norm) * vv[:, None]
    return zhat.contiguous(), vv.contiguous(), norm


def _positives(rows: int, device) -> torch.Tensor:
    idx = torch.arange(rows, device=device)
    half = rows // 2
    return torch.where(idx < half, idx + half, idx - half)


def _masked_similarity(zhat, vv, temp) -> torch.Tensor:
    rows = zhat.shape[0]
    s = zhat @ zhat.t() / temp
    eye = torch.eye(rows, dtype=torch.bool, device=zhat.device)
    return torch.where(eye | ~(vv > 0)[None, :], torch.full_like(s, _MASKED), s)


def ntxent_fwd_reference(zhat, vv, temp):
    """The plain version of K2 fwd: (loss, mx, den) per row."""
    s = _masked_similarity(zhat, vv, temp)
    mx = s.max(dim=1).values
    den = torch.exp(s - mx[:, None]).sum(dim=1)
    pos = s.gather(1, _positives(s.shape[0], s.device)[:, None])[:, 0]
    return torch.log(den) + mx - pos, mx, den


def _grad_matrix(zhat, vv, temp, mx, den, g) -> torch.Tensor:
    s = _masked_similarity(zhat, vv, temp)
    p = torch.exp(s - mx[:, None]) / den[:, None]
    onehot = torch.zeros_like(p).scatter_(
        1, _positives(s.shape[0], s.device)[:, None], 1.0)
    return (p - onehot) * g[:, None] / temp


def ntxent_bwd_rows_reference(zhat, vv, temp, mx, den, g):
    """The plain version of K2 bwd-rows: G·Ẑ."""
    return _grad_matrix(zhat, vv, temp, mx, den, g) @ zhat


def ntxent_bwd_cols_reference(zhat, vv, temp, mx, den, g):
    """The plain version of K2 bwd-cols: Gᵀ·Ẑ."""
    return _grad_matrix(zhat, vv, temp, mx, den, g).t() @ zhat


def ntxent_bwd_reference(zhat, vv, temp, mx, den, g):
    """The plain version of K2 bwd: G·Ẑ + Gᵀ·Ẑ."""
    return (ntxent_bwd_rows_reference(zhat, vv, temp, mx, den, g)
            + ntxent_bwd_cols_reference(zhat, vv, temp, mx, den, g))


TILE = 32            # rows of a block's tile and columns of a column tile
BLOCKS_PER_SM = 2    # K2 blocks resident on one SM (100 KB of shared memory each)
MAX_CHUNKS = 32      # column chunks a launch may take


def plan(rows: int, sms: int):
    """K2's grid for R = ``rows`` on ``sms`` SMs: (row tiles, chunks, tiles
    per chunk). Block (i, c) takes row tile i against column tiles
    [c·per, (c+1)·per); the column axis is split into the fewest chunks that
    give about one wave of ``BLOCKS_PER_SM`` blocks per SM, none empty."""
    tiles = -(-rows // TILE)
    chunks = min(tiles, MAX_CHUNKS, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
    per = -(-tiles // chunks)
    return tiles, -(-tiles // per), per


_SMS = {}


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _check(zhat: torch.Tensor, *vectors: torch.Tensor) -> None:
    if zhat.device.type != "cuda":
        raise ValueError(f"K2 takes CUDA tensors, got {zhat.device}")
    if zhat.dim() != 2 or not 1 <= zhat.shape[1] <= D_MAX:
        raise ValueError(f"K2 takes Ẑ [R, d] with d <= {D_MAX}, got {tuple(zhat.shape)}")
    rows = zhat.shape[0]
    for v in (zhat, *vectors):
        if v.dtype != torch.float32 or v.device != zhat.device or not v.is_contiguous():
            raise ValueError("K2 takes contiguous f32 operands on one card")
    if any(v.shape != (rows,) for v in vectors[1:]) or vectors[0].numel() != 1:
        raise ValueError(f"K2 takes τ [1] and row vectors [{rows}]")


def _launch(entry: str, zhat, vv, temp, vectors, outs, part_per_chunk: int) -> None:
    """One K2 call: the scratch the C entry asks for in one allocation (the
    hi/lo split of Ẑ, each row's coefficients, and with more than one chunk
    the chunks' partials and a counter per row tile), then the launch."""
    rows, d = zhat.shape
    tiles, chunks, per = plan(rows, _sm_count(zhat.device))
    split = chunks > 1
    sizes = (2 * rows * D_MAX, 4 * rows, chunks * part_per_chunk if split else 0,
             tiles if split else 0)
    ws = torch.empty(sum(sizes), device=zhat.device)
    offsets = [0]
    for size in sizes[:-1]:
        offsets.append(offsets[-1] + size)
    zs, aux, part, count = (ws.data_ptr() + 4 * o if n else None
                            for o, n in zip(offsets, sizes))
    code = getattr(_build.library(), entry)(
        zhat.data_ptr(), vv.data_ptr(), temp.data_ptr(),
        *(v.data_ptr() for v in vectors), *(o.data_ptr() for o in outs),
        zs, aux, part, count, rows, d, chunks, per, *_stream(zhat))
    _build.check(code, entry)


def _stream(t: torch.Tensor):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def ntxent_fwd(zhat: torch.Tensor, vv: torch.Tensor, temp: torch.Tensor):
    """Launch K2 fwd: per-row (loss, mx, den) [R] f32 of Ẑ [R, d] f32,
    validity ``vv`` [R] f32 and τ ``temp`` [1] f32, all on one card."""
    _check(zhat, temp, vv)
    rows = zhat.shape[0]
    outs = tuple(torch.empty(rows, device=zhat.device) for _ in range(3))
    _launch("ntxent_fwd", zhat, vv, temp, (), outs, 3 * rows)
    ntxent_fwd.launches += 1
    return outs


ntxent_fwd.launches = 0


def ntxent_bwd(zhat, vv, temp, mx, den, g) -> torch.Tensor:
    """Launch K2 bwd: dẐ = G·Ẑ + Gᵀ·Ẑ [R, d] f32 (operands as ``ntxent_fwd``
    plus the saved ``mx``, ``den`` and the per-row upstream gradient ``g`` [R])."""
    _check(zhat, temp, vv, mx, den, g)
    out = torch.empty_like(zhat)
    _launch("ntxent_bwd", zhat, vv, temp, (mx, den, g), (out,), zhat.numel())
    ntxent_bwd.launches += 1
    return out


ntxent_bwd.launches = 0


class _NtXent(torch.autograd.Function):
    """K2 forward and backward as one differentiable op (the JAX
    ``nt_xent_pallas`` custom VJP): CUDA tensors launch the kernels, CPU
    tensors take the plain versions."""

    @staticmethod
    def forward(ctx, z1, z2, temperature, valid):
        zhat, vv, norm = _prep(z1, z2, valid)
        temp = temperature.detach().to(torch.float32).reshape(1).contiguous()
        fwd = ntxent_fwd_reference if zhat.device.type == "cpu" else ntxent_fwd
        loss, mx, den = fwd(zhat, vv, temp)
        ctx.save_for_backward(zhat, vv, norm, mx, den, temp)
        ctx.dtypes = (z1.dtype, z2.dtype)
        rows = vv.sum()
        ctx.mark_non_differentiable(rows)
        return (loss * vv).sum(), rows

    @staticmethod
    def backward(ctx, g_sum, _g_rows):
        zhat, vv, norm, mx, den, temp = ctx.saved_tensors
        g_rows = (vv * g_sum).contiguous()
        bwd = ntxent_bwd_reference if zhat.device.type == "cpu" else ntxent_bwd
        dzhat = bwd(zhat, vv, temp, mx, den, g_rows)
        # VJP of ẑ = z/|z|: Ẑ stands in for z/|z| on every valid row, and the
        # invalid rows are masked below.
        dz = (dzhat - zhat * (dzhat * zhat).sum(dim=1, keepdim=True)) / norm
        dz = dz * vv[:, None]
        n = zhat.shape[0] // 2
        return dz[:n].to(ctx.dtypes[0]), dz[n:].to(ctx.dtypes[1]), None, None


def nt_xent(z1: torch.Tensor, z2: torch.Tensor, temperature,
            valid: torch.Tensor):
    """Fused NT-Xent of the pair rows ``z1``/``z2`` [N, d] with row validity
    ``valid`` [N]; returns ``(loss_sum, num_rows)`` like
    ``ops.sddmm.nt_xent_loss``, differentiable in ``z1`` and ``z2``."""
    if not torch.is_tensor(temperature):
        temperature = torch.full((1,), float(temperature), device=z1.device)
    return _NtXent.apply(z1, z2, temperature, valid)
