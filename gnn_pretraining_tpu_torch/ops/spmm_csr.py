"""Block-CSR GIN aggregation for graphs past the dense limit: kernel K3.

Port of ``gnn_pretraining_tpu/ops/spmm_csr.py``. The adjacency
(A[dst, src] = edge multiplicity) is kept as its nonzero (bm × bk) tiles,
dense tile values plus tile coordinates sorted by tile row, and

    z = A @ h + (1 + eps) * h

is computed over those tiles only:

  * ``build_block_csr`` (numpy, once per graph, byte-equal to the JAX one)
    makes the tiles of A and of Aᵀ; every empty tile row gets a zero tile,
    and ``pad_to`` pads with zero tiles that repeat the last row;
  * ``csr_spmm_fwd`` / ``csr_spmm_bwd`` launch K3 (``csrc/spmm_csr.cu``) over
    the tiles of A (forward) or of Aᵀ (backward, ``dh = Aᵀ g + (1+eps) g``)
    and count their launches; ``csr_matvec_reference`` is their plain
    version (a batched product of the tiles with the slices of h they meet,
    then ``index_add_`` over tile rows), with the kernel's rounding per mode;
  * ``spmm_csr`` is one ``torch.autograd.Function``: K3 on CUDA tensors (or
    an error), the plain version on CPU tensors; d eps = Σ g ⊙ h.

``rcm_order`` (Reverse Cuthill–McKee, scipy) relabels a graph so that its
edges gather near the diagonal, which is what keeps the tile count small.
Not ported: the tile-sharded multi-device variant (``shard_block_csr``,
``csr_aggregate_sharded``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_pretraining_tpu_torch.ops import _build
from gnn_pretraining_tpu_torch.ops.spmm import MODES


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class BlockCSR:
    """Nonzero adjacency tiles, sorted by tile row; built once per graph.

    ``vals[t]`` is the dense (bm, bk) tile at tile coordinates (``rows[t]``,
    ``cols[t]``) of A; ``vals_t`` / ``rows_t`` / ``cols_t`` are the tiles of
    Aᵀ, which drive the backward. ``row_ptr[i]`` is the first tile of tile
    row i (``row_ptr[-1]`` the tile count), so a CUDA block finds its row's
    tiles itself; ``row_ptr_t`` likewise for Aᵀ."""

    vals: torch.Tensor       # [nnzb, bm, bk]
    rows: torch.Tensor       # [nnzb] i32, non-decreasing
    cols: torch.Tensor       # [nnzb] i32
    vals_t: torch.Tensor     # [nnzb_t, bk, bm]
    rows_t: torch.Tensor     # [nnzb_t] i32
    cols_t: torch.Tensor     # [nnzb_t] i32
    row_ptr: torch.Tensor    # [n_pad / bm + 1] i32
    row_ptr_t: torch.Tensor  # [n_pad / bk + 1] i32
    num_nodes: int
    bm: int
    bk: int

    @property
    def nnzb(self) -> int:
        return int(self.vals.shape[0])

    def to(self, device) -> "BlockCSR":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


def _build_one(dst: np.ndarray, src: np.ndarray, w: np.ndarray, n_pad: int,
               bm: int, bk: int, dtype):
    """Dense tiles of the (n_pad × n_pad) matrix with entries w at (dst, src),
    one tile per nonzero (bm × bk) grid cell plus a zero tile for every empty
    tile row (so every output row block is written)."""
    rb, cb = dst // bm, src // bk
    n_rows = n_pad // bm
    key = rb.astype(np.int64) * (n_pad // bk) + cb
    uniq, inv = np.unique(key, return_inverse=True)
    rows = (uniq // (n_pad // bk)).astype(np.int32)
    cols = (uniq % (n_pad // bk)).astype(np.int32)
    vals = np.zeros((len(uniq), bm, bk), np.float32)
    np.add.at(vals, (inv, dst % bm, src % bk), w)

    empty = np.setdiff1d(np.arange(n_rows, dtype=np.int32), rows)
    if len(empty):
        rows = np.concatenate([rows, empty])
        cols = np.concatenate([cols, np.zeros(len(empty), np.int32)])
        vals = np.concatenate(
            [vals, np.zeros((len(empty), bm, bk), np.float32)])
    order = np.argsort(rows, kind="stable")
    return vals[order].astype(dtype), rows[order], cols[order]


def _row_ptr(rows: np.ndarray, n_rows: int) -> np.ndarray:
    return np.searchsorted(rows, np.arange(n_rows + 1), side="left").astype(np.int32)


def build_block_csr(senders, receivers, edge_mask, num_nodes: int,
                    bm: int = 128, bk: int = 128, dtype=np.float32,
                    pad_to: int | None = None) -> BlockCSR:
    """Host-side (numpy) construction, once per graph; tensors on the CPU.

    ``pad_to`` fixes the tile count (pad tiles repeat the last row with zero
    values, so they add nothing)."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    w = np.asarray(edge_mask, np.float32)
    keep = w != 0
    src, dst, w = senders[keep], receivers[keep], w[keep]
    n_pad = _round_up(num_nodes, max(bm, bk))

    vals, rows, cols = _build_one(dst, src, w, n_pad, bm, bk, dtype)
    vals_t, rows_t, cols_t = _build_one(src, dst, w, n_pad, bk, bm, dtype)

    def pad(v, r, c):
        if pad_to is None or len(r) >= pad_to:
            return v, r, c
        extra = pad_to - len(r)
        return (np.concatenate([v, np.zeros((extra,) + v.shape[1:], v.dtype)]),
                np.concatenate([r, np.full(extra, r[-1], np.int32)]),
                np.concatenate([c, np.zeros(extra, np.int32)]))

    vals, rows, cols = pad(vals, rows, cols)
    vals_t, rows_t, cols_t = pad(vals_t, rows_t, cols_t)
    t = torch.from_numpy
    return BlockCSR(vals=t(vals), rows=t(rows), cols=t(cols), vals_t=t(vals_t),
                    rows_t=t(rows_t), cols_t=t(cols_t),
                    row_ptr=t(_row_ptr(rows, n_pad // bm)),
                    row_ptr_t=t(_row_ptr(rows_t, n_pad // bk)),
                    num_nodes=num_nodes, bm=bm, bk=bk)


def synthetic_banded_edges(n: int, e: int, band: int, rng: np.random.Generator):
    """Edge list with banded locality (as after an RCM reorder): receiver
    offsets are geometric with mean ≈ band/4 in either direction."""
    senders = rng.integers(0, n, e).astype(np.int32)
    delta = rng.geometric(4.0 / band, e) * rng.choice([-1, 1], e)
    receivers = np.clip(senders + delta, 0, n - 1).astype(np.int32)
    return senders, receivers


def rcm_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee permutation, ``perm[new_id] = old_id``: apply with
    ``inv = argsort(perm); senders2 = inv[senders]`` and permute the feature
    rows the same way. Host-side, once per graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = sp.csr_matrix((np.ones(len(senders), np.float32),
                       (np.asarray(senders), np.asarray(receivers))),
                      shape=(num_nodes, num_nodes))
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=False),
                      dtype=np.int64)


def csr_matvec_reference(vals: torch.Tensor, rows: torch.Tensor,
                         cols: torch.Tensor, h: torch.Tensor, eps, mode: str,
                         num_nodes: int) -> torch.Tensor:
    """The plain version of K3: ``A @ h + (1+eps) h`` over the tiles.

    Each tile is multiplied with the slice of h at its column, the products
    are summed per tile row with ``index_add_``. ``highest`` takes f32
    products; ``split`` rounds h to hi = bf16(h) and lo = bf16(h - hi) and
    sums T·hi + T·lo; ``bf16`` takes T·bf16(h); the last two round the tiles
    to bf16 (exact for edge multiplicities)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    n0, f = h.shape
    bm, bk = vals.shape[1:]
    n_pad = _round_up(num_nodes, max(bm, bk))
    hp = torch.zeros(n_pad, f, dtype=torch.float32, device=h.device)
    hp[:n0] = h
    blocks = hp.view(n_pad // bk, bk, f)
    tiles = vals.to(torch.float32)
    if mode == "highest":
        prod = torch.bmm(tiles, blocks[cols.long()])
    else:
        tiles = tiles.to(torch.bfloat16).to(torch.float32)
        hi = blocks.to(torch.bfloat16)
        prod = torch.bmm(tiles, hi.to(torch.float32)[cols.long()])
        if mode == "split":
            lo = (blocks - hi.to(torch.float32)).to(torch.bfloat16)
            prod = prod + torch.bmm(tiles, lo.to(torch.float32)[cols.long()])
    agg = torch.zeros(n_pad // bm, bm, f, dtype=torch.float32, device=h.device)
    agg.index_add_(0, rows.long(), prod)
    return agg.view(n_pad, f)[:n0] + (1.0 + eps) * h


def _launch(vals, row_ptr, cols, h, eps, mode: str, num_nodes: int) -> torch.Tensor:
    """Check the operands and launch K3 once over the given tiles."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if h.device.type != "cuda" or any(t.device != h.device
                                      for t in (vals, row_ptr, cols)):
        raise ValueError(f"K3 needs the tiles and h on one CUDA device, got "
                         f"{vals.device} and {h.device}")
    if h.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"K3 takes f32 h and tiles, got {h.dtype}, {vals.dtype}")
    if row_ptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError("K3 takes i32 row_ptr and cols")
    if vals.dim() != 3 or tuple(vals.shape[1:]) != (128, 128):
        raise ValueError(f"K3 takes 128 x 128 tiles, got {tuple(vals.shape)}")
    n, f = h.shape
    n_rows = row_ptr.shape[0] - 1
    if n > num_nodes or n_rows != _round_up(num_nodes, 128) // 128:
        raise ValueError(f"h {tuple(h.shape)} and {n_rows} tile rows do not "
                         f"match {num_nodes} nodes")
    if not all(t.is_contiguous() for t in (vals, row_ptr, cols, h)):
        raise ValueError("K3 takes contiguous operands")
    if not torch.is_tensor(eps):
        eps = torch.tensor([float(eps)], dtype=torch.float32, device=h.device)
    if eps.numel() != 1 or eps.dtype != torch.float32 or eps.device != h.device:
        raise ValueError(f"eps must be one f32 value on {h.device}")
    eps = eps.detach().reshape(1).contiguous()
    out = torch.empty_like(h)
    code = _build.library().csr_spmm(
        vals.data_ptr(), row_ptr.data_ptr(), cols.data_ptr(), h.data_ptr(),
        eps.data_ptr(), out.data_ptr(), n_rows, n, f, MODES[mode],
        h.device.index, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(code, "csr_spmm")
    return out


def csr_spmm_fwd(bsr: BlockCSR, h: torch.Tensor, eps,
                 mode: str = "split") -> torch.Tensor:
    """Launch K3 over the tiles of A: ``A @ h + (1+eps) h`` -> [N, F] f32.

    ``bsr`` and ``h`` ([N, F] f32, contiguous) on one card, ``eps`` a float
    or a 1-element f32 tensor there. Raises on anything else and when the
    kernel does not build or launch. Records no autograd graph."""
    out = _launch(bsr.vals, bsr.row_ptr, bsr.cols, h.detach(), eps, mode,
                  bsr.num_nodes)
    csr_spmm_fwd.launches += 1
    return out


csr_spmm_fwd.launches = 0


def csr_spmm_bwd(bsr: BlockCSR, g: torch.Tensor, eps,
                 mode: str = "split") -> torch.Tensor:
    """Launch K3 over the tiles of Aᵀ: ``Aᵀ @ g + (1+eps) g`` -> [N, F] f32,
    the gradient of ``csr_spmm_fwd`` with respect to h."""
    out = _launch(bsr.vals_t, bsr.row_ptr_t, bsr.cols_t, g.detach(), eps, mode,
                  bsr.num_nodes)
    csr_spmm_bwd.launches += 1
    return out


csr_spmm_bwd.launches = 0


def _on_cpu(bsr: BlockCSR, h: torch.Tensor) -> bool:
    return h.device.type == "cpu" and bsr.vals.device.type == "cpu"


class _SpmmCsr(torch.autograd.Function):
    """K3 forward and backward as one differentiable op (plain versions on
    CPU tensors). The tiles get no gradient."""

    @staticmethod
    def forward(ctx, h, eps, bsr, mode):
        ctx.bsr, ctx.mode = bsr, mode
        ctx.save_for_backward(h, eps)
        if _on_cpu(bsr, h):
            return csr_matvec_reference(bsr.vals, bsr.rows, bsr.cols, h, eps,
                                        mode, bsr.num_nodes)
        return csr_spmm_fwd(bsr, h, eps, mode)

    @staticmethod
    def backward(ctx, g):
        h, eps = ctx.saved_tensors
        bsr = ctx.bsr
        dh = deps = None
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            if _on_cpu(bsr, g):
                dh = csr_matvec_reference(bsr.vals_t, bsr.rows_t, bsr.cols_t, g,
                                          eps, ctx.mode, bsr.num_nodes)
            else:
                dh = csr_spmm_bwd(bsr, g, eps, ctx.mode)
        if ctx.needs_input_grad[1]:
            deps = (g * h).sum().to(eps.dtype).reshape(eps.shape)
        return dh, deps, None, None


def spmm_csr(bsr: BlockCSR, h: torch.Tensor, eps,
             mode: str = "split") -> torch.Tensor:
    """``A @ h + (1+eps) h`` over block-CSR tiles, differentiable in ``h``
    (``Aᵀ g + (1+eps) g`` over the transposed tiles) and ``eps``
    (``Σ g ⊙ h``): K3 for CUDA tensors, its plain version on the CPU."""
    if not torch.is_tensor(eps):
        eps = torch.tensor([float(eps)], dtype=torch.float32, device=h.device)
    return _SpmmCsr.apply(h, eps, bsr, mode)


def gin_aggregate_csr(h: torch.Tensor, bsr: BlockCSR, eps,
                      mode: str = "split") -> torch.Tensor:
    return spmm_csr(bsr, h, eps, mode)
