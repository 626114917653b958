"""Sparse GIN aggregation for graphs past the dense limit: kernel K3.

Port of ``gnn_pretraining_tpu/ops/spmm_csr.py``. For the adjacency
A[dst, src] = edge multiplicity,

    z = A @ h + (1 + eps) * h

is computed over A's nonzeros:

  * ``build_block_csr`` (numpy, once per graph) makes two descriptions of A
    from the same masked edges: the nonzero (bm × bk) tiles of A and of Aᵀ,
    byte-equal to the JAX ones (the plain tile oracle, tile counts, the
    tile-sharded variant), and a CSR of A by destination row and of Aᵀ by
    source row (duplicate edges merged by summing), which K3 reads;
  * ``csr_spmm_fwd`` / ``csr_spmm_bwd`` launch K3 (``csrc/spmm_csr.cu``), a
    row-gather kernel, over the CSR of A (forward) or of Aᵀ (backward,
    ``dh = Aᵀ g + (1+eps) g``) and count their launches;
    ``csr_edges_reference`` is their plain version (a gather with the
    kernel's rounding per mode, then ``index_add_``) and
    ``csr_matvec_reference`` the same function over the tiles;
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
    """A graph's adjacency for K3, built once per graph on the host.

    The tiles: ``vals[t]`` is the dense (bm, bk) tile at tile coordinates
    (``rows[t]``, ``cols[t]``) of A, sorted by tile row; ``vals_t`` /
    ``rows_t`` / ``cols_t`` are the tiles of Aᵀ; ``row_ptr[i]`` is the first
    tile of tile row i (``row_ptr[-1]`` the tile count), ``row_ptr_t``
    likewise for Aᵀ. The edges: ``indptr`` / ``indices`` / ``data`` are A
    in CSR by destination row (``indices`` the sources, sorted within a row,
    ``data`` the summed multiplicities), ``indptr_t`` / ``indices_t`` /
    ``data_t`` Aᵀ by source row; these drive K3 and its plain version."""

    vals: torch.Tensor       # [nnzb, bm, bk]
    rows: torch.Tensor       # [nnzb] i32, non-decreasing
    cols: torch.Tensor       # [nnzb] i32
    vals_t: torch.Tensor     # [nnzb_t, bk, bm]
    rows_t: torch.Tensor     # [nnzb_t] i32
    cols_t: torch.Tensor     # [nnzb_t] i32
    row_ptr: torch.Tensor    # [n_pad / bm + 1] i32
    row_ptr_t: torch.Tensor  # [n_pad / bk + 1] i32
    indptr: torch.Tensor     # [num_nodes + 1] i32
    indices: torch.Tensor    # [nnz] i32
    data: torch.Tensor       # [nnz] f32
    indptr_t: torch.Tensor   # [num_nodes + 1] i32
    indices_t: torch.Tensor  # [nnz] i32
    data_t: torch.Tensor     # [nnz] f32
    num_nodes: int
    bm: int
    bk: int

    @property
    def nnzb(self) -> int:
        return int(self.vals.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def to(self, device) -> "BlockCSR":
        """Move what K3 reads (the two edge CSRs); the tiles stay where they
        are (on the host as built: ~1 GB at Cora ×6)."""
        return dataclasses.replace(self, **{name: getattr(self, name).to(device)
                                            for name in _EDGE_FIELDS})


_EDGE_FIELDS = ("indptr", "indices", "data", "indptr_t", "indices_t", "data_t")


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


def _edge_csr(dst: np.ndarray, src: np.ndarray, w: np.ndarray, n: int):
    """CSR of the (n × n) matrix with entries w at (dst, src): rows by dst,
    columns sorted within a row, duplicates summed in edge order (as
    ``np.add.at`` sums them into the tiles)."""
    key = dst.astype(np.int64) * n + src
    uniq, inv = np.unique(key, return_inverse=True)
    data = np.zeros(len(uniq), np.float32)
    np.add.at(data, inv.reshape(-1), w)
    indptr = np.searchsorted(uniq // n, np.arange(n + 1), side="left")
    return indptr.astype(np.int32), (uniq % n).astype(np.int32), data


def build_block_csr(senders, receivers, edge_mask, num_nodes: int,
                    bm: int = 128, bk: int = 128, dtype=np.float32,
                    pad_to: int | None = None) -> BlockCSR:
    """Host-side (numpy) construction, once per graph; tensors on the CPU.

    ``pad_to`` fixes the tile count (pad tiles repeat the last row with zero
    values, so they add nothing); the edge CSRs are the same either way."""
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
    indptr, indices, data = _edge_csr(dst, src, w, num_nodes)
    indptr_t, indices_t, data_t = _edge_csr(src, dst, w, num_nodes)
    t = torch.from_numpy
    return BlockCSR(vals=t(vals), rows=t(rows), cols=t(cols), vals_t=t(vals_t),
                    rows_t=t(rows_t), cols_t=t(cols_t),
                    row_ptr=t(_row_ptr(rows, n_pad // bm)),
                    row_ptr_t=t(_row_ptr(rows_t, n_pad // bk)),
                    indptr=t(indptr), indices=t(indices), data=t(data),
                    indptr_t=t(indptr_t), indices_t=t(indices_t), data_t=t(data_t),
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
    """``A @ h + (1+eps) h`` over the tiles: the tile oracle, with K3's
    rounding per mode (the TPU kernel's arithmetic).

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


def csr_edges_reference(indptr: torch.Tensor, indices: torch.Tensor,
                        data: torch.Tensor, h: torch.Tensor, eps,
                        mode: str) -> torch.Tensor:
    """The plain version of K3: ``A @ h + (1+eps) h`` over A's CSR.

    Gathers h at every nonzero's column, scales it by the nonzero with the
    kernel's rounding and sums per row with ``index_add_``. ``highest``
    takes f32 products; ``split`` rounds h to hi = bf16(h) and
    lo = bf16(h - hi) and sums a·hi + a·lo; ``bf16`` takes a·bf16(h); the
    last two round a to bf16 (exact for edge multiplicities)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    n = indptr.shape[0] - 1
    if h.shape[0] != n:
        raise ValueError(f"h {tuple(h.shape)} does not match {n} CSR rows")
    rows = torch.repeat_interleave(torch.arange(n, device=h.device),
                                   indptr.long().diff(), output_size=indices.shape[0])
    src = indices.long()
    a = data.to(torch.float32)[:, None]
    if mode == "highest":
        msgs = a * h[src]
    else:
        a = a.to(torch.bfloat16).to(torch.float32)
        hi = h.to(torch.bfloat16).to(torch.float32)
        msgs = a * hi[src]
        if mode == "split":
            lo = (h - hi).to(torch.bfloat16).to(torch.float32)
            msgs = msgs + a * lo[src]
    agg = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    agg.index_add_(0, rows, msgs)
    return agg + (1.0 + eps) * h


def _launch(indptr, indices, data, h, eps, mode: str) -> torch.Tensor:
    """Check the operands and launch K3 once over the given CSR."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if h.device.type != "cuda" or any(t.device != h.device
                                      for t in (indptr, indices, data)):
        raise ValueError(f"K3 needs the CSR and h on one CUDA device, got "
                         f"{indptr.device} and {h.device}")
    if h.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f"K3 takes f32 h and data, got {h.dtype}, {data.dtype}")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("K3 takes i32 indptr and indices")
    n, f = h.shape
    if indptr.shape[0] != n + 1 or indices.shape != data.shape:
        raise ValueError(f"h {tuple(h.shape)} does not match a CSR of "
                         f"{indptr.shape[0] - 1} rows")
    if not all(t.is_contiguous() for t in (indptr, indices, data, h)):
        raise ValueError("K3 takes contiguous operands")
    if not torch.is_tensor(eps):
        eps = torch.tensor([float(eps)], dtype=torch.float32, device=h.device)
    if eps.numel() != 1 or eps.dtype != torch.float32 or eps.device != h.device:
        raise ValueError(f"eps must be one f32 value on {h.device}")
    eps = eps.detach().reshape(1).contiguous()
    out = torch.empty_like(h)
    code = _build.library().csr_spmm(
        indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), h.data_ptr(),
        eps.data_ptr(), out.data_ptr(), n, f, MODES[mode], h.device.index,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(code, "csr_spmm")
    return out


def csr_spmm_fwd(bsr: BlockCSR, h: torch.Tensor, eps,
                 mode: str = "split") -> torch.Tensor:
    """Launch K3 over the CSR of A: ``A @ h + (1+eps) h`` -> [N, F] f32.

    ``bsr``'s edge CSRs and ``h`` ([N, F] f32, contiguous) on one card,
    ``eps`` a float or a 1-element f32 tensor there. Raises on anything else
    and when the kernel does not build or launch. Records no autograd graph."""
    out = _launch(bsr.indptr, bsr.indices, bsr.data, h.detach(), eps, mode)
    csr_spmm_fwd.launches += 1
    return out


csr_spmm_fwd.launches = 0


def csr_spmm_bwd(bsr: BlockCSR, g: torch.Tensor, eps,
                 mode: str = "split") -> torch.Tensor:
    """Launch K3 over the CSR of Aᵀ: ``Aᵀ @ g + (1+eps) g`` -> [N, F] f32,
    the gradient of ``csr_spmm_fwd`` with respect to h."""
    out = _launch(bsr.indptr_t, bsr.indices_t, bsr.data_t, g.detach(), eps, mode)
    csr_spmm_bwd.launches += 1
    return out


csr_spmm_bwd.launches = 0


def _on_cpu(bsr: BlockCSR, h: torch.Tensor) -> bool:
    return h.device.type == "cpu" and bsr.indptr.device.type == "cpu"


class _SpmmCsr(torch.autograd.Function):
    """K3 forward and backward as one differentiable op (the plain version
    on CPU tensors). The adjacency gets no gradient."""

    @staticmethod
    def forward(ctx, h, eps, bsr, mode):
        ctx.bsr, ctx.mode = bsr, mode
        ctx.save_for_backward(h, eps)
        if _on_cpu(bsr, h):
            return csr_edges_reference(bsr.indptr, bsr.indices, bsr.data, h, eps, mode)
        return csr_spmm_fwd(bsr, h, eps, mode)

    @staticmethod
    def backward(ctx, g):
        h, eps = ctx.saved_tensors
        bsr = ctx.bsr
        dh = deps = None
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            if _on_cpu(bsr, g):
                dh = csr_edges_reference(bsr.indptr_t, bsr.indices_t, bsr.data_t, g,
                                         eps, ctx.mode)
            else:
                dh = csr_spmm_bwd(bsr, g, eps, ctx.mode)
        if ctx.needs_input_grad[1]:
            deps = (g * h).sum().to(eps.dtype).reshape(eps.shape)
        return dh, deps, None, None


def spmm_csr(bsr: BlockCSR, h: torch.Tensor, eps,
             mode: str = "split") -> torch.Tensor:
    """``A @ h + (1+eps) h`` over A's nonzeros, differentiable in ``h``
    (``Aᵀ g + (1+eps) g`` over the CSR of Aᵀ) and ``eps``
    (``Σ g ⊙ h``): K3 for CUDA tensors, its plain version on the CPU."""
    if not torch.is_tensor(eps):
        eps = torch.tensor([float(eps)], dtype=torch.float32, device=h.device)
    return _SpmmCsr.apply(h, eps, bsr, mode)


def gin_aggregate_csr(h: torch.Tensor, bsr: BlockCSR, eps,
                      mode: str = "split") -> torch.Tensor:
    return spmm_csr(bsr, h, eps, mode)
