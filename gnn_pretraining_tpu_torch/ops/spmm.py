"""GIN neighbourhood aggregation: ``z = A @ h + (1 + eps) * h``.

Port of ``gnn_pretraining_tpu/ops/spmm.py``. The paths:

  * ``gin_aggregate_coo``   -- gather + ``index_add_`` over the COO edge list
                               (reference semantics);
  * ``gin_aggregate_dense`` -- ``A @ h`` as one f32 matmul;
  * ``spmm``                -- kernel K1 (``csrc/gin_spmm.cu``) on CUDA
                               tensors, forward and backward; its plain
                               versions ``spmm_reference`` and
                               ``spmm_bwd_reference`` on CPU tensors, and
                               only there;
  * ``ops.spmm_csr``        -- kernel K3 over the adjacency's nonzeros
                               (edge CSR), for graphs past the dense limit.

The adjacency is built once per batch (``build_dense_adjacency``) and reused
by all 5 GIN layers. ``spmm`` is one ``torch.autograd.Function``: its
backward is K1-bwd, ``dh = Aᵀ g + (1 + eps) g`` with A read in place (no
transposed copy), and ``d eps = Σ g ⊙ h``; the adjacency gets no gradient.
"""

from __future__ import annotations

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.ops import _build

MODES = {"highest": 0, "split": 1, "bf16": 2}


def build_dense_adjacency(senders: torch.Tensor, receivers: torch.Tensor,
                          edge_mask: torch.Tensor, num_nodes: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense [N, N] adjacency with A[dst, src] = multiplicity of edge src->dst.

    Masked (padding) edges contribute 0. ``dtype=torch.bfloat16`` is exact:
    the entries are small edge multiplicities."""
    flat = receivers.long() * num_nodes + senders.long()
    a = torch.zeros(num_nodes * num_nodes, dtype=torch.float32,
                    device=senders.device)
    a.index_add_(0, flat, edge_mask.to(torch.float32))
    return a.view(num_nodes, num_nodes).to(dtype)


def gin_aggregate_coo(h: torch.Tensor, senders: torch.Tensor,
                      receivers: torch.Tensor, edge_mask: torch.Tensor,
                      eps, edge_axis=None) -> torch.Tensor:
    """Reference-semantics aggregation via gather + masked ``index_add_``.

    With ``edge_axis`` (a ``parallel.mesh.DataAxis`` whose ranks each hold a
    block of the edge list), the partial over this rank's edges is summed
    over the ranks before ``(1+eps)·h`` is added: the edge-partitioned
    aggregation of ``parallel/edge_partition.py``."""
    msgs = h[senders.long()] * edge_mask.to(h.dtype)[:, None]
    agg = torch.zeros_like(h).index_add_(0, receivers.long(), msgs)
    if edge_axis is not None:
        agg = edge_axis.psum(agg)
    return agg + (1.0 + eps) * h


def gin_aggregate_dense(h: torch.Tensor, adj: torch.Tensor, eps) -> torch.Tensor:
    """``A @ h + (1+eps) h`` as one f32 matmul (full f32 while
    ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default)."""
    return adj.to(torch.float32) @ h + (1.0 + eps) * h


def spmm_reference(adj: torch.Tensor, h: torch.Tensor, eps,
                   mode: str = "split") -> torch.Tensor:
    """The plain version of K1-fwd: the kernel's rounding, as f32 matmuls.

    ``highest`` takes f32 products; ``split`` rounds h to hi = bf16(h) and
    lo = bf16(h - hi) and sums A·hi + A·lo; ``bf16`` takes A·bf16(h). In the
    last two an f32 A is rounded to bf16 first (exact for an adjacency)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if mode == "highest":
        agg = adj.to(torch.float32) @ h
    else:
        a = adj.to(torch.bfloat16).to(torch.float32)
        hi = h.to(torch.bfloat16)
        agg = a @ hi.to(torch.float32)
        if mode == "split":
            lo = (h - hi.to(torch.float32)).to(torch.bfloat16)
            agg = agg + a @ lo.to(torch.float32)
    return agg + (1.0 + eps) * h


def spmm_bwd_reference(adj: torch.Tensor, g: torch.Tensor, eps,
                       mode: str = "split") -> torch.Tensor:
    """The plain version of K1-bwd: ``Aᵀ g + (1+eps) g`` with the kernel's
    rounding applied to g (``spmm_reference`` on the transposed adjacency)."""
    return spmm_reference(adj.t(), g, eps, mode)


def _launch(entry: str, adj: torch.Tensor, h: torch.Tensor, eps,
            mode: str) -> torch.Tensor:
    """Check the operands and launch one of K1's two C entries on them."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {list(MODES)}")
    if h.device.type != "cuda" or adj.device != h.device:
        raise ValueError(f"K1 needs adj and h on one CUDA device, got "
                         f"{adj.device} and {h.device}")
    if h.dtype != torch.float32 or adj.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes h f32 and adj bf16/f32, got {h.dtype}, {adj.dtype}")
    n, f = h.shape
    if adj.shape != (n, n):
        raise ValueError(f"adj {tuple(adj.shape)} does not match h {tuple(h.shape)}")
    if not (adj.is_contiguous() and h.is_contiguous()):
        raise ValueError("K1 takes contiguous adj and h")
    if not torch.is_tensor(eps):
        eps = torch.full((1,), float(eps), dtype=torch.float32, device=h.device)
    if eps.numel() != 1 or eps.dtype != torch.float32 or eps.device != h.device:
        raise ValueError(f"eps must be one f32 value on {h.device}")
    eps = eps.detach().reshape(1).contiguous()
    out = torch.empty_like(h)
    lib, device = _build.library(), h.device.index
    # Scratch for the partial sums when K1 splits the contraction.
    ws_floats = lib.gin_spmm_workspace(n, f, MODES[mode], device)
    ws = torch.empty(ws_floats, dtype=torch.float32, device=h.device) if ws_floats else None
    code = getattr(lib, entry)(
        adj.data_ptr(), int(adj.dtype == torch.bfloat16), h.data_ptr(),
        eps.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        n, f, MODES[mode], device, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(code, entry)
    return out


def gin_spmm_fwd(adj: torch.Tensor, h: torch.Tensor, eps,
                 mode: str = "split") -> torch.Tensor:
    """Launch K1-fwd on CUDA tensors: ``A @ h + (1+eps) h`` -> [N, F] f32.

    ``adj`` [N, N] bf16 or f32, ``h`` [N, F] f32, both contiguous on one card;
    ``eps`` a float or a 1-element f32 tensor on that card. Raises on anything
    else, and when the kernel does not build or launch. No autograd graph is
    recorded here: ``spmm`` wraps this launch and K1-bwd in one Function.
    Allocates the output and, where K1 splits the contraction, scratch for
    its partial sums."""
    out = _launch("gin_spmm_fwd", adj, h.detach(), eps, mode)
    gin_spmm_fwd.launches += 1
    return out


gin_spmm_fwd.launches = 0


def gin_spmm_bwd(adj: torch.Tensor, g: torch.Tensor, eps,
                 mode: str = "split") -> torch.Tensor:
    """Launch K1-bwd on CUDA tensors: ``Aᵀ g + (1+eps) g`` -> [N, F] f32,
    contracting over A's rows in place. Operands as ``gin_spmm_fwd``, with
    the upstream gradient ``g`` (contiguous) where ``h`` was."""
    out = _launch("gin_spmm_bwd", adj, g.detach(), eps, mode)
    gin_spmm_bwd.launches += 1
    return out


gin_spmm_bwd.launches = 0


class _GinSpmm(torch.autograd.Function):
    """K1 forward and backward as one differentiable op.

    On CUDA tensors both directions launch the kernel; on CPU tensors both
    take the plain versions, so the CPU tests run this same wiring."""

    @staticmethod
    def forward(ctx, adj, h, eps, mode):
        ctx.mode = mode
        ctx.save_for_backward(adj, h, eps)
        if h.device.type == "cpu" and adj.device.type == "cpu":
            return spmm_reference(adj, h, eps, mode)
        return gin_spmm_fwd(adj, h, eps, mode)

    @staticmethod
    def backward(ctx, g):
        adj, h, eps = ctx.saved_tensors
        dh = deps = None
        if ctx.needs_input_grad[1]:
            # A gradient out of autograd may be a view or an expanded scalar.
            g = g.contiguous()
            if g.device.type == "cpu" and adj.device.type == "cpu":
                dh = spmm_bwd_reference(adj, g, eps, ctx.mode)
            else:
                dh = gin_spmm_bwd(adj, g, eps, ctx.mode)
        if ctx.needs_input_grad[2]:
            deps = (g * h).sum().to(eps.dtype).reshape(eps.shape)
        return None, dh, deps, None


def spmm(adj: torch.Tensor, h: torch.Tensor, eps,
         mode: str = "split") -> torch.Tensor:
    """``A @ h + (1+eps) h``, differentiable in ``h`` and ``eps``: kernel K1
    (forward and backward) for CUDA tensors, its plain versions for tensors
    on the CPU."""
    if not torch.is_tensor(eps):
        eps = torch.full((1,), float(eps), dtype=torch.float32, device=h.device)
    return _GinSpmm.apply(adj, h, eps, mode)


def gin_aggregate(h: torch.Tensor, eps, *, adj: torch.Tensor | None = None,
                  senders: torch.Tensor | None = None,
                  receivers: torch.Tensor | None = None,
                  edge_mask: torch.Tensor | None = None,
                  bsr=None, impl: str = "pallas") -> torch.Tensor:
    """Dispatch between the aggregation implementations.

    The dense-adjacency paths (``dense``/``pallas``, the latter being K1)
    carry O(N²) memory; past ``DENSE_ADJACENCY_MAX_NODES`` nodes they refuse
    to build an adjacency, before allocating it. For large graphs pass a
    ``BlockCSR`` (``ops.spmm_csr.build_block_csr``, once per graph) as
    ``bsr`` or ask for ``impl="csr"`` (K3; the BlockCSR is then built here on
    the host from the edge list). ``coo`` works at any size."""
    if impl == "coo":
        return gin_aggregate_coo(h, senders, receivers, edge_mask, eps)
    if bsr is not None or impl == "csr":
        from gnn_pretraining_tpu_torch.ops.spmm_csr import (
            build_block_csr,
            gin_aggregate_csr,
        )

        if bsr is None:
            bsr = build_block_csr(senders.cpu().numpy(), receivers.cpu().numpy(),
                                  edge_mask.cpu().numpy(), h.shape[0]).to(h.device)
        return gin_aggregate_csr(h, bsr, eps)
    if impl not in ("dense", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    if adj is None:
        if h.shape[0] > config.DENSE_ADJACENCY_MAX_NODES:
            raise ValueError(
                f"dense adjacency for {h.shape[0]} nodes would be "
                f"{h.shape[0]**2 * 2 / 2**20:.0f} MB; pass a BlockCSR as bsr= "
                "(ops/spmm_csr.build_block_csr) or use impl='coo'")
        adj = build_dense_adjacency(senders, receivers, edge_mask, h.shape[0])
    if impl == "dense":
        return gin_aggregate_dense(h, adj, eps)
    return spmm(adj, h, eps)
