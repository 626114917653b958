"""K1's autograd Function on its own terms, on the CPU: the backward's plain
version is the forward's on Aᵀ in every mode, non-contiguous and expanded
upstream gradients give the contiguous ones' result, no dH work is done
when H needs no gradient, and the CUDA wrappers refuse CPU tensors and
count nothing. The gradients against the JAX Pallas VJP are in
``test_torch_spmm_grad.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.ops import spmm as jax_spmm
from gnn_pretraining_tpu_torch.ops import spmm
from test_torch_spmm_grad import check, inputs, torch_grads

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["highest", "split", "bf16"])
def test_bwd_reference_is_the_transposed_forward(mode):
    """``spmm_bwd_reference`` rounds g as the forward rounds h, and contracts
    over A's rows: it equals the JAX kernel with ``transpose_a=True``."""
    adj, g, _, eps = inputs(80, 40, 5)
    want = jax_spmm._spmm_fwd_impl(jnp.asarray(adj, jnp.bfloat16), jnp.asarray(g),
                                   jnp.asarray(eps), mode=mode, transpose_a=True)
    got = spmm.spmm_bwd_reference(torch.from_numpy(adj).bfloat16(),
                                  torch.from_numpy(g), float(eps), mode)
    check(got.numpy(), want, mode)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(want).max()


def test_non_contiguous_and_expanded_upstream_gradients():
    adj, h, w, eps = inputs(72, 24, 9)
    strided = torch.from_numpy(np.ascontiguousarray(w.T)).t()      # a view
    assert not strided.is_contiguous()
    _, dh, deps = torch_grads(adj, h, w, eps, "highest", torch.float32, strided)
    _, dh_ref, deps_ref = torch_grads(adj, h, w, eps, "highest", torch.float32)
    np.testing.assert_allclose(dh.numpy(), dh_ref.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(deps.numpy(), deps_ref.numpy(), rtol=1e-6)

    # out.sum() hands the backward an expanded scalar (all strides 0).
    a = torch.from_numpy(adj)
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.tensor([eps], requires_grad=True)
    spmm.spmm(a, ht, et, "highest").sum().backward()
    want = adj.T @ np.ones_like(h) + (1 + eps)
    np.testing.assert_allclose(ht.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(et.grad.numpy()[0], h.sum(), rtol=1e-4, atol=1e-4)


def test_no_dh_work_when_h_needs_no_grad(monkeypatch):
    """A frozen input (ENZYMES' encoder feeding layer 0) skips the dH product;
    d eps still comes out."""
    adj, h, w, eps = inputs(72, 24, 11)
    calls = []
    real = spmm.spmm_bwd_reference
    monkeypatch.setattr(spmm, "spmm_bwd_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    et = torch.tensor([eps], requires_grad=True)
    out = spmm.spmm(torch.from_numpy(adj), torch.from_numpy(h), et, "split")
    (out * torch.from_numpy(w)).sum().backward()
    assert calls == []
    np.testing.assert_allclose(et.grad.numpy()[0], (w * h).sum(), rtol=1e-4)

    ht = torch.from_numpy(h).requires_grad_()
    (spmm.spmm(torch.from_numpy(adj), ht, et, "split") * torch.from_numpy(w)).sum().backward()
    assert calls == [1]


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    adj, h, _, eps = inputs(72, 24, 3)
    before = (spmm.gin_spmm_fwd.launches, spmm.gin_spmm_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        spmm.gin_spmm_bwd(torch.from_numpy(adj), torch.from_numpy(h), float(eps))
    spmm.spmm(torch.from_numpy(adj), torch.from_numpy(h).requires_grad_(),
              float(eps)).sum().backward()
    assert (spmm.gin_spmm_fwd.launches, spmm.gin_spmm_bwd.launches) == before
    with pytest.raises(ValueError, match="unknown mode"):
        spmm.spmm(torch.from_numpy(adj), torch.from_numpy(h), float(eps), "fp8")
