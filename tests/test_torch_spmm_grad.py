"""K1's autograd Function against ``spmm_pallas``' custom VJP, on the CPU.

``ops.spmm.spmm`` is one ``torch.autograd.Function`` over kernel K1's forward
and backward; on CPU tensors both directions run the plain versions
(``spmm_reference``, ``spmm_bwd_reference``), so these tests hold the
Function's wiring and the backward's rounding against the JAX Pallas kernel
with ``transpose_a=True`` (interpret mode; the Function's own properties are
in ``test_torch_spmm_function.py``). Tolerances are those of
tests/test_ops.py:92-122: ``highest`` rtol = atol = 1e-4, ``split`` within
2e-3 of the largest gradient entry, ``bf16`` within 5e-2 of it. The CUDA
kernel is held against ``spmm_bwd_reference`` on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.ops import spmm as jax_spmm
from gnn_pretraining_tpu_torch.ops import spmm

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

MAX_REL = {"split": 2e-3, "bf16": 5e-2}


def inputs(n, f, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.06).astype(np.float32)
    adj[:6, 3:9] += 1.0                       # multiplicities of 2, asymmetric
    h = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(n, f)).astype(np.float32)
    return adj, h, w, np.float32(0.15)


def jax_grads(adj, h, w, eps, mode, adj_dtype):
    a = jnp.asarray(adj, dtype=adj_dtype)

    def loss(h_, e_):
        return jnp.sum(jax_spmm.spmm_pallas(a, h_, e_, mode) * jnp.asarray(w))

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(eps))


def torch_grads(adj, h, w, eps, mode, adj_dtype, upstream=None):
    a = torch.from_numpy(adj).to(adj_dtype).requires_grad_(adj_dtype == torch.float32)
    ht = torch.from_numpy(h).requires_grad_()
    et = torch.tensor([eps], requires_grad=True)
    out = spmm.spmm(a, ht, et, mode)
    if upstream is None:
        (out * torch.from_numpy(w)).sum().backward()
    else:
        out.backward(upstream)
    return a, ht.grad, et.grad


def check(got, want, mode):
    got, want = np.asarray(got), np.asarray(want)
    if mode == "highest":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= MAX_REL[mode] * np.abs(want).max()


@pytest.mark.parametrize("mode", ["highest", "split", "bf16"])
@pytest.mark.parametrize("n,f,adj_dtype", [
    (72, 24, "bfloat16"), (80, 40, "float32"),
    (136, 40, "bfloat16"), (136, 40, "float32")])
def test_function_grads_match_pallas_vjp(n, f, adj_dtype, mode):
    adj, h, w, eps = inputs(n, f, n)
    dh, deps = jax_grads(adj, h, w, eps, mode, getattr(jnp, adj_dtype))
    a, got_dh, got_deps = torch_grads(adj, h, w, eps, mode,
                                      getattr(torch, adj_dtype))
    assert a.grad is None                      # the adjacency gets no gradient
    assert got_deps.shape == (1,)
    check(got_dh, dh, mode)
    # d eps = sum(g * h) is taken outside the kernel in f32 on both sides.
    np.testing.assert_allclose(got_deps.numpy()[0], float(deps), rtol=1e-4, atol=1e-4)


