"""The port's NT-Xent (K2's Function on its plain versions, and the plain
formula) against the JAX package's, on the CPU.

The JAX side runs ``nt_xent_loss`` (XLA) and ``nt_xent_pallas`` in interpret
mode, the port ``ops.ntxent.nt_xent`` (the K2 autograd Function, which takes
the plain versions of its three kernels for CPU tensors) and
``ops.sddmm.nt_xent_loss``. Shapes and tolerances are those of
``tests/test_ntxent_pallas.py``: 24x16 with 17 valid rows (loss rtol 1e-4),
16x8 with 11 valid rows for gradients (rtol 2e-3, atol 1e-5). The three plain
kernels are held one by one against the outputs of the three Pallas calls
(recorded as they run, jit off), and one case of 300 rows at the projection
width of 128 against the XLA formula only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gnn_pretraining_tpu.ops import ntxent_pallas
from gnn_pretraining_tpu.ops.sddmm import nt_xent_loss as jax_nt_xent_loss
from gnn_pretraining_tpu_torch.ops import ntxent
from gnn_pretraining_tpu_torch.ops.sddmm import nt_xent_loss

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)


def case(seed, n, d, n_valid):
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=(n, d)).astype(np.float32)
    z2 = rng.normal(size=(n, d)).astype(np.float32)
    return z1, z2, (np.arange(n) < n_valid)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


PORT = {"fused": ntxent.nt_xent, "formula": nt_xent_loss}


@functools.lru_cache(maxsize=None)
def jax_losses(shape, temp):
    """(XLA formula, Pallas interpret) loss sums and the formula's row count."""
    z1, z2, valid = (jnp.array(a) for a in case(*shape))
    ref_sum, ref_rows = jax_nt_xent_loss(z1, z2, np.float32(temp), valid)
    pl_sum, _ = ntxent_pallas.nt_xent_pallas(z1, z2, np.float32(temp), valid)
    return float(ref_sum), float(pl_sum), float(ref_rows)


@functools.lru_cache(maxsize=None)
def jax_grads(shape, temp):
    """d(mean loss)/d(z1, z2) of the XLA formula and of the Pallas kernels."""
    z1, z2, valid = (jnp.array(a) for a in case(*shape))

    def grads(fn):
        def mean_loss(a, b):
            s, n = fn(a, b, np.float32(temp), valid)
            return s / jnp.maximum(n, 1.0)
        return [np.asarray(g) for g in jax.grad(mean_loss, argnums=(0, 1))(z1, z2)]

    return grads(jax_nt_xent_loss), grads(ntxent_pallas.nt_xent_pallas)


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("shape", [(0, 24, 16, 17), (1, 32, 8, 32)],
                         ids=["24x16-17valid", "32x8-allvalid"])
def test_loss_matches_jax(port, shape):
    z1, z2, valid = case(*shape)
    ref_sum, pl_sum, ref_rows = jax_losses(shape, 0.43)
    got_sum, got_rows = PORT[port](t(z1), t(z2), torch.tensor([0.43]),
                                   t(valid.astype(np.float32)))
    assert float(got_rows) == ref_rows == 2 * valid.sum()
    np.testing.assert_allclose(float(got_sum), ref_sum, rtol=1e-4)
    np.testing.assert_allclose(float(got_sum), pl_sum, rtol=1e-4)


@pytest.mark.parametrize("port", sorted(PORT))
def test_gradients_match_jax(port):
    shape = (2, 16, 8, 11)
    z1, z2, valid = case(*shape)
    a, b = t(z1).requires_grad_(), t(z2).requires_grad_()
    s, n = PORT[port](a, b, torch.tensor([0.37]), t(valid.astype(np.float32)))
    (s / torch.clamp(n, min=1.0)).backward()
    for want in jax_grads(shape, 0.37):
        np.testing.assert_allclose(a.grad.numpy(), want[0], rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(b.grad.numpy(), want[1], rtol=2e-3, atol=1e-5)
    np.testing.assert_array_equal(a.grad.numpy()[11:], 0.0)      # padding rows


def pallas_outputs(zhat, vv, temp, mx, den, g):
    """The three Pallas calls' outputs, by kernel name, sliced to [R] / [R, d]."""
    got = {}
    real = pl.pallas_call

    def recording(kernel, **kwargs):
        call = real(kernel, **kwargs)

        def run(*args):
            out = call(*args)
            got[kernel.func.__name__] = out
            return out
        return run

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(pl, "pallas_call", recording)
        fwd = ntxent_pallas._fwd_call(zhat, vv, temp)
        ntxent_pallas._bwd_call(zhat, vv, temp, mx, den, g)
    rows, d = zhat.shape
    return {"fwd": [np.asarray(x) for x in fwd],
            "rows": np.asarray(got["_bwd_rows_kernel"])[:rows, :d],
            "cols": np.asarray(got["_bwd_cols_kernel"])[:rows, :d]}


@pytest.mark.parametrize("shape", [(3, 24, 16, 17), (4, 8, 8, 3)],
                         ids=["24x16-17valid", "8x8-3valid"])
def test_plain_kernels_match_the_pallas_calls(shape):
    z1, z2, valid = case(*shape)
    zhat, vv, _ = ntxent._prep(t(z1), t(z2), t(valid.astype(np.float32)))
    temp = torch.tensor([0.41])
    g = vv * 0.7
    loss, mx, den = ntxent.ntxent_fwd_reference(zhat, vv, temp)
    rows = ntxent.ntxent_bwd_rows_reference(zhat, vv, temp, mx, den, g)
    cols = ntxent.ntxent_bwd_cols_reference(zhat, vv, temp, mx, den, g)
    want = pallas_outputs(*(jnp.asarray(x.numpy()) for x in (zhat, vv)), np.float32(0.41),
                          *(jnp.asarray(x.numpy()) for x in (mx, den, g)))
    keep = vv.numpy() > 0                   # an invalid row's loss is never read
    for got, ref in zip((loss, mx, den), want["fwd"]):
        np.testing.assert_allclose(got.numpy()[keep], ref[keep], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mx.numpy(), want["fwd"][1], rtol=1e-5)
    np.testing.assert_allclose(rows.numpy(), want["rows"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(cols.numpy(), want["cols"], rtol=1e-4, atol=1e-6)
    assert np.abs(rows.numpy()).max() > 1e-3 and np.abs(cols.numpy()).max() > 1e-3


def test_three_hundred_rows_at_full_width_against_the_formula():
    z1, z2, valid = case(5, 300, 128, 271)
    temp = np.float32(0.2)

    def mean_loss(a, b):
        s, n = jax_nt_xent_loss(a, b, temp, jnp.array(valid))
        return s / n

    want, (w1, w2) = jax.value_and_grad(mean_loss, argnums=(0, 1))(jnp.array(z1),
                                                                  jnp.array(z2))
    a, b = t(z1).requires_grad_(), t(z2).requires_grad_()
    s, n = ntxent.nt_xent(a, b, torch.tensor([temp]), t(valid.astype(np.float32)))
    (s / n).backward()
    np.testing.assert_allclose(float(s / n), float(want), rtol=1e-4)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(w1), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(w2), rtol=2e-3, atol=1e-6)


def test_launch_wrappers_take_cuda_tensors_only():
    zhat = torch.zeros(4, 8)
    vv, temp = torch.ones(4), torch.tensor([0.5])
    before = ntxent.ntxent_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        ntxent.ntxent_fwd(zhat, vv, temp)
    with pytest.raises(ValueError, match="CUDA"):
        ntxent.ntxent_bwd(zhat, vv, temp, vv, vv, vv)
    assert ntxent.ntxent_fwd.launches == before
