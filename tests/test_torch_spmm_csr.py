"""The port's block-CSR aggregation (kernel K3's module) against the JAX one.

Same numpy-seeded graphs as tests/test_spmm_csr.py through
``gnn_pretraining_tpu.ops.spmm_csr`` and ``gnn_pretraining_tpu_torch.ops.spmm_csr``:

  * the host-side tile constructions give equal arrays and ``rcm_order`` the
    same permutation (``test_torch_csr_tiles.py``);
  * on the CPU ``spmm_csr`` runs K3's plain version, which is held against
    the JAX Pallas kernel (interpret mode) in each precision mode, forward
    and backward, within 1e-5 of max |ref| (both round alike; only the order
    of f32 sums differs);
  * it is held against the COO aggregation at tests/test_spmm_csr.py's
    tolerances: rtol = atol = 1e-5 in ``highest``, 2e-4 in ``split``,
    gradients rtol 1e-4 / atol 1e-5.

The CUDA kernel itself is held against ``csr_matvec_reference`` on the card
by chip_smoke.py.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.ops.spmm import gin_aggregate_coo as jax_coo
from gnn_pretraining_tpu_torch import FinetuneGNN
from gnn_pretraining_tpu_torch.ops import spmm_csr
from gnn_pretraining_tpu_torch.ops.spmm import gin_aggregate_coo

# The module: the JAX package's ``ops.spmm_csr`` attribute is its function.
jax_csr = importlib.import_module("gnn_pretraining_tpu.ops.spmm_csr")

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

MODES = ("highest", "split", "bf16")


def graph(seed, n, e, masked=0, f=48):
    """tests/test_spmm_csr.py:_graph."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = rng.integers(0, n, e).astype(np.int32)
    mask = np.ones(e, np.float32)
    if masked:
        mask[rng.choice(e, masked, replace=False)] = 0.0
    h = rng.normal(size=(n, f)).astype(np.float32)
    return senders, receivers, mask, h


def coo_ref(h, s, r, m, eps):
    return np.asarray(jax_coo(jnp.asarray(h), jnp.asarray(s), jnp.asarray(r),
                              jnp.asarray(m), eps))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_matches_the_jax_kernel(mode):
    """Forward and the gradients (dh over the transposed tiles, d eps) in
    the same precision mode, on a graph with masked edges and pad tiles."""
    s, r, m, h = graph(3, 520, 2000, 200)
    up = np.random.default_rng(12).normal(size=h.shape).astype(np.float32)
    jbsr = jax_csr.build_block_csr(s, r, m, 520, pad_to=40)
    bsr = spmm_csr.build_block_csr(s, r, m, 520, pad_to=40)

    def jax_loss(hh, eps):
        out = jax_csr.gin_aggregate_csr(hh, jbsr, eps, mode=mode)
        return jnp.sum(out * up), out

    (_, want), (jdh, jde) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.float32(0.17))
    hh = t(h).requires_grad_()
    eps = torch.tensor([0.17], requires_grad=True)
    got = spmm_csr.gin_aggregate_csr(hh, bsr, eps, mode=mode)
    (got * t(up)).sum().backward()
    for a, b in ((got.detach(), want), (hh.grad, jdh)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_allclose(float(eps.grad), float(jde), rtol=1e-5)


@pytest.mark.parametrize("n,e", [(130, 400), (520, 2000)])
def test_matches_coo(n, e):
    s, r, m, h = graph(3, n, e, e // 10)
    bsr = spmm_csr.build_block_csr(s, r, m, n)
    got = spmm_csr.gin_aggregate_csr(t(h), bsr, 0.17, mode="highest")
    np.testing.assert_allclose(got.numpy(), coo_ref(h, s, r, m, 0.17),
                               rtol=1e-5, atol=1e-5)


def test_isolated_rows_are_written():
    """Tile rows without incoming edges get (1+eps) h (their zero tile)."""
    rng = np.random.default_rng(4)
    n = 300
    s = rng.integers(0, 100, 200).astype(np.int32)
    r = rng.integers(0, 100, 200).astype(np.int32)
    m = np.ones(200, np.float32)
    h = rng.normal(size=(n, 32)).astype(np.float32)
    bsr = spmm_csr.build_block_csr(s, r, m, n)
    got = spmm_csr.gin_aggregate_csr(t(h), bsr, 0.0, mode="highest")
    np.testing.assert_allclose(got.numpy(), coo_ref(h, s, r, m, 0.0),
                               rtol=1e-5, atol=1e-5)


def test_split_mode_close_to_coo():
    s, r, m, h = graph(6, 256, 800)
    bsr = spmm_csr.build_block_csr(s, r, m, 256)
    got = spmm_csr.gin_aggregate_csr(t(h), bsr, 0.1, mode="split")
    np.testing.assert_allclose(got.numpy(), coo_ref(h, s, r, m, 0.1),
                               rtol=2e-4, atol=2e-4)


def test_gradients_match_coo():
    s, r, m, h = graph(5, 200, 600)
    bsr = spmm_csr.build_block_csr(s, r, m, 200)

    def f_coo(hh, eps):
        return jnp.sum(jax_coo(hh, jnp.asarray(s), jnp.asarray(r), jnp.asarray(m), eps) ** 2)

    jdh, jde = jax.grad(f_coo, argnums=(0, 1))(jnp.asarray(h), jnp.float32(0.3))
    hh = t(h).requires_grad_()
    eps = torch.tensor([0.3], requires_grad=True)
    (spmm_csr.gin_aggregate_csr(hh, bsr, eps, mode="highest") ** 2).sum().backward()
    np.testing.assert_allclose(hh.grad.numpy(), np.asarray(jdh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(eps.grad), float(jde), rtol=1e-4)


def test_pad_tiles_add_nothing_and_wrappers_never_fall_back():
    s, r, m, h = graph(7, 256, 300)
    plain = spmm_csr.build_block_csr(s, r, m, 256)
    padded = spmm_csr.build_block_csr(s, r, m, 256, pad_to=16)
    assert padded.nnzb == 16 > plain.nnzb
    before = (spmm_csr.csr_spmm_fwd.launches, spmm_csr.csr_spmm_bwd.launches)
    for mode in MODES:
        a = spmm_csr.spmm_csr(plain, t(h), 0.0, mode)
        b = spmm_csr.spmm_csr(padded, t(h), 0.0, mode)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (spmm_csr.csr_spmm_fwd.launches, spmm_csr.csr_spmm_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr.csr_spmm_fwd(plain, t(h), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr.csr_spmm_bwd(plain, t(h), 0.0)
    with pytest.raises(ValueError, match="unknown mode"):
        spmm_csr.spmm_csr(plain, t(h), 0.0, "tf32")


def test_model_csr_matches_coo():
    """The whole FinetuneGNN forward (eval) with the BlockCSR passed through
    embed and the backbone equals the COO forward on the same weights
    (tests/test_spmm_csr.py:TestModelCSR's tolerance); ``csr`` without a
    BlockCSR raises."""
    rng = np.random.default_rng(11)
    n, e, d = 260, 800, 1433
    s = t(rng.integers(0, n, e).astype(np.int32))
    r = t(rng.integers(0, n, e).astype(np.int32))
    m = torch.ones(e)
    x = t(rng.normal(size=(n, d)).astype(np.float32))
    mask = torch.ones(n)
    bsr = spmm_csr.build_block_csr(s.numpy(), r.numpy(), m.numpy(), n)
    coo = FinetuneGNN("Cora_NC", "coo", device="cpu").eval()
    csr = FinetuneGNN("Cora_NC", "csr", device="cpu").eval()
    csr.load_state_dict(coo.state_dict())
    with torch.no_grad():
        want = coo(x, mask, senders=s, receivers=r, edge_mask=m)
        got = csr(x, mask, bsr=bsr)
        with pytest.raises(ValueError, match="BlockCSR"):
            csr(x, mask, senders=s, receivers=r, edge_mask=m)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    # The layer alone, in split mode, against the port's COO aggregation.
    h = t(rng.normal(size=(n, 256)).astype(np.float32))
    np.testing.assert_allclose(
        spmm_csr.gin_aggregate_csr(h, bsr, 0.25).numpy(),
        gin_aggregate_coo(h, s, r, m, 0.25).numpy(), rtol=2e-4, atol=2e-4)
