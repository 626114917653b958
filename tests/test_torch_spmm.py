"""The port's GIN aggregation ops against the JAX package's, on the CPU.

Same numpy-seeded inputs through ``gnn_pretraining_tpu.ops`` and
``gnn_pretraining_tpu_torch.ops``. On the CPU ``spmm`` runs kernel K1's plain
version, ``spmm_reference``, which is held here against the JAX Pallas
kernel (interpret mode) in each precision mode, with the tolerances of
tests/test_ops.py:62-90. The CUDA kernel itself is held against
``spmm_reference`` on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config
from gnn_pretraining_tpu.ops import segment as jax_segment
from gnn_pretraining_tpu.ops import spmm as jax_spmm
from gnn_pretraining_tpu_torch.ops import segment, spmm
from gnn_pretraining_tpu_torch.ops.spmm_csr import build_block_csr

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

# Max |port - jax| / max |jax| per mode (tests/test_ops.py:71-90).
MODE_TOL = {"highest": 1e-5, "split": 1e-3, "bf16": 5e-2}


def multigraph(rng, n_valid, n_pad, e_valid, e_pad):
    """Random edges with repeats (multiplicities > 1) and masked padding."""
    senders = rng.integers(0, n_valid, e_pad).astype(np.int32)
    receivers = rng.integers(0, n_valid, e_pad).astype(np.int32)
    senders[e_valid // 2:e_valid] = senders[:e_valid - e_valid // 2]
    receivers[e_valid // 2:e_valid] = receivers[:e_valid - e_valid // 2]
    edge_mask = (np.arange(e_pad) < e_valid).astype(np.float32)
    return senders, receivers, edge_mask


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_adjacency_exact(dtype):
    rng = np.random.default_rng(0)
    s, r, m = multigraph(rng, 50, 64, 300, 360)
    want = np.zeros((64, 64), np.float32)
    for si, ri, mi in zip(s, r, m):
        want[ri, si] += mi
    assert want.max() >= 2                  # duplicates present
    got = spmm.build_dense_adjacency(t(s), t(r), t(m), 64, dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    jax_adj = jax_spmm.build_dense_adjacency(jnp.asarray(s), jnp.asarray(r),
                                             jnp.asarray(m), 64)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jax_adj))


def test_coo_dense_agree_with_jax():
    rng = np.random.default_rng(1)
    s, r, m = multigraph(rng, 50, 64, 200, 256)
    h = rng.normal(size=(64, 16)).astype(np.float32)
    eps = 0.3
    adj = spmm.build_dense_adjacency(t(s), t(r), t(m), 64)
    dense = spmm.gin_aggregate_dense(t(h), adj, eps)
    coo = spmm.gin_aggregate_coo(t(h), t(s), t(r), t(m), eps)
    np.testing.assert_allclose(dense.numpy(), coo.numpy(), rtol=1e-5, atol=1e-5)
    want = jax_spmm.gin_aggregate_coo(jnp.asarray(h), jnp.asarray(s),
                                      jnp.asarray(r), jnp.asarray(m),
                                      jnp.float32(eps))
    np.testing.assert_allclose(coo.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,f", [(136, 40), (144, 64)])
@pytest.mark.parametrize("adj_dtype", ["float32", "bfloat16"])
def test_spmm_reference_matches_pallas(n, f, adj_dtype):
    """Each precision mode of the plain version against the JAX kernel."""
    rng = np.random.default_rng(n)
    adj = (rng.random((n, n)) < 0.05).astype(np.float32)
    adj[:8, :8] += 1.0                      # multiplicities of 2
    h = rng.normal(size=(n, f)).astype(np.float32)
    eps = np.float32(-0.2)
    t_adj = t(adj).to(getattr(torch, adj_dtype))
    j_adj = jnp.asarray(adj, getattr(jnp, adj_dtype))
    for mode, tol in MODE_TOL.items():
        want = np.asarray(jax_spmm.spmm_pallas(j_adj, jnp.asarray(h),
                                               jnp.float32(eps), mode))
        got = spmm.spmm(t_adj, t(h), torch.tensor([eps]), mode).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() <= tol, mode
        if mode == "highest":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spmm_on_cpu_never_counts_a_launch():
    rng = np.random.default_rng(3)
    adj = t((rng.random((24, 24)) < 0.2).astype(np.float32)).to(torch.bfloat16)
    h = t(rng.normal(size=(24, 8)).astype(np.float32))
    before = spmm.gin_spmm_fwd.launches
    out = spmm.spmm(adj, h, 0.1)
    want = spmm.spmm_reference(adj, h, 0.1, "split")
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert spmm.gin_spmm_fwd.launches == before == 0
    with pytest.raises(ValueError, match="CUDA"):
        spmm.gin_spmm_fwd(adj, h, 0.1)      # the kernel wrapper never falls back
    with pytest.raises(ValueError, match="unknown mode"):
        spmm.spmm(adj, h, 0.1, "tf32")


def test_dispatch_paths_agree_and_csr_is_not_ported():
    rng = np.random.default_rng(4)
    s, r, m = multigraph(rng, 40, 48, 150, 160)
    h = t(rng.normal(size=(48, 12)).astype(np.float32))
    kw = dict(senders=t(s), receivers=t(r), edge_mask=t(m))
    coo = spmm.gin_aggregate(h, 0.2, impl="coo", **kw)
    for impl in ("dense", "pallas"):
        got = spmm.gin_aggregate(h, 0.2, impl=impl, **kw)
        np.testing.assert_allclose(got.numpy(), coo.numpy(), rtol=1e-3, atol=1e-3)
    # The name predates kernel K3: ``csr`` is ported now, and the dispatch
    # builds the block-CSR tiles on the host when no BlockCSR is passed.
    for got in (spmm.gin_aggregate(h, 0.2, impl="csr", **kw),
                spmm.gin_aggregate(h, 0.2, bsr=build_block_csr(s, r, m, 48), **kw)):
        np.testing.assert_allclose(got.numpy(), coo.numpy(), rtol=1e-3, atol=1e-3)


def test_dense_guard_raises_before_allocating(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("allocated an adjacency past the limit")

    monkeypatch.setattr(spmm, "build_dense_adjacency", refuse)
    n = config.DENSE_ADJACENCY_MAX_NODES + 1
    h = torch.zeros(n, 1)
    idx = torch.zeros(4, dtype=torch.int32)
    for impl in ("dense", "pallas"):
        with pytest.raises(ValueError, match="use impl='coo'"):
            spmm.gin_aggregate(h, 0.0, senders=idx, receivers=idx,
                               edge_mask=torch.ones(4), impl=impl)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(30, 6)).astype(np.float32)
    ids = np.sort(rng.integers(0, 4, 30)).astype(np.int32)
    ids[ids == 2] = 1                       # segment 2 stays empty
    mask = (np.arange(30) < 26).astype(np.float32)
    for name in ("segment_sum", "segment_mean", "segment_max"):
        want = getattr(jax_segment, name)(jnp.asarray(data), jnp.asarray(ids),
                                          5, jnp.asarray(mask))
        got = getattr(segment, name)(t(data), t(ids), 5, t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(segment.segment_count(t(ids), 5, t(mask)).numpy(),
                                  np.bincount(ids[:26], minlength=5))
