"""The fine-tune path's building blocks against the JAX package's, on the CPU.

Losses, similarity ops, top-k, hard-negative mining and the dropout source
(the metrics and the msgpack writer are in ``test_torch_finetune_metrics.py``,
the loaders and ``GraphStore.save`` in ``test_torch_finetune_loaders.py``): the
same numpy-seeded inputs go through ``gnn_pretraining_tpu`` and
``gnn_pretraining_tpu_torch``. Tolerances are stated at each comparison;
where both sides do the same f32 arithmetic it is rtol=1e-6, and array-valued
data (batches, stores) must be equal.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.finetune import mining as jax_mining
from gnn_pretraining_tpu.ops import sddmm as jax_sddmm
from gnn_pretraining_tpu.ops.topk import exact_top_k as jax_top_k
from gnn_pretraining_tpu.utils import losses as jax_losses
from gnn_pretraining_tpu_torch.finetune import mining
from gnn_pretraining_tpu_torch.models.gnn import Dropout, DropoutSource
from gnn_pretraining_tpu_torch.ops import sddmm
from gnn_pretraining_tpu_torch.ops.topk import exact_top_k
from gnn_pretraining_tpu_torch.utils import losses

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.asarray(a))


# -- losses, similarity, top-k ------------------------------------------------


@pytest.mark.parametrize("clamp", [True, False])
def test_bce_with_logits(clamp):
    rng = np.random.default_rng(0)
    z = np.concatenate([rng.normal(size=60) * 5, [150.0, -150.0, 0.0, 99.0]]).astype(np.float32)
    y = (rng.random(z.size) < 0.5).astype(np.float32)
    want = jax_losses.bce_with_logits(jnp.asarray(z), jnp.asarray(y), clamp=clamp)
    got = losses.bce_with_logits(t(z), t(y), clamp=clamp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert (got.max() <= 100.0) == clamp

    mask = (np.arange(z.size) < 50).astype(np.float32)
    want = jax_losses.masked_bce_with_logits_mean(jnp.asarray(z), jnp.asarray(y), jnp.asarray(mask))
    got = losses.masked_bce_with_logits_mean(t(z), t(y), t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = losses.masked_bce_with_logits_mean(t(z), t(y), t(mask * 0))
    assert float(empty) == 0.0                       # max(count, 1) guard


def test_l2_normalize_and_cosine_similarity():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    a[3] = 0.0                                       # clamped norm: stays 0
    b = rng.normal(size=(24, 16)).astype(np.float32)
    np.testing.assert_allclose(sddmm.l2_normalize(t(a)).numpy(),
                               jax_sddmm.l2_normalize(jnp.asarray(a)),
                               rtol=1e-6, atol=1e-7)
    for other in (None, b):
        want = jax_sddmm.cosine_similarity_matrix(
            jnp.asarray(a), None if other is None else jnp.asarray(other))
        got = sddmm.cosine_similarity_matrix(t(a), None if other is None else t(other))
        # f32 dot products of unit rows summed in another order: atol 1e-6.
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_exact_top_k_values_match_two_stage_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=40000).astype(np.float32)    # past the blocking threshold
    v[::7] = -np.inf
    want_v, want_i = jax_top_k(jnp.asarray(v), 64, num_blocks=16)
    got_v, got_i = exact_top_k(t(v), 64)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert set(got_i.tolist()) == set(np.asarray(want_i).tolist())


# -- mining ---------------------------------------------------------------------


def mining_case(n, n_pad, n_edges, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n_pad, 16)).astype(np.float32)
    emb[n:] = 0.0
    edges = rng.integers(0, n, (2, n_edges))
    node_mask = (np.arange(n_pad) < n).astype(np.float32)
    return emb, edges, node_mask


def pairs(s, r):
    return set(zip(np.asarray(s).tolist(), np.asarray(r).tolist()))


def test_counts_and_forbidden_mask():
    emb, edges, node_mask = mining_case(30, 32, 40, 0)
    assert (mining.candidate_count(32, edges, num_real_nodes=30)
            == jax_mining.candidate_count(32, edges, num_real_nodes=30))
    assert mining.candidate_count(32, edges) == jax_mining.candidate_count(32, edges)
    for cand, neg in ((700, 256), (20, 256), (5, 256), (10 ** 6, 256), (100, 16)):
        assert mining.hard_count(cand, neg) == jax_mining.hard_count(cand, neg)
    # Cora-sized: all 256 negatives are hard, the random remainder is empty.
    assert mining.hard_count(2708 * 2707 - 2 * 8444, 256) == 256
    got = mining.build_forbidden_mask(32, edges, node_mask=node_mask)
    want = jax_mining.build_forbidden_mask(32, edges, node_mask=node_mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool and got[30:].all() and got[:, 30:].all()


@pytest.mark.parametrize("num_negatives,num_hard", [(64, 20), (48, 48)])
def test_mining_equals_jax_with_injected_gumbel(num_negatives, num_hard):
    """Hard set equal as a set of pairs; with the JAX-side Gumbel draw handed
    over, the uniform remainder is equal too (num_rand = 44 and 0)."""
    n_pad = 32
    emb, edges, node_mask = mining_case(30, n_pad, 40, 1)
    forb = jax_mining.build_forbidden_mask(n_pad, edges, node_mask=node_mask)
    key = jax.random.PRNGKey(7)
    ws, wr = jax_mining.mine_hard_negatives(jnp.asarray(emb), forb, key,
                                            num_negatives=num_negatives,
                                            num_hard=num_hard)
    gumbel = np.asarray(jax.random.gumbel(key, (n_pad * n_pad,)))
    gs, gr = mining.mine_hard_negatives(
        t(emb), mining.build_forbidden_mask(n_pad, edges, node_mask=node_mask),
        num_negatives, num_hard, gumbel=t(gumbel))
    assert gs.dtype == torch.int32 and gs.shape == (num_negatives,)
    assert pairs(gs[:num_hard], gr[:num_hard]) == pairs(ws[:num_hard], wr[:num_hard])
    assert pairs(gs[num_hard:], gr[num_hard:]) == pairs(ws[num_hard:], wr[num_hard:])


@pytest.mark.parametrize("streaming", [False, True])
def test_mining_properties_with_own_generator(streaming):
    n_pad = 40
    emb, edges, node_mask = mining_case(37, n_pad, 60, 2)
    forb = mining.build_forbidden_mask(n_pad, edges, node_mask=node_mask)
    gen = torch.Generator().manual_seed(3)
    if streaming:
        s, r = mining.mine_hard_negatives_streaming(t(emb), forb, 96, 30,
                                                    generator=gen, row_block=16)
    else:
        s, r = mining.mine_hard_negatives(t(emb), forb, 96, 30, generator=gen)
    got = list(zip(s.tolist(), r.tolist()))
    assert len(set(got)) == 96                               # no duplicate
    assert not any(bool(forb[a, b]) for a, b in got)         # no forbidden pair
    hard = set(got[:30])
    rest = set(got[30:])
    assert not any((b, a) in hard for a, b in rest)          # no reverse of a hard pair
    # The generator is consumed: a second call draws another remainder.
    if not streaming:
        s2, r2 = mining.mine_hard_negatives(t(emb), forb, 96, 30, generator=gen)
        assert pairs(s2[:30], r2[:30]) == hard
        assert pairs(s2[30:], r2[30:]) != rest


@pytest.mark.parametrize("row_block", [16, 64])
def test_streaming_hard_set_equals_dense_and_jax(row_block):
    n_pad = 40
    emb, edges, node_mask = mining_case(37, n_pad, 60, 4)
    forb = mining.build_forbidden_mask(n_pad, edges, node_mask=node_mask)
    gen = torch.Generator().manual_seed(0)
    ds, dr = mining.mine_hard_negatives(t(emb), forb, 50, 50)
    ss, sr = mining.mine_hard_negatives_streaming(t(emb), forb, 80, 50,
                                                  generator=gen, row_block=row_block)
    assert pairs(ss[:50], sr[:50]) == pairs(ds, dr)
    js, jr = jax_mining.mine_hard_negatives_streaming(
        jnp.asarray(emb), jnp.asarray(forb.numpy()), jax.random.PRNGKey(0),
        num_negatives=50, num_hard=50, row_block=row_block)
    assert pairs(js, jr) == pairs(ds, dr)


def test_mining_needs_a_generator_for_the_remainder():
    emb, edges, node_mask = mining_case(30, 32, 40, 5)
    forb = mining.build_forbidden_mask(32, edges, node_mask=node_mask)
    with pytest.raises(ValueError, match="generator"):
        mining.mine_hard_negatives(t(emb), forb, 64, 20)


# -- metrics --------------------------------------------------------------------


# -- stores and loaders -----------------------------------------------------------


# -- msgpack writer and checkpoints -------------------------------------------------


# -- dropout ----------------------------------------------------------------------


def test_dropout_draws_from_its_source_only():
    x = torch.ones(64, 32)
    layer = Dropout(jax_config.DROPOUT_RATE, DropoutSource("cpu", seed=5))
    state = torch.random.get_rng_state()
    a = layer(x)
    assert torch.equal(torch.random.get_rng_state(), state)   # global RNG untouched
    kept = (a != 0).float().mean()
    assert abs(float(kept) - 0.8) < 0.05
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.8))
    layer.source.seed(5)
    assert torch.equal(layer(x), a)                           # reseeding repeats the draw
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)            # rate 0 needs no generator
    with pytest.raises(RuntimeError, match="seed"):
        Dropout(0.2)(x)


def test_dropout_takes_injected_keep_masks_in_call_order():
    """A flax ``nn.Dropout`` draw handed over: where(keep, x / keep_prob, 0)."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = nn.Dropout(0.2, deterministic=False).apply({}, jnp.asarray(x), rngs={"dropout": key})
    keep = np.asarray(want) != 0
    source = DropoutSource("cpu")
    first, second = Dropout(0.2, source), Dropout(0.2, source)
    source.inject([t(keep), t(~keep)])
    np.testing.assert_allclose(first(t(x)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(second(t(x)).numpy(), np.where(~keep, x / 0.8, 0), rtol=1e-6)
    with pytest.raises(RuntimeError):                         # the queue is empty again
        first(t(x))
    source.inject([t(keep[:4])])
    with pytest.raises(ValueError, match="keep-mask"):
        first(t(x))
