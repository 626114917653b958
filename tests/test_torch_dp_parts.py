"""The parts of the port's data parallelism against the JAX package's, on the
CPU: two gloo ranks (``torch_dp_helpers``) against the JAX functions on the
whole input.

  * SyncBN (``MaskedBatchNorm(axis=...)``), each rank on its half of the
    rows, against JAX ``MaskedBatchNorm`` on all of them: the output, the
    gradients (each rank's rows; the scale and bias summed over the ranks)
    and the running statistics, which every rank updates alike;
  * the gathered NT-Xent (``ops/sddmm.nt_xent_loss(axis=...)``, and the
    tasks' ``_nt_xent``, which takes the K2 wrapper, its plain version on
    the CPU) against JAX ``nt_xent_loss`` on the concatenated rows: the loss
    on every rank, and each rank's gradient, n times its rows' share, as
    JAX's transpose of the gather gives it;
  * ``dp_pads``, ``shard_sampler_step`` (over two steps) and
    ``build_sharded_gc_batches``, array for array against JAX's from the
    same sampler state and store.

Tolerances are ``tests/test_sharding.py``'s: losses rtol 1e-4, gradients
rtol 2e-3 / atol 2e-5; outputs and statistics rtol 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.data import batch as jax_batch
from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.finetune import gc_data_parallel as jax_gc_dp
from gnn_pretraining_tpu.models.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from gnn_pretraining_tpu.ops.sddmm import nt_xent_loss as jax_nt_xent_loss
from gnn_pretraining_tpu.parallel import data_parallel as jax_dp
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.batch import GraphStore
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.finetune.gc_data_parallel import build_sharded_gc_batches
from gnn_pretraining_tpu_torch.parallel import data_parallel as dp
from torch_dp_helpers import RANKS, run_ranks

torch.set_num_threads(1)

GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
N, D = 48, 16                 # SyncBN rows, features
R, Z = 40, 32                 # NT-Xent pair rows, projection width
TEMPERATURE = 0.4
DOMAINS = ("MUTAG", "ENZYMES")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    mask = torch.from_numpy((rng.random(N) < 0.8).astype(np.float32))
    return {
        "bn": {"x": 3.0 + f32(N, D), "mask": mask, "w": f32(N, D),
               "weight": 1 + 0.1 * f32(D), "bias": 0.1 * f32(D),
               "running_mean": 0.2 * f32(D), "running_var": 1 + 0.1 * f32(D).abs()},
        "ntxent": {"z1": f32(R, Z), "z2": f32(R, Z),
                   "valid": torch.from_numpy((rng.random(R) < 0.8).astype(np.float32)),
                   "temperature": torch.tensor([TEMPERATURE])},
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("dp_parts"), "parts", inputs)


def halves(x):
    return np.split(np.asarray(x), RANKS)


@pytest.fixture(scope="module")
def jax_bn(inputs):
    bn = {k: jnp.asarray(v.numpy()) for k, v in inputs["bn"].items()}
    module = JaxMaskedBatchNorm(features=D)
    variables = {"params": {"scale": bn["weight"], "bias": bn["bias"]},
                 "batch_stats": {"mean": bn["running_mean"], "var": bn["running_var"]}}

    def loss(x, params):
        y, mut = module.apply({**variables, "params": params}, x, bn["mask"], True,
                              mutable=["batch_stats"])
        return jnp.sum(y * bn["w"]), (y, mut["batch_stats"])

    (_, (y, stats)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        bn["x"], variables["params"])
    return {"y": y, "stats": stats, "gx": gx, "gw": gp["scale"], "gb": gp["bias"]}


def test_sync_bn_output_is_the_whole_batchs(ranks, jax_bn):
    for r, want in enumerate(halves(jax_bn["y"])):
        np.testing.assert_allclose(ranks[r]["y"].numpy(), want, rtol=1e-5, atol=1e-6)


def test_sync_bn_gradients(ranks, jax_bn):
    for r, want in enumerate(halves(jax_bn["gx"])):
        np.testing.assert_allclose(ranks[r]["gx"].numpy(), want, **GRAD_TOL)
    for key in ("gw", "gb"):                     # each rank's share of the sum
        got = sum(out[key] for out in ranks).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_bn[key]), **GRAD_TOL)


def test_sync_bn_running_statistics_update_alike_on_every_rank(ranks, jax_bn, inputs):
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        assert torch.equal(ranks[0][name], ranks[1][name])
        np.testing.assert_allclose(ranks[0][name].numpy(), np.asarray(jax_bn["stats"][key]),
                                   rtol=1e-5)
        assert not torch.equal(ranks[0][name], inputs["bn"][name])


@pytest.fixture(scope="module")
def jax_ntxent(inputs):
    nt = {k: jnp.asarray(v.numpy()) for k, v in inputs["ntxent"].items()}

    def loss(z1, z2):
        loss_sum, rows = jax_nt_xent_loss(z1, z2, jnp.float32(TEMPERATURE), nt["valid"] > 0)
        return loss_sum, rows

    (loss_sum, rows), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        nt["z1"], nt["z2"])
    return {"loss_sum": float(loss_sum), "rows": float(rows), "g1": grads[0], "g2": grads[1]}


@pytest.mark.parametrize("route", ["plain", "task"])
def test_gathered_ntxent_loss_on_every_rank(ranks, jax_ntxent, route):
    for out in ranks:
        np.testing.assert_allclose(float(out[route]["loss_sum"]), jax_ntxent["loss_sum"],
                                   rtol=1e-4)
        assert float(out[route]["rows"]) == jax_ntxent["rows"]


@pytest.mark.parametrize("route", ["plain", "task"])
def test_gathered_ntxent_gradients_are_n_times_each_ranks_share(ranks, jax_ntxent, route):
    for key in ("g1", "g2"):
        for r, want in enumerate(halves(jax_ntxent[key])):
            np.testing.assert_allclose(ranks[r][route][key].numpy() / RANKS, want, **GRAD_TOL)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_stores")
    rng = np.random.default_rng(0)
    for domain in DOMAINS:
        synthetic_pretrain_store(domain, rng, num_graphs=45).save(tmp / f"{domain}.npz")
    return tmp


def assert_batches_equal(got, want):
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def test_dp_pads_and_sampler_shares_equal_jax(stores):
    jsampler = jax_loaders.create_pretrain_train_loader(DOMAINS, np.random.default_rng(5),
                                                        stores)
    pads = dp.dp_pads(loaders.create_pretrain_train_loader(
        DOMAINS, np.random.default_rng(5), stores), RANKS)
    jpads = jax_dp.dp_pads(jsampler, RANKS)
    assert pads == jpads
    samplers = [loaders.create_pretrain_train_loader(DOMAINS, np.random.default_rng(5),
                                                     stores) for _ in range(RANKS)]
    for _ in range(2):
        want = jax_dp.shard_sampler_step(jsampler, RANKS, jpads)
        for r, sampler in enumerate(samplers):      # each rank's own copy of the state
            got = dp.shard_sampler_step(sampler, RANKS, r, pads)
            assert sorted(got) == sorted(want)
            for d in got:
                assert_batches_equal(got[d], jax.tree.map(lambda x: x[r], want[d]))


@pytest.mark.parametrize("split,size", [("train", 8), ("test", 3)])
def test_sharded_gc_batches_equal_jax(stores, split, size):
    got = build_sharded_gc_batches(GraphStore.load(stores / "ENZYMES.npz"), split, size, RANKS)
    want = jax_gc_dp.build_sharded_gc_batches(
        jax_batch.GraphStore.load(stores / "ENZYMES.npz"), split, size, RANKS)
    assert len(got) == len(want) > 1
    for subs, stacked in zip(got, want):
        assert len(subs) == RANKS
        for r, sub in enumerate(subs):
            assert_batches_equal(sub, jax.tree.map(lambda x: x[r], stacked))
