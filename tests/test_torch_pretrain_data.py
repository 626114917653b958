"""The pretraining data path against the JAX package's, on the CPU:
``masked_randperm_select`` and the augmented views given the JAX side's
uniform draws (and their invariants), the balanced multi-domain sampler
and the val loader (array for array, one seed), the stand-in pretrain
stores' splits and the numpy graph properties against the networkx ones,
and the per-epoch evaluation's means and balanced total. Tolerances: f32
rounding (rtol 1e-6) where both sides compute the same expression, exact
where the result is integral or boolean. The update parts (schedulers,
balancer, PCGrad, optimizer, clipping) are in ``test_torch_pretrain_parts.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.data.batch import GraphStore as JaxGraphStore
from gnn_pretraining_tpu.data.properties import compute_graph_properties as nx_properties
from gnn_pretraining_tpu.ops.sampling import masked_randperm_select as jax_select
from gnn_pretraining_tpu.pretrain import augmentations as jax_aug
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.properties import compute_graph_properties
from gnn_pretraining_tpu_torch.data.synthetic import _undirected_edges, synthetic_pretrain_store
from gnn_pretraining_tpu_torch.ops.sampling import masked_randperm_select
from gnn_pretraining_tpu_torch.pretrain import augmentations as aug
from test_torch_pretrain_parts import t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pretrain_stores")
    rng = np.random.default_rng(3)
    for domain, graphs in (("MUTAG", 40), ("PROTEINS", 30), ("ENZYMES", 50)):
        synthetic_pretrain_store(domain, rng, num_graphs=graphs).save(tmp / f"{domain}.npz")
    return tmp


def test_masked_randperm_select_matches_jax():
    rng = np.random.default_rng(6)
    groups = np.repeat(np.arange(5), [4, 9, 1, 6, 3]).astype(np.int32)
    groups = np.concatenate([groups, np.zeros(7, np.int32)])
    mask = np.concatenate([np.ones(23), np.zeros(7)]).astype(np.float32)
    num = np.array([1, 3, 0, 6, 2], np.int32)
    select = jax.jit(jax_select)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(select(key, jnp.asarray(groups), jnp.asarray(mask),
                                 jnp.asarray(num)))
        scores = t(jax.random.uniform(key, (groups.size,)))
        got = masked_randperm_select(t(groups), t(mask), t(num), scores=scores).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.array_equal(np.bincount(groups[got], minlength=5), num)
    drawn = masked_randperm_select(t(groups), t(mask), t(num),
                                   generator=torch.Generator().manual_seed(0))
    assert np.array_equal(np.bincount(groups[drawn.numpy()], minlength=5), num)


def jax_draws(key, batch):
    """The uniform draws ``augment_view`` makes from ``key`` (its own splits)."""
    k_node, k_egate, k_edrop, k_agate, k_acols = jax.random.split(key, 5)
    g, d = batch.num_graphs, batch.x.shape[1]
    u = jax.random.uniform
    return aug.Draws(*(t(x) for x in (u(k_node, (batch.num_nodes,)), u(k_egate, (g,)),
                                      u(k_edrop, (batch.num_edges,)), u(k_agate, (g,)),
                                      u(k_acols, (g, d)))))


@pytest.fixture
def samplers(processed_dir):
    """A JAX and a port sampler over the same stores, from the same seed."""
    domains = ("MUTAG", "PROTEINS", "ENZYMES")
    jax_stores = {d: JaxGraphStore.load(processed_dir / f"{d}.npz") for d in domains}
    return (jax_loaders.BalancedMultiDomainSampler(jax_stores, np.random.default_rng(11)),
            loaders.create_pretrain_train_loader(domains, np.random.default_rng(11),
                                                 processed_dir))


def test_views_match_jax_given_its_draws(samplers):
    jsampler, sampler = samplers
    jbatch = jsampler.sample_step()["ENZYMES"]
    batch = sampler.sample_step()["ENZYMES"]
    augment_view = jax.jit(jax_aug.augment_view)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = augment_view(key, jbatch)
        got = aug.augment_view(batch, draws=jax_draws(key, jbatch))
        np.testing.assert_array_equal(got.node_keep.numpy(), np.asarray(want.node_keep))
        np.testing.assert_array_equal(got.edge_keep.numpy(), np.asarray(want.edge_keep))
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


def test_view_invariants(samplers):
    _, sampler = samplers
    batch = sampler.sample_step()["PROTEINS"]
    gen = torch.Generator().manual_seed(1)
    v1, v2, common = aug.create_two_views(batch, gen)
    for v in (v1, v2):
        keep, valid = v.node_keep.bool(), batch.node_mask.bool()
        assert not (keep & ~valid).any()
        dropped = np.bincount(batch.node_graph[valid & ~keep].numpy(),
                              minlength=batch.num_graphs)
        n = batch.n_node.numpy()
        np.testing.assert_array_equal(dropped, np.where(n >= 3, np.maximum(1, (n * 0.2).astype(int)), 0))
        e = v.edge_keep.bool()
        assert keep[batch.senders[e].long()].all() and keep[batch.receivers[e].long()].all()
        masked = (v.x == 0) & (batch.x != 0)
        assert not masked[~valid].any()
    assert torch.equal(common, v1.node_keep * v2.node_keep)
    assert not torch.equal(v1.node_keep, v2.node_keep)             # independent draws
    source = aug.ViewSource(seed=1)
    again = source.two_views(batch)
    assert torch.equal(again[2], common)                           # seeded: repeatable
    source.inject([(v2, v1, common)])
    assert source.two_views(batch)[0] is v2


def test_sampler_and_val_loader_equal_jax(samplers, processed_dir):
    jsampler, sampler = samplers
    assert len(sampler) == len(jsampler) and sampler.pads == jsampler.pads
    for _ in range(3):
        want, got = jsampler.sample_step(), sampler.sample_step()
        assert list(got) == list(want)
        for d in want:
            for field in ("x", "senders", "receivers", "edge_mask", "edge_graph", "node_mask",
                          "node_graph", "graph_mask", "node_start", "n_node", "n_edge", "y",
                          "graph_properties"):
                np.testing.assert_array_equal(getattr(got[d], field).numpy(),
                                              np.asarray(getattr(want[d], field)),
                                              err_msg=f"{d}.{field}")
    for d in ("MUTAG", "ENZYMES"):
        want = jax_loaders.create_pretrain_val_loader(d, processed_dir=processed_dir)
        got = loaders.create_pretrain_val_loader(d, processed_dir=processed_dir)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.x.numpy(), np.asarray(w.x))
            np.testing.assert_array_equal(g.graph_properties.numpy(),
                                          np.asarray(w.graph_properties))


def test_graph_properties_match_networkx():
    rng = np.random.default_rng(7)
    for i in range(40):
        n = int(rng.integers(1, 30))
        ei = (_undirected_edges(rng, n, int(rng.integers(0, 3 * n))) if n > 1
              else np.zeros((2, 0), np.int64))
        if i % 3 == 0:
            ei = ei[:, (ei[0] < n // 2) & (ei[1] < n // 2)]         # several components
        np.testing.assert_allclose(compute_graph_properties(ei, n), nx_properties(ei, n),
                                   rtol=1e-5, atol=1e-6)


def test_pretrain_store_split_and_properties(processed_dir):
    store = synthetic_pretrain_store("NCI1", np.random.default_rng(8), num_graphs=60)
    assert {k: len(v) for k, v in store.splits.items()} == {"train": 54, "val": 6}
    train = store.graph_properties[store.splits["train"]]
    np.testing.assert_allclose(train.mean(0), 0.0, atol=1e-5)
    enz = loaders.GraphStore.load(processed_dir / "ENZYMES.npz")
    assert {k: len(v) for k, v in enz.splits.items()} == {"train": 40, "val": 5, "test": 5}


class _Logger:
    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((dict(metrics), step))


@pytest.mark.parametrize("balancer_step", [0, 150])
def test_run_evaluation_matches_jax(balancer_step):
    """Batch means per (task, domain), domain means per task, the balanced
    total and the balancer count, with domains of unequal batch counts."""
    from types import SimpleNamespace

    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt

    rng = np.random.default_rng(9)
    losses = {(task, d): rng.uniform(0.5, 3.0, n).astype(np.float32)
              for task in ("node_contrast", "graph_contrast")
              for d, n in (("MUTAG", 1), ("NCI1", 3))}
    val = {"MUTAG": [0], "NCI1": [0, 1, 2]}
    cfg = config.PretrainConfig("s2", 0)
    jlog, log = _Logger(), _Logger()
    want = jax_pretrain.run_evaluation(
        lambda p, s, task, d, b, k, step: jnp.float32(losses[(task, d)][b]),
        SimpleNamespace(params=None, batch_stats=None, opt_step=0,
                        balancer_step=balancer_step),
        cfg, val, jax.random.PRNGKey(0), 1, jlog, 5)
    got = pt.run_evaluation(lambda task, d, b, step: torch.tensor(losses[(task, d)][b]),
                            pt.PretrainState(balancer_step=balancer_step),
                            cfg, val, log, 5)
    assert got[2] == want[2] == balancer_step + 1
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-6, err_msg=k)
    assert log.rows[0][1] == jlog.rows[0][1] == 5
