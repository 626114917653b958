"""The port's modules against the JAX package's, weights carried across.

Each JAX module is initialised, its BN statistics and GIN eps moved off
their init values, and its variables carried into the port's module by
``utils.convert.variables_to_state_dict``. Then the same numpy-seeded
inputs go through both, and eval outputs must agree at rtol=1e-4,
atol=1e-5 (tests/test_model_parity.py:213-216). Graphs are small (<= 64
nodes); ``pallas`` runs the JAX kernel in interpret mode and the port's
plain version of K1.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config
from gnn_pretraining_tpu.models import finetune_model as jax_finetune
from gnn_pretraining_tpu.models import gnn as jax_gnn
from gnn_pretraining_tpu.models import heads as jax_heads
from gnn_pretraining_tpu.models import norm as jax_norm
from gnn_pretraining_tpu.ops.spmm import build_dense_adjacency as jax_adjacency
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu_torch.models import (
    FinetuneGNN,
    GINBackbone,
    GINLayer,
    MaskedBatchNorm,
    MLPHead,
    MLPLinkPredictor,
    PretrainableGNN,
)
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
N, N_VALID, E, E_VALID = 48, 40, 160, 140
KEY = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}


def perturb(variables, seed):
    """Move BN stats, BN affine params and GIN eps off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = jax.tree_util.keystr(path[-1:])
        v = np.asarray(v)
        if "'mean'" in name:
            return (0.2 * rng.normal(size=v.shape)).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        if "'scale'" in name:
            return (1 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        if "'eps'" in name:
            return np.float32(rng.uniform(-0.3, 0.3))
        return v

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(dict(variables)))


def port(module, variables):
    module.load_state_dict(variables_to_state_dict(variables))
    return module.eval()


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    g = {"x": rng.normal(size=(N, 21)).astype(np.float32),
         "h": rng.normal(size=(N, config.GNN_HIDDEN_DIM)).astype(np.float32),
         "node_mask": (np.arange(N) < N_VALID).astype(np.float32),
         "senders": rng.integers(0, N_VALID, E).astype(np.int32),
         "receivers": rng.integers(0, N_VALID, E).astype(np.int32),
         "edge_mask": (np.arange(E) < E_VALID).astype(np.float32),
         "node_graph": np.minimum(np.arange(N) // 12, 3).astype(np.int32)}
    g["node_graph"][N_VALID:] = 0
    return g


def jax_edges(g, aggregation):
    kw = {k: jnp.asarray(g[k]) for k in ("senders", "receivers", "edge_mask")}
    dtype = jnp.bfloat16 if aggregation == "pallas" else jnp.float32
    kw["adj"] = jax_adjacency(kw["senders"], kw["receivers"], kw["edge_mask"],
                              N, dtype=dtype)
    return kw


def torch_edges(g, aggregation):
    kw = {k: torch.from_numpy(g[k]) for k in ("senders", "receivers", "edge_mask")}
    dtype = torch.bfloat16 if aggregation == "pallas" else torch.float32
    kw["adj"] = build_dense_adjacency(kw["senders"], kw["receivers"],
                                      kw["edge_mask"], N, dtype=dtype)
    return kw


def test_masked_batch_norm_eval_and_train(graph):
    x, mask = graph["h"][:, :16] * 3 + 1, graph["node_mask"]
    bn = jax_norm.MaskedBatchNorm(16)
    variables = perturb(bn.init(KEY, jnp.asarray(x), jnp.asarray(mask), False), 1)
    tbn = port(MaskedBatchNorm(16, device="cpu"), variables)

    want = bn.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    got = tbn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)

    want, mutated = bn.apply(variables, jnp.asarray(x), jnp.asarray(mask), True,
                             mutable=["batch_stats"])
    got = tbn.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(np.abs(got.detach().numpy()[N_VALID:]).max()) == 0.0
    for leaf, buf in (("mean", tbn.running_mean), ("var", tbn.running_var)):
        np.testing.assert_allclose(buf.numpy(), mutated["batch_stats"][leaf],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aggregation", ["dense", "pallas"])
def test_gin_layer_and_backbone(graph, aggregation):
    h, mask = jnp.asarray(graph["h"]), jnp.asarray(graph["node_mask"])
    th, tmask = torch.from_numpy(graph["h"]), torch.from_numpy(graph["node_mask"])
    jkw, tkw = jax_edges(graph, aggregation), torch_edges(graph, aggregation)
    for jax_cls, torch_cls, seed in ((jax_gnn.GINLayer, GINLayer, 2),
                                     (jax_gnn.GINBackbone, GINBackbone, 3)):
        jmod = jax_cls(aggregation)
        variables = perturb(jmod.init(KEY, h, mask, False, **jkw), seed)
        tmod = port(torch_cls(aggregation, device="cpu"), variables)
        want = jmod.apply(variables, h, mask, False, **jkw)
        with torch.no_grad():
            got = tmod(th, tmask, **tkw)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=jax_cls.__name__)


def test_heads(graph):
    h = graph["h"]
    head = jax_heads.MLPHead((256, 128, 6))
    variables = head.init(KEY, jnp.asarray(h), False)
    got = port(MLPHead((256, 128, 6), device="cpu"), variables)(torch.from_numpy(h))
    np.testing.assert_allclose(got.detach().numpy(),
                               head.apply(variables, jnp.asarray(h), False),
                               rtol=RTOL, atol=ATOL)

    s, r = graph["senders"][:20], graph["receivers"][:20]
    lp = jax_heads.MLPLinkPredictor()
    variables = lp.init(KEY, jnp.asarray(h), jnp.asarray(s), jnp.asarray(r), False)
    tlp = port(MLPLinkPredictor(device="cpu"), variables)
    for logits in (False, True):
        want = lp.apply(variables, jnp.asarray(h), jnp.asarray(s), jnp.asarray(r),
                        False, return_logits=logits)
        got = tlp(torch.from_numpy(h), torch.from_numpy(s), torch.from_numpy(r),
                  return_logits=logits)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("domain", ["ENZYMES", "Cora_NC", "Cora_LP"])
def test_finetune_gnn(graph, domain):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, config.DOMAIN_DIMENSIONS[domain])).astype(np.float32)
    task = config.TASK_TYPES[domain]
    jextra, textra = {}, {}
    if task == "graph_classification":
        jextra = dict(node_graph=jnp.asarray(graph["node_graph"]), num_graphs=4)
        textra = dict(node_graph=torch.from_numpy(graph["node_graph"]), num_graphs=4)
    elif task == "link_prediction":
        s, r = graph["senders"][:24], graph["receivers"][::-1][:24].copy()
        jextra = dict(score_senders=jnp.asarray(s), score_receivers=jnp.asarray(r))
        textra = dict(score_senders=torch.from_numpy(s),
                      score_receivers=torch.from_numpy(r))
    mask = graph["node_mask"]
    init = jax_finetune.FinetuneGNN(domain, "coo").init(
        KEY, jnp.asarray(x), jnp.asarray(mask), False, **jax_edges(graph, "dense"),
        **jextra)
    variables = perturb(init, 5)
    for aggregation in ("dense", "pallas"):
        want = jax_finetune.FinetuneGNN(domain, aggregation).apply(
            variables, jnp.asarray(x), jnp.asarray(mask), False,
            **jax_edges(graph, aggregation), **jextra)
        tmod = port(FinetuneGNN(domain, aggregation, device="cpu"), variables)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x), torch.from_numpy(mask),
                       **torch_edges(graph, aggregation), **textra)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=aggregation)


def test_s5_variable_tree_round_trips_bit_for_bit():
    """The JAX package's whole scheme-s5 variable tree (the four encoders, the
    backbone, the per-domain heads of masking, node and graph contrast and
    graph properties, the shared link predictor and domain classifier, the
    mask token), filled with seeded values, into the port's PretrainableGNN
    (every key and shape, strictly) and back: bit for bit."""
    cfg = config.PretrainConfig("s5", 0)
    rng = np.random.default_rng(6)
    sample = {d: types.SimpleNamespace(
        x=np.zeros((8, config.DOMAIN_DIMENSIONS[d]), np.float32),
        node_mask=np.ones(8, np.float32), senders=np.arange(8, dtype=np.int32),
        receivers=np.roll(np.arange(8, dtype=np.int32), 1), edge_mask=np.ones(8, np.float32))
        for d in cfg.pretrain_domains}
    shapes = jax.eval_shape(lambda: jax_pretrain._init_model_impl(cfg, sample, "dense")[1])
    want = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    model = PretrainableGNN(cfg.pretrain_domains, cfg.active_tasks, "dense", device="cpu")
    model.load_state_dict(variables_to_state_dict(want))          # strict
    got = state_dict_to_variables(model.state_dict())
    assert set(got["params"]) == set(want["params"]) and len(want["params"]) == 24
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        g = flat_got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(k))
