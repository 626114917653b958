"""The parts of the port's edge- and node-partitioned paths against the JAX
package's, on the CPU.

  * the node-partition plan array for array at 2, 3 and 4 ranks, on a graph
    of 53 nodes (a multiple of none) with masked edges; ``shard_edges``,
    ``pad_node_rows`` and the plan's halo and psum bytes equal;
  * the models' ``edge_axis`` and ``aggregate_fn`` add no parameter and no
    buffer: the state_dict keys are those of a plain model, and
    ``utils.convert`` carries a JAX-shaped tree (the JAX model's leaves and
    shapes) into either unchanged;
  * on two gloo ranks (``tests/torch_dp_helpers.py``, started once for the
    module): ``DataAxis.all_to_all`` forward and backward against a hand
    permutation, on its native route (gloo on CPU tensors);
    ``gin_aggregate_coo(edge_axis=)``, ``edge_partitioned_aggregate`` and
    ``node_partitioned_aggregate`` (output, and the gradients of
    ``sum(out * w)`` in h and eps) against JAX's ``edge_partitioned_aggregate``
    and ``node_partitioned_aggregate`` on a 2-device CPU mesh.

Tolerances: the JAX package's for its sharded aggregates
(``tests/test_edge_partitioned_model.py``: 2e-4 forward, 1e-3 / 1e-5
gradients); the plan and the permutation exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.parallel import edge_partition as jax_edge
from gnn_pretraining_tpu.parallel import node_partition as jax_node
from gnn_pretraining_tpu.parallel.mesh import make_mesh as jax_mesh
from gnn_pretraining_tpu_torch.finetune.node_parallel import HaloAggregate
from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.parallel import edge_partition, node_partition
from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis
from gnn_pretraining_tpu_torch.utils.convert import load_variables, model_variables
from torch_dp_helpers import RANKS, run_ranks

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def graph(n=53, e=211, f=16, masked=17, seed=0):
    rng = np.random.default_rng(seed)
    edge_mask = np.ones(e, np.float32)
    edge_mask[rng.choice(e, masked, replace=False)] = 0.0
    return {"senders": rng.integers(0, n, e).astype(np.int32),
            "receivers": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": edge_mask,
            "h": rng.normal(size=(n, f)).astype(np.float32),
            "w": rng.normal(size=(n, f)).astype(np.float32),
            "eps": np.float32(0.3)}


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_plan_shards_and_bytes_equal_jax(n_dev):
    g = graph()
    edges = (g["senders"], g["receivers"], g["edge_mask"])
    want = jax_node.build_node_partition_plan(*edges, 53, n_dev)
    got = node_partition.build_node_partition_plan(*edges, 53, n_dev)
    for name in ("n_dev", "n_loc", "h_pad", "num_nodes"):
        assert getattr(got, name) == getattr(want, name), name
    for name in node_partition.PLAN_ARRAYS:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.halo_mask.sum() > 0 and got.loc_mask.sum() > 0
    assert got.loc_mask.sum() + got.halo_mask.sum() == g["edge_mask"].sum()
    for f in (16, 256):
        assert got.halo_bytes_per_layer(f) == want.halo_bytes_per_layer(f)
        assert got.psum_bytes_per_layer(f) == want.psum_bytes_per_layer(f)
    np.testing.assert_array_equal(node_partition.pad_node_rows(g["h"], got),
                                  jax_node.pad_node_rows(g["h"], want))
    for a, b in zip(edge_partition.shard_edges(*edges, n_dev),
                    jax_edge.shard_edges(*edges, n_dev)):
        assert a.dtype == b.dtype and len(a) % n_dev == 0
        np.testing.assert_array_equal(a, b)


def leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]]


def shape_leaves(tree):
    return [(jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def keys(tree):
    return sorted(k for k, _ in leaves(tree))


def test_partition_hooks_add_no_parameter_or_buffer():
    axis = DataAxis(device=torch.device("cpu"))
    plain = FinetuneGNN("Cora_LP", "coo", device="cpu")
    hooked = [FinetuneGNN("Cora_LP", "coo", device="cpu", edge_axis=axis),
              FinetuneGNN("Cora_LP", "coo", device="cpu", axis=axis,
                          aggregate_fn=HaloAggregate(axis))]
    jmodel = JaxFinetuneGNN(domain_name="Cora_LP", aggregation="coo")
    x = jnp.zeros((4, 1433))
    s = jnp.zeros(2, jnp.int32)
    # The JAX tree's shapes (traced, not computed); its values a third port
    # model's, so that neither side starts from the other's.
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), x, jnp.ones(4), False, senders=s, receivers=s,
        edge_mask=jnp.ones(2), score_senders=s, score_receivers=s))
    variables = model_variables(FinetuneGNN("Cora_LP", "coo", device="cpu",
                                            generator=torch.Generator().manual_seed(3)))
    assert [(k, v.shape) for k, v in sorted(leaves(variables))] == \
        [(k, v.shape) for k, v in sorted(shape_leaves(shapes))]
    want = load_variables(plain, variables).state_dict()
    for model in hooked:
        state = load_variables(model, variables).state_dict()
        assert list(state) == list(want)
        for k, v in want.items():
            assert torch.equal(state[k], v), k
        got = model_variables(model)
        assert keys(got) == keys(variables)
        for (_, a), (_, b) in zip(sorted(leaves(got)), sorted(leaves(variables))):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    g = graph()
    rng = np.random.default_rng(1)
    a2a = {"x": torch.stack([r * 100 + torch.arange(RANKS * 3 * 4.).view(RANKS * 3, 4)
                             for r in range(RANKS)]),
           "w": torch.from_numpy(rng.normal(size=(RANKS, RANKS * 3, 4)).astype(np.float32))}
    pad = edge_partition.shard_edges(g["senders"], g["receivers"], g["edge_mask"], RANKS)
    out = run_ranks(tmp_path_factory.mktemp("partition_parts"), "partition_parts",
                    {"graph": g, "a2a": a2a, "shard_edges": pad})
    return g, a2a, out


def jax_grads(fn, g, h, w):
    """JAX's ``fn(h, eps)`` and the gradients of ``sum(fn(h, eps) * w)``, in
    one jitted call."""
    def loss(h, eps):
        return jnp.sum(fn(h, eps) * w)

    both = jax.jit(lambda h, eps: (fn(h, eps), jax.grad(loss, argnums=(0, 1))(h, eps)))
    z, (dh, deps) = both(jnp.asarray(h), jnp.float32(g["eps"]))
    return np.asarray(z), np.asarray(dh), float(deps)


@pytest.fixture(scope="module")
def jax_edge_ref():
    g = graph()
    mesh = jax_mesh(n_data=1, n_edge=RANKS)
    pad = [jnp.asarray(a) for a in jax_edge.shard_edges(g["senders"], g["receivers"],
                                                         g["edge_mask"], RANKS)]
    return jax_grads(lambda h, eps: jax_edge.edge_partitioned_aggregate(mesh, h, *pad, eps),
                     g, g["h"], jnp.asarray(g["w"]))


def test_all_to_all_forward_and_backward(ranks):
    _, a2a, out = ranks
    x, w = a2a["x"], a2a["w"]
    block = lambda a, q: a[q * 3:(q + 1) * 3]  # noqa: E731
    for r, got in enumerate(out):
        a = got["a2a"]
        assert a["route"] == "native" and a["calls"] == {"native": 2}   # forward, backward
        # Rank r receives block r of every rank, rank-major.
        want = torch.cat([block(x[p], r) for p in range(RANKS)])
        assert torch.equal(a["y"], want)
        # The gradient of block q of rank r's input is rank q's weights on
        # the block it received from r.
        want_grad = torch.cat([block(w[q], r) for q in range(RANKS)])
        assert torch.equal(a["grad"], want_grad)


@pytest.mark.parametrize("route", ["coo", "edge"])
def test_edge_partitioned_aggregate_equals_jax(ranks, jax_edge_ref, route):
    _, _, out = ranks
    z, dh, deps = jax_edge_ref
    for got in out:
        np.testing.assert_allclose(got[route]["z"].numpy(), z, **FWD_TOL)
    # Each rank holds its own gradient of the replicated h: their sum is the
    # whole graph's (the all-reduce's backward sums the cotangents).
    np.testing.assert_allclose(sum(o[route]["dh"] for o in out).numpy() / RANKS, dh,
                               **GRAD_TOL)
    np.testing.assert_allclose(float(sum(o[route]["deps"] for o in out)) / RANKS, deps,
                               rtol=1e-3)


def test_node_partitioned_aggregate_equals_jax(ranks):
    g, _, out = ranks
    mesh = jax_mesh(n_data=1, n_edge=RANKS)
    plan = jax_node.build_node_partition_plan(g["senders"], g["receivers"], g["edge_mask"],
                                              53, RANKS)
    h, w = jax_node.pad_node_rows(g["h"], plan), jax_node.pad_node_rows(g["w"], plan)
    z, dh, deps = jax_grads(lambda h, eps: jax_node.node_partitioned_aggregate(
        mesh, h, plan, eps), g, h, jnp.asarray(w))
    n_loc = plan.n_loc
    for r, got in enumerate(out):
        rows = slice(r * n_loc, (r + 1) * n_loc)
        np.testing.assert_allclose(got["node"]["z"].numpy(), z[rows], **FWD_TOL)
        np.testing.assert_allclose(got["node"]["dh"].numpy(), dh[rows], **GRAD_TOL)
        assert got["node"]["calls"]["native"] == 2 + 2        # after the a2a test's two
    np.testing.assert_allclose(float(sum(o["node"]["deps"] for o in out)), deps, rtol=1e-3)
