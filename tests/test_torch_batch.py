"""The port's graph store reader and build_batch against the JAX package's.

A store written by the JAX ``GraphStore.save`` is read back by the port's
``GraphStore.load``; both packages then build padded batches of the same
graphs, which must be equal array by array (dtype included).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.data import batch as jax_batch
from gnn_pretraining_tpu_torch.data import batch as torch_batch

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    rng = np.random.default_rng(0)
    sizes = rng.integers(3, 12, 10)
    edges = [rng.integers(0, n, (2, 2 * n)) for n in sizes]
    store = jax_batch.GraphStore(
        name="toy",
        node_features=rng.normal(size=(int(sizes.sum()), 5)).astype(np.float32),
        edge_index=np.concatenate(edges, 1).astype(np.int32),
        node_offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        edge_offsets=np.concatenate([[0], np.cumsum([e.shape[1] for e in edges])]
                                    ).astype(np.int64),
        y=rng.integers(0, 3, 10).astype(np.int64),
        splits={"train": np.arange(7), "test": np.arange(7, 10)},
        graph_properties=rng.normal(size=(10, 12)).astype(np.float32),
        meta={"source": "synthetic", "scale": "1.0"})
    path = tmp_path_factory.mktemp("store") / "toy.npz"
    store.save(path)
    return path


def test_store_load_matches_jax(store_path):
    got = torch_batch.GraphStore.load(store_path)
    want = jax_batch.GraphStore.load(store_path)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("graphs", [[0, 3, 4, 9], [7], []], ids=str)
@pytest.mark.parametrize("with_properties", [False, True])
def test_build_batch_matches_jax(store_path, graphs, with_properties):
    store_t = torch_batch.GraphStore.load(store_path)
    store_j = jax_batch.GraphStore.load(store_path)
    got = torch_batch.build_batch(store_t, graphs, 64, 256, 6, with_properties)
    want = jax_batch.build_batch(store_j, graphs, 64, 256, 6, with_properties)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert isinstance(a, torch.Tensor), f.name
        assert a.numpy().dtype == b.dtype, f.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
    assert got.to("cpu").num_nodes == 64 and got.num_edges == 256


def test_build_batch_rejects_overflow(store_path):
    store = torch_batch.GraphStore.load(store_path)
    with pytest.raises(ValueError, match="exceeds padding"):
        torch_batch.build_batch(store, range(10), 16, 256, 10)
    with pytest.raises(ValueError, match="g_pad"):
        torch_batch.build_batch(store, range(10), 256, 512, 4)
