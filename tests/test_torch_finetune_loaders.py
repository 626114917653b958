"""The fine-tune loaders and ``GraphStore.save`` against the JAX package's, on
the CPU: on one module store directory written by the JAX preprocessing,
the GC batches, the NC graph and node batches and the LP graph and edge
batches equal the JAX loaders' array for array, and a store saved by the
port reads back in both packages.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.data import batch as jax_batch
from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.data import setup as data_setup
from gnn_pretraining_tpu_torch.data import batch, loaders

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stores")
    data_setup.main(processed_dir=tmp, raw_dir=tmp / "raw", synthetic_scale=0.06,
                    only=["ENZYMES", "PTC_MR", "Cora"])
    return tmp


def assert_batches_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def test_graph_store_save_round_trips_through_both_packages(processed_dir, tmp_path):
    for name in ("ENZYMES", "Cora_LP"):
        store = batch.GraphStore.load(processed_dir / f"{name}.npz")
        store.save(tmp_path / f"{name}.npz")
        for loader in (batch.GraphStore.load, jax_batch.GraphStore.load):
            back = loader(tmp_path / f"{name}.npz")
            want = jax_batch.GraphStore.load(processed_dir / f"{name}.npz")
            assert back.name == want.name and back.meta == want.meta
            assert back.splits.keys() == want.splits.keys()
            for k in want.splits:
                np.testing.assert_array_equal(back.splits[k], want.splits[k])
            for f in ("node_features", "edge_index", "node_offsets", "edge_offsets",
                      "y", "graph_properties", "node_y"):
                a, b = getattr(back, f), getattr(want, f)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("domain,batch_size", [("ENZYMES", 8), ("PTC_MR", 32)])
@pytest.mark.parametrize("split", ["train", "val"])
def test_gc_loader_batches_equal_jax(processed_dir, domain, batch_size, split):
    want = jax_loaders.create_finetune_arrays(domain, split, batch_size, processed_dir)
    got = loaders.create_finetune_arrays(domain, split, batch_size, processed_dir)
    assert len(got.batches) == len(want.batches) > 0
    for g, w in zip(got.batches, want.batches):
        assert_batches_equal(g, w)


@pytest.mark.parametrize("batch_size", [-1, 5])
def test_nc_loader_equals_jax(processed_dir, batch_size):
    want = jax_loaders.create_finetune_arrays("Cora_NC", "train", batch_size, processed_dir)
    got = loaders.create_finetune_arrays("Cora_NC", "train", batch_size, processed_dir)
    assert_batches_equal(got.graph, want.graph)
    assert len(got.node_indices) == len(want.node_indices)
    for a, b in zip(got.node_indices + got.labels, want.node_indices + want.labels):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_lp_loader_equals_jax(processed_dir, split):
    """Unshuffled positives (train) or pos-then-neg (val/test), ragged tail
    padded with a validity mask; message passing over the train edges only."""
    want = jax_loaders.create_finetune_arrays("Cora_LP", split, 64, processed_dir)
    got = loaders.create_finetune_arrays("Cora_LP", split, 64, processed_dir)
    assert_batches_equal(got.graph, want.graph)
    np.testing.assert_array_equal(got.train_edges, want.train_edges)
    assert len(got.edges) == len(want.edges)
    for field in ("edges", "labels", "edge_mask"):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert got.edge_mask[-1].sum() < 64                      # the tail is ragged
    if split != "train":
        labels = np.concatenate(got.labels)[np.concatenate(got.edge_mask) > 0]
        assert (np.diff(labels) <= 0).all() and labels[0] == 1 and labels[-1] == 0
