"""The port's native batch builder (``csrc/batcher.cc``) on the CPU.

Built with g++ at first use into ``build/torch_host/``; for several index
lists (repeated graphs, one graph, none), with and without graph
properties, on a store with a label per graph and on one with node labels,
its arrays equal the port's numpy builder's and the JAX package's
``build_batch``'s bitwise, dtype included. It writes into the caller's
arrays (a row of the chunked runner's buffer), padding and all; it raises
as the numpy builder does where the graphs do not fit, and on an index
outside the store; a source that does not compile raises and leaves no
library in place.
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

PADS = (96, 320, 8)


def toy_store(node_labels: bool):
    rng = np.random.default_rng(3)
    sizes = rng.integers(3, 12, 12)
    edges = [rng.integers(0, n, (2, 2 * n)) for n in sizes]
    n = int(sizes.sum())
    return jax_batch.GraphStore(
        name="toy",
        node_features=rng.normal(size=(n, 7)).astype(np.float32),
        edge_index=np.concatenate(edges, 1).astype(np.int32),
        node_offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        edge_offsets=np.concatenate([[0], np.cumsum([e.shape[1] for e in edges])]
                                    ).astype(np.int64),
        y=rng.integers(0, 3, n if node_labels else 12).astype(np.int64),
        splits={"train": np.arange(9), "test": np.arange(9, 12)},
        graph_properties=rng.normal(size=(12, 12)).astype(np.float32),
        meta={"source": "synthetic"})


@pytest.fixture(scope="module", params=["graph_labels", "node_labels"])
def stores(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("batcher") / "toy.npz"
    toy_store(request.param == "node_labels").save(path)
    return torch_batch.GraphStore.load(path), jax_batch.GraphStore.load(path)


@pytest.mark.parametrize("graphs", [[0, 3, 3, 11, 5], [7], []], ids=str)
@pytest.mark.parametrize("with_properties", [False, True])
def test_native_equals_numpy_and_jax(stores, graphs, with_properties):
    store, jax_store = stores
    got = torch_batch.build_batch(store, graphs, *PADS, with_properties)
    plain = torch_batch.build_batch_numpy(store, graphs, *PADS, with_properties)
    want = jax_batch.build_batch(jax_store, graphs, *PADS, with_properties)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        c = getattr(plain, f.name).numpy()
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes() == c.tobytes(), f.name


def test_writes_into_the_callers_arrays_and_raises_like_numpy(stores):
    store, _ = stores
    row = np.full(4096, -1, np.int32)          # stale words where the batch goes
    out, offset = {}, 0
    for name, (shape, dtype) in store.batch_shapes(*PADS).items():
        n = int(np.prod(shape))
        out[name] = row[offset:offset + n].view(dtype).reshape(shape)
        offset += n
    torch_batch.build_batch_into(store, [2, 9], *PADS, True, out)
    want = torch_batch.build_batch_numpy(store, [2, 9], *PADS, True)
    for name, arr in out.items():
        assert arr.tobytes() == getattr(want, name).numpy().tobytes(), name
    assert (row[offset:] == -1).all()
    for build in (torch_batch.build_batch, torch_batch.build_batch_numpy):
        with pytest.raises(ValueError, match="exceeds padding"):
            build(store, range(12), 16, 320, 12)
        with pytest.raises(ValueError, match="g_pad"):
            build(store, range(10), 256, 1024, 4)
    with pytest.raises(IndexError):
        torch_batch.build_batch(store, [3, 12], *PADS)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "batcher.cc"
    bad.write_text("extern \"C\" int gnn_build_batch( { not C++ }\n")
    monkeypatch.setattr(torch_batch, "BATCHER_SOURCE", bad)
    with pytest.raises(RuntimeError, match="native batch builder failed"):
        torch_batch.build_batcher(tmp_path / "build")
    assert not list((tmp_path / "build").iterdir())
