"""Seeded synthetic stand-in stores for the pretrain and fine-tune domains.

Random graphs with the real datasets' layout (feature width, label range,
split names, graph properties for the pretrain domains), written from a numpy
seed at any size: the smoke script builds them at the datasets' real sizes,
the tests at toy sizes. They carry no signal worth learning; they exist so
that an entry point that reads ``processed_dir`` can be driven without the
datasets. The calibrated generators of the JAX package
(``data/synthetic.py`` there) are offline preprocessing and are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphStore
from gnn_pretraining_tpu_torch.data.properties import (
    compute_graph_properties,
    standardize_properties,
)

# (graphs, mean nodes, mean degree) of the pretrain datasets: the JAX
# package's TU_SPECS (data/synthetic.py:34-38, from the reference's README).
PRETRAIN_SIZES = {"MUTAG": (188, 17.9, 2.2), "PROTEINS": (1113, 39.1, 3.7),
                  "NCI1": (4110, 29.9, 2.2), "ENZYMES": (600, 32.6, 3.8)}


def _undirected_edges(rng, n: int, m: int) -> np.ndarray:
    """[2, 2m] edges without self loops, each followed later by its reverse."""
    u = rng.integers(0, n, m)
    v = (u + rng.integers(1, n, m)) % n
    return np.stack([np.concatenate([u, v]), np.concatenate([v, u])])


def synthetic_graph_store(domain: str, rng: np.random.Generator,
                          sizes: Sequence[int], avg_degree: float = 3.7
                          ) -> GraphStore:
    """A graph-classification store: one random graph per entry of ``sizes``,
    features clipped normals of the domain's width, labels uniform over its
    classes, an 80/10/10 train/val/test split in index order."""
    d = config.DOMAIN_DIMENSIONS[domain]
    edges = [_undirected_edges(rng, int(n), max(1, int(avg_degree * n / 2)))
             for n in sizes]
    node_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    edge_offsets = np.concatenate(
        [[0], np.cumsum([e.shape[1] for e in edges])]).astype(np.int64)
    g = len(sizes)
    n_eval = max(1, g // 10)
    index = np.arange(g, dtype=np.int64)
    splits = {"train": index[:g - 2 * n_eval], "val": index[g - 2 * n_eval:g - n_eval],
              "test": index[g - n_eval:]}
    feats = np.clip(rng.normal(size=(int(node_offsets[-1]), d)),
                    config.MIN_SCALE, config.MAX_SCALE).astype(np.float32)
    return GraphStore(name=domain, node_features=feats,
                      edge_index=np.concatenate(edges, 1).astype(np.int32),
                      node_offsets=node_offsets, edge_offsets=edge_offsets,
                      y=rng.integers(0, config.NUM_CLASSES.get(domain, 2), g).astype(np.int64),
                      splits=splits, meta={"source": "synthetic"})


def synthetic_pretrain_store(domain: str, rng: np.random.Generator,
                             num_graphs: int | None = None) -> GraphStore:
    """A pretrain store of ``domain``'s real size (``PRETRAIN_SIZES``; or
    ``num_graphs`` graphs): Poisson node counts (at least 3), the dataset's
    mean degree, graph properties z-scored on the train split. The split is
    the JAX preprocessing's: 80/10/10 for a fine-tune domain (ENZYMES),
    else a shuffled 90/10 train/val."""
    count, mean_nodes, degree = PRETRAIN_SIZES[domain]
    g = count if num_graphs is None else num_graphs
    store = synthetic_graph_store(domain, rng, np.maximum(3, rng.poisson(mean_nodes, g)),
                                  degree)
    if domain not in config.DOWNSTREAM_TUDATASETS:
        perm = rng.permutation(g).astype(np.int64)
        n_val = int(np.ceil(g * config.VAL_FRACTION))
        store.splits = {"train": np.sort(perm[n_val:]), "val": np.sort(perm[:n_val])}
    return attach_graph_properties(store)


def attach_graph_properties(store: GraphStore) -> GraphStore:
    """Set the store's 12 graph properties, z-scored on its train split."""
    props = np.stack([
        compute_graph_properties(store.edge_index[:, store.edge_offsets[i]:store.edge_offsets[i + 1]],
                                 int(store.node_offsets[i + 1] - store.node_offsets[i]))
        for i in range(store.num_graphs)])
    store.graph_properties = standardize_properties(props, store.splits["train"])
    return store


def synthetic_planetoid_stores(name: str, rng: np.random.Generator,
                               num_nodes: int, num_undirected_edges: int,
                               n_train: int, n_val: int, n_test: int,
                               words_per_node: int = 18) -> Dict[str, GraphStore]:
    """``{name}_NC`` and ``{name}_LP`` stores over one random graph.

    Features are row-normalised bags of words of the domain's width. The NC
    store splits nodes ``n_train``/``n_val``/``n_test``; the LP store splits
    the directed edges 80/10/10 with as many sampled non-edges as held-out
    edges, as the JAX package's preprocessing does."""
    d = config.DOMAIN_DIMENSIONS[f"{name}_NC"]
    c = config.NUM_CLASSES[f"{name}_NC"]
    x = (rng.random((num_nodes, d)) < words_per_node / d).astype(np.float32)
    x /= np.maximum(x.sum(1, keepdims=True), 1.0)
    edge_index = _undirected_edges(rng, num_nodes, num_undirected_edges)
    y = rng.integers(0, c, num_nodes).astype(np.int64)
    common = dict(node_features=x, edge_index=edge_index.astype(np.int32),
                  node_offsets=np.array([0, num_nodes], np.int64),
                  edge_offsets=np.array([0, edge_index.shape[1]], np.int64),
                  y=y, node_y=y, meta={"source": "synthetic"})

    order = rng.permutation(num_nodes).astype(np.int64)
    nc_splits = {"train": np.sort(order[:n_train]),
                 "val": np.sort(order[n_train:n_train + n_val]),
                 "test": np.sort(order[n_train + n_val:n_train + n_val + n_test])}

    e = edge_index.shape[1]
    num_val_test = int(e * config.VAL_TEST_FRACTION)
    num_val = int(num_val_test * config.VAL_TEST_SPLIT_RATIO)
    perm = rng.permutation(e)
    train_pos = edge_index[:, perm[num_val_test:]].astype(np.int64)
    held_out = edge_index[:, perm[:num_val_test]].astype(np.int64)
    # Non-edges w.r.t. the undirected train edges, by rejection in bulk.
    taken = np.zeros((num_nodes, num_nodes), bool)
    taken[train_pos[0], train_pos[1]] = True
    taken[train_pos[1], train_pos[0]] = True
    np.fill_diagonal(taken, True)
    neg = np.zeros((2, 0), np.int64)
    while neg.shape[1] < num_val_test:
        cand = rng.integers(0, num_nodes, (2, 2 * num_val_test + 8))
        neg = np.concatenate([neg, cand[:, ~taken[cand[0], cand[1]]]], axis=1)
    neg = neg[:, :num_val_test]
    lp_splits = {"train_pos": train_pos,
                 "val_pos": held_out[:, :num_val], "val_neg": neg[:, :num_val],
                 "test_pos": held_out[:, num_val:], "test_neg": neg[:, num_val:]}
    return {f"{name}_NC": GraphStore(name=f"{name}_NC", splits=nc_splits, **common),
            f"{name}_LP": GraphStore(name=f"{name}_LP", splits=lp_splits, **common)}
