"""Seeded synthetic datasets: the calibrated generators and the stand-in stores.

The calibrated generators are the port's own copy of the JAX package's
``data/synthetic.py``, call for call, so that the same seed gives the same
arrays: ``generate_tu_dataset`` and ``generate_planetoid`` make datasets with
the real ones' feature widths, class counts and size distributions, with
label-correlated features and homophilous edges, calibrated so that training
from scratch lands near the reference's accuracies. Offline preprocessing
(``data/setup.py``) uses them when the raw files are absent.

The stand-in stores (``synthetic_graph_store``, ``synthetic_pretrain_store``,
``synthetic_planetoid_stores``) are random graphs with the real datasets'
layout (feature width, label range, split names, graph properties for the
pretrain domains), written from a numpy seed at any size: the smoke script
builds them at the datasets' real sizes, the tests at toy sizes. They carry
no signal worth learning; they exist so that an entry point that reads
``processed_dir`` can be driven without running the preprocessing.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Sequence, Tuple

import numpy as np

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphStore
from gnn_pretraining_tpu_torch.data.properties import (
    compute_graph_properties,
    standardize_properties,
)


@dataclasses.dataclass(frozen=True)
class TUSpec:
    num_graphs: int
    avg_nodes: float
    avg_degree: float
    feat_dim: int
    num_onehot: int          # trailing one-hot label block width (0 = all one-hot)
    num_classes: int


# Approximate statistics of the real datasets (nodes/edges from the
# reference README table; feature layout from DOMAIN_DIMENSIONS).
TU_SPECS: Dict[str, TUSpec] = {
    "MUTAG": TUSpec(188, 17.9, 2.2, 7, 7, 2),
    "PROTEINS": TUSpec(1113, 39.1, 3.7, 4, 3, 2),
    "NCI1": TUSpec(4110, 29.9, 2.2, 37, 37, 2),
    "ENZYMES": TUSpec(600, 32.6, 3.8, 21, 3, 6),
    "PTC_MR": TUSpec(344, 14.3, 2.0, 18, 18, 2),
}

# (graphs, mean nodes, mean degree) of the pretrain datasets, for the
# stand-in stores: the counts and means of TU_SPECS.
PRETRAIN_SIZES = {name: (TU_SPECS[name].num_graphs, TU_SPECS[name].avg_nodes,
                         TU_SPECS[name].avg_degree)
                  for name in config.PRETRAIN_TUDATASETS}

# Class-signal strength (multiplier on the class mean / one-hot logit
# signatures). Calibrated so that the from-scratch full fine-tuning baseline
# (b1) lands near the reference's measured b1 accuracies (BASELINE.md:18-27,
# e.g. ENZYMES 0.667, PTC_MR 0.505) instead of saturating at 1.0 — otherwise
# every cell of the 324-run sweep would be degenerate and scheme comparisons
# meaningless. Pretrain-only domains (MUTAG/PROTEINS/NCI1) keep a stronger
# signal; their graph labels never enter the tables.
TU_SIGNAL: Dict[str, float] = {
    "MUTAG": 0.5,
    "PROTEINS": 0.35,
    "NCI1": 0.3,
    "ENZYMES": 0.10,
    "PTC_MR": 0.06,
}

# Planetoid difficulty. Two failure modes were measured on this generator:
# hard features (large vocab / high mix) give *delayed* generalization — val
# accuracy sits at chance for ~100 steps after train loss converges, and the
# reference's patience-based early stopping kills every run just before the
# transition; noisy TRAIN labels stop the 140-label training set from
# learning at all. So: features stay easy (small class vocabulary, low
# global-word mix → val tracks train immediately, like real citation
# graphs), and the observed accuracy ceiling is set by flipping VAL/TEST
# labels only, mirroring real data's high Bayes error at evaluation.
# observed acc ≈ a·(1 − flip·(1 − 1/C)) for true-class accuracy a≈0.93,
# calibrated to the reference's b1 accuracies (Cora_NC 0.536, CiteSeer_NC
# 0.453 — BASELINE.md:18-21).
PLANETOID_WPC: Dict[str, int] = {
    "Cora": 16,
    "CiteSeer": 16,
}
PLANETOID_MIX: Dict[str, float] = {
    "Cora": 0.25,
    "CiteSeer": 0.3,
}
PLANETOID_FLIP: Dict[str, float] = {
    "Cora": 0.50,
    "CiteSeer": 0.62,
}

PLANETOID_SPECS: Dict[str, Tuple[int, int, int, int]] = {
    # name: (num_nodes, num_undirected_edges, feat_dim, num_classes)
    "Cora": (2708, 5278, 1433, 7),
    "CiteSeer": (3327, 4552, 3703, 6),
}


def _random_connected_graph(rng: np.random.Generator, n: int, avg_degree: float) -> np.ndarray:
    """Random graph with a spanning chain + extra edges; returns directed COO
    [2, 2*E_und] with both directions (PyG undirected convention)."""
    edges = {(i, i + 1) for i in range(n - 1)}
    target = max(n - 1, int(round(n * avg_degree / 2)))
    max_tries = 20 * target
    tries = 0
    while len(edges) < target and tries < max_tries:
        u, v = rng.integers(0, n, 2)
        tries += 1
        if u == v:
            continue
        a, b = (int(u), int(v)) if u < v else (int(v), int(u))
        edges.add((a, b))
    und = np.array(sorted(edges), np.int64).T
    return np.concatenate([und, und[::-1]], axis=1)


def _smooth_features(feats: np.ndarray, ei: np.ndarray, n: int,
                     homophily: float, rounds: int = 2) -> np.ndarray:
    """Mix each node's features with its neighbor mean: after ``rounds`` of
    ``x ← (1−h)·x + h·mean_nbr(x)`` a node's features become predictable from
    its neighborhood, as in real TU data (a node's chemical/structural type
    correlates with its neighbors'). The default generator draws node
    features iid given the graph label — adequate for classification
    calibration but degenerate for *node feature masking*: the masked node's
    identity carries no neighborhood signal, so NFM's only attainable target
    is the batch mean (see analysis/results/nfm_probe.md)."""
    deg = np.bincount(ei[1], minlength=n).astype(np.float32)
    deg = np.maximum(deg, 1.0)[:, None]
    x = feats.astype(np.float64)
    for _ in range(rounds):
        nbr_sum = np.zeros_like(x)
        np.add.at(nbr_sum, ei[1], x[ei[0]])
        x = (1.0 - homophily) * x + homophily * nbr_sum / deg
    return x.astype(np.float32)


def generate_tu_dataset(name: str, seed: int = 0, scale: float = 1.0,
                        homophily: float = 0.0):
    """Generate a TU-like dataset.

    Returns (node_features, edge_index(local, [2, sumE]), node_offsets,
    edge_offsets, graph_labels) — the ``parsers.parse_tu_dataset`` contract.
    ``homophily > 0`` smooths node features over the graph so they are
    neighbor-predictable (an alternative calibration for probing
    NFM-transfer sensitivity to the stand-in data).
    """
    spec = TU_SPECS[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()))
    g = max(10, int(spec.num_graphs * scale))

    num_cont = spec.feat_dim - spec.num_onehot
    # Per-class signatures drive both one-hot-label distribution and the
    # continuous block, making graph labels learnable from features. The
    # TU_SIGNAL multiplier controls how far apart the class signatures are
    # relative to the per-node N(0,1) noise (see comment above).
    sig = TU_SIGNAL[name]
    class_logits = sig * rng.normal(size=(spec.num_classes,
                                          max(spec.num_onehot, 1)))
    class_means = sig * rng.normal(size=(spec.num_classes, max(num_cont, 1)))

    xs, eis, labels = [], [], []
    node_offsets = [0]
    edge_offsets = [0]
    # Balanced, shuffled labels so stratified splits work at any scale.
    label_seq = rng.permutation(np.arange(g) % spec.num_classes)
    for gi in range(g):
        n = max(3, int(rng.poisson(spec.avg_nodes)))
        y = int(label_seq[gi])
        ei = _random_connected_graph(rng, n, spec.avg_degree)

        feats = np.zeros((n, spec.feat_dim), np.float32)
        if spec.num_onehot > 0:
            p = np.exp(class_logits[y])
            p /= p.sum()
            node_label = rng.choice(spec.num_onehot, size=n, p=p)
            feats[np.arange(n), num_cont + node_label] = 1.0
        if num_cont > 0:
            feats[:, :num_cont] = (class_means[y, :num_cont]
                                   + rng.normal(size=(n, num_cont))).astype(np.float32)
        if homophily > 0.0:
            feats = _smooth_features(feats, ei, n, homophily)

        xs.append(feats)
        eis.append(ei)
        labels.append(y)
        node_offsets.append(node_offsets[-1] + n)
        edge_offsets.append(edge_offsets[-1] + ei.shape[1])

    return (np.concatenate(xs, 0).astype(np.float32),
            np.concatenate(eis, 1).astype(np.int32),
            np.array(node_offsets, np.int64),
            np.array(edge_offsets, np.int64),
            np.array(labels, np.int64))


def generate_planetoid(name: str, seed: int = 0, scale: float = 1.0):
    """Generate a Planetoid-like citation graph (``parsers.parse_planetoid``
    contract: dict with x, y, edge_index, train/val/test masks)."""
    n0, e0, d, c = PLANETOID_SPECS[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()))
    n = max(60, int(n0 * scale))
    e_und = max(n, int(e0 * scale))

    y = rng.integers(0, c, n).astype(np.int64)

    # Homophilous edges: 80% same-class endpoint pairs.
    edges = set()
    by_class = [np.where(y == k)[0] for k in range(c)]
    while len(edges) < e_und:
        if rng.random() < 0.8:
            k = int(rng.integers(0, c))
            pool = by_class[k]
            if len(pool) < 2:
                continue
            u, v = rng.choice(pool, 2, replace=False)
        else:
            u, v = rng.integers(0, n, 2)
        if u == v:
            continue
        a, b = (int(u), int(v)) if u < v else (int(v), int(u))
        edges.add((a, b))
    und = np.array(sorted(edges), np.int64).T
    edge_index = np.concatenate([und, und[::-1]], axis=1).astype(np.int32)

    # Sparse bag-of-words features with class-specific active vocabulary,
    # row-normalized like the reference's NormalizeFeatures transform
    # (src/data/data_setup.py:154). Each active word comes from the global
    # vocabulary with probability PLANETOID_MIX (class-uninformative) and from
    # the class vocabulary otherwise — the mix ratio sets the task difficulty
    # (see comment above).
    mix = PLANETOID_MIX[name]
    words_per_class = PLANETOID_WPC[name]
    vocab = [rng.choice(d, words_per_class, replace=False) for _ in range(c)]
    x = np.zeros((n, d), np.float32)
    for i in range(n):
        k_active = int(rng.integers(5, 25))
        n_noise = rng.binomial(k_active, mix)
        n_own = min(k_active - n_noise, words_per_class)
        own = rng.choice(vocab[y[i]], n_own, replace=False)
        noise = rng.choice(d, max(1, n_noise), replace=False)
        x[i, own] = 1.0
        x[i, noise] = 1.0
    row_sum = x.sum(axis=1, keepdims=True)
    x = x / np.maximum(row_sum, 1.0)

    # Public-split-shaped masks: 20·C train, 500 val, 1000 test (scaled).
    train_n = min(20 * c, n // 4)
    val_n = min(500, max(n // 6, 10))
    test_n = min(1000, max(n // 3, 10))
    perm = rng.permutation(n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:train_n]] = True
    val_mask[perm[train_n:train_n + val_n]] = True
    test_mask[perm[train_n + val_n:train_n + val_n + test_n]] = True

    # Observed labels: uniform flips on the VAL/TEST nodes only set the
    # evaluation accuracy ceiling (see PLANETOID_FLIP above); train labels
    # stay clean so the 20-per-class supervision remains learnable. Edges
    # and features derive from the TRUE labels, so homophily and vocabulary
    # signal stay intact.
    flip = PLANETOID_FLIP[name]
    flip_mask = (rng.random(n) < flip) & ~train_mask
    y_obs = np.where(flip_mask, rng.integers(0, c, n), y)

    return {"x": x, "y": y_obs, "edge_index": edge_index,
            "train_mask": train_mask, "val_mask": val_mask, "test_mask": test_mask}


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
