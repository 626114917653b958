"""Readers of the raw dataset formats, in numpy.

The port's own copy of ``gnn_pretraining_tpu/data/parsers.py``: the same
readers of the public on-disk formats, so that preprocessing needs neither
torch-geometric nor the JAX package, and gives the same arrays.

  * TU Dortmund format: ``<DS>_A.txt`` (1-based global edge list),
    ``<DS>_graph_indicator.txt``, ``<DS>_graph_labels.txt`` and optional
    ``<DS>_node_labels.txt`` / ``<DS>_node_attributes.txt``, flat under the
    raw directory or nested as PyG writes them (``<root>/<DS>/raw/``). Like
    PyG's ``use_node_attr=True`` reader, node features are
    ``[attributes ‖ one-hot(node_label)]``; self-loops and duplicate edges
    are removed; graph labels become 0-based.
  * Planetoid format: ``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}``
    (pickled scipy matrices and an adjacency dict), with the standard public
    split masks.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Tuple

import numpy as np


def _coalesce_edges(edge_index: np.ndarray) -> np.ndarray:
    """Sort and deduplicate edges, dropping self-loops (PyG read_tu_data)."""
    if edge_index.size == 0:
        return edge_index.reshape(2, 0)
    mask = edge_index[0] != edge_index[1]
    edge_index = edge_index[:, mask]
    keys = edge_index[0].astype(np.int64) * (edge_index.max() + 1) + edge_index[1]
    order = np.argsort(keys, kind="stable")
    edge_index = edge_index[:, order]
    keys = keys[order]
    keep = np.concatenate([[True], keys[1:] != keys[:-1]])
    return edge_index[:, keep]


def parse_tu_dataset(raw_dir: Path, name: str) -> Tuple[np.ndarray, np.ndarray,
                                                        np.ndarray, np.ndarray,
                                                        np.ndarray]:
    """Parse a TU dataset directory.

    Returns (node_features [sumN, D] f32, edge_index [2, sumE] i32
    per-graph-local, node_offsets [G+1] i64, edge_offsets [G+1] i64,
    graph_labels [G] i64). Raises ``FileNotFoundError`` when neither layout
    holds the files.
    """
    d = Path(raw_dir)
    prefix = d / name
    if not Path(f"{prefix}_A.txt").exists():
        alt = d / name / "raw" / name
        if Path(f"{alt}_A.txt").exists():
            prefix = alt
        else:
            raise FileNotFoundError(f"TU raw files for {name} not found under {raw_dir}")

    edges = np.loadtxt(f"{prefix}_A.txt", delimiter=",", dtype=np.int64).T - 1
    graph_indicator = np.loadtxt(f"{prefix}_graph_indicator.txt", dtype=np.int64) - 1
    graph_labels = np.loadtxt(f"{prefix}_graph_labels.txt", dtype=np.int64)
    # 0-based contiguous labels (PyG maps {-1, 1} to {0, 1}).
    graph_labels = np.searchsorted(np.unique(graph_labels), graph_labels)

    num_nodes = graph_indicator.shape[0]
    num_graphs = int(graph_indicator.max()) + 1

    feats = []
    attr_path = Path(f"{prefix}_node_attributes.txt")
    if attr_path.exists():
        attrs = np.loadtxt(attr_path, delimiter=",", dtype=np.float32)
        if attrs.ndim == 1:
            attrs = attrs[:, None]
        feats.append(attrs)
    label_path = Path(f"{prefix}_node_labels.txt")
    if label_path.exists():
        node_labels = np.loadtxt(label_path, dtype=np.int64)
        uniq_nl = np.unique(node_labels)
        node_labels = np.searchsorted(uniq_nl, node_labels)
        onehot = np.zeros((num_nodes, len(uniq_nl)), np.float32)
        onehot[np.arange(num_nodes), node_labels] = 1.0
        feats.append(onehot)
    node_features = (np.concatenate(feats, axis=1) if feats
                     else np.zeros((num_nodes, 1), np.float32))

    # The format keeps each graph's nodes contiguous.
    counts = np.bincount(graph_indicator, minlength=num_graphs)
    node_offsets = np.zeros(num_graphs + 1, np.int64)
    node_offsets[1:] = np.cumsum(counts)

    # Group the edges by graph, then make them graph-local and coalesce.
    edge_graph = graph_indicator[edges[0]]
    order = np.argsort(edge_graph, kind="stable")
    edges = edges[:, order]
    edge_graph = edge_graph[order]
    bounds = np.zeros(num_graphs + 1, np.int64)
    bounds[1:] = np.cumsum(np.bincount(edge_graph, minlength=num_graphs))

    local_edges = [_coalesce_edges(edges[:, bounds[g]:bounds[g + 1]] - node_offsets[g])
                   for g in range(num_graphs)]
    edge_offsets = np.zeros(num_graphs + 1, np.int64)
    edge_offsets[1:] = np.cumsum([e.shape[1] for e in local_edges])
    edge_index = (np.concatenate(local_edges, axis=1) if local_edges
                  else np.zeros((2, 0), np.int64))

    return (node_features.astype(np.float32), edge_index.astype(np.int32),
            node_offsets, edge_offsets, graph_labels.astype(np.int64))


def _load_planetoid_file(path: Path):
    # The files are Python 2 pickles of scipy sparse matrices, numpy arrays
    # and a dict of lists.
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def parse_planetoid(raw_dir: Path, name: str) -> Dict[str, np.ndarray]:
    """Parse a Planetoid dataset (Cora/CiteSeer).

    Returns a dict with ``x`` [N, D] f32, ``y`` [N] i64, ``edge_index``
    [2, E] i32 (undirected, coalesced, no self-loops), and the standard
    public split masks ``train_mask``/``val_mask``/``test_mask``.
    """
    d = Path(raw_dir)
    lname = name.lower()
    base = d
    if not (d / f"ind.{lname}.x").exists():
        alt = d / name / "raw"
        if (alt / f"ind.{lname}.x").exists():
            base = alt
        else:
            raise FileNotFoundError(f"Planetoid raw files for {name} not found under {raw_dir}")

    objs = {k: _load_planetoid_file(base / f"ind.{lname}.{k}")
            for k in ("x", "tx", "allx", "y", "ty", "ally", "graph")}
    test_idx = np.loadtxt(base / f"ind.{lname}.test.index", dtype=np.int64)

    allx = np.asarray(objs["allx"].todense(), np.float32)
    tx = np.asarray(objs["tx"].todense(), np.float32)
    ally = np.asarray(objs["ally"], np.float32)
    ty = np.asarray(objs["ty"], np.float32)

    # Each tx/ty row goes to its node id: Cora's test indices are shuffled,
    # CiteSeer's have gaps (isolated test nodes keep all-zero features, as
    # PyG's tx extension gives them).
    n = max(int(test_idx.max()) + 1, allx.shape[0] + tx.shape[0])
    x = np.zeros((n, allx.shape[1]), np.float32)
    y_onehot = np.zeros((n, ally.shape[1]), np.float32)
    x[:allx.shape[0]] = allx
    y_onehot[:ally.shape[0]] = ally
    x[test_idx] = tx
    y_onehot[test_idx] = ty
    y = y_onehot.argmax(axis=1).astype(np.int64)
    rows, cols = [], []
    for src, nbrs in objs["graph"].items():
        for dst in nbrs:
            if src < n and dst < n:
                rows.append(src)
                cols.append(dst)
    edge_index = _coalesce_edges(np.array([rows + cols, cols + rows], np.int64))

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    num_train = int(np.asarray(objs["y"]).shape[0])
    train_mask[:num_train] = True
    val_mask[num_train:num_train + 500] = True
    test_mask[np.sort(test_idx)] = True

    return {"x": x, "y": y, "edge_index": edge_index.astype(np.int32),
            "train_mask": train_mask, "val_mask": val_mask, "test_mask": test_mask}
