"""The 12 structural graph-property targets, in numpy.

The port's own version of ``gnn_pretraining_tpu/data/properties.py``
(reference src/data/graph_properties.py:17-96), which computes them with
networkx; the card's machine has numpy and scipy only. Same definitions, on
the simple undirected graph (self loops and repeated edges removed): nodes,
edges, density, degree mean / variance / max, average clustering,
transitivity, connected components, diameter of the largest component,
degree assortativity (0 where the degrees do not vary), degree
centralization; z-scored with the train rows' mean and biased std, a
zero-variance column scaled by 1.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, shortest_path


def compute_graph_properties(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """12-dim property vector of one graph given its (local) edge_index."""
    n = int(num_nodes)
    ei = np.asarray(edge_index, np.int64).reshape(2, -1)
    adj = np.zeros((n, n), bool)
    loop = ei[0] == ei[1]
    adj[ei[0][~loop], ei[1][~loop]] = True
    adj |= adj.T
    deg = adj.sum(1).astype(np.float64)
    e = int(adj.sum()) // 2
    if n == 0:
        return np.zeros(12, np.float32)

    a = adj.astype(np.float64)
    triangles = ((a @ a) * a).sum(1) / 2.0          # triangles through each node
    pairs = deg * (deg - 1.0) / 2.0
    clustering = float(np.mean(np.where(pairs > 0, triangles / np.maximum(pairs, 1.0), 0.0)))
    transitivity = (float(triangles.sum() / pairs.sum())
                    if n > 2 and pairs.sum() > 0 else 0.0)

    graph = csr_matrix(a)
    num_components, labels = connected_components(graph, directed=False)
    largest = np.flatnonzero(labels == np.argmax(np.bincount(labels)))
    if largest.size > 1:
        dist = shortest_path(graph[largest][:, largest], directed=False, unweighted=True)
        diameter = float(dist.max())
    else:
        diameter = 0.0

    assortativity = 0.0
    if deg.var() > 0:
        u, v = np.nonzero(adj)
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.corrcoef(deg[u], deg[v])[0, 1]
        assortativity = float(r) if np.isfinite(r) else 0.0
    centralization = (float((deg.max() - deg).sum()) / ((n - 1) * (n - 2))
                      if n > 2 else 0.0)
    density = 2.0 * e / (n * (n - 1)) if n > 1 else 0.0
    return np.array([n, e, density, deg.mean(), deg.var(), deg.max(),
                     clustering, transitivity, num_components, diameter,
                     assortativity, centralization], np.float32)


def standardize_properties(all_props: np.ndarray, train_idx: np.ndarray) -> np.ndarray:
    """Z-score with mean/std fit on train rows; zero-std columns get scale 1."""
    train = all_props[train_idx]
    scale = train.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)
    return ((all_props - train.mean(axis=0)) / scale).astype(np.float32)
