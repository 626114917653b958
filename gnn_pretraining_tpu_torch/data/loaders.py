"""Loaders producing padded GraphBatches.

Port of ``gnn_pretraining_tpu/data/loaders.py``; all of it is numpy, so for
the same store and seed every batch equals the JAX package's array by array:

  * ``BalancedMultiDomainSampler``: each step samples ``BATCH_SIZE //
    num_domains`` graphs per domain with replacement; ``num_steps =
    max(len(train)) // samples_per_domain`` (reference
    src/data/pretrain_data_loaders.py:28-46); quantile pads, over-budget
    draws resampled;
  * the pretrain val loader: unshuffled batches of 32 (:56-65);
  * the fine-tune loaders: dispatch on task type, no shuffling, one fixed
    padded shape per loader (src/data/finetune_data_loaders.py:68-114).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import (
    GraphBatch,
    GraphStore,
    build_batch,
    round_up,
)


def _batch_pads(store: GraphStore, graph_indices: Sequence[int], batch_size: int
                ) -> Tuple[int, int]:
    """Fixed (n_pad, e_pad) covering every consecutive batch of the index list."""
    nn = np.diff(store.node_offsets)[graph_indices]
    ne = np.diff(store.edge_offsets)[graph_indices]
    max_n = max_e = 0
    for i in range(0, len(graph_indices), batch_size):
        max_n = max(max_n, int(nn[i:i + batch_size].sum()))
        max_e = max(max_e, int(ne[i:i + batch_size].sum()))
    return round_up(max(max_n, 1)), round_up(max(max_e, 1))


class BalancedMultiDomainSampler:
    """Per-step dict of one padded batch per domain, sampled with replacement."""

    def __init__(self, domain_stores: Dict[str, GraphStore],
                 rng: np.random.Generator,
                 batch_size: int = config.PRETRAIN_BATCH_SIZE):
        self.domain_stores = domain_stores
        self.rng = rng
        self.samples_per_domain = batch_size // len(domain_stores)
        self.train_indices = {d: np.asarray(s.splits["train"], np.int64)
                              for d, s in domain_stores.items()}
        # max(len(ds)) // samples_per_domain (:33), at least one step.
        self.num_steps = max(
            1, max(len(ix) for ix in self.train_indices.values())
            // self.samples_per_domain)
        # Pads: the largest graph + the 0.95 quantile for the other slots,
        # capped at the worst case; sample_step resamples a draw over budget.
        self.pads = {}
        self.graph_sizes = {}
        for d, s in domain_stores.items():
            ix = self.train_indices[d]
            all_nn, all_ne = np.diff(s.node_offsets), np.diff(s.edge_offsets)
            self.graph_sizes[d] = (all_nn, all_ne)
            nn, ne = all_nn[ix], all_ne[ix]
            spd = self.samples_per_domain
            n_pad = int(nn.max()) + int(np.ceil(np.quantile(nn, 0.95))) * (spd - 1)
            e_pad = int(ne.max()) + int(np.ceil(np.quantile(ne, 0.95))) * (spd - 1)
            self.pads[d] = (round_up(min(n_pad, int(nn.max()) * spd)),
                            round_up(max(min(e_pad, int(ne.max()) * spd), 1)))

    def __len__(self) -> int:
        return self.num_steps

    def __iter__(self) -> Iterator[Dict[str, GraphBatch]]:
        for _ in range(self.num_steps):
            yield self.sample_step()

    def sample_indices(self) -> Dict[str, np.ndarray]:
        """One step's draw: the graphs of each domain, without building."""
        out = {}
        for d in self.domain_stores:
            ix = self.train_indices[d]
            n_pad, e_pad = self.pads[d]
            nn, ne = self.graph_sizes[d]
            for _ in range(100):
                chosen = ix[self.rng.integers(0, len(ix), self.samples_per_domain)]
                if nn[chosen].sum() <= n_pad and ne[chosen].sum() <= e_pad:
                    break
            else:
                raise RuntimeError(
                    f"{d}: 100 consecutive draws exceeded the quantile pad "
                    f"budget (n_pad={n_pad}, e_pad={e_pad})")
            out[d] = chosen
        return out

    def sample_step(self) -> Dict[str, GraphBatch]:
        return {d: build_batch(self.domain_stores[d], chosen, *self.pads[d],
                               self.samples_per_domain, with_properties=True)
                for d, chosen in self.sample_indices().items()}


def create_pretrain_train_loader(domains: Sequence[str], rng: np.random.Generator,
                                 processed_dir=None) -> BalancedMultiDomainSampler:
    processed_dir = Path(processed_dir) if processed_dir else config.PROCESSED_DIR
    stores = {d: GraphStore.load(processed_dir / f"{d}.npz") for d in domains}
    return BalancedMultiDomainSampler(stores, rng)


def create_pretrain_val_loader(domain: str, processed_dir=None,
                               batch_size: int = config.PRETRAIN_BATCH_SIZE
                               ) -> List[GraphBatch]:
    """Unshuffled val batches with the graph properties attached."""
    processed_dir = Path(processed_dir) if processed_dir else config.PROCESSED_DIR
    store = GraphStore.load(processed_dir / f"{domain}.npz")
    idx = np.asarray(store.splits["val"], np.int64)
    n_pad, e_pad = _batch_pads(store, idx, batch_size)
    return [build_batch(store, idx[i:i + batch_size], n_pad, e_pad, batch_size,
                        with_properties=True)
            for i in range(0, len(idx), batch_size)]


@dataclasses.dataclass
class GraphClassificationData:
    """Unshuffled padded batches over a split (ref loader :68-76)."""
    batches: List[GraphBatch]


@dataclasses.dataclass
class NodeClassificationData:
    """One full graph + per-batch node-index/label arrays (ref loader :79-92)."""
    graph: GraphBatch
    node_indices: List[np.ndarray]   # [B] per batch
    labels: List[np.ndarray]         # [B] per batch


@dataclasses.dataclass
class LinkPredictionData:
    """One full graph + per-batch edge/label arrays (ref loader :95-103).

    ``train_edges`` are the positive train edges — the message-passing graph
    for every LP (and LP-domain NC) forward (reference: finetune.py:166,187).
    """
    graph: GraphBatch
    edges: List[np.ndarray]          # [2, B] per batch
    labels: List[np.ndarray]         # [B] per batch
    edge_mask: List[np.ndarray]      # [B] validity per batch (last may be ragged)
    train_edges: np.ndarray          # [2, E_train]


def _single_graph_batch(store: GraphStore,
                        message_passing_edges: Optional[np.ndarray] = None
                        ) -> GraphBatch:
    """The full (single) graph as a padded batch, optionally with its edge set
    replaced (NC/LP propagate over train edges only, ref finetune.py:166-187)."""
    n = int(store.node_offsets[1])
    if message_passing_edges is not None:
        ei = np.asarray(message_passing_edges, np.int64)
        sub = GraphStore(name=store.name, node_features=store.node_features,
                         edge_index=ei.astype(np.int32),
                         node_offsets=store.node_offsets,
                         edge_offsets=np.array([0, ei.shape[1]], np.int64),
                         y=store.y, splits=store.splits, node_y=store.node_y)
        return build_batch(sub, [0], round_up(n), round_up(max(ei.shape[1], 1)), 1)
    return build_batch(store, [0], round_up(n),
                       round_up(max(store.graph_num_edges(0), 1)), 1)


def create_finetune_arrays(domain_name: str, split: str, batch_size: int,
                           processed_dir=None):
    processed_dir = Path(processed_dir) if processed_dir else config.PROCESSED_DIR
    store = GraphStore.load(processed_dir / f"{domain_name}.npz")
    task_type = config.TASK_TYPES[domain_name]

    if task_type == "graph_classification":
        idx = np.asarray(store.splits[split], np.int64)
        n_pad, e_pad = _batch_pads(store, idx, batch_size)
        batches = [build_batch(store, idx[i:i + batch_size], n_pad, e_pad, batch_size)
                   for i in range(0, len(idx), batch_size)]
        return GraphClassificationData(batches=batches)

    if task_type == "node_classification":
        idx = np.asarray(store.splits[split], np.int64)
        bs = len(idx) if batch_size == -1 else batch_size
        graph = _single_graph_batch(store)
        node_indices = [idx[i:i + bs].astype(np.int32) for i in range(0, len(idx), bs)]
        labels = [np.asarray(store.node_y)[ix].astype(np.int32) for ix in node_indices]
        return NodeClassificationData(graph=graph, node_indices=node_indices,
                                      labels=labels)

    if task_type == "link_prediction":
        train_pos = np.asarray(store.splits["train_pos"], np.int64)
        if split == "train":
            edges_all = train_pos
            labels_all = np.ones(edges_all.shape[1], np.float32)
        else:
            pos = np.asarray(store.splits[f"{split}_pos"], np.int64)
            neg = np.asarray(store.splits[f"{split}_neg"], np.int64)
            edges_all = np.concatenate([pos, neg], axis=1)
            labels_all = np.concatenate([np.ones(pos.shape[1], np.float32),
                                         np.zeros(neg.shape[1], np.float32)])
        graph = _single_graph_batch(store, message_passing_edges=train_pos)
        edges, labels, masks = [], [], []
        total = edges_all.shape[1]
        for i in range(0, total, batch_size):
            chunk = edges_all[:, i:i + batch_size]
            lab = labels_all[i:i + batch_size]
            b = chunk.shape[1]
            if b < batch_size:  # pad the ragged tail; mask carries validity
                chunk = np.pad(chunk, ((0, 0), (0, batch_size - b)))
                lab = np.pad(lab, (0, batch_size - b))
            edges.append(chunk.astype(np.int32))
            labels.append(lab)
            masks.append((np.arange(batch_size) < b).astype(np.float32))
        return LinkPredictionData(graph=graph, edges=edges, labels=labels,
                                  edge_mask=masks, train_edges=train_pos)

    raise ValueError(f"unknown task type for domain {domain_name}")
