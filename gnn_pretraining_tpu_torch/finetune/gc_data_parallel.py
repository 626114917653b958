"""Data-parallel graph-classification fine-tuning.

Port of ``gnn_pretraining_tpu/finetune/gc_data_parallel.py``. The graphs of
each padded batch are dealt round-robin over the ranks of the data axis
(``parallel.mesh.DataAxis``), and a step computes exactly the single-device
step on the whole batch: the masked-mean loss sums its sum and count over
the ranks, every BatchNorm is a SyncBN (the model built on the axis), each
rank's dropout draws from its own stream, and the gradients, averaged over
the ranks, drive an AdamW step that is the same on every rank. The
per-graph outputs come back gathered rank-major over the ranks, for the
host's metrics. The model aggregates with ``coo``, as the JAX package's
data-parallel model does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphBatch, GraphStore, build_batch, round_up


def build_sharded_gc_batches(store: GraphStore, split: str, batch_size: int,
                             n_dev: int) -> List[List[GraphBatch]]:
    """Unshuffled batches of ``split``, each as its ``n_dev`` sub-batches
    (rank r's holds the batch's graphs ``r::n_dev``), all padded to the same
    per-rank shape over every (batch, rank) chunk."""
    idx = np.asarray(store.splits[split], np.int64)
    nn = np.diff(store.node_offsets)
    ne = np.diff(store.edge_offsets)
    g_local = max(1, -(-batch_size // n_dev))

    max_n = max_e = 1
    chunks = []
    for i in range(0, len(idx), batch_size):
        batch_idx = idx[i:i + batch_size]
        per_dev = [batch_idx[d::n_dev] for d in range(n_dev)]
        chunks.append(per_dev)
        for sel in per_dev:
            if len(sel):
                max_n = max(max_n, int(nn[sel].sum()))
                max_e = max(max_e, int(ne[sel].sum()))
    n_pad, e_pad = round_up(max_n), round_up(max_e)
    return [[build_batch(store, sel, n_pad, e_pad, g_local) for sel in per_dev]
            for per_dev in chunks]


def make_gc_steps_data_parallel(model, cfg, optimizer, labels, axis):
    """The data-parallel ``make_gc_steps``: ``train_step(batch) -> (loss, y,
    preds, probs, gnorm)`` and ``eval_step(batch) -> (loss, y, preds, probs)``
    over this rank's sub-batch; the loss is the whole batch's, ``y``,
    ``preds`` and ``probs`` every rank's, rank-major."""
    from gnn_pretraining_tpu_torch.finetune.finetune import (
        _class_loss,
        _classification_outputs,
        _update,
    )

    binary = config.NUM_CLASSES[cfg.domain_name] == 2

    def forward(batch):
        return model(batch.x, batch.node_mask, senders=batch.senders,
                     receivers=batch.receivers, edge_mask=batch.edge_mask,
                     node_graph=batch.node_graph, num_graphs=batch.num_graphs)

    def loss_from_logits(logits, y, mask):
        per = _class_loss(logits, y, binary)
        return (axis.psum((per * mask).sum())
                / torch.clamp(axis.psum(mask.sum()), min=1.0))

    def gathered(logits, y):
        probs, preds = _classification_outputs(logits)
        return axis.gather_rows(y), axis.gather_rows(preds), axis.gather_rows(probs)

    def train_step(batch):
        model.train()
        logits = forward(batch)
        loss = loss_from_logits(logits, batch.y, batch.graph_mask)
        gnorm = _update(model, optimizer, labels, loss, axis)
        with torch.no_grad():
            return (loss.detach(), *gathered(logits.detach(), batch.y), gnorm)

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        logits = forward(batch)
        loss = loss_from_logits(logits, batch.y, batch.graph_mask)
        return (loss, *gathered(logits, batch.y))

    return train_step, eval_step
