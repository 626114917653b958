"""Fine-tuning runtime: per-task-family train/eval steps + the host loop.

Port of ``gnn_pretraining_tpu/finetune/finetune.py`` (reference
src/finetune/finetune.py:109-436), the per-step path:

  * graph classification: padded graph batches, CE (or BCE-with-logits on
    logits[:,1] for binary domains), mean-pool readout; the bf16 adjacency is
    built per batch inside the step;
  * node classification: full-graph forward, logits gathered at the split's
    node indices; the adjacency is built once;
  * link prediction: per-batch hard-negative mining against a no-grad
    train-mode embedding over the train edges, then BCE on the scored pairs;
    val/test score the precomputed pos‖neg split edges;
  * AdamW param groups with freeze rules: encoder frozen for ENZYMES else lr
    1e-3, backbone frozen for linear_probe else 1e-4, head 1e-3; weight decay
    0.01 on every trainable leaf (BatchNorm and ε included); no grad clipping;
  * model selection on val AUC (LP) / accuracy, patience = epochs/2, initial
    checkpoint, best-reload for the test pass.

The model and the optimizer hold the state that the JAX steps thread through
``FTState``; a frozen subtree is frozen by ``requires_grad_(False)`` and the
whole model stays in ``train()`` during a train step, so every BatchNorm's
running statistics update, frozen or not, as in the JAX step. With
``aggregation="pallas"`` every GIN layer runs kernel K1 forward and, for each
layer whose input needs a gradient, K1 backward. With ``aggregation="csr"``
(node classification and link prediction: one fixed graph, for graphs past
the dense limit) the graph is RCM-reordered once, its block-CSR tiles are
built on the host (``finetune.runners.csr_graph_aux``), every node index of
the splits is remapped, and every GIN layer runs kernel K3 instead.

The run summary ends with the ``fidelity/*`` block (``utils.fidelity``)
that a sweep's ``--resume`` checks, and its test row carries the steady
rates ``test/steady_steps_per_sec`` / ``test/steady_edges_per_sec`` (from
the third epoch on; see ``STEADY_FROM_EPOCH``).

``data_parallel=True`` (``--data_parallel``, the drivers' ``--dp auto``) on a
graph-classification domain runs the steps of
``finetune/gc_data_parallel.py`` on every rank of the data axis
(``parallel.mesh.make_mesh``: the group passed as ``axis``, else a
launcher's node) when it has more than one rank: each rank holds its share
of every batch, on a ``coo`` model with SyncBN, as in the JAX package. Rank
0 alone writes the log, the checkpoints and the summary, and hands the best
checkpoint to every rank for the test pass.

``edge_parallel=True`` / ``node_parallel=True`` (``--edge_parallel`` /
``--node_parallel``, the drivers' ``--partition edge|node``) on a node or
link domain run the edge-partitioned steps of ``finetune/edge_parallel.py``
or the node-partitioned (halo-exchange) steps of
``finetune/node_parallel.py`` over the ranks of the axis, on a ``coo``
model, with the same writes and hand-over as above. A task family without
the asked path, or one rank, takes the single-device path. Not ported: the
JAX package's scan-fused runner (its chunked epochs and best-epoch replay
cut TPU dispatches; this loop saves the best state at each improvement
instead).
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.batch import GraphStore
from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays
from gnn_pretraining_tpu_torch.finetune import edge_parallel, node_parallel
from gnn_pretraining_tpu_torch.finetune import metrics as M
from gnn_pretraining_tpu_torch.finetune.mining import (
    build_forbidden_mask,
    candidate_count,
    hard_count,
    mine_hard_negatives,
)
from gnn_pretraining_tpu_torch.finetune.node_parallel import (
    HaloAggregate,
    replicate_head_dropout,
)
from gnn_pretraining_tpu_torch.finetune.runners import csr_graph_aux
from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.parallel.data_parallel import rank_seed
from gnn_pretraining_tpu_torch.parallel.mesh import make_mesh
from gnn_pretraining_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_transfer_artifact,
    save_checkpoint,
)
from gnn_pretraining_tpu_torch.utils.convert import (
    load_pretrained_into_finetune,
    load_variables,
    model_variables,
    variables_to_state_dict,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device
from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block
from gnn_pretraining_tpu_torch.utils.logging import MetricLogger, SilentLogger
from gnn_pretraining_tpu_torch.utils.losses import (
    bce_with_logits,
    masked_bce_with_logits_mean,
)

GROUP_LRS = {"encoder": config.LR_FINETUNE, "backbone": config.LR_BACKBONE,
             "head": config.LR_FINETUNE}
# The steady rates count the epochs from this one on, leaving out the
# one-off costs of the first (the kernels' build, the first launch at each
# shape), as the JAX fused runner leaves out its first two dispatches.
STEADY_FROM_EPOCH = 3


# ---------------------------------------------------------------------------
# Optimizer with freeze rules
# ---------------------------------------------------------------------------


def group_of_param(top_key: str, cfg: config.FinetuneConfig) -> str:
    if top_key == "input_encoder":
        return "frozen" if cfg.domain_name == "ENZYMES" else "encoder"
    if top_key == "gnn_backbone":
        return "frozen" if cfg.finetune_strategy == "linear_probe" else "backbone"
    return "head"


def create_finetune_optimizer(model: torch.nn.Module, cfg: config.FinetuneConfig):
    """(optimizer, labels, lrs). ``labels`` maps each parameter name to its
    group; frozen parameters get ``requires_grad_(False)`` and stay out of the
    optimizer; ``lrs`` holds the groups that have a parameter."""
    labels = {name: group_of_param(name.split(".")[0], cfg)
              for name, _ in model.named_parameters()}
    groups = []
    for group, lr in GROUP_LRS.items():
        members = [p for name, p in model.named_parameters()
                   if labels[name] == group]
        if members:
            groups.append({"params": members, "lr": lr, "name": group})
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    # torch AdamW's default weight_decay=0.01 (the reference passes only lr).
    optimizer = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    lrs = {g["name"]: g["lr"] for g in groups}
    return optimizer, labels, lrs


def param_counts(model: torch.nn.Module, labels: Dict[str, str]) -> Tuple[int, int]:
    total = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for name, p in model.named_parameters()
                    if labels[name] != "frozen")
    return total, trainable


def masked_grad_norm(model: torch.nn.Module, labels: Dict[str, str]) -> torch.Tensor:
    """L2 norm of the gradients of the trainable (non-frozen) parameters."""
    sq = [p.grad.to(torch.float32).pow(2).sum()
          for name, p in model.named_parameters()
          if labels[name] != "frozen" and p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


def _update(model, optimizer, labels, loss, axis=None) -> torch.Tensor:
    """Backward + one AdamW step; returns the masked grad norm. With ``axis``
    (a loss that every rank of it computes) the gradients are averaged over
    the ranks first, each rank's being n times its share (JAX
    ``finetune/edge_parallel.py`` ``_replicated_update``), so that the update
    is the same on every rank."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if axis is not None:
        with_grad = [p for p in model.parameters() if p.grad is not None]
        for p, g in zip(with_grad, axis.pmean([p.grad for p in with_grad])):
            p.grad = g
    gnorm = masked_grad_norm(model, labels)
    optimizer.step()
    return gnorm


def _adj_dtype(model: FinetuneGNN) -> torch.dtype:
    return torch.bfloat16 if model.aggregation == "pallas" else torch.float32


def _class_loss(logits: torch.Tensor, y: torch.Tensor, binary: bool) -> torch.Tensor:
    """Per-row loss: BCE on logits[:, 1] for binary domains, else CE."""
    if binary:
        return bce_with_logits(logits[:, 1], y, clamp=False)
    return F.cross_entropy(logits, y.long(), reduction="none")


def _classification_outputs(logits: torch.Tensor):
    return torch.softmax(logits, dim=-1), torch.argmax(logits, dim=-1)


def _lp_outputs(z: torch.Tensor, y: torch.Tensor):
    """(y, predictions, [1 - p, p]) of link logits ``z``."""
    probs = torch.sigmoid(z)
    preds = (probs > 0.5).to(torch.int32)
    return y.to(torch.int32), preds, torch.stack([1.0 - probs, probs], dim=1)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_gc_steps(model: FinetuneGNN, cfg, optimizer, labels):
    """``train_step(batch) -> (loss, y, preds, probs, gnorm)`` and
    ``eval_step(batch) -> (loss, y, preds, probs)`` over ``GraphBatch``es on
    the model's device."""
    binary = config.NUM_CLASSES[cfg.domain_name] == 2
    adj_dtype = _adj_dtype(model)

    def forward(batch):
        adj = build_dense_adjacency(batch.senders, batch.receivers,
                                    batch.edge_mask, batch.num_nodes,
                                    dtype=adj_dtype)
        return model(batch.x, batch.node_mask, adj=adj, senders=batch.senders,
                     receivers=batch.receivers, edge_mask=batch.edge_mask,
                     node_graph=batch.node_graph, num_graphs=batch.num_graphs)

    def loss_from_logits(logits, y, mask):
        per = _class_loss(logits, y, binary)
        return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def train_step(batch):
        model.train()
        logits = forward(batch)
        loss = loss_from_logits(logits, batch.y, batch.graph_mask)
        gnorm = _update(model, optimizer, labels, loss)
        probs, preds = _classification_outputs(logits.detach())
        return loss.detach(), batch.y, preds, probs, gnorm

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        logits = forward(batch)
        loss = loss_from_logits(logits, batch.y, batch.graph_mask)
        probs, preds = _classification_outputs(logits)
        return loss, batch.y, preds, probs

    return train_step, eval_step


def make_nc_steps(model: FinetuneGNN, cfg, optimizer, labels, graph, adj,
                  bsr=None, axis=None):
    """``train_step(node_idx, y)`` / ``eval_step(node_idx, y)`` over one full
    graph (``graph`` and ``adj`` or ``bsr`` already on the model's device).
    ``axis``: the update averages the gradients over its ranks (``_update``)."""
    binary = config.NUM_CLASSES[cfg.domain_name] == 2

    def forward():
        return model(graph.x, graph.node_mask, adj=adj, senders=graph.senders,
                     receivers=graph.receivers, edge_mask=graph.edge_mask,
                     bsr=bsr)

    def loss_from_logits(logits, node_idx, y):
        sel = logits[node_idx.long()]
        return _class_loss(sel, y, binary).mean(), sel

    def train_step(node_idx, y):
        model.train()
        loss, sel = loss_from_logits(forward(), node_idx, y)
        gnorm = _update(model, optimizer, labels, loss, axis)
        probs, preds = _classification_outputs(sel.detach())
        return loss.detach(), y, preds, probs, gnorm

    @torch.no_grad()
    def eval_step(node_idx, y):
        model.eval()
        loss, sel = loss_from_logits(forward(), node_idx, y)
        probs, preds = _classification_outputs(sel)
        return loss, y, preds, probs

    return train_step, eval_step


def make_lp_steps(model: FinetuneGNN, cfg, optimizer, labels, graph, adj_train,
                  forbidden, num_hard: int,
                  generator: Optional[torch.Generator] = None, bsr=None, axis=None):
    """``train_step(pos_edges, edge_mask) -> (loss, y, preds, probs2, mask,
    gnorm)`` and ``eval_step(edges, y, edge_mask)``.

    ``generator`` (on the model's device) draws the Gumbel noise of the
    miner's uniform remainder; ``train_step(..., gumbel=)`` or
    ``negatives=(senders, receivers)`` replace the draw or the whole mining.
    ``train_step.last_negatives`` holds the pairs the last call scored, so a
    second model can be stepped on exactly the same pairs. ``axis``: as in
    ``make_nc_steps``."""
    kwargs = dict(adj=adj_train, senders=graph.senders,
                  receivers=graph.receivers, edge_mask=graph.edge_mask, bsr=bsr)

    def train_step(pos_edges, edge_mask, *, gumbel=None, negatives=None):
        model.train()
        b = pos_edges.shape[1]
        # No-grad embedding in train mode: BN stats update, dropout active
        # (reference finetune.py:186-188 under model.train()); the scored
        # forward below starts from the updated stats.
        with torch.no_grad():
            emb = model.embed(graph.x, graph.node_mask, **kwargs)
            if negatives is None:
                negatives = mine_hard_negatives(
                    emb, forbidden, num_negatives=b, num_hard=num_hard,
                    generator=generator, gumbel=gumbel)
        neg_s, neg_r = train_step.last_negatives = negatives
        s = torch.cat([pos_edges[0], neg_s.to(pos_edges.dtype)])
        r = torch.cat([pos_edges[1], neg_r.to(pos_edges.dtype)])
        y = torch.cat([torch.ones(b, device=s.device),
                       torch.zeros(b, device=s.device)])
        mask = torch.cat([edge_mask, edge_mask])

        z = model(graph.x, graph.node_mask, score_senders=s, score_receivers=r,
                  return_logits=True, **kwargs)
        loss = masked_bce_with_logits_mean(z, y, mask)
        gnorm = _update(model, optimizer, labels, loss, axis)
        return (loss.detach(), *_lp_outputs(z.detach(), y), mask, gnorm)

    train_step.last_negatives = None

    @torch.no_grad()
    def eval_step(edges, y, edge_mask):
        model.eval()
        z = model(graph.x, graph.node_mask, score_senders=edges[0],
                  score_receivers=edges[1], return_logits=True, **kwargs)
        loss = masked_bce_with_logits_mean(z, y, edge_mask)
        return (loss, *_lp_outputs(z, y))

    return train_step, eval_step


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


def _pretrained_variables(cfg, out_root: Path):
    """The pretrained variables for ``cfg``: a checkpoint under
    ``out_root/pretrain`` if there is one, else the tracked fp16 transfer
    artifact."""
    ckpt_file = out_root / "pretrain" / f"model_{cfg.pretrained_scheme}_{cfg.seed}.msgpack"
    artifact_file = (config.ARTIFACTS_DIR / "transfer"
                     / f"backbone_{cfg.pretrained_scheme}_{cfg.seed}.msgpack")
    if ckpt_file.exists():
        ckpt = load_checkpoint(ckpt_file)
        return {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    if artifact_file.exists():
        return load_transfer_artifact(artifact_file)
    raise FileNotFoundError(
        f"pretrained checkpoint {ckpt_file} not found and no tracked "
        f"artifact at {artifact_file}")


def build_finetune_model(cfg, aggregation: str, device, out_root=None,
                         axis=None, edge_axis=None, aggregate_fn=None) -> FinetuneGNN:
    """A ``FinetuneGNN`` initialised from ``cfg.seed`` (dropout seeded
    ``cfg.seed + 1``, on a rank of ``axis`` the rank's seed of it, and SyncBN
    over the axis; ``edge_axis`` and ``aggregate_fn`` as the model takes
    them), with the pretrained backbone loaded unless the scheme is ``b1``
    (from scratch)."""
    model = FinetuneGNN(cfg.domain_name, aggregation,
                        generator=torch.Generator().manual_seed(cfg.seed),
                        device=device, axis=axis, edge_axis=edge_axis,
                        aggregate_fn=aggregate_fn)
    model.seed_dropout(cfg.seed + 1 if axis is None else rank_seed(cfg.seed + 1, axis.rank))
    if cfg.pretrained_scheme != "b1":
        pt_vars = _pretrained_variables(cfg, Path(out_root or config.OUTPUT_DIR))
        model.load_state_dict(load_pretrained_into_finetune(
            model.state_dict(), variables_to_state_dict(pt_vars),
            cfg.domain_name))
    return model


def _save_model(path, model, epoch: int, val_metrics) -> None:
    variables = model_variables(model)
    save_checkpoint(path, variables["params"], variables["batch_stats"],
                    epoch, val_metrics)


def build_steps(cfg, model: FinetuneGNN, optimizer, labels, data, device,
                axis=None, processed_dir=None, partition: Optional[str] = None):
    """The family's ``(train_step, eval_step, train_batches, eval_batches)``
    for ``data`` (split -> ``create_finetune_arrays`` output): the batch
    iterators yield the steps' positional arguments as device tensors, with
    the validity mask of the batch as numpy in front.

    Under ``csr`` the steps run on the RCM-permuted graph and its tiles
    (``csr_graph_aux`` of the train graph) and the iterators yield node ids
    in that labelling. With ``axis`` (graph classification, ``model`` built
    on it) the steps are the data-parallel ones over this rank's share of
    each batch of the store in ``processed_dir``, and the validity mask is
    every rank's, rank-major, as the steps' outputs are. With ``partition``
    (``"edge"`` or ``"node"``, node classification and link prediction,
    ``model`` built for it on ``axis``) the steps are the edge- or
    node-partitioned ones; the node ones take this rank's ``NodeShard`` as
    their last argument."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731

    if axis is not None and partition is None:
        from gnn_pretraining_tpu_torch.finetune.gc_data_parallel import (
            build_sharded_gc_batches,
            make_gc_steps_data_parallel,
        )

        train_step, eval_step = make_gc_steps_data_parallel(model, cfg, optimizer, labels,
                                                            axis)
        store = GraphStore.load(Path(processed_dir or config.PROCESSED_DIR)
                                / f"{cfg.domain_name}.npz")
        shards = {split: build_sharded_gc_batches(store, split, cfg.batch_size, axis.size)
                  for split in data}
        on_device = {split: [subs[axis.rank].to(device) for subs in batches]
                     for split, batches in shards.items()}

        def sharded(split):
            for subs, dev in zip(shards[split], on_device[split]):
                yield np.concatenate([s.graph_mask.numpy() for s in subs]) > 0, (dev,)

        return train_step, eval_step, lambda: sharded("train"), sharded

    if cfg.task_type == "graph_classification":
        train_step, eval_step = make_gc_steps(model, cfg, optimizer, labels)
        on_device = {split: [b.to(device) for b in d.batches]
                     for split, d in data.items()}

        def batches(split):
            for cpu, dev in zip(data[split].batches, on_device[split]):
                yield cpu.graph_mask.numpy() > 0, (dev,)

        return train_step, eval_step, lambda: batches("train"), batches

    g = data["train"].graph
    adj = bsr = inv = None
    if model.aggregation == "csr":
        g, bsr, inv = csr_graph_aux(g)
        bsr = bsr.to(device)
    graph = g.to(device)
    if model.aggregation in ("dense", "pallas"):
        adj = build_dense_adjacency(graph.senders, graph.receivers,
                                    graph.edge_mask, graph.num_nodes,
                                    dtype=_adj_dtype(model))

    def ids(a):
        """Node ids of the splits in the steps' labelling."""
        return inv[np.asarray(a)] if inv is not None else a

    extra = ()                      # the node-partitioned steps' last argument
    if partition == "node":
        extra = (node_parallel.prepare(g, axis, device)[1],)
    if cfg.task_type == "node_classification":
        if partition == "edge":
            train_step, eval_step = edge_parallel.make_nc_steps_edge_parallel(
                model, cfg, optimizer, labels, graph, axis)
        elif partition == "node":
            train_step, eval_step = node_parallel.make_nc_steps_node_parallel(
                model, cfg, optimizer, labels, axis)
        else:
            train_step, eval_step = make_nc_steps(model, cfg, optimizer, labels,
                                                  graph, adj, bsr)

        def batches(split):
            d = data[split]
            for ix, y in zip(d.node_indices, d.labels):
                yield np.ones(len(y), bool), (t(ids(ix)), t(y), *extra)

        return train_step, eval_step, lambda: batches("train"), batches

    train_edges = ids(data["train"].train_edges)
    real_n = int(g.node_mask.sum())
    forbidden = build_forbidden_mask(g.num_nodes, train_edges,
                                     node_mask=g.node_mask.numpy()).to(device)
    n_cand = candidate_count(g.num_nodes, train_edges, num_real_nodes=real_n)
    num_hard = hard_count(n_cand, cfg.batch_size)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)     # on every rank alike: mining is replicated
    if partition == "edge":
        train_step, eval_step = edge_parallel.make_lp_steps_edge_parallel(
            model, cfg, optimizer, labels, graph, axis, forbidden, num_hard, generator)
    elif partition == "node":
        train_step, eval_step = node_parallel.make_lp_steps_node_parallel(
            model, cfg, optimizer, labels, axis, forbidden, num_hard, generator)
    else:
        train_step, eval_step = make_lp_steps(model, cfg, optimizer, labels, graph,
                                              adj, forbidden, num_hard, generator,
                                              bsr)

    def train_batches():
        d = data["train"]
        for e, m in zip(d.edges, d.edge_mask):
            yield np.concatenate([m, m]) > 0, (t(ids(e)), t(m), *extra)

    def eval_batches(split):
        d = data[split]
        for e, y, m in zip(d.edges, d.labels, d.edge_mask):
            yield m > 0, (t(ids(e)), t(y), t(m), *extra)

    return train_step, eval_step, train_batches, eval_batches


def _to_numpy(*tensors):
    return [x.detach().cpu().numpy() for x in tensors]


def parallel_mode(cfg, data_parallel: bool = False, edge_parallel: bool = False,
                  node_parallel: bool = False) -> Optional[str]:
    """Which multi-rank path ``cfg`` takes under the flags: ``"data"``
    (graph classification), ``"node"`` or ``"edge"`` (node classification
    and link prediction; node first, as in the JAX package), else None."""
    if cfg.task_type == "graph_classification":
        return "data" if data_parallel else None
    return "node" if node_parallel else "edge" if edge_parallel else None


def finetune(cfg: config.FinetuneConfig, aggregation: str = "pallas",
             processed_dir=None, epochs: Optional[int] = None, out_root=None,
             device=None, use_wandb: bool = False, data_parallel: bool = False,
             axis=None, edge_parallel: bool = False,
             node_parallel: bool = False) -> Dict[str, float]:
    """Fine-tune one cell and return its test metrics.

    Runs on the card unless ``device="cpu"``. Checkpoints go to
    ``out_root/finetune``, metrics to ``out_root/metrics``; pretrained
    checkpoints are looked up under ``out_root/pretrain`` before the tracked
    transfer artifacts. ``data_parallel``, ``edge_parallel`` and
    ``node_parallel`` on ``axis`` (else ``make_mesh(device)``): see the
    module docstring."""
    device = resolve_device(device)
    mode = parallel_mode(cfg, data_parallel, edge_parallel, node_parallel)
    if mode is not None:
        axis = axis or make_mesh(device)
    axis = axis if mode is not None and axis is not None and axis.size > 1 else None
    mode = mode if axis is not None else None
    if axis is not None:
        device = axis.device
    lead = axis is None or axis.rank == 0
    # f32 products stay f32: the miner's similarities and the linears.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if aggregation == "csr" and cfg.task_type == "graph_classification":
        # The tiles are built once per graph; these batches change every step.
        raise ValueError(
            "aggregation='csr' needs one fixed message-passing graph (node "
            "classification / link prediction domains); graph-classification "
            "batches change structure per step — use pallas/coo/dense there")

    training_start = time.time()
    epochs = epochs or cfg.epochs
    patience = int(epochs * config.FINETUNE_PATIENCE_FRACTION)

    out_root = Path(out_root or config.OUTPUT_DIR)
    finetune_out_dir = out_root / "finetune"
    logger = SilentLogger()
    if lead:
        finetune_out_dir.mkdir(parents=True, exist_ok=True)
        logger = MetricLogger(config.FINETUNE_PROJECT_NAME, cfg.run_name,
                              out_dir=out_root / "metrics", use_wandb=use_wandb)

    data = {split: create_finetune_arrays(cfg.domain_name, split,
                                          cfg.batch_size,
                                          processed_dir=processed_dir)
            for split in ("val", "test", "train")}

    # The multi-rank models aggregate with coo, as the JAX package's do: the
    # edge-partitioned one over this rank's edges (no SyncBN, the same
    # dropout seed on every rank), the node-partitioned one by the halo
    # exchange (SyncBN, the rank's dropout seed, the head's replicated).
    if mode == "edge":
        model = build_finetune_model(cfg, "coo", device, out_root, edge_axis=axis)
    elif mode == "node":
        model = build_finetune_model(cfg, "coo", device, out_root, axis,
                                     aggregate_fn=HaloAggregate(axis))
        replicate_head_dropout(model, cfg.seed + 1)
    else:
        model = build_finetune_model(cfg, aggregation if axis is None else "coo", device,
                                     out_root, axis)
    optimizer, labels, lrs = create_finetune_optimizer(model, cfg)
    total_params, trainable_params = param_counts(model, labels)
    train_step, eval_step, train_batches, eval_batches = build_steps(
        cfg, model, optimizer, labels, data, device, axis, processed_dir,
        mode if mode in ("edge", "node") else None)

    ckpt_path = finetune_out_dir / f"model_{cfg.run_name}.msgpack"
    if lead:
        _save_model(ckpt_path, model, 0, {})

    # Per-cell throughput telemetry (real mask-valid edges per train step).
    if cfg.task_type == "graph_classification":
        ems = [float(b.edge_mask.sum()) for b in data["train"].batches]
        edges_per_step = float(np.sum(ems) / max(len(ems), 1))
    else:
        edges_per_step = float(data["train"].graph.edge_mask.sum())

    def run_eval_pass(split):
        batch_metrics, all_y, all_p = [], [], []
        for valid, args in eval_batches(split):
            loss, y, preds, probs = _to_numpy(*eval_step(*args))
            batch_metrics.append(M.compute_batch_metrics(
                cfg.domain_name, y[valid], preds[valid], probs[valid],
                float(loss), split))
            all_y.append(y[valid])
            all_p.append(probs[valid])
        global_auc = M.compute_global_auc(cfg.domain_name,
                                          np.concatenate(all_y),
                                          np.concatenate(all_p), split)
        return batch_metrics, global_auc

    best_val = -math.inf
    epochs_since_improvement = 0
    global_step = 0
    sel_key = "val/auc" if cfg.task_type == "link_prediction" else "val/accuracy"

    epoch = 0
    steady_wall, steady_steps = 0.0, 0
    t_loop = time.time()
    for epoch in range(1, epochs + 1):
        t_epoch, epoch_start_step = time.time(), global_step
        for valid, args in train_batches():
            step_start = time.time()
            global_step += 1
            out = train_step(*args)
            # LP also returns its doubled mask, which ``valid`` already is.
            loss, y, preds, probs = _to_numpy(*out[:4])
            gnorm = float(out[-1])
            tm = M.compute_training_metrics(
                epoch, global_step, float(loss), lrs, cfg.domain_name,
                y[valid], preds[valid], probs[valid], step_start, gnorm)
            logger.log(tm, step=global_step)

        val_bm, val_gauc = run_eval_pass("val")
        val_metrics = M.compute_validation_metrics(val_bm, epoch)
        val_metrics.update(val_gauc)
        # Every step's and every eval batch's outputs were fetched to the host
        # above, so the card is done with this epoch: no synchronize needed.
        if epoch >= STEADY_FROM_EPOCH:
            steady_wall += time.time() - t_epoch
            steady_steps += global_step - epoch_start_step
        logger.log(val_metrics, step=global_step)

        # Every rank computes the same metrics from the gathered outputs.
        if val_metrics[sel_key] > best_val:
            best_val = val_metrics[sel_key]
            epochs_since_improvement = 0
            if lead:
                _save_model(ckpt_path, model, epoch, val_metrics)
        else:
            epochs_since_improvement += 1
        if epochs_since_improvement >= patience:
            break
    loop_wall = time.time() - t_loop

    # Reload the best checkpoint and run the test pass (reference :415-433);
    # under data parallelism rank 0 reads it and hands it to every rank.
    best = load_checkpoint(ckpt_path) if lead else None
    if axis is not None:
        best = axis.from_rank0(best)
    load_variables(model, best)
    test_bm, test_gauc = run_eval_pass("test")
    test_metrics = M.compute_test_metrics(
        test_bm, epoch, epochs_since_improvement, training_start,
        total_params, trainable_params, train_steps=global_step,
        train_wall=loop_wall, edges_per_step=edges_per_step)
    test_metrics.update(test_gauc)
    if steady_steps:
        # Wall per train step of an epoch (its steps and its validation pass,
        # what one fused dispatch covers in the JAX package) from
        # STEADY_FROM_EPOCH on.
        steady = steady_wall / steady_steps
        test_metrics["test/steady_steps_per_sec"] = 1.0 / max(steady, 1e-9)
        test_metrics["test/steady_edges_per_sec"] = edges_per_step / max(steady, 1e-9)
    logger.log(test_metrics, step=global_step)
    logger.finish(extra=fidelity_block(epochs, cfg.seed, aggregation, processed_dir,
                                       (cfg.domain_name,)))
    if axis is not None:
        axis.barrier()          # rank 0's files are written when any rank returns
    return test_metrics


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--domain_name", type=str, required=True)
    parser.add_argument("--finetune_strategy", type=str, required=True)
    parser.add_argument("--pretrained_scheme", type=str, required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--aggregation", type=str, default="pallas",
                        choices=["dense", "pallas", "coo", "csr"])
    parser.add_argument("--processed_dir", type=str, default=None)
    parser.add_argument("--out_root", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda unless given (cpu runs the plain versions)")
    parser.add_argument("--wandb", action="store_true",
                        help="mirror the metrics to wandb (must be installed)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="under a multi-process launcher: shard each batch's "
                             "graphs over the node's ranks (graph classification)")
    parser.add_argument("--edge_parallel", action="store_true",
                        help="under a multi-process launcher: split the graph's "
                             "edges over the node's ranks (node / link tasks)")
    parser.add_argument("--node_parallel", action="store_true",
                        help="under a multi-process launcher: split the graph's "
                             "nodes over the node's ranks, halo exchange (node / "
                             "link tasks)")
    args = parser.parse_args()
    cfg = config.FinetuneConfig(domain_name=args.domain_name,
                                finetune_strategy=args.finetune_strategy,
                                pretrained_scheme=args.pretrained_scheme,
                                seed=args.seed)
    result = finetune(cfg, aggregation=args.aggregation, epochs=args.epochs,
                      processed_dir=args.processed_dir, out_root=args.out_root,
                      device=args.device, use_wandb=args.wandb,
                      data_parallel=args.data_parallel, edge_parallel=args.edge_parallel,
                      node_parallel=args.node_parallel)
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in result.items()})


if __name__ == "__main__":
    main()
