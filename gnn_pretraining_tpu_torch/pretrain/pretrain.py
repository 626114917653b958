"""Pretraining runtime: the multi-task train step, its chunked runner and the
host loop.

Port of ``gnn_pretraining_tpu/pretrain/pretrain.py`` (reference
src/pretrain/pretrain.py:96-353). One train step:

  1. each task's loss over all domains, and its own gradient
     (``torch.autograd.grad``; a parameter no task reaches gets zeros); the
     domain-adversarial task runs last;
  2. the adaptive loss balancer over the main tasks (a metric: the update
     does not use its weights, as in the JAX step);
  3. PCGrad over the main tasks' gradients (more than one task), then the
     domain-adversarial gradient added (JAX ``update_core``, the reference's
     GRL gradient reaching the shared parameters beside the surgery), then
     torch-style clipping to norm 0.5 and one AdamW step with per-task head
     learning rates;
  4. the same metric keys as the JAX step.

The step reads no host value that changes from step to step: its counters
(``PretrainState``: the scheduler step and the balancer's count) are device
tensors it advances itself, with host mirrors the loop advances by the
steps run; τ and λ come from per-step tables (``pretrain.schedulers``)
indexed on the device; PCGrad's layout is built once and its task order is
a device tensor. So one step is a fixed sequence of launches on fixed
buffers, which the chunked runner (``make_chunked_train_step``, the
counterpart of the JAX package's ``lax.scan`` chunk, JAX :268-354) captures
in one CUDA graph per scheme and replays for every step: the host writes a
step's batches and PCGrad order into the graph's input buffer and replays
it, and the step's metrics go into one packed ``[M, chunk]`` tensor (rows in
sorted name order) fetched once per ``CHUNK_FLUSH_EVERY`` chunks. A producer
thread (``chunked.prefetched``) samples the chunks' graphs, builds them with
the native builder into pinned host memory and draws their PCGrad orders
from the run's PCGrad generator in step order; the loop copies each chunk to
the card. On the CPU the same runner runs the same step eagerly, step by
step. On the card a failed capture or replay raises: there is no eager
fallback.

``pretrain(chunk_steps=32)`` takes the chunked runner on one device, as the
JAX package does; ``chunk_steps=1``, the data-parallel path and the path
under ``--debug_nans`` (whose checks read every step's values on the host)
take the per-step step (``make_train_step``). Both give the same steps: the
same batches, draws, PCGrad orders and metric rows.

The host loop samples the balanced multi-domain batches, evaluates every
epoch (its balancer count is written back into the state), keeps the best
validation checkpoint ``pretrain/model_{exp}_{seed}.msgpack`` (which the
JAX package's ``load_checkpoint`` and this package's ``finetune()`` read),
and stops after ``epochs // 2`` epochs without improvement. With
``aggregation="pallas"`` every GIN layer runs K1 forward and backward, and
every NT-Xent runs K2. The run summary ends with the ``fidelity/*`` block
(``utils/fidelity.py``) that the sweep scripts' ``--resume`` reads.

``resume=True`` (``--resume``) writes the train state to
``pretrain/resume_{exp}_{seed}.msgpack`` every ``RESUME_EVERY`` epochs and at
the last one (JAX pretrain.py:731-737), and, when that file exists, carries
on from the epoch after it: weights, BN statistics, AdamW's moments and
steps, the counters, and the state of every random stream (the sampler's
numpy generator, dropout, views, PCGrad's order, masks and negatives), so
the run goes on exactly as if it had never stopped. The JAX package
restarts its numpy sampler from the seed on resume, and so draws epoch 1's
batches again; this package does not. A JAX package's resume file loads
too; it holds no stream states, so the streams start from their seeds.

``--debug_nans`` (``utils.profiling.enable_nan_checks``) checks every task
loss, the combined gradient and the updated parameters of each step, and
every eval loss, and raises ``FloatingPointError`` at the first non-finite
one; a NaN first made by a backward op raises it too, naming the op.

``data_parallel=True`` (``--data_parallel``, the drivers' ``--dp auto``) runs
the step on every rank of the data axis (``parallel.mesh.make_mesh``: the
group passed as ``axis``, else a launcher's node) when it has more than one
rank, else the single-device path, as the JAX package does on one device:
each rank takes its share of every batch (``parallel.data_parallel``), the
model's BatchNorms are SyncBNs, and the ranks' parameters stay equal. Rank 0
alone evaluates (every rank then takes its total) and writes the log, the
checkpoint, the summary and the resume file, which holds every rank's
random streams; every rank restores the same state from it.

Every scheme of ``config.ALL_SCHEMES`` runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.loaders import (
    create_pretrain_train_loader,
    create_pretrain_val_loader,
)
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.parallel.data_parallel import (
    dp_pads,
    rank_seed,
    shard_sampler_step,
)
from gnn_pretraining_tpu_torch.parallel.mesh import make_mesh
from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource
from gnn_pretraining_tpu_torch.pretrain.balancer import balance_losses, np_balance
from gnn_pretraining_tpu_torch.pretrain.optimizers import (
    clip_grads_torch,
    create_task_specific_optimizer,
    param_labels,
)
from gnn_pretraining_tpu_torch.pretrain.chunked import (
    ChunkRunner,
    StepLayout,
    chunk_batches,
    prefetched,
    warmup_row,
)
from gnn_pretraining_tpu_torch.pretrain.pcgrad import apply_pcgrad, pcgrad_layout
from gnn_pretraining_tpu_torch.pretrain.schedulers import grl_lambda_table, temperature_table
from gnn_pretraining_tpu_torch.pretrain.tasks import (
    TaskContext,
    TaskDraws,
    compute_task_loss,
)
from gnn_pretraining_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from gnn_pretraining_tpu_torch.utils.convert import (
    adamw_to_opt_state,
    load_adamw_state,
    load_variables,
    model_variables,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device
from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block
from gnn_pretraining_tpu_torch.utils.logging import MetricLogger, SilentLogger
from gnn_pretraining_tpu_torch.utils.profiling import (
    ThroughputMeter,
    check_finite,
    enable_nan_checks,
    nan_checks_enabled,
)

FLUSH_EVERY = 8          # per-step path: steps between two fetches of their metrics
CHUNK_FLUSH_EVERY = 2    # chunked path: chunks between two fetches (JAX FLUSH_EVERY)
RESUME_EVERY = 5         # epochs between two resume files (and the last one)


@dataclasses.dataclass
class PretrainState:
    """The counters the JAX ``TrainState`` threads beside params and optimizer
    (which live in the model and the AdamW here): the scheduler step
    (pre-step value) and the balancer's step count. The train step reads and
    advances their device copy (``device_counters``, int64 [2]); the fields
    are its host mirrors, which the caller advances by the steps run
    (``advance``) and which evaluation, the resume file and the log read. A
    mirror set on the host (evaluation's balancer count, a resumed run's
    counters) is copied to the device before the next step."""
    opt_step: int = 0
    balancer_step: int = 0
    counters: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False,
                                                         compare=False)
    synced: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)

    def device_counters(self, device) -> torch.Tensor:
        """The device counters (opt_step, balancer_step), one tensor kept for
        the run and written in place, so a captured step keeps reading it."""
        device = torch.device(device)
        here = None if self.counters is None else self.counters.device
        if here is None or here.type != device.type or device.index not in (None, here.index):
            self.counters = torch.zeros(2, dtype=torch.long, device=device)
            self.synced = None
        mirrors = (self.opt_step, self.balancer_step)
        if self.synced != mirrors:
            self.counters.copy_(torch.tensor(mirrors, dtype=torch.long))
            self.synced = mirrors
        return self.counters

    def advance(self, steps: int, balancer_steps: int) -> None:
        """Advance the mirrors as ``steps`` train steps advanced the device
        counters (``balancer_steps`` of them counted by the balancer)."""
        self.opt_step += steps
        self.balancer_step += balancer_steps
        self.synced = (self.opt_step, self.balancer_step)


def _stream_seed(seed: int, axis) -> int:
    """``seed``, or under data parallelism the rank's own (``rank_seed``)."""
    return seed if axis is None else rank_seed(seed, axis.rank)


def build_pretrain_model(cfg: config.PretrainConfig, aggregation: str,
                         device, axis=None) -> PretrainableGNN:
    """Initialised from ``cfg.seed``; dropout seeded ``cfg.seed + 1`` (on a
    rank of ``axis``, the rank's seed of it); SyncBN over ``axis``."""
    model = PretrainableGNN(cfg.pretrain_domains, cfg.active_tasks, aggregation,
                            generator=torch.Generator().manual_seed(cfg.seed),
                            device=device, axis=axis)
    model.seed_dropout(_stream_seed(cfg.seed + 1, axis))
    return model


def random_streams(cfg: config.PretrainConfig, model: PretrainableGNN,
                   device, axis=None) -> Dict[str, Any]:
    """Every random stream of a run, seeded from ``cfg.seed``: the sampler's
    numpy generator (seed), the model's dropout (seed + 1, set by
    ``build_pretrain_model``), the views (seed + 2), PCGrad's task order
    (seed + 3, on the CPU) and the masks and negatives (seed + 4). On a rank
    of ``axis`` the dropout, views, masks and negatives take the rank's
    seeds; the sampler and PCGrad are the same on every rank."""
    return {"sampler": np.random.default_rng(cfg.seed),
            "dropout": model.dropout,
            "views": ViewSource(device, seed=_stream_seed(cfg.seed + 2, axis)),
            "pcgrad": torch.Generator().manual_seed(cfg.seed + 3),
            "task_draws": TaskDraws(device, seed=_stream_seed(cfg.seed + 4, axis))}


def stream_states(streams: Dict[str, Any]) -> Dict[str, Any]:
    """Each stream's state: a torch generator's bytes (uint8), the numpy
    generator's ``bit_generator.state`` with its 128-bit words as decimal
    strings (no msgpack int holds them)."""
    out = {}
    for name, stream in streams.items():
        if isinstance(stream, np.random.Generator):
            st = stream.bit_generator.state
            out[name] = {**st, "state": {k: str(v) for k, v in st["state"].items()}}
        else:
            out[name] = getattr(stream, "generator", stream).get_state().numpy()
    return out


def restore_streams(streams: Dict[str, Any], states: Dict[str, Any]) -> None:
    """The inverse of ``stream_states``, in place."""
    if set(states) != set(streams):
        raise ValueError(f"stream states {sorted(states)} do not match the run's "
                         f"streams {sorted(streams)}")
    for name, stream in streams.items():
        st = states[name]
        if isinstance(stream, np.random.Generator):
            stream.bit_generator.state = {**st, "state": {k: int(v) for k, v
                                                          in st["state"].items()}}
        else:
            getattr(stream, "generator", stream).set_state(
                torch.from_numpy(np.asarray(st, np.uint8)))


def save_resume_state(path, model: PretrainableGNN, optimizer, cfg: config.PretrainConfig,
                      state: PretrainState, streams: Dict[str, Any], epoch: int,
                      best_total: float, epochs_since_improvement: int, axis=None) -> None:
    """Write the run's train state after ``epoch`` (``utils.checkpoint.
    save_train_state``; the stream states under ``extra``). Under ``axis``
    every rank calls it, and rank 0 writes every rank's stream states too
    (``extra["rank_streams"]``)."""
    extra = {"streams": stream_states(streams)}
    if axis is not None:
        extra["rank_streams"] = axis.all_objects(extra["streams"])
        if axis.rank:
            return
    variables = model_variables(model)
    opt_state = adamw_to_opt_state(model, optimizer, param_labels(model, cfg.active_tasks),
                                   ["default", *cfg.active_tasks])
    counters = {"opt_step": state.opt_step, "balancer_step": state.balancer_step,
                "epoch": epoch, "best_total": best_total,
                "epochs_since_improvement": epochs_since_improvement}
    save_train_state(path, variables["params"], variables["batch_stats"], opt_state,
                     counters, extra=extra)


def load_resume_state(path, model: PretrainableGNN, optimizer, cfg: config.PretrainConfig,
                      streams: Dict[str, Any], axis=None) -> Dict[str, Any]:
    """Restore a train-state file onto ``model``, ``optimizer`` and
    ``streams`` in place and return its counters. Raises, naming the key,
    where the file does not fit the model. A rank of ``axis`` takes its own
    stream states from a file of a run on as many ranks. A file without
    stream states for this process (the JAX package's, or one of another
    number of ranks) leaves the streams at their seeds, and says so."""
    payload = load_train_state(path)
    load_variables(model, {"params": payload["params"],
                           "batch_stats": payload["batch_stats"]})
    load_adamw_state(payload["opt_state"], model, optimizer,
                     param_labels(model, cfg.active_tasks), ["default", *cfg.active_tasks])
    extra = payload["extra"]
    if axis is None:
        states = extra.get("streams")
    else:
        ranks = extra.get("rank_streams") or []
        states = ranks[axis.rank] if len(ranks) == axis.size else None
    if states is not None:
        restore_streams(streams, states)
    else:
        print(f"{path} holds no random-stream states for this process: "
              "the streams start from their seeds", flush=True)
    return payload["counters"]


def _at(table: torch.Tensor, step) -> torch.Tensor:
    """``table``'s [1] entry at ``step`` (a host int, or an int64 [1] device
    tensor); a step past the table's end reads its last entry."""
    last = table.shape[0] - 1
    if torch.is_tensor(step):
        return torch.index_select(table, 0, torch.clamp(step, max=last))
    step = min(int(step), last)
    return table[step:step + 1]


def _device_table(table, device) -> torch.Tensor:
    return torch.from_numpy(np.array(table, np.float32)).to(device)


def _task_grad(loss: torch.Tensor, params, step: Optional[int], task: str):
    """Each parameter's gradient of ``loss`` (None where it has none). Under
    the NaN checks, anomaly mode's error for a backward op that made a NaN
    is raised as ``FloatingPointError``."""
    try:
        return torch.autograd.grad(loss, params, allow_unused=True)
    except RuntimeError as err:
        if nan_checks_enabled() and "nan values" in str(err):
            raise FloatingPointError(f"non-finite value at train step {step}, "
                                     f"task {task} backward: {err}") from err
        raise


class StepBody:
    """One train step on device inputs: ``body(counters, domain_batches,
    perm, checked_step=None) -> (metrics, task_grads)``. ``counters`` is the state's
    int64 [2] device tensor (advanced in place), ``perm`` PCGrad's order of
    the sorted main tasks as an integer device tensor (None with one task).
    Everything else it reads is built here once: the τ and λ tables, PCGrad's
    layout, the counters' increment. ``checked_step`` (the host step, counted
    from 0) turns on the NaN checks, which read values on the host."""

    def __init__(self, model: PretrainableGNN, cfg: config.PretrainConfig, optimizer,
                 total_steps: int, views: ViewSource, draws: Optional[TaskDraws] = None,
                 axis=None):
        self.model, self.cfg, self.optimizer, self.axis = model, cfg, optimizer, axis
        self.tasks = [t for t in cfg.active_tasks if t != "domain_adv"]
        self.has_da = "domain_adv" in cfg.active_tasks
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.top_keys = [n.split(".")[0] for n in self.names]
        self.device = self.params[0].device
        self.views = views
        self.draws = draws if draws is not None else TaskDraws(self.device)
        self.temperature = _device_table(temperature_table(total_steps), self.device)
        self.grl_lambda = _device_table(grl_lambda_table(total_steps), self.device)
        self.multi_task = len(self.tasks) > 1
        self.increment = torch.tensor([1, int(self.multi_task)]).to(self.device)
        self.layout = (pcgrad_layout([p.shape for p in self.params], self.top_keys,
                                     self.tasks, self.device) if self.multi_task else None)

    def context(self, step) -> TaskContext:
        return TaskContext(temperature=_at(self.temperature, step), views=self.views,
                           grl_lambda=_at(self.grl_lambda, step), draws=self.draws,
                           axis=self.axis)

    def __call__(self, counters: torch.Tensor, domain_batches, perm,
                 checked_step: Optional[int] = None):
        model, params, tasks, has_da = self.model, self.params, self.tasks, self.has_da
        where = None if checked_step is None else f"train step {checked_step}"
        model.train()
        step = counters[0:1]
        ctx = self.context(step)
        task_losses, per_domain_task, grads = {}, {}, {}
        for t in tasks + ["domain_adv"] * has_da:
            loss, per_domain = compute_task_loss(t, model, domain_batches, ctx)
            if where is not None:
                check_finite(where, [(f"task {t} loss", loss)])
            g = _task_grad(loss, params, checked_step, t)
            grads[t] = [torch.zeros_like(p) if gi is None else gi
                        for p, gi in zip(params, g)]
            if self.axis is not None:
                grads[t] = self.axis.pmean(grads[t])
            task_losses[t] = loss.detach()
            per_domain_task[t] = {d: v.detach() for d, v in per_domain.items()}

        task_grads = dict(grads)
        da_loss = task_losses.pop("domain_adv", None)
        da_grads = grads.pop("domain_adv", None)
        total, weights, _ = balance_losses(task_losses, counters[1])
        if self.multi_task:
            combined, metrics = apply_pcgrad(grads, self.top_keys, perm=perm,
                                             layout=self.layout)
        else:
            combined, metrics = grads[tasks[0]], {}
        if has_da:                                 # after PCGrad, before clipping
            combined = torch._foreach_add(combined, da_grads)
        if where is not None:
            check_finite(where, ((f"combined gradient of {n}", g)
                                 for n, g in zip(self.names, combined)))
        clipped, pre_norm = clip_grads_torch(combined)
        for p, g in zip(params, clipped):
            p.grad = g
        self.optimizer.step()
        if where is not None:
            check_finite(where, ((f"parameter {n} after the update", p)
                                 for n, p in zip(self.names, params)))

        metrics["train/loss/total"] = total
        for t, w in weights.items():
            metrics[f"train/loss_balancer/weight/{t}"] = w
        # The reference logs the norm after clipping (pretrain.py:182-188).
        metrics["train/gradients/model_grad_norm"] = pre_norm * torch.clamp(
            config.MAX_GRAD_NORM / (pre_norm + 1e-6), max=1.0)
        for t, pd in per_domain_task.items():
            for d, v in pd.items():
                metrics[f"train/loss/{d}/{t}"] = v
        for t, v in task_losses.items():
            metrics[f"train/loss/{t}"] = v
        for d in self.cfg.pretrain_domains:
            metrics[f"train/loss/{d}"] = sum(per_domain_task[t][d] for t in per_domain_task)
        if has_da:
            metrics["train/loss/domain_adv"] = da_loss
            metrics["train/domain_adv/loss"] = da_loss
            # The reference logs λ after stepping its scheduler (pretrain.py:173).
            metrics["train/domain_adv/lambda"] = _at(self.grl_lambda, step + 1).reshape(())
        counters.add_(self.increment)
        return metrics, task_grads


def make_train_step(model: PretrainableGNN, cfg: config.PretrainConfig, optimizer,
                    total_steps: int, views: ViewSource,
                    pcgrad_generator: Optional[torch.Generator] = None,
                    draws: Optional[TaskDraws] = None, axis=None):
    """``train_step(state, domain_batches, perm=None) -> metrics`` (device
    tensors), the per-step path. It updates the model, the optimizer and
    ``state``; ``perm`` replaces PCGrad's draw of the task order from
    ``pcgrad_generator``; ``draws`` hands node-feature masking and link
    prediction their uniforms (unseeded by default: a scheme with those
    tasks needs one). ``train_step.last_task_grads`` holds the last step's
    per-task gradients (task -> one tensor per parameter, in
    ``named_parameters`` order), before PCGrad, the domain-adversarial one
    among them. Under ``utils.profiling.enable_nan_checks`` each task loss,
    the combined gradient and the updated parameters are checked
    (``FloatingPointError`` at the first non-finite value, naming the step,
    counted from 0, and the task or parameter). With ``axis`` (a
    ``parallel.mesh.DataAxis``; ``model`` built on it) the step is the
    data-parallel one (``parallel.data_parallel``): each task's gradient is
    averaged over the ranks, and the task gradients kept are those."""
    body = StepBody(model, cfg, optimizer, total_steps, views, draws, axis)
    k = len(body.tasks)

    def train_step(state: PretrainState, domain_batches, perm=None):
        if body.multi_task:
            if perm is None:
                perm = torch.randperm(k, generator=pcgrad_generator)
            perm = torch.as_tensor(perm, dtype=torch.long).to(body.device)
        else:
            perm = None
        checked = state.opt_step if nan_checks_enabled() else None
        metrics, train_step.last_task_grads = body(state.device_counters(body.device),
                                                   domain_batches, perm, checked)
        state.advance(1, int(body.multi_task))
        return metrics

    train_step.last_task_grads = None
    return train_step


def make_chunked_train_step(model: PretrainableGNN, cfg: config.PretrainConfig, optimizer,
                            total_steps: int, streams: Dict[str, Any]):
    """The chunked runner (JAX :268-325): ``(run_chunk, metric_names)``.

    ``run_chunk(state, words, layout) -> packed`` runs a chunk of train
    steps: ``words`` [chunk, layout.words] int32 holds each step's batches
    and PCGrad order (``chunked.stack_batches`` / ``chunk_batches``, on the
    host or the card), ``packed`` [M, chunk] f32 on the card holds each
    step's metrics, rows in ``metric_names`` order (the sorted metric keys,
    filled at the first step or capture). On the card the step is captured
    once in a CUDA graph (``run_chunk.capture``, before the first chunk or at
    it, after any resume file is loaded: snapshot, one warm-up step on a
    side stream, restore, capture) and replayed for every step; on the CPU
    it runs eagerly. ``streams`` are ``random_streams``' (dropout, views and
    task draws are the graph's generators; the PCGrad orders in ``words``
    come from ``streams["pcgrad"]``). The steps equal ``make_train_step``'s
    on the same batches, PCGrad orders and streams."""
    body = StepBody(model, cfg, optimizer, total_steps, streams["views"],
                    streams["task_draws"])
    runner = ChunkRunner(body, model, optimizer, streams)
    return runner, runner.metric_names


def make_eval_fn(model: PretrainableGNN, cfg: config.PretrainConfig,
                 total_steps: int, views: ViewSource, draws: Optional[TaskDraws] = None):
    """``eval_task_batch(task, domain, batch, step) -> loss`` in eval mode;
    each call takes fresh views, masks and negatives."""
    device = next(model.parameters()).device
    draws = draws if draws is not None else TaskDraws(device)
    temperature = _device_table(temperature_table(total_steps), device)
    grl_lambda = _device_table(grl_lambda_table(total_steps), device)

    @torch.no_grad()
    def eval_task_batch(task: str, domain: str, batch, step: int) -> torch.Tensor:
        model.eval()
        ctx = TaskContext(temperature=_at(temperature, step), views=views,
                          grl_lambda=_at(grl_lambda, step), draws=draws)
        loss, _ = compute_task_loss(task, model, {domain: batch}, ctx)
        if nan_checks_enabled():
            check_finite(f"eval at step {step}", [(f"task {task} loss on {domain}", loss)])
        return loss

    return eval_task_batch


def run_evaluation(eval_fn, state: PretrainState, cfg, val_loaders, logger,
                   global_step: int):
    """Every (task, domain, batch) loss, fetched in one transfer; returns
    (balanced total, metrics, the balancer's new step count)."""
    losses = {(task, domain): [eval_fn(task, domain, b, state.opt_step) for b in batches]
              for task in cfg.active_tasks for domain, batches in val_loaders.items()}
    values = torch.stack([v for vs in losses.values() for v in vs]).cpu().numpy()
    bounds = np.cumsum([0] + [len(vs) for vs in losses.values()])
    fetched = {k: values[a:b] for k, a, b in zip(losses, bounds[:-1], bounds[1:])}

    per_task = {}
    per_domain_task = {d: {} for d in val_loaders}
    for task in cfg.active_tasks:
        domain_means = []
        for domain in val_loaders:
            m = float(np.mean(fetched[(task, domain)]))
            per_domain_task[domain][task] = m
            domain_means.append(m)
        per_task[task] = float(np.mean(domain_means))
    main = {t: v for t, v in per_task.items() if t != "domain_adv"}
    total, balancer_step = np_balance(main, state.balancer_step)

    metrics = {}
    for d, tasks in per_domain_task.items():
        for t, v in tasks.items():
            metrics[f"val/loss/{d}/{t}"] = v
        metrics[f"val/loss/{d}"] = float(np.mean(list(tasks.values())))
    for t, v in per_task.items():
        metrics[f"val/loss/{t}"] = v
    metrics["val/loss/total"] = total
    if "domain_adv" in per_task:
        metrics["val/domain_adv/loss"] = per_task["domain_adv"]
    logger.log(metrics, step=global_step)
    return total, metrics, balancer_step


def pretrain(cfg: config.PretrainConfig, aggregation: str = "pallas",
             epochs: int = config.PRETRAIN_EPOCHS, processed_dir=None,
             use_wandb: bool = False, resume: bool = False, out_root=None,
             device=None, data_parallel: bool = False, axis=None,
             chunk_steps: int = 32) -> Dict[str, object]:
    """Pretrain one scheme and return ``{best_val_total, epochs, checkpoint}``.

    Runs on the card unless ``device="cpu"``. Checkpoints (and, with
    ``resume``, the resume file) go to ``out_root/pretrain``, metrics to
    ``out_root/metrics``. A resume file written at the last epoch leaves
    nothing to train: the summary is written and ``epochs`` is that epoch.
    ``data_parallel`` on ``axis`` (else ``make_mesh(device)``): see the
    module docstring. On one device with ``chunk_steps > 1`` the steps run
    through the chunked runner, ``min(chunk_steps, steps_per_epoch)`` to a
    chunk (the last of an epoch ragged), their metrics fetched every
    ``CHUNK_FLUSH_EVERY`` chunks; the data-parallel path, ``chunk_steps=1``
    and the NaN-checked path (``--debug_nans``) run step by step."""
    device = resolve_device(device)
    axis = (axis or make_mesh(device)) if data_parallel else None
    if axis is not None and axis.size == 1:
        axis = None                      # one rank: the single-device path
    if axis is not None:
        device = axis.device
    lead = axis is None or axis.rank == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    out_root = Path(out_root or config.OUTPUT_DIR)
    ckpt_path = out_root / "pretrain" / f"model_{cfg.run_name}.msgpack"
    resume_path = out_root / "pretrain" / f"resume_{cfg.run_name}.msgpack"
    logger = SilentLogger()
    if lead:
        (out_root / "pretrain").mkdir(parents=True, exist_ok=True)
        logger = MetricLogger(config.PRETRAIN_PROJECT_NAME, cfg.run_name,
                              out_dir=out_root / "metrics", use_wandb=use_wandb)

    model = build_pretrain_model(cfg, aggregation, device, axis)
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    streams = random_streams(cfg, model, device, axis)
    val_loaders = {d: [b.to(device) for b in
                       create_pretrain_val_loader(d, processed_dir=processed_dir)]
                   for d in cfg.pretrain_domains} if lead else {}
    train_loader = create_pretrain_train_loader(cfg.pretrain_domains, streams["sampler"],
                                                processed_dir=processed_dir)
    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * epochs
    chunked = axis is None and chunk_steps > 1 and not nan_checks_enabled()
    if chunked:
        chunk = int(min(chunk_steps, steps_per_epoch))
        run_chunk, metric_names = make_chunked_train_step(model, cfg, optimizer,
                                                          total_steps, streams)
        layout = StepLayout.of_loader(train_loader, len(run_chunk.body.tasks))
        train_step = None
    else:
        train_step = make_train_step(model, cfg, optimizer, total_steps, streams["views"],
                                     streams["pcgrad"], streams["task_draws"], axis=axis)
    if axis is None:
        train_batches = train_loader.__iter__
    else:
        pads = dp_pads(train_loader, axis.size)

        def train_batches():
            for _ in range(steps_per_epoch):
                yield shard_sampler_step(train_loader, axis.size, axis.rank, pads)

    state = PretrainState()
    eval_fn = make_eval_fn(model, cfg, total_steps, streams["views"], streams["task_draws"])

    # Aggregations per step and domain: two views per contrastive task.
    forwards = sum(2 if t in ("node_contrast", "graph_contrast") else 1
                   for t in cfg.active_tasks)
    meter = ThroughputMeter()
    # (first step, epoch, device metrics, real edges): one step's metric dict
    # and edge count, or one chunk's packed [M, chunk] metrics and edges [chunk].
    pending: List[tuple] = []

    def flush_pending():
        if not pending:
            return
        if chunked:
            values = torch.cat([m for _, _, m, _ in pending], dim=1).cpu().numpy().T
            keys = list(metric_names)
            steps = [(s0 + j, ep, e) for s0, ep, _, edges in pending
                     for j, e in enumerate(edges)]
        else:
            keys = sorted(pending[0][2])
            values = torch.stack([torch.stack([m[k].to(torch.float32).reshape(())
                                               for k in keys])
                                  for _, _, m, _ in pending]).cpu().numpy()
            steps = [(s0, ep, e) for s0, ep, _, e in pending]
        for (step, epoch_of, edges), row in zip(steps, values):
            m = {k: float(v) for k, v in zip(keys, row)}
            m["train/progress/epoch"] = epoch_of
            meter.update(float(edges), forwards * config.GNN_NUM_LAYERS)
            m.update(meter.metrics())
            logger.log(m, step=step)
        pending.clear()

    best_total = float("inf")
    epochs_since_improvement = 0
    global_step = 0
    start_epoch = 1
    if resume and resume_path.exists():
        counters = load_resume_state(resume_path, model, optimizer, cfg, streams, axis)
        state.opt_step, state.balancer_step = counters["opt_step"], counters["balancer_step"]
        start_epoch = counters["epoch"] + 1
        best_total = counters["best_total"]
        epochs_since_improvement = counters["epochs_since_improvement"]
        global_step = counters["opt_step"]
        if lead:
            print(f"resumed {cfg.run_name} at epoch {start_epoch} "
                  f"(best_val={best_total:.4f})", flush=True)
    first_step = global_step + 1
    if chunked and device.type == "cuda" and start_epoch <= epochs:
        # Capture before the first upload, after the resume file is loaded
        # (it replaces the optimizer's state tensors).
        run_chunk.capture(state, torch.from_numpy(warmup_row(train_loader, layout)), layout)
        print(f"[{cfg.run_name} +{time.time() - t_start:7.1f}s] train step captured "
              f"({sum(run_chunk.capture_launches.values())} kernel launches counted)",
              flush=True)

    def upload(item):
        words, edges = item
        return words.to(device, non_blocking=True), edges

    epoch = start_epoch - 1          # the loop is empty after a last-epoch resume
    for epoch in range(start_epoch, epochs + 1):
        if chunked:
            chunks = chunk_batches(train_loader, layout, steps_per_epoch, chunk,
                                   streams["pcgrad"], pin=device.type == "cuda")
            for words, step_edges in prefetched(chunks, put=upload):
                packed = run_chunk(state, words, layout)
                pending.append((global_step + 1, epoch, packed, step_edges))
                global_step += len(step_edges)
                if len(pending) >= CHUNK_FLUSH_EVERY:
                    flush_pending()
                if global_step - len(step_edges) + 1 == first_step:
                    meter.reset()        # the first chunk is not counted
        else:
            for host_batches in train_batches():
                global_step += 1
                edges = int(sum(float(b.edge_mask.sum()) for b in host_batches.values()))
                if axis is not None:        # the global batch's: every rank's share
                    edges = axis.psum(torch.tensor([float(edges)], device=device))
                batches = {d: b.to(device) for d, b in host_batches.items()}
                metrics = train_step(state, batches)
                if lead:
                    pending.append((global_step, epoch, metrics, edges))
                if len(pending) >= FLUSH_EVERY:
                    flush_pending()
                if global_step == first_step:
                    meter.reset()            # the first step's warm-up is not counted
        flush_pending()

        if lead:
            total, val_metrics, state.balancer_step = run_evaluation(
                eval_fn, state, cfg, val_loaders, logger, global_step)
            print(f"[{cfg.run_name} +{time.time() - t_start:7.1f}s] epoch {epoch}: "
                  f"{steps_per_epoch} steps, val_total={total:.4f}", flush=True)
        if axis is not None:            # rank 0's evaluation decides for every rank
            total, state.balancer_step = axis.from_rank0(
                (total, state.balancer_step) if lead else None)
        if total < best_total:
            best_total = total
            epochs_since_improvement = 0
            if lead:
                variables = model_variables(model)
                save_checkpoint(ckpt_path, variables["params"], variables["batch_stats"],
                                epoch, val_metrics)
        else:
            epochs_since_improvement += 1
        if resume and (epoch % RESUME_EVERY == 0 or epoch == epochs):
            save_resume_state(resume_path, model, optimizer, cfg, state, streams, epoch,
                              best_total, epochs_since_improvement, axis)
        if epochs_since_improvement >= int(epochs * config.PRETRAIN_PATIENCE_FRACTION):
            break
    if chunked:
        run_chunk.release()

    logger.finish(extra=fidelity_block(epochs, cfg.seed, aggregation, processed_dir,
                                       cfg.pretrain_domains))
    if axis is not None:
        axis.barrier()          # rank 0's files are written when any rank returns
    return {"best_val_total": best_total, "epochs": epoch, "checkpoint": str(ckpt_path)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_name", type=str, required=True,
                        choices=config.ALL_SCHEMES)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--epochs", type=int, default=config.PRETRAIN_EPOCHS)
    parser.add_argument("--aggregation", type=str, default="pallas",
                        choices=["dense", "pallas", "coo"])
    parser.add_argument("--processed_dir", type=str, default=None)
    parser.add_argument("--out_root", type=str, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="save the train state every 5 epochs and carry on "
                             "from it when it exists")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda unless given (cpu runs the plain versions)")
    parser.add_argument("--wandb", action="store_true",
                        help="mirror the metrics to wandb (must be installed)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="anomaly mode and a finite check of every loss, "
                             "gradient and update; raise at the first NaN")
    parser.add_argument("--data_parallel", action="store_true",
                        help="under a multi-process launcher: shard each step's "
                             "graphs over the node's ranks (one rank: the "
                             "single-device path)")
    args = parser.parse_args(argv)
    if args.debug_nans:
        enable_nan_checks()
    cfg = config.PretrainConfig(exp_name=args.exp_name, seed=args.seed)
    print(pretrain(cfg, aggregation=args.aggregation, epochs=args.epochs,
                   processed_dir=args.processed_dir, use_wandb=args.wandb,
                   resume=args.resume, out_root=args.out_root, device=args.device,
                   data_parallel=args.data_parallel))


if __name__ == "__main__":
    main()
