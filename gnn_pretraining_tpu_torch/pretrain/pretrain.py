"""Pretraining runtime: the multi-task train step and the host loop.

Port of ``gnn_pretraining_tpu/pretrain/pretrain.py`` (reference
src/pretrain/pretrain.py:96-353), the per-step path. One train step:

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

Every scheme of ``config.ALL_SCHEMES`` runs. Left for later: the chunked
``lax.scan`` runner (its per-step semantics are these), ``--data_parallel``
and ``--debug_nans``.
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
from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource
from gnn_pretraining_tpu_torch.pretrain.balancer import balance_losses, np_balance
from gnn_pretraining_tpu_torch.pretrain.optimizers import (
    clip_grads_torch,
    create_task_specific_optimizer,
    param_labels,
)
from gnn_pretraining_tpu_torch.pretrain.pcgrad import apply_pcgrad
from gnn_pretraining_tpu_torch.pretrain.schedulers import grl_lambda_at, temperature_at
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
from gnn_pretraining_tpu_torch.utils.logging import MetricLogger
from gnn_pretraining_tpu_torch.utils.profiling import ThroughputMeter

FLUSH_EVERY = 8          # train steps between two fetches of their metrics
RESUME_EVERY = 5         # epochs between two resume files (and the last one)


@dataclasses.dataclass
class PretrainState:
    """The counters the JAX ``TrainState`` threads beside params and optimizer
    (which live in the model and the AdamW here)."""
    opt_step: int = 0        # scheduler step (pre-step value)
    balancer_step: int = 0   # the balancer's step count


def build_pretrain_model(cfg: config.PretrainConfig, aggregation: str,
                         device) -> PretrainableGNN:
    """Initialised from ``cfg.seed``; dropout seeded ``cfg.seed + 1``."""
    model = PretrainableGNN(cfg.pretrain_domains, cfg.active_tasks, aggregation,
                            generator=torch.Generator().manual_seed(cfg.seed),
                            device=device)
    model.seed_dropout(cfg.seed + 1)
    return model


def random_streams(cfg: config.PretrainConfig, model: PretrainableGNN,
                   device) -> Dict[str, Any]:
    """Every random stream of a run, seeded from ``cfg.seed``: the sampler's
    numpy generator (seed), the model's dropout (seed + 1, set by
    ``build_pretrain_model``), the views (seed + 2), PCGrad's task order
    (seed + 3, on the CPU) and the masks and negatives (seed + 4)."""
    return {"sampler": np.random.default_rng(cfg.seed),
            "dropout": model.dropout,
            "views": ViewSource(device, seed=cfg.seed + 2),
            "pcgrad": torch.Generator().manual_seed(cfg.seed + 3),
            "task_draws": TaskDraws(device, seed=cfg.seed + 4)}


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
                      best_total: float, epochs_since_improvement: int) -> None:
    """Write the run's train state after ``epoch`` (``utils.checkpoint.
    save_train_state``; the stream states under ``extra``)."""
    variables = model_variables(model)
    opt_state = adamw_to_opt_state(model, optimizer, param_labels(model, cfg.active_tasks),
                                   ["default", *cfg.active_tasks])
    counters = {"opt_step": state.opt_step, "balancer_step": state.balancer_step,
                "epoch": epoch, "best_total": best_total,
                "epochs_since_improvement": epochs_since_improvement}
    save_train_state(path, variables["params"], variables["batch_stats"], opt_state,
                     counters, extra={"streams": stream_states(streams)})


def load_resume_state(path, model: PretrainableGNN, optimizer, cfg: config.PretrainConfig,
                      streams: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a train-state file onto ``model``, ``optimizer`` and
    ``streams`` in place and return its counters. Raises, naming the key,
    where the file does not fit the model. A file without stream states (the
    JAX package's) leaves the streams at their seeds, and says so."""
    payload = load_train_state(path)
    load_variables(model, {"params": payload["params"],
                           "batch_stats": payload["batch_stats"]})
    load_adamw_state(payload["opt_state"], model, optimizer,
                     param_labels(model, cfg.active_tasks), ["default", *cfg.active_tasks])
    if "streams" in payload["extra"]:
        restore_streams(streams, payload["extra"]["streams"])
    else:
        print(f"{path} holds no random-stream states (a JAX package file): "
              "the streams start from their seeds", flush=True)
    return payload["counters"]


def _context(step: int, total_steps: int, views: ViewSource, draws: TaskDraws,
             device) -> TaskContext:
    temp = torch.tensor([temperature_at(step, total_steps)], device=device)
    lam = torch.tensor([grl_lambda_at(step, total_steps)], device=device)
    return TaskContext(temperature=temp, views=views, grl_lambda=lam, draws=draws)


def make_train_step(model: PretrainableGNN, cfg: config.PretrainConfig, optimizer,
                    total_steps: int, views: ViewSource,
                    pcgrad_generator: Optional[torch.Generator] = None,
                    draws: Optional[TaskDraws] = None):
    """``train_step(state, domain_batches, perm=None) -> metrics`` (device
    tensors). It updates the model, the optimizer and ``state``; ``perm``
    replaces PCGrad's draw of the task order; ``draws`` hands node-feature
    masking and link prediction their uniforms (unseeded by default: a
    scheme with those tasks needs one). ``train_step.last_task_grads`` holds
    the last step's per-task gradients (task -> one tensor per parameter, in
    ``named_parameters`` order), before PCGrad, the domain-adversarial one
    among them."""
    tasks = [t for t in cfg.active_tasks if t != "domain_adv"]
    has_da = "domain_adv" in cfg.active_tasks
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    top_keys = [n.split(".")[0] for n in names]
    device = params[0].device
    draws = draws if draws is not None else TaskDraws(device)

    def train_step(state: PretrainState, domain_batches, perm=None):
        model.train()
        ctx = _context(state.opt_step, total_steps, views, draws, device)
        task_losses, per_domain_task, grads = {}, {}, {}
        for t in tasks + ["domain_adv"] * has_da:
            loss, per_domain = compute_task_loss(t, model, domain_batches, ctx)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            grads[t] = [torch.zeros_like(p) if gi is None else gi
                        for p, gi in zip(params, g)]
            task_losses[t] = loss.detach()
            per_domain_task[t] = {d: v.detach() for d, v in per_domain.items()}

        train_step.last_task_grads = dict(grads)
        da_loss = task_losses.pop("domain_adv", None)
        da_grads = grads.pop("domain_adv", None)
        total, weights, state.balancer_step = balance_losses(task_losses,
                                                             state.balancer_step)
        if len(tasks) > 1:
            combined, metrics = apply_pcgrad(grads, top_keys,
                                             generator=pcgrad_generator, perm=perm)
        else:
            combined, metrics = grads[tasks[0]], {}
        if has_da:                                 # after PCGrad, before clipping
            combined = torch._foreach_add(combined, da_grads)
        clipped, pre_norm = clip_grads_torch(combined)
        for p, g in zip(params, clipped):
            p.grad = g
        optimizer.step()

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
        for d in cfg.pretrain_domains:
            metrics[f"train/loss/{d}"] = sum(per_domain_task[t][d] for t in per_domain_task)
        if has_da:
            metrics["train/loss/domain_adv"] = da_loss
            metrics["train/domain_adv/loss"] = da_loss
            # The reference logs λ after stepping its scheduler (pretrain.py:173).
            metrics["train/domain_adv/lambda"] = torch.tensor(
                grl_lambda_at(state.opt_step + 1, total_steps), device=device)
        state.opt_step += 1
        return metrics

    train_step.last_task_grads = None
    return train_step


def make_eval_fn(model: PretrainableGNN, cfg: config.PretrainConfig,
                 total_steps: int, views: ViewSource, draws: Optional[TaskDraws] = None):
    """``eval_task_batch(task, domain, batch, step) -> loss`` in eval mode;
    each call takes fresh views, masks and negatives."""
    device = next(model.parameters()).device
    draws = draws if draws is not None else TaskDraws(device)

    @torch.no_grad()
    def eval_task_batch(task: str, domain: str, batch, step: int) -> torch.Tensor:
        model.eval()
        ctx = _context(step, total_steps, views, draws, device)
        loss, _ = compute_task_loss(task, model, {domain: batch}, ctx)
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
             device=None) -> Dict[str, object]:
    """Pretrain one scheme and return ``{best_val_total, epochs, checkpoint}``.

    Runs on the card unless ``device="cpu"``. Checkpoints (and, with
    ``resume``, the resume file) go to ``out_root/pretrain``, metrics to
    ``out_root/metrics``. A resume file written at the last epoch leaves
    nothing to train: the summary is written and ``epochs`` is that epoch."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    out_root = Path(out_root or config.OUTPUT_DIR)
    (out_root / "pretrain").mkdir(parents=True, exist_ok=True)
    ckpt_path = out_root / "pretrain" / f"model_{cfg.run_name}.msgpack"
    resume_path = out_root / "pretrain" / f"resume_{cfg.run_name}.msgpack"
    logger = MetricLogger(config.PRETRAIN_PROJECT_NAME, cfg.run_name,
                          out_dir=out_root / "metrics", use_wandb=use_wandb)

    model = build_pretrain_model(cfg, aggregation, device)
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    streams = random_streams(cfg, model, device)
    val_loaders = {d: [b.to(device) for b in
                       create_pretrain_val_loader(d, processed_dir=processed_dir)]
                   for d in cfg.pretrain_domains}
    train_loader = create_pretrain_train_loader(cfg.pretrain_domains, streams["sampler"],
                                                processed_dir=processed_dir)
    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * epochs

    state = PretrainState()
    train_step = make_train_step(model, cfg, optimizer, total_steps, streams["views"],
                                 streams["pcgrad"], streams["task_draws"])
    eval_fn = make_eval_fn(model, cfg, total_steps, streams["views"], streams["task_draws"])

    # Aggregations per step and domain: two views per contrastive task.
    forwards = sum(2 if t in ("node_contrast", "graph_contrast") else 1
                   for t in cfg.active_tasks)
    meter = ThroughputMeter()
    pending: List[tuple] = []     # (step, epoch, device metrics, real edges)

    def flush_pending():
        if not pending:
            return
        keys = sorted(pending[0][2])
        values = torch.stack([torch.stack([m[k].to(torch.float32).reshape(())
                                           for k in keys])
                              for _, _, m, _ in pending]).cpu().numpy()
        for (step, epoch_of, _, edges), row in zip(pending, values):
            m = {k: float(v) for k, v in zip(keys, row)}
            m["train/progress/epoch"] = epoch_of
            meter.update(edges, forwards * config.GNN_NUM_LAYERS)
            m.update(meter.metrics())
            logger.log(m, step=step)
        pending.clear()

    best_total = float("inf")
    epochs_since_improvement = 0
    global_step = 0
    start_epoch = 1
    if resume and resume_path.exists():
        counters = load_resume_state(resume_path, model, optimizer, cfg, streams)
        state.opt_step, state.balancer_step = counters["opt_step"], counters["balancer_step"]
        start_epoch = counters["epoch"] + 1
        best_total = counters["best_total"]
        epochs_since_improvement = counters["epochs_since_improvement"]
        global_step = counters["opt_step"]
        print(f"resumed {cfg.run_name} at epoch {start_epoch} "
              f"(best_val={best_total:.4f})", flush=True)
    first_step = global_step + 1

    epoch = start_epoch - 1          # the loop is empty after a last-epoch resume
    for epoch in range(start_epoch, epochs + 1):
        for host_batches in train_loader:
            global_step += 1
            edges = int(sum(float(b.edge_mask.sum()) for b in host_batches.values()))
            batches = {d: b.to(device) for d, b in host_batches.items()}
            pending.append((global_step, epoch, train_step(state, batches), edges))
            if len(pending) >= FLUSH_EVERY:
                flush_pending()
            if global_step == first_step:
                meter.reset()            # the first step's warm-up is not counted
        flush_pending()

        total, val_metrics, state.balancer_step = run_evaluation(
            eval_fn, state, cfg, val_loaders, logger, global_step)
        print(f"[{cfg.run_name} +{time.time() - t_start:7.1f}s] epoch {epoch}: "
              f"{steps_per_epoch} steps, val_total={total:.4f}", flush=True)
        if total < best_total:
            best_total = total
            epochs_since_improvement = 0
            variables = model_variables(model)
            save_checkpoint(ckpt_path, variables["params"], variables["batch_stats"],
                            epoch, val_metrics)
        else:
            epochs_since_improvement += 1
        if resume and (epoch % RESUME_EVERY == 0 or epoch == epochs):
            save_resume_state(resume_path, model, optimizer, cfg, state, streams, epoch,
                              best_total, epochs_since_improvement)
        if epochs_since_improvement >= int(epochs * config.PRETRAIN_PATIENCE_FRACTION):
            break

    logger.finish(extra=fidelity_block(epochs, cfg.seed, aggregation, processed_dir,
                                       cfg.pretrain_domains))
    return {"best_val_total": best_total, "epochs": epoch, "checkpoint": str(ckpt_path)}


def main() -> None:
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
    args = parser.parse_args()
    cfg = config.PretrainConfig(exp_name=args.exp_name, seed=args.seed)
    print(pretrain(cfg, aggregation=args.aggregation, epochs=args.epochs,
                   processed_dir=args.processed_dir, use_wandb=args.wandb,
                   resume=args.resume, out_root=args.out_root, device=args.device))


if __name__ == "__main__":
    main()
