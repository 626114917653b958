"""Two gloo ranks on the CPU for the port's data-parallel tests
(``tests/test_torch_dp_*.py``).

``run_ranks(tmp, job, inputs)`` writes ``inputs`` to ``tmp``, starts two
processes (``python -c`` importing this module, one intra-op thread each),
which form a gloo group over a ``FileStore`` under ``tmp``, build the data
axis (``parallel.mesh.make_mesh``) and run ``JOBS[job](axis, inputs)``, and
returns each rank's result dict. The ranks import torch and the port alone,
never JAX: the test process holds the JAX reference.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
RANK_TIMEOUT_S = 300

JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def run_ranks(tmp: Path, name: str, inputs: dict) -> list:
    """Rank 0's and rank 1's results of ``JOBS[name]`` on ``inputs``."""
    tmp = Path(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import torch_dp_helpers as h; h.rank_main()",
         str(r), str(tmp), name], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(RANKS)]
    outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    failed = [f"rank {r} of {name} exited {p.returncode}:\n{out[-3000:]}"
              for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise AssertionError("\n".join(failed))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]


def rank_main() -> None:
    import torch.distributed as dist

    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.parallel.mesh import make_mesh

    rank, tmp, name = int(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    for key, value in inputs.get("config", {}).items():
        if isinstance(value, dict):
            getattr(config, key).update(value)
        else:
            setattr(config, key, value)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), RANKS),
                            rank=rank, world_size=RANKS)
    try:
        out = JOBS[name](make_mesh("cpu", dist.group.WORLD), inputs)
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def rows(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's contiguous share of the rows of ``x``."""
    n = x.shape[0] // axis.size
    return x[axis.rank * n:(axis.rank + 1) * n]


@job
def parts(axis, inputs):
    """SyncBN forward, gradients and running statistics on this rank's rows;
    the gathered NT-Xent, plain and through the K2 wrapper (its plain
    version on the CPU), with the gradients of this rank's rows."""
    from gnn_pretraining_tpu_torch.models.norm import MaskedBatchNorm
    from gnn_pretraining_tpu_torch.ops.sddmm import nt_xent_loss
    from gnn_pretraining_tpu_torch.pretrain.tasks import _nt_xent

    bn = inputs["bn"]
    layer = MaskedBatchNorm(bn["x"].shape[1], device="cpu", axis=axis)
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(layer, name).copy_(bn[name])
    x = rows(bn["x"], axis).clone().requires_grad_(True)
    y = layer(x, rows(bn["mask"], axis))
    gx, gw, gb = torch.autograd.grad((y * rows(bn["w"], axis)).sum(),
                                     [x, layer.weight, layer.bias])
    out = {"y": y.detach(), "gx": gx, "gw": gw, "gb": gb,
           "running_mean": layer.running_mean.clone(), "running_var": layer.running_var.clone()}

    nt = inputs["ntxent"]
    for route, fn in (("plain", lambda *a: nt_xent_loss(*a, axis=axis)),
                      ("task", lambda *a: _nt_xent(*a, axis))):
        z1, z2 = (rows(nt[k], axis).clone().requires_grad_(True) for k in ("z1", "z2"))
        loss_sum, num_rows = fn(z1, z2, nt["temperature"], rows(nt["valid"], axis))
        g1, g2 = torch.autograd.grad(loss_sum, [z1, z2])
        out[route] = {"loss_sum": loss_sum.detach(), "rows": num_rows, "g1": g1, "g2": g2}
    return out


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@job
def step(axis, inputs):
    """One s5 data-parallel pretrain step on this rank's share, with the
    injected views, masks, negatives and PCGrad order, recording its ReLU
    branches and max-pool winners; a second step on the rank's own draws;
    one graph-classification train step and one eval step of the
    data-parallel fine-tune on this rank's share of a batch; a
    data-parallel ``pretrain()`` resumed from its own file."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.gc_data_parallel import (
        make_gc_steps_data_parallel,
    )
    from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
    from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
    from gnn_pretraining_tpu_torch.parallel.data_parallel import make_dp_train_step, rank_seed
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain import tasks
    from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer
    from gnn_pretraining_tpu_torch.utils import relu_branches

    mine = inputs["ranks"][axis.rank]
    cfg = config.PretrainConfig(inputs["scheme"], 0)
    model = PretrainableGNN(cfg.pretrain_domains, cfg.active_tasks, "dense", device="cpu",
                            axis=axis)
    model.load_state_dict(inputs["state_dict"])
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    views = ViewSource(seed=rank_seed(2, axis.rank))
    views.inject(mine["views"])
    draws = tasks.TaskDraws(seed=rank_seed(4, axis.rank))
    draws.inject(mine["mask_scores"], mine["negatives"])
    train_step = make_dp_train_step(model, cfg, optimizer, inputs["total_steps"], axis, views,
                                    torch.Generator().manual_seed(3), draws)
    state = pt.PretrainState(opt_step=inputs["step"])
    pooled = []
    with relu_branches.record(model) as branches, \
            relu_branches.max_pool(tasks, record=pooled):
        metrics = train_step(state, mine["batches"], perm=inputs["perm"])
    assert not views.injected and not draws.injected_masks and not draws.injected_negatives
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "task_grads": {t: [g.clone() for g in gs]
                          for t, gs in train_step.last_task_grads.items()},
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
           "after_one": _state(model), "branches": branches, "pooled": pooled}
    train_step(state, mine["second_batches"])
    out["after_two"] = _state(model)

    gc = inputs["gc"]
    fcfg = config.FinetuneConfig("ENZYMES", "full_finetune", "b1", 0)
    fmodel = FinetuneGNN("ENZYMES", "coo", device="cpu", axis=axis)
    fmodel.load_state_dict(gc["state_dict"])
    foptimizer, labels, _ = ft.create_finetune_optimizer(fmodel, fcfg)
    train, evaluate = make_gc_steps_data_parallel(fmodel, fcfg, foptimizer, labels, axis)
    with relu_branches.record(fmodel) as gc_branches:
        out["gc_train"] = [x.detach().clone() for x in train(gc["batches"][axis.rank])]
    out["gc_branches"] = gc_branches
    out["gc_grads"] = {n: p.grad.clone() for n, p in fmodel.named_parameters()
                       if p.grad is not None}
    out["gc_after"] = _state(fmodel)
    out["gc_eval"] = [x.clone() for x in evaluate(gc["batches"][axis.rank])]

    # pretrain(data_parallel=True) for 1 epoch with --resume; its file
    # restored on every rank; then 2 epochs, which carry on from it.
    rs = inputs["resume"]
    rcfg = config.PretrainConfig("b4", 42)
    kw = dict(processed_dir=rs["stores"], out_root=rs["root"], device="cpu",
              data_parallel=True, axis=axis, resume=True)
    runs = [pt.pretrain(rcfg, epochs=1, **kw)]
    rmodel = pt.build_pretrain_model(rcfg, "pallas", "cpu", axis)
    roptimizer, _, _ = create_task_specific_optimizer(rmodel, rcfg.active_tasks)
    streams = pt.random_streams(rcfg, rmodel, "cpu", axis)
    counters = pt.load_resume_state(Path(rs["root"]) / "pretrain" / "resume_b4_42.msgpack",
                                    rmodel, roptimizer, rcfg, streams, axis)
    out["restored"] = {"state": _state(rmodel), "streams": pt.stream_states(streams),
                       "counters": counters}
    runs.append(pt.pretrain(rcfg, epochs=2, **kw))
    out["resume_runs"] = runs
    return out
