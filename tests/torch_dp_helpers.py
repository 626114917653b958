"""Two gloo ranks on the CPU for the port's data-parallel tests
(``tests/test_torch_dp_*.py``).

``run_ranks(tmp, job, inputs)`` writes ``inputs`` to ``tmp``, starts two
processes (``python -c`` importing this module, one intra-op thread each),
which form a gloo group over a ``FileStore`` under ``tmp``, build the data
axis (``parallel.mesh.make_mesh``) and run ``JOBS[job](axis, inputs)``, and
returns each rank's result dict. The ranks import torch and the port alone,
never JAX: the test process holds the JAX reference. The jobs: ``parts``
and ``step`` (data parallelism), ``partition_parts`` and
``partition_steps`` (the edge- and node-partitioned paths).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def full_graph(g: dict):
    """A one-graph ``GraphBatch`` of the numpy arrays ``g`` (``x``,
    ``senders``, ``receivers``, ``edge_mask``, ``node_mask``)."""
    from gnn_pretraining_tpu_torch.data.batch import GraphBatch

    n, e = g["x"].shape[0], g["senders"].shape[0]
    t = lambda a: torch.from_numpy(a.copy())  # noqa: E731
    return GraphBatch(
        x=t(g["x"]), senders=t(g["senders"]), receivers=t(g["receivers"]),
        edge_mask=t(g["edge_mask"]), edge_graph=torch.zeros(e, dtype=torch.int32),
        node_mask=t(g["node_mask"]), node_graph=torch.zeros(n, dtype=torch.int32),
        graph_mask=torch.ones(1), node_start=torch.zeros(1, dtype=torch.int32),
        n_node=torch.full((1,), n, dtype=torch.int32),
        n_edge=torch.full((1,), e, dtype=torch.int32), y=torch.zeros(1, dtype=torch.int32),
        graph_properties=torch.zeros(1, 12))


@job
def partition_parts(axis, inputs):
    """The all-to-all on a rank-numbered tensor (forward and the gradient of
    a weighted sum); the edge-partitioned aggregation, through
    ``gin_aggregate_coo(edge_axis=)`` on this rank's block and through
    ``edge_partitioned_aggregate``; the node-partitioned aggregation on this
    rank's rows: outputs and the gradients of ``sum(out * w)`` in h and eps."""
    from gnn_pretraining_tpu_torch.ops.spmm import gin_aggregate_coo
    from gnn_pretraining_tpu_torch.parallel.edge_partition import (
        edge_partitioned_aggregate,
        local_edges,
    )
    from gnn_pretraining_tpu_torch.parallel.node_partition import (
        build_node_partition_plan,
        node_partitioned_aggregate,
        pad_node_rows,
    )

    out = {}
    x = inputs["a2a"]["x"][axis.rank].clone().requires_grad_(True)
    y = axis.all_to_all(x)
    (y * inputs["a2a"]["w"][axis.rank]).sum().backward()
    out["a2a"] = {"y": y.detach(), "grad": x.grad, "route": axis.all_to_all_route("cpu"),
                  "calls": dict(axis.all_to_all_calls)}

    g = inputs["graph"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    def grads(fn, h_full, w):
        h = t(h_full).clone().requires_grad_(True)
        eps = torch.tensor(g["eps"], requires_grad=True)
        z = fn(h, eps)
        (z * t(w)).sum().backward()
        return {"z": z.detach(), "dh": h.grad, "deps": eps.grad}

    s, r, m = (t(a) for a in local_edges(g["senders"], g["receivers"], g["edge_mask"], axis))
    out["coo"] = grads(lambda h, eps: gin_aggregate_coo(h, s, r, m, eps, edge_axis=axis),
                       g["h"], g["w"])
    pad = inputs["shard_edges"]
    out["edge"] = grads(lambda h, eps: edge_partitioned_aggregate(
        axis, h, *(t(a) for a in pad), eps), g["h"], g["w"])

    plan = build_node_partition_plan(g["senders"], g["receivers"], g["edge_mask"],
                                     g["h"].shape[0], axis.size)
    rows = slice(axis.rank * plan.n_loc, (axis.rank + 1) * plan.n_loc)
    out["node"] = grads(lambda h, eps: node_partitioned_aggregate(axis, h, plan, eps),
                        pad_node_rows(g["h"], plan)[rows], pad_node_rows(g["w"], plan)[rows])
    out["node"]["calls"] = dict(axis.all_to_all_calls)
    return out


def _partitioned_model(domain, mode, axis, state_dict):
    """A ``coo`` model for ``mode`` on ``axis`` with ``state_dict``'s weights,
    and the head's own dropout source (node) or None (edge)."""
    from gnn_pretraining_tpu_torch.finetune import node_parallel
    from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
    from gnn_pretraining_tpu_torch.parallel.data_parallel import rank_seed

    if mode == "edge":
        model, head = FinetuneGNN(domain, "coo", device="cpu", edge_axis=axis), None
        model.seed_dropout(1)
    else:
        model = FinetuneGNN(domain, "coo", device="cpu", axis=axis,
                            aggregate_fn=node_parallel.HaloAggregate(axis))
        model.seed_dropout(rank_seed(1, axis.rank))
        head = node_parallel.replicate_head_dropout(model, 2)
    model.load_state_dict(state_dict)
    return model, head


@job
def partition_steps(axis, inputs):
    """For each (task, mode) of ``inputs["cases"]``: the partitioned eval step
    on the given weights, then a train step with the given dropout
    keep-masks (the node ranks take their rows) and, for link prediction,
    the given Gumbel draw of the miner, then a train step on the rank's own
    draws; outputs, gradients and the state after each train step. The first
    train step takes the given ReLU branches (the node ranks their rows)."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune import edge_parallel, node_parallel
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.mining import build_forbidden_mask
    from gnn_pretraining_tpu_torch.parallel.node_partition import pad_node_rows
    from gnn_pretraining_tpu_torch.utils import relu_branches

    graph = full_graph(inputs["graph"])
    out = {}
    for task, mode in inputs["cases"]:
        spec = inputs[task]
        cfg = config.FinetuneConfig(spec["domain"], "full_finetune", "b1", 0)
        model, head = _partitioned_model(spec["domain"], mode, axis, spec["state_dict"])
        optimizer, labels, _ = ft.create_finetune_optimizer(model, cfg)
        extra, trunk, branches = (), list(spec["trunk_masks"]), list(spec["branches"])
        if mode == "node":
            plan, shard = node_parallel.prepare(graph, axis, "cpu")
            extra = (shard,)
            rows = slice(axis.rank * plan.n_loc, (axis.rank + 1) * plan.n_loc)
            trunk = [torch.from_numpy(pad_node_rows(k.numpy(), plan)[rows]) for k in trunk]
            # The node rows' records to this rank's rows; the pairs' whole.
            branches = [torch.from_numpy(pad_node_rows(b.numpy(), plan)[rows])
                        if b.shape[0] == graph.num_nodes else b for b in branches]
        if task == "nc":
            if mode == "edge":
                train, evaluate = edge_parallel.make_nc_steps_edge_parallel(
                    model, cfg, optimizer, labels, graph, axis)
            else:
                train, evaluate = node_parallel.make_nc_steps_node_parallel(
                    model, cfg, optimizer, labels, axis)
            kwargs = {}
        else:
            forbidden = build_forbidden_mask(graph.num_nodes, spec["train_edges"],
                                             node_mask=inputs["graph"]["node_mask"])
            generator = torch.Generator().manual_seed(0)
            if mode == "edge":
                train, evaluate = edge_parallel.make_lp_steps_edge_parallel(
                    model, cfg, optimizer, labels, graph, axis, forbidden, spec["num_hard"],
                    generator)
            else:
                train, evaluate = node_parallel.make_lp_steps_node_parallel(
                    model, cfg, optimizer, labels, axis, forbidden, spec["num_hard"],
                    generator)
            kwargs = {"gumbel": spec["gumbel"]}
        case = {"eval": [a.clone() for a in evaluate(*spec["eval_args"], *extra)]}
        if head is None:
            model.dropout.inject(trunk + list(spec["head_masks"]))
        else:
            model.dropout.inject(trunk)
            head.inject(spec["head_masks"])
        with relu_branches.replay(model, branches) as flips:
            case["train"] = [a.detach().clone() for a in train(*spec["train_args"], *extra,
                                                               **kwargs)]
        case["relu_flips"] = sum(flips)
        assert not model.dropout.injected and (head is None or not head.injected)
        case["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}
        case["after_one"] = _state(model)
        train(*spec["train_args"], *extra)
        case["after_two"] = _state(model)
        out[f"{task}-{mode}"] = case
    return out
