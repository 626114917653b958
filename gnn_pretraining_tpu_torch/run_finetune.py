"""Fine-tuning sweep driver of the port.

    python -m gnn_pretraining_tpu_torch.run_finetune --sweep [--resume]
    python -m gnn_pretraining_tpu_torch.run_finetune --domain_sweep Cora_NC
    python -m gnn_pretraining_tpu_torch.run_finetune --domain_name ENZYMES \\
        --finetune_strategy full_finetune --pretrained_scheme b1 --seed 42

The counterpart of the JAX package's ``run_finetune.py``, with the same
flags. ``--sweep`` runs the 324-cell grid (domain x strategy x scheme x
seed, in the JAX package's order) in one process, ``--domain_sweep D`` the
cells of one domain, and the cell flags one cell; the shard flags are
``run_pretrain``'s. In every mode ``--resume`` skips a cell whose summary
carries a completed ``fidelity/*`` block matching the run asked for, and a
cell from a pretrained scheme is skipped unless that scheme's pretrain
summary is complete at ``config.PRETRAIN_EPOCHS`` (``pretrain_ready``): a
checkpoint is written at every new best epoch, so one exists even when the
pretrain run died part-way. A cell that raises is printed with its traceback
and the sweep goes on; ``main`` returns 2 when any cell failed or was
skipped by ``pretrain_ready``.

``--isolate N`` with ``--sweep`` or ``--domain_sweep`` runs the grid as
child processes of N cells each, as ``run_pretrain`` does (a child of a
domain sweep gets ``--domain_sweep`` in place of ``--sweep``, so that its
slice indexes the same grid); an in-process sweep writes the pidfile and
clears the caches past the RSS bound, as there.

Runs on the card unless ``--device cpu`` (under a launcher,
``cuda:LOCAL_RANK``), resolved once before the grid; writes under
``config.OUTPUT_DIR`` (``outputs/torch/``) unless ``--out_root``.

``--dp auto`` forms the data axis as ``run_pretrain`` does and runs each
graph-classification cell data-parallel
(``finetune(data_parallel=True)``, ``finetune/gc_data_parallel.py``).
``--partition edge|node`` forms the same axis and runs each node or link
cell over it, edge-partitioned (``finetune(edge_parallel=True)``,
``finetune/edge_parallel.py``) or node-partitioned with a halo exchange
(``finetune(node_parallel=True)``, ``finetune/node_parallel.py``), as the
JAX driver's ``_parallel_kwargs`` maps the flags; it leaves graph
classification cells alone, and the two flags go together. A cell that
the flags give no multi-rank path runs on rank 0 of the axis alone, while
the other ranks go on to the next cell and wait for it there. With no
launcher and more than one card either flag starts one rank per card; with
one card the cells take the single-device path.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
import traceback
from typing import List, Tuple

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.finetune.finetune import finetune, parallel_mode
from gnn_pretraining_tpu_torch.parallel.mesh import close_mesh
from gnn_pretraining_tpu_torch.run_pretrain import (
    add_common_args,
    child_flags,
    data_axis,
    dp_auto,
    launcher_device,
    metrics_root,
    run_isolated,
    shard_grid,
    shard_label,
    slice_grid,
    spawn_dp_ranks,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device
from gnn_pretraining_tpu_torch.utils.fidelity import cell_completed as summary_completed
from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block
from gnn_pretraining_tpu_torch.utils.runtime import maybe_clear_caches, write_pidfile


def cell_completed(cfg: config.FinetuneConfig, args) -> bool:
    """As ``run_pretrain.cell_completed``, for a fine-tune cell."""
    path = metrics_root(args) / config.FINETUNE_PROJECT_NAME / f"{cfg.run_name}.summary.json"
    return summary_completed(path, fidelity_block(
        args.epochs or cfg.epochs, cfg.seed, args.aggregation, args.processed_dir,
        (cfg.domain_name,)))


def pretrain_ready(scheme: str, seed: int, args) -> bool:
    """A fine-tune cell may start from ``scheme``'s checkpoint only when that
    pretrain summary is complete at ``config.PRETRAIN_EPOCHS``, whatever
    ``--epochs`` the fine-tune asks for. ``b1`` trains from scratch."""
    if scheme == "b1":
        return True
    pcfg = config.PretrainConfig(exp_name=scheme, seed=seed)
    path = metrics_root(args) / config.PRETRAIN_PROJECT_NAME / f"{pcfg.run_name}.summary.json"
    return summary_completed(path, fidelity_block(
        config.PRETRAIN_EPOCHS, seed, args.aggregation, args.processed_dir,
        pcfg.pretrain_domains))


def full_grid() -> List[Tuple[str, str, str, int]]:
    return [(d, st, sc, seed)
            for d in config.FINETUNE_DOMAINS
            for st in config.FINETUNE_STRATEGIES
            for sc in config.FINETUNE_SCHEMES
            for seed in config.SEEDS]


def run_grid(grid, args, device: torch.device) -> list:
    """Fine-tune the cells of ``grid`` in order; returns the ones that failed
    or were skipped for want of a complete pretrain."""
    write_pidfile()         # lets a job that needs the card find this sweep
    print(f"Fine-tuning sweep: {len(grid)} runs (shard {shard_label(args)})",
          flush=True)
    failed = []
    for i, (domain, strategy, scheme, seed) in enumerate(grid):
        cfg = config.FinetuneConfig(domain_name=domain, finetune_strategy=strategy,
                                    pretrained_scheme=scheme, seed=seed)
        tag = f"[{i + 1}/{len(grid)}] {cfg.run_name}"
        if args.resume and cell_completed(cfg, args):
            print(f"{tag}: already complete, skipping", flush=True)
            continue
        if not pretrain_ready(scheme, seed, args):
            failed.append(cfg.run_name)
            print(f"{tag}: SKIPPED — pretrain {scheme}_{seed} has no completed-fidelity "
                  "marker", flush=True)
            continue
        axis = data_axis(args, device)
        multi = axis is not None and axis.size > 1
        mode = parallel_mode(cfg, data_parallel=dp_auto(args),
                             edge_parallel=args.partition == "edge",
                             node_parallel=args.partition == "node") if multi else None
        if multi and mode is None and axis.rank:
            print(f"{tag}: no multi-rank path, runs on rank 0", flush=True)
            continue
        print(f"{tag}: starting", flush=True)
        t0 = time.time()
        try:
            res = finetune(cfg, aggregation=args.aggregation, processed_dir=args.processed_dir,
                           epochs=args.epochs, out_root=args.out_root, device=device,
                           use_wandb=args.wandb, data_parallel=mode == "data",
                           edge_parallel=mode == "edge", node_parallel=mode == "node",
                           axis=axis)
            key = "test/auc" if cfg.task_type == "link_prediction" else "test/accuracy"
            print(f"{tag}: {key}={res[key]:.4f} ({time.time() - t0:.0f}s)", flush=True)
        except Exception:
            traceback.print_exc()
            if mode is not None:        # the other ranks wait in a collective
                raise
            failed.append(cfg.run_name)
            print(f"{tag}: FAILED", flush=True)
        # As in run_pretrain.run_sweep: free the finished cell before the next.
        gc.collect()
        if maybe_clear_caches():
            print(f"{tag}: cleared caches (host RSS bound)", flush=True)
    print(f"\n{len(failed)} failed runs: {failed}" if failed else "\nAll runs completed.",
          flush=True)
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(parser)
    parser.add_argument("--domain_sweep", type=str, default=None,
                        choices=config.FINETUNE_DOMAINS)
    parser.add_argument("--domain_name", type=str, default=None,
                        choices=config.FINETUNE_DOMAINS)
    parser.add_argument("--finetune_strategy", type=str, default=None,
                        choices=config.FINETUNE_STRATEGIES)
    parser.add_argument("--pretrained_scheme", type=str, default=None,
                        choices=config.FINETUNE_SCHEMES)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--aggregation", type=str, default="pallas",
                        choices=["dense", "pallas", "coo", "csr"])
    parser.add_argument("--partition", type=str, default="none",
                        choices=["none", "edge", "node"],
                        help="split node / link cells over the ranks (as --dp auto "
                             "forms them): 'edge' = edge-partitioned aggregation "
                             "(summed [N,F] partials), 'node' = node partitioning "
                             "with a halo exchange (bytes with the edge cut); "
                             "graph-classification cells ignore it")
    args = parser.parse_args(argv)
    if args.sweep:
        grid = full_grid()
    elif args.domain_sweep:
        grid = [c for c in full_grid() if c[0] == args.domain_sweep]
    elif not all((args.domain_name, args.finetune_strategy, args.pretrained_scheme)) \
            or args.seed is None:
        parser.error("provide --sweep, --domain_sweep, or all of --domain_name "
                     "--finetune_strategy --pretrained_scheme --seed")
    else:
        grid = [(args.domain_name, args.finetune_strategy, args.pretrained_scheme, args.seed)]
    if args.isolate < 0:
        parser.error("--isolate takes a positive number of cells per child")
    grid = slice_grid(shard_grid(grid, args), args)
    if args.isolate and (args.sweep or args.domain_sweep):
        flags = child_flags(args)
        if args.domain_sweep and not args.sweep:
            flags[0:1] = ["--domain_sweep", args.domain_sweep]

        def incomplete(cell):
            cfg = config.FinetuneConfig(domain_name=cell[0], finetune_strategy=cell[1],
                                        pretrained_scheme=cell[2], seed=cell[3])
            return None if cell_completed(cfg, args) else cfg.run_name
        return run_isolated("gnn_pretraining_tpu_torch.run_finetune", grid, args, flags,
                            incomplete)
    rc = spawn_dp_ranks("gnn_pretraining_tpu_torch.run_finetune", args, argv)
    if rc is not None:
        return rc
    device = resolve_device(launcher_device(args))
    failed = run_grid(grid, args, device)
    close_mesh()
    return 2 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
