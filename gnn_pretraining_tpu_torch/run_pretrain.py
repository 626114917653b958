"""Pretraining sweep driver of the port.

    python -m gnn_pretraining_tpu_torch.run_pretrain --sweep [--resume] [--isolate N]
    python -m gnn_pretraining_tpu_torch.run_pretrain --exp_name s2 --seed 42

The counterpart of the JAX package's ``run_pretrain.py``, with the same
flags. ``--sweep`` runs the 24-cell grid (each scheme of
``config.ALL_SCHEMES`` under each seed of ``config.SEEDS``) in one process,
cell after cell; ``--exp_name --seed`` runs one cell.
``--shard_index i --num_shards n`` keeps ``grid[i::n]`` (``--num_shards 24
--shard_index 12`` is s2 under seed 42). Without them a process started by a
multi-process launcher (``torchrun``: ``WORLD_SIZE``, ``RANK``) keeps
``grid[RANK::WORLD_SIZE]`` and runs on ``cuda:LOCAL_RANK``; no process group
is made, each process runs its own cells. ``--resume`` skips a cell whose
summary carries a completed ``fidelity/*`` block matching the run asked for
(``cell_completed``), and passes ``resume=True`` to ``pretrain()``, so a cell
that was cut short carries on from its train-state file. A cell that raises
is printed with its traceback and the sweep goes on; ``main`` returns 2 when
any cell failed.

``--sweep --isolate N`` runs the grid as child processes of N cells each
(``python -m gnn_pretraining_tpu_torch.run_pretrain`` with the same flags
and a slice of the grid), one after another, so that the host memory of a
cell goes back to the system with its child. The orchestrator touches no
card: between two children, where no process of the sweep holds the card,
it parks while a job has asked for the card (``utils.runtime.acquire_chip``);
with ``--resume`` it starts no child for a chunk that is complete; a child
that fails is logged and the pass goes on; ``main`` returns 1 when a cell is
still incomplete after the pass. Without shard flags an orchestrator runs
the whole grid. An in-process sweep records itself in the port's pidfile
(``utils.runtime.write_pidfile``), so such a job can find it, and after each
cell clears the caches once host RSS crosses its bound
(``utils.runtime.maybe_clear_caches``).

Runs on the card unless ``--device cpu``, resolved once before the grid.
Writes under ``config.OUTPUT_DIR`` (``outputs/torch/``) unless
``--out_root``. A production cell on the card (``--epochs`` at
``config.PRETRAIN_EPOCHS``, no ``--out_root``) adds its wall time and the
card's name and power limit to ``analysis/results/pretrain_timings_torch.json``.

``--dp auto`` runs every cell data-parallel (``pretrain(data_parallel=True)``,
``parallel/data_parallel.py``). Under a launcher the ``LOCAL_WORLD_SIZE``
ranks of a node form one data axis and step through the grid together, and
the grid is sharded over the nodes (``WORLD_SIZE // LOCAL_WORLD_SIZE``,
``GROUP_RANK``), as the JAX package shards it over processes and
data-parallelises over each one's devices; rank 0 of the axis alone writes.
Without a launcher, on a host with k > 1 cards, it starts k local ranks of
itself (``parallel.mesh.spawn_local_ranks``); with one card, or
``--device cpu``, it runs the single-device path. A cell that fails under
``--dp`` ends the run: the other ranks would wait for it in a collective.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.parallel.mesh import (
    close_mesh,
    launcher_env,
    make_mesh,
    spawn_local_ranks,
)
from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain
from gnn_pretraining_tpu_torch.utils.device import resolve_device
from gnn_pretraining_tpu_torch.utils.fidelity import cell_completed as summary_completed
from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block
from gnn_pretraining_tpu_torch.utils.runtime import honor_pause, maybe_clear_caches, write_pidfile

# The JAX package's pretrain_timings.json beside it holds TPU timings.
TIMINGS_FILE = config.REPO_ROOT / "analysis" / "results" / "pretrain_timings_torch.json"


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The flags both drivers take."""
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="skip cells whose summary says they completed at "
                             "this fidelity; carry on from a train-state file")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--shard_index", type=int, default=None)
    parser.add_argument("--num_shards", type=int, default=0)
    parser.add_argument("--out_root", type=str, default=None,
                        help="root for checkpoints and metrics (default: "
                             "outputs/torch); point trial runs elsewhere")
    parser.add_argument("--processed_dir", type=str, default=None,
                        help="alternate processed-data store (default: "
                             "data/processed)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda unless given (cpu runs the plain versions)")
    parser.add_argument("--wandb", action="store_true",
                        help="mirror the metrics to wandb (must be installed)")
    parser.add_argument("--no_wandb", action="store_true",
                        help="the default; accepted so that a JAX package "
                             "command line runs unchanged")
    parser.add_argument("--isolate", type=int, default=0, metavar="N",
                        help="with a sweep: run the grid as child processes of "
                             "N cells each (host memory goes back with each)")
    parser.add_argument("--dp", type=str, default="off", choices=["off", "auto"],
                        help="data parallelism: 'auto' shards each step's graphs over "
                             "the ranks of a node (a launcher's, else one per card of "
                             "this host); one rank runs the single-device path")
    parser.add_argument("--grid_start", type=int, default=0,
                        help=argparse.SUPPRESS)      # an --isolate child's slice
    parser.add_argument("--grid_count", type=int, default=0,
                        help=argparse.SUPPRESS)


def dp_auto(args) -> bool:
    """``--dp auto`` was given (a namespace without the flag: off)."""
    return getattr(args, "dp", "off") == "auto"


def multi_rank(args) -> bool:
    """The ranks of a node are wanted: ``--dp auto`` or run_finetune's
    ``--partition edge|node``."""
    return dp_auto(args) or getattr(args, "partition", "none") != "none"


def launcher_shard(dp: bool = False):
    """(shards, index) that a multi-process launcher gives this process
    (``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them), else (1, 0). Under
    ``dp`` (``--dp auto`` or ``--partition``) the ranks of a node share a
    shard: (nodes, ``GROUP_RANK``)."""
    env = launcher_env()
    if env is None:
        return 1, 0
    return (env["nodes"], env["node"]) if dp else (env["world"], env["rank"])


def shard_label(args) -> str:
    """The shard a sweep runs, for its log: the flags', or the launcher's."""
    if args.num_shards or args.isolate or args.grid_count or "WORLD_SIZE" not in os.environ:
        return f"{args.shard_index}/{args.num_shards}"
    n, i = launcher_shard(multi_rank(args))
    return f"{i}/{n} of the launcher"


def shard_grid(grid, args):
    """``grid[i::n]`` for ``--shard_index i --num_shards n``, else the
    launcher's shard (``launcher_shard``). One flag without the other is
    rejected: two machines started with only ``--num_shards 2`` would both
    run shard 0. An ``--isolate`` orchestrator without the flags runs the
    whole grid, and so do its children, whose slices index that grid."""
    if (args.num_shards > 0) != (args.shard_index is not None):
        raise SystemExit("--shard_index and --num_shards must be given together "
                         "(or neither, for the launcher's shard or the whole grid)")
    if args.num_shards:
        n, i = args.num_shards, args.shard_index
    elif args.isolate or args.grid_count:
        return grid
    else:
        n, i = launcher_shard(multi_rank(args))
    if not 0 <= i < max(n, 1):
        raise SystemExit(f"--shard_index {i} out of range for {n} shards")
    return grid[i::n] if n > 1 else grid


def slice_grid(grid, args):
    """The slice ``[grid_start, grid_start + grid_count)`` of the sharded
    grid that an ``--isolate`` child runs, else the grid. Slicing after
    sharding keeps a child's grid aligned with its parent's."""
    if args.grid_count:
        return grid[args.grid_start:args.grid_start + args.grid_count]
    return grid


def launcher_device(args):
    """``--device``, else ``cuda:LOCAL_RANK`` under a launcher, else None
    (the card)."""
    if args.device is None and "LOCAL_RANK" in os.environ:
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return args.device


def child_flags(args) -> list:
    """The flags an ``--isolate`` child gets: the parent's, verbatim."""
    flags = ["--sweep", "--aggregation", args.aggregation]
    if dp_auto(args):
        flags += ["--dp", "auto"]
    if getattr(args, "partition", "none") != "none":
        flags += ["--partition", args.partition]
    if args.resume:
        flags.append("--resume")
    if args.epochs is not None:
        flags += ["--epochs", str(args.epochs)]
    for name in ("out_root", "processed_dir", "device"):
        if getattr(args, name) is not None:
            flags += [f"--{name}", str(getattr(args, name))]
    if args.wandb:
        flags.append("--wandb")
    if args.num_shards:
        flags += ["--shard_index", str(args.shard_index), "--num_shards", str(args.num_shards)]
    return flags


def run_isolated(module: str, grid, args, flags, incomplete) -> int:
    """Run ``grid`` as child processes (``python -m module``) of
    ``args.isolate`` cells each, one after another; returns 1 when a cell is
    still incomplete afterwards (``incomplete(cell)`` names it), else 0.

    Children write to this process's stdout and stderr. A child that fails
    is logged and the pass goes on: its cells are retried by the next
    ``--resume`` pass. Nothing here touches the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(config.REPO_ROOT), env.get("PYTHONPATH")) if p)
    total = len(grid)
    for start in range(0, total, args.isolate):
        count = min(args.isolate, total - start)
        cells = f"cells {start + 1}-{start + count}"
        if args.resume and not any(map(incomplete, grid[start:start + count])):
            print(f"[isolate] {cells}/{total}: all complete, skipping child", flush=True)
            continue
        # No child is alive here: the card can be lent out (acquire_chip).
        honor_pause(cells)
        print(f"[isolate] {cells}/{total}", flush=True)
        t0 = time.time()
        rc = subprocess.call([sys.executable, "-m", module, *flags, "--grid_start", str(start),
                              "--grid_count", str(count)], env=env)
        print(f"[isolate] {cells}/{total}: child rc={rc} ({time.time() - t0:.1f}s)"
              f"{' — continuing' if rc else ''}", flush=True)
    missing = [name for name in map(incomplete, grid) if name]
    if missing:
        print(f"\n{len(missing)} cells incomplete after this pass: "
              f"{missing[:10]}{' ...' if len(missing) > 10 else ''}", flush=True)
        return 1
    print("\nAll runs completed.", flush=True)
    return 0


def metrics_root(args) -> Path:
    return Path(args.out_root) / "metrics" if args.out_root else config.METRICS_DIR


def cell_completed(cfg: config.PretrainConfig, args) -> bool:
    """The cell's summary exists, says completed, and matches the epochs,
    aggregation and stores asked for now: a smoke run never stands in for a
    production cell."""
    path = metrics_root(args) / config.PRETRAIN_PROJECT_NAME / f"{cfg.run_name}.summary.json"
    return summary_completed(path, fidelity_block(
        args.epochs, cfg.seed, args.aggregation, args.processed_dir, cfg.pretrain_domains))


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device() if device.index is None else device.index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip()


def record_pretrain_timing(run_name: str, seconds: float, card: str) -> None:
    """Merge one cell's wall time, beside the card it ran on, into
    ``TIMINGS_FILE`` (per cell, the latest run wins, atomic replace)."""
    timings = json.loads(TIMINGS_FILE.read_text()) if TIMINGS_FILE.exists() else {}
    timings[run_name] = {"seconds": round(float(seconds), 1), "card": card}
    TIMINGS_FILE.parent.mkdir(parents=True, exist_ok=True)
    tmp = TIMINGS_FILE.with_name(TIMINGS_FILE.name + ".tmp")
    tmp.write_text(json.dumps(dict(sorted(timings.items())), indent=2) + "\n")
    os.replace(tmp, TIMINGS_FILE)


def data_axis(args, device: torch.device):
    """The data axis of a ``--dp auto`` (or ``--partition``) sweep
    (``make_mesh``: the process group is made at the first call, the first
    cell that runs), or None."""
    return make_mesh(device) if multi_rank(args) else None


def spawn_dp_ranks(module: str, args, argv) -> Optional[int]:
    """Under ``--dp auto`` (or ``--partition``) with no launcher and more than
    one card: run this command as one rank per card (``spawn_local_ranks``)
    and return its exit code; else None, and this process runs the grid
    itself."""
    if (not multi_rank(args) or launcher_env() is not None
            or args.device not in (None, "cuda")):
        return None
    cards = torch.cuda.device_count()
    if cards < 2:
        return None
    return spawn_local_ranks(module, sys.argv[1:] if argv is None else list(argv), cards)


def run_sweep(grid, args, device: torch.device) -> list:
    """Pretrain the cells of ``grid`` in order; returns the ones that failed."""
    # Only production cells feed the timing record: a reduced-epoch trial or
    # a scratch out_root stays out of it.
    card = (card_line(device) if device.type == "cuda" and args.out_root is None
            and args.epochs == config.PRETRAIN_EPOCHS else None)
    write_pidfile()         # lets a job that needs the card find this sweep
    print(f"Pretraining sweep: {len(grid)} runs (shard {shard_label(args)})",
          flush=True)
    failed = []
    for i, (exp, seed) in enumerate(grid):
        cfg = config.PretrainConfig(exp_name=exp, seed=seed)
        tag = f"[{i + 1}/{len(grid)}] {cfg.run_name}"
        if args.resume and cell_completed(cfg, args):
            print(f"{tag}: already complete, skipping", flush=True)
            continue
        t0 = time.time()
        axis = data_axis(args, device)
        try:
            res = pretrain(cfg, aggregation=args.aggregation, epochs=args.epochs,
                           processed_dir=args.processed_dir, use_wandb=args.wandb,
                           resume=args.resume, out_root=args.out_root, device=device,
                           data_parallel=axis is not None, axis=axis)
            print(f"{tag}: best_val={res['best_val_total']:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
            if card and (axis is None or axis.rank == 0):
                record_pretrain_timing(cfg.run_name, time.time() - t0, card)
        except Exception:
            traceback.print_exc()
            if axis is not None and axis.size > 1:
                raise
            failed.append(cfg.run_name)
            print(f"{tag}: FAILED", flush=True)
        # A finished cell's model, optimizer and batches sit in reference
        # cycles (closures that refer to themselves); free them before the
        # next cell allocates its own.
        gc.collect()
        if maybe_clear_caches():
            print(f"{tag}: cleared caches (host RSS bound)", flush=True)
    print(f"\n{len(failed)} failed runs: {failed}" if failed else "\nAll runs completed.",
          flush=True)
    return failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(parser)
    parser.add_argument("--exp_name", type=str, default=None, choices=config.ALL_SCHEMES)
    parser.add_argument("--epochs", type=int, default=config.PRETRAIN_EPOCHS)
    parser.add_argument("--aggregation", type=str, default="pallas",
                        choices=["dense", "pallas", "coo"])
    args = parser.parse_args(argv)
    if args.sweep:
        grid = [(e, s) for e in config.ALL_SCHEMES for s in config.SEEDS]
    elif args.exp_name is None or args.seed is None:
        parser.error("provide --sweep or both --exp_name and --seed")
    else:
        grid = [(args.exp_name, args.seed)]
    if args.isolate < 0:
        parser.error("--isolate takes a positive number of cells per child")
    grid = slice_grid(shard_grid(grid, args), args)
    if args.isolate and args.sweep:
        def incomplete(cell):
            cfg = config.PretrainConfig(exp_name=cell[0], seed=cell[1])
            return None if cell_completed(cfg, args) else cfg.run_name
        return run_isolated("gnn_pretraining_tpu_torch.run_pretrain", grid, args,
                            child_flags(args), incomplete)
    rc = spawn_dp_ranks("gnn_pretraining_tpu_torch.run_pretrain", args, argv)
    if rc is not None:
        return rc
    device = resolve_device(launcher_device(args))
    failed = run_sweep(grid, args, device)
    close_mesh()
    return 2 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
