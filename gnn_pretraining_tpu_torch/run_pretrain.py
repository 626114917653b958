"""Pretraining sweep driver of the port.

    python -m gnn_pretraining_tpu_torch.run_pretrain --sweep [--resume]
    python -m gnn_pretraining_tpu_torch.run_pretrain --exp_name s2 --seed 42

The counterpart of the JAX package's ``run_pretrain.py``, with the same
flags. ``--sweep`` runs the 24-cell grid (each scheme of
``config.ALL_SCHEMES`` under each seed of ``config.SEEDS``) in one process,
cell after cell; ``--exp_name --seed`` runs one cell.
``--shard_index i --num_shards n`` keeps ``grid[i::n]`` (``--num_shards 24
--shard_index 12`` is s2 under seed 42). ``--resume`` skips a cell whose
summary carries a completed ``fidelity/*`` block matching the run asked for
(``cell_completed``), and passes ``resume=True`` to ``pretrain()``, so a cell
that was cut short carries on from its train-state file. A cell that raises
is printed with its traceback and the sweep goes on; ``main`` returns 2 when
any cell failed.

Runs on the card unless ``--device cpu``, resolved once before the grid.
Writes under ``config.OUTPUT_DIR`` (``outputs/torch/``) unless
``--out_root``. A production cell on the card (``--epochs`` at
``config.PRETRAIN_EPOCHS``, no ``--out_root``) adds its wall time and the
card's name and power limit to ``analysis/results/pretrain_timings_torch.json``.
Not ported: ``--isolate``, the chip lock and pause hooks, ``--dp``,
``--debug_nans`` and the multi-host default of the shard flags.
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

import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain
from gnn_pretraining_tpu_torch.utils.device import resolve_device
from gnn_pretraining_tpu_torch.utils.fidelity import cell_completed as summary_completed
from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block

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


def shard_grid(grid, args):
    """``grid[i::n]`` for ``--shard_index i --num_shards n``, else the whole
    grid. One flag without the other is rejected: two machines started with
    only ``--num_shards 2`` would both run shard 0."""
    if (args.num_shards > 0) != (args.shard_index is not None):
        raise SystemExit("--shard_index and --num_shards must be given together "
                         "(or neither, for the whole grid)")
    if not args.num_shards:
        return grid
    if not 0 <= args.shard_index < args.num_shards:
        raise SystemExit(f"--shard_index {args.shard_index} out of range for "
                         f"{args.num_shards} shards")
    return grid[args.shard_index::args.num_shards]


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


def run_sweep(grid, args, device: torch.device) -> list:
    """Pretrain the cells of ``grid`` in order; returns the ones that failed."""
    # Only production cells feed the timing record: a reduced-epoch trial or
    # a scratch out_root stays out of it.
    card = (card_line(device) if device.type == "cuda" and args.out_root is None
            and args.epochs == config.PRETRAIN_EPOCHS else None)
    print(f"Pretraining sweep: {len(grid)} runs (shard {args.shard_index}/{args.num_shards})",
          flush=True)
    failed = []
    for i, (exp, seed) in enumerate(grid):
        cfg = config.PretrainConfig(exp_name=exp, seed=seed)
        tag = f"[{i + 1}/{len(grid)}] {cfg.run_name}"
        if args.resume and cell_completed(cfg, args):
            print(f"{tag}: already complete, skipping", flush=True)
            continue
        t0 = time.time()
        try:
            res = pretrain(cfg, aggregation=args.aggregation, epochs=args.epochs,
                           processed_dir=args.processed_dir, use_wandb=args.wandb,
                           resume=args.resume, out_root=args.out_root, device=device)
            print(f"{tag}: best_val={res['best_val_total']:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
            if card:
                record_pretrain_timing(cfg.run_name, time.time() - t0, card)
        except Exception:
            traceback.print_exc()
            failed.append(cfg.run_name)
            print(f"{tag}: FAILED", flush=True)
        # A finished cell's model, optimizer and batches sit in reference
        # cycles (closures that refer to themselves); free them before the
        # next cell allocates its own.
        gc.collect()
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
    grid = shard_grid(grid, args)
    device = resolve_device(args.device)
    return 2 if run_sweep(grid, args, device) else 0


if __name__ == "__main__":
    sys.exit(main())
