"""The grids and shards of the port's sweep drivers, against the JAX
package's root drivers, on the CPU.

  * the grids and the shard selection equal the JAX scripts', one shard flag
    without the other is rejected;
  * without shard flags a process started by a multi-process launcher
    (``WORLD_SIZE``, ``RANK``) keeps ``grid[RANK::WORLD_SIZE]``, the shard
    the JAX scripts take from the flags of the same numbers, and runs on
    ``cuda:LOCAL_RANK``;
  * an ``--isolate`` orchestrator without shard flags, and its children,
    take the whole grid, and a child's slice (``slice_grid``) is the JAX
    scripts'.
"""

from __future__ import annotations

import types

import pytest
import torch

from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
from torch_driver_helpers import jax_run_finetune, jax_run_pretrain

torch.set_num_threads(1)

GRID = [(e, s) for e in config.ALL_SCHEMES for s in config.SEEDS]


def flags(**kw):
    return types.SimpleNamespace(**{"num_shards": 0, "shard_index": None, "isolate": 0,
                                    "grid_start": 0, "grid_count": 0, "device": None, **kw})


@pytest.mark.parametrize("n,i", [(24, 12), (5, 3), (1, 0), (3, 0)])
def test_shard_grid_equals_jax(n, i):
    grid = [(e, s) for e in config.ALL_SCHEMES for s in config.SEEDS]
    args = types.SimpleNamespace(num_shards=n, shard_index=i)
    assert run_pretrain.shard_grid(grid, args) == jax_run_pretrain.shard_grid(grid, args)
    assert grid[12] == ("s2", 42)


def test_finetune_grid_equals_jax():
    assert run_finetune.full_grid() == jax_run_finetune.full_grid()
    assert len(run_finetune.full_grid()) == 324


@pytest.mark.parametrize("driver", [run_pretrain, run_finetune], ids=["pretrain", "finetune"])
@pytest.mark.parametrize("flag", [["--num_shards", "2"], ["--shard_index", "0"]],
                         ids=["num_shards", "shard_index"])
def test_one_shard_flag_without_the_other_is_rejected(driver, flag):
    with pytest.raises(SystemExit, match="together"):
        driver.main(["--sweep", *flag, "--device", "cpu"])


@pytest.mark.parametrize("n,i", [(2, 0), (2, 1), (3, 2)])
def test_the_launchers_shard_is_the_default(monkeypatch, n, i):
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setenv("RANK", str(i))
    got = run_pretrain.shard_grid(GRID, flags())
    assert got == GRID[i::n] == jax_run_pretrain.shard_grid(
        GRID, types.SimpleNamespace(num_shards=n, shard_index=i))
    # Explicit flags win over the launcher's.
    assert run_pretrain.shard_grid(GRID, flags(num_shards=24, shard_index=12)) == [("s2", 42)]
    monkeypatch.setenv("RANK", str(n))
    with pytest.raises(SystemExit, match="out of range"):
        run_pretrain.shard_grid(GRID, flags())


def test_isolate_takes_the_whole_grid_and_children_slice_it_as_jax(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert run_pretrain.shard_grid(GRID, flags(isolate=3)) == GRID
    assert run_pretrain.shard_grid(GRID, flags(grid_start=3, grid_count=3)) == GRID
    sharded = run_pretrain.shard_grid(GRID, flags(isolate=3, num_shards=5, shard_index=2))
    assert sharded == jax_run_pretrain.shard_grid(
        GRID, types.SimpleNamespace(num_shards=5, shard_index=2, isolate=3))
    for start, count in ((0, 0), (3, 3), (4, 9)):
        want = jax_run_pretrain.slice_grid(
            sharded, types.SimpleNamespace(grid_start=start, grid_count=count))
        assert run_pretrain.slice_grid(sharded, flags(grid_start=start, grid_count=count)) == want


def test_a_launched_process_runs_on_its_local_card(monkeypatch):
    assert run_pretrain.launcher_device(flags()) is None
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert run_pretrain.launcher_device(flags()) == "cuda:1"
    assert run_pretrain.launcher_device(flags(device="cpu")) == "cpu"
