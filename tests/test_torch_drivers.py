"""The port's sweep drivers and its own output root, on the CPU.

``gnn_pretraining_tpu_torch.run_pretrain`` and ``run_finetune`` are driven
through ``main(argv)`` with ``--device cpu`` on a tiny seeded ENZYMES store
(24 graphs; s2 over ENZYMES alone, 1 GIN layer). The root constants of both
packages point into a temporary directory, the JAX package's at
``<tmp>/outputs`` and the port's at ``<tmp>/outputs/torch`` (the layout of
the repository), and the runs that pass no ``--out_root`` write under the
port's. Held here (the grids, shards and per-cell behaviour with the cells
replaced by recorders are in ``test_torch_driver_grids.py`` and
``test_torch_driver_cells.py``):

  * a one-cell pretrain shard (``--num_shards 24 --shard_index 12``, s2
    under seed 42) writes a summary that the port's ``cell_completed``
    accepts, and the same command under ``--resume`` does not call
    ``pretrain()``;
  * ``run_finetune`` skips a cell from s2, whose pretrain ran 1 epoch of
    ``config.PRETRAIN_EPOCHS``, and exits 2; a single cell under
    ``--resume`` is skipped once complete;
  * two cells run in one process (a shard of ``--domain_sweep``) give the
    metrics each gives alone (rtol 1e-6, times and rates aside);
  * nothing lands under the JAX package's ``pretrain/``, ``finetune/`` or
    ``metrics/``, and the JAX ``run_pretrain.cell_completed`` stays False
    for the port's cell (it turns True once the summary is copied there);
  * ``--isolate 1`` over two b1 cells of ``--domain_sweep ENZYMES`` (5
    layers: the children take the real config) runs each cell in a child
    ``python -m gnn_pretraining_tpu_torch.run_finetune`` with the parent's
    flags and ``--domain_sweep`` kept, while the orchestrator makes no
    ``torch.cuda`` call and resolves no device; the same command under
    ``--resume`` starts no child.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.utils import runtime
from torch_driver_helpers import FT_EPOCHS, SHARD, call, cell, jax_run_pretrain

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

def summary_test_metrics(root, run_name):
    summary = json.loads((root / "metrics" / config.FINETUNE_PROJECT_NAME
                          / f"{run_name}.summary.json").read_text())
    return {k: v for k, v in summary.items()
            if k.startswith("test/") and "time" not in k and "_per_sec" not in k}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drivers")
    stores = tmp / "processed"
    stores.mkdir()
    synthetic_pretrain_store("ENZYMES", np.random.default_rng(3), num_graphs=24).save(
        stores / "ENZYMES.npz")
    roots = {"jax": tmp / "outputs", "port": tmp / "outputs" / "torch"}
    base = ["--device", "cpu", "--processed_dir", str(stores)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "GNN_NUM_LAYERS", 1)
        mp.setattr(runtime, "SWEEP_PIDFILE", tmp / "sweep.pid")
        for c, side in ((jax_config, "jax"), (config, "port")):
            mp.setitem(c.PRETRAIN_DOMAINS, "s2", ("ENZYMES",))
            mp.setattr(c, "OUTPUT_DIR", roots[side])
            mp.setattr(c, "PRETRAIN_OUTPUT_DIR", roots[side] / "pretrain")
            mp.setattr(c, "FINETUNE_OUTPUT_DIR", roots[side] / "finetune")
            mp.setattr(c, "METRICS_DIR", roots[side] / "metrics")
        out = {"stores": stores, "roots": roots, "tmp": tmp}
        # Under the default root: the pretrain shard, then the same command
        # under --resume; a fine-tune cell from s2; one b1 cell, run and resumed.
        out["pretrain"] = call(run_pretrain.main, ["--sweep", *SHARD, "--epochs", "1", *base])
        out["pretrain_resumed"] = call(run_pretrain.main,
                                       ["--sweep", *SHARD, "--epochs", "1", "--resume", *base],
                                       pretrain=run_pretrain)
        out["from_s2"] = call(run_finetune.main, [*cell("full_finetune", "s2"), *base],
                              finetune=run_finetune)
        out["alone_full"] = call(run_finetune.main, [*cell("full_finetune", "b1"), *base])
        out["alone_full_resumed"] = call(run_finetune.main,
                                         [*cell("full_finetune", "b1"), "--resume", *base],
                                         finetune=run_finetune)
        out["alone_probe"] = call(run_finetune.main, [*cell("linear_probe", "b1"), *base,
                                                      "--out_root", str(tmp / "alone")])
        # Both b1 cells in one process: ENZYMES' grid has 2 x 9 x 3 cells, so
        # shard 0 of 27 is full_finetune then linear_probe, b1 under seed 42.
        out["sweep"] = call(run_finetune.main,
                            ["--domain_sweep", "ENZYMES", "--num_shards", "27", "--shard_index",
                             "0", "--epochs", str(FT_EPOCHS), *base, "--out_root",
                             str(tmp / "sweep")])
        yield out


def args_of(runs, **kw):
    """The parsed flags of a driver run on the store, ``kw`` overriding."""
    return types.SimpleNamespace(**{"out_root": None, "epochs": 1, "aggregation": "pallas",
                                    "processed_dir": runs["stores"], **kw})


def test_one_cell_pretrain_shard_writes_a_completed_summary(runs):
    rc, out, _ = runs["pretrain"]
    assert rc == 0 and "[1/1] s2_42: best_val=" in out
    assert run_pretrain.cell_completed(config.PretrainConfig("s2", 42), args_of(runs))
    assert not run_pretrain.cell_completed(config.PretrainConfig("s2", 42),
                                           args_of(runs, epochs=2))


def test_resume_skips_the_completed_pretrain_cell(runs):
    rc, out, calls = runs["pretrain_resumed"]
    assert rc == 0 and calls == []
    assert "[1/1] s2_42: already complete, skipping" in out


def test_finetune_skips_a_cell_whose_pretrain_is_not_complete(runs, monkeypatch):
    rc, out, calls = runs["from_s2"]
    assert rc == 2 and calls == []
    assert "ENZYMES_full_finetune_s2_42: SKIPPED" in out
    # The checkpoint is there; the guard reads the epochs of its summary.
    assert (runs["roots"]["port"] / "pretrain" / "model_s2_42.msgpack").exists()
    assert not run_finetune.pretrain_ready("s2", 42, args_of(runs, epochs=FT_EPOCHS))
    monkeypatch.setattr(config, "PRETRAIN_EPOCHS", 1)
    assert run_finetune.pretrain_ready("s2", 42, args_of(runs, epochs=FT_EPOCHS))


def test_single_finetune_cell_under_resume_is_skipped_once_complete(runs):
    assert runs["alone_full"][0] == 0
    rc, out, calls = runs["alone_full_resumed"]
    assert rc == 0 and calls == []
    assert "ENZYMES_full_finetune_b1_42: already complete, skipping" in out


def test_two_cells_in_one_process_equal_each_alone(runs):
    rc, out, _ = runs["sweep"]
    assert rc == 0
    assert "[1/2] ENZYMES_full_finetune_b1_42: test/accuracy=" in out
    assert "[2/2] ENZYMES_linear_probe_b1_42: test/accuracy=" in out
    sweep = runs["tmp"] / "sweep"
    for name, alone in (("ENZYMES_full_finetune_b1_42", runs["roots"]["port"]),
                        ("ENZYMES_linear_probe_b1_42", runs["tmp"] / "alone")):
        want, got = summary_test_metrics(alone, name), summary_test_metrics(sweep, name)
        assert got.keys() == want.keys() and "test/accuracy" in got
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=f"{name} {k}")


def test_port_runs_write_only_under_the_port_root(runs):
    jax_root, port_root = runs["roots"]["jax"], runs["roots"]["port"]
    assert [p for sub in ("pretrain", "finetune", "metrics")
            for p in (jax_root / sub).rglob("*")] == []
    for path in ("pretrain/model_s2_42.msgpack",
                 f"metrics/{config.PRETRAIN_PROJECT_NAME}/s2_42.summary.json",
                 "finetune/model_ENZYMES_full_finetune_b1_42.msgpack",
                 f"metrics/{config.FINETUNE_PROJECT_NAME}/ENZYMES_full_finetune_b1_42.summary.json"):
        assert (port_root / path).is_file(), path


def test_jax_cell_completed_stays_false_for_a_port_cell(runs, tmp_path):
    jcfg = jax_config.PretrainConfig("s2", 42)
    assert not jax_run_pretrain.cell_completed(jcfg, args_of(runs))
    # Only the root keeps them apart: the same summary under the JAX root counts.
    name = f"{config.PRETRAIN_PROJECT_NAME}/s2_42.summary.json"
    (tmp_path / "metrics" / name).parent.mkdir(parents=True)
    shutil.copy(runs["roots"]["port"] / "metrics" / name, tmp_path / "metrics" / name)
    assert jax_run_pretrain.cell_completed(jcfg, args_of(runs, out_root=str(tmp_path)))


ISOLATE = ["--domain_sweep", "ENZYMES", "--num_shards", "27", "--shard_index", "0",
           "--epochs", "1", "--isolate", "1"]


@pytest.fixture(scope="module")
def isolated(runs):
    """The isolate sweep and its --resume pass, each child's command line
    recorded, with every torch.cuda entry and resolve_device made to fail
    in this process (the children are other processes)."""
    out_root = runs["tmp"] / "isolated"
    argv = [*ISOLATE, "--device", "cpu", "--processed_dir", str(runs["stores"]),
            "--out_root", str(out_root)]
    children, touched = [], []
    real_call = subprocess.call

    def recording_call(cmd, **kwargs):
        children.append(cmd)
        return real_call(cmd, **kwargs)

    def touch(name):
        return lambda *a, **k: touched.append(name)

    with pytest.MonkeyPatch.context() as mp:
        # The children's pidfiles and threads: the test's own, one thread.
        mp.setenv("TMPDIR", str(runs["tmp"]))
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setattr(run_pretrain.subprocess, "call", recording_call)
        mp.setattr(run_finetune, "resolve_device", touch("resolve_device"))
        for name in ("is_available", "device_count", "current_device", "init",
                     "synchronize", "get_device_properties", "memory_allocated"):
            mp.setattr(torch.cuda, name, touch(f"torch.cuda.{name}"))
        first = call(run_finetune.main, argv)
        first_children = list(children)
        resumed = call(run_finetune.main, [*argv, "--resume"])
    return {"first": first, "children": first_children, "resumed": resumed,
            "resumed_children": children[len(first_children):], "touched": touched,
            "argv": argv, "out_root": out_root, "stores": str(runs["stores"])}


def test_isolate_children_are_the_ports_driver_with_the_parents_flags(isolated):
    rc, out, _ = isolated["first"]
    assert rc == 0 and "All runs completed." in out
    children = isolated["children"]
    assert len(children) == 2
    for start, cmd in enumerate(children):
        assert cmd[1:3] == ["-m", "gnn_pretraining_tpu_torch.run_finetune"]
        flags = cmd[3:]
        assert flags[:2] == ["--domain_sweep", "ENZYMES"] and "--sweep" not in flags
        assert flags[-4:] == ["--grid_start", str(start), "--grid_count", "1"]
        for flag in ("--epochs", "--device", "--processed_dir", "--out_root",
                     "--shard_index", "--num_shards"):
            i = isolated["argv"].index(flag)
            assert flags[flags.index(flag) + 1] == isolated["argv"][i + 1], flag
        assert f"[isolate] cells {start + 1}-{start + 1}/2: child rc=0" in out
    args = types.SimpleNamespace(out_root=str(isolated["out_root"]), epochs=1,
                                 aggregation="pallas", processed_dir=isolated["stores"])
    for strategy in ("full_finetune", "linear_probe"):
        cfg = config.FinetuneConfig(domain_name="ENZYMES", finetune_strategy=strategy,
                                    pretrained_scheme="b1", seed=42)
        assert run_finetune.cell_completed(cfg, args), strategy


def test_isolate_orchestrator_touches_no_card(isolated):
    assert isolated["touched"] == []


def test_isolate_resume_starts_no_child(isolated):
    rc, out, _ = isolated["resumed"]
    assert rc == 0 and isolated["resumed_children"] == []
    assert out.count("all complete, skipping child") == 2

