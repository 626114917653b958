"""The port's sweep drivers and its own output root, on the CPU.

``gnn_pretraining_tpu_torch.run_pretrain`` and ``run_finetune`` are driven
through ``main(argv)`` with ``--device cpu`` on a tiny seeded ENZYMES store
(24 graphs; s2 over ENZYMES alone, 1 GIN layer). The root constants of both
packages point into a temporary directory, the JAX package's at
``<tmp>/outputs`` and the port's at ``<tmp>/outputs/torch`` (the layout of
the repository), and the runs that pass no ``--out_root`` write under the
port's. Held here:

  * the grids and the shard selection equal the JAX scripts';
  * one shard flag without the other is rejected, and without a card the
    drivers raise before the first cell;
  * a one-cell pretrain shard (``--num_shards 24 --shard_index 12``, s2
    under seed 42) writes a summary that the port's ``cell_completed``
    accepts, and the same command under ``--resume`` does not call
    ``pretrain()``;
  * a cell that raises is listed, the sweep goes on, and the exit code is 2;
  * ``run_finetune`` skips a cell from s2, whose pretrain ran 1 epoch of
    ``config.PRETRAIN_EPOCHS``, and exits 2; a single cell under
    ``--resume`` is skipped once complete;
  * two cells run in one process (a shard of ``--domain_sweep``) give the
    metrics each gives alone (rtol 1e-6, times and rates aside);
  * nothing lands under the JAX package's ``pretrain/``, ``finetune/`` or
    ``metrics/``, and the JAX ``run_pretrain.cell_completed`` stays False
    for the port's cell (it turns True once the summary is copied there).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHARD = ["--num_shards", "24", "--shard_index", "12"]          # s2 under seed 42
FT_EPOCHS = 2


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_run_pretrain = _load("jax_run_pretrain", REPO / "run_pretrain.py")
jax_run_finetune = _load("jax_run_finetune", REPO / "run_finetune.py")


def call(main, argv, **spies):
    """``main(argv)`` with stdout captured and each ``name=module`` of
    ``spies`` having its ``name`` replaced by a recorder that must not run;
    -> (exit code, stdout, recorded calls)."""
    calls = []
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        for name, module in spies.items():
            mp.setattr(module, name, lambda *a, **k: calls.append((a, k)))
        rc = main(argv)
    return rc, out.getvalue(), calls


def cell(strategy, scheme):
    return ["--domain_name", "ENZYMES", "--finetune_strategy", strategy,
            "--pretrained_scheme", scheme, "--seed", "42", "--epochs", str(FT_EPOCHS)]


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


@pytest.mark.parametrize("driver,entry,argv", [
    (run_pretrain, "pretrain", ["--sweep"]),
    (run_finetune, "finetune", cell("full_finetune", "b1"))], ids=["pretrain", "finetune"])
def test_without_a_card_the_driver_raises_before_any_cell(monkeypatch, driver, entry, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(driver, entry, lambda *a, **k: pytest.fail("a cell ran"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(argv)


def test_a_failing_cell_is_listed_and_the_sweep_goes_on(monkeypatch, capsys):
    ran = []

    def pretrain(cfg, **kwargs):
        ran.append(cfg.run_name)
        if cfg.exp_name == "b2":
            raise ValueError("the b2 cell fails")
        return {"best_val_total": 1.0}

    monkeypatch.setattr(run_pretrain, "pretrain", pretrain)
    assert run_pretrain.main(["--sweep", "--num_shards", "12", "--shard_index", "0",
                              "--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert ran == ["b2_42", "s2_42"]
    assert "b2_42: FAILED" in out.out and "s2_42: best_val=1.0000" in out.out
    assert "ValueError: the b2 cell fails" in out.err


@pytest.mark.parametrize("extra,recorded", [([], True), (["--epochs", "2"], False),
                                            (["--out_root", "elsewhere"], False)],
                         ids=["production", "fewer_epochs", "out_root"])
def test_only_production_cells_on_the_card_record_their_time(monkeypatch, tmp_path, extra,
                                                            recorded):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(run_pretrain, "TIMINGS_FILE", tmp_path / "timings.json")
    monkeypatch.setattr(run_pretrain, "card_line", lambda device: card)
    monkeypatch.setattr(run_pretrain, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(run_pretrain, "pretrain", lambda cfg, **kw: {"best_val_total": 1.0})
    assert run_pretrain.main(["--exp_name", "s2", "--seed", "42", *extra]) == 0
    assert (tmp_path / "timings.json").exists() == recorded
    if recorded:
        entry = json.loads((tmp_path / "timings.json").read_text())["s2_42"]
        assert entry["card"] == card and entry["seconds"] >= 0


def test_the_timing_record_is_the_ports_own():
    """Beside the JAX package's record of TPU timings, never in it."""
    assert run_pretrain.TIMINGS_FILE == REPO / "analysis" / "results" / "pretrain_timings_torch.json"


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
