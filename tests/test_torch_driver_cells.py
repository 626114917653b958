"""The port's sweep drivers cell by cell, on the CPU, with the cells'
entry points replaced by recorders where the point is the driver:

  * without a card the drivers raise before the first cell;
  * a cell that raises is listed, the sweep goes on, and the exit code is 2;
  * only production cells on the card record their wall time, in the port's
    own timing file;
  * an in-process sweep writes the port's pidfile, and after each cell
    clears the caches once host RSS crosses its bound, with the JAX
    package's log line.
"""

from __future__ import annotations

import json

import pytest
import torch

from gnn_pretraining_tpu_torch import run_finetune, run_pretrain
from gnn_pretraining_tpu_torch.utils import runtime
from torch_driver_helpers import REPO, cell

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def own_pidfile(tmp_path, monkeypatch):
    monkeypatch.setattr(runtime, "SWEEP_PIDFILE", tmp_path / "sweep.pid")


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


@pytest.mark.parametrize("driver,entry,argv", [
    (run_pretrain, "pretrain", ["--sweep", "--num_shards", "12", "--shard_index", "0"]),
    (run_finetune, "finetune", ["--domain_sweep", "ENZYMES", "--num_shards", "27",
                                "--shard_index", "0"])], ids=["pretrain", "finetune"])
def test_in_process_sweeps_record_themselves_and_clear_past_the_bound(
        monkeypatch, capsys, driver, entry, argv):
    """Two cells: the pidfile names this process while they run, and the
    caches are cleared after each cell once RSS is past the bound."""
    seen = []

    def cell_fn(cfg, **kwargs):
        seen.append(runtime.SWEEP_PIDFILE.read_text())
        return {"best_val_total": 1.0, "test/accuracy": 0.5}

    monkeypatch.setattr(driver, entry, cell_fn)
    monkeypatch.setattr(runtime, "rss_gb", lambda: runtime.CLEAR_CACHES_RSS_GB + 1.0)
    assert driver.main([*argv, "--device", "cpu"]) == 0
    assert seen == [runtime._identity()] * 2
    out = capsys.readouterr().out
    assert out.count("cleared caches (host RSS bound)") == 2
