"""The drivers' ``--dp auto`` on two CPU ranks under a launcher's environment.

``run_pretrain`` (b4: ENZYMES alone) and ``run_finetune`` (ENZYMES b1, a
graph-classification cell) run as two processes that a launcher would
start (``WORLD_SIZE`` 2, ``RANK`` / ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` 2,
``MASTER_ADDR`` / ``MASTER_PORT``), with ``--device cpu`` (gloo), on a tiny
seeded ENZYMES store and the real config (5 layers). Held:

  * the two ranks form one data axis and run the cell together (rc 0);
    rank 0 alone writes: rank 1, given an output root of its own, leaves it
    unmade, and the log holds each step once;
  * the pretrain resume file holds both ranks' random streams (the sampler
    and PCGrad's the same on both, the views, draws and dropout not; every
    rank restoring it and a run carrying on from it are held in
    ``test_torch_dp_step.py``);
  * under ``--resume`` a finished cell is skipped on each rank without
    making a process group (``main`` in this process, as rank 1);
  * ``--partition`` is refused.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.parallel.mesh import free_port
from gnn_pretraining_tpu_torch.utils import runtime
from gnn_pretraining_tpu_torch.utils.checkpoint import load_train_state
from torch_driver_helpers import REPO, call

torch.set_num_threads(1)

PRETRAIN = ["--exp_name", "b4", "--seed", "42", "--resume"]
FINETUNE = ["--domain_name", "ENZYMES", "--finetune_strategy", "full_finetune",
            "--pretrained_scheme", "b1", "--seed", "42", "--epochs", "2", "--resume"]
LAUNCHER = {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": "0"}


def launch(module, argvs, tmp):
    """``python -m module`` as the two ranks of one node, rank r with
    ``argvs[r]``; -> each rank's output."""
    env = dict(os.environ, **LAUNCHER, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp), PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, argv in enumerate(argvs)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_drivers")
    stores = tmp / "processed"
    stores.mkdir()
    synthetic_pretrain_store("ENZYMES", np.random.default_rng(3), num_graphs=24).save(
        stores / "ENZYMES.npz")
    root, other = tmp / "outputs" / "torch", tmp / "rank1_root"
    base = ["--dp", "auto", "--device", "cpu", "--processed_dir", str(stores)]
    out = {"tmp": tmp, "stores": stores, "root": root, "other": other, "base": base}
    for key, module, argv in (("pretrain", "gnn_pretraining_tpu_torch.run_pretrain",
                               PRETRAIN + ["--epochs", "1"]),
                              ("finetune", "gnn_pretraining_tpu_torch.run_finetune", FINETUNE)):
        out[key] = launch(module, [argv + base + ["--out_root", str(root)],
                                   argv + base + ["--out_root", str(other)]], tmp)
    return out


def train_steps_logged(path):
    """The steps of the log's train-step lines, in order."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [r["_step"] for r in rows if "train/progress/epoch" in r]


@pytest.mark.parametrize("kind", ["pretrain", "finetune"])
def test_rank_0_alone_writes(runs, kind):
    assert not runs["other"].exists()
    project = {"pretrain": config.PRETRAIN_PROJECT_NAME,
               "finetune": config.FINETUNE_PROJECT_NAME}[kind]
    run = {"pretrain": "b4_42", "finetune": "ENZYMES_full_finetune_b1_42"}[kind]
    summary = json.loads((runs["root"] / "metrics" / project / f"{run}.summary.json").read_text())
    assert summary["fidelity/completed"] == 1
    assert (runs["root"] / kind / f"model_{run}.msgpack").exists()
    steps = train_steps_logged(runs["root"] / "metrics" / project / f"{run}.jsonl")
    assert steps == list(range(1, len(steps) + 1)) and steps      # each step once
    assert all("All runs completed." in out for out in runs[kind])


def test_the_resume_file_holds_every_ranks_streams(runs):
    extra = load_train_state(runs["root"] / "pretrain" / "resume_b4_42.msgpack")["extra"]
    ranks = extra["rank_streams"]
    assert len(ranks) == 2
    for name in ("sampler", "pcgrad"):
        assert str(ranks[0][name]) == str(ranks[1][name]), name
    for name in ("views", "task_draws", "dropout"):
        assert not np.array_equal(ranks[0][name], ranks[1][name]), name


@pytest.mark.parametrize("driver,argv", [(run_pretrain, PRETRAIN + ["--epochs", "1"]),
                                         (run_finetune, FINETUNE)], ids=["pretrain", "finetune"])
def test_a_finished_cell_is_skipped_without_a_process_group(runs, driver, argv, monkeypatch):
    for key, value in dict(LAUNCHER, RANK="1", LOCAL_RANK="1").items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(runtime, "SWEEP_PIDFILE", runs["tmp"] / "sweep.pid")
    rc, out, _ = call(driver.main, argv + runs["base"] + ["--out_root", str(runs["root"])])
    assert rc == 0 and "already complete, skipping" in out
    assert not torch.distributed.is_initialized()


def test_partition_is_refused():
    with pytest.raises(SystemExit):
        run_finetune.main(FINETUNE + ["--partition", "edge", "--device", "cpu"])
