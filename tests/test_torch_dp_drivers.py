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
  * ``run_finetune --partition edge`` and ``--partition node`` on a tiny
    seeded Cora_NC store (2 GIN layers, dropout off in the ranks and in the
    reference, as the JAX package's driver test has it): the two ranks run
    the cell partitioned, and its summary's test loss and accuracy equal
    ``--partition none``'s at that test's tolerances (loss rtol 5e-4 / atol
    5e-5, accuracy exactly, ``tests/test_node_parallel.py``);
  * one rank with ``--partition`` (no launcher) takes the single-device
    path: the same summary as ``--partition none``, bit for bit.
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
from gnn_pretraining_tpu_torch.data.synthetic import (
    synthetic_planetoid_stores,
    synthetic_pretrain_store,
)
from gnn_pretraining_tpu_torch.parallel.mesh import free_port
from gnn_pretraining_tpu_torch.utils import runtime
from gnn_pretraining_tpu_torch.utils.checkpoint import load_train_state
from torch_driver_helpers import REPO, call

torch.set_num_threads(1)

PRETRAIN = ["--exp_name", "b4", "--seed", "42", "--resume"]
FINETUNE = ["--domain_name", "ENZYMES", "--finetune_strategy", "full_finetune",
            "--pretrained_scheme", "b1", "--seed", "42", "--epochs", "2", "--resume"]
LAUNCHER = {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "GROUP_RANK": "0"}


def launch(module, argvs, tmp, code=None):
    """``python -m module`` (or ``python -c code``) as the two ranks of one
    node, rank r with ``argvs[r]``; -> each rank's output."""
    env = dict(os.environ, **LAUNCHER, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp), PYTHONPATH=str(REPO))
    head = ["-m", module] if code is None else ["-c", code]
    procs = [subprocess.Popen([sys.executable, *head, *argv],
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


PARTITION_LAYERS = 2
PARTITION_CELL = ["--domain_name", "Cora_NC", "--finetune_strategy", "full_finetune",
                  "--pretrained_scheme", "b1", "--seed", "42", "--epochs", "2",
                  "--aggregation", "coo", "--device", "cpu"]
# A rank of the partitioned runs: the driver with dropout off and 2 layers.
PARTITION_RANK = ("import sys; from gnn_pretraining_tpu_torch import config; "
                  "config.DROPOUT_RATE = 0.0; "
                  f"config.GNN_NUM_LAYERS = {PARTITION_LAYERS}; "
                  "from gnn_pretraining_tpu_torch import run_finetune; "
                  "sys.exit(run_finetune.main(sys.argv[1:]))")


def cora_summary(root):
    return json.loads((root / "metrics" / config.FINETUNE_PROJECT_NAME
                       / "Cora_NC_full_finetune_b1_42.summary.json").read_text())


@pytest.fixture(scope="module")
def partition_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition_drivers")
    stores = tmp / "processed"
    stores.mkdir()
    for key, store in synthetic_planetoid_stores("Cora", np.random.default_rng(5), 64, 120,
                                                 20, 12, 12).items():
        store.save(stores / f"{key}.npz")
    base = PARTITION_CELL + ["--processed_dir", str(stores)]
    out = {"tmp": tmp, "base": base, "logs": {}}
    for partition in ("edge", "node"):
        root = tmp / partition
        out["logs"][partition] = launch(
            None, [base + ["--partition", partition, "--out_root", str(root)],
                   base + ["--partition", partition, "--out_root", str(tmp / f"{partition}1")]],
            tmp, code=PARTITION_RANK)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "DROPOUT_RATE", 0.0)
        mp.setattr(config, "GNN_NUM_LAYERS", PARTITION_LAYERS)
        for partition in ("none", "node"):          # node: one rank, no launcher
            rc, _, _ = call(run_finetune.main, base + ["--partition", partition, "--out_root",
                                                       str(tmp / f"one_rank_{partition}")])
            assert rc == 0
    return out


@pytest.mark.parametrize("partition", ["edge", "node"])
def test_partitioned_driver_matches_the_single_device_cell(partition_runs, partition):
    tmp = partition_runs["tmp"]
    got, want = cora_summary(tmp / partition), cora_summary(tmp / "one_rank_none")
    assert got["fidelity/completed"] == 1
    assert not (tmp / f"{partition}1").exists()                     # rank 0 alone writes
    for log in partition_runs["logs"][partition]:            # both ranks ran the cell
        assert "All runs completed." in log and "runs on rank 0" not in log
    np.testing.assert_allclose(got["test/loss"], want["test/loss"], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got["test/accuracy"], want["test/accuracy"], rtol=0, atol=1e-9)


def test_one_rank_with_partition_takes_the_single_device_path(partition_runs):
    tmp = partition_runs["tmp"]
    got, want = cora_summary(tmp / "one_rank_node"), cora_summary(tmp / "one_rank_none")
    assert not torch.distributed.is_initialized()
    for key in ("test/loss", "test/accuracy", "test/auc", "test/f1"):
        if key in want:
            assert got[key] == want[key], key
