"""Resuming the port's ``pretrain()`` from its train-state file, on the CPU.

A run of scheme s5 (every random stream drawn from) on a tiny ENZYMES store
with one GIN layer, stopped after its epoch-5 resume file and resumed,
must end bitwise equal to the same run left uninterrupted: the last resume
file (weights, BN statistics, AdamW moments and steps, counters, stream
states), the best checkpoint, the metric log row for row (timing keys
apart) and the summary. The train-state file restores bitwise onto a fresh
model, optimizer and streams, and a file that does not fit the model raises
and names the key. The fidelity markers give the JAX package's answers on
the same files, and flax reads the stream states the port writes.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from flax import serialization

from gnn_pretraining_tpu.utils import fidelity as jax_fidelity
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.synthetic import (
    attach_graph_properties,
    synthetic_graph_store,
    synthetic_pretrain_store,
)
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer
from gnn_pretraining_tpu_torch.utils import _msgpack, fidelity
from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

EPOCHS = 6                # the resume file is written after epoch 5 and 6


def patch_config(mp, scheme="s5", domains=("ENZYMES",)):
    mp.setattr(config, "GNN_NUM_LAYERS", 1)
    mp.setitem(config.PRETRAIN_DOMAINS, scheme, domains)


def rows_of(root):
    """The metric log of the s5 run under ``root``, without the timing keys."""
    path = root / "metrics" / config.PRETRAIN_PROJECT_NAME / "s5_7.jsonl"
    return [{k: v for k, v in json.loads(line).items()
             if k != "_time" and not k.startswith("train/system/")} for line in open(path)]


def summary_of(root):
    path = root / "metrics" / config.PRETRAIN_PROJECT_NAME / "s5_7.summary.json"
    return json.loads(path.read_text())


class Stopped(Exception):
    pass


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A: 6 epochs uninterrupted; B: stopped after its epoch-5 resume file,
    then ``pretrain(resume=True)``; then A resumed at its last epoch. Graphs
    of ~6 nodes keep an epoch (one step of 32 graphs and the evaluation)
    short; the validation total of this store and seed never stalls for 3
    epochs, so early stopping ends neither run before epoch 6."""
    tmp = tmp_path_factory.mktemp("resume")
    processed = tmp / "processed"
    processed.mkdir()
    rng = np.random.default_rng(3)
    attach_graph_properties(synthetic_graph_store(
        "ENZYMES", rng, np.maximum(3, rng.poisson(6, 40)), 3.8)).save(processed / "ENZYMES.npz")
    cfg = config.PretrainConfig("s5", 7)
    run = dict(epochs=EPOCHS, processed_dir=processed, aggregation="pallas",
               device="cpu", resume=True)
    out = {"processed": processed}
    with pytest.MonkeyPatch.context() as mp:
        patch_config(mp)
        out["A"] = pt.pretrain(cfg, out_root=tmp / "A", **run)
        out["A summary"] = summary_of(tmp / "A")
        saved = []

        def save_then_stop(path, *args, **kwargs):
            real_save(path, *args, **kwargs)
            saved.append(load_checkpoint(path)["counters"]["epoch"])
            raise Stopped

        real_save = pt.save_train_state
        mp.setattr(pt, "save_train_state", save_then_stop)
        with pytest.raises(Stopped):
            pt.pretrain(cfg, out_root=tmp / "B", **run)
        mp.setattr(pt, "save_train_state", real_save)
        out["stopped after"] = saved
        out["B rows before"] = len(rows_of(tmp / "B"))
        out["B"] = pt.pretrain(cfg, out_root=tmp / "B", **run)
        out["A rows"] = rows_of(tmp / "A")
        out["A final"] = pt.pretrain(cfg, out_root=tmp / "A", **run)
    out["root"] = tmp
    return out


def assert_same_tree(got, want, path="root"):
    """Bitwise: every key, dtype, shape and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("part", ["resume_file", "best_checkpoint", "metric_log", "summary"])
def test_stopped_and_resumed_run_equals_uninterrupted(resumed, part):
    assert resumed["stopped after"] == [5]
    root = resumed["root"]
    if part in ("resume_file", "best_checkpoint"):
        name = f"{'resume' if part == 'resume_file' else 'model'}_s5_7.msgpack"
        a = load_checkpoint(root / "A" / "pretrain" / name)
        b = load_checkpoint(root / "B" / "pretrain" / name)
        assert_same_tree(b, a)
        if part == "resume_file":
            assert a["counters"]["epoch"] == EPOCHS and a["counters"]["opt_step"] == EPOCHS
            assert set(a["extra"]["streams"]) == {"sampler", "dropout", "views", "pcgrad",
                                                  "task_draws"}
    elif part == "metric_log":
        rows = rows_of(root / "B")
        assert resumed["B rows before"] == 2 * 5                # a step and a val row per epoch
        assert rows == resumed["A rows"] and len(rows) == 2 * EPOCHS
        assert rows[-2]["train/progress/epoch"] == EPOCHS
    else:
        drop = lambda s: {k: v for k, v in s.items()  # noqa: E731
                          if not k.startswith("train/system/")}
        assert drop(summary_of(root / "B")) == drop(resumed["A summary"])
    assert resumed["B"] == {**resumed["A"], "checkpoint": str(root / "B" / "pretrain"
                                                             / "model_s5_7.msgpack")}


def test_resume_at_the_last_epoch_trains_nothing(resumed):
    """The loop is empty, the summary is still written (its fidelity block
    complete) and ``epochs`` is the file's epoch."""
    root = resumed["root"]
    assert resumed["A final"] == resumed["A"]
    assert rows_of(root / "A") == resumed["A rows"]
    summary = summary_of(root / "A")
    block = fidelity.fidelity_block(EPOCHS, 7, "pallas", resumed["processed"], ("ENZYMES",))
    assert {k: v for k, v in summary.items() if k.startswith("fidelity/")} == block
    assert fidelity.cell_completed(
        root / "A" / "metrics" / config.PRETRAIN_PROJECT_NAME / "s5_7.summary.json", block)


def fresh_run(seed):
    """(cfg, model, optimizer, streams) of a fresh s5 run from ``seed``."""
    cfg = config.PretrainConfig("s5", seed)
    model = pt.build_pretrain_model(cfg, "pallas", "cpu")
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    return cfg, model, optimizer, pt.random_streams(cfg, model, "cpu")


def move_everything(model, optimizer, streams, rng):
    """Two AdamW steps on seeded gradients, new BN statistics, and draws
    from every stream."""
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
        optimizer.step()
    for buf in model.buffers():
        buf.copy_(torch.from_numpy(rng.random(buf.shape).astype(np.float32)))
    streams["sampler"].integers(0, 100, 7)
    for name in ("dropout", "views", "task_draws"):
        torch.rand(5, generator=streams[name].generator)
    torch.rand(3, generator=streams["pcgrad"])


@pytest.mark.parametrize("steps", [0, 2])
def test_train_state_round_trip_is_bitwise(tmp_path, monkeypatch, steps):
    """A port file restores onto a fresh model, optimizer and streams (of
    another seed), every tensor, counter and stream state equal."""
    patch_config(monkeypatch)
    cfg, model, optimizer, streams = fresh_run(7)
    if steps:
        move_everything(model, optimizer, streams, np.random.default_rng(5))
    state = pt.PretrainState(opt_step=steps, balancer_step=3)
    path = tmp_path / "resume.msgpack"
    pt.save_resume_state(path, model, optimizer, cfg, state, streams, 5, 0.25, 2)

    _, model2, optimizer2, streams2 = fresh_run(11)
    counters = pt.load_resume_state(path, model2, optimizer2, cfg, streams2)
    assert counters == {"opt_step": steps, "balancer_step": 3, "epoch": 5,
                        "best_total": 0.25, "epochs_since_improvement": 2}
    for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), name
    for (name, p), p2 in zip(model.named_parameters(), model2.parameters()):
        s, s2 = optimizer.state.get(p, {}), optimizer2.state.get(p2, {})
        assert s.keys() == s2.keys() and len(s) == 3 * bool(steps), name
        for k in s:
            assert s[k].dtype == s2[k].dtype and torch.equal(s[k], s2[k]), (name, k)
    assert_same_tree(pt.stream_states(streams2), pt.stream_states(streams))
    assert np.array_equal(streams2["sampler"].integers(0, 1000, 9),
                          streams["sampler"].integers(0, 1000, 9))
    for name in ("dropout", "views", "task_draws"):
        assert torch.equal(torch.rand(4, generator=streams2[name].generator),
                           torch.rand(4, generator=streams[name].generator)), name


def break_payload(payload, case):
    if case == "parameter shape":
        moments = payload["opt_state"]["inner_states"]["default"]["inner_state"]["0"]["mu"]
        moments["mask_token"] = np.zeros(3, np.float32)
    elif case == "optimizer label":
        del payload["opt_state"]["inner_states"]["graph_prop"]
    elif case == "stream":
        del payload["extra"]["streams"]["pcgrad"]
    elif case == "counter":
        del payload["counters"]["epochs_since_improvement"]
    elif case == "weights":
        del payload["params"]["heads_link_pred"]
    return payload


@pytest.mark.parametrize("case, names", [
    ("parameter shape", "mask_token"), ("optimizer label", "graph_prop"),
    ("stream", "pcgrad"), ("counter", "epochs_since_improvement"),
    ("weights", "heads_link_pred")])
def test_a_file_that_does_not_fit_raises_and_names_the_key(tmp_path, monkeypatch, case,
                                                           names):
    patch_config(monkeypatch)
    cfg, model, optimizer, streams = fresh_run(7)
    move_everything(model, optimizer, streams, np.random.default_rng(5))
    path = tmp_path / "resume.msgpack"
    pt.save_resume_state(path, model, optimizer, cfg, pt.PretrainState(2, 0), streams,
                         5, 1.0, 0)
    path.write_bytes(_msgpack.packb(break_payload(load_checkpoint(path), case)))
    _, model2, optimizer2, streams2 = fresh_run(7)
    with pytest.raises((KeyError, ValueError, RuntimeError), match=names):
        pt.load_resume_state(path, model2, optimizer2, cfg, streams2)


def test_stream_states_are_read_by_flax(monkeypatch):
    """The torch generators' bytes and the sampler's 128-bit words (as
    strings) come back from flax's reader as written; an int past 64 bits
    refuses to be written."""
    patch_config(monkeypatch)
    _, model, optimizer, streams = fresh_run(7)
    states = pt.stream_states(streams)
    restored = serialization.msgpack_restore(_msgpack.packb({"streams": states}))["streams"]
    assert_same_tree(restored, states)
    assert states["dropout"].dtype == np.uint8
    word = streams["sampler"].bit_generator.state["state"]["state"]
    assert word >= 1 << 64 and int(restored["sampler"]["state"]["state"]) == word
    with pytest.raises(OverflowError):
        _msgpack.packb({"state": word})
    count = serialization.msgpack_restore(_msgpack.packb({"count": np.array(3, np.int32)}))
    assert count["count"].dtype == np.int32 and count["count"].shape == ()


def write_npz(path, **meta):
    np.savez(path, x=np.zeros(3), **{f"meta__{k}": v for k, v in meta.items()})


# The cases of tests/test_fidelity.py, on the same files for both packages.
STORES = {
    "provenance": {"A": dict(source=np.str_("synthetic"), scale=np.float64(0.25),
                             homophily=np.float64(0.0)),
                   "B": dict(source=np.str_("synthetic"), scale=np.float64(0.25),
                             homophily=np.float64(0.0))},
    "mixed provenance": {"A": dict(source=np.str_("synthetic"), scale=np.float64(1.0)),
                         "B": dict(source=np.str_("raw"), scale=np.float64(1.0))},
    "missing file": {"nope": None},
    "legacy store": {"A": {}},
    "calibration": {"A": dict(source=np.str_("synthetic"), homophily=np.float64(0.45))},
    "mixed calibration": {"A": dict(homophily=np.float64(0.45)),
                          "B": dict(homophily=np.float64(0.0))},
}


@pytest.mark.parametrize("case", list(STORES) + ["port store"])
def test_data_fidelity_matches_jax(tmp_path, case):
    if case == "port store":
        synthetic_pretrain_store("MUTAG", np.random.default_rng(0), 8).save(tmp_path / "M.npz")
        domains = ["M"]
    else:
        for name, meta in STORES[case].items():
            if meta is not None:
                write_npz(tmp_path / f"{name}.npz", **meta)
        domains = list(STORES[case])
    got = fidelity.data_fidelity(tmp_path, domains)
    assert got == jax_fidelity.data_fidelity(tmp_path, domains)
    assert fidelity.fidelity_block(50, 42, "pallas", tmp_path, domains) == \
        jax_fidelity.fidelity_block(50, 42, "pallas", tmp_path, domains)


@pytest.mark.parametrize("case", ["matching", "smoke run", "incomplete", "absent",
                                  "garbled", "pre-fidelity"])
def test_cell_completed_matches_jax(tmp_path, case):
    write_npz(tmp_path / "D.npz", source=np.str_("synthetic"), scale=np.float64(0.5),
              homophily=np.float64(0.0))
    block = fidelity.fidelity_block(50, 42, "pallas", tmp_path, ["D"])
    path = tmp_path / "run.summary.json"
    text = {"matching": json.dumps(block),
            "smoke run": json.dumps({**block, "fidelity/epochs": 2}),
            "incomplete": json.dumps({**block, "fidelity/completed": 0}),
            "absent": None, "garbled": "{not json",
            "pre-fidelity": json.dumps({"test/accuracy": 0.9})}[case]
    if text is not None:
        path.write_text(text)
    got = fidelity.cell_completed(path, block)
    assert got == jax_fidelity.cell_completed(path, block)
    assert got == (case == "matching")
