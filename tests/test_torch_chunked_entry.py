"""``pretrain()`` through the chunked runner, on the CPU.

The chunked path (``chunk_steps=32``: the sampler's draws built into rows by
a producer thread, the steps run by ``make_chunked_train_step``) against the
per-step loop (``chunk_steps=1``) on a tiny ENZYMES store of 37 steps per
epoch, so that an epoch is a chunk of 32 and a ragged tail of 5, scheme b2
(node-feature masking: masks and dropout drawn) with one GIN layer: the same
metric log row for row (timing keys apart), the same best-checkpoint bytes
and the same summary; without the thread (``GNN_NO_PREFETCH``) the same rows
again. A chunked s2 run (views, dropout and PCGrad's order drawn) stopped
after its epoch-5 resume file and resumed equals the uninterrupted chunked
run bitwise (chunks of 2 over 5 steps an epoch; ``test_torch_resume.py``
holds s5, every stream, in chunks of its one step). An exception in
``prefetched``'s producer reaches the caller.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.synthetic import attach_graph_properties, synthetic_graph_store
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain.chunked import prefetched

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

ENTRY = config.PretrainConfig("b2", 5)
RESUME = config.PretrainConfig("s2", 5)
ENTRY_GRAPHS = 1480          # 1184 train graphs: 37 steps of 32
RESUME_GRAPHS = 200          # 160 train graphs: 5 steps of 32
RESUME_EPOCHS = 6            # resume files after epochs 5 and 6


@pytest.fixture(scope="module", autouse=True)
def small():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "GNN_NUM_LAYERS", 1)
        for cfg in (ENTRY, RESUME):
            mp.setitem(config.PRETRAIN_DOMAINS, cfg.exp_name, ("ENZYMES",))
        yield


def store(root, graphs, seed):
    root.mkdir()
    rng = np.random.default_rng(seed)
    attach_graph_properties(synthetic_graph_store(
        "ENZYMES", rng, np.maximum(3, rng.poisson(4, graphs)), 3.0)).save(root / "ENZYMES.npz")
    return root


def rows_of(root, cfg=ENTRY):
    path = root / "metrics" / config.PRETRAIN_PROJECT_NAME / f"{cfg.run_name}.jsonl"
    return [{k: v for k, v in json.loads(line).items()
             if k != "_time" and not k.startswith("train/system/")} for line in open(path)]


def summary_of(root, cfg=ENTRY):
    path = root / "metrics" / config.PRETRAIN_PROJECT_NAME / f"{cfg.run_name}.summary.json"
    return {k: v for k, v in json.loads(path.read_text()).items()
            if not k.startswith("train/system/")}


def file_bytes(root, kind, cfg=ENTRY):
    return (root / "pretrain" / f"{kind}_{cfg.run_name}.msgpack").read_bytes()


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunked_entry")
    processed = store(tmp / "processed", ENTRY_GRAPHS, 2)
    run = dict(epochs=1, processed_dir=processed, aggregation="pallas", device="cpu")
    out = {"processed": processed}
    for name, chunk_steps in (("chunked", 32), ("per_step", 1)):
        out[name] = pt.pretrain(ENTRY, out_root=tmp / name, chunk_steps=chunk_steps, **run)
        out[f"{name} root"] = tmp / name
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GNN_NO_PREFETCH", "1")
        pt.pretrain(ENTRY, out_root=tmp / "no_prefetch", chunk_steps=32, **run)
    out["no_prefetch root"] = tmp / "no_prefetch"
    return out


def test_entry_run_has_a_ragged_chunk(entry_runs):
    rows = [r for r in rows_of(entry_runs["chunked root"]) if "train/loss/total" in r]
    assert len(rows) == 37 and 37 % 32 == 5
    assert [r["_step"] for r in rows] == list(range(1, 38))


@pytest.mark.parametrize("part", ["metric_log", "best_checkpoint", "summary"])
def test_chunked_entry_equals_per_step(entry_runs, part):
    a, b = entry_runs["chunked root"], entry_runs["per_step root"]
    if part == "metric_log":
        assert rows_of(a) == rows_of(b)
    elif part == "best_checkpoint":
        assert file_bytes(a, "model") == file_bytes(b, "model")
        assert entry_runs["chunked"] == {**entry_runs["per_step"],
                                         "checkpoint": entry_runs["chunked"]["checkpoint"]}
    else:
        assert summary_of(a) == summary_of(b)


def test_no_prefetch_gives_the_same_rows(entry_runs):
    assert rows_of(entry_runs["no_prefetch root"]) == rows_of(entry_runs["chunked root"])


class Stopped(Exception):
    pass


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A: 6 epochs chunked, uninterrupted; B: stopped after its epoch-5
    resume file, then resumed."""
    tmp = tmp_path_factory.mktemp("chunked_resume")
    processed = store(tmp / "processed", RESUME_GRAPHS, 4)
    run = dict(epochs=RESUME_EPOCHS, processed_dir=processed, aggregation="pallas",
               device="cpu", resume=True, chunk_steps=2)
    pt.pretrain(RESUME, out_root=tmp / "A", **run)
    real_save = pt.save_train_state

    def save_then_stop(path, *args, **kwargs):
        real_save(path, *args, **kwargs)
        raise Stopped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "save_train_state", save_then_stop)
        with pytest.raises(Stopped):
            pt.pretrain(RESUME, out_root=tmp / "B", **run)
    stopped_rows = len(rows_of(tmp / "B", RESUME))
    pt.pretrain(RESUME, out_root=tmp / "B", **run)
    return {"A": tmp / "A", "B": tmp / "B", "stopped_rows": stopped_rows}


@pytest.mark.parametrize("part", ["resume_file", "metric_log"])
def test_resumed_chunked_run_equals_uninterrupted(resumed, part):
    a, b = resumed["A"], resumed["B"]
    if part == "resume_file":
        assert file_bytes(b, "resume", RESUME) == file_bytes(a, "resume", RESUME)
        assert file_bytes(b, "model", RESUME) == file_bytes(a, "model", RESUME)
    else:
        rows = rows_of(a, RESUME)
        assert resumed["stopped_rows"] == 5 * 6      # 5 epochs of 5 steps and an eval
        assert rows_of(b, RESUME) == rows and len(rows) == RESUME_EPOCHS * 6


def test_producer_exception_reaches_the_caller():
    def items():
        yield 1
        yield 2
        raise KeyError("sampler failed")

    got = []
    with pytest.raises(KeyError, match="sampler failed"):
        for item in prefetched(items(), depth=1, put=lambda x: 10 * x):
            got.append(item)
    assert got == [10, 20]
    assert not [t for t in threading.enumerate() if t.name == "pretrain-prefetch"]


def test_closing_early_stops_the_producer(monkeypatch):
    def items():
        yield from range(100)

    gen = prefetched(items(), depth=2)
    assert next(gen) == 0
    gen.close()
    assert not [t for t in threading.enumerate() if t.name == "pretrain-prefetch"]
    monkeypatch.setenv("GNN_NO_PREFETCH", "1")
    assert list(prefetched(iter(range(4)), put=lambda x: -x)) == [0, -1, -2, -3]
