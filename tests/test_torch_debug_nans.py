"""``pretrain --debug_nans`` and the rest of ``utils/profiling.py`` in the port.

``enable_nan_checks`` is the port's counterpart of ``jax_debug_nans``
(JAX ``pretrain/pretrain.py:762-766``): a pretrain step on a batch with one
poisoned feature row raises ``FloatingPointError`` naming the step and the
task, and so does an eval loss; a NaN first made by a backward op raises it
too, naming the op. Switched off, the step runs no check at all (counted:
no ``check_finite`` call, so no host sync) and gives the losses the checked
step gives. ``--debug_nans`` switches it on; ``trace`` writes a
``torch.profiler`` trace. Toy s2 on one ENZYMES store with one GIN layer at
the full width of 256, on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.loaders import create_pretrain_train_loader
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer
from gnn_pretraining_tpu_torch.utils import profiling

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(cfg, batches of one s2 step, make() -> a fresh (train_step, eval_fn,
    state) from the same seeds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "GNN_NUM_LAYERS", 1)
        mp.setitem(config.PRETRAIN_DOMAINS, "s2", ("ENZYMES",))
        tmp = tmp_path_factory.mktemp("nan_store")
        synthetic_pretrain_store("ENZYMES", np.random.default_rng(0), num_graphs=8).save(
            tmp / "ENZYMES.npz")
        cfg = config.PretrainConfig("s2", 3)
        batches = create_pretrain_train_loader(cfg.pretrain_domains, np.random.default_rng(1),
                                               tmp).sample_step()

        def make():
            model = pt.build_pretrain_model(cfg, "pallas", "cpu")
            optimizer = create_task_specific_optimizer(model, cfg.active_tasks)[0]
            streams = pt.random_streams(cfg, model, "cpu")
            step = pt.make_train_step(model, cfg, optimizer, 10, streams["views"],
                                      streams["pcgrad"], streams["task_draws"])
            evaluate = pt.make_eval_fn(model, cfg, 10, streams["views"], streams["task_draws"])
            return step, evaluate, pt.PretrainState()

        yield cfg, batches, make


@pytest.fixture
def nan_checks():
    profiling.enable_nan_checks()
    try:
        yield
    finally:
        profiling.enable_nan_checks(False)


def poisoned(batches):
    out = {d: b.to("cpu") for d, b in batches.items()}
    x = out["ENZYMES"].x.clone()
    x[3] = float("nan")                       # one valid node's features
    out["ENZYMES"].x = x
    return out


def test_poisoned_batch_raises_in_train_step_and_eval(toy, nan_checks):
    cfg, batches, make = toy
    step, evaluate, state = make()
    assert batches["ENZYMES"].node_mask[3] == 1 and torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="train step 0: task node_contrast loss"):
        step(state, poisoned(batches))
    with pytest.raises(FloatingPointError, match="eval at step 0: task graph_contrast loss "
                                                 "on ENZYMES"):
        evaluate("graph_contrast", "ENZYMES", poisoned(batches)["ENZYMES"], 0)


def test_nan_made_by_a_backward_op_is_named(nan_checks):
    """A finite loss whose backward makes a NaN (sqrt of a negative in the
    branch ``where`` discards): anomaly mode names the op."""
    p = torch.tensor([-1.0, 4.0], requires_grad=True)
    loss = torch.where(p > 0, p.clamp(min=-2).sqrt(), torch.zeros(2)).sum()
    assert torch.isfinite(loss)
    with pytest.raises(FloatingPointError, match="train step 5, task link_pred backward.*"
                                                 "SqrtBackward0"):
        pt._task_grad(loss, [p], 5, "link_pred")


def test_checks_off_add_no_work(toy, monkeypatch):
    """Off: no finite check and so no host sync in the step. On: one check
    per task loss, one of the combined gradient, one of the parameters; the
    same losses (bitwise at one thread)."""
    cfg, batches, make = toy
    calls = []
    check = pt.check_finite
    monkeypatch.setattr(pt, "check_finite", lambda *a: calls.append(a[0]) or check(*a))
    losses = {}
    for on in (False, True):
        profiling.enable_nan_checks(on)
        try:
            step, _, state = make()
            metrics = step(state, batches)
        finally:
            profiling.enable_nan_checks(False)
        losses[on] = {k: float(v) for k, v in metrics.items() if k.startswith("train/loss/")}
        assert len(calls) == on * (len(cfg.active_tasks) + 2)
    assert losses[True] == losses[False] and all(np.isfinite(list(losses[True].values())))
    assert not torch.is_anomaly_enabled()


def test_debug_nans_flag_switches_the_checks_on(monkeypatch):
    seen = []
    monkeypatch.setattr(pt, "pretrain", lambda cfg, **kw: seen.append(
        (cfg.exp_name, profiling.nan_checks_enabled())) or {})
    try:
        pt.main(["--exp_name", "s2", "--seed", "1", "--device", "cpu"])
        pt.main(["--exp_name", "s2", "--seed", "1", "--device", "cpu", "--debug_nans"])
    finally:
        profiling.enable_nan_checks(False)
    assert seen == [("s2", False), ("s2", True)]


def test_trace_writes_a_profiler_trace(tmp_path):
    with profiling.trace(tmp_path / "profile"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = (tmp_path / "profile").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    with profiling.trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()
