"""A toy ``pretrain()`` run of the port (scheme s2, 1 epoch) against the JAX
package's, and its checkpoint in both packages, on the CPU; and the metric
keys of a toy scheme-s5 run (all six tasks) against the JAX package's.

Both runs read the same tiny store (ENZYMES only, one GIN layer at the full
width of 256), both with ``resume=True`` (which only adds the last epoch's
train-state file). The port's metric keys must equal the JAX run's, its
checkpoint must load in the JAX package's ``load_checkpoint`` with the tree
(every key and shape) of the JAX run's checkpoint, and the port's
``finetune()`` must start from it: the backbone it builds is the checkpoint's.
Each package reads the other's train-state file, every array equal through
the key map; one more AdamW update from the restored states agrees (rtol
1e-6, atol 1e-9, as ``tests/test_torch_pretrain_parts.py``'s optimizer
test); the summaries' ``fidelity/*`` blocks agree; and the JAX package's
``load_transfer_artifact`` reads the port's transfer artifact to what the
JAX writer gives for the same tree.
"""

from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.models.pretrain_model import PretrainableGNN as JaxPretrainableGNN
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain_module
from gnn_pretraining_tpu.pretrain.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu.utils import checkpoint as jax_checkpoint
from gnn_pretraining_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from gnn_pretraining_tpu.utils.fidelity import fidelity_block as jax_fidelity_block
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer
from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain
from gnn_pretraining_tpu_torch.utils import checkpoint as port_checkpoint
from gnn_pretraining_tpu_torch.utils.convert import (
    adamw_to_opt_state,
    model_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

DOMAINS = ("ENZYMES",)


def run_both(tmp, scheme):
    """The JAX package's pretrain() and the port's, 1 epoch each, on a tiny
    ENZYMES store in ``tmp``; -> {"jax"|"port": {result, rows, root}}."""
    processed = tmp / "processed"
    processed.mkdir()
    rng = np.random.default_rng(2)
    for domain, graphs in (("ENZYMES", 40),):
        synthetic_pretrain_store(domain, rng, num_graphs=graphs).save(processed / f"{domain}.npz")
    out = {"processed": processed}
    for name, run, kwargs in (
            ("jax", jax_pretrain, dict(aggregation="dense", use_wandb=False,
                                       chunk_steps=1, resume=True)),
            ("port", pretrain, dict(aggregation="pallas", device="cpu", resume=True))):
        root = tmp / name
        result = run(jax_config.PretrainConfig(scheme, 7) if name == "jax"
                     else config.PretrainConfig(scheme, 7), epochs=1,
                     processed_dir=processed, out_root=root, **kwargs)
        rows = [json.loads(line) for line in
                open(root / "metrics" / config.PRETRAIN_PROJECT_NAME / f"{scheme}_7.jsonl")]
        out[name] = {"result": result, "rows": rows, "root": root}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "GNN_NUM_LAYERS", 1)
            mp.setitem(c.PRETRAIN_DOMAINS, "s2", DOMAINS)
        out = run_both(tmp_path_factory.mktemp("s2_loop"), "s2")
        # The port's finetune() from the port's checkpoint (ENZYMES, 1 epoch).
        cfg = config.FinetuneConfig("ENZYMES", "full_finetune", "s2", 7)
        model = ft.build_finetune_model(cfg, "pallas", "cpu", out["port"]["root"])
        out["finetune_model"] = model
        out["finetune"] = ft.finetune(cfg, processed_dir=out["processed"], epochs=1,
                                      out_root=out["port"]["root"], device="cpu")
    return out


def jax_s5_keys(jax_s2_rows):
    """The metric keys the JAX package's pretrain() logs for s5 over DOMAINS."""
    cfg = jax_config.PretrainConfig("s5", 7)
    main = [t for t in cfg.active_tasks if t != "domain_adv"]
    params = state_dict_to_variables(PretrainableGNN(
        DOMAINS, cfg.active_tasks, "dense", device="cpu").state_dict())["params"]
    optimizer = jax_opt.create_task_specific_optimizer(params, cfg.active_tasks)
    jmodel = JaxPretrainableGNN(domain_names=DOMAINS, task_names=cfg.active_tasks)
    _, update_core, assemble_metrics, _ = jax_pretrain_module._make_step_parts(
        jmodel, cfg, optimizer, 10)
    one = jnp.float32(1.0)
    losses = {t: one for t in main}
    _, _, _, metrics = jax.eval_shape(
        update_core, params, optimizer.init(params), jnp.int32(0), losses,
        {t: params for t in main}, params, jax.random.PRNGKey(0))
    step = assemble_metrics(dict(metrics), {t: {d: one for d in DOMAINS}
                                            for t in cfg.active_tasks},
                            losses, one, jnp.int32(0))
    logged = []
    logger = type("Logger", (), {"log": lambda self, m, step: logged.append(m)})()
    state = types.SimpleNamespace(params=None, batch_stats=None, opt_step=0,
                                  balancer_step=0)
    jax_pretrain_module.run_evaluation(lambda *args: 1.0, state, cfg,
                                       {d: [None] for d in DOMAINS},
                                       jax.random.PRNGKey(0), 1, logger, 0)
    loop = {k for r in jax_s2_rows for k in r
            if k.startswith(("train/system/", "train/progress/"))}
    return set(step) | loop | set(logged[0])


@pytest.fixture(scope="module")
def runs_s5(tmp_path_factory, runs):
    """The port's s5 pretrain() (1 epoch) and the JAX package's s5 keys."""
    tmp = tmp_path_factory.mktemp("s5_loop")
    processed = tmp / "processed"
    processed.mkdir()
    synthetic_pretrain_store("ENZYMES", np.random.default_rng(2), num_graphs=40).save(
        processed / "ENZYMES.npz")
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "GNN_NUM_LAYERS", 1)
            mp.setitem(c.PRETRAIN_DOMAINS, "s5", DOMAINS)
        pretrain(config.PretrainConfig("s5", 7), epochs=1, processed_dir=processed,
                 out_root=tmp, aggregation="pallas", device="cpu")
        want = jax_s5_keys(runs["jax"]["rows"])
    rows = [json.loads(line) for line in
            open(tmp / "metrics" / config.PRETRAIN_PROJECT_NAME / "s5_7.jsonl")]
    return {"rows": rows, "want": want}


def keys_of(rows, prefix):
    return sorted({k for r in rows for k in r if k.startswith(prefix)})


@pytest.mark.parametrize("prefix", ["train/", "val/", "gradient_surgery/"])
def test_metric_keys_equal_jax(runs, prefix):
    got, want = keys_of(runs["port"]["rows"], prefix), keys_of(runs["jax"]["rows"], prefix)
    assert got == want and got
    assert len(runs["port"]["rows"]) == len(runs["jax"]["rows"])     # steps + val
    losses = [r["train/loss/total"] for r in runs["port"]["rows"] if "train/loss/total" in r]
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("prefix", ["train/", "val/", "gradient_surgery/"])
def test_metric_keys_equal_jax_s5(runs_s5, prefix):
    """As for s2, with the domain-adversarial keys: train/loss/domain_adv,
    train/domain_adv/{loss,lambda}, val/domain_adv/loss."""
    rows = runs_s5["rows"]
    got = set(keys_of(rows, prefix))
    assert got == {k for k in runs_s5["want"] if k.startswith(prefix)}
    steps = [r for r in rows if "train/loss/total" in r]
    assert len(steps) == len(rows) - 1 and np.isfinite(
        [r["train/loss/total"] for r in steps]).all()
    assert {"train/": {"train/domain_adv/loss", "train/domain_adv/lambda",
                       "train/loss/domain_adv", "train/loss/ENZYMES/domain_adv"},
            "val/": {"val/domain_adv/loss", "val/loss/domain_adv"},
            "gradient_surgery/": set()}[prefix] <= got


def test_checkpoint_loads_in_jax_with_the_jax_tree(runs):
    port = jax_load_checkpoint(runs["port"]["result"]["checkpoint"])
    want = jax_load_checkpoint(runs["jax"]["result"]["checkpoint"])
    shapes = lambda tree: {k: (shapes(v) if isinstance(v, dict)  # noqa: E731
                               else np.shape(v)) for k, v in tree.items()}
    assert shapes(port["params"]) == shapes(want["params"])
    assert shapes(port["batch_stats"]) == shapes(want["batch_stats"])
    assert port["meta"]["epoch"] == want["meta"]["epoch"] == 1
    assert port["meta"]["val_metrics"].keys() == want["meta"]["val_metrics"].keys()
    assert runs["port"]["result"]["epochs"] == runs["jax"]["result"]["epochs"] == 1


def test_finetune_starts_from_the_checkpoint(runs):
    ckpt = jax_load_checkpoint(runs["port"]["result"]["checkpoint"])
    model = runs["finetune_model"]
    for i in range(1):
        kernel = ckpt["params"]["gnn_backbone"][f"layers_{i}"]["mlp_0"]["kernel"]
        np.testing.assert_array_equal(
            model.gnn_backbone.layers[i].gin_conv.nn[0].weight.detach().numpy(), kernel.T)
    encoder = ckpt["params"]["input_encoders_ENZYMES"]["linear"]["kernel"]
    np.testing.assert_array_equal(model.input_encoder.linear.weight.detach().numpy(), encoder.T)
    assert np.isfinite(runs["finetune"]["test/loss"])


def flat(tree, path=""):
    """path -> leaf of a restored tree; an empty dict (optax's masked leaf,
    an empty state) is a leaf of its own."""
    if isinstance(tree, dict) and tree:
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{path}/{key}").items()}
    return {path: "{}" if isinstance(tree, dict) else tree}


def assert_same_leaves(got, want, **tol):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        elif tol:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=k, **tol)
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


def resume_file(runs, name):
    return runs[name]["root"] / "pretrain" / "resume_s2_7.msgpack"


def port_run(monkeypatch, path):
    """A fresh port s2 run (one GIN layer, ENZYMES) restored from ``path``:
    (model, optimizer, counters, labels, label order)."""
    monkeypatch.setattr(config, "GNN_NUM_LAYERS", 1)
    monkeypatch.setitem(config.PRETRAIN_DOMAINS, "s2", DOMAINS)
    cfg = config.PretrainConfig("s2", 7)
    model = pt.build_pretrain_model(cfg, "pallas", "cpu")
    optimizer, labels, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    streams = pt.random_streams(cfg, model, "cpu")
    seeded = pt.stream_states(streams)
    counters = pt.load_resume_state(path, model, optimizer, cfg, streams)
    return (model, optimizer, counters, labels, ["default", *cfg.active_tasks],
            (seeded, pt.stream_states(streams)))


def test_jax_train_state_loads_in_port(runs, monkeypatch, capsys):
    """The JAX run's file: weights, BN statistics, moments and counts equal
    the file's through the key map; no stream state, so the streams stay
    at their seeds, and the port says so."""
    path = resume_file(runs, "jax")
    model, optimizer, counters, labels, order, (seeded, after) = port_run(monkeypatch, path)
    assert "holds no random-stream states" in capsys.readouterr().out
    want = serialization.msgpack_restore(path.read_bytes())
    variables = model_variables(model)
    assert_same_leaves(variables["params"], want["params"])
    assert_same_leaves(variables["batch_stats"], want["batch_stats"])
    assert_same_leaves(adamw_to_opt_state(model, optimizer, labels, order), want["opt_state"])
    steps = [r for r in runs["jax"]["rows"] if "train/loss/total" in r]
    assert counters == want["counters"]
    assert (counters["epoch"], counters["best_total"], counters["opt_step"]) == (
        runs["jax"]["result"]["epochs"], runs["jax"]["result"]["best_val_total"], len(steps))
    assert flat(after).keys() == flat(seeded).keys() and all(
        np.array_equal(a, b) for a, b in zip(flat(after).values(), flat(seeded).values()))


def test_port_pretrain_carries_on_from_the_jax_file(runs, monkeypatch, tmp_path, capsys):
    """The JAX run's file at the port's resume path: written at the last
    epoch, so the port trains nothing, says that the streams start from
    their seeds, and writes the summary."""
    monkeypatch.setattr(config, "GNN_NUM_LAYERS", 1)
    monkeypatch.setitem(config.PRETRAIN_DOMAINS, "s2", DOMAINS)
    (tmp_path / "pretrain").mkdir()
    (tmp_path / "pretrain" / "resume_s2_7.msgpack").write_bytes(
        resume_file(runs, "jax").read_bytes())
    result = pretrain(config.PretrainConfig("s2", 7), epochs=1, processed_dir=runs["processed"],
                      out_root=tmp_path, device="cpu", resume=True)
    out = capsys.readouterr().out
    assert "holds no random-stream states" in out and "resumed s2_7 at epoch 2" in out
    assert result["epochs"] == 1
    assert result["best_val_total"] == runs["jax"]["result"]["best_val_total"]
    summary = json.loads((tmp_path / "metrics" / config.PRETRAIN_PROJECT_NAME
                          / "s2_7.summary.json").read_text())
    assert summary["fidelity/completed"] == 1 and summary["fidelity/epochs"] == 1


def jax_restored(runs):
    """The port run's file through JAX ``load_train_state``, onto a template
    over the port checkpoint's tree: (state, counters, template, payload)."""
    ckpt = jax_load_checkpoint(runs["port"]["result"]["checkpoint"])
    tasks = jax_config.PretrainConfig("s2", 7).active_tasks
    optimizer = jax_opt.create_task_specific_optimizer(ckpt["params"], tasks)
    template = jax_pretrain_module.TrainState(
        params=ckpt["params"], batch_stats=ckpt["batch_stats"],
        opt_state=optimizer.init(ckpt["params"]), opt_step=jnp.int32(0),
        balancer_step=jnp.int32(0))
    path = resume_file(runs, "port")
    state, counters = jax_checkpoint.load_train_state(path, template)
    return state, counters, template, optimizer, serialization.msgpack_restore(path.read_bytes())


def test_port_train_state_loads_in_jax(runs):
    state, counters, template, _, payload = jax_restored(runs)
    assert jax.tree.structure(state.opt_state) == jax.tree.structure(template.opt_state)
    assert_same_leaves(serialization.to_state_dict(state.opt_state), payload["opt_state"])
    assert_same_leaves(state.params, payload["params"])
    assert_same_leaves(state.batch_stats, payload["batch_stats"])
    steps = [r for r in runs["port"]["rows"] if "train/loss/total" in r]
    assert counters == payload["counters"] and int(state.opt_step) == len(steps)
    assert int(state.balancer_step) == counters["balancer_step"]
    assert counters["best_total"] == runs["port"]["result"]["best_val_total"]


def test_one_more_update_agrees(runs, monkeypatch):
    """One optax update from the JAX-restored state and one port AdamW step
    from the port-restored state, on the same seeded gradients."""
    state, _, _, optimizer, _ = jax_restored(runs)
    rng = np.random.default_rng(12)
    grads = jax.tree.map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32),
                         state.params)
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)

    model, port_opt, _, labels, order, _ = port_run(monkeypatch, resume_file(runs, "port"))
    port_grads = variables_to_state_dict({"params": grads})
    for name, p in model.named_parameters():
        p.grad = port_grads[name]
    port_opt.step()
    tol = dict(rtol=1e-6, atol=1e-9)
    assert_same_leaves(model_variables(model)["params"], params, **tol)
    got = adamw_to_opt_state(model, port_opt, labels, order)
    assert_same_leaves(got, serialization.to_state_dict(opt_state), **tol)
    assert {int(v["inner_state"]["0"]["count"]) for v in got["inner_states"].values()} == {
        len([r for r in runs["port"]["rows"] if "train/loss/total" in r]) + 1}


def test_summary_fidelity_block_equals_jax(runs):
    """The same block as the JAX run's summary, but for the aggregation each
    run used (the JAX run's dense, the port's K1)."""
    def block(name):
        path = (runs[name]["root"] / "metrics" / config.PRETRAIN_PROJECT_NAME
                / "s2_7.summary.json")
        return {k: v for k, v in json.loads(path.read_text()).items()
                if k.startswith("fidelity/")}

    want = jax_fidelity_block(1, 7, "pallas", runs["processed"], DOMAINS)
    assert block("port") == want
    assert block("jax") == {**want, "fidelity/aggregation": "dense"}


@pytest.mark.parametrize("part", ["arrays", "meta", "subtrees_and_dtypes"])
def test_transfer_artifact_equals_the_jax_writers(runs, tmp_path, part):
    """From the port checkpoint's tree, with an int32 and an f64 leaf added
    to the backbone (kept as they are) and numbers in ``meta``."""
    ckpt = port_checkpoint.load_checkpoint(runs["port"]["result"]["checkpoint"])
    params = dict(ckpt["params"])
    params["gnn_backbone"] = {**params["gnn_backbone"], "steps": np.arange(3, dtype=np.int32),
                              "scale64": np.linspace(0, 1, 4)}
    meta = {"scheme": "s2", "seed": 7, "val_total": np.float32(0.75), "tracked": True}
    paths = {"port": tmp_path / "port.msgpack", "jax": tmp_path / "jax.msgpack"}
    port_checkpoint.save_transfer_artifact(paths["port"], params, ckpt["batch_stats"], meta)
    jax_checkpoint.save_transfer_artifact(paths["jax"], params, ckpt["batch_stats"], meta)
    got, want = (jax_checkpoint.load_transfer_artifact(p) for p in paths.values())
    if part == "arrays":
        assert_same_leaves(got["params"], want["params"])
        assert_same_leaves(got["batch_stats"], want["batch_stats"])
    elif part == "meta":
        assert got["meta"] == want["meta"] == {"scheme": "s2", "seed": 7.0,
                                               "val_total": 0.75, "tracked": True}
        assert all(type(got["meta"][k]) is type(v) for k, v in want["meta"].items())
    else:
        raw = serialization.msgpack_restore(paths["port"].read_bytes())
        assert set(raw["params"]) == {"gnn_backbone", "input_encoders_ENZYMES"}
        assert set(raw["batch_stats"]) == {"gnn_backbone", "input_encoders_ENZYMES"}
        dtypes = {np.asarray(v).dtype for v in flat(raw["params"]).values()}
        assert dtypes == {np.dtype(np.float16), np.dtype(np.int32), np.dtype(np.float64)}
        assert raw["params"]["gnn_backbone"]["steps"].dtype == np.int32
