"""A toy ``pretrain()`` run of the port (scheme s2, 1 epoch) against the JAX
package's, and its checkpoint in both packages, on the CPU; and the metric
keys of a toy scheme-s5 run (all six tasks) against the JAX package's.

Both runs read the same tiny store (ENZYMES only, one GIN layer at the full
width of 256). The port's metric keys must equal the JAX run's, its
checkpoint must load in the JAX package's ``load_checkpoint`` with the tree
(every key and shape) of the JAX run's checkpoint, and the port's
``finetune()`` must start from it: the backbone it builds is the checkpoint's.
"""

from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.models.pretrain_model import PretrainableGNN as JaxPretrainableGNN
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain_module
from gnn_pretraining_tpu.pretrain.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain
from gnn_pretraining_tpu_torch.utils.convert import state_dict_to_variables

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
                                       chunk_steps=1)),
            ("port", pretrain, dict(aggregation="pallas", device="cpu"))):
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
