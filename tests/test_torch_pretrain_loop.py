"""A toy ``pretrain()`` run of the port (scheme s2, 1 epoch) against the JAX
package's, and its checkpoint in both packages, on the CPU.

Both runs read the same tiny store (ENZYMES only, one GIN layer at the full
width of 256). The port's metric keys must equal the JAX run's, its
checkpoint must load in the JAX package's ``load_checkpoint`` with the tree
(every key and shape) of the JAX run's checkpoint, and the port's
``finetune()`` must start from it: the backbone it builds is the checkpoint's.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.pretrain.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

DOMAINS = ("ENZYMES",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2_loop")
    processed = tmp / "processed"
    processed.mkdir()
    rng = np.random.default_rng(2)
    for domain, graphs in (("ENZYMES", 40),):
        synthetic_pretrain_store(domain, rng, num_graphs=graphs).save(processed / f"{domain}.npz")
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "GNN_NUM_LAYERS", 1)
            mp.setitem(c.PRETRAIN_DOMAINS, "s2", DOMAINS)
        out = {}
        for name, run, kwargs in (
                ("jax", jax_pretrain, dict(aggregation="dense", use_wandb=False,
                                           chunk_steps=1)),
                ("port", pretrain, dict(aggregation="pallas", device="cpu"))):
            root = tmp / name
            result = run(jax_config.PretrainConfig("s2", 7) if name == "jax"
                         else config.PretrainConfig("s2", 7), epochs=1,
                         processed_dir=processed, out_root=root, **kwargs)
            rows = [json.loads(line) for line in
                    open(root / "metrics" / config.PRETRAIN_PROJECT_NAME / "s2_7.jsonl")]
            out[name] = {"result": result, "rows": rows, "root": root}
        # The port's finetune() from the port's checkpoint (ENZYMES, 1 epoch).
        cfg = config.FinetuneConfig("ENZYMES", "full_finetune", "s2", 7)
        model = ft.build_finetune_model(cfg, "pallas", "cpu", out["port"]["root"])
        out["finetune_model"] = model
        out["finetune"] = ft.finetune(cfg, processed_dir=processed, epochs=1,
                                      out_root=out["port"]["root"], device="cpu")
    return out


def keys_of(rows, prefix):
    return sorted({k for r in rows for k in r if k.startswith(prefix)})


@pytest.mark.parametrize("prefix", ["train/", "val/", "gradient_surgery/"])
def test_metric_keys_equal_jax(runs, prefix):
    got, want = keys_of(runs["port"]["rows"], prefix), keys_of(runs["jax"]["rows"], prefix)
    assert got == want and got
    assert len(runs["port"]["rows"]) == len(runs["jax"]["rows"])     # steps + val
    losses = [r["train/loss/total"] for r in runs["port"]["rows"] if "train/loss/total" in r]
    assert np.isfinite(losses).all()


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
