"""The port's loaders of reference ``.pt`` checkpoints against the JAX
package's importer, on the CPU, on ``torch.save`` files written from port
models (``test_torch_ref_import.py`` builds them, and holds the reader and
the key map): ``load_torch_pretrained_into_finetune`` and
``load_torch_finetune_checkpoint`` give the JAX loaders' trees, a fine-tune
model built from a reference file serves as its source, the loaders raise
where the JAX ones do, and the loaded tensors go to the model's device.
"""

from __future__ import annotations

import pytest
import torch

from gnn_pretraining_tpu.utils import torch_import as jax_import
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.utils import torch_import
from gnn_pretraining_tpu_torch.utils.checkpoint import save_checkpoint
from gnn_pretraining_tpu_torch.utils.convert import (
    model_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)
from test_torch_ref_import import build, files

torch.set_num_threads(1)


def port_and_jax_start(domain: str):
    """A port FinetuneGNN with seeded weights other than the files', and the
    same weights as the JAX importer's starting tree."""
    model = build(domain, 2)
    return model, model_variables(model)


def assert_model_equals_tree(model, tree):
    want = variables_to_state_dict(tree)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, tensor in want.items():
        assert torch.equal(got[key], tensor), key


@pytest.mark.parametrize("domain", ["ENZYMES", "Cora_NC"])
def test_pretrained_loader_matches_jax(files, domain):
    path, source = files["s5"]
    model, start = port_and_jax_start(domain)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch_import.load_torch_pretrained_into_finetune(model, path, domain)
    assert_model_equals_tree(model, jax_import.load_torch_pretrained_into_finetune(
        start, path, domain))
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    carried = {k for k in before if k.startswith("gnn_backbone.")}
    if domain == "ENZYMES":
        carried |= {k for k in before if k.startswith("input_encoder.")}
    assert moved == carried
    src = source.state_dict()
    assert torch.equal(model.state_dict()["gnn_backbone.layers.4.gin_conv.eps"],
                       src["gnn_backbone.layers.4.gin_conv.eps"])


def test_finetune_model_from_a_reference_pt(files, tmp_path):
    """A reference pretrain ``.pt`` reaches ``finetune()`` as a port pretrain
    checkpoint (``reference_to_port``, ``state_dict_to_variables``,
    ``save_checkpoint`` under ``out_root/pretrain``): the cell's model is its
    seeded init with the transfer contract applied from the ``.pt``, as the
    JAX importer applies it to the same init."""
    path = files["s5"][0]
    read = torch_import.read_torch_checkpoint(path)
    variables = state_dict_to_variables(torch_import.reference_to_port(read["state_dict"]))
    save_checkpoint(tmp_path / "pretrain" / "model_s5_42.msgpack", variables["params"],
                    variables["batch_stats"], read["epoch"], read["val_metrics"])
    model = ft.build_finetune_model(config.FinetuneConfig("ENZYMES", "full_finetune", "s5", 42),
                                    "pallas", "cpu", out_root=tmp_path)
    fresh = ft.build_finetune_model(config.FinetuneConfig("ENZYMES", "full_finetune", "b1", 42),
                                    "pallas", "cpu")
    assert_model_equals_tree(model, jax_import.load_torch_pretrained_into_finetune(
        model_variables(fresh), path, "ENZYMES"))


@pytest.mark.parametrize("name", ["Cora_NC", "Cora_NC cut"])
def test_finetune_loader_matches_jax(files, name):
    path, source = files[name]
    model, start = port_and_jax_start("Cora_NC")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, missing = torch_import.load_torch_finetune_checkpoint(model, path)
    want, want_missing = jax_import.load_torch_finetune_checkpoint(start, path)
    assert missing == want_missing
    assert_model_equals_tree(model, want)
    kept = {k for k in before if k in missing}
    for key, value in model.state_dict().items():
        expected = before[key] if key in kept else source.state_dict()[key]
        assert torch.equal(value, expected), key
    assert bool(kept) == name.endswith("cut")


def _extra_key(sd):
    sd["gnn_backbone.layers.0.extra.weight"] = torch.ones(2, 2)


def _wrong_shape(sd):
    sd["gnn_backbone.layers.0.gin_conv.nn.0.weight"] = torch.ones(3, 3)


@pytest.mark.parametrize("loader", ["finetune", "pretrained"])
@pytest.mark.parametrize("edit,error", [(_extra_key, KeyError), (_wrong_shape, ValueError)],
                         ids=["KeyError", "ValueError"])
def test_loaders_raise_as_jax(tmp_path, loader, edit, error):
    """A key without a counterpart, or a shape that differs: both packages
    raise the same error, and the port's model is left as it was."""
    source = build("ENZYMES" if loader == "finetune" else "s5", 1)
    sd = torch_import.port_to_reference(source.state_dict())
    edit(sd)
    path = tmp_path / "bad.pt"
    torch.save({"model_state_dict": sd}, str(path))
    model, start = port_and_jax_start("ENZYMES")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    if loader == "finetune":
        port_call = lambda: torch_import.load_torch_finetune_checkpoint(model, path)  # noqa: E731
        jax_call = lambda: jax_import.load_torch_finetune_checkpoint(start, path)  # noqa: E731
    else:
        port_call = lambda: torch_import.load_torch_pretrained_into_finetune(  # noqa: E731
            model, path, "ENZYMES")
        jax_call = lambda: jax_import.load_torch_pretrained_into_finetune(  # noqa: E731
            start, path, "ENZYMES")
    with pytest.raises(error):
        jax_call()
    with pytest.raises(error):
        port_call()
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_loaded_tensors_go_to_the_models_device(files):
    """Loading moves nothing off the model's device and keeps its dtypes (here
    the CPU; on the card, the card)."""
    model, _ = port_and_jax_start("Cora_NC")
    torch_import.load_torch_finetune_checkpoint(model, files["Cora_NC"][0])
    assert {(t.device.type, t.dtype) for t in model.state_dict().values()} == {
        ("cpu", torch.float32)}
