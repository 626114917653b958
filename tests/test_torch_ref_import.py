"""The port's reference-checkpoint importer against the JAX package's.

Reference-format ``.pt`` files (``torch.save({"epoch", "model_state_dict",
"val_metrics"})`` with the reference's keys and BatchNorm's
``num_batches_tracked``) are written from port models: a ``FinetuneGNN`` of
each task type and a ``PretrainableGNN`` of scheme s5 (every head), and a
copy of one cut mid-storage. On each file the port's
``utils.torch_import`` must give what ``gnn_pretraining_tpu.utils.
torch_import`` gives, bitwise:

  * ``read_torch_checkpoint``: key sets, ``missing``, ``epoch``,
    ``val_metrics``, every array and its dtype; also on the JAX test's
    edge cases (a non-contiguous view, a bf16 storage, a cut at an odd byte);
  * ``reference_to_port`` against the JAX key map carried into the port's
    layout, ``variables_to_state_dict(torch_state_to_flax(sd))``;
  * both loaders, from the same starting weights (a port model, carried to
    the JAX tree with ``utils.convert``), whole and truncated files, and the
    ``KeyError`` / ``ValueError`` of a key or a shape that does not fit
    (``test_torch_ref_loaders.py``, on the files of this module's fixture).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.utils import torch_import as jax_import
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.utils import torch_import
from gnn_pretraining_tpu_torch.utils.convert import variables_to_state_dict

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

FINETUNE_DOMAINS = ("ENZYMES", "Cora_NC", "Cora_LP")
MODELS = FINETUNE_DOMAINS + ("s5",)


def build(name: str, seed: int):
    """A port model with seeded weights, and BN statistics, BN scales and
    shifts and GIN eps moved off their init values."""
    gen = torch.Generator().manual_seed(seed)
    if name in FINETUNE_DOMAINS:
        model = FinetuneGNN(name, "coo", generator=gen, device="cpu")
    else:
        cfg = config.PretrainConfig(name, 42)
        model = PretrainableGNN(cfg.pretrain_domains, cfg.active_tasks, "coo",
                                generator=gen, device="cpu")
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key.endswith("running_mean"):
                value.normal_(0.0, 0.2, generator=gen)
            elif key.endswith("running_var"):
                value.uniform_(0.5, 1.5, generator=gen)
            elif key.endswith("gin_conv.eps"):
                value.uniform_(-0.3, 0.3, generator=gen)
            elif key.endswith("weight") and value.dim() == 1:
                value.uniform_(0.5, 1.5, generator=gen)
            elif key.endswith("bias"):
                value.add_(torch.randn(value.shape, generator=gen), alpha=0.1)
    return model


def save_reference(path, model, epoch=3, val_metrics=None):
    torch.save({"epoch": epoch,
                "model_state_dict": torch_import.port_to_reference(model.state_dict(), 11),
                "val_metrics": val_metrics or {"val/accuracy": 0.625, "val/loss": 1.5}},
               str(path))
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> (.pt path, the port model it was written from); "Cora_NC cut"
    is Cora_NC's file cut at half its bytes, mid-storage."""
    tmp = tmp_path_factory.mktemp("reference_pt")
    out = {}
    for name in MODELS:
        model = build(name, 1)
        out[name] = (save_reference(tmp / f"{name}.pt", model), model)
    blob = out["Cora_NC"][0].read_bytes()
    cut = tmp / "Cora_NC_cut.pt"
    cut.write_bytes(blob[:len(blob) // 2])
    out["Cora_NC cut"] = (cut, out["Cora_NC"][1])
    return out


def assert_same_reads(got, want):
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    assert got["missing"] == want["missing"]
    assert got.get("epoch") == want.get("epoch")
    assert got.get("val_metrics") == want.get("val_metrics")
    for key, arr in want["state_dict"].items():
        assert got["state_dict"][key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got["state_dict"][key], arr, err_msg=key)


@pytest.mark.parametrize("name", MODELS + ("Cora_NC cut",))
def test_reader_matches_jax(files, name):
    path, model = files[name]
    got = torch_import.read_torch_checkpoint(path)
    assert_same_reads(got, jax_import.read_torch_checkpoint(path))
    reference = torch_import.port_to_reference(model.state_dict(), 11)
    assert set(got["state_dict"]) | set(got["missing"]) == set(reference)
    if name.endswith("cut"):
        assert 0 < len(got["missing"]) < len(reference)
    else:
        assert got["missing"] == [] and got["epoch"] == 3
        for key, value in reference.items():
            np.testing.assert_array_equal(got["state_dict"][key], value.numpy())


def _noncontiguous():
    base = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    return {"ok": base.clone(), "bad": base.t()}, None


def _bf16():
    return {"bf": torch.zeros(4, dtype=torch.bfloat16),
            "f": torch.ones(4, dtype=torch.float32)}, None


def _odd_cut():
    return {"a": torch.arange(64, dtype=torch.float32),
            "z": torch.arange(64, dtype=torch.float32)}, lambda n: (n * 3 // 4) | 1


@pytest.mark.parametrize("case,unread", [(_noncontiguous, {"bad"}), (_bf16, {"bf"}),
                                         (_odd_cut, None)],
                         ids=["noncontiguous", "unknown_dtype", "odd_byte_truncation"])
def test_reader_edge_cases_match_jax(tmp_path, case, unread):
    """tests/test_torch_import.py:182-214's cases: what cannot be read is
    reported in ``missing``, never made up, by both readers alike."""
    sd, cut = case()
    path = tmp_path / "ck.pt"
    torch.save({"model_state_dict": sd, "epoch": 1}, str(path))
    if cut is not None:
        blob = path.read_bytes()
        path.write_bytes(blob[:cut(len(blob))])
    got = torch_import.read_torch_checkpoint(path)
    assert_same_reads(got, jax_import.read_torch_checkpoint(path))
    assert set(got["state_dict"]) | set(got["missing"]) == set(sd)
    if unread is not None:
        assert set(got["missing"]) == unread
    for key, arr in got["state_dict"].items():
        np.testing.assert_array_equal(arr, sd[key].numpy())


@pytest.mark.parametrize("name", MODELS + ("Cora_NC cut",))
def test_reference_to_port_matches_jax_key_map(files, name):
    sd = jax_import.read_torch_checkpoint(files[name][0])["state_dict"]
    got = torch_import.reference_to_port(sd)
    want = variables_to_state_dict(jax_import.torch_state_to_flax(sd))
    assert sorted(got) == sorted(want)
    for key, tensor in want.items():
        assert got[key].dtype == tensor.dtype and torch.equal(got[key], tensor), key
    if "cut" not in name:
        assert sorted(got) == sorted(files[name][1].state_dict())


