"""What the port's serving slice refuses, on the CPU: an entry point without a
card raises rather than run on the CPU, ``export_serving`` rejects the
kernel aggregations (``pallas``, ``csr``) and unknown platforms, and the
export CLI refuses a task artifact from a pretrain checkpoint (fine-tune
first). What it serves and exports is held in ``test_torch_serving.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu_torch import FinetuneGNN, load_serving_model, serving
from gnn_pretraining_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_serving import ARTIFACT, _cli, _small_example

torch.set_num_threads(1)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving_model("ENZYMES", ARTIFACT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FinetuneGNN("Cora_NC")
    model = load_serving_model("Cora_NC", ARTIFACT, device="cpu", seed=3)
    assert next(model.parameters()).device.type == "cpu" and not model.training


@pytest.mark.parametrize("aggregation", ["pallas", "csr"])
def test_export_rejects_kernel_aggregations(aggregation):
    ex = _small_example("Cora_NC", np.random.default_rng(1))
    with pytest.raises(ValueError, match="not exportable"):
        serving.export_serving(FinetuneGNN("Cora_NC", aggregation, device="cpu"), ex,
                               platforms=("cpu",))


def test_cli_refuses_task_export_from_pretrain_checkpoint(tmp_path):
    ckpt = tmp_path / "pre.msgpack"
    save_checkpoint(ckpt, {"gnn_backbone": {"layers_0": {"eps": np.float32(0)}}}, {},
                    epoch=0)
    with pytest.raises(SystemExit, match="fine-tune first"):
        _cli(tmp_path / "nc.pt2", ckpt, "Cora_NC")
    with pytest.raises(SystemExit, match="fine-tune first"):
        _cli(tmp_path / "nc.pt2", ckpt, "Cora_NC", "--embed")
