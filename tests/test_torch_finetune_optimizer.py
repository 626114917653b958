"""Each parameter's AdamW group in the port against the JAX package's optax
label (``create_finetune_optimizer``), alone: for every domain and freeze
strategy, each parameter falls in the group whose learning rate and freeze
the JAX label gives it. The three steps of the groups against
``optax.multi_transform`` are in ``test_torch_finetune_adamw.py``.
"""

from __future__ import annotations

import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.finetune import finetune as jax_ft
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.finetune import finetune as ft

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

@pytest.mark.parametrize("domain", sorted(config.TASK_TYPES))
@pytest.mark.parametrize("strategy", config.FINETUNE_STRATEGIES)
def test_group_of_param_equals_jax(domain, strategy):
    cfg = config.FinetuneConfig(domain, strategy, "b2", 1)
    jcfg = jax_config.FinetuneConfig(domain, strategy, "b2", 1)
    for top in ("input_encoder", "gnn_backbone", "classification_head"):
        assert ft.group_of_param(top, cfg) == jax_ft.group_of_param(top, jcfg)
