"""Checkpoints, weight conversion, losses, logging and device selection."""

from gnn_pretraining_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_transfer_artifact,
    save_checkpoint,
)
from gnn_pretraining_tpu_torch.utils.convert import (
    load_pretrained_into_finetune,
    state_dict_to_variables,
    variables_to_state_dict,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device
