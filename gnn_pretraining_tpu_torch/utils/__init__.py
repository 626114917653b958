"""Checkpoints, weight conversion, fidelity markers, losses, logging and
device selection."""

from gnn_pretraining_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_state,
    load_transfer_artifact,
    save_checkpoint,
    save_train_state,
    save_transfer_artifact,
)
from gnn_pretraining_tpu_torch.utils.convert import (
    adamw_to_opt_state,
    load_adamw_state,
    load_pretrained_into_finetune,
    state_dict_to_variables,
    variables_to_state_dict,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device
from gnn_pretraining_tpu_torch.utils.fidelity import (
    cell_completed,
    data_fidelity,
    fidelity_block,
)
