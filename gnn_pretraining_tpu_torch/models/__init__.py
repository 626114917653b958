"""Model library: torch modules with the reference's semantics on padded batches."""

from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.models.gnn import (
    GINBackbone,
    GINConv,
    GINLayer,
    InputEncoder,
    TorchLinear,
)
from gnn_pretraining_tpu_torch.models.heads import (
    DomainClassifierHead,
    MLPHead,
    MLPLinkPredictor,
)
from gnn_pretraining_tpu_torch.models.norm import MaskedBatchNorm
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
