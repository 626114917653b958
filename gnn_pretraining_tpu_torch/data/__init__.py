"""Graph stores on disk and padded batches as tensors."""

from gnn_pretraining_tpu_torch.data.batch import (
    GraphBatch,
    GraphStore,
    build_batch,
    pad_to,
    round_up,
)
from gnn_pretraining_tpu_torch.data.loaders import (
    GraphClassificationData,
    LinkPredictionData,
    NodeClassificationData,
    create_finetune_arrays,
)
