"""gnn_pretraining_tpu_torch — the PyTorch/CUDA port of gnn_pretraining_tpu.

A second package beside the JAX one, which stays the reference. It runs on
one NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel of the
JAX package gets a kernel written by hand for Hopper (``csrc/``). This slice
holds the serving path: the eval-mode forward of ``FinetuneGNN`` on kernel K1
(the GIN aggregation), with the weights of the JAX transfer artifacts.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.serving import (
    load_serving_model,
    make_embedding_fn,
    make_serving_fn,
)

__version__ = "0.1.0"
