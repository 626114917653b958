"""gnn_pretraining_tpu_torch — the PyTorch/CUDA port of gnn_pretraining_tpu.

A second package beside the JAX one, which stays the reference. It runs on
one NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel of the
JAX package gets a kernel written by hand for Hopper (``csrc/``). Ported so
far: the serving path (the eval-mode forward of ``FinetuneGNN`` with the
weights of the JAX transfer artifacts), the fine-tune training path
(``finetune.finetune``: GC, NC and LP steps and the per-step host loop) and
multi-task pretraining (``pretrain.pretrain``: every scheme), on kernel K1,
the GIN aggregation, forward and backward,
and kernel K2, the fused NT-Xent, forward and backward; and fine-tuning on
graphs past the dense limit (``aggregation="csr"``) on kernel K3, the
block-CSR GIN aggregation, forward and backward. The offline preprocessing
(``python -m gnn_pretraining_tpu_torch.data.setup``) writes the stores they
read, the same as the JAX package's setup, on host code only. At the
boundaries: reference PyTorch ``.pt`` checkpoints import into the port's
models (``utils.torch_import``), a fine-tuned model exports as a
self-contained ``torch.export`` serving artifact (``serving.export_serving``,
``python -m gnn_pretraining_tpu_torch.export_model``), and ``pretrain
--debug_nans`` stops at the first NaN (``utils.profiling``). Pretraining and
graph-classification fine-tuning run data-parallel over the ranks of a
``torch.distributed`` group (``parallel/``, the drivers' ``--dp auto``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.serving import (
    load_serving_model,
    make_embedding_fn,
    make_serving_fn,
)

__version__ = "0.1.0"
