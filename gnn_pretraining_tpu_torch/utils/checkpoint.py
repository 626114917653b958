"""Reading the JAX package's checkpoints: flax msgpack of {params, batch_stats, meta}.

Read side only. The trees come back as nested dicts of numpy arrays, in the
flax layout (``kernel`` [in, out], ``scale``, ``mean``/``var``);
``utils.convert`` carries them across into a torch ``state_dict``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from gnn_pretraining_tpu_torch.utils._msgpack import unpackb


def load_checkpoint(path) -> Dict[str, Any]:
    """The whole tree of a ``save_checkpoint`` file, as flax restores it."""
    return unpackb(Path(path).read_bytes())


def load_transfer_artifact(path) -> Dict[str, Any]:
    """Load a ``save_transfer_artifact`` file, promoting fp16 back to f32 so
    the restored weights drop into an f32 model unchanged."""
    payload = load_checkpoint(path)
    return {"params": _promote(payload["params"]),
            "batch_stats": _promote(payload["batch_stats"]),
            "meta": payload.get("meta", {})}


def _promote(tree):
    if isinstance(tree, dict):
        return {k: _promote(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree
