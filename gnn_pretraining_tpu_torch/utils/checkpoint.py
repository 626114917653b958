"""The JAX package's checkpoint format: flax msgpack of {params, batch_stats, meta}.

Trees are nested dicts of numpy arrays in the flax layout (``kernel``
[in, out], ``scale``, ``mean``/``var``); ``utils.convert`` carries them to and
from a torch ``state_dict``. ``save_checkpoint`` writes a file that the JAX
package's ``load_checkpoint`` restores. The fp16 transfer artifact has a read
side only so far.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from gnn_pretraining_tpu_torch.utils._msgpack import packb, unpackb


def save_checkpoint(path, params, batch_stats, epoch: int,
                    val_metrics: Optional[Dict[str, float]] = None) -> None:
    """Write {params, batch_stats, meta: {epoch, val_metrics}}.

    The write goes through a temp file and ``os.replace``, so a kill mid-write
    never leaves a truncated checkpoint in place of a good one."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "params": params,
        "batch_stats": batch_stats,
        "meta": {
            "epoch": int(epoch),
            "val_metrics": {k: float(v) for k, v in (val_metrics or {}).items()},
        },
    }
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(packb(payload))
    os.replace(tmp, path)


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
