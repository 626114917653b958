"""The JAX package's checkpoint formats, in flax msgpack.

Trees are nested dicts of numpy arrays in the flax layout (``kernel``
[in, out], ``scale``, ``mean``/``var``); ``utils.convert`` carries them to and
from a torch ``state_dict``. Three kinds of file, each written through a temp
file and ``os.replace`` (a kill mid-write never leaves a truncated file in
place of a good one), each readable by the JAX package's loaders:

  * the best checkpoint, {params, batch_stats, meta: {epoch, val_metrics}};
  * the train state of ``pretrain --resume``, {params, batch_stats,
    opt_state, counters, extra} (JAX ``save_train_state``): ``opt_state`` in
    optax's layout (``convert.adamw_to_opt_state``); ``extra`` holds what
    only this package reads (its random streams), and the JAX package's
    ``load_train_state`` ignores it;
  * the fp16 transfer artifact: the backbone and the ENZYMES encoder only.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from gnn_pretraining_tpu_torch.utils._msgpack import packb, unpackb

TRAIN_STATE_KEYS = ("params", "batch_stats", "opt_state", "counters", "extra")
COUNTER_KEYS = ("opt_step", "balancer_step", "epoch", "best_total",
                "epochs_since_improvement")
TRANSFER_SUBTREES = ("gnn_backbone", "input_encoders_ENZYMES")


def _atomic_write(path, payload) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(packb(payload))
    os.replace(tmp, path)


def save_checkpoint(path, params, batch_stats, epoch: int,
                    val_metrics: Optional[Dict[str, float]] = None) -> None:
    """Write {params, batch_stats, meta: {epoch, val_metrics}}."""
    _atomic_write(path, {
        "params": params,
        "batch_stats": batch_stats,
        "meta": {
            "epoch": int(epoch),
            "val_metrics": {k: float(v) for k, v in (val_metrics or {}).items()},
        },
    })


def load_checkpoint(path) -> Dict[str, Any]:
    """The whole tree of a file of this module, as flax restores it."""
    return unpackb(Path(path).read_bytes())


def save_train_state(path, params, batch_stats, opt_state, counters: Dict[str, Any],
                     extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the in-run resume state (JAX ``save_train_state``): ``counters``
    has exactly ``COUNTER_KEYS``; ``best_total`` is written as a float, the
    others as ints."""
    if set(counters) != set(COUNTER_KEYS):
        raise ValueError(f"counters {sorted(counters)}, expected {sorted(COUNTER_KEYS)}")
    _atomic_write(path, {
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": opt_state,
        "counters": {k: float(counters[k]) if k == "best_total" else int(counters[k])
                     for k in COUNTER_KEYS},
        "extra": extra or {},
    })


def load_train_state(path) -> Dict[str, Any]:
    """A ``save_train_state`` file (this package's or the JAX package's);
    raises, naming the key, if a part or a counter is missing."""
    payload = load_checkpoint(path)
    for key in TRAIN_STATE_KEYS:
        if key not in payload:
            raise KeyError(f"{path}: no '{key}' in the train state")
    for key in COUNTER_KEYS:
        if key not in payload["counters"]:
            raise KeyError(f"{path}: no 'counters/{key}' in the train state")
    return payload


def save_transfer_artifact(path, params, batch_stats,
                           meta: Optional[Dict[str, Any]] = None) -> None:
    """Persist only the transfer contract's subtrees (``gnn_backbone`` and
    ``input_encoders_ENZYMES``), f32 leaves cast to f16 and the others kept,
    numbers in ``meta`` written as floats (JAX ``save_transfer_artifact``)."""
    def subtree(collection):
        return _cast16({k: collection[k] for k in TRANSFER_SUBTREES if k in collection})

    _atomic_write(path, {
        "params": subtree(params),
        "batch_stats": subtree(batch_stats),
        "meta": {k: (float(v) if isinstance(v, (int, float, np.floating))
                     and not isinstance(v, bool) else v)
                 for k, v in (meta or {}).items()},
    })


def load_transfer_artifact(path) -> Dict[str, Any]:
    """Load a ``save_transfer_artifact`` file, promoting fp16 back to f32 so
    the restored weights drop into an f32 model unchanged."""
    payload = load_checkpoint(path)
    return {"params": _promote(payload["params"]),
            "batch_stats": _promote(payload["batch_stats"]),
            "meta": payload.get("meta", {})}


def _cast16(tree):
    if isinstance(tree, dict):
        return {k: _cast16(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.astype(np.float16) if arr.dtype == np.float32 else arr


def _promote(tree):
    if isinstance(tree, dict):
        return {k: _promote(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree
