"""Weights carried across: flax variable trees to torch ``state_dict``s.

The port's modules use the reference PyTorch model's attribute names, so a
``state_dict`` here has the reference's keys (``gnn_backbone.layers.0.
gin_conv.nn.0.weight``, ...). The map below is the inverse of the JAX
package's reference importer (``gnn_pretraining_tpu/utils/torch_import.py``):

  flax ``kernel`` [in,out]           -> ``weight`` [out,in] (transposed)
  flax BN ``scale``/``bias``         -> ``weight``/``bias``
  batch_stats ``mean``/``var``       -> ``running_mean``/``running_var``
  ``layers_{i}``                     -> ``layers.{i}``
  layer ``eps`` (scalar)             -> ``gin_conv.eps`` [1]
  ``mlp_0``/``mlp_bn``/``mlp_1``     -> ``gin_conv.nn.{0,1,3}``
  ``linear_{j}`` (MLPHead)           -> ``mlp.{3j}``
  ``input_encoders_{D}``             -> ``input_encoders.{D}``
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

_LAYER = re.compile(r"layers_(\d+)$")
_HEAD_LINEAR = re.compile(r"linear_(\d+)$")
_GIN_MLP = {"mlp_0": "gin_conv.nn.0", "mlp_bn": "gin_conv.nn.1",
            "mlp_1": "gin_conv.nn.3"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _module_key(name: str) -> str:
    m = _LAYER.match(name)
    if m:
        return f"layers.{m.group(1)}"
    m = _HEAD_LINEAR.match(name)
    if m:
        return f"mlp.{3 * int(m.group(1))}"
    if name.startswith("input_encoders_"):
        return "input_encoders." + name[len("input_encoders_"):]
    return _GIN_MLP.get(name, name)


def _leaf(collection: str, name: str, value: np.ndarray):
    value = np.asarray(value)
    if collection == "batch_stats":
        return _STAT_LEAF[name], value
    if name == "kernel":
        return "weight", value.T
    if name == "scale":
        return "weight", value
    if name == "eps":
        return "gin_conv.eps", value.reshape(1)
    return name, value


def variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (numpy leaves) -> state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(collection: str, tree: Dict[str, Any], prefix: List[str]) -> None:
        for name, value in tree.items():
            if isinstance(value, dict):
                walk(collection, value, prefix + [_module_key(name)])
            else:
                leaf, arr = _leaf(collection, name, value)
                out[".".join(prefix + [leaf])] = torch.tensor(arr)

    for collection in ("params", "batch_stats"):
        walk(collection, variables.get(collection, {}), [])
    return out


def load_pretrained_into_finetune(finetune_state: Dict[str, torch.Tensor],
                                  pretrain_state: Dict[str, torch.Tensor],
                                  domain_name: str) -> Dict[str, torch.Tensor]:
    """The transfer contract (reference finetune_model.py:128-146; JAX
    ``models/finetune_model.load_pretrained_into_finetune``): backbone
    params and BN stats always; ENZYMES also gets its pretrain encoder,
    ``input_encoders.ENZYMES.* -> input_encoder.*``."""
    merged = dict(finetune_state)
    enc = "input_encoders.ENZYMES."
    for key, value in pretrain_state.items():
        if key.startswith("gnn_backbone."):
            merged[key] = value
        elif domain_name == "ENZYMES" and key.startswith(enc):
            merged["input_encoder." + key[len(enc):]] = value
    return merged
