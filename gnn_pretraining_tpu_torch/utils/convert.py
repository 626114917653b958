"""Weights carried across: flax variable trees to torch ``state_dict``s and back.

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
  ``heads_{task}_{D}`` (per domain)  -> ``heads_{task}.{D}``
  ``heads_link_pred/predictor/linear_{j}``   -> ``heads_link_pred.predictor.mlp.{3j}``
  ``heads_domain_adv/classifier/linear_{j}`` -> ``heads_domain_adv.classifier.mlp.{3j}``

``state_dict_to_variables`` is the inverse (a linear ``weight`` is told from
a BatchNorm one by its rank).
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
# Per-domain pretraining heads of the JAX tree (``heads_<task>_<domain>``).
_DOMAIN_HEADS = tuple(f"heads_{t}" for t in
                      ("node_feat_mask", "node_contrast", "graph_contrast", "graph_prop"))


def _module_key(name: str) -> str:
    m = _LAYER.match(name)
    if m:
        return f"layers.{m.group(1)}"
    m = _HEAD_LINEAR.match(name)
    if m:
        return f"mlp.{3 * int(m.group(1))}"
    if name.startswith("input_encoders_"):
        return "input_encoders." + name[len("input_encoders_"):]
    for head in _DOMAIN_HEADS:
        if name.startswith(head + "_"):
            return f"{head}.{name[len(head) + 1:]}"
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


def _flax_path(key: str):
    """A state_dict key -> (collection, flax path, leaf name)."""
    parts = key.split(".")
    leaf = parts.pop()
    path: List[str] = []
    i = 0
    while i < len(parts):
        part = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if part == "layers" and nxt is not None:
            path.append(f"layers_{nxt}")
            i += 2
        elif part == "mlp" and nxt is not None:
            path.append(f"linear_{int(nxt) // 3}")
            i += 2
        elif (part == "input_encoders" or part in _DOMAIN_HEADS) and nxt is not None:
            path.append(f"{part}_{nxt}")
            i += 2
        elif part == "gin_conv":
            if leaf == "eps" and nxt is None:
                i += 1
            else:                           # gin_conv.nn.{0,1,3}
                path.append({"0": "mlp_0", "1": "mlp_bn", "3": "mlp_1"}[parts[i + 2]])
                i += 3
        else:
            path.append(part)
            i += 1
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", path, {"running_mean": "mean", "running_var": "var"}[leaf]
    return "params", path, leaf


def _to_flax(key: str, tensor: torch.Tensor):
    """A state_dict entry -> (collection, flax path, leaf name, numpy array)."""
    collection, path, leaf = _flax_path(key)
    arr = tensor.detach().cpu().numpy()
    if collection == "params":
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        elif leaf == "eps":
            arr = arr.reshape(())
    return collection, path, leaf, np.array(arr)   # a C-ordered copy; keeps rank 0


def _put(tree: Dict[str, Any], path: List[str], leaf: str, value) -> None:
    for name in path:
        tree = tree.setdefault(name, {})
    tree[leaf] = value


def state_dict_to_variables(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A port ``state_dict`` -> ``{"params": ..., "batch_stats": ...}`` of
    numpy leaves in the flax layout; inverse of ``variables_to_state_dict``."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, tensor in state.items():
        collection, path, leaf, arr = _to_flax(key, tensor)
        _put(out[collection], path, leaf, arr)
    return out


# torch's AdamW keeps a ``step`` and two moments per parameter; optax keeps,
# per label, what flax's ``to_state_dict`` writes of ``optax.multi_transform``
# over ``optax.adamw`` (JAX ``pretrain/optimizers.py:36-46``):
#
#   inner_states/<label>/inner_state/"0"/{count, mu, nu}, "1": {}, "2": {}
#
# one label per transform (``default``, then each active task, whether or
# not a parameter carries it); ``count`` a 0-d int32; ``mu`` and ``nu`` the
# whole params tree in the flax layout with each leaf of another label
# written as {} (optax's ``MaskedNode``); "1" and "2" the empty states of the
# weight decay and the learning-rate scaling. Keys are sorted, as jax's tree
# functions leave them.


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def adamw_to_opt_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       labels: Dict[str, str], label_order: List[str]) -> Dict[str, Any]:
    """The optax state that matches ``optimizer``'s (``labels``: parameter
    name -> label; ``label_order``: the transforms' labels in order). Every
    parameter must have taken as many steps as every other (the train step
    hands each one a gradient), or none."""
    named = list(model.named_parameters())
    states = [optimizer.state.get(p) for _, p in named]
    steps = {int(s["step"]) for s in states if s}
    if len(steps) > 1 or (steps and not all(states)):
        raise ValueError(f"AdamW steps differ across parameters: {sorted(steps)}")
    count = np.array(steps.pop() if steps else 0, np.int32)
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        moments[key] = {name: (s[key] if s else torch.zeros_like(p))
                        for (name, p), s in zip(named, states)}
    inner = {}
    for label in label_order:
        adam = {"count": count, "mu": {}, "nu": {}}
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for name, tensor in moments[key].items():
                _, path, leaf, arr = _to_flax(name, tensor)
                _put(adam[slot], path, leaf, arr if labels[name] == label else {})
        inner[label] = {"inner_state": {"0": _sorted_tree(adam), "1": {}, "2": {}}}
    return {"inner_states": inner}


def load_adamw_state(opt_state: Dict[str, Any], model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, labels: Dict[str, str],
                     label_order: List[str]) -> None:
    """Set ``optimizer``'s state from an optax state in the layout above
    (``adamw_to_opt_state``'s, or the JAX package's). A count of 0 leaves a
    parameter's state empty, as a fresh AdamW has it. Raises, naming the key,
    on labels, parameters or shapes that do not match the model."""
    inner_states = opt_state["inner_states"]
    if set(inner_states) != set(label_order):
        raise ValueError(f"opt_state labels {sorted(inner_states)} do not match the "
                         f"optimizer's {sorted(label_order)}")
    params = dict(model.named_parameters())
    for label in label_order:
        where = f"opt_state/inner_states/{label}/inner_state"
        inner = inner_states[label]["inner_state"]
        if set(inner) != {"0", "1", "2"} or inner["1"] or inner["2"]:
            raise ValueError(f"{where}: expected adam's state and two empty states, "
                             f"got keys {sorted(inner)}")
        count = int(inner["0"]["count"])
        members = {n for n in params if labels[n] == label}
        moments = {}
        for slot in ("mu", "nu"):
            got = variables_to_state_dict({"params": inner["0"][slot]})
            if set(got) != members:
                raise ValueError(f"{where}/0/{slot}: missing {sorted(members - set(got))}, "
                                 f"unexpected {sorted(set(got) - members)}")
            for name, tensor in got.items():
                if tensor.shape != params[name].shape:
                    raise ValueError(f"{where}/0/{slot}: {name} has shape "
                                     f"{tuple(tensor.shape)}, the model "
                                     f"{tuple(params[name].shape)}")
            moments[slot] = got
        for name in sorted(members):
            p = params[name]
            if count == 0:
                optimizer.state.pop(p, None)
                continue
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moments["mu"][name].to(device=p.device, dtype=p.dtype),
                "exp_avg_sq": moments["nu"][name].to(device=p.device, dtype=p.dtype)}


def load_variables(model: torch.nn.Module, variables: Dict[str, Any]) -> torch.nn.Module:
    """Load a flax ``{"params", "batch_stats"}`` pair into a port module (on
    the module's device); the tests carry weights across with it."""
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device)
                           for k, v in variables_to_state_dict(variables).items()})
    return model


def model_variables(model: torch.nn.Module) -> Dict[str, Any]:
    """The way back: a port module's weights and BN statistics as flax trees."""
    return state_dict_to_variables(model.state_dict())


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
