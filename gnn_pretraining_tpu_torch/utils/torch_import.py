"""Reference PyTorch checkpoints in and out of the port's models.

Port of ``gnn_pretraining_tpu/utils/torch_import.py``. The reference saves
``{epoch, model_state_dict, val_metrics}`` with ``torch.save``
(src/pretrain/pretrain.py:263-275, src/finetune/finetune.py:274-283) and its
transfer loader copies ``gnn_backbone.*`` (plus ``input_encoders.ENZYMES.* ->
input_encoder.*`` for ENZYMES) into the fine-tune model
(src/models/finetune_model.py:128-146).

``read_torch_checkpoint`` parses the torch zip format directly (data.pkl plus
raw little-endian storages) with a restricted unpickler, numpy only. It is the
one read path, for whole files and truncated ones alike: the one artifact the
reference ships (outputs/finetune/model_Cora_NC_linear_probe_b2_42.pt) is cut
off mid-storage, and ``torch.load`` rejects it. A tensor whose storage bytes
were lost, whose storage dtype it does not know (bf16, quantised) or which is
a non-contiguous view is reported in ``missing``, never made up.

The port's modules carry the reference's attribute names, so the key map
(``reference_to_port``) is the identity but for two things: the
reference's ``heads`` ModuleDict (``heads.{task}[.{domain}]``) is one
attribute per task here (``heads_{task}[.{domain}]``), and BatchNorm's
``num_batches_tracked`` has no counterpart (``MaskedBatchNorm`` keeps no
counter). ``port_to_reference`` is the way back, for writing a reference-
format file from a port model.
"""

from __future__ import annotations

import collections
import io
import pickle
import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from gnn_pretraining_tpu_torch.utils.convert import load_pretrained_into_finetune

_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "BoolStorage": np.bool_,
}
_TRACKED = "num_batches_tracked"


def _read_zip_entries(path: Path) -> Dict[str, bytes]:
    """Stream the local file headers of a (possibly truncated) zip archive.

    torch's zip writer stores entries uncompressed with data descriptors
    (sizes live *after* the payload), so entries remain recoverable even when
    the central directory is missing.
    """
    buf = Path(path).read_bytes()
    entries: Dict[str, bytes] = {}
    off = 0
    while off + 30 <= len(buf) and buf[off:off + 4] == b"PK\x03\x04":
        (_, _, flags, comp, _, _, _, csize, usize, nlen, elen
         ) = struct.unpack("<IHHHHHIIIHH", buf[off:off + 30])
        name = buf[off + 30:off + 30 + nlen].decode()
        data_start = off + 30 + nlen + elen
        if comp != 0:
            raise ValueError(f"unsupported compression in {name}")
        if flags & 0x08:  # sizes deferred to the data descriptor
            # The descriptor signature can occur by chance inside a large
            # binary storage; only accept a candidate whose recorded csize
            # matches the bytes actually spanned (descriptor layout:
            # sig(4) crc(4) csize(4) usize(4)).
            dd = buf.find(b"PK\x07\x08", data_start)
            while dd != -1 and dd + 16 <= len(buf):
                (csz,) = struct.unpack("<I", buf[dd + 8:dd + 12])
                if csz == dd - data_start:
                    break
                dd = buf.find(b"PK\x07\x08", dd + 1)
            if dd == -1 or dd + 16 > len(buf):
                # truncated inside this entry: keep what's there
                entries[name] = buf[data_start:]
                break
            entries[name] = buf[data_start:dd]
            off = dd + 16
        else:
            entries[name] = buf[data_start:data_start + usize]
            off = data_start + usize
    return entries


class _TensorRef:
    """Deferred tensor: storage key + layout, materialized against entries."""

    def __init__(self, storage_type: str, storage_key: str, numel: int,
                 offset: int, size: Tuple[int, ...], stride: Tuple[int, ...]):
        self.storage_type = storage_type
        self.storage_key = storage_key
        self.numel = numel
        self.offset = offset
        self.size = tuple(size)
        self.stride = tuple(stride)


class _StorageMarker:
    def __init__(self, name: str):
        self.name = name


class _RestrictedUnpickler(pickle.Unpickler):
    """Understands exactly the pieces a torch state-dict pickle uses."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        if name.endswith("Storage"):
            return _StorageMarker(name)
        if name == "_rebuild_tensor_v2":
            def rebuild(storage, storage_offset, size, stride, *_ignored):
                st, key, numel = storage
                return _TensorRef(st, key, numel, storage_offset, size, stride)
            return rebuild
        # Anything else (device tags, rebuild hooks) degrades to an inert stub.
        return lambda *a, **k: None

    def persistent_load(self, pid):
        # ('storage', StorageType, key, location, numel)
        tag, storage_type, key, _location, numel = pid
        if tag != "storage":
            raise ValueError(f"unknown persistent id {tag!r}")
        name = (storage_type.name if isinstance(storage_type, _StorageMarker)
                else str(storage_type))
        return (name, str(key), int(numel))


def read_torch_checkpoint(path) -> Dict[str, Any]:
    """Parse a torch-format checkpoint into numpy arrays.

    Returns ``{"state_dict": {key: np.ndarray}, "missing": [key...],
    "epoch": ..., "val_metrics": ...}``; ``missing`` lists the tensors that
    could not be read (storage bytes lost to truncation, an unknown storage
    dtype, a non-contiguous view).
    """
    entries = _read_zip_entries(path)
    pkl_name = next((n for n in entries if n.endswith("/data.pkl")), None)
    if pkl_name is None:
        raise ValueError(f"{path}: no data.pkl entry (archive truncated "
                         f"before the pickle?); entries: {sorted(entries)}")
    prefix = pkl_name[:-len("data.pkl")]
    obj = _RestrictedUnpickler(io.BytesIO(entries[pkl_name])).load()

    sd_raw = obj.get("model_state_dict", obj) if isinstance(obj, dict) else obj
    state, missing = {}, []
    for key, ref in sd_raw.items():
        if not isinstance(ref, _TensorRef):
            continue
        dtype = _STORAGE_DTYPES.get(ref.storage_type)
        if dtype is None:
            # Reinterpreting unknown storage bytes (bf16, quantized, ...)
            # as f32 would load numeric garbage; report instead.
            missing.append(key)
            continue
        contiguous = []
        acc = 1
        for s in reversed(ref.size):
            contiguous.append(acc)
            acc *= s
        if ref.size and ref.stride != tuple(reversed(contiguous)):
            # torch.save preserves storage+stride; a non-contiguous view
            # cannot be materialized by a flat reshape.
            missing.append(key)
            continue
        raw = entries.get(f"{prefix}data/{ref.storage_key}")
        itemsize = dtype().nbytes
        need = (ref.offset + int(np.prod(ref.size or (1,)))) * itemsize
        if raw is None or len(raw) < need:
            missing.append(key)
            continue
        # A truncated tail may not be an itemsize multiple; trim before view.
        flat = np.frombuffer(raw, dtype=dtype, count=len(raw) // itemsize)
        n = int(np.prod(ref.size)) if ref.size else 1
        arr = flat[ref.offset:ref.offset + n]
        state[key] = (arr.reshape(ref.size) if ref.size else arr[0]).copy()

    out = {"state_dict": state, "missing": missing}
    if isinstance(obj, dict):
        out["epoch"] = obj.get("epoch")
        out["val_metrics"] = obj.get("val_metrics")
    return out


def _port_key(key: str) -> str:
    parts = key.split(".")
    if parts[0] == "heads" and len(parts) > 2:
        return ".".join([f"heads_{parts[1]}"] + parts[2:])
    return key


def reference_to_port(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` (numpy or torch values) under the port's
    keys, as tensors of the reference's dtypes; ``num_batches_tracked``
    dropped."""
    return {_port_key(k): torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()
            if k.rsplit(".", 1)[-1] != _TRACKED}


def port_to_reference(state_dict: Dict[str, torch.Tensor],
                      batches_tracked: int = 0) -> Dict[str, torch.Tensor]:
    """The inverse of ``reference_to_port``: the reference's keys, with an
    int64 ``num_batches_tracked`` after every BatchNorm's ``running_var``,
    as ``torch.nn.BatchNorm1d`` writes it."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith("heads_"):
            head, rest = key.split(".", 1)
            key = f"heads.{head[len('heads_'):]}.{rest}"
        out[key] = value
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + _TRACKED] = torch.tensor(batches_tracked)
    return out


def _load_into(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy ``state`` into ``model`` in place, cast to each leaf's dtype on
    its device. Checks every entry before it copies any: a key the model
    lacks raises ``KeyError``, a shape that differs ``ValueError`` (JAX
    ``_deep_update``)."""
    current = model.state_dict()
    for key, value in state.items():
        if key not in current:
            raise KeyError(f"imported key {key} has no counterpart in the model")
        if tuple(value.shape) != tuple(current[key].shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(current[key].shape)} "
                             f"vs {tuple(value.shape)}")
    with torch.no_grad():
        for key, value in state.items():
            current[key].copy_(value)


def load_torch_pretrained_into_finetune(model: torch.nn.Module, path,
                                        domain_name: str) -> torch.nn.Module:
    """Apply the reference transfer contract from a ``.pt`` file to a port
    ``FinetuneGNN``, in place: ``gnn_backbone.*`` always; for ENZYMES also
    ``input_encoders.ENZYMES.* -> input_encoder.*``
    (``convert.load_pretrained_into_finetune``). Entries lost to truncation
    keep the model's current values."""
    state = reference_to_port(read_torch_checkpoint(path)["state_dict"])
    _load_into(model, load_pretrained_into_finetune({}, state, domain_name))
    return model


def load_torch_finetune_checkpoint(model: torch.nn.Module, path
                                   ) -> Tuple[torch.nn.Module, List[str]]:
    """Load a reference *fine-tune* checkpoint (encoder + backbone + head)
    into a matching port ``FinetuneGNN``, in place. Returns (model,
    missing keys); a missing entry keeps the model's current value."""
    ckpt = read_torch_checkpoint(path)
    _load_into(model, reference_to_port(ckpt["state_dict"]))
    return model, ckpt["missing"]
