"""Serving: eval-mode inference functions over a fine-tune model, and
self-contained serving artifacts of them.

Port of ``gnn_pretraining_tpu/serving.py``. The functions take the same
positional inputs as the JAX ones (padded static-shape tensors) and return
the same outputs:

  * graph_classification: (x, node_mask, senders, receivers, edge_mask,
    node_graph) -> [num_graphs, C] logits
  * node_classification:  (x, node_mask, senders, receivers, edge_mask)
    -> [N, C] logits
  * link_prediction:      (x, node_mask, senders, receivers, edge_mask,
    score_senders, score_receivers) -> [S] probabilities
  * embedding:            (x, node_mask, senders, receivers, edge_mask)
    -> [N, 256] node embeddings

Each call builds the dense adjacency once (bf16 for kernel K1, as the JAX
fine-tune eval step builds it) and passes it to every GIN layer, so the
``pallas`` aggregation always runs on the kernel.

``export_serving`` is the counterpart of the JAX package's StableHLO export:
it bakes the weights into a ``torch.export`` program of the same function,
fixed to one padding bucket, one program per device type (``cuda``,
``cpu``), so that ``load_serving`` replays it without the model code. As in
the JAX package only the ``dense`` and ``coo`` aggregations export: an
artifact computes the aggregation with the plain dense product or the
scatter, never with a hand kernel.
"""

from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.utils.checkpoint import load_transfer_artifact
from gnn_pretraining_tpu_torch.utils.convert import (
    load_pretrained_into_finetune,
    variables_to_state_dict,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device

GRAPH = ("x", "node_mask", "senders", "receivers", "edge_mask")
EXTRA_INPUTS = {"graph_classification": ("node_graph",),
                "node_classification": (),
                "link_prediction": ("score_senders", "score_receivers")}
EXPORT_PLATFORMS = ("cuda", "cpu")
ARTIFACT_MAGIC = b"GNNTORCHSERVE\x01"


def _graph_kwargs(model: FinetuneGNN, x, senders, receivers, edge_mask) -> dict:
    kwargs = dict(senders=senders, receivers=receivers, edge_mask=edge_mask)
    if model.aggregation in ("pallas", "dense"):
        dtype = torch.bfloat16 if model.aggregation == "pallas" else torch.float32
        kwargs["adj"] = build_dense_adjacency(senders, receivers, edge_mask,
                                              x.shape[0], dtype=dtype)
    return kwargs


class ServingModule(nn.Module):
    """``model``'s eval-mode serving function (or, with ``embed_only``, its
    embedding function) over the positional inputs of ``self.names``. The
    padded graph count of graph classification fixes an output shape, so it
    is bound here."""

    def __init__(self, model: FinetuneGNN, embed_only: bool = False,
                 num_graphs: int | None = None):
        super().__init__()
        self.model = model.eval()
        self.kind = "embed" if embed_only else model.task_type
        if self.kind == "graph_classification" and num_graphs is None:
            raise ValueError("graph classification serving needs num_graphs")
        self.num_graphs = num_graphs
        self.names = GRAPH + EXTRA_INPUTS.get(self.kind, ())

    def forward(self, x, node_mask, senders, receivers, edge_mask, *extra):
        kw = _graph_kwargs(self.model, x, senders, receivers, edge_mask)
        if self.kind == "embed":
            return self.model.embed(x, node_mask, **kw)
        if self.kind == "graph_classification":
            return self.model(x, node_mask, node_graph=extra[0],
                              num_graphs=self.num_graphs, **kw)
        if self.kind == "node_classification":
            return self.model(x, node_mask, **kw)
        return self.model(x, node_mask, score_senders=extra[0],
                          score_receivers=extra[1], **kw)


def _inference(module: nn.Module) -> Callable:
    @torch.inference_mode()
    def fn(*inputs):
        return module(*inputs)
    return fn


def make_serving_fn(model: FinetuneGNN) -> Tuple[Callable, Tuple[str, ...]]:
    """Eval-mode inference function over ``model``'s weights + its positional
    input names. For graph classification the first element is a factory
    ``make(num_graphs) -> fn`` (the padded graph count fixes an output shape),
    as in the JAX package."""
    names = GRAPH + EXTRA_INPUTS[model.task_type]
    if model.task_type == "graph_classification":
        return (lambda num_graphs: _inference(ServingModule(model, num_graphs=num_graphs)),
                names)
    return _inference(ServingModule(model)), names


def make_embedding_fn(model: FinetuneGNN) -> Tuple[Callable, Tuple[str, ...]]:
    """Representation serving: encoder + backbone → [N, 256] embeddings."""
    return _inference(ServingModule(model, embed_only=True)), GRAPH


def load_serving_model(domain: str, transfer_artifact, device=None,
                       seed: int = 0) -> FinetuneGNN:
    """A ``FinetuneGNN`` for ``domain`` in eval mode on ``device`` (the card
    unless ``device="cpu"``): encoder and head from a seeded init, then the
    backbone (and for ENZYMES the encoder) from a JAX transfer artifact
    (``artifacts/transfer/backbone_<scheme>_<seed>.msgpack``)."""
    device = resolve_device(device)
    model = FinetuneGNN(domain, "pallas",
                        generator=torch.Generator().manual_seed(seed),
                        device=device)
    art = load_transfer_artifact(Path(transfer_artifact))
    merged = load_pretrained_into_finetune(
        model.state_dict(), variables_to_state_dict(art), domain)
    model.load_state_dict(merged)
    return model.eval()


# ---------------------------------------------------------------------------
# Serving artifacts
# ---------------------------------------------------------------------------


def _model_on(model: FinetuneGNN, device: torch.device) -> FinetuneGNN:
    """``model`` itself if it lives on ``device``'s type, else a copy there."""
    if next(model.parameters()).device.type == device.type:
        return model
    twin = FinetuneGNN(model.domain_name, model.aggregation, device=device)
    twin.load_state_dict(model.state_dict())
    return twin


def export_serving(model: FinetuneGNN, example: Dict[str, object],
                   platforms: Sequence[str] = EXPORT_PLATFORMS,
                   embed_only: bool = False) -> bytes:
    """Serialize an inference artifact for ``example``'s padded shapes.

    ``example`` maps the input names (module docstring) to arrays or tensors;
    for graph classification it also carries ``num_graphs``, the padded graph
    count of the bucket. The artifact holds one ``torch.export`` program per
    entry of ``platforms`` (``cuda``, ``cpu``), each exported on that device
    with the weights baked in. Exporting for ``cuda`` needs the card and
    raises without one."""
    if model.aggregation not in ("dense", "coo"):
        raise ValueError(
            f"aggregation={model.aggregation!r} is not exportable; build the "
            "serving model with 'dense' or 'coo' aggregation")
    unknown = [p for p in platforms if p not in EXPORT_PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms {list(platforms)}: expected some of {EXPORT_PLATFORMS}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("exporting for 'cuda' needs a CUDA device; pass "
                           "platforms=('cpu',) to export for the CPU alone")
    num_graphs = None
    if model.task_type == "graph_classification" and not embed_only:
        num_graphs = int(example["num_graphs"])
    names = GRAPH + (() if embed_only else EXTRA_INPUTS[model.task_type])
    programs = {}
    for platform in platforms:
        device = torch.device(platform)
        module = ServingModule(_model_on(model, device), embed_only, num_graphs)
        args = tuple(torch.as_tensor(example[n]).to(device) for n in names)
        with torch.no_grad():
            program = torch.export.export(module, args)
        program.example_inputs = None      # the header keeps their shapes
        buf = io.BytesIO()
        torch.export.save(program, buf)
        programs[platform] = buf.getvalue()
    header = {"domain": model.domain_name, "aggregation": model.aggregation,
              "embed_only": bool(embed_only), "num_graphs": num_graphs,
              "inputs": [[n, list(a.shape), str(a.dtype)] for n, a in zip(names, args)],
              "programs": {p: len(b) for p, b in programs.items()}}
    head = json.dumps(header).encode()
    return b"".join([ARTIFACT_MAGIC, len(head).to_bytes(8, "little"), head,
                     *programs.values()])


def read_artifact(blob: bytes) -> Tuple[dict, Dict[str, bytes]]:
    """An artifact's header and its programs' bytes by device type."""
    if not blob.startswith(ARTIFACT_MAGIC):
        raise ValueError("not a serving artifact of this package")
    at = len(ARTIFACT_MAGIC)
    size = int.from_bytes(blob[at:at + 8], "little")
    header = json.loads(blob[at + 8:at + 8 + size])
    at += 8 + size
    programs = {}
    for platform, nbytes in header["programs"].items():
        programs[platform] = blob[at:at + nbytes]
        at += nbytes
    if at != len(blob):
        raise ValueError(f"artifact is {len(blob)} bytes, its header accounts for {at}")
    return header, programs


def load_serving(blob: bytes, device=None) -> Callable:
    """The artifact's program for ``device`` (the card unless
    ``device="cpu"``) as an inference function of the positional inputs
    named in its header. Raises when the artifact holds no program for that
    device type."""
    device = resolve_device(device)
    header, programs = read_artifact(blob)
    if device.type not in programs:
        raise ValueError(f"the artifact holds no program for {device.type!r}, "
                         f"only for {sorted(programs)}")
    fn = _inference(torch.export.load(io.BytesIO(programs[device.type])).module())
    fn.header = header
    return fn


def save_artifact(path, blob: bytes) -> None:
    """Write ``blob`` through a temp file and ``os.replace``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(blob)
    os.replace(tmp, path)


def load_artifact(path, device=None) -> Callable:
    return load_serving(Path(path).read_bytes(), device)
