"""Padded, masked graph batches as torch tensors.

The port of ``gnn_pretraining_tpu/data/batch.py``: the same static-shape
layout (nodes of the batched graphs concatenated then zero-padded to
``n_pad``, edges to ``e_pad``, graph slots to ``g_pad``, validity masks
carrying the real sizes), read from the same on-disk ``GraphStore`` ``.npz``
files. ``GraphBatch`` is a plain dataclass of tensors with ``.to(device)``.

``build_batch`` runs the native builder (``csrc/batcher.cc``, the port's own
counterpart of the JAX package's ``native/batcher.cc``): host C++ with a
plain C interface, bound with ctypes, built with ``g++ -O2 -shared -fPIC``
at first use into ``build/torch_host/`` (under a temporary name, then
renamed into place, so processes that build at once do not collide). It
writes the batch into arrays allocated here, or into the caller's
(``build_batch_into``: a step's row of the chunked pretrain runner's input
buffer). ``build_batch_numpy`` is its plain version. A failed build raises:
nothing switches to numpy quietly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config

BATCHER_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "batcher.cc"
HOST_BUILD_DIR = config.REPO_ROOT / "build" / "torch_host"
BATCHER_LIB = "libgnn_batcher.so"


def pad_to(x: np.ndarray, size: int, axis: int = 0, value=0) -> np.ndarray:
    pad = size - x.shape[axis]
    if pad < 0:
        raise ValueError(f"cannot pad axis {axis} of {x.shape} to {size}")
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


def round_up(x: int, m: int = 8) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GraphBatch:
    """A padded multi-graph batch (all fields tensors, static shapes)."""

    x: torch.Tensor                 # [N, D] f32 node features
    senders: torch.Tensor           # [E] i32 global src node id (padding: 0)
    receivers: torch.Tensor         # [E] i32 global dst node id (padding: 0)
    edge_mask: torch.Tensor         # [E] f32 1.0 for real edges
    edge_graph: torch.Tensor        # [E] i32 graph id per edge (padding: 0)
    node_mask: torch.Tensor         # [N] f32 1.0 for real nodes
    node_graph: torch.Tensor        # [N] i32 graph id per node (padding: 0)
    graph_mask: torch.Tensor        # [G] f32 1.0 for real graphs
    node_start: torch.Tensor        # [G] i32 first global node id of each graph
    n_node: torch.Tensor            # [G] i32 valid node count per graph
    n_edge: torch.Tensor            # [G] i32 valid edge count per graph
    y: torch.Tensor                 # [G] i32 graph labels (0 where absent)
    graph_properties: torch.Tensor  # [G, P] f32 standardized targets

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def to(self, device) -> "GraphBatch":
        return GraphBatch(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass
class GraphStore:
    """Host-side ragged storage of one dataset (the JAX package's ``.npz``
    layout): node/edge arrays concatenated with offset tables."""

    name: str
    node_features: np.ndarray       # [sumN, D] f32
    edge_index: np.ndarray          # [2, sumE] i32 (per-graph-local ids)
    node_offsets: np.ndarray        # [G+1] i64
    edge_offsets: np.ndarray        # [G+1] i64
    y: np.ndarray                   # [G] graph labels (or [N] node labels)
    splits: Dict[str, np.ndarray]
    graph_properties: Optional[np.ndarray] = None  # [G, 12] f32
    node_y: Optional[np.ndarray] = None            # [sumN] node labels
    meta: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def num_graphs(self) -> int:
        return len(self.node_offsets) - 1

    def graph_num_edges(self, i: int) -> int:
        return int(self.edge_offsets[i + 1] - self.edge_offsets[i])

    @functools.cached_property
    def native_arrays(self) -> tuple:
        """The store's arrays in the native builder's types, contiguous:
        (node_features f32, edge_index i64, node_offsets i64, edge_offsets
        i64, y i64, graph_properties f32 or None), made once per store."""
        props = self.graph_properties
        return (np.ascontiguousarray(self.node_features, np.float32),
                np.ascontiguousarray(self.edge_index, np.int64),
                np.ascontiguousarray(self.node_offsets, np.int64),
                np.ascontiguousarray(self.edge_offsets, np.int64),
                np.ascontiguousarray(self.y, np.int64),
                None if props is None else np.ascontiguousarray(props, np.float32))

    def batch_shapes(self, n_pad: int, e_pad: int, g_pad: int) -> Dict[str, tuple]:
        """Each ``GraphBatch`` field's (shape, numpy dtype) at these pads."""
        d = self.node_features.shape[1]
        p = self.graph_properties.shape[1] if self.graph_properties is not None else 12
        f32, i32 = np.float32, np.int32
        return {"x": ((n_pad, d), f32), "senders": ((e_pad,), i32),
                "receivers": ((e_pad,), i32), "edge_mask": ((e_pad,), f32),
                "edge_graph": ((e_pad,), i32), "node_mask": ((n_pad,), f32),
                "node_graph": ((n_pad,), i32), "graph_mask": ((g_pad,), f32),
                "node_start": ((g_pad,), i32), "n_node": ((g_pad,), i32),
                "n_edge": ((g_pad,), i32), "y": ((g_pad,), i32),
                "graph_properties": ((g_pad, p), f32)}

    def save(self, path) -> None:
        """Write the ``.npz`` layout that ``load`` (here and in the JAX
        package) reads."""
        arrays = {
            "node_features": self.node_features,
            "edge_index": self.edge_index,
            "node_offsets": self.node_offsets,
            "edge_offsets": self.edge_offsets,
            "y": self.y,
        }
        if self.graph_properties is not None:
            arrays["graph_properties"] = self.graph_properties
        if self.node_y is not None:
            arrays["node_y"] = self.node_y
        for k, v in self.splits.items():
            arrays[f"split__{k}"] = v
        for k, v in self.meta.items():
            arrays[f"meta__{k}"] = np.array(str(v))
        np.savez_compressed(path, name=np.array(self.name), **arrays)

    @classmethod
    def load(cls, path) -> "GraphStore":
        z = np.load(path, allow_pickle=False)
        splits = {k[len("split__"):]: z[k] for k in z.files if k.startswith("split__")}
        meta = {k[len("meta__"):]: str(z[k]) for k in z.files
                if k.startswith("meta__")}
        return cls(
            meta=meta,
            name=str(z["name"]),
            node_features=z["node_features"],
            edge_index=z["edge_index"],
            node_offsets=z["node_offsets"],
            edge_offsets=z["edge_offsets"],
            y=z["y"],
            splits=splits,
            graph_properties=z["graph_properties"] if "graph_properties" in z.files else None,
            node_y=z["node_y"] if "node_y" in z.files else None,
        )


_batcher: Optional[ctypes.CDLL] = None
_batcher_lock = threading.Lock()


def build_batcher(build_dir: Path = HOST_BUILD_DIR) -> Path:
    """Compile ``csrc/batcher.cc`` into ``build_dir/libgnn_batcher.so``;
    raises with the compiler's output when it fails."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / BATCHER_LIB
    tmp = build_dir / f"{BATCHER_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-shared", "-fPIC", "-std=c++17",
           str(BATCHER_SOURCE), "-o", str(tmp)]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native batch builder failed: "
                           f"{' '.join(cmd)}\n{done.stdout}")
    os.replace(tmp, lib)
    return lib


def batcher() -> ctypes.CDLL:
    """The loaded native builder, built first where it is missing or older
    than its source."""
    global _batcher
    with _batcher_lock:
        if _batcher is None:
            lib = HOST_BUILD_DIR / BATCHER_LIB
            if not lib.is_file() or lib.stat().st_mtime < BATCHER_SOURCE.stat().st_mtime:
                build_batcher()
            handle = ctypes.CDLL(str(lib))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            handle.gnn_build_batch.argtypes = (
                [p, i64, p, i64, p, p, i64, p, i64, p, i64, p, i64, i64, i64, i64,
                 ctypes.c_int] + [p] * 13)
            handle.gnn_build_batch.restype = ctypes.c_int
            _batcher = handle
    return _batcher


FIELDS = ("x", "senders", "receivers", "edge_mask", "edge_graph", "node_mask",
          "node_graph", "graph_mask", "node_start", "n_node", "n_edge", "y",
          "graph_properties")


def build_batch_into(store: GraphStore, graph_indices: Sequence[int],
                     n_pad: int, e_pad: int, g_pad: int, with_properties: bool,
                     out: Dict[str, np.ndarray]) -> None:
    """The native builder: write the padded batch of the selected graphs
    into ``out`` (every field of ``GraphBatch``, contiguous numpy arrays of
    ``store.batch_shapes``' shapes and types), padding included. Raises
    ``ValueError`` as ``build_batch_numpy`` does where the graphs do not fit,
    ``IndexError`` on an index outside the store."""
    shapes = store.batch_shapes(n_pad, e_pad, g_pad)
    for name in FIELDS:
        a = out[name]
        shape, dtype = shapes[name]
        if a.shape != shape or a.dtype != dtype or not a.flags.c_contiguous:
            raise ValueError(f"out[{name!r}] must be a contiguous {np.dtype(dtype)} "
                             f"array of shape {shape}, got {a.dtype} {a.shape}")
    idx = np.ascontiguousarray(np.asarray(graph_indices, np.int64).reshape(-1))
    nf, ei, noff, eoff, y, props = store.native_arrays
    code = batcher().gnn_build_batch(
        nf.ctypes.data, nf.shape[1], ei.ctypes.data, ei.shape[1], noff.ctypes.data,
        eoff.ctypes.data, store.num_graphs, y.ctypes.data, y.shape[0],
        None if props is None else props.ctypes.data, shapes["graph_properties"][0][1],
        idx.ctypes.data, idx.shape[0], n_pad, e_pad, g_pad,
        int(bool(with_properties) and props is not None),
        *(out[name].ctypes.data for name in FIELDS))
    if code == 1:
        raise ValueError(f"{idx.shape[0]} graphs > g_pad={g_pad}")
    if code == 2:
        raise IndexError(f"a graph index of {idx.tolist()} is outside the store's "
                         f"{store.num_graphs} graphs")
    if code == 3:
        total_n = int(np.diff(noff)[idx].sum())
        total_e = int(np.diff(eoff)[idx].sum())
        raise ValueError(f"batch ({total_n} nodes, {total_e} edges) exceeds "
                         f"padding ({n_pad}, {e_pad})")
    if code != 0:
        raise RuntimeError(f"the native batch builder returned {code}")


def build_batch(store: GraphStore, graph_indices: Sequence[int],
                n_pad: int, e_pad: int, g_pad: int,
                with_properties: bool = False) -> GraphBatch:
    """Concatenate the selected graphs into one padded ``GraphBatch`` on the
    CPU with the native builder (``build_batch_into``): the arrays of
    ``build_batch_numpy``, its plain version."""
    out = {name: np.empty(shape, dtype) for name, (shape, dtype)
           in store.batch_shapes(n_pad, e_pad, g_pad).items()}
    build_batch_into(store, graph_indices, n_pad, e_pad, g_pad, with_properties, out)
    return GraphBatch(**{k: torch.from_numpy(v) for k, v in out.items()})


def build_batch_numpy(store: GraphStore, graph_indices: Sequence[int],
                      n_pad: int, e_pad: int, g_pad: int,
                      with_properties: bool = False) -> GraphBatch:
    """The plain version of ``build_batch`` (the JAX package's numpy path):
    local edge ids are relabelled to global ones, then every array is
    zero-padded."""
    g = len(graph_indices)
    if g > g_pad:
        raise ValueError(f"{g} graphs > g_pad={g_pad}")
    d = store.node_features.shape[1]
    p = store.graph_properties.shape[1] if store.graph_properties is not None else 12

    xs: List[np.ndarray] = [np.zeros((0, d), np.float32)]
    send: List[np.ndarray] = [np.zeros(0, np.int64)]
    recv: List[np.ndarray] = [np.zeros(0, np.int64)]
    edge_graph: List[np.ndarray] = [np.zeros(0, np.int32)]
    node_graph: List[np.ndarray] = [np.zeros(0, np.int32)]
    node_start = np.zeros(g_pad, np.int32)
    n_node = np.zeros(g_pad, np.int32)
    n_edge = np.zeros(g_pad, np.int32)
    y = np.zeros(g_pad, np.int32)
    props = np.zeros((g_pad, p), np.float32)

    cursor = 0
    for slot, gi in enumerate(graph_indices):
        n0, n1 = store.node_offsets[gi], store.node_offsets[gi + 1]
        e0, e1 = store.edge_offsets[gi], store.edge_offsets[gi + 1]
        nn, ne = int(n1 - n0), int(e1 - e0)
        xs.append(store.node_features[n0:n1])
        ei = store.edge_index[:, e0:e1].astype(np.int64)
        send.append(ei[0] + cursor)
        recv.append(ei[1] + cursor)
        edge_graph.append(np.full(ne, slot, np.int32))
        node_graph.append(np.full(nn, slot, np.int32))
        node_start[slot] = cursor
        n_node[slot] = nn
        n_edge[slot] = ne
        if store.y.shape[0] == store.num_graphs:
            y[slot] = store.y[gi]
        if with_properties and store.graph_properties is not None:
            props[slot] = store.graph_properties[gi]
        cursor += nn

    total_n = cursor
    total_e = int(sum(a.shape[0] for a in send))
    if total_n > n_pad or total_e > e_pad:
        raise ValueError(f"batch ({total_n} nodes, {total_e} edges) exceeds "
                         f"padding ({n_pad}, {e_pad})")

    arrays = dict(
        x=pad_to(np.concatenate(xs, 0).astype(np.float32), n_pad),
        senders=pad_to(np.concatenate(send).astype(np.int32), e_pad),
        receivers=pad_to(np.concatenate(recv).astype(np.int32), e_pad),
        edge_mask=pad_to(np.ones(total_e, np.float32), e_pad),
        edge_graph=pad_to(np.concatenate(edge_graph), e_pad),
        node_mask=pad_to(np.ones(total_n, np.float32), n_pad),
        node_graph=pad_to(np.concatenate(node_graph), n_pad),
        graph_mask=pad_to(np.ones(g, np.float32), g_pad),
        node_start=node_start, n_node=n_node, n_edge=n_edge, y=y,
        graph_properties=props)
    return GraphBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in arrays.items()})
