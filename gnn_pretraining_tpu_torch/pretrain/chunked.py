"""The chunked pretrain runner: a step's inputs as one row of words, the host
prefetch thread, and the train step captured in a CUDA graph and replayed.

Port of the JAX package's chunked single-device path
(``gnn_pretraining_tpu/pretrain/pretrain.py``: ``make_chunked_train_step``
:268-325, ``stack_batches`` :328, ``aot_compile_chunks`` :333-354,
``prefetched`` :587-629, ``chunk_gen`` :651-662, ``_put_chunk`` :664-668).
On the TPU a chunk of steps ran inside one ``lax.scan`` program; here one
train step is captured once in a CUDA graph and replayed for each step of a
chunk:

  * ``StepLayout``: where each field of each domain's padded batch, and
    PCGrad's task order, lie in one step's row of 32-bit words (every field
    64-byte aligned). The pads are fixed per domain per loader, so one
    layout, and one graph, serves a run;
  * ``chunk_batches`` samples a chunk's graphs (the sampler's numpy
    generator), builds each batch with the native builder straight into the
    chunk's [chunk, words] int32 host buffer (pinned for the card) and
    writes each step's PCGrad order, drawn in step order from the run's
    PCGrad generator; each step's real edge count stays on the host;
    ``stack_batches`` packs given batches the same way;
  * ``prefetched`` runs such a generator in a producer thread, ``depth``
    items ahead, and hands each item to ``put`` (the copy to the card) on
    the consumer's thread; a producer exception is raised in the consumer;
    ``GNN_NO_PREFETCH`` turns the thread off;
  * ``ChunkRunner`` copies each step's row into the graph's input buffer and
    replays the graph; the step's metrics land in a packed [M, chunk]
    tensor, rows in sorted name order. On the CPU it runs the same step
    body eagerly on the same buffer.

The capture (``ChunkRunner.capture``) snapshots the model's parameters and
buffers, the optimizer's state and the graph's generators, runs one warm-up
step on a side stream (it initialises AdamW's state, loads the kernels and
the libraries' workspaces), restores the snapshot, and captures one step on
that stream with the dropout, view and task-draw generators registered with
the graph, so a replay draws what an eager step draws and advances the
generators' offsets as it would. The wrappers' ``.launches`` counters move
at the warm-up and the capture, not on replay: ``capture_launches`` holds
each kernel's launches per step, counted at capture, and ``replays`` the
steps replayed. A failed capture or replay raises.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from gnn_pretraining_tpu_torch.data.batch import FIELDS, GraphBatch, build_batch_into

ALIGN_WORDS = 16             # 64 bytes: every field of a row starts at a multiple
CAPTURE_WARMUP_STEPS = 1     # eager steps on the capture stream before capturing


def _aligned(n: int) -> int:
    return -(-n // ALIGN_WORDS) * ALIGN_WORDS


class StepLayout:
    """One step's inputs as a row of int32 words: for each domain (sorted)
    each ``GraphBatch`` field (f32 fields bit-cast), then PCGrad's order of
    the ``perm_len`` sorted main tasks (none with fewer than two).
    ``shapes``: domain -> field -> (shape, numpy dtype)."""

    def __init__(self, shapes: Dict[str, Dict[str, tuple]], perm_len: int):
        self.entries = []                    # (domain, field, offset, shape, dtype)
        offset = 0
        for d in sorted(shapes):
            for name in FIELDS:
                shape, dtype = shapes[d][name]
                dtype = np.dtype(dtype)
                if dtype.itemsize != 4:
                    raise ValueError(f"{d}.{name}: a row holds 32-bit fields, got {dtype}")
                self.entries.append((d, name, offset, tuple(shape), dtype))
                offset += _aligned(math.prod(shape))
        self.perm_len = perm_len if perm_len > 1 else 0
        self.perm_offset = offset
        self.words = max(offset + _aligned(self.perm_len), 1)

    @classmethod
    def of_loader(cls, loader, perm_len: int) -> "StepLayout":
        """The layout of a ``BalancedMultiDomainSampler``'s steps."""
        return cls({d: store.batch_shapes(*loader.pads[d], loader.samples_per_domain)
                    for d, store in loader.domain_stores.items()}, perm_len)

    def _key(self):
        return (tuple((d, n, o, s, str(t)) for d, n, o, s, t in self.entries),
                self.perm_len, self.words)

    def __eq__(self, other) -> bool:
        return isinstance(other, StepLayout) and self._key() == other._key()

    def np_views(self, row: np.ndarray) -> Dict[str, Dict[str, np.ndarray]]:
        """domain -> field -> a writable view into ``row`` (an int32 numpy row)."""
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for d, name, offset, shape, dtype in self.entries:
            n = math.prod(shape)
            out.setdefault(d, {})[name] = row[offset:offset + n].view(dtype).reshape(shape)
        return out

    def views(self, row: torch.Tensor):
        """(domain -> ``GraphBatch`` of views into ``row``, PCGrad's order as an
        int32 view or None) for an int32 tensor row."""
        torch_dtype = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}
        fields: Dict[str, Dict[str, torch.Tensor]] = {}
        for d, name, offset, shape, dtype in self.entries:
            n = math.prod(shape)
            fields.setdefault(d, {})[name] = (
                row[offset:offset + n].view(torch_dtype[dtype]).view(shape))
        perm = (row[self.perm_offset:self.perm_offset + self.perm_len]
                if self.perm_len else None)
        return {d: GraphBatch(**f) for d, f in fields.items()}, perm

    def empty(self, steps: int, pin: bool = False) -> torch.Tensor:
        """A zeroed [steps, words] int32 host buffer (pinned for the card)."""
        return torch.zeros((steps, self.words), dtype=torch.int32, pin_memory=pin)


def stack_batches(batch_dicts: Sequence[Dict[str, GraphBatch]], layout: StepLayout,
                  perms: Optional[Sequence] = None, pin: bool = False) -> torch.Tensor:
    """Stack per-domain batch dicts (and each step's PCGrad order, where the
    layout has one) into one chunk of rows, [len(batch_dicts), words]."""
    words = layout.empty(len(batch_dicts), pin)
    buf = words.numpy()
    for j, batches in enumerate(batch_dicts):
        out = layout.np_views(buf[j])
        for d, b in batches.items():
            for name in FIELDS:
                out[d][name][...] = getattr(b, name).cpu().numpy()
        if layout.perm_len:
            buf[j, layout.perm_offset:layout.perm_offset + layout.perm_len] = \
                np.asarray(perms[j], np.int32)
    return words


def _fill_row(loader, layout: StepLayout, row: np.ndarray, chosen) -> int:
    """Build each domain's batch of ``chosen`` into ``row``; its real edges."""
    out = layout.np_views(row)
    edges = 0
    for d, ix in chosen.items():
        build_batch_into(loader.domain_stores[d], ix, *loader.pads[d],
                         loader.samples_per_domain, True, out[d])
        edges += int(out[d]["n_edge"].sum())
    return edges


def chunk_batches(loader, layout: StepLayout, steps: int, chunk: int,
                  pcgrad_generator: Optional[torch.Generator],
                  pin: bool = False) -> Iterator[tuple]:
    """``steps`` steps of ``loader`` in chunks of ``chunk`` (the last ragged):
    yields (words [c, layout.words] int32, real edges per step [c] int64).
    Per step, in order: the sampler's draw, then PCGrad's order from
    ``pcgrad_generator`` (where the layout has one), as the per-step path
    draws them."""
    for start in range(0, steps, chunk):
        c = min(chunk, steps - start)
        words = layout.empty(c, pin)
        buf = words.numpy()
        edges = np.zeros(c, np.int64)
        for j in range(c):
            edges[j] = _fill_row(loader, layout, buf[j], loader.sample_indices())
            if layout.perm_len:
                buf[j, layout.perm_offset:layout.perm_offset + layout.perm_len] = (
                    torch.randperm(layout.perm_len, generator=pcgrad_generator).numpy())
        yield words, edges


def warmup_row(loader, layout: StepLayout) -> np.ndarray:
    """A row for the capture's warm-up step, drawn from no stream: each
    domain's first train graph alone (it fits any pad), the identity order."""
    row = np.zeros(layout.words, np.int32)
    _fill_row(loader, layout, row, {d: ix[:1] for d, ix in loader.train_indices.items()})
    row[layout.perm_offset:layout.perm_offset + layout.perm_len] = np.arange(layout.perm_len)
    return row


def prefetched(gen: Iterable, depth: int = 3, put=lambda item: item) -> Iterator:
    """Run ``gen`` in a producer thread, up to ``depth`` items ahead, and yield
    ``put(item)`` for each on the caller's thread (the copy to the card goes
    there). An exception in the producer is raised here; closing the
    generator stops and joins the producer. With ``GNN_NO_PREFETCH`` set,
    no thread: ``gen`` runs on the caller's thread."""
    if os.environ.get("GNN_NO_PREFETCH"):
        for item in gen:
            yield put(item)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop, failure, done = object(), [], threading.Event()

    def offer(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        # The sentinel goes up in a finally: an exception in ``gen`` must
        # reach the consumer, not strand it on q.get().
        try:
            for item in gen:
                if not offer(item):
                    return
        except BaseException as exc:  # noqa: BLE001 -- raised in the consumer
            failure.append(exc)
        finally:
            offer(stop)

    thread = threading.Thread(target=producer, name="pretrain-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if failure:
                    raise failure[0]
                return
            yield put(item)
    finally:
        done.set()
        thread.join()


def kernel_counters() -> dict:
    """name -> the launch-counting wrapper of every hand kernel."""
    from gnn_pretraining_tpu_torch.ops import ntxent, spmm, spmm_csr

    return {"gin_spmm_fwd": spmm.gin_spmm_fwd, "gin_spmm_bwd": spmm.gin_spmm_bwd,
            "ntxent_fwd": ntxent.ntxent_fwd, "ntxent_bwd": ntxent.ntxent_bwd,
            "csr_spmm_fwd": spmm_csr.csr_spmm_fwd, "csr_spmm_bwd": spmm_csr.csr_spmm_bwd}


class ChunkRunner:
    """``runner(state, words, layout) -> packed`` (see
    ``pretrain.make_chunked_train_step``) over a ``pretrain.StepBody``."""

    def __init__(self, body, model: torch.nn.Module, optimizer, streams: Dict):
        self.body, self.model, self.optimizer, self.streams = body, model, optimizer, streams
        self.device = body.device
        self.on_card = self.device.type == "cuda"
        self.metric_names: List[str] = []
        self.layout: Optional[StepLayout] = None
        self.row = self.batches = self.perm = None
        self.graph = self.out = self.counters = None
        self.capture_launches: Dict[str, int] = {}
        self.replays = 0

    def _bind(self, layout: StepLayout) -> None:
        if self.layout is None:
            self.layout = layout
            self.row = torch.zeros(layout.words, dtype=torch.int32, device=self.device)
            self.batches, self.perm = layout.views(self.row)
        elif layout != self.layout:
            raise ValueError("a chunk of another layout than the runner's")

    def _step(self, counters: torch.Tensor) -> torch.Tensor:
        """One step on the input buffer: its metrics as one f32 vector."""
        perm = None if self.perm is None else self.perm.long()
        metrics, _ = self.body(counters, self.batches, perm)
        if not self.metric_names:
            self.metric_names.extend(sorted(metrics))
        return torch.stack([metrics[n].to(torch.float32).reshape(())
                            for n in self.metric_names])

    def _generators(self) -> List[torch.Generator]:
        sources = (self.streams["dropout"], self.streams["views"], self.streams["task_draws"])
        return [s.generator for s in sources if s.generator is not None]

    def capture(self, state, row, layout: StepLayout) -> None:
        """Capture the train step in a CUDA graph (once), warming it up on
        ``row`` (one step's words) with nothing trained."""
        if not self.on_card:
            raise RuntimeError("a CUDA graph is captured on the card only")
        if self.graph is not None:
            return
        dropout, views, draws = (self.streams[k] for k in ("dropout", "views", "task_draws"))
        if dropout.injected or views.injected or draws.injected_masks or \
                draws.injected_negatives:
            raise ValueError("a captured step draws from its generators: nothing may "
                             "be injected")
        self._bind(layout)
        counters = state.device_counters(self.device)
        self.row.copy_(torch.as_tensor(row).to(self.device))
        with torch.no_grad():
            weights = {k: v.clone() for k, v in self.model.state_dict().items()}
            opt_state = {p: {k: v.clone() for k, v in st.items()}
                         for p, st in self.optimizer.state.items()}
            gen_states = [g.get_state() for g in self._generators()]
            saved_counters = counters.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARMUP_STEPS):
                    self._step(counters)
        finally:
            torch.cuda.current_stream(self.device).wait_stream(side)
            with torch.no_grad():     # in place: the graph reads these tensors
                for k, v in self.model.state_dict().items():
                    v.copy_(weights[k])
                for p, st in self.optimizer.state.items():
                    for k, v in st.items():
                        if p in opt_state:
                            v.copy_(opt_state[p][k])
                        else:         # the warm-up made it: AdamW's fresh state is 0
                            v.zero_()
                for g, st in zip(self._generators(), gen_states):
                    g.set_state(st)
                counters.copy_(saved_counters)
        graph = torch.cuda.CUDAGraph()
        for g in self._generators():
            graph.register_generator_state(g)
        kernels = kernel_counters()
        before = {name: k.launches for name, k in kernels.items()}
        with torch.cuda.graph(graph, stream=side):
            out = self._step(counters)
        self.capture_launches = {name: k.launches - before[name]
                                 for name, k in kernels.items()}
        self.graph, self.out, self.counters = graph, out, counters

    def __call__(self, state, words: torch.Tensor, layout: StepLayout) -> torch.Tensor:
        self._bind(layout)
        counters = state.device_counters(self.device)
        if self.on_card:
            if self.graph is None:
                self.capture(state, words[0], layout)
            if counters is not self.counters:
                raise ValueError("the runner was captured with another state's counters")
        columns = []
        for j in range(words.shape[0]):
            self.row.copy_(words[j], non_blocking=True)
            if self.on_card:
                self.graph.replay()
                columns.append(self.out.clone())
            else:
                columns.append(self._step(counters))
        if self.on_card:
            self.replays += words.shape[0]
        state.advance(words.shape[0], words.shape[0] * int(self.body.multi_task))
        return torch.stack(columns, dim=1)

    def release(self) -> None:
        """Free the graph and what it holds (its pool; the parameters' last
        gradients, which live there)."""
        self.graph = self.out = None
        for p in self.model.parameters():
            p.grad = None
