#!/usr/bin/env python3
"""Drive the PyTorch port (gnn_pretraining_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit (nvcc). Phases, each printed as one JSON line:

  1. device  -- the card's name and power limit (nvidia-smi); TF32 off;
  2. build   -- compile the port's CUDA sources (build/torch_kernels/);
  3. kernel  -- K1-fwd against its plain version in every precision mode, at
                the serving shapes and a ragged one, bf16 and f32 adjacency;
  4. slice   -- the serving path through the user's entry points: ENZYMES
                embeddings and graph logits from the b2 transfer artifact,
                Cora node logits and link probabilities, each counted at 5
                K1 launches and held against the same weights on the dense
                f32 path;
  5. timing  -- CUDA-event medians of K1, its plain version, one PyTorch
                call for the same function, and each serving forward;
  6. profile -- each serving forward's device time by kernel
                (torch.profiler) and the share of its time the card idles.

Then the card's nvidia-smi line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises, so the script exits
non-zero and prints no result; it also does so without a CUDA card and
outside a checkout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ARTIFACT = HERE / "artifacts" / "transfer" / "backbone_b2_42.msgpack"
SEED = 0
KERNEL_SHAPES = ((1056, 256), (2712, 256), (136, 40))
# Max |kernel - plain| / max |plain| per mode: tests/test_ops.py:71-90.
KERNEL_TOL = {"highest": 1e-5, "split": 1e-3, "bf16": 5e-2}
# Max relative error of a serving output, K1 (split) path vs dense f32 path.
SLICE_TOL = 1e-3
LAUNCHES_PER_FORWARD = 5            # one K1 launch per GIN layer
TIMING_REPS = 30
WARMUP = 5
PROFILE_REPS = 5
# Published H100 SXM peaks (dense bf16 tensor cores, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Bucket shapes of the tracked serving artifacts (artifacts/MANIFEST.json).
ENZYMES_BUCKET = dict(graphs=32, nodes=1056, edges=3992)
CORA_NODES, CORA_NODES_PAD = 2708, 2712
CORA_NC_EDGES, CORA_NC_EDGES_PAD = 10556, 10560
CORA_LP_EDGES, CORA_LP_EDGES_PAD = 8444, 8448
CORA_SCORE_PAIRS = 256


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def import_port():
    """The port from this checkout, never from elsewhere on the path."""
    sys.path.insert(0, str(HERE))
    import gnn_pretraining_tpu_torch as port

    if not Path(port.__file__).resolve().is_relative_to(HERE):
        raise RuntimeError(f"imported {port.__file__}, not the checkout's port")
    return port


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return card


def build_phase() -> None:
    from gnn_pretraining_tpu_torch.ops import _build

    res = _build.build()
    ptxas = [ln.strip() for ln in str(res["log"]).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": res["seconds"], "library": res["path"],
          "ptxas": ptxas})


def random_adjacency(rng, n: int, device, dtype) -> torch.Tensor:
    """A sparse multigraph adjacency: ~4 edges per node, a tenth of them
    repeated (entries of 2 and more), the last twentieth masked out."""
    from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency

    e = 4 * n
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    s = np.concatenate([s, s[: e // 10]]).astype(np.int32)
    r = np.concatenate([r, r[: e // 10]]).astype(np.int32)
    mask = (np.arange(s.size) < s.size - s.size // 20).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return build_dense_adjacency(t(s), t(r), t(mask), n, dtype=dtype)


def kernel_phase(device) -> dict:
    from gnn_pretraining_tpu_torch.ops.spmm import gin_spmm_fwd, spmm_reference

    rng = np.random.default_rng(SEED)
    errors = {}
    for n, f in KERNEL_SHAPES:
        h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        eps = torch.tensor([-0.2], device=device)
        for dtype in (torch.bfloat16, torch.float32):
            adj = random_adjacency(rng, n, device, dtype)
            for mode, tol in KERNEL_TOL.items():
                out = gin_spmm_fwd(adj, h, eps, mode)
                ref = spmm_reference(adj, h, eps, mode)
                torch.cuda.synchronize()
                abs_err = float((out - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                ok = bool(rel <= tol and torch.isfinite(out).all())
                emit({"phase": "kernel", "kernel": "gin_spmm_fwd", "n": n,
                      "f": f, "adj": str(dtype).replace("torch.", ""),
                      "mode": mode, "max_abs_err": abs_err, "max_rel_err": rel,
                      "tol": tol, "ok": ok})
                if not ok:
                    raise AssertionError(f"K1 {mode} at ({n},{f}) {dtype}: "
                                         f"relative error {rel} > {tol}")
                errors[(n, f, dtype, mode)] = abs_err
    return errors


def synthetic_store(rng, name: str, sizes, undirected_edges, feat_dim: int,
                    features):
    """A GraphStore of random multigraphs, both edge directions present."""
    from gnn_pretraining_tpu_torch.data.batch import GraphStore

    edges = []
    for n_g, m_g in zip(sizes, undirected_edges):
        u = rng.integers(0, n_g, m_g)
        v = (u + rng.integers(1, n_g, m_g)) % n_g          # no self loops
        edges.append(np.stack([np.concatenate([u, v]), np.concatenate([v, u])]))
    node_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    edge_offsets = np.concatenate(
        [[0], np.cumsum([e.shape[1] for e in edges])]).astype(np.int64)
    return GraphStore(name=name,
                      node_features=features(int(node_offsets[-1]), feat_dim),
                      edge_index=np.concatenate(edges, 1).astype(np.int32),
                      node_offsets=node_offsets, edge_offsets=edge_offsets,
                      y=rng.integers(0, 2, len(sizes)), splits={})


def serving_inputs(device):
    """Seeded batches at the serving buckets: ENZYMES (32 graphs, <=1056
    nodes, <=3992 edges, x dim 21) and Cora (2708/2712 nodes, x dim 1433;
    10556/10560 edges for NC, 8444/8448 for LP, 256 score pairs)."""
    from gnn_pretraining_tpu_torch.data.batch import build_batch

    rng = np.random.default_rng(SEED)
    b = ENZYMES_BUCKET
    sizes = 20 + rng.multinomial(b["nodes"] - 20 * b["graphs"] - 8,
                                 [1 / b["graphs"]] * b["graphs"])
    molecule = lambda n, d: np.clip(  # noqa: E731
        rng.normal(size=(n, d)), -3, 3).astype(np.float32)
    store = synthetic_store(rng, "ENZYMES", sizes, (1.85 * sizes).astype(int),
                            21, molecule)
    enz = build_batch(store, range(b["graphs"]), b["nodes"], b["edges"],
                      b["graphs"]).to(device)

    def bag_of_words(n, d):
        x = (rng.random((n, d)) < 18 / d).astype(np.float32)
        return x / np.maximum(x.sum(1, keepdims=True), 1.0)

    cora = {}
    for task, real, pad in (("NC", CORA_NC_EDGES, CORA_NC_EDGES_PAD),
                            ("LP", CORA_LP_EDGES, CORA_LP_EDGES_PAD)):
        store = synthetic_store(rng, "Cora", [CORA_NODES], [real // 2], 1433,
                                bag_of_words)
        cora[task] = build_batch(store, [0], CORA_NODES_PAD, pad, 1).to(device)
    score = torch.from_numpy(
        rng.integers(0, CORA_NODES, (2, CORA_SCORE_PAIRS)).astype(np.int32)).to(device)
    return enz, cora, score


def serving_forwards(models, enz, cora, score):
    """name -> zero-argument callable running one serving forward."""
    from gnn_pretraining_tpu_torch import make_embedding_fn, make_serving_fn

    graph = lambda b: (b.x, b.node_mask, b.senders, b.receivers, b.edge_mask)  # noqa: E731
    embed, _ = make_embedding_fn(models["ENZYMES"])
    gc_make, _ = make_serving_fn(models["ENZYMES"])
    gc = gc_make(enz.num_graphs)
    nc, _ = make_serving_fn(models["Cora_NC"])
    lp, _ = make_serving_fn(models["Cora_LP"])
    return {
        "ENZYMES_embed": lambda: embed(*graph(enz)),
        "ENZYMES_GC": lambda: gc(*graph(enz), enz.node_graph),
        "Cora_NC": lambda: nc(*graph(cora["NC"])),
        "Cora_LP": lambda: lp(*graph(cora["LP"]), score[0], score[1]),
    }


EXPECTED_SHAPES = {"ENZYMES_embed": (1056, 256), "ENZYMES_GC": (32, 6),
                   "Cora_NC": (CORA_NODES_PAD, 7), "Cora_LP": (CORA_SCORE_PAIRS,)}


def slice_phase(device):
    from gnn_pretraining_tpu_torch import FinetuneGNN, load_serving_model
    from gnn_pretraining_tpu_torch.ops.spmm import gin_spmm_fwd

    models = {d: load_serving_model(d, ARTIFACT, device=device, seed=SEED)
              for d in ("ENZYMES", "Cora_NC", "Cora_LP")}
    enz, cora, score = serving_inputs(device)
    forwards = serving_forwards(models, enz, cora, score)

    gin_spmm_fwd.launches = 0          # the main path's run, and only it
    outputs, launches = {}, {}
    for name, fwd in forwards.items():
        before = gin_spmm_fwd.launches
        outputs[name] = fwd()
        launches[name] = gin_spmm_fwd.launches - before
    main_path_launches = gin_spmm_fwd.launches
    torch.cuda.synchronize()

    twins = {}
    for domain, model in models.items():
        twins[domain] = FinetuneGNN(domain, "dense", device=device)
        twins[domain].load_state_dict(model.state_dict())
    dense = {name: fwd() for name, fwd in
             serving_forwards(twins, enz, cora, score).items()}
    if gin_spmm_fwd.launches != main_path_launches:
        raise AssertionError("the dense path launched K1")

    for name, out in outputs.items():
        ref = dense[name]
        rel = float((out - ref).abs().max() / ref.abs().max())
        ok = bool(tuple(out.shape) == EXPECTED_SHAPES[name]
                  and torch.isfinite(out).all() and rel <= SLICE_TOL
                  and launches[name] == LAUNCHES_PER_FORWARD)
        emit({"phase": "slice", "forward": name, "shape": list(out.shape),
              "k1_launches": launches[name], "max_rel_err_vs_dense": rel,
              "tol": SLICE_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"serving forward {name} failed its checks")
    return forwards, enz, cora, main_path_launches


def median_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(TIMING_REPS)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def k1_bound(n: int, f: int, adj_bytes: int) -> dict:
    """Least time for split-mode K1 on the H100: two bf16 passes of
    2*N*N*F operations, against A, H and out each moved once."""
    ops = 2 * 2 * n * n * f
    nbytes = adj_bytes * n * n + 4 * n * f * 2 + 4
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations": ops, "bytes": nbytes}


def timing_phase(device, forwards, enz, cora, errors, launches):
    from gnn_pretraining_tpu_torch.ops.spmm import (
        build_dense_adjacency,
        gin_spmm_fwd,
        spmm_reference,
    )

    rng = np.random.default_rng(SEED + 1)
    entries = []
    for batch in (enz, cora["NC"]):
        n, f = batch.num_nodes, 256
        adj = build_dense_adjacency(batch.senders, batch.receivers,
                                    batch.edge_mask, n, dtype=torch.bfloat16)
        adj_f32 = adj.float()          # made outside the timed call
        h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        eps = torch.tensor([0.1], device=device)
        beta = 1.0 + 0.1
        row = {"n": n, "f": f, "mode": "split", "adj": "bfloat16",
               "ms": median_ms(lambda: gin_spmm_fwd(adj, h, eps, "split")),
               "plain_ms": median_ms(lambda: spmm_reference(adj, h, eps, "split")),
               "library_ms": median_ms(lambda: torch.addmm(h, adj_f32, h, beta=beta)),
               "library_call": "torch.addmm(h, adj_f32, h, beta=1+eps)",
               **k1_bound(n, f, adj.element_size())}
        emit({"phase": "timing", "kernel": "gin_spmm_fwd", **row})
        entries.append(row)
    forward_ms = {}
    for name, fwd in forwards.items():
        forward_ms[name] = median_ms(fwd)
        emit({"phase": "timing", "forward": name, "ms": forward_ms[name]})

    main = entries[-1]                 # the Cora shape, the larger of the two
    n = main["n"]
    return forward_ms, [{
        "name": "gin_spmm_fwd", "route": "cuda",
        "source": "gnn_pretraining_tpu_torch/csrc/gin_spmm.cu",
        "replaces": "gnn_pretraining_tpu/ops/spmm.py:86",
        "launches": launches,
        "max_abs_err": errors[(n, 256, torch.bfloat16, "split")],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "at": {"n": n, "f": 256, "mode": "split", "adj": "bfloat16"},
        "also": [{k: e[k] for k in ("n", "ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by")}
                 for e in entries[:-1]],
    }]


def profile_phase(forwards, forward_ms) -> None:
    """Where a serving forward's time goes: device time by kernel from
    torch.profiler over PROFILE_REPS forwards, and the idle share of the
    forward's CUDA-event time (timing phase) that no kernel covers."""
    from torch.profiler import ProfilerActivity, profile

    for name, fwd in forwards.items():
        fwd()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_REPS):
                fwd()
            torch.cuda.synchronize()
        kernels = sorted(
            ((e.key, e.self_device_time_total / PROFILE_REPS / 1e3, e.count // PROFILE_REPS)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda k: -k[1])
        busy = sum(ms for _, ms, _ in kernels)
        k1 = sum(ms for key, ms, _ in kernels if "gin_spmm_fwd" in key)
        emit({"phase": "profile", "forward": name, "event_ms": forward_ms[name],
              "device_busy_ms": busy if kernels else None,
              "k1_device_ms": k1 if kernels else None,
              "idle_share": 1 - busy / forward_ms[name] if kernels else None,
              "kernels_per_forward": sum(c for _, _, c in kernels),
              "top": [[key[:60], ms, c] for key, ms, c in kernels[:6]]})


def main() -> int:
    t0 = time.perf_counter()
    card = device_phase()
    import_port()
    build_phase()
    device = torch.device("cuda")
    errors = kernel_phase(device)
    forwards, enz, cora, launches = slice_phase(device)
    forward_ms, kernels = timing_phase(device, forwards, enz, cora, errors,
                                       launches)
    profile_phase(forwards, forward_ms)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
