#!/usr/bin/env python3
"""Drive the PyTorch port (gnn_pretraining_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit (nvcc). Phases, each printed as one JSON line:

  1. device  -- the card's name and power limit (nvidia-smi); TF32 off;
  2. build   -- compile the port's CUDA sources (build/torch_kernels/);
  3. kernel  -- K1-fwd and K1-bwd against their plain versions in every
                precision mode, at every shape the main path gives them (the
                serving buckets and the pads of the fine-tune loaders built
                from the stores of phase 5) and a ragged one, bf16 and f32
                adjacency; the autograd Function's dH and d-eps against
                autograd through the dense f32 aggregation;
  4. slice   -- the serving path through the user's entry points: ENZYMES
                embeddings and graph logits from the b2 transfer artifact,
                Cora node logits and link probabilities, each counted at 5
                K1 launches and held against the same weights on the dense
                f32 path;
  5. train   -- one fine-tune train step per cell (ENZYMES full_finetune and
                linear_probe, Cora_NC, Cora_LP) through create_finetune_arrays
                and make_*_steps on seeded synthetic stores of the datasets'
                real sizes, each counted at its K1 fwd/bwd launches and held
                (loss, gradients, post-step parameters) against a twin model
                on the dense f32 path with the same dropout seed and the
                same ReLU branches;
  6. entry   -- finetune() for 2 epochs on each of the three stores;
  7. timing  -- CUDA-event medians of K1 fwd and bwd, their plain versions,
                one PyTorch call for the same function, each serving forward
                and each train step;
  8. profile -- each serving forward's and train step's device time by kernel
                (torch.profiler) and the share of its time the card idles.

Then the card's nvidia-smi line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises, so the script exits
non-zero and prints no result; it also does so without a CUDA card and
outside a checkout.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ARTIFACT = HERE / "artifacts" / "transfer" / "backbone_b2_42.msgpack"
SEED = 0
# (N, F) of the serving buckets and a ragged shape; kernel_shapes() adds the
# node pads of the fine-tune loaders, which depend on the stores.
SERVING_SHAPES = ((1056, 256), (2712, 256))
RAGGED_SHAPE = (136, 40)
# Max |kernel - plain| / max |plain| per mode: tests/test_ops.py:71-90.
KERNEL_TOL = {"highest": 1e-5, "split": 1e-3, "bf16": 5e-2}
# Max relative error of a serving output, K1 (split) path vs dense f32 path.
SLICE_TOL = 1e-3
LAUNCHES_PER_FORWARD = 5            # one K1 launch per GIN layer
# Autograd Function vs autograd through the dense f32 aggregation (highest).
FUNCTION_TOL = 1e-5
# Train cells: (domain, strategy) -> K1 launches (fwd, bwd) of one train step.
# One fwd per GIN layer and forward pass (LP runs a no-grad embedding pass
# first: 10); one bwd per layer whose input needs a gradient (ENZYMES' frozen
# encoder spares layer 0's; a frozen backbone under a frozen encoder all 5).
TRAIN_CELLS = {("ENZYMES", "full_finetune"): (5, 4),
               ("ENZYMES", "linear_probe"): (5, 0),
               ("Cora_NC", "full_finetune"): (5, 5),
               ("Cora_LP", "full_finetune"): (10, 5)}
ENTRY_CELLS = (("ENZYMES", "full_finetune"), ("Cora_NC", "full_finetune"),
               ("Cora_LP", "full_finetune"))
ENTRY_EPOCHS = 2
# Train step on K1 (split) vs its twin on the dense f32 path: loss relative;
# gradients as the L2 norm of the difference over the L2 norm of the model's
# gradient (all leaves, and the head's alone), and as max |diff| over its
# largest entry. The twin takes the ReLU branches the K1 model took
# (utils/relu_branches.py): a pre-activation within rounding of 0 would
# otherwise fall on either side of the kink and move every gradient below it,
# most visibly in link prediction, whose loss reaches the model through 512
# scored pairs only. The units where the twin's own sign said otherwise are
# counted and printed, and may be no more than RELU_FLIP_SHARE of all units.
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = 2e-3
RELU_FLIP_SHARE = 1e-5
# Real sizes of the datasets the synthetic stores stand in for.
ENZYMES_GRAPHS, ENZYMES_MEAN_NODES, ENZYMES_AVG_DEGREE = 600, 32.6, 3.8
CORA_UNDIRECTED_EDGES, CORA_SPLIT = 5278, (140, 500, 1000)
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


def kernel_shapes(processed_dir: Path) -> dict:
    """(N, F) -> where the main path meets it: the serving buckets, the node
    pad of every fine-tune loader over the stores, and a ragged shape."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays

    shapes = {shape: ["serving"] for shape in SERVING_SHAPES}
    for domain in ("ENZYMES", "Cora_NC", "Cora_LP"):
        cfg = config.FinetuneConfig(domain, "full_finetune", "b2", 42)
        for split in ("train", "val", "test"):
            data = create_finetune_arrays(domain, split, cfg.batch_size, processed_dir)
            graph = data.batches[0] if domain == "ENZYMES" else data.graph
            shapes.setdefault((graph.num_nodes, 256), []).append(f"{domain}/{split}")
    shapes.setdefault(RAGGED_SHAPE, []).append("ragged")
    emit({"phase": "kernel", "shapes": [{"n": n, "f": f, "of": of}
                                        for (n, f), of in shapes.items()]})
    return shapes


def kernel_phase(device, shapes) -> dict:
    from gnn_pretraining_tpu_torch.ops.spmm import (
        gin_aggregate_dense,
        gin_spmm_bwd,
        gin_spmm_fwd,
        spmm,
        spmm_bwd_reference,
        spmm_reference,
    )

    pairs = {"gin_spmm_fwd": (gin_spmm_fwd, spmm_reference),
             "gin_spmm_bwd": (gin_spmm_bwd, spmm_bwd_reference)}
    rng = np.random.default_rng(SEED)
    errors = {}
    for n, f in shapes:
        h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        eps = torch.tensor([-0.2], device=device)
        for dtype in (torch.bfloat16, torch.float32):
            adj = random_adjacency(rng, n, device, dtype)
            for mode, tol in KERNEL_TOL.items():
                for name, (kernel, plain) in pairs.items():
                    out = kernel(adj, h, eps, mode)
                    ref = plain(adj, h, eps, mode)
                    torch.cuda.synchronize()
                    abs_err = float((out - ref).abs().max())
                    rel = abs_err / float(ref.abs().max())
                    ok = bool(rel <= tol and torch.isfinite(out).all())
                    emit({"phase": "kernel", "kernel": name, "n": n, "f": f,
                          "adj": str(dtype).replace("torch.", ""), "mode": mode,
                          "max_abs_err": abs_err, "max_rel_err": rel,
                          "tol": tol, "ok": ok})
                    if not ok:
                        raise AssertionError(f"{name} {mode} at ({n},{f}) {dtype}: "
                                             f"relative error {rel} > {tol}")
                    errors[(name, n, f, dtype, mode)] = abs_err

        # The Function's wiring: dH from K1-bwd, d-eps from the reduction.
        adj = random_adjacency(rng, n, device, torch.bfloat16)
        up = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        grads = []
        for aggregate in (lambda h_, e_: spmm(adj, h_, e_, "highest"),
                          lambda h_, e_: gin_aggregate_dense(h_, adj, e_)):
            h_, e_ = h.clone().requires_grad_(), eps.clone().requires_grad_()
            aggregate(h_, e_).backward(up.t().contiguous().t())   # a strided gradient
            grads.append((h_.grad, e_.grad))
        torch.cuda.synchronize()
        (dh, de), (dh_ref, de_ref) = grads
        rel_h = float((dh - dh_ref).abs().max() / dh_ref.abs().max())
        rel_e = float((de - de_ref).abs().max() / de_ref.abs().max())
        ok = rel_h <= FUNCTION_TOL and rel_e <= FUNCTION_TOL
        emit({"phase": "kernel", "function": "spmm", "n": n, "f": f,
              "dh_max_rel_err": rel_h, "deps_max_rel_err": rel_e,
              "tol": FUNCTION_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"spmm Function at ({n},{f}): dH {rel_h}, d-eps {rel_e}")
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

    gin_spmm_fwd.launches = 0          # the serving path's run, and only it
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


def write_stores(processed_dir: Path) -> dict:
    """Seeded synthetic stores at the real datasets' sizes, through
    GraphStore.save: ENZYMES (600 graphs of ~33 nodes, x dim 21, 6 classes)
    and Cora (2708 nodes, 10556 directed edges, x dim 1433, 7 classes, node
    split 140/500/1000, edge split 80/10/10)."""
    from gnn_pretraining_tpu_torch.data.synthetic import (
        synthetic_graph_store,
        synthetic_planetoid_stores,
    )

    rng = np.random.default_rng(SEED + 2)
    sizes = np.clip(rng.poisson(ENZYMES_MEAN_NODES, ENZYMES_GRAPHS), 2, 126)
    stores = {"ENZYMES": synthetic_graph_store("ENZYMES", rng, sizes,
                                               ENZYMES_AVG_DEGREE)}
    stores.update(synthetic_planetoid_stores("Cora", rng, CORA_NODES,
                                             CORA_UNDIRECTED_EDGES, *CORA_SPLIT))
    sizes = {}
    for name, store in stores.items():
        store.save(processed_dir / f"{name}.npz")
        sizes[name] = {"graphs": store.num_graphs,
                       "nodes": int(store.node_offsets[-1]),
                       "directed_edges": int(store.edge_offsets[-1])}
        if "train_pos" in store.splits:
            sizes[name]["train_edges"] = int(store.splits["train_pos"].shape[1])
    emit({"phase": "train", "stores": sizes})
    return sizes


def train_cell(domain: str, strategy: str, processed_dir: Path, device):
    """One train step of the cell on K1, checked against its dense twin.
    Returns (name, step, batch): step() runs one more train step on K1 and
    batch is the padded graph whose adjacency K1 was given."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.ops.spmm import gin_spmm_bwd, gin_spmm_fwd
    from gnn_pretraining_tpu_torch.utils import relu_branches

    cfg = config.FinetuneConfig(domain, strategy, "b2", 42)
    data = {"train": create_finetune_arrays(domain, "train", cfg.batch_size,
                                            processed_dir)}
    sides = {}
    for aggregation in ("pallas", "dense"):
        model = ft.build_finetune_model(cfg, aggregation, device)
        if sides:
            model.load_state_dict(sides["pallas"][0].state_dict())
        model.seed_dropout(SEED)
        optimizer, labels, lrs = ft.create_finetune_optimizer(model, cfg)
        train, _, batches, _ = ft.build_steps(cfg, model, optimizer, labels, data, device)
        sides[aggregation] = (model, train, next(iter(batches()))[1], labels, lrs)

    model, train, args, labels, lrs = sides["pallas"]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    fwd0, bwd0 = gin_spmm_fwd.launches, gin_spmm_bwd.launches
    with relu_branches.record(model) as branches:
        out = train(*args)
    launched = (gin_spmm_fwd.launches - fwd0, gin_spmm_bwd.launches - bwd0)
    twin, twin_train, twin_args, _, _ = sides["dense"]
    extra = ({"negatives": train.last_negatives}
             if cfg.task_type == "link_prediction" else {})
    with relu_branches.replay(twin, branches) as flips:
        twin_out = twin_train(*twin_args, **extra)
    units = sum(b.numel() for b in branches)
    if (gin_spmm_fwd.launches - fwd0, gin_spmm_bwd.launches - bwd0) != launched:
        raise AssertionError("the dense twin launched K1")
    torch.cuda.synchronize()

    loss, twin_loss = float(out[0]), float(twin_out[0])
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    twin_grads = {n: p.grad for n, p in twin.named_parameters() if p.grad is not None}
    if grads.keys() != twin_grads.keys():
        raise AssertionError(f"{domain}/{strategy}: K1 and dense train other leaves")
    g_max = max(float(g.abs().max()) for g in twin_grads.values())
    g_err = max(float((grads[n] - twin_grads[n]).abs().max()) for n in grads)

    def l2_err(prefix=""):
        """||g - g_twin|| / ||g_twin|| over the leaves under ``prefix``."""
        names = [n for n in grads if n.startswith(prefix)]
        ref = math.sqrt(sum(float(twin_grads[n].double().pow(2).sum()) for n in names))
        err = math.sqrt(sum(float((grads[n] - twin_grads[n]).double().pow(2).sum())
                            for n in names))
        return err / ref

    g_l2_err, head_l2_err = l2_err(), l2_err("classification_head")
    # AdamW moves an element by ~lr whatever its gradient's size, so where the
    # gradient is rounding noise (a bias in front of a BatchNorm) the two sides
    # may part by up to 2 lr; where it is clear (> 1e-3 of the largest entry)
    # the mean distance must stay under 0.05 lr.
    moved, p_err_sum, clear_count = 0.0, 0.0, 0
    params, twin_params = dict(model.named_parameters()), dict(twin.named_parameters())
    with torch.no_grad():
        for n, group in labels.items():
            if group == "frozen":
                if not torch.equal(params[n], start[n]):
                    raise AssertionError(f"frozen leaf {n} moved")
                continue
            lr = lrs[group]
            dist = (params[n] - twin_params[n]).abs() / lr
            if float(dist.max()) > 2.02:
                raise AssertionError(f"{n}: K1 and dense parameters part by more than 2 lr")
            clear = twin_grads[n].abs() > 1e-3 * g_max
            p_err_sum += float(dist[clear].sum())
            clear_count += int(clear.sum())
            moved = max(moved, float((params[n] - start[n]).abs().max()) / lr)
    p_err = p_err_sum / max(clear_count, 1)
    stats_moved = any(not torch.equal(v, start[k]) for k, v in model.state_dict().items()
                      if k.endswith("running_mean"))
    name = f"{domain}/{strategy}"
    batch = (data["train"].batches[0] if cfg.task_type == "graph_classification"
             else data["train"].graph)
    ok = bool(launched == TRAIN_CELLS[(domain, strategy)] and math.isfinite(loss)
              and abs(loss - twin_loss) <= TRAIN_LOSS_TOL * abs(twin_loss)
              and g_err <= TRAIN_GRAD_TOL * g_max and g_l2_err <= TRAIN_GRAD_TOL
              and head_l2_err <= TRAIN_GRAD_TOL
              and sum(flips) <= RELU_FLIP_SHARE * units
              and p_err <= 0.05
              and clear_count > 100 and moved > 0.5 and stats_moved)
    emit({"phase": "train", "cell": name, "k1_nodes_pad": batch.num_nodes,
          "k1_launches_fwd_bwd": list(launched),
          "expected": list(TRAIN_CELLS[(domain, strategy)]), "loss": loss,
          "loss_dense": twin_loss, "grad_max_err_over_max": g_err / g_max,
          "grad_l2_err_over_l2": g_l2_err,
          "head_grad_l2_err_over_l2": head_l2_err, "grad_tol": TRAIN_GRAD_TOL,
          "relu_units": units, "relu_flips_replayed": sum(flips),
          "param_mean_err_over_lr": p_err,
          "params_with_clear_grad": clear_count, "param_moved_over_lr": moved,
          "trainable_leaves": len(grads), "ok": ok})
    if not ok:
        raise AssertionError(f"train step {name} failed its checks")
    return name, (lambda: train(*args)), batch.to(device)


def train_phase(device, processed_dir: Path):
    """name -> step() and name -> the step's padded graph, per train cell."""
    cells = [train_cell(domain, strategy, processed_dir, device)
             for domain, strategy in TRAIN_CELLS]
    return ({name: step for name, step, _ in cells},
            {name: batch for name, _, batch in cells})


def entry_phase(processed_dir: Path, out_root: Path) -> None:
    """finetune() end to end: finite losses, the metric keys, the best
    checkpoint on disk and reloaded for the test pass."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune.finetune import finetune
    from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint

    for domain, strategy in ENTRY_CELLS:
        cfg = config.FinetuneConfig(domain, strategy, "b2", 42)
        t0 = time.perf_counter()
        result = finetune(cfg, aggregation="pallas", processed_dir=processed_dir,
                          epochs=ENTRY_EPOCHS, out_root=out_root)
        seconds = time.perf_counter() - t0
        log = out_root / "metrics" / config.FINETUNE_PROJECT_NAME / f"{cfg.run_name}.jsonl"
        rows = [json.loads(line) for line in open(log)]
        losses = [v for r in rows for k, v in r.items() if k.endswith("/loss")]
        ckpt = load_checkpoint(out_root / "finetune" / f"model_{cfg.run_name}.msgpack")
        sel = "val/auc" if cfg.task_type == "link_prediction" else "val/accuracy"
        keys = {"test/accuracy", "test/f1", "test/auc", "test/auc_global", "test/loss",
                "test/convergence_epochs", "test/total_parameters",
                "test/trainable_parameters", "test/steps_per_sec"}
        ok = bool(keys <= result.keys() and losses and np.isfinite(losses).all()
                  and any(sel in r for r in rows)
                  and any("train/gradients/model_grad_norm" in r for r in rows)
                  and ckpt["meta"]["epoch"] == result["test/convergence_epochs"]
                  and 1 <= ckpt["meta"]["epoch"] <= ENTRY_EPOCHS)
        emit({"phase": "entry", "cell": cfg.run_name, "seconds": seconds,
              "train_steps": sum("train/loss" in r for r in rows),
              "best_epoch": ckpt["meta"]["epoch"], "test_loss": result["test/loss"],
              "test_accuracy": result["test/accuracy"],
              "steps_per_sec": result["test/steps_per_sec"], "ok": ok})
        if not ok:
            raise AssertionError(f"finetune() on {cfg.run_name} failed its checks")


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


KERNEL_ROWS = {
    "gin_spmm_fwd": {"replaces": "gnn_pretraining_tpu/ops/spmm.py:86",
                     "library_call": "torch.addmm(h, adj_f32, h, beta=1+eps)"},
    "gin_spmm_bwd": {"replaces": "gnn_pretraining_tpu/ops/spmm.py:190",
                     "library_call": "torch.addmm(g, adj_f32.t(), g, beta=1+eps)"},
}


def timing_phase(device, forwards, steps, timed, errors, launches):
    """``timed``: (where the path meets the shape, its padded graph, the
    kernels the path launches at that shape); the last is the main row."""
    from gnn_pretraining_tpu_torch.ops.spmm import (
        build_dense_adjacency,
        gin_spmm_bwd,
        gin_spmm_fwd,
        spmm_bwd_reference,
        spmm_reference,
    )

    rng = np.random.default_rng(SEED + 1)
    entries = {name: [] for name in KERNEL_ROWS}
    for of, batch, launched_here in timed:
        n, f = batch.num_nodes, 256
        adj = build_dense_adjacency(batch.senders, batch.receivers,
                                    batch.edge_mask, n, dtype=torch.bfloat16)
        adj_f32 = adj.float()          # made outside the timed call
        adj_f32_t = adj_f32.t()        # a view: addmm reads A in place too
        h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        eps = torch.tensor([0.1], device=device)
        beta = 1.0 + 0.1
        calls = {
            "gin_spmm_fwd": (lambda: gin_spmm_fwd(adj, h, eps, "split"),
                             lambda: spmm_reference(adj, h, eps, "split"),
                             lambda: torch.addmm(h, adj_f32, h, beta=beta)),
            "gin_spmm_bwd": (lambda: gin_spmm_bwd(adj, h, eps, "split"),
                             lambda: spmm_bwd_reference(adj, h, eps, "split"),
                             lambda: torch.addmm(h, adj_f32_t, h, beta=beta)),
        }
        for name in launched_here:
            kernel, plain, library = calls[name]
            row = {"n": n, "f": f, "of": of, "mode": "split", "adj": "bfloat16",
                   "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                   "library_ms": median_ms(library),
                   "library_call": KERNEL_ROWS[name]["library_call"],
                   **k1_bound(n, f, adj.element_size())}
            emit({"phase": "timing", "kernel": name, **row})
            entries[name].append(row)
    forward_ms = {}
    for name, fwd in forwards.items():
        forward_ms[name] = median_ms(fwd)
        emit({"phase": "timing", "forward": name, "ms": forward_ms[name]})
    step_ms = {}
    for name, step in steps.items():
        step_ms[name] = median_ms(step)
        emit({"phase": "timing", "train_step": name, "ms": step_ms[name]})

    kernels = []
    for name, rows in entries.items():
        main = rows[-1]                # the Cora shape, the larger of the two
        n = main["n"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gnn_pretraining_tpu_torch/csrc/gin_spmm.cu",
            "replaces": KERNEL_ROWS[name]["replaces"],
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": errors[(name, n, 256, torch.bfloat16, "split")],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "at": {"n": n, "f": 256, "of": main["of"], "mode": "split",
                   "adj": "bfloat16"},
            "also": [{**{k: e[k] for k in ("n", "of", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")},
                      "max_abs_err": errors[(name, e["n"], 256, torch.bfloat16, "split")]}
                     for e in rows[:-1]],
        })
    return {**forward_ms, **step_ms}, kernels


def profile_phase(calls, event_ms) -> None:
    """Where a serving forward's or a train step's time goes: device time by
    kernel from torch.profiler over PROFILE_REPS calls, and the idle share of
    the call's CUDA-event time (timing phase) that no kernel covers."""
    from torch.profiler import ProfilerActivity, profile

    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_REPS):
                call()
            torch.cuda.synchronize()
        kernels = sorted(
            ((e.key, e.self_device_time_total / PROFILE_REPS / 1e3, e.count // PROFILE_REPS)
             for e in prof.key_averages()
             # Kernels and copies only: an annotated range such as the
             # optimizer's step shows on the device timeline too, and would
             # count the kernels under it a second time.
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and not e.key.startswith("Optimizer.")),
            key=lambda k: -k[1])
        busy = sum(ms for _, ms, _ in kernels)
        k1 = {d: sum(ms for key, ms, _ in kernels if f"gin_spmm_{d}_kernel" in key)
              for d in ("fwd", "bwd")}
        emit({"phase": "profile", "call": name, "event_ms": event_ms[name],
              "device_busy_ms": busy if kernels else None,
              "k1_fwd_device_ms": k1["fwd"] if kernels else None,
              "k1_bwd_device_ms": k1["bwd"] if kernels else None,
              "idle_share": 1 - busy / event_ms[name] if kernels else None,
              "kernels_per_call": sum(c for _, _, c in kernels),
              "top": [[key[:60], ms, c] for key, ms, c in kernels[:6]]})


def main() -> int:
    t0 = time.perf_counter()
    card = device_phase()
    import_port()
    from gnn_pretraining_tpu_torch.ops.spmm import gin_spmm_bwd, gin_spmm_fwd

    build_phase()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        processed_dir, out_root = Path(tmp) / "processed", Path(tmp) / "out"
        processed_dir.mkdir()
        write_stores(processed_dir)
        errors = kernel_phase(device, kernel_shapes(processed_dir))
        forwards, enz, cora, serving_launches = slice_phase(device)
        gin_spmm_fwd.launches = gin_spmm_bwd.launches = 0   # the train path's run
        steps, train_graphs = train_phase(device, processed_dir)
        entry_phase(processed_dir, out_root)
        train_launches = (gin_spmm_fwd.launches, gin_spmm_bwd.launches)
    launches = {"gin_spmm_fwd": {"serving": serving_launches, "train": train_launches[0]},
                "gin_spmm_bwd": {"serving": 0, "train": train_launches[1]}}
    if min(serving_launches, *train_launches) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    calls = {**forwards, **steps}
    both = ("gin_spmm_fwd", "gin_spmm_bwd")
    timed = (("ENZYMES serving bucket", enz, both[:1]),
             ("ENZYMES train batch", train_graphs["ENZYMES/full_finetune"], both),
             ("Cora full graph", cora["NC"], both))
    event_ms, kernels = timing_phase(device, forwards, steps, timed, errors,
                                     launches)
    profile_phase(calls, event_ms)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
