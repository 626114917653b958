#!/usr/bin/env python3
"""Drive the PyTorch port (gnn_pretraining_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card and the CUDA
toolkit (nvcc). Phases, each printed as one JSON line:

  1. device  -- the card's name and power limit (nvidia-smi); TF32 off;
  2. build   -- compile the port's CUDA sources (build/torch_kernels/) and
                report each kernel's ptxas resources;
  3. kernel  -- K1-fwd and K1-bwd against their plain versions in every
                precision mode, at every shape the main path gives them (the
                serving buckets, the pads of the fine-tune loaders built from
                the stores of phase 5, and the pads of the pretrain samplers
                (s2 and b4) and val loaders over the stores of phase 8) and a
                ragged one,
                bf16 and f32
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
  7. ntxent  -- K2-fwd and K2-bwd against their plain versions at the rows
                the pretrain loaders give them (2 x the node pad of each
                domain's train and val batches and of b4's batch, 2 x the
                graphs of a train and a val batch) and at 4104 rows with
                invalid rows, d = 128, f32;
                two calls on the same inputs must be bitwise equal; each
                launch's grid and each K2 kernel's ptxas registers;
  8. pretrain -- one train step each of schemes s2 (node + graph contrast),
                s5 (all six tasks) and b4 (five tasks on 32 ENZYMES graphs)
                over MUTAG, PROTEINS, NCI1, ENZYMES stores of the datasets'
                real sizes at full width, each counted at its K1 and K2
                launches and held against a dense-f32 twin on the plain
                NT-Xent formula with the same views, masks, negatives,
                PCGrad order, dropout draws and ReLU branches; one step each
                of b2, s1, s3, s4 (finite losses, the JAX step's metric keys,
                launch counts); then pretrain() for 1 epoch of s2 and of s5
                on the stores cut to a quarter of their graphs, and
                finetune() on ENZYMES for 1 epoch from each checkpoint (every
                head in the checkpoint, the JAX tree's keys, the backbone
                carried over);
  9. csr     -- K3-fwd and K3-bwd against their plain version (over the
                edge CSR) and the tile oracle (over the 128 x 128 tiles) in
                every precision mode on Cora_NC and Cora_LP at 6x scale after
                RCM (data/processed_6x, 16248 nodes, the stores the csr path
                trains on), a banded 16384-node graph, a ragged 300-node
                graph with rows and tile rows without edges, a pad_to case
                and the 2712-node Cora store of phase 5, where K3 must also
                equal K1 on the same graph; the autograd Function's dH and
                d-eps against autograd through the COO f32 aggregation;
 10. csr train and entry -- one fine-tune train step on K3 per csr cell
                (Cora_NC full_finetune and linear_probe, Cora_LP
                full_finetune, on the 6x stores, scheme b1), each counted at
                its K3 fwd/bwd launches with no K1 launch and held (loss,
                gradients, post-step parameters) against a twin on the coo
                f32 path on the same permuted graph with the same dropout
                seed, ReLU branches and negatives; then finetune(
                aggregation="csr") for 2 epochs on Cora_NC and 1 on Cora_LP;
 11. resume  -- pretrain() s5 at full width on K1 and K2 over the four
                datasets' stores cut to RESUME_STORE_GRAPHS graphs each (the
                graph sizes of phase 8's), so that an epoch is a handful of
                steps: run A for 6 epochs with resume=True, run B the same
                but stopped after its epoch-5 resume file, then B' =
                pretrain(resume=True). B's file restores onto a fresh model,
                optimizer and streams on the card, every tensor and
                generator state bitwise equal to the file's; B' starts at
                epoch 6, logs A's number of epoch-6 steps, launches K1 and
                K2 exactly steps x phase 8's per-step counts (and the
                epoch's evaluation forwards), ends with A's params and
                epoch-6 losses within RESUME_PARAM_TOL / RESUME_LOSS_TOL
                (not bitwise: index_add_ and scatter reductions add in the
                order their atomics land), and its summary's fidelity block
                is complete and accepted by cell_completed; save and load
                milliseconds and the file's bytes;
 12. timing  -- device-time medians (each call queued behind a sleep
                kernel, so the host's launch cost is left out; the time per
                call beside it) of K1 fwd and bwd (split, and bf16), of the
                three K2 kernels and of K3 fwd and bwd (Cora_NC 6x and the
                banded graph), their plain versions and one PyTorch call for
                the same function where there is one (addmm, cuSPARSE for
                K3), K2 at every row count of the ntxent phase beside the
                device time of an empty kernel (the launch floor);
                CUDA-event medians per call of each serving forward and
                each train step, csr ones included, and of the K2 Function
                against the plain NT-Xent formula (forward + backward) from
                16 to 8192 rows;
 13. profile -- each serving forward's and train step's device time by kernel
                (torch.profiler) and the share of its time the card idles.

The build phase prints every kernel's registers, shared memory and spills
(ptxas) and fails if a kernel of K1, K2 or K3 spills. Then the card's
nvidia-smi line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises, so the script exits
non-zero and prints no result; it also does so without a CUDA card and
outside a checkout.
"""

from __future__ import annotations

import json
import math
import re
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
# Block-CSR (K3) cells on the tracked stores of Cora at 6x scale (16248
# nodes: past the dense limit, where csr is the only kernel route). Per
# train step K3 runs fwd once per GIN layer and forward pass, bwd once per
# layer whose input needs a gradient: the linear probe freezes the backbone
# but trains the encoder, so its gradient still crosses every layer.
CSR_STORES = HERE / "data" / "processed_6x"
CSR_TRAIN_CELLS = {("Cora_NC", "full_finetune"): (5, 5),
                   ("Cora_NC", "linear_probe"): (5, 5),
                   ("Cora_LP", "full_finetune"): (10, 5)}
CSR_ENTRY_CELLS = (("Cora_NC", "full_finetune", 2), ("Cora_LP", "full_finetune", 1))
CELL_LAUNCHES = {"pallas": TRAIN_CELLS, "csr": CSR_TRAIN_CELLS}
CELL_KERNELS = {"pallas": ("gin_spmm_fwd", "gin_spmm_bwd"),
                "csr": ("csr_spmm_fwd", "csr_spmm_bwd")}
TWIN = {"pallas": "dense", "csr": "coo"}
CELL_SCHEME = {"pallas": "b2", "csr": "b1"}     # b1: from scratch, no checkpoint
# K3's checks: the 6x Cora graphs after RCM, the banded graph of the JAX
# package's crossover scans, a ragged graph with empty tile rows, a pad_to
# case, and the 2712-node Cora store, where K3 must also agree with K1.
CSR_BANDED = dict(n=16384, e=65536, band=256)
CSR_RAGGED = dict(n=300, e=200, f=40, reach=100)      # edges among the first 100
CSR_PADDED = dict(n=520, e=2000, masked=200, pad_to=64, f=72)
ENTRY_EPOCHS = 2
ENTRY_CELLS = (("ENZYMES", "full_finetune", ENTRY_EPOCHS),
               ("Cora_NC", "full_finetune", ENTRY_EPOCHS),
               ("Cora_LP", "full_finetune", ENTRY_EPOCHS))
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
# Pretraining at full width: per train step, K1 runs once per GIN layer and
# (task, domain) forward (two views for node and graph contrast, one for the
# other tasks), fwd and bwd: every layer's input needs a gradient, as the
# encoders train, masking's input carries the mask token's gradient, and the
# domain classifier's reaches the backbone through the reversal even at
# lambda = 0. K2 runs once per (contrastive task, domain) NT-Xent, fwd and
# bwd. Per scheme (K1, K2) launches per direction: 5 layers x domains x
# forwards per domain (s2: 4 x 4; s5: 4 x 8; b4: 1 x 7; b2: 4 x 1; s1: 4 x 2;
# s3: 4 x 6; s4: 4 x 7).
PRETRAIN_SCHEME = "s2"
STEP_LAUNCHES = {"s2": (80, 8), "s5": (160, 8), "b4": (35, 2), "b2": (20, 0),
                 "s1": (40, 0), "s3": (120, 8), "s4": (140, 8)}
TWIN_SCHEMES = ("s2", "s5", "b4")        # held against a dense-f32 twin
CHECKED_SCHEMES = ("b2", "s1", "s3", "s4")  # one checked step each
PRETRAIN_ENTRY_EPOCHS = 1
# The entry epochs (pretrain() for s2 and s5) run on stores cut to a quarter
# of each dataset's graphs, with the same graph sizes.
ENTRY_STORE_SHARE = 4
# K2 vs its plain versions: the summed loss, each row's loss and denominator
# relative, dZ (the sum of the TPU's two backward terms) as max |diff| over
# max |ref| (both f32 on the card; sums in another order).
NTXENT_LOSS_TOL = 1e-5
NTXENT_GRAD_TOL = 1e-4
NTXENT_MULTI_TILE_ROWS = 4104       # > 4096, ragged against the 32-row tiles
NTXENT_VALID_SHARE = 0.7            # of node pairs; graph rows all valid
CROSSOVER_ROWS = (4096, 8192)       # besides the rows of the ntxent phase
# The resume phase: pretrain() s5 on the four datasets' stores cut to 48
# graphs each, 8 graphs per domain per step: 5 steps per epoch. The resume
# file is written after epoch 5 (RESUME_EVERY) and after the last, the 6th.
RESUME_SCHEME = "s5"
RESUME_EPOCHS = 6
RESUME_STORE_GRAPHS = 48
# B' against A after the 6th epoch. Losses of epoch 6 (each step's total and
# task losses, the validation total): relative, as a train step against its
# twin (TRAIN_LOSS_TOL). Parameters: max |B' - A| over the run's AdamW
# budget, the default learning rate times the run's steps: an element whose
# gradient is rounding noise moves by up to ~lr a step either way, so the
# two runs may part by that much there (their relative L2 is printed beside).
RESUME_LOSS_TOL = TRAIN_LOSS_TOL
RESUME_PARAM_TOL = 1.0
TIMING_REPS = 30
WARMUP = 5
SLEEP_CYCLES = 1_000_000            # device_ms: ~0.5 ms of card time per call
PROFILE_REPS = 5
# Published H100 SXM peaks (dense bf16 and tf32 tensor cores, f32 outside
# them, HBM3); every bound_ms counts operations at the first, K1's and K2's
# alike.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Sources whose kernels must not spill registers (the redesigns of K1-K3).
NO_SPILL_SOURCES = ("gin_spmm.cu", "ntxent.cu", "spmm_csr.cu")
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


def ptxas_report(log: str) -> list:
    """Per kernel of nvcc's ``-Xptxas -v`` output: its source, registers,
    shared memory, stack frame and spill bytes."""
    rows, source = [], None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            rows.append({"source": source, "kernel": m.group(1)})
        elif rows and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            (rows[-1]["stack_bytes"], rows[-1]["spill_stores"],
             rows[-1]["spill_loads"]) = map(int, m.groups())
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return rows


def build_phase() -> list:
    """Build every kernel; fail if a kernel of NO_SPILL_SOURCES spills.
    Returns the ptxas rows."""
    from gnn_pretraining_tpu_torch.ops import _build

    res = _build.build()
    kernels = ptxas_report(str(res["log"]))
    for row in kernels:
        emit({"phase": "build", "ptxas": row})
    spilled = [k["kernel"] for k in kernels if k["source"] in NO_SPILL_SOURCES
               and k.get("spill_stores", 0) + k.get("spill_loads", 0) > 0]
    emit({"phase": "build", "seconds": res["seconds"], "library": res["path"],
          "kernels": len(kernels), "spilled": spilled})
    if spilled or not kernels:
        raise AssertionError(f"ptxas: kernels that spill {spilled} (of {len(kernels)})")
    return kernels


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
    pad of every fine-tune loader and of every pretrain sampler and val
    loader over the stores, and a ragged shape."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.data.loaders import (
        create_finetune_arrays,
        create_pretrain_val_loader,
    )

    shapes = {shape: ["serving"] for shape in SERVING_SHAPES}
    for domain in ("ENZYMES", "Cora_NC", "Cora_LP"):
        cfg = config.FinetuneConfig(domain, "full_finetune", "b2", 42)
        for split in ("train", "val", "test"):
            data = create_finetune_arrays(domain, split, cfg.batch_size, processed_dir)
            graph = data.batches[0] if domain == "ENZYMES" else data.graph
            shapes.setdefault((graph.num_nodes, 256), []).append(f"{domain}/{split}")
    cfg, loader = pretrain_loader(processed_dir)
    for domain in cfg.pretrain_domains:
        shapes.setdefault((loader.pads[domain][0], 256), []).append(
            f"pretrain {domain}/train")
        val = create_pretrain_val_loader(domain, processed_dir)[0]
        shapes.setdefault((val.num_nodes, 256), []).append(f"pretrain {domain}/val")
    _, b4 = pretrain_loader(processed_dir, "b4")       # 32 ENZYMES graphs per step
    shapes.setdefault((b4.pads["ENZYMES"][0], 256), []).append("pretrain b4 ENZYMES/train")
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
        attach_graph_properties,
        synthetic_graph_store,
        synthetic_planetoid_stores,
    )

    rng = np.random.default_rng(SEED + 2)
    sizes = np.clip(rng.poisson(ENZYMES_MEAN_NODES, ENZYMES_GRAPHS), 2, 126)
    # With graph properties: ENZYMES is also a pretraining domain.
    stores = {"ENZYMES": attach_graph_properties(synthetic_graph_store(
        "ENZYMES", rng, sizes, ENZYMES_AVG_DEGREE))}
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


def train_cell(domain: str, strategy: str, processed_dir: Path, device,
               kernel: str = "pallas"):
    """One train step of the cell on K1 (``kernel="pallas"``) or K3
    (``"csr"``), checked against its twin: the dense f32 path, or for csr
    the coo f32 path on the same RCM-permuted graph. Returns (name, step,
    batch): step() runs one more train step on the kernel and batch is the
    padded graph the loader gave."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.runners import csr_graph_aux
    from gnn_pretraining_tpu_torch.utils import relu_branches

    cfg = config.FinetuneConfig(domain, strategy, CELL_SCHEME[kernel], 42)
    data = {"train": create_finetune_arrays(domain, "train", cfg.batch_size,
                                            processed_dir)}
    model = ft.build_finetune_model(cfg, kernel, device)
    model.seed_dropout(SEED)
    optimizer, labels, lrs = ft.create_finetune_optimizer(model, cfg)
    train, _, batches, _ = ft.build_steps(cfg, model, optimizer, labels, data, device)
    args = next(iter(batches()))[1]
    twin = ft.build_finetune_model(cfg, TWIN[kernel], device)
    twin.load_state_dict(model.state_dict())
    twin.seed_dropout(SEED)
    twin_optimizer, _, _ = ft.create_finetune_optimizer(twin, cfg)
    if kernel == "pallas":
        twin_train = ft.build_steps(cfg, twin, twin_optimizer, labels, data, device)[0]
    else:
        # The graph the csr steps run on; ``args`` are already in its labels.
        graph = csr_graph_aux(data["train"].graph)[0].to(device)
        if cfg.task_type == "node_classification":
            twin_train = ft.make_nc_steps(twin, cfg, twin_optimizer, labels, graph, None)[0]
        else:
            twin_train = ft.make_lp_steps(twin, cfg, twin_optimizer, labels, graph,
                                          None, None, 0)[0]

    kernels = counters()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    before = {name: c.launches for name, c in kernels.items()}
    with relu_branches.record(model) as branches:
        out = train(*args)
    counts = {name: c.launches - before[name] for name, c in kernels.items()}
    launched = tuple(counts[name] for name in CELL_KERNELS[kernel])
    extra = ({"negatives": train.last_negatives}
             if cfg.task_type == "link_prediction" else {})
    with relu_branches.replay(twin, branches) as flips:
        twin_out = twin_train(*args, **extra)
    units = sum(b.numel() for b in branches)
    if any(c.launches - before[name] != counts[name] for name, c in kernels.items()):
        raise AssertionError("the twin launched a kernel")
    others = {name: n for name, n in counts.items()
              if n and name not in CELL_KERNELS[kernel]}
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
    name = f"{domain}/{strategy}" + ("" if kernel == "pallas" else f" {kernel}")
    batch = (data["train"].batches[0] if cfg.task_type == "graph_classification"
             else data["train"].graph)
    expected = CELL_LAUNCHES[kernel][(domain, strategy)]
    ok = bool(launched == expected and not others and math.isfinite(loss)
              and abs(loss - twin_loss) <= TRAIN_LOSS_TOL * abs(twin_loss)
              and g_err <= TRAIN_GRAD_TOL * g_max and g_l2_err <= TRAIN_GRAD_TOL
              and head_l2_err <= TRAIN_GRAD_TOL
              and sum(flips) <= RELU_FLIP_SHARE * units
              and p_err <= 0.05
              and clear_count > 100 and moved > 0.5 and stats_moved)
    emit({"phase": "train", "cell": name, "nodes_pad": batch.num_nodes,
          "kernel": CELL_KERNELS[kernel], "launches_fwd_bwd": list(launched),
          "other_launches": others, "expected": list(expected), "loss": loss,
          "twin": TWIN[kernel], "loss_twin": twin_loss,
          "grad_max_err_over_max": g_err / g_max,
          "grad_l2_err_over_l2": g_l2_err,
          "head_grad_l2_err_over_l2": head_l2_err, "grad_tol": TRAIN_GRAD_TOL,
          "relu_units": units, "relu_flips_replayed": sum(flips),
          "param_mean_err_over_lr": p_err,
          "params_with_clear_grad": clear_count, "param_moved_over_lr": moved,
          "trainable_leaves": len(grads), "ok": ok})
    if not ok:
        raise AssertionError(f"train step {name} failed its checks")
    return name, (lambda: train(*args)), batch.to(device)


def train_phase(device, processed_dir: Path, kernel: str = "pallas"):
    """name -> step() and name -> the step's padded graph, per train cell."""
    cells = [train_cell(domain, strategy, processed_dir, device, kernel)
             for domain, strategy in CELL_LAUNCHES[kernel]]
    return ({name: step for name, step, _ in cells},
            {name: batch for name, _, batch in cells})


def entry_phase(processed_dir: Path, out_root: Path, cells=ENTRY_CELLS,
                aggregation: str = "pallas") -> None:
    """finetune() end to end: finite losses, the metric keys, the best
    checkpoint on disk and reloaded for the test pass."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune.finetune import finetune
    from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint

    for domain, strategy, epochs in cells:
        cfg = config.FinetuneConfig(domain, strategy, CELL_SCHEME[aggregation], 42)
        t0 = time.perf_counter()
        result = finetune(cfg, aggregation=aggregation, processed_dir=processed_dir,
                          epochs=epochs, out_root=out_root)
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
                  and 1 <= ckpt["meta"]["epoch"] <= epochs)
        emit({"phase": "entry", "cell": cfg.run_name, "aggregation": aggregation,
              "epochs": epochs, "seconds": seconds,
              "train_steps": sum("train/loss" in r for r in rows),
              "best_epoch": ckpt["meta"]["epoch"], "test_loss": result["test/loss"],
              "test_accuracy": result["test/accuracy"],
              "steps_per_sec": result["test/steps_per_sec"], "ok": ok})
        if not ok:
            raise AssertionError(f"finetune() on {cfg.run_name} failed its checks")


def write_pretrain_stores(processed_dir: Path, entry_dir: Path) -> None:
    """Seeded synthetic stores of the pretrain-only datasets at their real
    sizes, with graph properties (MUTAG 188 graphs of ~17.9 nodes, PROTEINS
    1113 of ~39.1, NCI1 4110 of ~29.9); ENZYMES is write_stores' store. In
    ``entry_dir`` the entry epochs' stores: all four datasets cut to
    1/ENTRY_STORE_SHARE of their graphs, of the same sizes."""
    from gnn_pretraining_tpu_torch.data.batch import GraphStore
    from gnn_pretraining_tpu_torch.data.synthetic import (
        PRETRAIN_SIZES,
        synthetic_pretrain_store,
    )

    rng = np.random.default_rng(SEED + 3)
    sizes = {}
    for name in ("MUTAG", "PROTEINS", "NCI1"):
        synthetic_pretrain_store(name, rng).save(processed_dir / f"{name}.npz")
    for name, (graphs, _, _) in PRETRAIN_SIZES.items():
        synthetic_pretrain_store(name, rng, graphs // ENTRY_STORE_SHARE).save(
            entry_dir / f"{name}.npz")
    for where, root in (("full", processed_dir), ("entry", entry_dir)):
        for name in PRETRAIN_SIZES:
            store = GraphStore.load(root / f"{name}.npz")
            sizes[f"{name} {where}"] = {
                "graphs": store.num_graphs, "nodes": int(store.node_offsets[-1]),
                "directed_edges": int(store.edge_offsets[-1]),
                "train": len(store.splits["train"]), "val": len(store.splits["val"])}
    emit({"phase": "pretrain", "stores": sizes, "entry_store_share": 1 / ENTRY_STORE_SHARE})


def pretrain_loader(processed_dir: Path, scheme: str = PRETRAIN_SCHEME):
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.data.loaders import create_pretrain_train_loader

    cfg = config.PretrainConfig(scheme, 42)
    return cfg, create_pretrain_train_loader(cfg.pretrain_domains,
                                             np.random.default_rng(SEED), processed_dir)


def ntxent_shapes(processed_dir: Path) -> dict:
    """K2 rows -> where the pretrain path meets them: 2 x the node pad of each
    domain's train and val batches (node contrast), 2 x the graphs of a train
    and a val batch (graph contrast), and a multi-tile row count. Train rows
    run all three kernels; val rows (eval, no gradient) the forward only."""
    from gnn_pretraining_tpu_torch.data.loaders import create_pretrain_val_loader

    cfg, loader = pretrain_loader(processed_dir)
    rows = {}

    def add(r, of):
        if of not in rows.setdefault(r, []):
            rows[r].append(of)

    add(2 * loader.samples_per_domain, "train graph_contrast")
    for domain in cfg.pretrain_domains:
        add(2 * loader.pads[domain][0], f"train {domain} node_contrast")
    _, b4 = pretrain_loader(processed_dir, "b4")
    add(2 * b4.samples_per_domain, "train b4 graph_contrast")
    add(2 * b4.pads["ENZYMES"][0], "train b4 ENZYMES node_contrast")
    for domain in cfg.pretrain_domains:
        val = create_pretrain_val_loader(domain, processed_dir)[0]
        add(2 * val.num_nodes, f"val {domain} node_contrast")
        add(2 * val.num_graphs, "val graph_contrast")
    add(NTXENT_MULTI_TILE_ROWS, "multi-tile")
    emit({"phase": "ntxent", "rows": [{"rows": r, "of": of} for r, of in rows.items()]})
    return rows


def ntxent_inputs(rng, rows: int, device):
    """Ẑ [rows, 128] (normalized, invalid rows zeroed), validity and τ: node
    pairs valid with NTXENT_VALID_SHARE, graph rows (16) all valid."""
    from gnn_pretraining_tpu_torch.ops import ntxent

    n = rows // 2
    z = [torch.from_numpy(rng.normal(size=(n, 128)).astype(np.float32)).to(device)
         for _ in range(2)]
    share = 1.0 if rows <= 16 else NTXENT_VALID_SHARE
    valid = torch.from_numpy((rng.random(n) < share).astype(np.float32)).to(device)
    zhat, vv, _ = ntxent._prep(z[0], z[1], valid)
    return zhat, vv, torch.tensor([0.37], device=device), z, valid


def ntxent_kernel_phase(device, shapes, ptxas) -> dict:
    """Each K2 kernel against its plain version on the same inputs; the
    backward takes the plain forward's mx and den, so each kernel is held
    alone. A second call on the same inputs must give the same bits. Prints
    each K2 kernel's ptxas registers and each launch's grid."""
    from gnn_pretraining_tpu_torch.ops import _build, ntxent

    lib = _build.library()
    resident = {name: lib.ntxent_blocks_per_sm(backward, device.index or 0)
                for backward, name in enumerate(K2_COUNTERS)}
    emit({"phase": "ntxent", "blocks_per_sm": resident,
          "ptxas": [{k: row.get(k) for k in ("kernel", "registers", "smem_bytes",
                                             "stack_bytes", "spill_stores")}
                    for row in ptxas if row["source"] == "ntxent.cu"]})
    if min(resident.values()) < ntxent.BLOCKS_PER_SM:
        raise AssertionError(f"K2 blocks resident per SM {resident}, the plan assumes "
                             f"{ntxent.BLOCKS_PER_SM}")
    rng = np.random.default_rng(SEED + 4)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    errors = {}
    for rows in shapes:
        zhat, vv, temp, _, _ = ntxent_inputs(rng, rows, device)
        g = (0.8 * vv).contiguous()
        loss, mx, den = ntxent.ntxent_fwd(zhat, vv, temp)
        again = ntxent.ntxent_fwd(zhat, vv, temp)
        ref_loss, ref_mx, ref_den = ntxent.ntxent_fwd_reference(zhat, vv, temp)
        dz = ntxent.ntxent_bwd(zhat, vv, temp, ref_mx, ref_den, g)
        dz_again = ntxent.ntxent_bwd(zhat, vv, temp, ref_mx, ref_den, g)
        ref_dz = ntxent.ntxent_bwd_reference(zhat, vv, temp, ref_mx, ref_den, g)
        torch.cuda.synchronize()
        tiles, chunks, per = ntxent.plan(rows, sms)
        grid = {"row_tiles": tiles, "chunks": chunks, "tiles_per_chunk": per,
                "blocks": tiles * chunks}
        same = all(torch.equal(a, b) for a, b in zip((loss, mx, den), again))
        keep = vv > 0
        total, ref_total = float((loss * vv).sum()), float((ref_loss * vv).sum())
        loss_rel = abs(total - ref_total) / abs(ref_total)
        row_err = float((loss - ref_loss)[keep].abs().max())
        row_rel = row_err / float(ref_loss[keep].abs().max())
        den_rel = float(((den - ref_den).abs() / ref_den)[keep].max())
        ok = bool(loss_rel <= NTXENT_LOSS_TOL and row_rel <= NTXENT_LOSS_TOL
                  and den_rel <= NTXENT_LOSS_TOL and torch.isfinite(loss).all()
                  and torch.equal(mx[keep] >= -1e29, ref_mx[keep] >= -1e29) and same
                  and (rows < 400 or grid["blocks"] >= sms))
        emit({"phase": "ntxent", "kernel": "ntxent_fwd", "rows": rows, "d": 128, **grid,
              "valid_rows": int(keep.sum()), "loss_sum_rel_err": loss_rel,
              "row_loss_max_abs_err": row_err, "row_loss_max_rel_err": row_rel,
              "den_max_rel_err": den_rel, "tol": NTXENT_LOSS_TOL, "bitwise_repeat": same,
              "ok": ok})
        if not ok:
            raise AssertionError(f"K2 fwd at {rows} rows: loss {loss_rel}, rows {row_rel}, "
                                 f"den {den_rel}, repeat equal {same}, grid {grid}")
        errors[("ntxent_fwd", rows)] = row_err
        abs_err = float((dz - ref_dz).abs().max())
        rel = abs_err / float(ref_dz.abs().max())
        same = torch.equal(dz, dz_again)
        ok = bool(rel <= NTXENT_GRAD_TOL and torch.isfinite(dz).all() and same)
        emit({"phase": "ntxent", "kernel": "ntxent_bwd", "rows": rows, "d": 128, **grid,
              "max_abs_err": abs_err, "max_rel_err": rel, "tol": NTXENT_GRAD_TOL,
              "bitwise_repeat": same, "ok": ok})
        if not ok:
            raise AssertionError(f"ntxent_bwd at {rows} rows: relative error {rel}, "
                                 f"repeat equal {same}")
        errors[("ntxent_bwd", rows)] = abs_err
    return errors


K2_COUNTERS = ("ntxent_fwd", "ntxent_bwd")


def counters() -> dict:
    """name -> the launch-counting wrapper of every kernel of the port."""
    from gnn_pretraining_tpu_torch.ops import ntxent
    from gnn_pretraining_tpu_torch.ops.spmm import gin_spmm_bwd, gin_spmm_fwd
    from gnn_pretraining_tpu_torch.ops.spmm_csr import csr_spmm_bwd, csr_spmm_fwd

    return {"gin_spmm_fwd": gin_spmm_fwd, "gin_spmm_bwd": gin_spmm_bwd,
            **{name: getattr(ntxent, name) for name in K2_COUNTERS},
            "csr_spmm_fwd": csr_spmm_fwd, "csr_spmm_bwd": csr_spmm_bwd}


def step_draws(cfg, batches, device):
    """One set of every draw a train step of ``cfg`` makes, on the card: the
    contrastive tasks' views, masking's node scores and link prediction's
    negative-sampling uniforms, each in the tasks' call order (per task,
    domains sorted), and PCGrad's task order (the sorted names reversed)."""
    from gnn_pretraining_tpu_torch.ops.sampling import draw_negatives
    from gnn_pretraining_tpu_torch.pretrain.augmentations import create_two_views

    generator = torch.Generator(device=device).manual_seed(SEED)
    domains = sorted(batches)
    views = [create_two_views(batches[d], generator) for t in cfg.active_tasks
             if t in ("node_contrast", "graph_contrast") for d in domains]
    masks = [torch.rand(batches[d].num_nodes, generator=generator, device=device)
             for d in domains] if "node_feat_mask" in cfg.active_tasks else []
    negatives = [draw_negatives(batches[d].num_edges, generator, device)
                 for d in domains] if "link_pred" in cfg.active_tasks else []
    main = [t for t in cfg.active_tasks if t != "domain_adv"]
    return views, masks, negatives, list(range(len(main)))[::-1]


def make_step(cfg, aggregation, device, total_steps, draws, model=None):
    """(model, train_step, state, labels, lrs) for ``cfg`` with ``draws``
    (step_draws) injected; the weights of ``model`` when given."""
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer
    from gnn_pretraining_tpu_torch.pretrain.tasks import TaskDraws

    views, masks, negatives, _ = draws
    twin = pt.build_pretrain_model(cfg, aggregation, device)
    if model is not None:
        twin.load_state_dict(model.state_dict())
    optimizer, labels, lrs = create_task_specific_optimizer(twin, cfg.active_tasks)
    source, task_draws = ViewSource(device, seed=SEED), TaskDraws(device, seed=SEED)
    source.inject(views)
    task_draws.inject(masks, negatives)
    step = pt.make_train_step(twin, cfg, optimizer, total_steps, source, draws=task_draws)
    return twin, step, pt.PretrainState(), labels, lrs


def expected_step_keys(cfg) -> set:
    """The metric keys of one JAX train step of ``cfg`` (``update_core`` and
    ``assemble_metrics``, gnn_pretraining_tpu/pretrain/pretrain.py:163-209)."""
    main = [t for t in cfg.active_tasks if t != "domain_adv"]
    keys = {"train/loss/total", "train/gradients/model_grad_norm",
            *(f"train/loss/{t}" for t in cfg.active_tasks),
            *(f"train/loss/{d}" for d in cfg.pretrain_domains),
            *(f"train/loss/{d}/{t}" for d in cfg.pretrain_domains for t in cfg.active_tasks),
            *(f"train/loss_balancer/weight/{t}" for t in main)}
    if len(main) > 1:
        keys |= {"gradient_surgery/total_conflicts", "gradient_surgery/total_projections",
                 "gradient_surgery/conflict_ratio"}
    if "domain_adv" in cfg.active_tasks:
        keys |= {"train/domain_adv/loss", "train/domain_adv/lambda"}
    return keys


def launches_of(scheme: str) -> dict:
    k1, k2 = STEP_LAUNCHES[scheme]
    return {"gin_spmm_fwd": k1, "gin_spmm_bwd": k1, "ntxent_fwd": k2, "ntxent_bwd": k2,
            "csr_spmm_fwd": 0, "csr_spmm_bwd": 0}


def pretrain_step_phase(device, processed_dir: Path, scheme: str = PRETRAIN_SCHEME):
    """One train step of ``scheme`` on K1 + K2 against a dense-f32 twin on the
    plain NT-Xent formula; both get the same batches, views, masks,
    negatives, PCGrad order, dropout draws and ReLU branches. Returns
    (step() for the timing phase, the step's launches)."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.pretrain import tasks
    from gnn_pretraining_tpu_torch.utils import relu_branches

    cfg, loader = pretrain_loader(processed_dir, scheme)
    total_steps = len(loader) * PRETRAIN_ENTRY_EPOCHS
    batches = {d: b.to(device) for d, b in loader.sample_step().items()}
    draws = step_draws(cfg, batches, device)
    perm = draws[-1]
    model, step, state, labels, lrs = make_step(cfg, "pallas", device, total_steps, draws)
    twin, twin_step, twin_state, _, _ = make_step(cfg, "dense", device, total_steps,
                                                  draws, model)

    start = {k: v.clone() for k, v in model.state_dict().items()}
    kernels = counters()
    before = {name: c.launches for name, c in kernels.items()}
    # The twin takes the K1 model's side of every ReLU kink and the winners
    # of every max pool (graph contrast): a max that two nodes reach within
    # rounding would otherwise go to either, and move every gradient below.
    pooled = []
    with relu_branches.record(model) as branches, \
            relu_branches.max_pool(tasks, record=pooled):
        out = step(state, batches, perm=perm)
    launched = {name: c.launches - before[name] for name, c in kernels.items()}
    pooled_entries = sum(int(w.any(0).sum()) for w in pooled)
    config.FUSED_NTXENT = False          # the twin takes the plain formula
    try:
        with relu_branches.replay(twin, branches) as flips, \
                relu_branches.max_pool(tasks, replay=pooled) as pool_flips:
            twin_out = twin_step(twin_state, batches, perm=perm)
    finally:
        config.FUSED_NTXENT = True
    if any(c.launches - before[name] != launched[name] for name, c in kernels.items()):
        raise AssertionError("the dense twin launched K1 or K2")
    torch.cuda.synchronize()

    losses = {t: (float(out[f"train/loss/{t}"]), float(twin_out[f"train/loss/{t}"]))
              for t in cfg.active_tasks}
    names = [n for n, _ in model.named_parameters()]

    def grad_errors(grads, twin_grads):
        """max |diff| / max |twin|, ||diff|| / ||twin|| (all leaves, and the
        heads' alone)."""
        g_max = max(float(g.abs().max()) for g in twin_grads.values())

        def l2_err(prefix=""):
            keys = [n for n in grads if n.startswith(prefix)]
            ref = math.sqrt(sum(float(twin_grads[n].double().pow(2).sum()) for n in keys))
            err = math.sqrt(sum(float((grads[n] - twin_grads[n]).double().pow(2).sum())
                                for n in keys))
            return err / ref

        return {"max": max(float((grads[n] - twin_grads[n]).abs().max())
                           for n in grads) / g_max,
                "l2": l2_err(), "heads_l2": l2_err("heads_")}

    # Per task, before PCGrad: what K1 and K2 change. After PCGrad the
    # combined gradient also carries PCGrad's conflict decisions, a sign test
    # per (leaf, task pair) that rounding can flip where a dot product is
    # near 0: then that leaf's combined gradient moves by up to its own size.
    # So the combined gradient is held in L2 over all leaves and in max over
    # the leaves both sides decided alike; the leaves decided apart must
    # carry no clear gradient (each task's at most 1e-3 of its largest) or
    # agree in their combined gradient as the others do.
    per_task = {t: grad_errors(dict(zip(names, step.last_task_grads[t])),
                               dict(zip(names, twin_step.last_task_grads[t])))
                for t in cfg.active_tasks}
    grads = {n: p.grad for n, p in model.named_parameters()}
    twin_grads = {n: p.grad for n, p in twin.named_parameters()}
    g_max = max(float(g.abs().max()) for g in twin_grads.values())
    combined = grad_errors(grads, twin_grads)
    apart = [n for n, a, b in zip(names, pcgrad_decisions(step.last_task_grads, perm),
                                  pcgrad_decisions(twin_step.last_task_grads, perm))
             if a != b]
    combined["max_decided_alike"] = max(float((grads[n] - twin_grads[n]).abs().max())
                                        for n in names if n not in apart) / g_max
    task_g_max = {t: max(float(g.abs().max()) for g in gs)
                  for t, gs in twin_step.last_task_grads.items()}
    apart_share = max((float(g[names.index(n)].abs().max()) / task_g_max[t]
                       for t, g in twin_step.last_task_grads.items() for n in apart),
                      default=0.0)
    # With more than two tasks a leaf's projected gradient can vanish (one
    # conflict on a scalar leaf such as a layer's eps projects it to 0), and
    # the sign tests after that fall either way on a rounding residue: such
    # a leaf carries a clear gradient but its combined gradient still agrees.
    apart_err = max((float((grads[n] - twin_grads[n]).abs().max()) / g_max for n in apart),
                    default=0.0)
    conflicts = (float(out.get("gradient_surgery/total_conflicts", 0)),
                 float(twin_out.get("gradient_surgery/total_conflicts", 0)))
    # As in the fine-tune cells: AdamW moves an element by ~lr whatever its
    # gradient, so where the gradient is rounding noise the sides may part by
    # up to 2 lr; where it is clear the mean distance stays under 0.05 lr.
    p_err_sum, clear_count, moved = 0.0, 0, 0.0
    params, twin_params = dict(model.named_parameters()), dict(twin.named_parameters())
    with torch.no_grad():
        for n, label in labels.items():
            lr = lrs[label]
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
    units = sum(b.numel() for b in branches)
    expected = launches_of(scheme)
    ok = bool(launched == expected and set(out) == expected_step_keys(cfg)
              and all(math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_TOL * abs(b)
                      for a, b in losses.values())
              and all(e <= TRAIN_GRAD_TOL for errs in per_task.values()
                      for e in errs.values())
              and combined["l2"] <= TRAIN_GRAD_TOL
              and combined["max_decided_alike"] <= TRAIN_GRAD_TOL
              and (apart_share <= 1e-3 or apart_err <= TRAIN_GRAD_TOL)
              and sum(flips) <= RELU_FLIP_SHARE * units
              and p_err <= 0.05 and clear_count > 100 and moved > 0.5 and stats_moved
              and state.opt_step == 1 and state.balancer_step == 1)
    emit({"phase": "pretrain", "step": scheme, "launches": launched,
          "expected": expected,
          "node_pads": {d: b.num_nodes for d, b in batches.items()},
          "losses_k1_k2_vs_dense": losses,
          "grad_norm": float(out["train/gradients/model_grad_norm"]),
          "task_grad_err": per_task, "combined_grad_err": combined,
          "pcgrad_conflicts_k1_k2_vs_dense": conflicts,
          "pcgrad_leaves_decided_apart": apart,
          "decided_apart_grad_over_task_max": apart_share,
          "decided_apart_combined_err": apart_err, "grad_tol": TRAIN_GRAD_TOL,
          "relu_units": units,
          "relu_flips_replayed": sum(flips), "max_pool_calls": len(pool_flips),
          "max_pool_entries": pooled_entries, "max_pool_flips_replayed": sum(pool_flips),
          "param_mean_err_over_lr": p_err, "params_with_clear_grad": clear_count,
          "param_moved_over_lr": moved, "ok": ok})
    if not ok:
        raise AssertionError(f"the {scheme} pretrain step failed its checks")
    return (lambda: step(state, batches, perm=perm)), launched


def checked_step_phase(device, processed_dir: Path, scheme: str) -> None:
    """One train step of ``scheme`` on K1 (and K2): finite losses, the JAX
    step's metric keys, the launch counts."""
    cfg, loader = pretrain_loader(processed_dir, scheme)
    batches = {d: b.to(device) for d, b in loader.sample_step().items()}
    draws = step_draws(cfg, batches, device)
    _, step, state, _, _ = make_step(cfg, "pallas", device, len(loader), draws)
    kernels = counters()
    before = {name: c.launches for name, c in kernels.items()}
    out = step(state, batches, perm=draws[-1])
    torch.cuda.synchronize()
    launched = {name: c.launches - before[name] for name, c in kernels.items()}
    losses = {k: float(v) for k, v in out.items() if k.startswith("train/loss/")}
    ok = bool(launched == launches_of(scheme) and set(out) == expected_step_keys(cfg)
              and all(math.isfinite(v) for v in losses.values()))
    emit({"phase": "pretrain", "step": scheme, "launches": launched,
          "expected": launches_of(scheme), "tasks": list(cfg.active_tasks),
          "losses": {t: losses[f"train/loss/{t}"] for t in cfg.active_tasks},
          "metric_keys": len(out), "ok": ok})
    if not ok:
        raise AssertionError(f"the {scheme} pretrain step failed its checks")


def pcgrad_decisions(task_grads, perm) -> list:
    """PCGrad's conflict decisions per leaf (a tuple, one per task pair), as
    ``pretrain/pcgrad.apply_pcgrad`` takes them: in the order ``perm`` of
    the sorted main tasks, the i-th task's (projected) gradient against each
    earlier one, projected where <g_i, g_j> < 0 and both are nonzero."""
    order = [sorted(t for t in task_grads if t != "domain_adv")[i] for i in perm]
    out = []
    for leaf in range(len(task_grads[order[0]])):
        g = [task_grads[t][leaf].double() for t in order]
        mod, decisions = list(g), []
        for i in range(len(order)):
            for j in range(i):
                dot, nj = float((mod[i] * g[j]).sum()), float((g[j] * g[j]).sum())
                conflict = dot < 0 and bool(mod[i].any()) and nj > 0
                decisions.append(conflict)
                if conflict:
                    mod[i] = mod[i] - dot / nj * g[j]
        out.append(tuple(decisions))
    return out


def jax_tree_top_keys(cfg) -> set:
    """The top-level keys of the JAX package's variable tree for ``cfg``
    (gnn_pretraining_tpu/models/pretrain_model.py:45-63)."""
    shared = {"link_pred", "domain_adv"}
    return {"gnn_backbone", "mask_token", *(f"input_encoders_{d}" for d in cfg.pretrain_domains),
            *(f"heads_{t}" for t in cfg.active_tasks if t in shared),
            *(f"heads_{t}_{d}" for t in cfg.active_tasks if t not in shared
              for d in cfg.pretrain_domains)}


def pretrain_entry_phase(device, entry_dir: Path, out_root: Path, scheme: str) -> float:
    """pretrain() for ``scheme`` on the entry stores, 1 epoch, then finetune()
    on ENZYMES from its checkpoint. Returns the seconds per train step."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune.finetune import build_finetune_model, finetune
    from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain
    from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = config.PretrainConfig(scheme, 42)
    t0 = time.perf_counter()
    result = pretrain(cfg, aggregation="pallas", epochs=PRETRAIN_ENTRY_EPOCHS,
                      processed_dir=entry_dir, out_root=out_root)
    seconds = time.perf_counter() - t0
    log = out_root / "metrics" / config.PRETRAIN_PROJECT_NAME / f"{cfg.run_name}.jsonl"
    rows = [json.loads(line) for line in open(log)]
    train_rows = [r for r in rows if "train/loss/total" in r]
    train_keys = expected_step_keys(cfg) | {"train/system/steps_per_s", "train/progress/epoch"}
    val_keys = {"val/loss/total", *(f"val/loss/{d}/{t}" for d in cfg.pretrain_domains
                                    for t in cfg.active_tasks)}
    if "domain_adv" in cfg.active_tasks:
        val_keys.add("val/domain_adv/loss")
    ckpt = load_checkpoint(result["checkpoint"])
    losses = [r["train/loss/total"] for r in train_rows]
    task_losses = [r[f"train/loss/{t}"] for r in train_rows for t in cfg.active_tasks]

    ft_cfg = config.FinetuneConfig("ENZYMES", "full_finetune", scheme, 42)
    loaded = build_finetune_model(ft_cfg, "pallas", device, out_root)
    kernel = ckpt["params"]["gnn_backbone"]["layers_0"]["mlp_0"]["kernel"]
    transferred = bool(np.array_equal(
        loaded.gnn_backbone.layers[0].gin_conv.nn[0].weight.detach().cpu().numpy(), kernel.T))
    t1 = time.perf_counter()
    ft = finetune(ft_cfg, aggregation="pallas", processed_dir=entry_dir,
                  epochs=1, out_root=out_root)
    ft_seconds = time.perf_counter() - t1
    steps = len(pretrain_loader(entry_dir, scheme)[1]) * PRETRAIN_ENTRY_EPOCHS
    heads = jax_tree_top_keys(cfg)
    ok = bool(train_keys <= set(train_rows[0]) and val_keys <= set(rows[-1])
              and len(train_rows) == steps
              and np.isfinite(losses).all() and np.isfinite(task_losses).all()
              and ckpt["meta"]["epoch"] == 1 and transferred
              and set(ckpt["params"]) == heads
              and {"gnn_backbone", *(f"input_encoders_{d}" for d in cfg.pretrain_domains)}
              == set(ckpt["batch_stats"])
              and np.isfinite(ft["test/loss"]))
    emit({"phase": "pretrain", "entry": cfg.run_name, "stores": str(entry_dir.name),
          "seconds": seconds, "train_steps": len(train_rows),
          "seconds_per_step": seconds / len(train_rows),
          "first_loss": losses[0], "last_loss": losses[-1],
          "val_total": result["best_val_total"],
          "val_domain_adv_loss": rows[-1].get("val/domain_adv/loss"),
          "steps_per_sec": train_rows[-1]["train/system/steps_per_s"],
          "checkpoint_params": sorted(ckpt["params"]),
          "backbone_transferred": transferred, "finetune_cell": ft_cfg.run_name,
          "finetune_seconds": ft_seconds, "finetune_test_loss": ft["test/loss"],
          "finetune_test_accuracy": ft["test/accuracy"], "ok": ok})
    if not ok:
        raise AssertionError(f"pretrain() {scheme} / finetune() from its checkpoint "
                             "failed its checks")
    return seconds / len(train_rows)


class Stopped(Exception):
    """Raised in place of the rest of run B after its epoch-5 resume file."""


def resume_stores(resume_dir: Path) -> dict:
    """The four datasets' stores of phase 8 cut to RESUME_STORE_GRAPHS graphs
    each (drawn as phase 8's are, so with the same graph sizes)."""
    from gnn_pretraining_tpu_torch.data.batch import GraphStore
    from gnn_pretraining_tpu_torch.data.synthetic import (
        PRETRAIN_SIZES,
        synthetic_pretrain_store,
    )

    rng = np.random.default_rng(SEED + 5)
    sizes = {}
    for name in PRETRAIN_SIZES:
        synthetic_pretrain_store(name, rng, RESUME_STORE_GRAPHS).save(resume_dir / f"{name}.npz")
        store = GraphStore.load(resume_dir / f"{name}.npz")
        sizes[name] = {"graphs": store.num_graphs, "nodes": int(store.node_offsets[-1]),
                       "train": len(store.splits["train"]), "val": len(store.splits["val"])}
    return sizes


def tree_equal(a, b) -> bool:
    """Bitwise equality of two restored msgpack trees."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{path}/{key}").items()}
    return {path: tree}


def resume_phase(device, resume_dir: Path, out_root: Path) -> None:
    """Runs A (6 epochs), B (stopped after its epoch-5 resume file) and B'
    (B resumed) of pretrain() s5 at full width on K1 and K2, and checks 1-5
    of the module docstring's resume phase."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer
    from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint
    from gnn_pretraining_tpu_torch.utils.convert import adamw_to_opt_state, model_variables
    from gnn_pretraining_tpu_torch.utils.fidelity import cell_completed, fidelity_block

    t0 = time.perf_counter()
    stores = resume_stores(resume_dir)
    cfg = config.PretrainConfig(RESUME_SCHEME, 42)
    roots = {name: out_root / f"resume_{name}" for name in ("A", "B")}
    run = dict(aggregation="pallas", epochs=RESUME_EPOCHS, processed_dir=resume_dir,
               resume=True)
    kernels = counters()

    def log(name):
        path = roots[name] / "metrics" / config.PRETRAIN_PROJECT_NAME / f"{cfg.run_name}.jsonl"
        return [json.loads(line) for line in open(path)]

    result_a = pt.pretrain(cfg, out_root=roots["A"], **run)
    real_save = pt.save_train_state

    def save_then_stop(*args, **kwargs):
        real_save(*args, **kwargs)
        raise Stopped

    pt.save_train_state = save_then_stop
    try:
        pt.pretrain(cfg, out_root=roots["B"], **run)
        raise AssertionError("run B was not stopped at its first resume file")
    except Stopped:
        pass
    finally:
        pt.save_train_state = real_save
    rows_before = len(log("B"))

    # Check 1: B's file onto a fresh model, optimizer and streams on the card.
    path = roots["B"] / "pretrain" / f"resume_{cfg.run_name}.msgpack"
    saved = load_checkpoint(path)
    model = pt.build_pretrain_model(cfg, "pallas", device)
    optimizer, labels, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    streams = pt.random_streams(cfg, model, device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    counters_b = pt.load_resume_state(path, model, optimizer, cfg, streams)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    variables = model_variables(model)
    restored = {
        "params": tree_equal(variables["params"], saved["params"]),
        "batch_stats": tree_equal(variables["batch_stats"], saved["batch_stats"]),
        "opt_state": tree_equal(adamw_to_opt_state(model, optimizer, labels,
                                                   ["default", *cfg.active_tasks]),
                                saved["opt_state"]),
        "streams": tree_equal(pt.stream_states(streams), saved["extra"]["streams"]),
        "counters": counters_b == saved["counters"],
        "on_card": all(p.device.type == "cuda" and s["exp_avg"].device.type == "cuda"
                       for p, s in optimizer.state.items())
        and all(streams[k].generator.device.type == "cuda"
                for k in ("dropout", "views", "task_draws"))}
    state = pt.PretrainState(counters_b["opt_step"], counters_b["balancer_step"])
    t = time.perf_counter()
    pt.save_resume_state(out_root / "resume_save_timing.msgpack", model, optimizer, cfg, state,
                         streams, counters_b["epoch"], counters_b["best_total"],
                         counters_b["epochs_since_improvement"])
    save_ms = (time.perf_counter() - t) * 1e3
    del model, optimizer, streams

    # B' in this process; its launches alone.
    before = {name: c.launches for name, c in kernels.items()}
    result_b = pt.pretrain(cfg, out_root=roots["B"], **run)
    launched = {name: c.launches - before[name] for name, c in kernels.items()}

    rows_a, rows_b = log("A"), log("B")[rows_before:]
    steps = lambda rows: [r for r in rows if "train/loss/total" in r]  # noqa: E731
    epoch6_a = [r for r in steps(rows_a) if r["train/progress/epoch"] == RESUME_EPOCHS]
    epoch6_b = steps(rows_b)
    steps_per_epoch = len(steps(rows_a)) // RESUME_EPOCHS
    # Check 3: per train step phase 8's counts; the epoch's evaluation runs
    # every (task, domain, val batch) forward once more, without backward.
    k1, k2 = STEP_LAUNCHES[RESUME_SCHEME]
    val_batches = sum(math.ceil(s["val"] / config.PRETRAIN_BATCH_SIZE) for s in stores.values())
    forwards = sum(2 if t in ("node_contrast", "graph_contrast") else 1 for t in cfg.active_tasks)
    contrast = sum(t in ("node_contrast", "graph_contrast") for t in cfg.active_tasks)
    n = len(epoch6_b)
    expected = {"gin_spmm_fwd": n * k1 + val_batches * forwards * config.GNN_NUM_LAYERS,
                "gin_spmm_bwd": n * k1, "ntxent_fwd": n * k2 + val_batches * contrast,
                "ntxent_bwd": n * k2, "csr_spmm_fwd": 0, "csr_spmm_bwd": 0}

    # Check 4: B' against A.
    loss_keys = ["train/loss/total", *(f"train/loss/{t}" for t in cfg.active_tasks)]
    loss_err = max(abs(rb[k] - ra[k]) / abs(ra[k]) for ra, rb in zip(epoch6_a, epoch6_b)
                   for k in loss_keys)
    val_err = abs(rows_b[-1]["val/loss/total"] - rows_a[-1]["val/loss/total"]) / abs(
        rows_a[-1]["val/loss/total"])
    final = {name: load_checkpoint(roots[name] / "pretrain" / f"resume_{cfg.run_name}.msgpack")
             for name in roots}
    pa, pb = leaves(final["A"]["params"]), leaves(final["B"]["params"])
    param_diff = max(float(np.abs(pb[k] - pa[k]).max()) for k in pa)
    param_l2 = math.sqrt(sum(float(((pb[k] - pa[k]).astype(np.float64) ** 2).sum()) for k in pa)
                         / sum(float((pa[k].astype(np.float64) ** 2).sum()) for k in pa))
    budget = config.DEFAULT_LR * RESUME_EPOCHS * steps_per_epoch

    # Check 5: the summary's fidelity block.
    summary_path = (roots["B"] / "metrics" / config.PRETRAIN_PROJECT_NAME
                    / f"{cfg.run_name}.summary.json")
    summary = json.loads(summary_path.read_text())
    completed = cell_completed(summary_path, fidelity_block(
        RESUME_EPOCHS, cfg.seed, "pallas", resume_dir, cfg.pretrain_domains))

    checks = {
        "1_restored_bitwise": restored,
        "2_starts_at_epoch_6": bool(rows_b[0]["_step"] == 5 * steps_per_epoch + 1
                                    and {r["train/progress/epoch"] for r in epoch6_b}
                                    == {RESUME_EPOCHS} and len(epoch6_b) == len(epoch6_a)
                                    == steps_per_epoch and counters_b["epoch"] == 5
                                    and result_b["epochs"] == result_a["epochs"] == RESUME_EPOCHS),
        "3_launches": launched == expected,
        "4_agrees_with_A": bool(loss_err <= RESUME_LOSS_TOL and val_err <= RESUME_LOSS_TOL
                                and param_diff <= RESUME_PARAM_TOL * budget),
        "5_fidelity": bool(summary.get("fidelity/completed") == 1 and completed),
    }
    ok = bool(all(restored.values()) and all(list(checks.values())[1:]))
    emit({"phase": "resume", "scheme": cfg.run_name, "stores": stores,
          "store_graphs": RESUME_STORE_GRAPHS, "steps_per_epoch": steps_per_epoch,
          "epochs": RESUME_EPOCHS, "stopped_after_epoch": counters_b["epoch"],
          "b_prime_first_step": rows_b[0]["_step"], "b_prime_steps": len(epoch6_b),
          "a_epoch6_steps": len(epoch6_a), "launches": launched, "expected": expected,
          "val_batches": val_batches, "epoch6_loss_max_rel_err": loss_err,
          "epoch6_val_total_rel_err": val_err, "loss_tol": RESUME_LOSS_TOL,
          "param_max_abs_diff": param_diff, "param_rel_l2_diff": param_l2,
          "param_budget_lr_x_steps": budget, "param_tol_x_budget": RESUME_PARAM_TOL,
          "best_val_total": {"A": result_a["best_val_total"], "B": result_b["best_val_total"]},
          "fidelity": {k: v for k, v in summary.items() if k.startswith("fidelity/")},
          "save_ms": save_ms, "load_ms": load_ms, "file_bytes": path.stat().st_size,
          "seconds": time.perf_counter() - t0, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError(f"the resume phase failed its checks: {checks}")


def device_ms(fn) -> float:
    """Device time of one call: the median over TIMING_REPS calls of the
    CUDA-event time around it, each call queued behind a ~0.5 ms sleep
    kernel so that the host has launched all of it before the card reaches
    the first event (the host's launch time is not in the number)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def median_ms(fn) -> float:
    """Time of one call as the caller sees it: the median CUDA-event time
    around calls made back to back, the host's launch time included."""
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
    kernels the path launches at that shape); the last is the main row.
    Kernel rows take device time (and the time per call), forwards and
    train steps the time per call."""
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
            "gin_spmm_fwd": (gin_spmm_fwd,
                             lambda: spmm_reference(adj, h, eps, "split"),
                             lambda: torch.addmm(h, adj_f32, h, beta=beta)),
            "gin_spmm_bwd": (gin_spmm_bwd,
                             lambda: spmm_bwd_reference(adj, h, eps, "split"),
                             lambda: torch.addmm(h, adj_f32_t, h, beta=beta)),
        }
        for name in launched_here:
            launch, plain, library = calls[name]
            kernel = lambda: launch(adj, h, eps, "split")  # noqa: E731
            row = {"n": n, "f": f, "of": of, "mode": "split", "adj": "bfloat16",
                   "ms": device_ms(kernel), "call_ms": median_ms(kernel),
                   # One bf16 pass instead of split's two: what the MMAs cost.
                   "bf16_ms": device_ms(lambda: launch(adj, h, eps, "bf16")),
                   "plain_ms": device_ms(plain), "library_ms": device_ms(library),
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
            "call_ms": main["call_ms"], "bf16_ms": main["bf16_ms"],
            "also": [{**{k: e[k] for k in ("n", "of", "ms", "call_ms", "bf16_ms", "plain_ms",
                                           "library_ms",
                                           "bound_ms", "bound_by")},
                      "max_abs_err": errors[(name, e["n"], 256, torch.bfloat16, "split")]}
                     for e in rows[:-1]],
        })
    return {**forward_ms, **step_ms}, kernels


def k2_bound(name: str, rows: int, d: int = 128) -> dict:
    """Least time for one K2 call on the H100 at R = rows: the forward's S =
    ẐẐᵀ is 2 R² d operations; the backward's least work is S once and one
    product (G + Gᵀ)·Ẑ, 4 R² d (G and Gᵀ are elementwise in S); against Ẑ,
    the row vectors and the outputs each moved once. Operations count at the
    card's bf16 tensor-core peak, as K1's do; ``bound_3xtf32_ms`` at the tf32
    peak for the three passes this kernel runs each product in."""
    ops = (2 if name == "ntxent_fwd" else 4) * rows * rows * d
    vectors_in, out = ((1, 3 * rows) if name == "ntxent_fwd"
                       else (4, rows * d))
    nbytes = 4 * (rows * d + vectors_in * rows + 1 + out)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_3xtf32_ms": max(3 * ops / PEAK_TF32_FLOPS * 1e3, t_bytes),
            "operations": ops, "bytes": nbytes}


K2_ROWS = {"ntxent_fwd": {"replaces": "gnn_pretraining_tpu/ops/ntxent_pallas.py:209"},
           "ntxent_bwd": {"replaces": "gnn_pretraining_tpu/ops/ntxent_pallas.py:247 and "
                                      "gnn_pretraining_tpu/ops/ntxent_pallas.py:271"}}


def ntxent_timing_phase(device, shapes, errors, launches):
    """Each K2 call and its plain version at every row count of the ntxent
    phase (no single PyTorch call computes NT-Xent: library_ms null), beside
    the device time of an empty kernel (the floor of a launch; a K2 call is
    two), then the K2 Function against the plain formula, forward +
    backward, from 16 to 8192 rows (the H100 crossover of the dispatch
    threshold). Returns the kernel entries and the crossover."""
    from gnn_pretraining_tpu_torch.ops import _build, ntxent
    from gnn_pretraining_tpu_torch.ops.sddmm import nt_xent_loss

    lib, stream = _build.library(), torch.cuda.current_stream(device).cuda_stream

    def empty():
        _build.check(lib.ntxent_launch_floor(device.index or 0, stream), "ntxent_launch_floor")

    floor = {"launch_floor_ms": device_ms(empty), "launch_floor_call_ms": median_ms(empty)}
    emit({"phase": "timing", "kernel": "empty", **floor})
    rng = np.random.default_rng(SEED + 5)
    timed_rows = sorted(shapes)
    trained = {r for r in timed_rows
               if any(o.startswith("train") or o == "multi-tile" for o in shapes[r])}
    entries = {name: [] for name in K2_ROWS}
    for rows in timed_rows:
        zhat, vv, temp, _, _ = ntxent_inputs(rng, rows, device)
        g = (0.8 * vv).contiguous()
        _, mx, den = ntxent.ntxent_fwd_reference(zhat, vv, temp)
        calls = {
            "ntxent_fwd": (lambda: ntxent.ntxent_fwd(zhat, vv, temp),
                           lambda: ntxent.ntxent_fwd_reference(zhat, vv, temp)),
            "ntxent_bwd": (lambda: ntxent.ntxent_bwd(zhat, vv, temp, mx, den, g),
                           lambda: ntxent.ntxent_bwd_reference(zhat, vv, temp, mx, den, g)),
        }
        for name, (kernel, plain) in calls.items():
            if name != "ntxent_fwd" and rows not in trained:
                continue                       # eval runs the forward only
            row = {"rows": rows, "d": 128, "of": shapes[rows], "ms": device_ms(kernel),
                   "call_ms": median_ms(kernel), "plain_ms": device_ms(plain),
                   "library_ms": None, **floor,
                   "max_abs_err": errors[(name, rows)], **k2_bound(name, rows)}
            emit({"phase": "timing", "kernel": name, **row})
            entries[name].append(row)

    crossover = []
    for rows in sorted({*timed_rows, *CROSSOVER_ROWS}):
        _, _, temp, (z1, z2), valid = ntxent_inputs(rng, rows, device)
        a, b = z1.clone().requires_grad_(), z2.clone().requires_grad_()
        row = {"rows": rows}
        for label, fn in (("fused_ms", ntxent.nt_xent), ("formula_ms", nt_xent_loss)):
            row[label] = median_ms(lambda: fn(a, b, temp, valid)[0].backward())
        row["formula_over_fused"] = row["formula_ms"] / row["fused_ms"]
        emit({"phase": "timing", "ntxent_crossover": row})
        crossover.append(row)

    kernels = []
    for name, rows in entries.items():
        # The largest s2 train node pad, where both calls run every step.
        main = max((e for e in rows if any(o.startswith("train") and "b4" not in o
                                           for o in e["of"])),
                   key=lambda e: e["rows"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gnn_pretraining_tpu_torch/csrc/ntxent.cu",
            "replaces": K2_ROWS[name]["replaces"],
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "bound_3xtf32_ms": main["bound_3xtf32_ms"], **floor,
            "at": {"rows": main["rows"], "d": 128, "of": main["of"]},
            "call_ms": main["call_ms"],
            "also": [{k: e[k] for k in ("rows", "of", "ms", "call_ms", "plain_ms", "bound_ms",
                                        "bound_by", "max_abs_err")}
                     for e in rows if e is not main],
        })
    return kernels, crossover


def csr_cases(processed_dir: Path) -> list:
    """K3's check shapes: per case its BlockCSR (on the CPU), the feature
    width, the edges in the tiles' labelling (for the COO reference and the
    library call), whether K1 is compared on it and whether it is timed."""
    from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays
    from gnn_pretraining_tpu_torch.finetune.runners import csr_graph_aux
    from gnn_pretraining_tpu_torch.ops.spmm_csr import (
        build_block_csr,
        synthetic_banded_edges,
    )

    rng = np.random.default_rng(SEED + 6)
    cases = []

    def add(label, bsr, f, s, r, m, k1=False, timed=False):
        cases.append({"label": label, "bsr": bsr, "f": f, "edges": (s, r, m),
                      "k1": k1, "timed": timed})

    for domain in ("Cora_NC", "Cora_LP"):
        g = create_finetune_arrays(domain, "train", -1, CSR_STORES).graph
        graph, bsr, _ = csr_graph_aux(g)
        add(f"{domain} x6 after RCM", bsr, 256, graph.senders.numpy(),
            graph.receivers.numpy(), graph.edge_mask.numpy(), timed=domain == "Cora_NC")
    b = CSR_BANDED
    s, r = synthetic_banded_edges(b["n"], b["e"], b["band"], np.random.default_rng(0))
    m = np.ones(b["e"], np.float32)
    add(f"banded {b['n']}", build_block_csr(s, r, m, b["n"]), 256, s, r, m, timed=True)
    c = CSR_RAGGED
    s = rng.integers(0, c["reach"], c["e"]).astype(np.int32)
    r = rng.integers(0, c["reach"], c["e"]).astype(np.int32)
    m = np.ones(c["e"], np.float32)
    add(f"ragged {c['n']}, empty tile rows", build_block_csr(s, r, m, c["n"]), c["f"], s, r, m)
    c = CSR_PADDED
    s = rng.integers(0, c["n"], c["e"]).astype(np.int32)
    r = rng.integers(0, c["n"], c["e"]).astype(np.int32)
    m = np.ones(c["e"], np.float32)
    m[rng.choice(c["e"], c["masked"], replace=False)] = 0.0
    add(f"{c['n']} nodes, pad_to {c['pad_to']}",
        build_block_csr(s, r, m, c["n"], pad_to=c["pad_to"]), c["f"], s, r, m)
    g = create_finetune_arrays("Cora_NC", "train", -1, processed_dir).graph
    s, r, m = g.senders.numpy(), g.receivers.numpy(), g.edge_mask.numpy()
    add(f"Cora {g.num_nodes} (K1's graph)", build_block_csr(s, r, m, g.num_nodes), 256,
        s, r, m, k1=True)
    emit({"phase": "csr", "cases": [{"case": c["label"], "nodes": c["bsr"].num_nodes,
                                     "nnz": c["bsr"].nnz,
                                     "longest_row": int(c["bsr"].indptr.diff().max()),
                                     "longest_row_t": int(c["bsr"].indptr_t.diff().max()),
                                     "tiles": c["bsr"].nnzb,
                                     "tiles_t": int(c["bsr"].vals_t.shape[0]),
                                     "f": c["f"]} for c in cases]})
    return cases


def csr_kernel_phase(device, cases) -> dict:
    """K3 fwd and bwd against their plain version and the tile oracle in
    every mode, K3 against K1 on K1's graph, and the Function's dH and d-eps
    against autograd through the COO f32 aggregation."""
    from gnn_pretraining_tpu_torch.ops.spmm import (
        build_dense_adjacency,
        gin_aggregate_coo,
        gin_spmm_bwd,
        gin_spmm_fwd,
    )
    from gnn_pretraining_tpu_torch.ops.spmm_csr import (
        csr_edges_reference,
        csr_matvec_reference,
        csr_spmm_bwd,
        csr_spmm_fwd,
        spmm_csr,
    )

    rng = np.random.default_rng(SEED + 7)
    errors = {}
    for case in cases:
        label, f, host = case["label"], case["f"], case["bsr"]
        bsr = host.to(device)                   # the edge CSRs; tiles stay
        n = bsr.num_nodes
        h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        eps = torch.tensor([-0.2], device=device)
        s, r, m = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in case["edges"])
        adj = (build_dense_adjacency(s, r, m, n, dtype=torch.bfloat16)
               if case["k1"] else None)
        pairs = {"csr_spmm_fwd": (csr_spmm_fwd, (bsr.indptr, bsr.indices, bsr.data),
                                  (host.vals, host.rows, host.cols), gin_spmm_fwd),
                 "csr_spmm_bwd": (csr_spmm_bwd, (bsr.indptr_t, bsr.indices_t, bsr.data_t),
                                  (host.vals_t, host.rows_t, host.cols_t), gin_spmm_bwd)}
        for name, (kernel, edges, tiles, k1) in pairs.items():
            tiles = [t.to(device) for t in tiles]
            for mode, tol in KERNEL_TOL.items():
                out = kernel(bsr, h, eps, mode)
                ref = csr_edges_reference(*edges, h, eps, mode)
                scale = float(ref.abs().max())
                tile_rel = float((out - csr_matvec_reference(*tiles, h, eps, mode, n))
                                 .abs().max()) / scale
                k1_rel = (float((out - k1(adj, h, eps, mode)).abs().max()) / scale
                          if adj is not None else None)
                torch.cuda.synchronize()
                abs_err = float((out - ref).abs().max())
                rel = abs_err / scale
                ok = bool(rel <= tol and tile_rel <= tol and torch.isfinite(out).all()
                          and (k1_rel is None or k1_rel <= tol))
                emit({"phase": "csr", "kernel": name, "case": label, "n": n, "f": f,
                      "nnz": bsr.nnz, "tiles": host.nnzb, "mode": mode,
                      "max_abs_err": abs_err, "max_rel_err": rel,
                      "tile_oracle_max_rel_diff": tile_rel, "k1_max_rel_diff": k1_rel,
                      "tol": tol, "ok": ok})
                if not ok:
                    raise AssertionError(f"{name} {mode} on {label}: relative error {rel}, "
                                         f"against the tiles {tile_rel}, against K1 "
                                         f"{k1_rel} > {tol}")
                errors[(name, label, mode)] = abs_err

        # The Function's wiring: dH from K3 over the CSR of Aᵀ, d-eps from
        # the reduction, against autograd through the COO aggregation.
        up = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        grads = []
        for aggregate in (lambda h_, e_: spmm_csr(bsr, h_, e_, "highest"),
                          lambda h_, e_: gin_aggregate_coo(h_, s, r, m, e_)):
            h_, e_ = h.clone().requires_grad_(), eps.clone().requires_grad_()
            aggregate(h_, e_).backward(up.t().contiguous().t())   # a strided gradient
            grads.append((h_.grad, e_.grad))
        torch.cuda.synchronize()
        (dh, de), (dh_ref, de_ref) = grads
        rel_h = float((dh - dh_ref).abs().max() / dh_ref.abs().max())
        rel_e = float((de - de_ref).abs().max() / de_ref.abs().max())
        ok = rel_h <= FUNCTION_TOL and rel_e <= FUNCTION_TOL
        emit({"phase": "csr", "function": "spmm_csr", "case": label, "n": n, "f": f,
              "dh_max_rel_err": rel_h, "deps_max_rel_err": rel_e, "tol": FUNCTION_TOL,
              "ok": ok})
        if not ok:
            raise AssertionError(f"spmm_csr Function on {label}: dH {rel_h}, d-eps {rel_e}")
    return errors


def csr_bound(nnz: int, n: int, f: int) -> dict:
    """Least time for split-mode K3 on the H100, counted by this graph's
    nonzeros: H read and out written once (8 N F bytes), each nonzero's index
    and value (8 nnz) and indptr (4 (N + 1)), against 4 nnz F operations (a·hi
    + a·lo per nonzero and feature) at the tensor-core peak, as K1's and K2's
    (``bound_f32_simt_ms`` at the f32 peak, where this kernel runs them)."""
    ops = 4 * nnz * f
    nbytes = 8 * n * f + 8 * nnz + 4 * (n + 1)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_f32_simt_ms": max(ops / PEAK_F32_FLOPS * 1e3, t_bytes),
            "operations": ops, "bytes": nbytes}


K3_ROWS = {name: {"replaces": "gnn_pretraining_tpu/ops/spmm_csr.py:205",
                  "library_call": f"torch.sparse.addmm({x}, {a}, {x}, beta=1+eps), "
                                  f"{a} a sparse CSR tensor (cuSPARSE)"}
           for name, x, a in (("csr_spmm_fwd", "h", "A"), ("csr_spmm_bwd", "g", "A^T"))}


def csr_timing_phase(device, cases, errors, launches) -> list:
    """K3 fwd and bwd at the timed cases (the main row is Cora_NC x6 after
    RCM): device time of the kernel (and its time per call), its plain
    version and one cuSPARSE call for the same function, beside the bound."""
    from gnn_pretraining_tpu_torch.ops.spmm_csr import (
        csr_edges_reference,
        csr_spmm_bwd,
        csr_spmm_fwd,
    )

    rng = np.random.default_rng(SEED + 8)
    entries = {name: [] for name in K3_ROWS}
    for case in (c for c in cases if c["timed"]):
        host, f = case["bsr"], case["f"]
        bsr = host.to(device)
        n = bsr.num_nodes
        h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(device)
        eps = torch.tensor([0.1], device=device)
        beta = 1.0 + 0.1
        s, r, m = (torch.from_numpy(np.ascontiguousarray(a)).to(device).long()
                   for a in case["edges"])

        def csr_matrix(dst, src):
            return torch.sparse_coo_tensor(torch.stack([dst, src]), m.float(), (n, n)
                                           ).coalesce().to_sparse_csr()

        a_csr, a_t_csr = csr_matrix(r, s), csr_matrix(s, r)     # made outside the timing
        calls = {
            "csr_spmm_fwd": (lambda: csr_spmm_fwd(bsr, h, eps, "split"),
                             lambda: csr_edges_reference(bsr.indptr, bsr.indices, bsr.data,
                                                         h, eps, "split"),
                             lambda: torch.sparse.addmm(h, a_csr, h, beta=beta)),
            "csr_spmm_bwd": (lambda: csr_spmm_bwd(bsr, h, eps, "split"),
                             lambda: csr_edges_reference(bsr.indptr_t, bsr.indices_t,
                                                         bsr.data_t, h, eps, "split"),
                             lambda: torch.sparse.addmm(h, a_t_csr, h, beta=beta)),
        }
        for name, (kernel, plain, library) in calls.items():
            got, want = kernel(), library()
            torch.cuda.synchronize()
            lib_rel = float((got - want).abs().max() / want.abs().max())
            if lib_rel > KERNEL_TOL["split"]:
                raise AssertionError(f"{name} and cuSPARSE part on {case['label']}: {lib_rel}")
            tiles = host.nnzb if name == "csr_spmm_fwd" else int(host.vals_t.shape[0])
            row = {"case": case["label"], "n": n, "f": f, "nnz": bsr.nnz, "tiles": tiles,
                   "mode": "split", "ms": device_ms(kernel), "call_ms": median_ms(kernel),
                   "plain_ms": device_ms(plain), "library_ms": device_ms(library),
                   "library_call": K3_ROWS[name]["library_call"],
                   "library_max_rel_diff": lib_rel,
                   "max_abs_err": errors[(name, case["label"], "split")],
                   **csr_bound(bsr.nnz, n, f)}
            emit({"phase": "timing", "kernel": name, **row})
            entries[name].append(row)

    kernels = []
    for name, rows in entries.items():
        main, *also = rows                      # Cora_NC x6 first, as in ``cases``
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gnn_pretraining_tpu_torch/csrc/spmm_csr.cu",
            "replaces": K3_ROWS[name]["replaces"],
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "bound_f32_simt_ms": main["bound_f32_simt_ms"],
            "at": {k: main[k] for k in ("case", "n", "f", "nnz", "tiles", "mode")},
            "call_ms": main["call_ms"],
            "also": [{k: e[k] for k in ("case", "nnz", "tiles", "ms", "call_ms", "plain_ms",
                                        "library_ms", "bound_ms", "bound_by", "max_abs_err")}
                     for e in also],
        })
    return kernels


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
        # K1's tile kernels and, where it splits the contraction, its sums.
        k1 = {d: sum(ms for key, ms, _ in kernels if f"gin_spmm_{d}_" in key)
              for d in ("fwd", "bwd")}
        k2 = sum(ms for key, ms, _ in kernels if "ntxent_" in key and "_kernel" in key)
        k3 = sum(ms for key, ms, _ in kernels if "csr_spmm_kernel" in key)
        emit({"phase": "profile", "call": name, "event_ms": event_ms[name],
              "device_busy_ms": busy if kernels else None,
              "k1_fwd_device_ms": k1["fwd"] if kernels else None,
              "k1_bwd_device_ms": k1["bwd"] if kernels else None,
              "k2_device_ms": k2 if kernels else None,
              "k3_device_ms": k3 if kernels else None,
              "idle_share": 1 - busy / event_ms[name] if kernels else None,
              "kernels_per_call": sum(c for _, _, c in kernels),
              "top": [[key[:60], ms, c] for key, ms, c in kernels[:6]]})


def main() -> int:
    t0 = time.perf_counter()
    card = device_phase()
    import_port()
    ptxas = build_phase()
    device = torch.device("cuda")
    kernels = counters()

    def run_path(drive):
        """Drive one path with every launch count set to 0 just before it;
        returns what it returns and the counts read just after."""
        for c in kernels.values():
            c.launches = 0
        out = drive()
        return out, {name: c.launches for name, c in kernels.items()}

    seconds = {}

    def clocked(name, fn):
        t = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t
        return out

    def pretrain_tasks_path():
        """The schemes past s2: a twin-checked step each of s5 and b4, a
        checked step each of b2, s1, s3, s4, pretrain() s5 and finetune()
        from its checkpoint."""
        twin_steps, per_step = {}, {}
        for scheme in TWIN_SCHEMES[1:]:
            twin_steps[f"pretrain {scheme}"], per_step[scheme] = clocked(
                f"{scheme} step", lambda: pretrain_step_phase(device, processed_dir, scheme))
        for scheme in CHECKED_SCHEMES:
            clocked(f"{scheme} step", lambda: checked_step_phase(device, processed_dir, scheme))
        per_step["s5 entry s/step"] = clocked("s5 entry", lambda: pretrain_entry_phase(
            device, entry_dir, out_root, "s5"))
        return twin_steps, per_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        processed_dir, out_root = Path(tmp) / "processed", Path(tmp) / "out"
        entry_dir = Path(tmp) / "entry"
        processed_dir.mkdir()
        entry_dir.mkdir()
        write_stores(processed_dir)
        write_pretrain_stores(processed_dir, entry_dir)
        errors = kernel_phase(device, kernel_shapes(processed_dir))
        k2_shapes = ntxent_shapes(processed_dir)
        k2_errors = ntxent_kernel_phase(device, k2_shapes, ptxas)
        k3_cases = csr_cases(processed_dir)
        k3_errors = csr_kernel_phase(device, k3_cases)
        (forwards, enz, cora, _), serving = run_path(lambda: slice_phase(device))
        (steps, train_graphs), train = run_path(lambda: (
            train_phase(device, processed_dir), entry_phase(processed_dir, out_root))[0])
        (pretrain_step, _), pretrain = run_path(lambda: (
            clocked("s2 step", lambda: pretrain_step_phase(device, processed_dir, "s2")),
            clocked("s2 entry", lambda: pretrain_entry_phase(device, entry_dir, out_root,
                                                             "s2")))[0])
        (task_steps, per_step), pretrain_tasks = run_path(pretrain_tasks_path)
        emit({"phase": "pretrain", "phase_seconds": seconds,
              "entry_store_share": 1 / ENTRY_STORE_SHARE,
              "entry_seconds_per_step": {"s5": per_step["s5 entry s/step"]}})
        pretrain_graph = max(pretrain_loader(processed_dir)[1].sample_step().values(),
                             key=lambda b: b.num_nodes).to(device)
        b4_graph = pretrain_loader(processed_dir, "b4")[1].sample_step()["ENZYMES"].to(device)
        csr_steps, csr = run_path(lambda: (
            train_phase(device, CSR_STORES, "csr"),
            entry_phase(CSR_STORES, out_root, CSR_ENTRY_CELLS, "csr"))[0][0])
        resume_dir = Path(tmp) / "resume"
        resume_dir.mkdir()
        _, resume = run_path(lambda: clocked("resume", lambda: resume_phase(
            device, resume_dir, out_root)))
    paths = {"serving": serving, "train": train, "pretrain": pretrain,
             "pretrain_tasks": pretrain_tasks, "csr": csr, "resume": resume}
    launches = {name: {path: counts[name] for path, counts in paths.items()}
                for name in kernels}
    k3 = CELL_KERNELS["csr"]
    unlaunched = [name for name in kernels if name not in k3
                  and min(pretrain[name], pretrain_tasks[name], resume[name]) < 1]
    unlaunched += [name for name in k3 if csr[name] < 1]
    if min(serving["gin_spmm_fwd"], train["gin_spmm_fwd"], train["gin_spmm_bwd"]) < 1 \
            or unlaunched:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    strays = {name: [path for path, n in launches[name].items()
                     if n and (path == "csr") != (name in k3)]
              for name in kernels if name in k3 or name in CELL_KERNELS["pallas"]}
    if any(strays.values()):
        raise AssertionError(f"K1 launched on the csr path or K3 off it: {strays}")
    steps[f"pretrain {PRETRAIN_SCHEME}"] = pretrain_step
    steps.update(task_steps)
    steps.update(csr_steps)
    calls = {**forwards, **steps}
    both = ("gin_spmm_fwd", "gin_spmm_bwd")
    timed = (("ENZYMES serving bucket", enz, both[:1]),
             ("ENZYMES train batch", train_graphs["ENZYMES/full_finetune"], both),
             ("pretrain batch, largest pad", pretrain_graph, both),
             ("pretrain b4 batch (32 ENZYMES graphs)", b4_graph, both),
             ("Cora full graph", cora["NC"], both))
    event_ms, k1_kernels = timing_phase(device, forwards, steps, timed, errors,
                                        launches)
    k2_kernels, _ = ntxent_timing_phase(device, k2_shapes, k2_errors, launches)
    k3_kernels = csr_timing_phase(device, k3_cases, k3_errors, launches)
    profile_phase(calls, event_ms)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    for k in k1_kernels + k2_kernels + k3_kernels:
        k["launches_per_s5_step"] = per_step["s5"][k["name"]]
    emit({"kernels": k1_kernels + k2_kernels + k3_kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
