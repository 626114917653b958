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
                on the stores cut to an eighth of their graphs, and
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
 12. drivers -- the sweep drivers through main(argv) on a temporary
                out_root, each cell's seconds and peak card memory:
                (1) the s2 seed-42 pretrain shard (--num_shards 24
                --shard_index 12), 1 epoch on the resume phase's stores,
                launches K1 and K2 fwd and bwd and nothing else; (2) the
                same shard on another out_root, a second cell in the same
                process, peaks within DRIVER_PEAK_TOL of the first's card
                memory; (3) the first command again with --resume launches
                nothing and prints its skip line; (4) run_finetune ENZYMES
                full_finetune b1, 4 epochs, launches K1 fwd and bwd only, and
                its summary holds the fidelity block and both steady rates;
                (5) the same cell from s2, whose pretrain ran 1 epoch, is
                skipped by pretrain_ready with exit code 2 and no launch;
                (6) Cora_NC full_finetune b1 --aggregation csr, 3 epochs on
                the 6x store, launches K3 fwd and bwd and no K1; (7) the JAX
                package's outputs/{pretrain,finetune,metrics} are unchanged
                (listed by path);
 12b. sweep  -- the sweep's process runtime (utils/runtime.py) and the
                artifact exporter, with the runtime's pidfile and pause files
                in a directory of the phase's own: (a) run_pretrain --sweep
                --isolate 1 over 2 cells (b2 and s2 under seed 84, 1 epoch on
                the resume phase's stores): two children on the card, each
                cell's summary complete, each child's wall time, and the
                orchestrator resolves no device and allocates no card
                memory; the same command under --resume starts no child;
                (b) while (a) runs, a requester process calls acquire_chip as
                soon as the first child has recorded itself: the orchestrator
                parks at the boundary before the second child, the paused
                file names it, no child runs while it is parked, and
                release_chip resumes the sweep; a pause file whose owner is
                gone is discarded at once; (c) reclaim_chip terminates a
                recorded sleeping process and leaves alone a process whose
                pidfile holds another start time; (d) an in-process sweep of
                8 cells (s2 and s5 pretrain, ENZYMES and Cora_NC full_finetune
                b1, under seeds 42 and 84, 1 epoch each): host RSS, the
                card's peak allocated and reserved memory after each cell,
                whether maybe_clear_caches cleared, the machine's MemTotal
                beside the clearing bound; (e) two processes of a launcher
                (WORLD_SIZE 2, RANK 0 and 1, LOCAL_RANK 0) split a 4-cell grid
                (b2 under 4 seeds) into grid[0::2] and grid[1::2]; (f) export_artifacts on the
                fine-tune checkpoints of phase 6 and the pretrain checkpoints
                of phase 8 and of (a): the manifest's sha256 and bytes
                recomputed from the files, each serving artifact replayed on
                the card within ARTIFACT_TOL of its eager model;
 12c. dp     -- data parallelism (parallel/, finetune/gc_data_parallel.py)
                on the one card: NCCL refuses two ranks on one device, so
                DP_RANKS processes form a gloo group on cuda:0 over a
                FileStore. Which collectives gloo runs on CUDA tensors. One
                s5 data-parallel step at full width and depth on phase 8's
                stores, each rank on its share of the sampler's draw
                (dp_pads, shard_sampler_step): each rank's K1 and K2
                launches (K2 on the rows gathered over the ranks), and its
                losses, per-task and combined gradients against one process
                stepping on the union of the shares with the same views,
                masks, negatives, PCGrad order, dropout keep-masks and ReLU
                branches (row for row), at the pretrain phase's twin
                tolerances; after a second step on the ranks' own draws
                their parameters and BatchNorm statistics bitwise equal.
                One ENZYMES full_finetune graph-classification step and
                eval step dealt over the ranks against one process on the
                whole batch. The CUDA-event medians of the data-parallel
                steps beside the single process's (the ranks share the
                card). Then run_pretrain --dp auto, s2 for 1 epoch on the
                resume phase's stores: one card, so the single-device path,
                and its summary's fidelity block is the one without --dp;
 12d. partition -- edge- and node-partitioned full-graph fine-tuning
                (parallel/edge_partition.py, parallel/node_partition.py,
                finetune/edge_parallel.py, finetune/node_parallel.py) on
                PART_RANKS gloo ranks on cuda:0, at full width and depth, b1:
                (a) Cora_NC and (b) Cora_LP full_finetune on phase 5's
                stores: one process's coo eval step and train step (its
                keep-masks, ReLU branches and, for LP, the pairs its miner
                drew recorded: equal similarities tie in the hard top-k,
                and rounding breaks the tie), then each rank's eval step and
                train step,
                edge and node, from the same weights with those records
                (a node rank takes its rows): loss, probabilities,
                predictions, gradients, BatchNorm statistics and the
                parameters after AdamW against the single process's at the
                JAX package's tolerances (PART_*_TOL), the ranks bitwise
                equal after a second step on their own draws; (c) Cora_NC on
                the 6x store (16248 nodes): each mode's train-step
                CUDA-event median per rank beside one process's coo step
                and K1 step, the eval loss against the coo one, the plan's
                halo and psum bytes per layer at F = 256 (also at (a) and
                (b)), the all-to-all's route (host-staged: gloo refuses CUDA
                tensors) and K1 / K3 launches (none: the paths run coo);
                (d) run_finetune --partition edge and node against --partition
                none, Cora_NC b1 coo, 2 epochs, no launcher, dropout off: on
                one card the single-device path, the test loss within 5e-4
                and the accuracy equal;
 12e. chunked -- run after phase 15 (profile), on phase 8's stores: the
                chunked pretrain runner (make_chunked_train_step: one CUDA
                graph of the train step per scheme, replayed). For s2, s5
                and b4: the step
                captured, its K1 and K2 launches per step counted at
                capture (and none on replay); one chunk of 8 steps replayed
                against 8 eager steps (make_train_step) of a twin built from
                the same seeds on the same batches and PCGrad orders: every
                view, mask, negative and dropout keep-mask bitwise equal,
                the step-1 losses within CHUNK_LOSS_TOL of max |ref|, every
                packed metric row within TRAIN_LOSS_TOL of the eager
                metrics (PCGrad's conflict and projection counts apart by
                at most its decisions on leaves whose gradient is rounding:
                the biases a BatchNorm follows, ROUNDING_BIASES, and past
                two tasks a projected scalar leaf),
                the parameters after the chunk within phase 8's lr
                distances, the generators' states and the counters equal;
                the CUDA-event median ms per step replayed and eager, with
                device busy and idle share (torch.profiler); pretrain() s5
                for 1 epoch on the entry stores with chunk_steps=32 and
                with chunk_steps=1, seconds per step, the same metric keys
                and finite losses; build_batch's host ms per s5 step,
                numpy beside native. Last in the script: a capture forced
                to fail (a host read inside the captured step) makes the
                runner raise, at capture and when asked for a chunk, and
                trains nothing. Phases 8, 11, 12, 12b, 12c and 13 run
                pretrain() chunked too: its kernels' wrappers count the
                capture's warm-up step and the capture, not the replays;
 13. data    -- the port's offline preprocessing (data/setup.py, host code)
                on this machine, then the kernels driven from the stores it
                made: (1) setup.main at scale 1 without raw files, one
                dataset at a time (each one's seconds), the nine stores held
                against the digests of the JAX package's (SCALE1_DIGESTS:
                integer arrays by SHA-256, float arrays by their moments);
                (2) Cora at 6x scale, equal array for array to the tracked
                data/processed_6x stores; (3) through the drivers' main(argv)
                on a temporary out_root: run_pretrain s2 seed 42 for 1 epoch
                on stores made at scale 0.1 (K1 and K2 fwd and bwd),
                run_finetune ENZYMES full_finetune b1 for 3 epochs on the
                scale-1 store (K1 only) and Cora_NC b1 --aggregation csr for
                1 epoch on the 6x store (K3 and no K1), each at the launch
                counts of DATA_LAUNCHES, each summary's fidelity block
                recording the made stores' source, scale and calibration;
 14. timing  -- device-time medians (each call queued behind a sleep
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
 15. profile -- each serving forward's and train step's device time by kernel
                (torch.profiler) and the share of its time the card idles.
 16. artifacts -- last, so that what it leaves in the process (torch.export, a
                profiler session, anomaly mode) is not in the times above
                (tools/serving_ab.py): the port's artifacts in and out
                (utils/torch_import.py, serving.export_serving,
                export_model.py, --debug_nans):
                (a) the trained Cora_NC model of phase 6 written as a
                reference .pt (the reference's keys and num_batches_tracked,
                torch.save of {epoch, model_state_dict, val_metrics}) and a
                copy cut mid-storage, imported into fresh K1 models: the
                whole file serves as the source model does (5 K1 launches
                each), the cut one recovers what the reader reports, lists
                the rest in missing and leaves those at the fresh values;
                (b) phase 8's s2 checkpoint as a reference pretrain .pt,
                transferred into ENZYMES by the importer (backbone and
                encoder equal), then imported as a port pretrain checkpoint
                under a fresh out_root, where finetune() finds it: the
                cell's model equals the imported one, and finetune() for 1
                epoch runs from it at ARTIFACT_FT_LAUNCHES;
                (c) export_model.main(argv) on the phase-6 checkpoints
                (ENZYMES, Cora_NC, Cora_LP) and, with --embed, on the s2
                one, at the tracked buckets, dense and coo, --platforms
                cuda,cpu: each artifact replayed on the card against the
                eager port model (ARTIFACT_TOL) and eager K1 serving
                (SLICE_TOL), its cpu program on the host, no K1 launch and
                no host-to-device copy in an artifact call; export and load
                seconds, bytes, and the median ms of 30 artifact calls
                beside eager K1 serving; (d) an s2 step under
                enable_nan_checks on a batch with one NaN feature row raises
                FloatingPointError, a clean one gives the unchecked losses;
                then, outside the path's counts, K2-fwd and K2-bwd against
                their plain versions on that step's NT-Xent inputs that hold
                a NaN and on Ẑ with one valid or one invalid row made NaN on
                the card: NaN exactly where the plain version's is (loss, mx,
                den, dẐ), the finite entries within K2's tolerances. A check
                named in KNOWN_FAILURES must fail and the script fails if it
                passes; the list is empty.

The build phase prints every kernel's registers, shared memory and spills
(ptxas) and fails if a kernel of K1, K2 or K3 spills. Then the card's
nvidia-smi line, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failure raises, so the script exits
non-zero and prints no result; it also does so without a CUDA card and
outside a checkout.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

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
# The entry epochs (pretrain() for s2 and s5) run on stores cut to an eighth
# of each dataset's graphs, with the same graph sizes (a quarter until the
# sweep phase came: 56 and 123 s of the script on a slow host).
ENTRY_STORE_SHARE = 8
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
# The drivers phase: the sweep drivers' main(argv) on a temporary out_root.
# The pretrain shard is s2 under seed 42 (grid index 12 of 24), 1 epoch over
# the resume phase's stores. The dense fine-tune cell runs 4 epochs: its
# patience is then 2, so at least 3 epochs run and the summary carries the
# steady rates (from epoch 3 on). A second pretrain cell, the same shard on
# another out_root, must peak within DRIVER_PEAK_TOL of the first's card
# memory: a finished cell's tensors are freed before the next one starts.
DRIVER_SHARD = ["--sweep", "--num_shards", "24", "--shard_index", "12", "--epochs", "1"]
DRIVER_FT_EPOCHS = 4
DRIVER_CSR_EPOCHS = 3
DRIVER_PEAK_TOL = 0.10
STEADY_KEYS = ("test/steady_steps_per_sec", "test/steady_edges_per_sec")
# The sweep phase: the sweep runtime of utils/runtime.py, the drivers'
# --isolate and launcher shard, and the artifact exporter, on the card.
# (a, b) An --isolate 1 sweep of the pretrain grid's shard 1 of 12 (b2 and s2
# under seed 84), 1 epoch each on the resume phase's stores: two children on
# the card, while a requester process asks for the card as soon as the first
# child has recorded itself, with SWEEP_POLL polls and SWEEP_WAIT_S before
# its reclaim fallback; then the same command under --resume. (d) An
# in-process sweep of RSS_PRETRAIN's cells (1 epoch each on the resume
# phase's stores) and RSS_FINETUNE's (full_finetune b1, 1 epoch on the
# phase-5 stores). (e) Two processes of a launcher (WORLD_SIZE 2, RANK 0 and
# 1, LOCAL_RANK 0) over SHARD_GRID's 4 cells, 1 epoch each. (f) The exporter
# on the phase-6 fine-tune and phase-8 pretrain checkpoints (seed 42), then
# on (a)'s (seed 84, which gives the ENZYMES b2 embedding artifact).
SWEEP_ISOLATE = ["--sweep", "--num_shards", "12", "--shard_index", "1", "--epochs", "1",
                 "--isolate", "1"]
SWEEP_ISOLATE_CELLS = ("b2_84", "s2_84")
SWEEP_WAIT_S, SWEEP_POLL = 120.0, 0.2
RSS_PRETRAIN = (("s2", "s5"), (42, 84))           # schemes x seeds
RSS_FINETUNE = (("ENZYMES", "Cora_NC"), (42, 84))  # domains x seeds
SHARD_GRID = (("b2",), (42, 84, 126, 168))        # schemes x seeds
# The data phase: the port's offline preprocessing (data/setup.py) on the
# card's machine, then K1, K2 and K3 driven from the stores it made. The s2
# cell pretrains 1 epoch on stores at scale 0.1: MUTAG, PROTEINS, NCI1 and
# ENZYMES with 18, 111, 411 and 60 graphs (train 16, 99, 369, 48; val 2, 12,
# 42, 6). Launches predicted from the code and these sizes: 369 // 8 = 46
# steps of STEP_LAUNCHES["s2"], then the epoch's evaluation over 5 val batches
# (1, 1, 2, 1) x 2 tasks x (2 views x 5 layers of K1, 1 NT-Xent). The
# ENZYMES b1 cell on the scale-1 store (train 480, val 60, test 60 graphs in
# batches of 32): 15 steps x (5, 4) and 2 val batches x 5 per epoch, then 2
# test batches x 5; its patience is int(3 / 2) = 1, so it may stop after
# epoch 2 and its count is read at the epochs it ran. The csr cell, Cora_NC
# for 1 epoch on the 6x store: one full-graph step (5, 5), one val and one
# test forward (5 each).
DATA_PRETRAIN_SCALE = 0.1
DATA_PRETRAIN_GRAPHS = {"MUTAG": 18, "PROTEINS": 111, "NCI1": 411, "ENZYMES": 60}
DATA_CSR_SCALE = 6.0
DATA_FT_EPOCHS = 3
DATA_CSR_EPOCHS = 1
DATA_S2_VAL_BATCHES = 5   # its 46 train steps replay one captured step
DATA_LAUNCHES = {
    "pretrain s2": lambda epochs: {
        "gin_spmm_fwd": pretrain_step_calls() * 80 + DATA_S2_VAL_BATCHES * 2 * 10,
        "gin_spmm_bwd": pretrain_step_calls() * 80,
        "ntxent_fwd": pretrain_step_calls() * 8 + DATA_S2_VAL_BATCHES * 2,
        "ntxent_bwd": pretrain_step_calls() * 8},
    "finetune ENZYMES b1": lambda epochs: {
        "gin_spmm_fwd": epochs * (15 * 5 + 2 * 5) + 2 * 5, "gin_spmm_bwd": epochs * 15 * 4},
    "finetune Cora_NC b1 csr": lambda epochs: {
        "csr_spmm_fwd": epochs * (5 + 5) + 5, "csr_spmm_bwd": epochs * 5},
}
# Float moments of a store against SCALE1_DIGESTS: relative, since the sums
# may round otherwise on another CPU.
DIGEST_RTOL = 1e-6
# The artifacts phase: reference .pt files in, serving artifacts out, NaN
# checks. (a) The trained Cora_NC model written as a reference .pt, imported
# into a fresh K1 model, serves as the source does (torch.equal, or within
# IMPORT_TOL absolute). (b) ENZYMES full_finetune from the s2 checkpoint as a
# reference pretrain .pt, 1 epoch on the phase-5 store (train 480, val 60,
# test 60 graphs in batches of 32): 15 steps x (5, 4), then 2 val and 2 test
# batches x 5 fwd. (c) Each artifact's cuda program within ARTIFACT_TOL of
# max |ref| of the eager port model with its aggregation, within SLICE_TOL of
# the eager K1 serving output, its cpu program (on the host) within
# ARTIFACT_CPU_TOL; no K1 launch and no host-to-device copy in an artifact
# call. (d) The checked clean s2 step within NAN_LOSS_TOL (relative) of the
# unchecked one (the card's atomics add in landing order); launches: three
# whole s2 steps (clean, clean checked, poisoned unchecked), then the checked
# poisoned step, which stops where the first NaN shows and is not counted.
REFERENCE_TRACKED = 100     # num_batches_tracked written into the .pt files
ARTIFACT_PLATFORMS = "cuda,cpu"
IMPORT_TOL = 1e-6
ARTIFACT_TOL = 1e-5
ARTIFACT_CPU_TOL = 1e-4
NAN_LOSS_TOL = 1e-5
ARTIFACT_FT_LAUNCHES = {"gin_spmm_fwd": 15 * 5 + 2 * 5 + 2 * 5, "gin_spmm_bwd": 15 * 4}
NAN_LAUNCHES = {"gin_spmm_fwd": 3 * 80, "gin_spmm_bwd": 3 * 80,
                "ntxent_fwd": 3 * 8, "ntxent_bwd": 3 * 8}
# Checks that fail on the card for a known fault, each with where it is
# tracked; the script fails if one of them passes (take it out then).
KNOWN_FAILURES = {}

# Phase 12c, dp: data parallelism on the one card.
DP_RANKS = 2                    # gloo ranks on the one card (NCCL refuses two on one device)
DP_SCHEME = "s5"
DP_GC_CELL = ("ENZYMES", "full_finetune")
DP_TIMING_REPS = 5
DP_EVAL_TOL = 1e-2              # the eval loss after one AdamW step on each side
DP_RANK_TIMEOUT_S = 600
# Phase 12d, partition: edge- and node-partitioned fine-tuning on the one
# card, as 12c's gloo ranks. Tolerances: the JAX package's own for these paths
# (tests/test_node_parallel.py:95-96, 121-126: loss rtol 1e-5, probabilities
# 1e-4, BN statistics rtol 1e-4 / atol 1e-6, gradients 1e-5 of their norm
# and 1e-4 per leaf; the driver's test loss rtol 5e-4 / atol 5e-5 and
# accuracy exactly, :281-285).
PART_RANKS = 2
PART_CELLS = ("Cora_NC", "Cora_LP")
PART_MODES = ("edge", "node")
PART_SCALE_DOMAIN = "Cora_NC"           # on CSR_STORES, the tracked 6x stores
PART_TIMING_REPS = 5
PART_LOSS_TOL = 1e-5
PART_PROBS_TOL = 1e-4
PART_STATS_TOL = 1e-4
PART_GRAD_TOL = 1e-5
PART_LEAF_TOL = 1e-4
PART_DRIVER_EPOCHS = 2
PART_DRIVER_LOSS_TOL = (5e-4, 5e-5)
# K2 on inputs that hold NaN (k2_nan_phase): besides the poisoned step's own
# NT-Xent inputs, Ẑ of NTXENT_NAN_ROWS rows (ntxent_inputs) with one row made
# NaN on the card (0/0, the card's NaN): a valid row, whose columns poison
# every valid row, and an invalid one, whose columns are masked, so that only
# its own row turns NaN. NaN where the plain version's is, in loss, mx and
# den of every row and in dẐ; the finite entries within the kernel phase's
# tolerances.
NTXENT_NAN_ROWS = 832
# Digests (store_digest) of the nine stores that the JAX package's setup
# writes at scale 1, seed 0, without raw files
# (python -m gnn_pretraining_tpu.data.setup --raw_dir <empty directory>,
# scikit-learn 1.9.0, networkx 3.6.1); the data phase holds the port's stores
# against them: integer arrays exactly, float moments at DIGEST_RTOL.
SCALE1_DIGESTS = {
    "CiteSeer_LP": {
        "edge_index": ["int32", [2, 9104], "6575a9c529de48b97df3f04d99b72b2d497ef67a81504b7dbe9df90ce142c41e"],
        "edge_offsets": ["int64", [2], "c992feb069959cddbeddf712d4a52590395c96de5d01100231709b7e303caa93"],
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "CiteSeer_LP",
        "node_features": ["float32", [3327, 3703], 3327.00007096678, 276.57774258509204, 0.20000000298023224],
        "node_offsets": ["int64", [2], "6f90e569728c6e58bb3de71182fccb17e63e7d95528c439f9929139b5fa214b9"],
        "node_y": ["int64", [3327], "8d42b3058e78d7528ec9b0f5c324eceff38baccd823a606284fee3b48c44468e"],
        "split__test_neg": ["int64", [2, 910], "68f20a7e943d8bfa29602ac08e1f9dde30b1e15633d35a6390050027fa68e800"],
        "split__test_pos": ["int64", [2, 910], "5395fa294a2991edbc8625ff45763ec4acdef7a05cea6606c464bd83f177c409"],
        "split__train_pos": ["int64", [2, 7284], "550db57568ece423bf7aab26bfdd7318f4e42208b06d98362e2f267c454624a4"],
        "split__val_neg": ["int64", [2, 910], "c3e7df2745228445c5cb5941c470d85ea7a4a004f388d8d7098c87a9bbca8bf9"],
        "split__val_pos": ["int64", [2, 910], "4f80968ad384af770b0bd2733c55a17ad90449215f97d74ac0458262595c2d8d"],
        "y": ["int64", [3327], "8d42b3058e78d7528ec9b0f5c324eceff38baccd823a606284fee3b48c44468e"],
    },
    "CiteSeer_NC": {
        "edge_index": ["int32", [2, 9104], "6575a9c529de48b97df3f04d99b72b2d497ef67a81504b7dbe9df90ce142c41e"],
        "edge_offsets": ["int64", [2], "c992feb069959cddbeddf712d4a52590395c96de5d01100231709b7e303caa93"],
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "CiteSeer_NC",
        "node_features": ["float32", [3327, 3703], 3327.00007096678, 276.57774258509204, 0.20000000298023224],
        "node_offsets": ["int64", [2], "6f90e569728c6e58bb3de71182fccb17e63e7d95528c439f9929139b5fa214b9"],
        "node_y": ["int64", [3327], "8d42b3058e78d7528ec9b0f5c324eceff38baccd823a606284fee3b48c44468e"],
        "split__test": ["int64", [1000], "ed24dfd87a0b710a2046252f15ac4bf89fd8de7629376dcbfb6b54ae339bea3a"],
        "split__train": ["int64", [120], "953aa5956831de5817c0531f9899f97e822aba32958509ad6054d1aa87fb88db"],
        "split__val": ["int64", [500], "951bea1066266cc579d2a02614eebb1797bceb5f56c16e7ba4605d99f27f33bd"],
        "y": ["int64", [3327], "8d42b3058e78d7528ec9b0f5c324eceff38baccd823a606284fee3b48c44468e"],
    },
    "Cora_LP": {
        "edge_index": ["int32", [2, 10556], "dc20b08fa06bab053f76987c2d2a0e0b7490a30438c8df5ab494636315136df9"],
        "edge_offsets": ["int64", [2], "a7ac73970eabd0e0f4cf4e2e62f6d4cc15c9a5657e0b1e8bc32f85288d199319"],
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "Cora_LP",
        "node_features": ["float32", [2708, 1433], 2708.000056423247, 223.49076684406435, 0.20000000298023224],
        "node_offsets": ["int64", [2], "414089392a8343314e8e6b72c41cf9b2d047c45955c5de33033f739184d907de"],
        "node_y": ["int64", [2708], "105863e35c7fb18cbbeea5adf553ab463ed239fe9769f29e8da317cf61d9e704"],
        "split__test_neg": ["int64", [2, 1056], "c193b447137feecd437039192bc325416edac98576901f0668f2a95aae014dbb"],
        "split__test_pos": ["int64", [2, 1056], "0dedc48be25ffd09e8347179cb019af721e8bcdda5fe210e82d5d1a2e41c5d68"],
        "split__train_pos": ["int64", [2, 8445], "8fa343e6eb55967bef8c9f1a2f0ec8567b036966de5e27fd4ab81572457708d3"],
        "split__val_neg": ["int64", [2, 1055], "a5ae53d791baa221786e13c9eecefda80ec570ac152c96f6e55e95a2b39d6ae2"],
        "split__val_pos": ["int64", [2, 1055], "16d611a21680a06f0a18f8a2e348a1200920c1ad66876795cbe491d918a84042"],
        "y": ["int64", [2708], "105863e35c7fb18cbbeea5adf553ab463ed239fe9769f29e8da317cf61d9e704"],
    },
    "Cora_NC": {
        "edge_index": ["int32", [2, 10556], "dc20b08fa06bab053f76987c2d2a0e0b7490a30438c8df5ab494636315136df9"],
        "edge_offsets": ["int64", [2], "a7ac73970eabd0e0f4cf4e2e62f6d4cc15c9a5657e0b1e8bc32f85288d199319"],
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "Cora_NC",
        "node_features": ["float32", [2708, 1433], 2708.000056423247, 223.49076684406435, 0.20000000298023224],
        "node_offsets": ["int64", [2], "414089392a8343314e8e6b72c41cf9b2d047c45955c5de33033f739184d907de"],
        "node_y": ["int64", [2708], "105863e35c7fb18cbbeea5adf553ab463ed239fe9769f29e8da317cf61d9e704"],
        "split__test": ["int64", [902], "5f45674718955434be521faaed70e39e680f18d73508c5ba6273485ee351d9c9"],
        "split__train": ["int64", [140], "f36579cb8e91316f390983c1158471061f35822d50fb784dcff7cc43bba15118"],
        "split__val": ["int64", [451], "8d0fe314e30143cecb945412c99585970a40d009ed9166786ce15f43a119e35f"],
        "y": ["int64", [2708], "105863e35c7fb18cbbeea5adf553ab463ed239fe9769f29e8da317cf61d9e704"],
    },
    "ENZYMES": {
        "edge_index": ["int32", [2, 74420], "e11f6c7ac3435c4c6b16ef1bf18f9d30c4aa3ec06c0ed75fae3771d6b136979d"],
        "edge_offsets": ["int64", [601], "9c09eea61688fb39ad71a08644565f7312f41178ba43dc0f5f748568397a8065"],
        "graph_properties": ["float32", [600, 12], 45.411430332111195, 6789.652482595446, 4.919858455657959],
        "meta__homophily": "0.0",
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "ENZYMES",
        "node_features": ["float32", [19586, 21], 331.5339419875469, 408796.9639908015, 3.0],
        "node_offsets": ["int64", [601], "4053f0c5d2efbc45cba52c4078ceaaa556e91d0ac1a2ab1260c08dd6f08cb662"],
        "split__test": ["int64", [60], "b841d761a675a0f3750734e93673b77a338157d4c5d58e4e45a3099cd73573f2"],
        "split__train": ["int64", [480], "7e85da4a39bccbe573d9732f30994a4f5404bfb797f702c6af5f00e9dd44e6f9"],
        "split__val": ["int64", [60], "fab991d6f1616b642e170830b471db51c104e68f2be030383a417d06339d31a4"],
        "y": ["int64", [600], "411f0888ee6e371c82f9e99d6e9ef4ff0ef589bcdc90f9930b949db1aedc6807"],
    },
    "MUTAG": {
        "edge_index": ["int32", [2, 7442], "ed143dcdcefdfa3109725f1256ce8969997b44a05a144ff993fac6917ba67a0c"],
        "edge_offsets": ["int64", [189], "1f39acf19cc3e21d1fb069ebcfcd4e94a0c56f82a06fa0b569c482d5f12bf4ce"],
        "graph_properties": ["float32", [188, 12], 20.03464930644259, 2095.7610139832404, 4.063368320465088],
        "meta__homophily": "0.0",
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "MUTAG",
        "node_features": ["float32", [3390, 7], 3390.0, 3390.0, 1.0],
        "node_offsets": ["int64", [189], "cfc751c552a19a3450053b3cf982fc382031a547ed440ea082c168419fb00f54"],
        "split__train": ["int64", [169], "883ee7cd7329c26d17eabd7c97ab8489f47e83b720034ef8ea8ae9b8c0bebba8"],
        "split__val": ["int64", [19], "8f82d7811f463cef9c4797f41fa57c6f0930d47817134ac647daa3fc60e035fb"],
        "y": ["int64", [188], "762605c263a873178e581bdfe2af9c1249f6bf2c2386e3457ae23c80e16df448"],
    },
    "NCI1": {
        "edge_index": ["int32", [2, 270440], "1f501180900c7cf5615eb646280853264c7efe797738ab1795a652aac9991ddf"],
        "edge_offsets": ["int64", [4111], "151836df7f8f0c21df87da5d4da56b146f6a51646bfb8da01d7452e80d9c739b"],
        "graph_properties": ["float32", [4110, 12], -6.516979931737296, 45199.7595243299, 8.251921653747559],
        "meta__homophily": "0.0",
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "NCI1",
        "node_features": ["float32", [122917, 37], 122917.0, 122917.0, 1.0],
        "node_offsets": ["int64", [4111], "525e919f364fba0ae2f6ce707d61052093a20940134d036fd1962a7ee49124dd"],
        "split__train": ["int64", [3699], "21a72a280a5d67b2bce43c2af9e012b4be2c89b6b340f8d6a64c10a1062fc75a"],
        "split__val": ["int64", [411], "b19acbeabbe7da964ad02a9ab1d0b8abe70351882c2f66619f4aef4d9b9778d4"],
        "y": ["int64", [4110], "c05af7a2b4219084d00301cc0da014d1327b112b99dde9b521b0ff84688984f3"],
    },
    "PROTEINS": {
        "edge_index": ["int32", [2, 160916], "31cb814ab7eacabe73045aaf39a4a330d3e38e1ac677de28c4afd533e2ae1f73"],
        "edge_offsets": ["int64", [1114], "a95e6a633cb0414bcf387142b2e081e020e50cde9297dbc7dfef403b983a22b1"],
        "graph_properties": ["float32", [1113, 12], 18.066890308167785, 12343.881631181657, 6.068387031555176],
        "meta__homophily": "0.0",
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "PROTEINS",
        "node_features": ["float32", [43482, 4], 45201.499331370695, 89402.95508167038, 4.305697441101074],
        "node_offsets": ["int64", [1114], "69c4226c438153b577b088e1c5d24f5ecd83cbc658eb504d76f8cd8bd70e1486"],
        "split__train": ["int64", [1001], "f23e2a326c6d74bed7f783cc3a0547e47cb4c6c2029a4b4ad217ff8ae9337a7c"],
        "split__val": ["int64", [112], "11945e35ff0e397e95681ce3081bd307a1de663ba179acec6de3c43fb2d52753"],
        "y": ["int64", [1113], "b3cf5c40f26174b10c89826ee230f0cdfaffb7f5546e1abe9ffe0d61451da756"],
    },
    "PTC_MR": {
        "edge_index": ["int32", [2, 10056], "f73a6644d098a11b462bcf65fc9d80ac616c7d50242036e5b20986ac691bd796"],
        "edge_offsets": ["int64", [345], "21ddb638674ef3f4794a3db11c651ec99f5f5a3f179557066ee5d68f037bc94e"],
        "meta__homophily": "0.0",
        "meta__scale": "1.0",
        "meta__source": "synthetic",
        "name": "PTC_MR",
        "node_features": ["float32", [5028, 18], 5028.0, 5028.0, 1.0],
        "node_offsets": ["int64", [345], "ffa2125f4153394da8db84340e42ac9c210798c1c19c47db6da7ebbacdf1e8bc"],
        "split__test": ["int64", [35], "0c619b4d712212d7618140d09a52f9a5da9b47d3612aca064f4d200801d61463"],
        "split__train": ["int64", [275], "b46a4f2c2522b71ac7667673c4cea3ccb9182765fdbbae3cc641aeabf4e57d50"],
        "split__val": ["int64", [34], "3d41df7000d8432ab6f307d0ee8bd7d80f437ddec80a40ec8fabc773b4712640"],
        "y": ["int64", [344], "4f3146530d0ae7ed48b995199f913ede6246e74a6318e35a265301c54cdc2026"],
    },
}
# The JAX package's default output directories, which no port run may touch.
JAX_OUTPUT_DIRS = ("pretrain", "finetune", "metrics")
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
    # The dp phase gathers the rows of its DP_RANKS ranks (each at dp_pads).
    from gnn_pretraining_tpu_torch.parallel.data_parallel import dp_pads

    for domain, (n_pad, _, g_local) in dp_pads(pretrain_loader(processed_dir, DP_SCHEME)[1],
                                               DP_RANKS).items():
        add(2 * DP_RANKS * n_pad, f"train dp {DP_SCHEME} {domain} node_contrast, gathered")
    add(2 * DP_RANKS * g_local, f"train dp {DP_SCHEME} graph_contrast, gathered")
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
    from gnn_pretraining_tpu_torch.pretrain.chunked import kernel_counters

    return kernel_counters()


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


CHUNK_SCHEMES = ("s2", "s5", "b4")
CHUNK_STEPS = 8                      # one chunk replayed against 8 eager steps
CHUNK_LOSS_TOL = 1e-5                # step-1 losses, |diff| over max |eager|
# PCGrad decides a conflict by the sign of a per-leaf dot product and a
# projection by the leaf's gradients being nonzero. On a bias that a
# BatchNorm follows (an encoder's linear, a GIN MLP's first layer) the
# gradient is 0 in exact arithmetic and ~1e-9 of the others in f32, and
# with more than two tasks a scalar leaf (a layer's eps) projected once is
# 0 in exact arithmetic: there the decisions are rounding's, and two runs
# whose sums add in another order (the pooling's atomics) may take them
# apart. At most one of each per task pair on each such leaf.
ROUNDING_BIASES = ("linear.bias", "gin_conv.nn.0.bias")
CHUNK_REPLAY_REPS = 10
CHUNK_EAGER_REPS = 3
CHUNK_ENTRY_SCHEME = "s5"
BUILD_TIMING_STEPS = 40


def pretrain_step_calls() -> int:
    """How often a chunked pretrain() runs its step through the kernels'
    wrappers: the capture's warm-up steps and the capture. Its steps replay
    the captured launches, which the wrappers do not count."""
    from gnn_pretraining_tpu_torch.pretrain.chunked import CAPTURE_WARMUP_STEPS

    return CAPTURE_WARMUP_STEPS + 1


def flat_tensors(obj) -> list:
    if torch.is_tensor(obj):
        return [obj]
    return [t for item in obj for t in flat_tensors(item)]


def draw_recording(streams, model, out: list):
    """Record what a step's random sources hand out, in call order: views,
    mask scores, negatives and dropout keep-masks."""
    import contextlib

    def wrap(obj, name):
        real = getattr(obj, name)

        def recorded(*args, **kwargs):
            drawn = real(*args, **kwargs)
            out.append(drawn)
            return drawn

        return mock.patch.object(obj, name, recorded)

    stack = contextlib.ExitStack()
    for obj, name in ((streams["views"], "two_views"), (streams["task_draws"], "mask_scores"),
                      (streams["task_draws"], "negatives"), (model.dropout, "keep_mask")):
        stack.enter_context(wrap(obj, name))
    return stack


def profiled(call, reps: int = PROFILE_REPS) -> list:
    """(kernel name, device ms per call, launches per call) of ``call`` under
    torch.profiler, kernels and copies only, largest first."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return sorted(
        ((e.key, e.self_device_time_total / reps / 1e3, e.count // reps)
         for e in prof.key_averages()
         # Kernels and copies only: an annotated range such as the
         # optimizer's step shows on the device timeline too, and would
         # count the kernels under it a second time.
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and not e.key.startswith("Optimizer.")),
        key=lambda k: -k[1])


def chunked_step_phase(device, processed_dir: Path, scheme: str) -> dict:
    """The train step of ``scheme`` captured in a CUDA graph
    (make_chunked_train_step) on phase 8's stores: its K1 and K2 launches
    counted at capture; one chunk of CHUNK_STEPS steps replayed against as
    many eager steps (make_train_step) of a twin from the same seeds on the
    same batches: every view, mask, negative and dropout keep-mask bitwise
    equal, the step-1 losses within CHUNK_LOSS_TOL, every metric of every
    step within TRAIN_LOSS_TOL (PCGrad's conflicts and projections apart by
    at most its decisions on ROUNDING_BIASES and, past two tasks, on the
    scalar leaves), the
    parameters after the chunk within phase 8's lr distances, the
    generators' states and the counters equal; then each step's CUDA-event
    median and device busy, replayed and eager."""
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain.chunked import StepLayout, stack_batches, warmup_row
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer

    cfg, loader = pretrain_loader(processed_dir, scheme)
    total_steps = len(loader) * PRETRAIN_ENTRY_EPOCHS
    k = sum(t != "domain_adv" for t in cfg.active_tasks)
    layout = StepLayout.of_loader(loader, k)
    host = [loader.sample_step() for _ in range(CHUNK_STEPS)]

    def fresh():
        model = pt.build_pretrain_model(cfg, "pallas", device)
        optimizer, labels, lrs = create_task_specific_optimizer(model, cfg.active_tasks)
        return model, optimizer, pt.random_streams(cfg, model, device), labels, lrs

    model, optimizer, streams, labels, lrs = fresh()
    run_chunk, names = pt.make_chunked_train_step(model, cfg, optimizer, total_steps, streams)
    state = pt.PretrainState()
    kernels = counters()
    before = {name: c.launches for name, c in kernels.items()}
    refs = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    with draw_recording(streams, model, refs):
        run_chunk.capture(state, warmup_row(loader, layout), layout)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    around_capture = {name: c.launches - before[name] for name, c in kernels.items()}
    refs = flat_tensors(refs[len(refs) // 2:])   # the warm-up's draws came first
    perms = [torch.randperm(k, generator=streams["pcgrad"]).numpy() if k > 1 else None
             for _ in range(CHUNK_STEPS)]
    words = stack_batches(host, layout, perms, pin=True).to(device, non_blocking=True)
    graph, graph_draws = run_chunk.graph, []

    class RecordingGraph:
        def replay(self):
            graph.replay()
            graph_draws.append([r.clone() for r in refs])

    run_chunk.graph = RecordingGraph()
    try:
        before = {name: c.launches for name, c in kernels.items()}
        packed = run_chunk(state, words, layout).cpu().numpy()
        on_replay = {name: c.launches - before[name] for name, c in kernels.items()}
    finally:
        run_chunk.graph = graph

    twin, twin_opt, twin_streams, _, _ = fresh()
    step = pt.make_train_step(twin, cfg, twin_opt, total_steps, twin_streams["views"],
                              twin_streams["pcgrad"], twin_streams["task_draws"])
    twin_state = pt.PretrainState()
    eager_draws, eager = [], []
    for b in host:
        drawn = []
        with draw_recording(twin_streams, twin, drawn):
            m = step(twin_state, {d: x.to(device) for d, x in b.items()})
        eager_draws.append([r.clone() for r in flat_tensors(drawn)])
        eager.append({n: float(v) for n, v in m.items()})
    torch.cuda.synchronize()

    draws_equal = bool(len(graph_draws) == CHUNK_STEPS and all(
        len(g) == len(e) and all(torch.equal(a, b) for a, b in zip(g, e))
        for g, e in zip(graph_draws, eager_draws)))
    losses = [n for n in names if n.startswith("train/loss")]
    scale = max(abs(eager[0][n]) for n in losses)
    step1_err = max(abs(float(packed[names.index(n), 0]) - eager[0][n]) for n in losses) / scale
    metric_err = {n: max(abs(float(packed[i, j]) - eager[j][n]) / max(abs(eager[j][n]), 1e-6)
                         for j in range(CHUNK_STEPS))
                  for i, n in enumerate(names) if not n.startswith("gradient_surgery/")}
    worst = max(metric_err, key=metric_err.get)
    surgery = {n: [float(packed[names.index(n), j]) - eager[j][n] for j in range(CHUNK_STEPS)]
               for n in ("gradient_surgery/total_conflicts",
                         "gradient_surgery/total_projections") if n in names}
    rounding = k * (k - 1) // 2 * sum(n.endswith(ROUNDING_BIASES) or (k > 2 and p.numel() == 1)
                                      for n, p in twin.named_parameters())
    conflicts_ok = all(abs(d) <= rounding for diffs in surgery.values() for d in diffs)
    grads = {n: p.grad for n, p in twin.named_parameters()}
    g_max = max(float(g.abs().max()) for g in grads.values())
    params, twin_params = dict(model.named_parameters()), dict(twin.named_parameters())
    dist_max, dist_sum, clear_count = 0.0, 0.0, 0
    with torch.no_grad():
        for n, label in labels.items():
            dist = (params[n] - twin_params[n]).abs() / lrs[label]
            clear = grads[n].abs() > 1e-3 * g_max
            dist_max = max(dist_max, float(dist.max()))
            dist_sum += float(dist[clear].sum())
            clear_count += int(clear.sum())
    streams_equal = all(
        np.array_equal(np.asarray(a), np.asarray(b)) for name in ("dropout", "views", "task_draws")
        for a, b in [(pt.stream_states(streams)[name], pt.stream_states(twin_streams)[name])])
    expected = launches_of(scheme)
    calls = pretrain_step_calls()
    checks = {
        "launches_at_capture": run_chunk.capture_launches == expected
        and around_capture == {n: calls * v for n, v in expected.items()}
        and not any(on_replay.values()),
        "draws_bitwise": draws_equal,
        "step1_losses": step1_err <= CHUNK_LOSS_TOL,
        "packed_rows": names == sorted(eager[0]) and packed.shape == (len(names), CHUNK_STEPS)
        and all(e <= TRAIN_LOSS_TOL for e in metric_err.values()) and conflicts_ok,
        "params_after_chunk": dist_max <= 2.02 and dist_sum / max(clear_count, 1) <= 0.05,
        "streams_and_counters": streams_equal and state.opt_step == twin_state.opt_step
        == CHUNK_STEPS and run_chunk.replays == CHUNK_STEPS
        and state.device_counters(device).tolist() == twin_state.device_counters(device).tolist(),
    }

    one = stack_batches(host[:1], layout, perms[:1], pin=True).to(device)
    first = {d: x.to(device) for d, x in host[0].items()}
    timed = {"replayed": (lambda: run_chunk(state, one, layout), CHUNK_REPLAY_REPS),
             "eager": (lambda: step(twin_state, first), CHUNK_EAGER_REPS)}
    times = {}
    for how, (call, reps) in timed.items():
        event = event_median(call, reps)
        top = profiled(call, reps)
        busy = sum(ms for _, ms, _ in top)
        times[how] = {"event_ms": event, "device_busy_ms": busy if top else None,
                      "idle_share": 1 - busy / event if top else None,
                      "kernels_per_step": sum(c for _, _, c in top)}
    ok = all(checks.values())
    emit({"phase": "chunked", "scheme": scheme, "capture_s": capture_s,
          "launches_per_step_at_capture": run_chunk.capture_launches,
          "launches_around_capture": around_capture, "launches_on_replay": on_replay,
          "expected": expected, "steps": CHUNK_STEPS, "draw_tensors_per_step": len(refs),
          "step1_loss_err": step1_err, "metric_max_rel_err": metric_err[worst],
          "metric_max_rel_err_key": worst, "pcgrad_replayed_minus_eager": surgery,
          "pcgrad_projections": [e.get("gradient_surgery/total_projections") for e in eager],
          "pcgrad_rounding_decisions": rounding,
          "param_max_dist_over_lr": dist_max,
          "param_mean_dist_over_lr": dist_sum / max(clear_count, 1),
          "times": times, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError(f"the chunked {scheme} step failed its checks: {checks}")
    run_chunk.release()
    return times


def chunked_entry_phase(entry_dir: Path, out_root: Path) -> dict:
    """pretrain() of CHUNK_ENTRY_SCHEME for 1 epoch on the entry stores with
    chunk_steps=32 and with chunk_steps=1: seconds per step, finite losses,
    the same metric keys and steps."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.pretrain.pretrain import pretrain

    cfg = config.PretrainConfig(CHUNK_ENTRY_SCHEME, 42)
    out = {}
    for chunk_steps in (32, 1):
        root = out_root / f"chunked_entry_{chunk_steps}"
        t0 = time.perf_counter()
        pretrain(cfg, aggregation="pallas", epochs=PRETRAIN_ENTRY_EPOCHS,
                 processed_dir=entry_dir, out_root=root, chunk_steps=chunk_steps)
        seconds = time.perf_counter() - t0
        log = root / "metrics" / config.PRETRAIN_PROJECT_NAME / f"{cfg.run_name}.jsonl"
        rows = [r for r in map(json.loads, open(log)) if "train/loss/total" in r]
        out[chunk_steps] = {"seconds": seconds, "steps": len(rows),
                            "seconds_per_step": seconds / len(rows),
                            "keys": sorted(rows[0]),
                            "finite": bool(np.isfinite([r["train/loss/total"] for r in rows]).all()),
                            "first_loss": rows[0]["train/loss/total"],
                            "last_loss": rows[-1]["train/loss/total"]}
    a, b = out[32], out[1]
    ok = bool(a["finite"] and b["finite"] and a["keys"] == b["keys"] and a["steps"] == b["steps"])
    emit({"phase": "chunked", "entry": cfg.run_name, "stores": entry_dir.name,
          "seconds_per_step": {"chunk_steps=32": a["seconds_per_step"],
                               "chunk_steps=1": b["seconds_per_step"]},
          "runs": {str(c): {k: v for k, v in r.items() if k != "keys"} for c, r in out.items()},
          "same_metric_keys": a["keys"] == b["keys"], "ok": ok})
    if not ok:
        raise AssertionError("pretrain() chunked and per step disagree in their rows")
    return {"chunk_steps=32": a["seconds_per_step"], "chunk_steps=1": b["seconds_per_step"]}


def batch_build_phase(processed_dir: Path) -> dict:
    """Host ms per s5 step of build_batch, the numpy builder beside the
    native one (each warmed up on the first draw), on the same
    BUILD_TIMING_STEPS draws of phase 8's stores; the two builders' arrays
    equal."""
    from gnn_pretraining_tpu_torch.data.batch import build_batch, build_batch_numpy

    _, loader = pretrain_loader(processed_dir, "s5")
    draws = [loader.sample_indices() for _ in range(BUILD_TIMING_STEPS)]
    stores, spd = loader.domain_stores, loader.samples_per_domain
    ms, built = {}, {}
    for name, build in (("numpy", build_batch_numpy), ("native", build_batch)):
        for d, ix in draws[0].items():     # the library's build and load, the store's arrays
            build(stores[d], ix, *loader.pads[d], spd, True)
        t = time.perf_counter()
        built[name] = [{d: build(stores[d], ix, *loader.pads[d], spd, True)
                        for d, ix in chosen.items()} for chosen in draws]
        ms[name] = (time.perf_counter() - t) * 1e3 / BUILD_TIMING_STEPS
    equal = all(getattr(a[d], f).numpy().tobytes() == getattr(b[d], f).numpy().tobytes()
                for a, b in zip(built["numpy"], built["native"]) for d in a
                for f in ("x", "senders", "receivers", "edge_mask", "edge_graph", "node_mask",
                          "node_graph", "graph_mask", "node_start", "n_node", "n_edge", "y",
                          "graph_properties"))
    emit({"phase": "chunked", "build_batch_ms_per_s5_step": ms, "steps": BUILD_TIMING_STEPS,
          "equal": equal, "ok": equal})
    if not equal:
        raise AssertionError("the native batch builder differs from the numpy one")
    return ms


def chunked_phase(device, processed_dir: Path, entry_dir: Path, out_root: Path) -> dict:
    """Phase 12e: chunked_step_phase per scheme of CHUNK_SCHEMES, the entry
    seconds and the builders' host time."""
    out = {"steps": {s: chunked_step_phase(device, processed_dir, s) for s in CHUNK_SCHEMES}}
    out["entry_seconds_per_step"] = chunked_entry_phase(entry_dir, out_root)
    out["build_batch_ms"] = batch_build_phase(processed_dir)
    return out


def capture_failure_phase(device, processed_dir: Path) -> None:
    """No fallback: a b4 step that reads a value on the host inside the
    captured region (clip's norm) cannot be captured; the runner raises,
    at capture and again when asked to run a chunk, and trains nothing."""
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain.chunked import StepLayout, stack_batches, warmup_row
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer

    cfg, loader = pretrain_loader(processed_dir, "b4")
    k = sum(t != "domain_adv" for t in cfg.active_tasks)
    layout = StepLayout.of_loader(loader, k)
    model = pt.build_pretrain_model(cfg, "pallas", device)
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    streams = pt.random_streams(cfg, model, device)
    run_chunk, _ = pt.make_chunked_train_step(model, cfg, optimizer, len(loader), streams)
    start = {n: v.clone() for n, v in model.state_dict().items()}
    state = pt.PretrainState()
    real_clip = pt.clip_grads_torch

    def syncing_clip(grads):
        clipped, total = real_clip(grads)
        float(total)                # a host read: refused while capturing
        return clipped, total

    raised = []
    words = stack_batches([loader.sample_step()], layout,
                          [np.arange(k)]).to(device)
    with mock.patch.object(pt, "clip_grads_torch", syncing_clip):
        for attempt in (lambda: run_chunk.capture(state, warmup_row(loader, layout), layout),
                        lambda: run_chunk(state, words, layout)):
            try:
                attempt()
                raised.append(None)
            except Exception as err:  # noqa: BLE001 -- the point: what it raised
                raised.append(f"{type(err).__name__}: {str(err)[:160]}")
    torch.cuda.synchronize()
    untouched = all(torch.equal(v, start[n]) for n, v in model.state_dict().items())
    ok = bool(all(raised) and run_chunk.graph is None and run_chunk.replays == 0
              and state.opt_step == 0 and untouched
              and float(torch.ones(4, device=device).sum()) == 4.0)
    emit({"phase": "chunked", "forced_capture_failure": raised,
          "graph": run_chunk.graph is not None, "replays": run_chunk.replays,
          "opt_step": state.opt_step, "weights_untouched": untouched, "ok": ok})
    if not ok:
        raise AssertionError("a failed capture did not raise, or trained")


def reference_pt(path: Path, model, epoch: int, val_metrics) -> float:
    """Write ``model``'s weights as the reference writes a checkpoint (its
    keys, BatchNorm's num_batches_tracked, torch.save of {epoch,
    model_state_dict, val_metrics}); returns the seconds."""
    from gnn_pretraining_tpu_torch.utils.torch_import import port_to_reference

    t = time.perf_counter()
    torch.save({"epoch": int(epoch),
                "model_state_dict": port_to_reference(model.state_dict(), REFERENCE_TRACKED),
                "val_metrics": {k: float(v) for k, v in val_metrics.items()}}, str(path))
    return time.perf_counter() - t


def reference_import_checks(device, out_root: Path, tmp: Path, enz, cora, card) -> dict:
    """(a): a trained Cora_NC model written as a reference .pt (and a copy cut
    mid-storage), imported into fresh K1 models on the card."""
    from gnn_pretraining_tpu_torch import FinetuneGNN, make_serving_fn
    from gnn_pretraining_tpu_torch.utils import torch_import
    from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint
    from gnn_pretraining_tpu_torch.utils.convert import load_variables

    ckpt = load_checkpoint(out_root / "finetune" / "model_Cora_NC_full_finetune_b2_42.msgpack")
    source = load_variables(FinetuneGNN("Cora_NC", "pallas", device=device), ckpt).eval()
    whole, cut = tmp / "Cora_NC_reference.pt", tmp / "Cora_NC_reference_cut.pt"
    save_s = reference_pt(whole, source, ckpt["meta"]["epoch"], ckpt["meta"]["val_metrics"])
    blob = whole.read_bytes()
    cut.write_bytes(blob[:len(blob) // 2])

    def fresh():
        return FinetuneGNN("Cora_NC", "pallas", device=device,
                           generator=torch.Generator().manual_seed(SEED + 7))

    torch.cuda.synchronize()
    t = time.perf_counter()
    imported, missing = torch_import.load_torch_finetune_checkpoint(fresh(), whole)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    graph = cora["NC"]
    inputs = (graph.x, graph.node_mask, graph.senders, graph.receivers, graph.edge_mask)
    before = counters()["gin_spmm_fwd"].launches
    want = make_serving_fn(source)[0](*inputs)
    got = make_serving_fn(imported.eval())[0](*inputs)
    served_launches = counters()["gin_spmm_fwd"].launches - before
    torch.cuda.synchronize()
    serve_err = float((got - want).abs().max())

    start = fresh()
    initial = {k: v.clone() for k, v in start.state_dict().items()}
    t = time.perf_counter()
    part, cut_missing = torch_import.load_torch_finetune_checkpoint(start, cut)
    torch.cuda.synchronize()
    cut_import_s = time.perf_counter() - t
    read = torch_import.read_torch_checkpoint(cut)
    recovered = set(torch_import.reference_to_port(read["state_dict"]))
    lost = set(torch_import.reference_to_port(
        {k: np.zeros(1) for k in cut_missing}))
    src = source.state_dict()
    placed = all(torch.equal(v, src[k] if k in recovered else initial[k])
                 for k, v in part.state_dict().items())
    on_card = {t.device.type for t in part.state_dict().values()} == {"cuda"}
    checks = {
        "whole_read": missing == [] and torch_import.read_torch_checkpoint(whole)["epoch"]
        == int(ckpt["meta"]["epoch"]),
        "whole_serves_as_source": bool(torch.equal(got, want) or serve_err <= IMPORT_TOL),
        "k1_launches": served_launches == 2 * LAUNCHES_PER_FORWARD,
        "cut_reports": read["missing"] == cut_missing and 0 < len(lost) and 0 < len(recovered),
        "cut_covers_every_key": recovered | lost == set(src) and not recovered & lost,
        "cut_placed": placed, "on_card": on_card}
    emit({"phase": "artifacts", "part": "a reference fine-tune .pt", "card": card,
          "file_bytes": len(blob), "cut_bytes": len(blob) // 2, "save_seconds": save_s,
          "import_seconds": import_s, "cut_import_seconds": cut_import_s,
          "serve_max_abs_err": serve_err, "k1_launches": served_launches,
          "tensors_recovered": len(read["state_dict"]), "tensors_missing": len(cut_missing),
          "torch": torch.__version__, "checks": checks, "ok": all(checks.values())})
    return checks


def reference_pretrain_checks(device, processed_dir: Path, out_root: Path, tmp: Path,
                              card) -> dict:
    """(b): the s2 checkpoint written as a reference pretrain .pt, transferred
    into ENZYMES by the importer, then imported as a port pretrain checkpoint
    where finetune() looks for it, and fine-tuned for 1 epoch on K1 from it."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune.finetune import build_finetune_model, finetune
    from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
    from gnn_pretraining_tpu_torch.utils import torch_import
    from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from gnn_pretraining_tpu_torch.utils.convert import load_variables, state_dict_to_variables

    cfg = config.PretrainConfig("s2", 42)
    ckpt = load_checkpoint(out_root / "pretrain" / f"model_{cfg.run_name}.msgpack")
    source = load_variables(PretrainableGNN(cfg.pretrain_domains, cfg.active_tasks,
                                            "pallas", device=device), ckpt)
    path = tmp / "s2_reference.pt"
    save_s = reference_pt(path, source, ckpt["meta"]["epoch"], ckpt["meta"]["val_metrics"])
    ft_cfg = config.FinetuneConfig("ENZYMES", "full_finetune", "s2", 42)
    # The cell's seeded init (scheme b1 loads no backbone), then the transfer.
    model = build_finetune_model(dataclasses.replace(ft_cfg, pretrained_scheme="b1"),
                                 "pallas", device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch_import.load_torch_pretrained_into_finetune(model, path, "ENZYMES")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    src, got = source.state_dict(), model.state_dict()
    carried = all(torch.equal(v, src[k]) for k, v in got.items() if k.startswith("gnn_backbone."))
    carried &= all(torch.equal(v, src["input_encoders.ENZYMES." + k[len("input_encoder."):]])
                   for k, v in got.items() if k.startswith("input_encoder."))
    ft_root = tmp / "out"
    read = torch_import.read_torch_checkpoint(path)
    variables = state_dict_to_variables(torch_import.reference_to_port(read["state_dict"]))
    save_checkpoint(ft_root / "pretrain" / f"model_{cfg.run_name}.msgpack", variables["params"],
                    variables["batch_stats"], read["epoch"], read["val_metrics"])
    cell = build_finetune_model(ft_cfg, "pallas", device, ft_root).state_dict()
    as_imported = cell.keys() == got.keys() and all(torch.equal(cell[k], v)
                                                    for k, v in got.items())
    kernels = counters()
    before = {k: c.launches for k, c in kernels.items()}
    t = time.perf_counter()
    result = finetune(ft_cfg, aggregation="pallas", processed_dir=processed_dir, epochs=1,
                      out_root=ft_root)
    seconds = time.perf_counter() - t
    launched = {k: c.launches - before[k] for k, c in kernels.items() if c.launches - before[k]}
    checks = {"transferred": bool(carried), "finetune_starts_as_imported": as_imported,
              "launches": launched == ARTIFACT_FT_LAUNCHES,
              "finite": bool(np.isfinite(result["test/loss"]))}
    emit({"phase": "artifacts", "part": "b reference pretrain .pt -> finetune()", "card": card,
          "save_seconds": save_s, "import_seconds": import_s, "finetune_seconds": seconds,
          "launches": launched, "expected": ARTIFACT_FT_LAUNCHES,
          "test_loss": result["test/loss"], "test_accuracy": result["test/accuracy"],
          "checks": checks, "ok": all(checks.values())})
    return checks


def export_checks(device, out_root: Path, tmp: Path, enz, cora, score, card) -> dict:
    """(c): export_model.main(argv) at the tracked buckets, in dense and coo,
    for cuda and cpu; each artifact replayed on the card (and its cpu program
    on the host) against the eager port models on the same weights."""
    from torch.profiler import ProfilerActivity, profile

    from gnn_pretraining_tpu_torch import export_model, make_embedding_fn, make_serving_fn
    from gnn_pretraining_tpu_torch import serving

    graph = lambda b: (b.x, b.node_mask, b.senders, b.receivers, b.edge_mask)  # noqa: E731
    finetuned = lambda d: out_root / "finetune" / f"model_{d}_full_finetune_b2_42.msgpack"  # noqa: E731
    cases = (("ENZYMES", "ENZYMES", finetuned("ENZYMES"), enz, (*graph(enz), enz.node_graph)),
             ("Cora_NC", "Cora_NC", finetuned("Cora_NC"), cora["NC"], graph(cora["NC"])),
             ("Cora_LP", "Cora_LP", finetuned("Cora_LP"), cora["LP"],
              (*graph(cora["LP"]), score[0], score[1])),
             ("ENZYMES embed", "ENZYMES", out_root / "pretrain" / "model_s2_42.msgpack", enz,
              graph(enz)))
    k1 = counters()["gin_spmm_fwd"]
    checks = {}
    for name, domain, ckpt, batch, inputs in cases:
        embed = name.endswith("embed")

        def eager(aggregation):
            model = export_model.load_model(ckpt, domain, aggregation, embed, device)
            if embed:
                return make_embedding_fn(model)[0]
            fn = make_serving_fn(model)[0]
            return fn(batch.num_graphs) if model.task_type == "graph_classification" else fn

        k1_fn = eager("pallas")
        k1_out = k1_fn(*inputs)
        eager_ms = median_ms(lambda: k1_fn(*inputs))
        for aggregation in ("dense", "coo"):
            out = tmp / f"{name.replace(' ', '_')}_{aggregation}.pt2"
            argv = ["--checkpoint", str(ckpt), "--domain_name", domain,
                    "--num_nodes", str(batch.num_nodes), "--num_edges", str(batch.num_edges),
                    "--num_graphs", str(batch.num_graphs),
                    "--num_score_edges", str(CORA_SCORE_PAIRS), "--aggregation", aggregation,
                    "--platforms", ARTIFACT_PLATFORMS, "--out", str(out),
                    *(["--embed"] * embed)]
            t = time.perf_counter()
            rc = export_model.main(argv)
            export_s = time.perf_counter() - t
            t = time.perf_counter()
            served = serving.load_artifact(out)
            load_s = time.perf_counter() - t
            ref = eager(aggregation)(*inputs)
            before = k1.launches
            got = served(*inputs)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                served(*inputs)
                torch.cuda.synchronize()
            h2d = sum(e.count for e in prof.key_averages() if "HtoD" in e.key)
            art_ms = median_ms(lambda: served(*inputs))
            artifact_launches = k1.launches - before
            host = serving.load_artifact(out, device="cpu")(*(a.cpu() for a in inputs))
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max()) / scale
            k1_err = float((got - k1_out).abs().max()) / float(k1_out.abs().max())
            cpu_err = float((host - ref.cpu()).abs().max()) / scale
            header = serving.read_artifact(out.read_bytes())[0]
            case = f"{name} {aggregation}"
            checks[case] = bool(rc == 0 and tuple(got.shape) == tuple(ref.shape)
                                and torch.isfinite(got).all() and got.device.type == "cuda"
                                and err <= ARTIFACT_TOL and k1_err <= SLICE_TOL
                                and cpu_err <= ARTIFACT_CPU_TOL and artifact_launches == 0
                                and h2d == 0 and set(header["programs"]) == {"cuda", "cpu"})
            emit({"phase": "artifacts", "part": "c export", "card": card,
                  "artifact": case, "bucket": [batch.num_nodes, batch.num_edges],
                  "export_seconds": export_s, "load_seconds": load_s,
                  "bytes": out.stat().st_size, "program_bytes": header["programs"],
                  "max_rel_err_vs_eager": err, "max_rel_err_vs_eager_k1": k1_err,
                  "cpu_program_max_rel_err": cpu_err, "h2d_copies_per_call": h2d,
                  "k1_launches_in_artifact_calls": artifact_launches,
                  "artifact_ms": art_ms, "eager_k1_ms": eager_ms, "ok": checks[case]})
    return checks


def k2_nan_cases(captured, temp, device) -> list:
    """(name, Ẑ, validity, τ) of k2_nan_phase: each of the poisoned step's
    NT-Xent inputs that holds a NaN, and NTXENT_NAN_ROWS rows with one valid
    or one invalid row made NaN on the card."""
    cases = [(f"poisoned step, {zhat.shape[0]} rows", zhat, vv, temp)
             for zhat, vv in captured if torch.isnan(zhat).any()]
    zhat, vv, tau, _, _ = ntxent_inputs(np.random.default_rng(SEED + 7), NTXENT_NAN_ROWS,
                                        device)
    for kind in ("valid", "invalid"):
        row = int((vv > 0).nonzero()[0]) if kind == "valid" else int((vv == 0).nonzero()[0])
        poisoned = zhat.clone()
        poisoned[row] = poisoned[row] * 0 / 0
        cases.append((f"{NTXENT_NAN_ROWS} rows, NaN {kind} row {row}", poisoned, vv, tau))
    return cases


def nan_agreement(got, want, tol: float) -> dict:
    """NaN in the same entries; the finite ones within tol of max |want|."""
    same = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max()) if fin.any() else 1.0
    err = float((got[fin] - want[fin]).abs().max()) / scale if fin.any() else 0.0
    return {"nan": int(torch.isnan(got).sum()), "plain_nan": int(torch.isnan(want).sum()),
            "same_nan": same, "max_rel_err": err, "ok": same and err <= tol}


def k2_nan_phase(captured, temp, card) -> None:
    """K2-fwd and K2-bwd against their plain versions on Ẑ that holds NaN
    (k2_nan_cases): NaN exactly where the plain version's is, in loss, mx,
    den and dẐ. Run after the artifacts path's counts are read, as the
    kernel phases run outside every path's, so its launches are not the
    path's. A check named in KNOWN_FAILURES must fail, and must be taken out
    of it once it passes."""
    from gnn_pretraining_tpu_torch.ops import ntxent

    fwd_rows, bwd_rows = [], []
    for name, zhat, vv, tau in k2_nan_cases(captured, temp, temp.device):
        kernel = ntxent.ntxent_fwd(zhat, vv, tau)
        plain = ntxent.ntxent_fwd_reference(zhat, vv, tau)
        fwd = {out: nan_agreement(k, p, NTXENT_LOSS_TOL)
               for out, k, p in zip(("loss", "mx", "den"), kernel, plain)}
        g = vv.clone()
        dz = ntxent.ntxent_bwd(zhat, vv, tau, kernel[1], kernel[2], g)
        dz_plain = ntxent.ntxent_bwd_reference(zhat, vv, tau, plain[1], plain[2], g)
        torch.cuda.synchronize()
        nan_bits = zhat[torch.isnan(zhat)][:1].view(torch.int32).tolist()
        fwd_rows.append({"case": name, "rows": zhat.shape[0],
                         "nan_rows": int(torch.isnan(zhat).any(1).sum()),
                         "valid_rows": int((vv > 0).sum()),
                         "nan_bits": [f"{b & 0xffffffff:#010x}" for b in nan_bits], **fwd})
        bwd_rows.append({"case": name, **nan_agreement(dz, dz_plain, NTXENT_GRAD_TOL)})
    checks = {"d k2_fwd_nan_where_plain_is_nan": bool(fwd_rows) and all(
                  r[out]["ok"] for r in fwd_rows for out in ("loss", "mx", "den")),
              "d k2_bwd_nan_where_plain_is_nan": bool(bwd_rows) and all(
                  r["ok"] for r in bwd_rows)}
    failed = [name for name, ok in checks.items() if not ok]
    unexpected = [name for name in failed if name not in KNOWN_FAILURES]
    stale = [name for name in checks if name in KNOWN_FAILURES and name not in failed]
    emit({"phase": "artifacts", "part": "d K2 on Ẑ that holds NaN", "card": card,
          "forward": fwd_rows, "backward": bwd_rows, "checks": checks,
          "known_failures": {name: KNOWN_FAILURES[name] for name in failed
                             if name in KNOWN_FAILURES},
          "ok": not unexpected and not stale})
    if unexpected:
        raise AssertionError(f"K2 on NaN inputs failed its checks: {unexpected}")
    if stale:
        raise AssertionError(f"known failures now pass; take them out of KNOWN_FAILURES: {stale}")


def nan_checks(device, processed_dir: Path, card):
    """(d): one s2 step under enable_nan_checks on a batch with one poisoned
    feature row raises FloatingPointError naming the step and the task; a
    clean step under the switch gives the losses of a clean step without it.
    Returns the checks, the poisoned step's NT-Xent inputs and temperature."""
    from gnn_pretraining_tpu_torch.ops import ntxent
    from gnn_pretraining_tpu_torch.pretrain.schedulers import temperature_at
    from gnn_pretraining_tpu_torch.utils.profiling import enable_nan_checks

    cfg, loader = pretrain_loader(processed_dir)
    batches = {d: b.to(device) for d, b in loader.sample_step().items()}
    domain = sorted(batches)[-1]
    row = int(batches[domain].node_mask.nonzero()[0])
    poisoned = dict(batches)
    poisoned[domain] = dataclasses.replace(batches[domain], x=batches[domain].x.clone())
    poisoned[domain].x[row] = float("nan")
    kernels = counters()
    before = {k: c.launches for k, c in kernels.items()}
    losses, seconds, captured = {}, {}, []
    prep = ntxent._prep

    def recording_prep(z1, z2, valid):
        """The NT-Xent's (Ẑ, validity), kept for k2_nan_phase."""
        out = prep(z1, z2, valid)
        captured.append((out[0].detach().clone(), out[1].clone()))
        return out

    for name, on, step_batches in (("clean", False, batches), ("clean checked", True, batches),
                                   ("poisoned", False, poisoned)):
        # The views are drawn from the step's own batches.
        draws = step_draws(cfg, step_batches, device)
        enable_nan_checks(on)
        ntxent._prep = recording_prep if name == "poisoned" else prep
        try:
            _, step, state, _, _ = make_step(cfg, "pallas", device, 10, draws)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, step_batches, perm=draws[-1])
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
        finally:
            enable_nan_checks(False)
            ntxent._prep = prep
        losses[name] = {k: float(v) for k, v in out.items() if k.startswith("train/loss/")}
    launched = {k: c.launches - before[k] for k, c in kernels.items() if c.launches - before[k]}
    raised = None
    draws = step_draws(cfg, poisoned, device)
    enable_nan_checks(True)
    try:
        _, step, state, _, _ = make_step(cfg, "pallas", device, 10, draws)
        step(state, poisoned, perm=draws[-1])
    except FloatingPointError as err:
        raised = str(err)
    finally:
        enable_nan_checks(False)
    clean, checked = losses["clean"], losses["clean checked"]
    rel = max(abs(checked[k] - v) / max(abs(v), 1e-12) for k, v in clean.items())
    checks = {"poisoned_raises": raised is not None
              and raised.startswith("non-finite value at train step 0")
              and "task node_contrast" in raised,
              "same_losses": checked.keys() == clean.keys() and rel <= NAN_LOSS_TOL
              and all(math.isfinite(v) for v in checked.values()),
              "launches": launched == NAN_LAUNCHES, "switched_off": not torch.is_anomaly_enabled()}
    emit({"phase": "artifacts", "part": "d nan checks", "card": card, "poisoned": domain,
          "row": row, "raised": raised, "loss_max_rel_diff": rel, "tol": NAN_LOSS_TOL,
          "poisoned_unchecked_losses": {k: v for k, v in losses["poisoned"].items()
                                        if k.count("/") == 2},
          "step_seconds": seconds, "launches": launched, "expected": NAN_LAUNCHES,
          "checks": checks, "ok": all(checks.values())})
    return checks, captured, torch.tensor([temperature_at(0, 10)], device=device)


def artifacts_phase(device, processed_dir: Path, out_root: Path, tmp: Path, card):
    """Checks (a)-(d) of the module docstring's artifacts phase; returns the
    poisoned step's NT-Xent inputs and temperature for k2_nan_phase."""
    tmp.mkdir()
    t0 = time.perf_counter()
    enz, cora, score = serving_inputs(device)
    checks = {"a": reference_import_checks(device, out_root, tmp, enz, cora, card),
              "b": reference_pretrain_checks(device, processed_dir, out_root, tmp, card),
              "c": export_checks(device, out_root, tmp, enz, cora, score, card)}
    checks["d"], captured, temp = nan_checks(device, processed_dir, card)
    failed = [f"{part} {name}" for part, c in checks.items() for name, ok in c.items() if not ok]
    emit({"phase": "artifacts", "seconds": time.perf_counter() - t0, "card": card,
          "failed": failed, "ok": not failed})
    if failed:
        raise AssertionError(f"the artifacts phase failed its checks: {failed}")
    return captured, temp


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
    # Check 3: phase 8's counts per step the wrappers ran; the epoch's
    # evaluation runs every (task, domain, val batch) forward once more,
    # without backward.
    k1, k2 = STEP_LAUNCHES[RESUME_SCHEME]
    val_batches = sum(math.ceil(s["val"] / config.PRETRAIN_BATCH_SIZE) for s in stores.values())
    forwards = sum(2 if t in ("node_contrast", "graph_contrast") else 1 for t in cfg.active_tasks)
    contrast = sum(t in ("node_contrast", "graph_contrast") for t in cfg.active_tasks)
    # B' runs its step chunked: the wrappers count the capture's warm-up and
    # the capture (pretrain_step_calls), not its replays.
    n = pretrain_step_calls() if epoch6_b else 0
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


def jax_outputs() -> dict:
    """Every file under the JAX package's default output directories (by
    path, without importing it), with its size and modification time."""
    out = {}
    for sub in JAX_OUTPUT_DIRS:
        root = HERE / "outputs" / sub
        out[sub] = sorted((str(p.relative_to(root)), p.stat().st_size, p.stat().st_mtime_ns)
                          for p in root.rglob("*")) if root.exists() else None
    return out


def drivers_phase(processed_dir: Path, resume_dir: Path, out_root: Path) -> None:
    """The sweep drivers through their main(argv), on the card: checks 1-7 of
    the module docstring's drivers phase."""
    import contextlib
    import gc
    import io

    from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
    from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block

    t0 = time.perf_counter()
    before_outputs = jax_outputs()
    # Earlier phases leave tensors in reference cycles; the drivers collect
    # them after each cell, so collect them here too, or the first cell's
    # peak would count them and the second's would not.
    gc.collect()
    base_mib = torch.cuda.memory_allocated() / 2**20
    kernels = counters()
    root = out_root / "drivers"
    pretrain = [*DRIVER_SHARD, "--processed_dir", str(resume_dir)]

    def finetune(domain, scheme, epochs, *extra):
        return ["--domain_name", domain, "--finetune_strategy", "full_finetune",
                "--pretrained_scheme", scheme, "--seed", "42", "--epochs", str(epochs),
                "--out_root", str(root), *extra]

    enzymes = ["--processed_dir", str(processed_dir)]
    steps = (("pretrain s2_42", run_pretrain.main, [*pretrain, "--out_root", str(root)]),
             ("pretrain s2_42, second cell", run_pretrain.main,
              [*pretrain, "--out_root", str(out_root / "drivers_second")]),
             ("pretrain s2_42 --resume", run_pretrain.main,
              [*pretrain, "--out_root", str(root), "--resume"]),
             ("finetune ENZYMES b1", run_finetune.main,
              finetune("ENZYMES", "b1", DRIVER_FT_EPOCHS, *enzymes)),
             ("finetune ENZYMES s2", run_finetune.main,
              finetune("ENZYMES", "s2", DRIVER_FT_EPOCHS, *enzymes)),
             ("finetune Cora_NC b1 csr", run_finetune.main,
              finetune("Cora_NC", "b1", DRIVER_CSR_EPOCHS, "--aggregation", "csr",
                       "--processed_dir", str(CSR_STORES))))
    cells = {}
    for name, main, argv in steps:
        before = {k: c.launches for k, c in kernels.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = main(argv)
        torch.cuda.synchronize()
        cells[name] = {"rc": rc, "seconds": time.perf_counter() - t,
                       "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                       "launches": {k: c.launches - before[k] for k, c in kernels.items()},
                       "printed": printed.getvalue()}
        print(printed.getvalue(), end="", flush=True)
    launched = {name: {k for k, n in cell["launches"].items() if n} for name, cell in cells.items()}
    summary = json.loads((root / "metrics" / config.FINETUNE_PROJECT_NAME
                          / "ENZYMES_full_finetune_b1_42.summary.json").read_text())
    first, second = (cells[f"pretrain s2_42{k}"]["peak_mib"] for k in ("", ", second cell"))
    checks = {
        "1_pretrain_k1_k2": launched["pretrain s2_42"] == {
            "gin_spmm_fwd", "gin_spmm_bwd", "ntxent_fwd", "ntxent_bwd"},
        "2_second_cell_peak": bool(abs(second - first) <= DRIVER_PEAK_TOL * first),
        "3_resume_skips": not launched["pretrain s2_42 --resume"]
        and "[1/1] s2_42: already complete, skipping" in cells["pretrain s2_42 --resume"]["printed"],
        "4_dense_cell": launched["finetune ENZYMES b1"] == {"gin_spmm_fwd", "gin_spmm_bwd"}
        and all(k in summary for k in STEADY_KEYS)
        and {k: v for k, v in summary.items() if k.startswith("fidelity/")} == fidelity_block(
            DRIVER_FT_EPOCHS, 42, "pallas", processed_dir, ("ENZYMES",)),
        "5_pretrain_ready_skips": cells["finetune ENZYMES s2"]["rc"] == 2
        and not launched["finetune ENZYMES s2"]
        and "SKIPPED" in cells["finetune ENZYMES s2"]["printed"],
        "6_csr_cell": launched["finetune Cora_NC b1 csr"] == {"csr_spmm_fwd", "csr_spmm_bwd"},
        "7_jax_outputs_unchanged": jax_outputs() == before_outputs,
        "exit_codes": [c["rc"] for c in cells.values()] == [0, 0, 0, 0, 2, 0],
    }
    ok = all(checks.values())
    emit({"phase": "drivers",
          "cells": {name: {k: c[k] for k in ("rc", "seconds", "peak_mib", "launches")}
                    for name, c in cells.items()},
          "base_mib": base_mib, "steady": {k: summary.get(k) for k in STEADY_KEYS},
          "fidelity": {k: v for k, v in summary.items() if k.startswith("fidelity/")},
          "jax_outputs": {k: None if v is None else len(v) for k, v in before_outputs.items()},
          "seconds": time.perf_counter() - t0, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError(f"the drivers phase failed its checks: {checks}")


SWEEP_REQUESTER = """
import json, sys, time
from gnn_pretraining_tpu_torch.utils import runtime
wait_s, poll = float(sys.argv[1]), float(sys.argv[2])
deadline = time.monotonic() + wait_s
while not runtime.SWEEP_PIDFILE.exists():        # the first child runs its cell
    if time.monotonic() > deadline:
        sys.exit("no child recorded itself")
    time.sleep(0.05)
child = int(runtime.SWEEP_PIDFILE.read_text().split()[0])
t = time.monotonic()
got = runtime.acquire_chip(wait_s=wait_s, poll=poll)
waited = time.monotonic() - t
paused = runtime.PAUSED_FILE.read_text().split()
quiet = []
for _ in range(10):                              # ~1 s: no child starts while parked
    quiet.append(not runtime.SWEEP_PIDFILE.exists())
    time.sleep(0.1)
state = runtime._proc_stat(child)
runtime.release_chip()
print(json.dumps({"acquired": got, "waited_s": waited, "paused": paused, "first_child": child,
                  "first_child_state": None if state is None else state[0],
                  "no_child_while_parked": all(quiet)}), flush=True)
"""

SHARD_PROCESS = """
import sys
from gnn_pretraining_tpu_torch import config
config.ALL_SCHEMES, config.SEEDS = {schemes!r}, {seeds!r}
from gnn_pretraining_tpu_torch import run_pretrain
sys.exit(run_pretrain.main(sys.argv[1:]))
"""


def mem_total_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemTotal in /proc/meminfo")


def captured_main(main, argv):
    """main(argv) with this process's prints captured (children print to the
    inherited descriptors); -> (exit code, printed text)."""
    import contextlib
    import io

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = main(argv)
    print(printed.getvalue(), end="", flush=True)
    return rc, printed.getvalue()


def child_env(**extra) -> dict:
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(HERE), env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def isolate_checks(resume_dir: Path, sweep_root: Path, runtime_dir: Path, card) -> dict:
    """(a) and (b): an --isolate sweep on the card, parked for a requester at
    its chunk boundary; its --resume pass; a dead requester's file."""
    import os
    import types

    from gnn_pretraining_tpu_torch import config, run_pretrain
    from gnn_pretraining_tpu_torch.utils import runtime

    argv = [*SWEEP_ISOLATE, "--processed_dir", str(resume_dir), "--out_root", str(sweep_root)]
    requester = subprocess.Popen(
        [sys.executable, "-c", SWEEP_REQUESTER, str(SWEEP_WAIT_S), str(SWEEP_POLL)],
        stdout=subprocess.PIPE, text=True, env=child_env(TMPDIR=str(runtime_dir)))
    children, resolved = [], []
    real_call = subprocess.call

    def recording_call(cmd, **kwargs):
        children.append(cmd)
        return real_call(cmd, **kwargs)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        with mock.patch.multiple(subprocess, call=recording_call), \
                mock.patch.multiple(run_pretrain, resolve_device=lambda d: resolved.append(d)):
            rc, printed = captured_main(run_pretrain.main, argv)
            first = list(children)
            rc_resume, printed_resume = captured_main(run_pretrain.main, [*argv, "--resume"])
        out, _ = requester.communicate(timeout=SWEEP_WAIT_S)
    finally:
        if requester.poll() is None:
            requester.kill()
            requester.wait()
    seconds = time.perf_counter() - t
    orchestrator_bytes = max(torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()) - base
    report = json.loads(out.splitlines()[-1]) if requester.returncode == 0 else {}
    child_s = [float(m) for m in re.findall(r"child rc=0 \(([0-9.]+)s\)", printed)]
    args = types.SimpleNamespace(out_root=str(sweep_root), epochs=1, aggregation="pallas",
                                 processed_dir=str(resume_dir))
    done = {c: run_pretrain.cell_completed(
        config.PretrainConfig(exp_name=c.split("_")[0], seed=int(c.split("_")[1])), args)
        for c in SWEEP_ISOLATE_CELLS}
    # A pause request whose owner is gone: discarded, the sweep not parked.
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()
    runtime.PAUSE_FILE.write_text(f"{gone.pid} 1")
    t_dead = time.perf_counter()
    runtime.honor_pause("dead requester")
    dead_s = time.perf_counter() - t_dead
    checks = {
        "a_children": rc == 0 and len(first) == 2 and all(
            c[1:3] == ["-m", "gnn_pretraining_tpu_torch.run_pretrain"] for c in first)
        and len(child_s) == 2 and all(done.values()),
        "a_resume_starts_no_child": rc_resume == 0 and len(children) == 2
        and printed_resume.count("all complete, skipping child") == 2,
        "a_orchestrator_no_card": orchestrator_bytes == 0 and not resolved,
        "b_parked_at_boundary": report.get("acquired") is True
        and report.get("paused", [None])[0] == str(os.getpid())
        and report.get("paused", [])[-1:] == ["2-2"]
        and "sweep parked at cells 2-2" in printed and "sweep resuming" in printed,
        "b_no_child_while_parked": report.get("no_child_while_parked") is True
        and report.get("first_child_state") in (None, "Z"),
        "b_dead_requester_discarded": not runtime.PAUSE_FILE.exists() and dead_s < 1.0,
    }
    emit({"phase": "sweep", "part": "a isolate, b pause", "card": card, "cells": done,
          "child_seconds": child_s, "orchestrator_seconds": seconds,
          "orchestrator_card_bytes": orchestrator_bytes, "requester": report,
          "children": [c[3:] for c in first], "checks": checks})
    return checks


def reclaim_checks(runtime_dir: Path, card) -> dict:
    """(c): a recorded sleeping process is reclaimed; a pidfile whose start
    time is not the live process's is removed and nothing is signalled."""
    from gnn_pretraining_tpu_torch.utils import runtime

    path = runtime_dir / "reclaim.pid"
    recorded = subprocess.Popen(
        [sys.executable, "-c", "import sys, time\n"
         "from gnn_pretraining_tpu_torch.utils.runtime import write_pidfile\n"
         "write_pidfile(sys.argv[1]); time.sleep(120)", str(path)], env=child_env())
    stale = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        deadline = time.monotonic() + 60
        while not path.exists() and time.monotonic() < deadline and recorded.poll() is None:
            time.sleep(0.05)
        t = time.perf_counter()
        reclaimed = runtime.reclaim_chip(path, wait_s=10.0)
        reclaim_s = time.perf_counter() - t
        recorded_rc = recorded.wait(timeout=30)
        stale_path = runtime_dir / "stale.pid"
        stale_path.write_text(f"{stale.pid} {runtime._proc_stat(stale.pid)[1] + 1}")
        signalled = runtime.reclaim_chip(stale_path, wait_s=5.0)
        stale_alive = stale.poll() is None
    finally:
        for proc in (recorded, stale):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    checks = {"c_reclaimed": reclaimed and recorded_rc == -15 and not path.exists(),
              "c_stale_not_signalled": not signalled and stale_alive
              and not stale_path.exists()}
    emit({"phase": "sweep", "part": "c reclaim", "card": card, "reclaim_seconds": reclaim_s,
          "recorded_rc": recorded_rc, "checks": checks})
    return checks


def rss_checks(processed_dir: Path, resume_dir: Path, rss_root: Path, card) -> dict:
    """(d): host RSS and the card's peak memory after each cell of
    an in-process sweep, and whether maybe_clear_caches fired."""
    from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
    from gnn_pretraining_tpu_torch.utils import runtime

    rows = []

    def recorder(driver):
        def record():
            fired = runtime.maybe_clear_caches()
            torch.cuda.synchronize()
            rows.append({"rss_gib": runtime.rss_gb(),
                         "peak_allocated_mib": torch.cuda.max_memory_allocated() / 2**20,
                         "peak_reserved_mib": torch.cuda.max_memory_reserved() / 2**20,
                         "allocated_mib": torch.cuda.memory_allocated() / 2**20,
                         "cleared": fired})
            torch.cuda.reset_peak_memory_stats()
            return fired
        return mock.patch.multiple(driver, maybe_clear_caches=record)

    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = runtime.rss_gb()
    t = time.perf_counter()
    (schemes, seeds), (domains, ft_seeds) = RSS_PRETRAIN, RSS_FINETUNE
    with recorder(run_pretrain), mock.patch.multiple(config, ALL_SCHEMES=schemes, SEEDS=seeds):
        rc_pre, _ = captured_main(run_pretrain.main, [
            "--sweep", "--epochs", "1", "--processed_dir", str(resume_dir),
            "--out_root", str(rss_root)])
    with recorder(run_finetune), mock.patch.multiple(config, FINETUNE_DOMAINS=domains,
                                         FINETUNE_STRATEGIES=("full_finetune",),
                                         FINETUNE_SCHEMES=("b1",), SEEDS=ft_seeds):
        rc_ft, _ = captured_main(run_finetune.main, [
            "--sweep", "--epochs", "1", "--processed_dir", str(processed_dir),
            "--out_root", str(rss_root)])
    names = ([f"{e}_{s}" for e in schemes for s in seeds]
             + [f"{d}_full_finetune_b1_{s}" for d in domains for s in ft_seeds])
    for name, row in zip(names, rows):
        row["cell"] = name
    checks = {"d_cells": rc_pre == 0 and rc_ft == 0 and len(rows) == len(names) >= 6}
    emit({"phase": "sweep", "part": "d host RSS", "card": card, "mem_total_gib": mem_total_gib(),
          "clear_threshold_gib": runtime.CLEAR_CACHES_RSS_GB, "rss_gib_before": before,
          "cells": rows, "seconds": time.perf_counter() - t, "checks": checks})
    return checks


def shard_checks(resume_dir: Path, shard_root: Path, runtime_dir: Path, card) -> dict:
    """(e): two processes of a launcher on the one card split SHARD_GRID into
    grid[0::2] and grid[1::2]."""
    schemes, seeds = SHARD_GRID
    grid = [f"{e}_{s}" for e in schemes for s in seeds]
    code = SHARD_PROCESS.format(schemes=schemes, seeds=seeds)
    argv = ["--sweep", "--epochs", "1", "--processed_dir", str(resume_dir),
            "--out_root", str(shard_root)]
    logs = [shard_root / f"rank{rank}.log" for rank in (0, 1)]
    shard_root.mkdir(parents=True)
    t = time.perf_counter()
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, *argv], stdout=f, stderr=subprocess.STDOUT,
                env=child_env(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK="0",
                              TMPDIR=str(runtime_dir))))
    for proc in procs:
        proc.wait(timeout=600)
    seconds = time.perf_counter() - t
    outs = [log.read_text() for log in logs]
    ran = [re.findall(r"^\[\d+/\d+\] (\S+): best_val=", out, re.M) for out in outs]
    for out in outs:
        print(out, end="", flush=True)
    checks = {"e_split": [p.returncode for p in procs] == [0, 0]
              and ran == [grid[0::2], grid[1::2]] and sorted(ran[0] + ran[1]) == sorted(grid)}
    emit({"phase": "sweep", "part": "e launcher shards", "card": card, "grid": grid,
          "ran": ran, "seconds": seconds, "checks": checks})
    return checks


def exporter_checks(device, processed_dir: Path, out_root: Path, sweep_root: Path,
                    art: Path, card) -> dict:
    """(f): export_artifacts.main(argv) on the earlier phases' checkpoints; the
    manifest's sha256 and bytes recomputed from the files; each serving
    artifact replayed on the card against its eager model."""
    import hashlib

    from gnn_pretraining_tpu_torch import export_artifacts, make_embedding_fn, make_serving_fn
    from gnn_pretraining_tpu_torch import serving

    common = ["--artifacts_dir", str(art), "--processed_dir", str(processed_dir),
              "--platforms", ARTIFACT_PLATFORMS]
    t = time.perf_counter()
    rc = [captured_main(export_artifacts.main, ["--out_root", str(out_root), "--seeds", "42",
                                                *common])[0],
          captured_main(export_artifacts.main, ["--out_root", str(sweep_root), "--seeds", "84",
                                                *common])[0]]
    export_s = time.perf_counter() - t
    manifest = json.loads((art / "MANIFEST.json").read_text())
    files_ok = all(
        (art / k).stat().st_size == e["bytes"]
        and hashlib.sha256((art / k).read_bytes()).hexdigest() == e["sha256"]
        for k, e in manifest.items())
    replay = {}
    rng = np.random.default_rng(SEED + 11)
    for key, entry in sorted(manifest.items()):
        if not key.startswith("serving/"):
            continue
        embed = bool(entry.get("embed"))
        domain = entry.get("domain") or Path(key).stem.rsplit("_", 1)[0]
        example = export_artifacts.serving_example(domain, processed_dir, embed=embed)
        model = export_artifacts.load_model(entry["source"], domain, "coo", embed, device)
        if embed:
            eager, names = make_embedding_fn(model)
        else:
            eager, names = make_serving_fn(model)
            if model.task_type == "graph_classification":
                eager = eager(example["num_graphs"])
        for k in ("score_senders", "score_receivers"):
            if k in example:
                example[k] = rng.integers(0, entry["bucket"]["num_nodes"],
                                          example[k].shape).astype(np.int32)
        inputs = [torch.from_numpy(np.asarray(example[n])).to(device) for n in names]
        with torch.no_grad():
            ref = eager(*inputs)
            got = serving.load_artifact(art / key)(*inputs)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        replay[key] = {"max_rel_err": err, "ok": bool(got.device.type == "cuda"
                                                      and torch.isfinite(got).all()
                                                      and err <= ARTIFACT_TOL)}
    want = {"transfer/backbone_s2_42.msgpack", "transfer/backbone_s5_42.msgpack",
            "transfer/backbone_b2_84.msgpack", "transfer/backbone_s2_84.msgpack",
            "serving/ENZYMES_b2.pt2", "serving/Cora_NC_b2.pt2", "serving/Cora_LP_b2.pt2",
            "serving/ENZYMES_embed_b2.pt2"}
    checks = {"f_exported": rc == [0, 0] and want <= set(manifest),
              "f_manifest_is_the_files": files_ok,
              "f_replayed": bool(replay) and all(r["ok"] for r in replay.values())}
    emit({"phase": "sweep", "part": "f exporter", "card": card, "export_seconds": export_s,
          "artifacts": {k: e["bytes"] for k, e in manifest.items()}, "replay": replay,
          "tol": ARTIFACT_TOL, "checks": checks})
    return checks


def sweep_phase(device, processed_dir: Path, resume_dir: Path, out_root: Path, tmp: Path,
                card) -> None:
    """Checks (a)-(f) of the module docstring's sweep phase, with the
    runtime's files in a directory of their own (the children's TMPDIR)."""
    import os

    from gnn_pretraining_tpu_torch.utils import runtime

    t0 = time.perf_counter()
    runtime_dir = tmp / "runtime"
    runtime_dir.mkdir(parents=True)
    files = {name: runtime_dir / getattr(runtime, name).name
             for name in ("SWEEP_PIDFILE", "PAUSE_FILE", "PAUSED_FILE")}
    tmpdir = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(runtime_dir)       # the isolate children's runtime files
    try:
        with mock.patch.multiple(runtime, **files):
            checks = {**isolate_checks(resume_dir, tmp / "isolate", runtime_dir, card),
                      **reclaim_checks(runtime_dir, card),
                      **rss_checks(processed_dir, resume_dir, tmp / "rss", card),
                      **shard_checks(resume_dir, tmp / "shards", runtime_dir, card),
                      **exporter_checks(device, processed_dir, out_root, tmp / "isolate",
                                        tmp / "exported", card)}
    finally:
        if tmpdir is None:
            os.environ.pop("TMPDIR", None)
        else:
            os.environ["TMPDIR"] = tmpdir
    failed = [name for name, ok in checks.items() if not ok]
    emit({"phase": "sweep", "seconds": time.perf_counter() - t0, "card": card,
          "failed": failed, "ok": not failed})
    if failed:
        raise AssertionError(f"the sweep phase failed its checks: {failed}")


class RowMap:
    """Where the real rows of each rank's batch sit in the union batch (rank
    0's graphs first) that a single process steps on: node, edge, pair (the
    link predictor's [positive edges; negatives]) and graph rows."""

    def __init__(self, rank_batches):
        self.nodes, self.edges, self.pads = [], [], []
        n_off = e_off = 0
        for b in rank_batches:
            n, e = int(b.node_mask.sum()), int(b.edge_mask.sum())
            self.nodes.append(n_off + torch.arange(n))
            self.edges.append(e_off + torch.arange(e))
            self.pads.append((b.num_nodes, b.num_edges, b.num_graphs))
            n_off, e_off = n_off + n, e_off + e
        from gnn_pretraining_tpu_torch.data.batch import round_up

        self.union = (round_up(n_off), round_up(e_off))

    def kind(self, rows: int) -> str:
        n_pad, e_pad, g = self.pads[0]
        kinds = {n_pad: "node", 2 * e_pad: "pair", g: "graph"}
        if len(kinds) != 3:
            raise AssertionError(f"rank rows of two kinds coincide: {self.pads[0]}")
        return kinds[rows]

    def to_rank(self, a: torch.Tensor, kind: str, r: int, dim: int = 0) -> torch.Tensor:
        """Rank r's rows of the union rows ``a`` (its padding rows 0)."""
        rows = (self.nodes if kind == "node" else self.edges)[r].to(a.device)
        shape = list(a.shape)
        shape[dim] = self.pads[r][0 if kind == "node" else 1]
        out = a.new_zeros(shape)
        out.narrow(dim, 0, len(rows)).copy_(a.index_select(dim, rows))
        return out

    def to_union(self, arrays, fill) -> torch.Tensor:
        """The union rows of the ranks' ``arrays`` (same shape on every rank:
        the ranks share their pads); the union's padding rows ``fill``."""
        kind = self.kind(arrays[0].shape[0])
        if kind == "graph":
            return torch.cat(list(arrays))
        n_u, e_u = self.union
        out = torch.full(((n_u if kind == "node" else 2 * e_u), *arrays[0].shape[1:]), fill,
                         dtype=arrays[0].dtype)
        for r, a in enumerate(arrays):
            if kind == "node":
                out[self.nodes[r]] = a[:len(self.nodes[r])]
            else:
                e_r, rows = self.pads[r][1], self.edges[r]
                out[rows] = a[:len(rows)]
                out[e_u + rows] = a[e_r:e_r + len(rows)]
        return out


def union_of(stores: dict, picked: list, maps: dict, with_properties: bool) -> dict:
    """{domain: the batch of every rank's graphs, rank 0's first}."""
    from gnn_pretraining_tpu_torch.data.batch import build_batch

    out = {}
    for d, store in stores.items():
        ix = np.concatenate([p[d] for p in picked])
        out[d] = build_batch(store, ix, *maps[d].union, len(ix),
                             with_properties=with_properties)
    return out


def tagged_recording(model, tasks_module, domain=None):
    """Within the block, every ReLU call's ``x > 0``, every dropout keep-mask
    and every max pool's winners (``utils/relu_branches``'s), each as (domain
    of the forward, tensor on the host): the domain is ``domain``, else that
    of the model's last ``encode``."""
    import contextlib

    from torch import nn

    @contextlib.contextmanager
    def block():
        now = [domain]
        out = {"branches": [], "pooled": [], "dropout": []}
        real_encode, source = getattr(model, "encode", None), model.dropout
        real_max = tasks_module.segment_max
        real_keep = source.keep_mask

        def encode(x, mask, d):
            now[0] = d
            return real_encode(x, mask, d)

        def keep_mask(x, rate):
            keep = real_keep(x, rate)
            out["dropout"].append((now[0], keep.detach().cpu()))
            return keep

        def segment_max(data, ids, num, mask):
            top = real_max(data, ids, num, mask)
            won = (data.detach() == top.detach()[ids.long()]) & mask.bool()[:, None]
            out["pooled"].append((now[0], won.cpu()))
            return top

        hooks = [m.register_forward_pre_hook(
            lambda _m, args: out["branches"].append((now[0], (args[0].detach() > 0).cpu())))
            for m in model.modules() if isinstance(m, nn.ReLU)]
        if domain is None:
            model.encode = encode
        source.keep_mask, tasks_module.segment_max = keep_mask, segment_max
        try:
            yield out
        finally:
            for h in hooks:
                h.remove()
            model.__dict__.pop("encode", None)
            source.keep_mask, tasks_module.segment_max = real_keep, real_max

    return block()


def union_records(ranks: list, maps: dict, key: str, fill, device):
    """The union batch's records of ``key`` from every rank's, call by call."""
    calls = zip(*(out[key] for out in ranks))
    return [maps[tagged[0][0]].to_union([t for _, t in tagged], fill).to(device)
            for tagged in calls]


def moved(obj, device):
    """``obj`` with every tensor (in GraphBatches, named tuples, lists,
    dicts) on ``device``."""
    if torch.is_tensor(obj) or hasattr(obj, "to") and dataclasses.is_dataclass(obj):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(moved(x, device) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(moved(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    return obj


def event_median(fn, reps: int = DP_TIMING_REPS) -> float:
    """Median CUDA-event ms of ``reps`` calls made back to back after one
    warm-up call, the host's launches included."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def gloo_cuda_collectives(device) -> dict:
    """Which collectives gloo runs on tensors of ``device`` (the card): each
    tried once on a group of its own (30 s timeout), after the checked work;
    a refusal is recorded, and nothing else depends on it."""
    import datetime

    import torch.distributed as dist

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device=device)
    n = dist.get_world_size(group)
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x,
                                              group=group),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty_like(x), [x.clone() for _ in range(n)], group=group),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty_like(x) for _ in range(n)], [x.clone() for _ in range(n)],
            group=group)}
    out = {}
    for name, probe in probes.items():
        try:
            probe()
            torch.cuda.synchronize()
            out[name] = "runs"
        except (RuntimeError, ValueError, NotImplementedError) as err:
            out[name] = "refused: " + str(err).strip().splitlines()[0][:160]
    return out


def dp_pretrain_rank(axis, inputs) -> dict:
    """This rank's s5 data-parallel step on its share, with the union's draws
    (its rows) injected and every kink and keep-mask recorded; a second step
    on its own draws; the step's time."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.parallel.data_parallel import make_dp_train_step
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain import tasks
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer

    dev = axis.device
    mine = moved(inputs["ranks"][axis.rank], dev)
    cfg = config.PretrainConfig(DP_SCHEME, 42)
    model = pt.build_pretrain_model(cfg, "pallas", dev, axis)
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    streams = pt.random_streams(cfg, model, dev, axis)
    streams["views"].inject(mine["views"])
    streams["task_draws"].inject(mine["mask_scores"], mine["negatives"])
    step = make_dp_train_step(model, cfg, optimizer, inputs["total_steps"], axis,
                              streams["views"], streams["pcgrad"], streams["task_draws"])
    state = pt.PretrainState()
    kernels = counters()
    for c in kernels.values():
        c.launches = 0
    with tagged_recording(model, tasks) as rec:
        metrics = step(state, mine["batches"], perm=inputs["perm"])
    torch.cuda.synchronize()
    names = [n for n, _ in model.named_parameters()]
    out = {"launches": {name: c.launches for name, c in kernels.items()},
           "metrics": {k: float(v) for k, v in metrics.items()},
           "task_grads": {t: {n: g.cpu() for n, g in zip(names, gs)}
                          for t, gs in step.last_task_grads.items()},
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()}, **rec}
    step(state, mine["second"])
    out["after_two"] = {k: v.cpu() for k, v in model.state_dict().items()}
    out["step_ms"] = event_median(lambda: step(state, mine["second"]))
    return out


def dp_gc_rank(axis, inputs) -> dict:
    """This rank's graph-classification data-parallel train and eval steps
    on its share of one batch, kinks and keep-masks recorded."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.gc_data_parallel import (
        make_gc_steps_data_parallel,
    )
    from gnn_pretraining_tpu_torch.pretrain import tasks

    cfg = config.FinetuneConfig(*DP_GC_CELL, "b1", 42)
    model = ft.build_finetune_model(cfg, "coo", axis.device, axis=axis)
    optimizer, labels, _ = ft.create_finetune_optimizer(model, cfg)
    train, evaluate = make_gc_steps_data_parallel(model, cfg, optimizer, labels, axis)
    batch = inputs["ranks"][axis.rank]["gc"].to(axis.device)
    with tagged_recording(model, tasks, cfg.domain_name) as rec:
        out = train(batch)
    grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
    return {"gc_train": [x.cpu() for x in out], "gc_eval": [x.cpu() for x in evaluate(batch)],
            "gc_grads": grads, "gc_branches": rec["branches"], "gc_dropout": rec["dropout"],
            "gc_step_ms": event_median(lambda: train(batch))}


def dp_rank_main() -> None:
    """One rank of the dp phase (``python -c "import chip_smoke;
    chip_smoke.dp_rank_main()" RANK TMP``): a group of the phase's ranks
    over a FileStore in TMP, gloo on the one card or NCCL with a card per
    rank; writes TMP/rank<RANK>.pt."""
    import torch.distributed as dist

    rank, tmp = int(sys.argv[1]), Path(sys.argv[2])
    import_port()
    from gnn_pretraining_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    n, device = len(inputs["ranks"]), inputs["device"]
    if inputs["backend"] == "nccl":
        device = f"cuda:{rank}"
        torch.cuda.set_device(device)
    dist.init_process_group(inputs["backend"], store=dist.FileStore(str(tmp / "store"), n),
                            rank=rank, world_size=n)
    try:
        axis = make_mesh(device, dist.group.WORLD)
        out = {**dp_pretrain_rank(axis, inputs), **dp_gc_rank(axis, inputs)}
        out["collectives"] = gloo_cuda_collectives(axis.device)
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def grad_errs(got: dict, want: dict) -> dict:
    """max |diff| / max |want| and ||diff|| / ||want|| over the leaves."""
    g_max = max(float(g.abs().max()) for g in want.values())
    l2 = math.sqrt(sum(float(g.double().pow(2).sum()) for g in want.values()))
    diff = {n: (got[n].to(want[n].device) - want[n]) for n in want}
    return {"max": max(float(d.abs().max()) for d in diff.values()) / g_max,
            "l2": math.sqrt(sum(float(d.double().pow(2).sum()) for d in diff.values())) / l2}


def dp_phase(device, processed_dir: Path, resume_dir: Path, tmp: Path, card,
             n: int = DP_RANKS, backend: str = "gloo") -> dict:
    """The dp phase of the module docstring on ``n`` ranks (gloo on one card,
    or NCCL with a card per rank: tools/dp_cards.py); returns the launches
    of its paths (every rank's checked step and run_pretrain --dp auto)."""
    import types

    from gnn_pretraining_tpu_torch import config, run_pretrain
    from gnn_pretraining_tpu_torch.data.batch import GraphStore, build_batch
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.gc_data_parallel import build_sharded_gc_batches
    from gnn_pretraining_tpu_torch.ops.sampling import NegativeDraws
    from gnn_pretraining_tpu_torch.parallel import data_parallel as dp
    from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
    from gnn_pretraining_tpu_torch.pretrain import tasks
    from gnn_pretraining_tpu_torch.pretrain.augmentations import GraphView
    from gnn_pretraining_tpu_torch.utils import relu_branches
    from gnn_pretraining_tpu_torch.utils.fidelity import fidelity_block

    t0 = time.perf_counter()
    tmp.mkdir(parents=True)
    # Every rank draws two steps from a copy of the same sampler state; the
    # single process steps on the union of the first step's shares.
    loaders = [pretrain_loader(processed_dir, DP_SCHEME) for _ in range(n)]
    cfg, sampler = loaders[0]
    pads = dp.dp_pads(sampler, n)
    picked, steps, real = [], [], dp.build_batch
    with mock.patch.object(dp, "build_batch", lambda store, ix, *a, **k: (
            picked.append(np.asarray(ix)), real(store, ix, *a, **k))[1]):
        for _ in range(2):
            shares = []
            for r, (_, s) in enumerate(loaders):
                picked.clear()
                shares.append((dp.shard_sampler_step(s, n, r, pads),
                               dict(zip(s.domain_stores, picked))))
            steps.append(shares)
    first = steps[0]
    maps = {d: RowMap([b[d] for b, _ in first]) for d in cfg.pretrain_domains}
    union = {d: b.to(device) for d, b in union_of(
        sampler.domain_stores, [p for _, p in first], maps, True).items()}
    views, masks, negatives, perm = step_draws(cfg, union, device)
    order = sorted(cfg.pretrain_domains)
    view_domains = [d for t in cfg.active_tasks if t in ("node_contrast", "graph_contrast")
                    for d in order]

    def rank_draws(r):
        out = {"views": [], "mask_scores": [maps[d].to_rank(m, "node", r).cpu()
                                            for m, d in zip(masks, order)],
               "negatives": [NegativeDraws(*(maps[d].to_rank(x, "edge", r, dim).cpu()
                                             for x, dim in zip(n, (1, 1, 0))))
                             for n, d in zip(negatives, order)]}
        for (v1, v2, common), d in zip(views, view_domains):
            m = maps[d]
            view = lambda v: GraphView(*(m.to_rank(x, k, r).cpu() for x, k in  # noqa: E731
                                         zip(v, ("node", "node", "edge"))))
            out["views"].append((view(v1), view(v2), m.to_rank(common, "node", r).cpu()))
        return out

    gc_cfg = config.FinetuneConfig(*DP_GC_CELL, "b1", 42)
    gc_store = GraphStore.load(processed_dir / f"{gc_cfg.domain_name}.npz")
    gc_subs = build_sharded_gc_batches(gc_store, "train", gc_cfg.batch_size, n)[0]
    gc_map = RowMap(gc_subs)
    ix = np.asarray(gc_store.splits["train"], np.int64)[:gc_cfg.batch_size]
    gc_union = build_batch(gc_store, np.concatenate([ix[r::n] for r in range(n)]),
                           *gc_map.union, gc_cfg.batch_size).to(device)
    total_steps = len(sampler) * PRETRAIN_ENTRY_EPOCHS
    torch.save({"total_steps": total_steps, "perm": perm, "device": str(device),
                "backend": backend,
                "ranks": [{"batches": first[r][0], "second": steps[1][r][0], "gc": gc_subs[r],
                           **rank_draws(r)} for r in range(n)]}, tmp / "inputs.pt")

    t_ranks = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import chip_smoke; chip_smoke.dp_rank_main()", str(r), str(tmp)],
                              cwd=HERE, env=child_env(OMP_NUM_THREADS="4"))
             for r in range(n)]
    try:
        rcs = [p.wait(timeout=DP_RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"dp ranks exited {rcs}")
    rank_seconds = time.perf_counter() - t_ranks
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(n)]
    emit({"phase": "dp", "gloo_on_cuda_tensors": ranks[0]["collectives"],
          "torch": torch.__version__, "card": card})

    # The single process on the union, on the same draws, kinks and keep-masks.
    from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource
    from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer

    twin = pt.build_pretrain_model(cfg, "pallas", device)
    optimizer, _, _ = create_task_specific_optimizer(twin, cfg.active_tasks)
    source, draws = ViewSource(device, seed=SEED), tasks.TaskDraws(device, seed=SEED)
    source.inject(views)
    draws.inject(masks, negatives)
    twin.dropout.inject(union_records(ranks, maps, "dropout", 1.0, device))
    step = pt.make_train_step(twin, cfg, optimizer, total_steps, source, draws=draws)
    state = pt.PretrainState()
    start = {k: v.cpu() for k, v in twin.state_dict().items()}
    with relu_branches.replay(twin, union_records(ranks, maps, "branches", False, device)) \
            as flips, relu_branches.max_pool(
                tasks, replay=union_records(ranks, maps, "pooled", False, device)) as pool_flips:
        twin_out = {k: float(v) for k, v in step(state, union, perm=perm).items()}
    names = [n for n, _ in twin.named_parameters()]
    got = ranks[0]
    losses = {k: (got["metrics"][k], v) for k, v in twin_out.items()
              if k.startswith("train/loss/")}
    loss_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in losses.values())
    per_task = {t: grad_errs(got["task_grads"][t], dict(zip(names, gs)))
                for t, gs in step.last_task_grads.items()}
    combined = grad_errs(got["grads"], {n: p.grad for n, p in twin.named_parameters()})
    after = [out["after_two"] for out in ranks]
    bitwise = all(torch.equal(after[0][k], a[k]) for a in after[1:] for k in after[0])
    moved_after = any(not torch.equal(after[0][k], v) for k, v in start.items())
    twin_ms = event_median(lambda: step(state, union))
    expected = launches_of(DP_SCHEME)
    pre_ok = bool(all(out["launches"] == expected for out in ranks)
                  and all(out["metrics"] == got["metrics"] for out in ranks)
                  and set(twin_out) == set(got["metrics"]) == expected_step_keys(cfg)
                  and all(math.isfinite(a) for a, _ in losses.values())
                  and loss_err <= TRAIN_LOSS_TOL
                  and all(e["max"] <= TRAIN_GRAD_TOL and e["l2"] <= TRAIN_GRAD_TOL
                          for e in per_task.values())
                  and combined["l2"] <= TRAIN_GRAD_TOL and bitwise and moved_after)
    emit({"phase": "dp", "step": DP_SCHEME, "ranks": n, "backend": backend,
          "node_pads_per_rank": {d: pads[d][0] for d in order},
          "node_pads_union": {d: b.num_nodes for d, b in union.items()},
          "launches_per_rank": [out["launches"] for out in ranks], "expected": expected,
          "loss_max_rel_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
          "losses_dp_vs_single": {k: v for k, v in losses.items() if k.count("/") == 2},
          "task_grad_err": per_task, "combined_grad_err": combined,
          "grad_tol": TRAIN_GRAD_TOL, "relu_flips_replayed": sum(flips),
          "max_pool_flips_replayed": sum(pool_flips),
          "ranks_bitwise_equal_after_two_steps": bitwise,
          "dp_step_ms_per_rank": [out["step_ms"] for out in ranks],
          "single_step_ms": twin_ms, "card": card, "ok": pre_ok})

    gc_twin = ft.build_finetune_model(gc_cfg, "coo", device)
    gc_opt, gc_labels, _ = ft.create_finetune_optimizer(gc_twin, gc_cfg)
    gc_train, gc_eval = ft.make_gc_steps(gc_twin, gc_cfg, gc_opt, gc_labels)
    gc_maps = {gc_cfg.domain_name: gc_map}
    gc_twin.dropout.inject(union_records(ranks, gc_maps, "gc_dropout", 1.0, device))
    with relu_branches.replay(gc_twin, union_records(ranks, gc_maps, "gc_branches", False,
                                                     device)):
        t_loss, t_y, _, t_probs, _ = gc_train(gc_union)
    t_eval = float(gc_eval(gc_union)[0])
    loss, y, _, probs, _ = got["gc_train"]
    gc_grads = grad_errs(got["gc_grads"], {n: p.grad for n, p in gc_twin.named_parameters()
                                           if p.grad is not None})
    gc_loss_err = abs(float(loss) - float(t_loss)) / abs(float(t_loss))
    eval_err = abs(float(got["gc_eval"][0]) - t_eval) / abs(t_eval)
    gc_twin_ms = event_median(lambda: gc_train(gc_union))
    gc_ok = bool(gc_loss_err <= TRAIN_LOSS_TOL and torch.equal(y, t_y.cpu())
                 and float((probs - t_probs.cpu()).abs().max()) <= TRAIN_GRAD_TOL
                 and gc_grads["max"] <= TRAIN_GRAD_TOL and gc_grads["l2"] <= TRAIN_GRAD_TOL
                 and eval_err <= DP_EVAL_TOL
                 and all(torch.equal(out["gc_train"][0], loss) for out in ranks))
    emit({"phase": "dp", "cell": "/".join(DP_GC_CELL), "graphs_per_rank": gc_map.pads[0][2],
          "loss_rel_err": gc_loss_err, "probs_max_abs_err": float((probs - t_probs.cpu())
                                                                  .abs().max()),
          "grad_err": gc_grads, "eval_loss_rel_err": eval_err, "eval_tol": DP_EVAL_TOL,
          "dp_step_ms_per_rank": [out["gc_step_ms"] for out in ranks],
          "single_step_ms": gc_twin_ms, "card": card, "ok": gc_ok})

    # run_pretrain --dp auto: on one card the single-device path; on k
    # cards k ranks of it, whose launches this process does not see.
    one_card = device.type != "cuda" or torch.cuda.device_count() == 1
    kernels = counters()
    for c in kernels.values():
        c.launches = 0
    root = tmp / "dp_auto"
    s2 = config.PretrainConfig("s2", 42)
    rc, _ = captured_main(run_pretrain.main, [
        "--exp_name", "s2", "--seed", "42", "--epochs", "1", "--dp", "auto",
        "--processed_dir", str(resume_dir), "--out_root", str(root)])
    auto_launches = {name: c.launches for name, c in kernels.items()}
    summary = json.loads((root / "metrics" / config.PRETRAIN_PROJECT_NAME
                          / f"{s2.run_name}.summary.json").read_text())
    block = {k: v for k, v in summary.items() if k.startswith("fidelity/")}
    plain = types.SimpleNamespace(out_root=str(root), epochs=1, aggregation="pallas",
                                  processed_dir=str(resume_dir))
    auto_ok = bool(rc == 0 and block == fidelity_block(1, 42, "pallas", str(resume_dir),
                                                       s2.pretrain_domains)
                   and run_pretrain.cell_completed(s2, plain)
                   and not torch.distributed.is_initialized()
                   and (not one_card or all(auto_launches[k] > 0
                                            for k in ("gin_spmm_fwd", "ntxent_fwd"))))
    emit({"phase": "dp", "run_pretrain": "--dp auto, s2, 1 epoch",
          "cards": torch.cuda.device_count() if device.type == "cuda" else 0, "rc": rc,
          "fidelity": block, "cell_completed_without_dp": auto_ok, "launches": auto_launches,
          "ok": auto_ok})
    launches = {name: sum(out["launches"][name] for out in ranks) + auto_launches[name]
                for name in kernels}
    emit({"phase": "dp", "seconds": time.perf_counter() - t0, "ranks_seconds": rank_seconds,
          "card": card, "ok": pre_ok and gc_ok and auto_ok})
    if not (pre_ok and gc_ok and auto_ok):
        raise AssertionError(f"the dp phase failed its checks: step {pre_ok}, gc {gc_ok}, "
                             f"run_pretrain --dp auto {auto_ok}")
    return launches


def keep_mask_recording(source):
    """Within the block, every keep-mask ``source`` hands out, on the host,
    in call order."""
    import contextlib

    @contextlib.contextmanager
    def block():
        real, masks = source.keep_mask, []

        def keep_mask(x, rate):
            keep = real(x, rate)
            masks.append(keep.detach().cpu())
            return keep

        source.keep_mask = keep_mask
        try:
            yield masks
        finally:
            source.keep_mask = real

    return block()


def partition_cell(cfg, processed_dir: Path, device, axis=None, mode=None):
    """``cfg``'s full-graph cell built as ``finetune()`` builds it: the
    single-device ``coo`` steps, or with ``mode`` the edge- or
    node-partitioned ones on ``axis``. A namespace of the model, the head's
    own dropout source (node) or None, the steps, their first train and val
    arguments, the optimizer's labels and learning rates and the train
    graph (on the host)."""
    import types

    from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.node_parallel import (
        HaloAggregate,
        replicate_head_dropout,
    )

    data = {split: create_finetune_arrays(cfg.domain_name, split, cfg.batch_size,
                                          processed_dir) for split in ("train", "val")}
    head = None
    if mode == "edge":
        model = ft.build_finetune_model(cfg, "coo", device, edge_axis=axis)
    elif mode == "node":
        model = ft.build_finetune_model(cfg, "coo", device, axis=axis,
                                        aggregate_fn=HaloAggregate(axis))
        head = replicate_head_dropout(model, cfg.seed + 1)
    else:
        model = ft.build_finetune_model(cfg, "coo", device)
    optimizer, labels, lrs = ft.create_finetune_optimizer(model, cfg)
    train, evaluate, train_batches, eval_batches = ft.build_steps(
        cfg, model, optimizer, labels, data, device, axis, partition=mode)
    return types.SimpleNamespace(
        model=model, head=head, train=train, evaluate=evaluate,
        targs=next(iter(train_batches()))[1], eargs=next(iter(eval_batches("val")))[1],
        labels=labels, lrs=lrs, graph=data["train"].graph)


def to_rank_rows(records, n_loc: int, axis, fill):
    """Each record (rows of the whole graph) cut to this rank's ``n_loc``
    rows of the plan's layout, its padding rows ``fill``."""
    out = []
    for a in records:
        pad = a.new_full((axis.size * n_loc - a.shape[0], *a.shape[1:]), fill)
        out.append(torch.cat([a, pad])[axis.rank * n_loc:(axis.rank + 1) * n_loc])
    return out


def partition_rank_cells(axis, inputs) -> dict:
    """(a) and (b) on this rank: for each cell and mode, the eval step on
    the twin's starting weights, a train step with the twin's keep-masks,
    ReLU branches and mined pairs (a node rank takes its rows), a second on
    its own draws (its own mining), then the step's CUDA-event median; (c)
    each mode's train step median and eval loss on the 6x store."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.utils import relu_branches

    dev, out = axis.device, {"launches": {}, "cells": {}, "scale": {}}
    kernels = counters()
    for c in kernels.values():
        c.launches = 0
    for spec in inputs["cells"]:
        cfg = config.FinetuneConfig(spec["domain"], "full_finetune", "b1", 42)
        for mode in PART_MODES:
            cell = partition_cell(cfg, Path(inputs["processed_dir"]), dev, axis, mode)
            model, head, train = cell.model, cell.head, cell.train
            model.load_state_dict(moved(spec["state"], dev))
            ev = [x.cpu() for x in cell.evaluate(*cell.eargs)]
            # The records of the encoder and the backbone have a row per
            # node; the link predictor's (pairs) are replicated.
            nodes = spec["nodes"]
            trunk = [m for m in spec["masks"] if m.shape[0] == nodes]
            head_masks = [m for m in spec["masks"] if m.shape[0] != nodes]
            branches = spec["branches"]
            if mode == "node":
                n_loc = cell.targs[-1].x.shape[0]
                trunk = to_rank_rows(trunk, n_loc, axis, 1.0)
                branches = [to_rank_rows([b], n_loc, axis, False)[0] if b.shape[0] == nodes
                            else b for b in branches]
                model.dropout.inject(moved(trunk, dev))
                head.inject(moved(head_masks, dev))
            else:
                model.dropout.inject(moved(spec["masks"], dev))
            kw = ({} if spec["negatives"] is None
                  else {"negatives": moved(spec["negatives"], dev)})
            with relu_branches.replay(model, moved(branches, dev)) as flips:
                step = [x.detach().cpu().clone() for x in train(*cell.targs, **kw)]
            if model.dropout.injected or (head is not None and head.injected):
                raise AssertionError("a keep-mask was left over")
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                     if p.grad is not None}
            after_one = {k: v.cpu().clone() for k, v in model.state_dict().items()}
            train(*cell.targs)
            after_two = {k: v.cpu().clone() for k, v in model.state_dict().items()}
            out["cells"][f"{spec['domain']}/{mode}"] = {
                "eval": ev, "train": step, "grads": grads, "after_one": after_one,
                "after_two": after_two, "flips": sum(flips),
                "step_ms": event_median(lambda: train(*cell.targs), PART_TIMING_REPS)}
    scale = inputs["scale"]
    cfg = config.FinetuneConfig(scale["domain"], "full_finetune", "b1", 42)
    for mode in PART_MODES:
        cell = partition_cell(cfg, Path(scale["processed_dir"]), dev, axis, mode)
        cell.model.load_state_dict(moved(scale["state"], dev))
        out["scale"][mode] = {"eval_loss": float(cell.evaluate(*cell.eargs)[0]),
                              "step_ms": event_median(lambda: cell.train(*cell.targs),
                                                      PART_TIMING_REPS)}
    torch.cuda.synchronize()
    out["launches"] = {name: c.launches for name, c in kernels.items()}
    out["all_to_all"] = {"route": axis.all_to_all_route(dev),
                         "calls": dict(axis.all_to_all_calls)}
    return out


def partition_rank_main() -> None:
    """One rank of the partition phase (``python -c "import chip_smoke;
    chip_smoke.partition_rank_main()" RANK TMP``), as ``dp_rank_main``."""
    import torch.distributed as dist

    rank, tmp = int(sys.argv[1]), Path(sys.argv[2])
    import_port()
    from gnn_pretraining_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    n, device = inputs["ranks"], inputs["device"]
    if inputs["backend"] == "nccl":
        device = f"cuda:{rank}"
        torch.cuda.set_device(device)
    dist.init_process_group(inputs["backend"], store=dist.FileStore(str(tmp / "store"), n),
                            rank=rank, world_size=n)
    try:
        out = partition_rank_cells(make_mesh(device, dist.group.WORLD), inputs)
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def adamw_agreement(got: dict, want: dict, grads: dict, labels: dict, lrs: dict) -> dict:
    """Parameters after one AdamW step against the twin's: the largest
    distance over lr (at most 2: the first step moves an element by about
    lr whatever its gradient's size), and the share of elements with a clear
    gradient (> 1e-4) that part by more than 0.05 lr."""
    worst, off, clear_n = 0.0, 0, 0
    for n, group in labels.items():
        if group == "frozen":
            continue
        dist = (got[n].cpu() - want[n].cpu()).abs() / lrs[group]
        worst = max(worst, float(dist.max()))
        clear = grads[n].cpu().abs() > 1e-4
        off += int((dist[clear] > 0.05).sum())
        clear_n += int(clear.sum())
    return {"max_over_lr": worst, "clear_share_off": off / max(clear_n, 1),
            "clear_elements": clear_n}


def partition_driver_checks(processed_dir: Path, root: Path, card) -> dict:
    """(d): ``run_finetune --partition edge|node`` against ``--partition
    none``, Cora_NC b1 coo, PART_DRIVER_EPOCHS epochs, with no launcher (one
    card: the single-device path; k cards: k ranks spawned) and dropout off,
    as the JAX package's driver test runs it; -> the path's launches."""
    import os

    from gnn_pretraining_tpu_torch import config, run_finetune

    kernels = counters()
    for c in kernels.values():
        c.launches = 0
    site = root / "site"
    site.mkdir(parents=True)
    # Spawned ranks (several cards) get dropout off from a sitecustomize.
    (site / "sitecustomize.py").write_text(
        "from gnn_pretraining_tpu_torch import config\nconfig.DROPOUT_RATE = 0.0\n")
    env = {"PYTHONPATH": os.pathsep.join(p for p in (str(site), str(HERE),
                                                     os.environ.get("PYTHONPATH")) if p)}
    summaries, seconds = {}, {}
    cfg = config.FinetuneConfig("Cora_NC", "full_finetune", "b1", 42)
    with mock.patch.object(config, "DROPOUT_RATE", 0.0), mock.patch.dict(os.environ, env):
        for partition in ("none", "edge", "node"):
            t = time.perf_counter()
            rc, _ = captured_main(run_finetune.main, [
                "--domain_name", "Cora_NC", "--finetune_strategy", "full_finetune",
                "--pretrained_scheme", "b1", "--seed", "42",
                "--epochs", str(PART_DRIVER_EPOCHS), "--aggregation", "coo",
                "--partition", partition, "--processed_dir", str(processed_dir),
                "--out_root", str(root / partition)])
            seconds[partition] = time.perf_counter() - t
            if rc:
                raise AssertionError(f"run_finetune --partition {partition} exited {rc}")
            summaries[partition] = json.loads(
                (root / partition / "metrics" / config.FINETUNE_PROJECT_NAME
                 / f"{cfg.run_name}.summary.json").read_text())
    launches = {name: c.launches for name, c in kernels.items()}
    want = summaries["none"]
    rtol, atol = PART_DRIVER_LOSS_TOL
    rows = {p: {"test/loss": s["test/loss"], "test/accuracy": s["test/accuracy"],
                "completed": s["fidelity/completed"]} for p, s in summaries.items()}
    ok = bool(all(abs(s["test/loss"] - want["test/loss"]) <= atol + rtol * abs(want["test/loss"])
                  and s["test/accuracy"] == want["test/accuracy"]
                  and s["fidelity/completed"] == 1 for s in summaries.values())
              and not any(launches.values()))
    emit({"phase": "partition", "run_finetune": "Cora_NC b1 coo, --partition none / edge / "
          "node, dropout off", "epochs": PART_DRIVER_EPOCHS,
          "cards": torch.cuda.device_count(), "summaries": rows, "seconds": seconds,
          "loss_tol": list(PART_DRIVER_LOSS_TOL), "launches": launches, "card": card,
          "ok": ok})
    if not ok:
        raise AssertionError("run_finetune --partition does not match --partition none")
    return launches


def partition_phase(device, processed_dir: Path, tmp: Path, card, n: int = PART_RANKS,
                    backend: str = "gloo") -> dict:
    """Phase 12d on ``n`` ranks (gloo on one card, or NCCL with a card per
    rank: tools/dp_cards.py); returns the launches of its paths (every
    rank's partitioned steps and the drivers of (d))."""
    from gnn_pretraining_tpu_torch import config
    from gnn_pretraining_tpu_torch.finetune import finetune as ft
    from gnn_pretraining_tpu_torch.finetune.mining import sample_gumbel
    from gnn_pretraining_tpu_torch.parallel.node_partition import build_node_partition_plan
    from gnn_pretraining_tpu_torch.utils import relu_branches

    t0 = time.perf_counter()
    tmp.mkdir(parents=True)
    twins, cells = {}, []
    for domain in PART_CELLS:
        cfg = config.FinetuneConfig(domain, "full_finetune", "b1", 42)
        cell = partition_cell(cfg, processed_dir, device)
        model, train, graph = cell.model, cell.train, cell.graph
        state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        ev = [x.cpu() for x in cell.evaluate(*cell.eargs)]
        kw = {}
        if cfg.task_type == "link_prediction":
            kw = {"gumbel": sample_gumbel(graph.num_nodes ** 2,
                                          torch.Generator(device).manual_seed(SEED), device)}
        with keep_mask_recording(model.dropout) as masks, \
                relu_branches.record(model) as branches:
            step = [x.detach().cpu().clone() for x in train(*cell.targs, **kw)]
        # The ranks score the pairs mined here: equal similarities (nodes
        # with equal embeddings) tie in the hard top-k, and a tie falls by
        # the rounding of the sums, which the partitions add in another order.
        negatives = getattr(train, "last_negatives", None)
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        plan = build_node_partition_plan(graph.senders.numpy(), graph.receivers.numpy(),
                                         graph.edge_mask.numpy(), graph.num_nodes, n)
        twins[domain] = {
            "eval": ev, "train": step, "grads": grads, "labels": cell.labels,
            "lrs": cell.lrs, "after_one": {k: v.cpu().clone() for k, v in
                                           model.state_dict().items()},
            "step_ms": event_median(lambda: train(*cell.targs), PART_TIMING_REPS),
            "bytes": (plan.halo_bytes_per_layer(config.GNN_HIDDEN_DIM),
                      plan.psum_bytes_per_layer(config.GNN_HIDDEN_DIM))}
        cells.append({"domain": domain, "state": state, "masks": masks,
                      "branches": [b.cpu() for b in branches], "nodes": graph.num_nodes,
                      "negatives": None if negatives is None else moved(negatives, "cpu")})
        del cell, model, train

    # (c) the 6x store: the single-process coo and K1 steps and eval loss.
    scfg = config.FinetuneConfig(PART_SCALE_DOMAIN, "full_finetune", "b1", 42)
    cell = partition_cell(scfg, CSR_STORES, device)
    g6 = cell.graph
    scale_state = {k: v.cpu().clone() for k, v in cell.model.state_dict().items()}
    scale = {"coo_eval_loss": float(cell.evaluate(*cell.eargs)[0]),
             "coo_step_ms": event_median(lambda: cell.train(*cell.targs), PART_TIMING_REPS)}
    del cell
    from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays

    kdata = {"train": create_finetune_arrays(PART_SCALE_DOMAIN, "train", scfg.batch_size,
                                             CSR_STORES)}
    k1 = ft.build_finetune_model(scfg, "pallas", device)
    k1_opt, k1_labels, _ = ft.create_finetune_optimizer(k1, scfg)
    k1_train, _, k1_batches, _ = ft.build_steps(scfg, k1, k1_opt, k1_labels, kdata, device)
    k1_args = next(iter(k1_batches()))[1]
    scale["k1_step_ms"] = event_median(lambda: k1_train(*k1_args), PART_TIMING_REPS)
    del k1, k1_train, k1_opt, k1_args
    plan6 = build_node_partition_plan(g6.senders.numpy(), g6.receivers.numpy(),
                                      g6.edge_mask.numpy(), g6.num_nodes, n)
    scale["bytes"] = (plan6.halo_bytes_per_layer(config.GNN_HIDDEN_DIM),
                      plan6.psum_bytes_per_layer(config.GNN_HIDDEN_DIM))
    torch.cuda.empty_cache()

    torch.save({"ranks": n, "device": str(device), "backend": backend,
                "processed_dir": str(processed_dir), "cells": cells,
                "scale": {"domain": PART_SCALE_DOMAIN, "processed_dir": str(CSR_STORES),
                          "state": scale_state}}, tmp / "inputs.pt")
    t_ranks = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import chip_smoke; chip_smoke.partition_rank_main()", str(r),
                               str(tmp)], cwd=HERE, env=child_env(OMP_NUM_THREADS="4"))
             for r in range(n)]
    try:
        rcs = [p.wait(timeout=DP_RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"partition ranks exited {rcs}")
    rank_seconds = time.perf_counter() - t_ranks
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(n)]

    oks = []
    for domain in PART_CELLS:
        twin = twins[domain]
        for mode in PART_MODES:
            got = [out["cells"][f"{domain}/{mode}"] for out in ranks]
            r0 = got[0]
            loss, twin_loss = float(r0["train"][0]), float(twin["train"][0])
            eval_loss, twin_eval = float(r0["eval"][0]), float(twin["eval"][0])
            probs_err = float((r0["train"][3] - twin["train"][3]).abs().max())
            eval_probs_err = float((r0["eval"][3] - twin["eval"][3]).abs().max())
            grads = grad_errs(r0["grads"], twin["grads"])
            stats = max(float(((r0["after_one"][k] - v).abs()
                               / (PART_STATS_TOL * v.abs() + 1e-6)).max())
                        for k, v in twin["after_one"].items() if k.endswith(("_mean", "_var")))
            params = adamw_agreement(r0["after_one"], twin["after_one"], twin["grads"],
                                     twin["labels"], twin["lrs"])
            bitwise = all(torch.equal(a["after_two"][k], v) for a in got[1:]
                          for k, v in r0["after_two"].items())
            equal_out = all(torch.equal(a["train"][0], r0["train"][0]) for a in got[1:])
            ok = bool(abs(loss - twin_loss) <= PART_LOSS_TOL * abs(twin_loss)
                      and abs(eval_loss - twin_eval) <= PART_LOSS_TOL * abs(twin_eval)
                      and probs_err <= PART_PROBS_TOL and eval_probs_err <= PART_PROBS_TOL
                      and torch.equal(r0["eval"][2], twin["eval"][2])
                      and grads["l2"] <= PART_GRAD_TOL and grads["max"] <= PART_LEAF_TOL
                      and stats <= 1.0 and params["max_over_lr"] <= 2.02
                      and params["clear_share_off"] <= 0.005 and bitwise and equal_out)
            oks.append(ok)
            emit({"phase": "partition", "cell": f"{domain}/full_finetune b1", "mode": mode,
                  "ranks": n, "backend": backend, "loss": loss, "loss_single": twin_loss,
                  "loss_rel_err": abs(loss - twin_loss) / abs(twin_loss),
                  "eval_loss_rel_err": abs(eval_loss - twin_eval) / abs(twin_eval),
                  "probs_max_abs_err": probs_err, "eval_probs_max_abs_err": eval_probs_err,
                  "grad_err": grads, "bn_stats_err_over_tol": stats, "adamw": params,
                  "relu_flips_replayed": [a["flips"] for a in got],
                  "ranks_bitwise_equal_after_two_steps": bitwise,
                  "tol": {"loss": PART_LOSS_TOL, "probs": PART_PROBS_TOL,
                          "grad_l2": PART_GRAD_TOL, "grad_max": PART_LEAF_TOL,
                          "bn_stats": [PART_STATS_TOL, 1e-6]},
                  "step_ms_per_rank": [a["step_ms"] for a in got],
                  "single_coo_step_ms": twin["step_ms"],
                  "halo_bytes_per_layer": twin["bytes"][0],
                  "psum_bytes_per_layer": twin["bytes"][1], "card": card, "ok": ok})
    scale_ok = all(abs(out["scale"][m]["eval_loss"] - scale["coo_eval_loss"])
                   <= PART_LOSS_TOL * abs(scale["coo_eval_loss"])
                   for out in ranks for m in PART_MODES)
    launches = {name: sum(out["launches"][name] for out in ranks) for name in ranks[0]["launches"]}
    routes = [out["all_to_all"] for out in ranks]
    none_launched = not any(launches[k] for k in ("gin_spmm_fwd", "gin_spmm_bwd",
                                                  "csr_spmm_fwd", "csr_spmm_bwd"))
    emit({"phase": "partition", "cell": f"{PART_SCALE_DOMAIN} x6 full_finetune b1",
          "nodes": g6.num_nodes, "nnz": int(g6.edge_mask.sum()), "ranks": n, "backend": backend,
          "step_ms_per_rank": {m: [out["scale"][m]["step_ms"] for out in ranks]
                               for m in PART_MODES},
          "single_coo_step_ms": scale["coo_step_ms"], "single_k1_step_ms": scale["k1_step_ms"],
          "eval_loss_rel_err": {m: [abs(out["scale"][m]["eval_loss"] - scale["coo_eval_loss"])
                                    / abs(scale["coo_eval_loss"]) for out in ranks]
                                for m in PART_MODES},
          "halo_bytes_per_layer": scale["bytes"][0], "psum_bytes_per_layer": scale["bytes"][1],
          "feature_dim": config.GNN_HIDDEN_DIM, "all_to_all": routes,
          "launches_on_partitioned_steps": launches, "card": card,
          "ok": scale_ok and none_launched})
    driver_launches = partition_driver_checks(processed_dir, tmp / "drivers", card)
    ok = all(oks) and scale_ok and none_launched
    emit({"phase": "partition", "seconds": time.perf_counter() - t0,
          "ranks_seconds": rank_seconds, "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"the partition phase failed its checks: cells {oks}, "
                             f"scale {scale_ok}, no K1/K3 launch {none_launched}")
    return {name: launches[name] + driver_launches[name] for name in launches}


def store_digest(path: Path) -> dict:
    """Key -> digest of one store's arrays: integer and bool arrays by dtype,
    shape and the SHA-256 of their bytes; float arrays by dtype, shape and
    their float64 sum, sum of squares and max |x|; strings (name, meta__*)
    as they are."""
    import hashlib

    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in sorted(z.files):
            a = z[key]
            if a.dtype.kind in "biu":
                out[key] = [str(a.dtype), list(a.shape),
                            hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()]
            elif a.dtype.kind == "f":
                x = a.astype(np.float64)
                out[key] = [str(a.dtype), list(a.shape), float(x.sum()),
                            float((x * x).sum()), float(np.abs(x).max(initial=0.0))]
            else:
                out[key] = str(a)
    return out


def digests_match(got: dict, want: dict) -> bool:
    """Two ``store_digest``s agree: strings and integer arrays exactly, float
    arrays in dtype and shape and their moments at DIGEST_RTOL."""
    def agree(g, w):
        if isinstance(w, str) or isinstance(w[2], str):
            return g == w
        return g[:2] == w[:2] and all(math.isclose(a, b, rel_tol=DIGEST_RTOL)
                                      for a, b in zip(g[2:], w[2:]))

    return sorted(got) == sorted(want) and all(agree(got[k], w) for k, w in want.items())


def data_phase(tmp: Path, out_root: Path) -> None:
    """The port's offline preprocessing on this machine, then the drivers'
    cells from the stores it made: checks of the module docstring's data
    phase."""
    import contextlib
    import io

    from gnn_pretraining_tpu_torch import config, run_finetune, run_pretrain
    from gnn_pretraining_tpu_torch.data import setup

    t0 = time.perf_counter()
    raw = tmp / "raw_empty"
    raw.mkdir()
    dirs = {"full": tmp / "full", "csr": tmp / "cora_6x", "pretrain": tmp / "pretrain_0.1"}

    def make(out, **kw):
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            setup.main(processed_dir=out, raw_dir=raw, **kw)
        return time.perf_counter() - t

    seconds = {name: make(dirs["full"], only=[name])
               for name in (*config.TUDATASETS, *config.PLANETOID_DATASETS)}
    seconds[f"Cora x{DATA_CSR_SCALE:g}"] = make(dirs["csr"], synthetic_scale=DATA_CSR_SCALE,
                                                only=["Cora"])
    seconds[f"pretrain x{DATA_PRETRAIN_SCALE:g}"] = make(
        dirs["pretrain"], synthetic_scale=DATA_PRETRAIN_SCALE,
        only=list(config.PRETRAIN_TUDATASETS))

    made = {p.stem: store_digest(p) for p in sorted(dirs["full"].glob("*.npz"))}
    mismatched = sorted(set(made) ^ set(SCALE1_DIGESTS)) + [
        name for name in sorted(set(made) & set(SCALE1_DIGESTS))
        if not digests_match(made[name], SCALE1_DIGESTS[name])]
    tracked_equal = {}
    for name in ("Cora_NC", "Cora_LP"):
        with np.load(dirs["csr"] / f"{name}.npz") as got, \
                np.load(CSR_STORES / f"{name}.npz") as want:
            tracked_equal[name] = sorted(got.files) == sorted(want.files) and all(
                got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                for k in want.files)
    graphs = {}
    for name in DATA_PRETRAIN_GRAPHS:
        with np.load(dirs["pretrain"] / f"{name}.npz") as z:
            graphs[name] = len(z["node_offsets"]) - 1

    kernels = counters()
    root = out_root / "data"

    def finetune(domain, epochs, processed, *extra):
        return ["--domain_name", domain, "--finetune_strategy", "full_finetune",
                "--pretrained_scheme", "b1", "--seed", "42", "--epochs", str(epochs),
                "--processed_dir", str(processed), "--out_root", str(root), *extra]

    ft_metrics = root / "metrics" / config.FINETUNE_PROJECT_NAME
    cells = (("pretrain s2", run_pretrain.main,
              ["--exp_name", "s2", "--seed", "42", "--epochs", "1", "--processed_dir",
               str(dirs["pretrain"]), "--out_root", str(root)],
              root / "metrics" / config.PRETRAIN_PROJECT_NAME / "s2_42.summary.json",
              DATA_PRETRAIN_SCALE),
             ("finetune ENZYMES b1", run_finetune.main,
              finetune("ENZYMES", DATA_FT_EPOCHS, dirs["full"]),
              ft_metrics / "ENZYMES_full_finetune_b1_42.summary.json", 1.0),
             ("finetune Cora_NC b1 csr", run_finetune.main,
              finetune("Cora_NC", DATA_CSR_EPOCHS, dirs["csr"], "--aggregation", "csr"),
              ft_metrics / "Cora_NC_full_finetune_b1_42.summary.json", DATA_CSR_SCALE))
    runs, checks = {}, {}
    for name, main, argv, summary_path, scale in cells:
        before = {k: c.launches for k, c in kernels.items()}
        t = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = main(argv)
        torch.cuda.synchronize()
        launched = {k: c.launches - before[k] for k, c in kernels.items()}
        summary = json.loads(summary_path.read_text())
        epochs = int(summary.get("test/progress/epoch", 1))
        want = {k: 0 for k in kernels} | DATA_LAUNCHES[name](epochs)
        fidelity = {k: summary.get(f"fidelity/{k}")
                    for k in ("data_source", "synthetic_scale", "calibration")}
        runs[name] = {"rc": rc, "seconds": time.perf_counter() - t, "epochs": epochs,
                      "launches": launched, "predicted": want, "fidelity": fidelity}
        print(printed.getvalue(), end="", flush=True)
        checks[f"{name}: rc 0, launches as predicted"] = rc == 0 and launched == want
        checks[f"{name}: fidelity"] = fidelity == {
            "data_source": "synthetic", "synthetic_scale": scale, "calibration": 0.0}
    checks = {"scale-1 stores match the JAX digests": not mismatched,
              "Cora x6 stores equal data/processed_6x": all(tracked_equal.values()),
              "scale-0.1 graph counts": graphs == DATA_PRETRAIN_GRAPHS,
              "ENZYMES epochs": runs["finetune ENZYMES b1"]["epochs"] in (2, DATA_FT_EPOCHS),
              **checks}
    ok = all(checks.values())
    emit({"phase": "data", "setup_seconds": seconds, "mismatched_stores": mismatched,
          "tracked_equal": tracked_equal, "pretrain_graphs": graphs,
          "cells": runs, "seconds": time.perf_counter() - t0, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError(f"the data phase failed its checks: {checks}")


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
    for name, call in calls.items():
        kernels = profiled(call)
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
        _, drivers = run_path(lambda: clocked("drivers", lambda: drivers_phase(
            processed_dir, resume_dir, out_root)))
        _, sweep = run_path(lambda: clocked("sweep", lambda: sweep_phase(
            device, processed_dir, resume_dir, out_root, Path(tmp) / "sweep", card)))
        # Its ranks count their own launches; the parent's comparison step
        # and its own launches stay out of the path's.
        dp = clocked("dp", lambda: dp_phase(device, processed_dir, resume_dir,
                                            Path(tmp) / "dp", card))
        # Its ranks and drivers count their own launches (none: coo paths);
        # the parent's single-process and K1 comparison steps stay out.
        partition = clocked("partition", lambda: partition_phase(
            device, processed_dir, Path(tmp) / "partition", card))
        _, data = run_path(lambda: clocked("data", lambda: data_phase(Path(tmp), out_root)))
        paths = {"serving": serving, "train": train, "pretrain": pretrain,
                 "pretrain_tasks": pretrain_tasks, "csr": csr, "resume": resume,
                 "drivers": drivers, "sweep": sweep, "dp": dp, "partition": partition,
                 "data": data}
        # The kernel rows read these dicts; the artifacts path joins them below.
        launches = {name: {path: counts[name] for path, counts in paths.items()}
                    for name in kernels}
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
        # After the timing and profile phases (its captures and eager twins
        # stay out of their numbers), before the artifacts phase (whose
        # leftovers slow the host).
        chunk_out, chunked = run_path(lambda: clocked("chunked", lambda: chunked_phase(
            device, processed_dir, entry_dir, out_root)))
        emit({"phase": "chunked", "phase_seconds": seconds["chunked"],
              "step_event_ms": {scheme: {how: t["event_ms"] for how, t in times.items()}
                                for scheme, times in chunk_out["steps"].items()},
              "entry_seconds_per_step": chunk_out["entry_seconds_per_step"],
              "build_batch_ms_per_s5_step": chunk_out["build_batch_ms"]})
        # Last: what the artifacts phase leaves in the process (torch.export,
        # a profiler session, anomaly mode) slowed the serving forwards timed
        # after it (tools/serving_ab.py).
        (nan_inputs, temp), artifacts = run_path(lambda: clocked("artifacts", lambda: (
            artifacts_phase(device, processed_dir, out_root, Path(tmp) / "artifacts", card))))
        k2_nan_phase(nan_inputs, temp, card)
        # Last: a failed capture may leave its side stream current.
        capture_failure_phase(device, processed_dir)
    for name in kernels:
        launches[name]["chunked"] = chunked[name]
        launches[name]["artifacts"] = artifacts[name]
    kernel_rows = k1_kernels + k2_kernels + k3_kernels
    for k in kernel_rows:
        k["launches"] = sum(k["launches_by_path"].values())
    k3 = CELL_KERNELS["csr"]
    unlaunched = [name for name in kernels if name not in k3
                  and min(pretrain[name], pretrain_tasks[name], chunked[name], resume[name],
                          drivers[name], dp[name], data[name]) < 1]
    unlaunched += [name for name in k3 if min(csr[name], drivers[name], data[name]) < 1]
    if min(serving["gin_spmm_fwd"], train["gin_spmm_fwd"], train["gin_spmm_bwd"],
           artifacts["gin_spmm_fwd"], artifacts["gin_spmm_bwd"]) < 1 or unlaunched:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    # The drivers and data paths run dense and csr cells; their phases check
    # each cell.
    strays = {name: [path for path, n in launches[name].items()
                     if n and path not in ("drivers", "data")
                     and (path == "csr") != (name in k3)]
              for name in kernels if name in k3 or name in CELL_KERNELS["pallas"]}
    if any(strays.values()):
        raise AssertionError(f"K1 launched on the csr path or K3 off it: {strays}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    for k in kernel_rows:
        k["launches_per_s5_step"] = per_step["s5"][k["name"]]
    emit({"kernels": kernel_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
