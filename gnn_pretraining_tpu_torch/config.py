"""Central configuration: every behavioural constant of the framework.

The port's own copy of ``gnn_pretraining_tpu/config.py``: the same names and
values with their provenance citations (reference file:line), so that the
PyTorch package never imports the JAX one. ``tests/test_torch_config.py``
holds every UPPERCASE constant equal to its JAX counterpart.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Tuple

# ---------------------------------------------------------------------------
# Dataset registry (reference: src/data/data_setup.py:24-59)
# ---------------------------------------------------------------------------

CONTINUOUS_TUDATASETS: Tuple[str, ...] = ("PROTEINS", "ENZYMES")
DOWNSTREAM_TUDATASETS: Tuple[str, ...] = ("ENZYMES", "PTC_MR")
PRETRAIN_TUDATASETS: Tuple[str, ...] = ("MUTAG", "PROTEINS", "NCI1", "ENZYMES")
TUDATASETS: Tuple[str, ...] = ("MUTAG", "PROTEINS", "NCI1", "ENZYMES", "PTC_MR")
PLANETOID_DATASETS: Tuple[str, ...] = ("Cora", "CiteSeer")

DOMAIN_DIMENSIONS: Dict[str, int] = {
    "MUTAG": 7,
    "PROTEINS": 4,
    "NCI1": 37,
    "ENZYMES": 21,
    "PTC_MR": 18,
    "Cora_NC": 1433,
    "CiteSeer_NC": 3703,
    "Cora_LP": 1433,
    "CiteSeer_LP": 3703,
}

NUM_CLASSES: Dict[str, int] = {
    "ENZYMES": 6,
    "PTC_MR": 2,
    "Cora_NC": 7,
    "CiteSeer_NC": 6,
    "Cora_LP": 2,
    "CiteSeer_LP": 2,
}

TASK_TYPES: Dict[str, str] = {
    "ENZYMES": "graph_classification",
    "PTC_MR": "graph_classification",
    "Cora_NC": "node_classification",
    "CiteSeer_NC": "node_classification",
    "Cora_LP": "link_prediction",
    "CiteSeer_LP": "link_prediction",
}

# Preprocessing (reference: src/data/data_setup.py:17-22)
MIN_SCALE = -3.0
MAX_SCALE = 3.0
PREPROCESS_RANDOM_SEED = 42
VAL_FRACTION = 0.1
VAL_TEST_FRACTION = 0.2
VAL_TEST_SPLIT_RATIO = 0.5

# Graph properties (reference: src/data/graph_properties.py:13)
GRAPH_PROPERTY_DIM = 12

# ---------------------------------------------------------------------------
# Model (reference: src/models/gnn.py:6-8, heads.py:10-13,
#         pretrain_model.py:18-20, finetune_model.py:14-17)
# ---------------------------------------------------------------------------

DROPOUT_RATE = 0.2
GNN_HIDDEN_DIM = 256
GNN_NUM_LAYERS = 5

CONTRASTIVE_PROJ_DIM = 128
DOMAIN_CLASSIFIER_DROPOUT_RATE = 0.5
DOMAIN_CLASSIFIER_HIDDEN_DIM = 128
GRAPH_PROP_HIDDEN_DIM = 512

MASK_TOKEN_INIT_STD = 0.1
NODE_FEATURE_MASKING_MASK_RATE = 0.15
NODE_FEATURE_MASKING_MIN_NUM_NODES = 3

FINETUNE_HIDDEN_DIM = 128
LR_BACKBONE = 1e-4
LR_FINETUNE = 1e-3

# BatchNorm semantics follow torch.nn.BatchNorm1d defaults.
BN_MOMENTUM = 0.1
BN_EPS = 1e-5

# The fused NT-Xent (kernel K2, ops/ntxent.py) takes every single-device
# NT-Xent on the card: threshold 0. The JAX package's 4096 is a TPU crossover
# and does not carry over; the H100 crossover of K2 against the plain formula
# is measured by chip_smoke.py and recorded in PERF.md, and the threshold
# moves only once K2 has been redesigned for this card.
FUSED_NTXENT = True
FUSED_NTXENT_MIN_ROWS = 0
# Above this many nodes ops/spmm.gin_aggregate refuses to materialize an
# [N, N] dense adjacency (8192^2 bf16 = 128 MB) and demands COO instead.
DENSE_ADJACENCY_MAX_NODES = 8192

# ---------------------------------------------------------------------------
# Augmentations (reference: src/pretrain/augmentations.py:7-14)
# ---------------------------------------------------------------------------

ATTR_MASK_MIN_NUM_FEATURES = 3
ATTR_MASK_PROB = 0.2
ATTR_MASK_RATE = 0.2
EDGE_DROP_MIN_NUM_EDGES = 3
EDGE_DROP_PROB = 0.2
EDGE_DROP_RATE = 0.2
NODE_DROP_MIN_NUM_NODES = 3
NODE_DROP_RATE = 0.2

# ---------------------------------------------------------------------------
# Schedulers (reference: src/pretrain/schedulers.py:3-7)
# ---------------------------------------------------------------------------

FINAL_TEMP = 0.2
GRL_GAMMA = 10.0
INITIAL_TEMP = 0.5
MAX_LAMBDA = 0.01
START_ADVERSARIAL_EPOCH_FRACTION = 0.4

# ---------------------------------------------------------------------------
# Multi-task optimization (reference: src/pretrain/adaptive_loss_balancer.py:4-6,
#                          optimizers.py:5-15)
# ---------------------------------------------------------------------------

BALANCER_EPSILON = 1e-8
BALANCER_MIN_TOTAL_LOSS = 1e-6
BALANCER_WARMUP_STEPS = 100

DEFAULT_LR = 1e-5
DEFAULT_WEIGHT_DECAY = 1e-5
TASK_SPECIFIC_LR: Dict[str, float] = {
    "link_pred": 5e-7,
    "node_feat_mask": 1e-5,
    "node_contrast": 1e-5,
    "graph_contrast": 1e-5,
    "graph_prop": 1e-5,
    "domain_adv": 5e-6,
}

# ---------------------------------------------------------------------------
# Pretraining loop (reference: src/pretrain/pretrain.py:27-52)
# ---------------------------------------------------------------------------

PRETRAIN_BATCH_SIZE = 32
PRETRAIN_EPOCHS = 50
MAX_GRAD_NORM = 0.5
PRETRAIN_PATIENCE_FRACTION = 0.5

PRETRAIN_DOMAINS: Dict[str, Tuple[str, ...]] = {
    "b2": PRETRAIN_TUDATASETS,
    "b3": PRETRAIN_TUDATASETS,
    "b4": ("ENZYMES",),
    "s1": PRETRAIN_TUDATASETS,
    "s2": PRETRAIN_TUDATASETS,
    "s3": PRETRAIN_TUDATASETS,
    "s4": PRETRAIN_TUDATASETS,
    "s5": PRETRAIN_TUDATASETS,
}

ACTIVE_TASKS: Dict[str, Tuple[str, ...]] = {
    "b2": ("node_feat_mask",),
    "b3": ("node_contrast",),
    "b4": ("node_feat_mask", "link_pred", "node_contrast", "graph_contrast", "graph_prop"),
    "s1": ("node_feat_mask", "link_pred"),
    "s2": ("node_contrast", "graph_contrast"),
    "s3": ("node_feat_mask", "link_pred", "node_contrast", "graph_contrast"),
    "s4": ("node_feat_mask", "link_pred", "node_contrast", "graph_contrast", "graph_prop"),
    "s5": ("node_feat_mask", "link_pred", "node_contrast", "graph_contrast", "graph_prop", "domain_adv"),
}

ALL_TASKS: Tuple[str, ...] = (
    "node_feat_mask", "link_pred", "node_contrast", "graph_contrast", "graph_prop", "domain_adv",
)

ALL_SCHEMES: Tuple[str, ...] = ("b2", "b3", "b4", "s1", "s2", "s3", "s4", "s5")
SEEDS: Tuple[int, ...] = (42, 84, 126)

# ---------------------------------------------------------------------------
# Fine-tuning loop (reference: src/finetune/finetune.py:24-42)
# ---------------------------------------------------------------------------

FINETUNE_BATCH_SIZES: Dict[str, int] = {
    "ENZYMES": 32,
    "PTC_MR": 32,
    "Cora_NC": -1,          # full-batch
    "CiteSeer_NC": -1,
    "Cora_LP": 256,
    "CiteSeer_LP": 256,
}
FINETUNE_EPOCHS: Dict[str, int] = {
    "ENZYMES": 100,
    "PTC_MR": 100,
    "Cora_NC": 200,
    "CiteSeer_NC": 200,
    "Cora_LP": 300,
    "CiteSeer_LP": 300,
}
HARD_NEGATIVE_RATIO = 0.3
MIN_HARD_NEGATIVES = 8
FINETUNE_PATIENCE_FRACTION = 0.5
# Net-new (no reference analogue): rounds of fixed-shape rejection sampling
# for negative edges. The reference resamples until clean (dynamic); with R
# rounds the probability a returned "negative" is a true edge is
# ~(E_g/n_g^2)^R.
NEG_SAMPLING_ROUNDS = 8
# Net-new: above this node count the LP hard-negative miner switches to a
# streaming path with O(row_block * N) peak memory; the two paths consume
# randomness differently, so this threshold is behaviour-affecting.
STREAMING_MINER_MIN_NODES = 8192
# Net-new: offset folded into the seed of the fine-tune runner's
# per-(epoch, step) key stream.
FINETUNE_KEY_OFFSET = 7919

FINETUNE_DOMAINS: Tuple[str, ...] = (
    "ENZYMES", "PTC_MR", "Cora_NC", "CiteSeer_NC", "Cora_LP", "CiteSeer_LP",
)
FINETUNE_STRATEGIES: Tuple[str, ...] = ("full_finetune", "linear_probe")
FINETUNE_SCHEMES: Tuple[str, ...] = ("b1",) + ALL_SCHEMES

# ---------------------------------------------------------------------------
# Paths (the same repository root as the JAX package's)
# ---------------------------------------------------------------------------

REPO_ROOT = Path(__file__).resolve().parent.parent
DATA_ROOT_DIR = REPO_ROOT / "data"
RAW_DIR = DATA_ROOT_DIR / "raw"
PROCESSED_DIR = DATA_ROOT_DIR / "processed"
# The port's runs go under a root of their own: the project and file names
# equal the JAX package's, and both packages read each other's checkpoints,
# train states and completion markers, so a shared root would let a port run
# overwrite a JAX cell and pass its sweep's --resume check.
OUTPUT_DIR = REPO_ROOT / "outputs" / "torch"
PRETRAIN_OUTPUT_DIR = OUTPUT_DIR / "pretrain"
FINETUNE_OUTPUT_DIR = OUTPUT_DIR / "finetune"
METRICS_DIR = OUTPUT_DIR / "metrics"
# Tracked (git) durable artifacts: fp16 transfer checkpoints and serving
# exports written by the JAX package.
ARTIFACTS_DIR = REPO_ROOT / "artifacts"

PRETRAIN_PROJECT_NAME = "gnn-pretraining-pretrain"
FINETUNE_PROJECT_NAME = "gnn-pretraining-finetune"


# ---------------------------------------------------------------------------
# Run configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Pretraining run config (reference: src/pretrain/pretrain.py:58-68)."""

    exp_name: str
    seed: int

    @property
    def pretrain_domains(self) -> Tuple[str, ...]:
        return PRETRAIN_DOMAINS[self.exp_name]

    @property
    def active_tasks(self) -> Tuple[str, ...]:
        return ACTIVE_TASKS[self.exp_name]

    @property
    def run_name(self) -> str:
        return f"{self.exp_name}_{self.seed}"


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Fine-tuning run config (reference: src/finetune/finetune.py:109-127)."""

    domain_name: str
    finetune_strategy: str
    pretrained_scheme: str
    seed: int

    @property
    def exp_name(self) -> str:
        return f"{self.domain_name}_{self.finetune_strategy}_{self.pretrained_scheme}"

    @property
    def task_type(self) -> str:
        return TASK_TYPES[self.domain_name]

    @property
    def batch_size(self) -> int:
        return FINETUNE_BATCH_SIZES[self.domain_name]

    @property
    def epochs(self) -> int:
        return FINETUNE_EPOCHS[self.domain_name]

    @property
    def patience(self) -> int:
        return int(self.epochs * FINETUNE_PATIENCE_FRACTION)

    @property
    def run_name(self) -> str:
        return f"{self.exp_name}_{self.seed}"
