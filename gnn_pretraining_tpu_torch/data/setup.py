"""Offline preprocessing: raw (or synthetic) datasets → GraphStore ``.npz`` files.

    python -m gnn_pretraining_tpu_torch.data.setup [--processed_dir D] [--raw_dir R]
        [--synthetic_scale S] [--synthetic_seed N] [--synthetic_homophily H]
        [--only NAME ...]

The port of ``gnn_pretraining_tpu/data/setup.py`` (reference
src/data/data_setup.py:66-178), host code on numpy, scipy and torch's CPU
generator only: for the same raw files, or the same synthetic scale and seed,
it writes the same stores, array for array, as the JAX package's setup.

  * Downstream TU sets (ENZYMES, PTC_MR): stratified 80/10/10 with seed 42.
  * Pretrain-only TU sets: a 90/10 shuffle split.
  * Continuous-feature sets (PROTEINS, ENZYMES): standardized on the train
    graphs' node rows, clipped to ±3.
  * Planetoid NC: the public masks; LP: a seeded 80/10/10 edge permutation
    with sampled negatives.

The splits replicate scikit-learn's ``StratifiedShuffleSplit`` and
``ShuffleSplit`` (version 1.9.0, ``model_selection/_split.py``,
``utils/extmath._approximate_mode``) draw for draw on a
``np.random.RandomState``, which the card's machine has and scikit-learn is
not. Without raw files under ``raw_dir`` each dataset is generated by
``data/synthetic.py`` instead.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import synthetic
from gnn_pretraining_tpu_torch.data.batch import GraphStore
from gnn_pretraining_tpu_torch.data.parsers import parse_planetoid, parse_tu_dataset
from gnn_pretraining_tpu_torch.data.properties import (
    compute_graph_properties,
    standardize_properties,
)


def _split_sizes(n_samples: int, test_size: float) -> Tuple[int, int]:
    """(n_train, n_test) for a float test share (sklearn's
    ``_validate_shuffle_split``): the test count rounds up."""
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples} and test_size={test_size}, "
                         "the train set would be empty")
    return n_train, n_test


def shuffle_split(n_samples: int, test_size: float,
                  seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``next(ShuffleSplit(1, test_size=test_size, random_state=seed).split(X))``
    for ``len(X) == n_samples``: (train, test) indices."""
    n_train, n_test = _split_sizes(n_samples, test_size)
    perm = np.random.RandomState(seed).permutation(n_samples)
    return perm[n_test:n_test + n_train], perm[:n_test]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Draws per class nearest the multivariate hypergeometric's mean,
    summing to ``n_draws``; ties in the remainder broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_shuffle_split(y: np.ndarray, test_size: float,
                             seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``next(StratifiedShuffleSplit(1, test_size=test_size,
    random_state=seed).split(X, y))``: (train, test) indices. Raises
    ``ValueError`` where scikit-learn does: a class with one member, or
    fewer train or test slots than classes."""
    n_train, n_test = _split_sizes(len(y), test_size)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError(f"classes with one member: {classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"train_size {n_train} < {n_classes} classes")
    if n_test < n_classes:
        raise ValueError(f"test_size {n_test} < {n_classes} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])

    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[:n_i[i]])
        test.extend(members[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _scale_continuous_features(store_feats: np.ndarray, node_offsets: np.ndarray,
                               train_idx: np.ndarray) -> np.ndarray:
    """Standardize on the train graphs' node rows (biased std, a zero std
    scaled by 1), clip to ±3 (ref :90-100)."""
    rows = np.concatenate([
        np.arange(node_offsets[i], node_offsets[i + 1]) for i in train_idx])
    train_x = store_feats[rows]
    mean = train_x.mean(axis=0)
    scale = train_x.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)
    scaled = (store_feats - mean) / scale
    return np.clip(scaled, config.MIN_SCALE, config.MAX_SCALE).astype(np.float32)


def _stratified_or_plain(indices: np.ndarray, labels: np.ndarray,
                         test_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified split as the reference's (:86,102); a plain shuffle split
    only where a class is too small to stratify, which only undersized
    synthetic stores reach."""
    try:
        return stratified_shuffle_split(labels, test_size, config.PREPROCESS_RANDOM_SEED)
    except ValueError:
        return shuffle_split(len(indices), test_size, config.PREPROCESS_RANDOM_SEED)


def _compute_properties(edge_index: np.ndarray, node_offsets: np.ndarray,
                        edge_offsets: np.ndarray, train_idx: np.ndarray) -> np.ndarray:
    g = len(node_offsets) - 1
    props = np.zeros((g, config.GRAPH_PROPERTY_DIM), np.float32)
    for i in range(g):
        n = int(node_offsets[i + 1] - node_offsets[i])
        ei = edge_index[:, edge_offsets[i]:edge_offsets[i + 1]]
        props[i] = compute_graph_properties(np.asarray(ei, np.int64), n)
    return standardize_properties(props, train_idx)


def process_tu_dataset(name: str, raw_dir: Path, synthetic_scale: float = 1.0,
                       synthetic_seed: int = 0,
                       synthetic_homophily: float = 0.0) -> GraphStore:
    try:
        x, ei, n_off, e_off, y = parse_tu_dataset(raw_dir, name)
        source = "raw"
    except FileNotFoundError:
        x, ei, n_off, e_off, y = synthetic.generate_tu_dataset(
            name, seed=synthetic_seed, scale=synthetic_scale,
            homophily=synthetic_homophily)
        source = "synthetic"

    num_graphs = len(n_off) - 1
    if name in config.DOWNSTREAM_TUDATASETS:
        train_idx, val_test_idx = _stratified_or_plain(
            np.arange(num_graphs), y, config.VAL_TEST_FRACTION)
        if name in config.CONTINUOUS_TUDATASETS:
            x = _scale_continuous_features(x, n_off, train_idx)
        val_rel, test_rel = _stratified_or_plain(
            np.arange(len(val_test_idx)), y[val_test_idx], config.VAL_TEST_SPLIT_RATIO)
        splits = {"train": train_idx.astype(np.int64),
                  "val": val_test_idx[val_rel].astype(np.int64),
                  "test": val_test_idx[test_rel].astype(np.int64)}
    else:
        train_idx, val_idx = shuffle_split(num_graphs, config.VAL_FRACTION,
                                           config.PREPROCESS_RANDOM_SEED)
        splits = {"train": train_idx.astype(np.int64), "val": val_idx.astype(np.int64)}

    props = (_compute_properties(ei, n_off, e_off, splits["train"])
             if name in config.PRETRAIN_TUDATASETS else None)

    print(f"  {name}: {num_graphs} graphs ({source}), splits "
          f"{ {k: len(v) for k, v in splits.items()} }")
    synthetic_source = source == "synthetic"
    return GraphStore(name=name, node_features=x, edge_index=ei,
                      node_offsets=n_off, edge_offsets=e_off, y=y,
                      splits=splits, graph_properties=props,
                      meta={"source": source,
                            "scale": str(synthetic_scale if synthetic_source else 1.0),
                            "homophily": str(synthetic_homophily if synthetic_source
                                             else 0.0)})


def _create_link_prediction_splits(edge_index: np.ndarray, num_nodes: int,
                                   seed: int = config.PREPROCESS_RANDOM_SEED
                                   ) -> Dict[str, np.ndarray]:
    """80/10/10 edge split with sampled negatives (ref :126-149).

    The edge permutation is ``torch.randperm`` on a CPU generator seeded
    ``seed``, as the reference draws it (a CUDA generator draws other
    numbers). Negatives are uniform non-edges of the undirected train edges,
    drawn one pair at a time from ``np.random.default_rng(seed)``."""
    num_edges = edge_index.shape[1]
    num_val_test = int(num_edges * config.VAL_TEST_FRACTION)
    num_val = int(num_val_test * config.VAL_TEST_SPLIT_RATIO)

    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    perm = torch.randperm(num_edges, generator=gen).numpy()
    train_edges = edge_index[:, perm[num_val_test:]]
    val_test_edges = edge_index[:, perm[:num_val_test]]

    existing = set()
    for u, v in train_edges.T:
        existing.add((int(u), int(v)))
        existing.add((int(v), int(u)))
    rng = np.random.default_rng(seed)
    neg = []
    while len(neg) < num_val_test:
        u, v = rng.integers(0, num_nodes, 2)
        if u != v and (int(u), int(v)) not in existing:
            neg.append((int(u), int(v)))
    neg_edges = np.array(neg, np.int64).T

    return {
        "train_pos": train_edges.astype(np.int64),
        "val_pos": val_test_edges[:, :num_val].astype(np.int64),
        "val_neg": neg_edges[:, :num_val],
        "test_pos": val_test_edges[:, num_val:].astype(np.int64),
        "test_neg": neg_edges[:, num_val:],
    }


def process_planetoid_dataset(name: str, raw_dir: Path, synthetic_scale: float = 1.0,
                              synthetic_seed: int = 0) -> Dict[str, GraphStore]:
    try:
        d = parse_planetoid(raw_dir, name)
        source = "raw"
        # The reference loads Planetoid with NormalizeFeatures (:154): rows
        # divided by their sum, clamped to at least 1. The synthetic
        # generator writes its features normalized already.
        row_sum = d["x"].sum(axis=1, keepdims=True)
        d["x"] = (d["x"] / np.maximum(row_sum, 1.0)).astype(np.float32)
    except FileNotFoundError:
        d = synthetic.generate_planetoid(name, seed=synthetic_seed, scale=synthetic_scale)
        source = "synthetic"

    n = d["x"].shape[0]
    e = d["edge_index"].shape[1]
    common = dict(node_features=d["x"], edge_index=d["edge_index"],
                  node_offsets=np.array([0, n], np.int64),
                  edge_offsets=np.array([0, e], np.int64), y=d["y"], node_y=d["y"],
                  meta={"source": source,
                        "scale": str(synthetic_scale if source == "synthetic" else 1.0)})
    nc_splits = {split: np.where(d[f"{split}_mask"])[0].astype(np.int64)
                 for split in ("train", "val", "test")}
    lp_splits = _create_link_prediction_splits(np.asarray(d["edge_index"], np.int64), n)

    print(f"  {name}: {n} nodes, {e} directed edges ({source})")
    return {f"{name}_NC": GraphStore(name=f"{name}_NC", splits=nc_splits, **common),
            f"{name}_LP": GraphStore(name=f"{name}_LP", splits=lp_splits, **common)}


def main(processed_dir: Optional[Path] = None, raw_dir: Optional[Path] = None,
         synthetic_scale: float = 1.0, synthetic_seed: int = 0,
         synthetic_homophily: float = 0.0, only=None) -> None:
    """Write ``<name>.npz`` for each TU set and ``<name>_{NC,LP}.npz`` for
    each Planetoid set into ``processed_dir``. ``only`` restricts this to the
    named datasets (TU or Planetoid names): e.g. a Cora store at a large
    synthetic scale for the csr cell, without computing graph properties for
    thousands of scaled TU graphs."""
    processed_dir = Path(processed_dir or config.PROCESSED_DIR)
    raw_dir = Path(raw_dir or config.RAW_DIR)
    processed_dir.mkdir(parents=True, exist_ok=True)

    print("Processing TU datasets...")
    for name in config.TUDATASETS:
        if only is not None and name not in only:
            continue
        store = process_tu_dataset(name, raw_dir, synthetic_scale,
                                   synthetic_seed, synthetic_homophily)
        store.save(processed_dir / f"{name}.npz")

    print("Processing Planetoid datasets...")
    for name in config.PLANETOID_DATASETS:
        if only is not None and name not in only:
            continue
        stores = process_planetoid_dataset(name, raw_dir, synthetic_scale, synthetic_seed)
        for key, store in stores.items():
            store.save(processed_dir / f"{key}.npz")
    print(f"Done -> {processed_dir}")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--processed_dir", type=str, default=None)
    p.add_argument("--raw_dir", type=str, default=None)
    p.add_argument("--synthetic_scale", type=float, default=1.0)
    p.add_argument("--synthetic_seed", type=int, default=0)
    p.add_argument("--synthetic_homophily", type=float, default=0.0,
                   help="smooth synthetic TU node features over edges so they "
                        "are neighbor-predictable (NFM probe calibration)")
    p.add_argument("--only", type=str, nargs="+", default=None,
                   help="process only these datasets (TU/Planetoid names)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
