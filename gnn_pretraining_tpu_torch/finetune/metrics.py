"""Evaluation metrics with reference-pipeline parity (numpy, host side).

Port of ``gnn_pretraining_tpu/finetune/metrics.py`` (reference
src/finetune/metrics.py) without scikit-learn: every metric is a closed form
that equals sklearn's. The quirks are part of the parity contract:

  * split-level metrics are *sample-weighted means of per-batch metrics*
    (:14-33) — NOT global metrics;
  * per-batch AUC is defined 0.0 when the batch is single-class or sklearn
    raises (:64-73); with unshuffled LP loaders this makes split "AUC" land
    around 0.08-0.11 by construction, and it is still the model-selection
    signal (finetune.py:269);
  * binary domains use ``average='binary'`` f1/precision/recall, multiclass
    uses macro (:59).

A corrected global AUC (over the concatenated split) is additionally reported
under ``{prefix}/auc_global`` — extra information, never used for selection.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
from gnn_pretraining_tpu_torch import config


def binary_roc_auc(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """sklearn-equal binary ROC AUC via the rank (Mann-Whitney U) statistic.

    The trapezoidal area under the binary ROC curve equals
    P(score_pos > score_neg) + P(score_pos == score_neg)/2, computed here
    with tie-averaged ranks — identical to ``roc_auc_score``, heavy ties
    included. Non-finite probabilities give 0.0 (sklearn raises there and
    the callers record 0.0).
    """
    if not np.isfinite(y_prob).all():
        return 0.0  # sklearn raises ValueError here -> callers record 0.0
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = y_true.shape[0] - n_pos
    order = np.argsort(y_prob, kind="stable")
    sorted_p = y_prob[order]
    # average ranks over tied prob values (1-based)
    boundaries = np.empty(y_prob.shape[0], bool)
    boundaries[0] = True
    np.not_equal(sorted_p[1:], sorted_p[:-1], out=boundaries[1:])
    group = np.cumsum(boundaries) - 1
    starts = np.flatnonzero(boundaries)
    ends = np.append(starts[1:], y_prob.shape[0])
    avg_rank = (starts + ends + 1) / 2.0  # mean of 1-based [start+1, end]
    ranks = np.empty(y_prob.shape[0])
    ranks[order] = avg_rank[group]
    r_pos = ranks[pos].sum()
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _binary_prf(y_true: np.ndarray, y_pred: np.ndarray):
    """accuracy, f1, precision, recall with sklearn ``zero_division=0``."""
    t1 = y_true == 1
    p1 = y_pred == 1
    tp = int(np.sum(t1 & p1))
    fp = int(p1.sum()) - tp
    fn = int(t1.sum()) - tp
    acc = float(np.mean(y_true == y_pred))
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return acc, f1, prec, rec


def _macro_prf(y_true: np.ndarray, y_pred: np.ndarray):
    """accuracy + macro f1/precision/recall, sklearn-equal (zero_division=0).

    sklearn's macro average runs over sorted(unique(y_true) | unique(y_pred));
    per-class ratios with zero denominators contribute 0."""
    labels = np.union1d(np.unique(y_true), np.unique(y_pred))
    tp = np.empty(len(labels)); pc = np.empty(len(labels))
    tc = np.empty(len(labels))
    for i, c in enumerate(labels):
        t = y_true == c
        p = y_pred == c
        tp[i] = np.sum(t & p)
        pc[i] = p.sum()
        tc[i] = t.sum()
    prec = np.divide(tp, pc, out=np.zeros_like(tp), where=pc > 0)
    rec = np.divide(tp, tc, out=np.zeros_like(tp), where=tc > 0)
    den = prec + rec
    f1 = np.divide(2 * prec * rec, den, out=np.zeros_like(tp), where=den > 0)
    acc = float(np.mean(y_true == y_pred)) if len(y_true) else 0.0
    return acc, float(f1.mean()), float(prec.mean()), float(rec.mean())


def multiclass_ovr_auc(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """sklearn-equal ``roc_auc_score(..., multi_class='ovr')`` (macro over
    per-class one-vs-rest rank AUCs). sklearn raises when y_true does not
    contain every probability column's class — callers record 0.0 there,
    and this mirrors that contract by returning 0.0. A label id outside the
    probability columns is the same case and gives 0.0 as well."""
    classes = np.unique(y_true)
    n_cols = y_prob.shape[1]
    if (len(classes) != n_cols or classes.min() < 0 or classes.max() >= n_cols):
        return 0.0  # sklearn ValueError path -> recorded as 0.0
    aucs = [binary_roc_auc((y_true == c).astype(np.int64), y_prob[:, int(c)])
            for c in classes]
    return float(np.mean(aucs))


def compute_batch_metrics(domain_name: str, targets: np.ndarray,
                          predictions: np.ndarray, probabilities: np.ndarray,
                          loss: float, prefix: str) -> Dict[str, float]:
    is_binary = config.NUM_CLASSES[domain_name] == 2

    y_true = np.asarray(targets)
    y_pred = np.asarray(predictions)
    y_prob = np.asarray(probabilities)
    if is_binary:
        y_prob = y_prob[:, 1]

    m: Dict[str, float] = {}
    if is_binary:
        acc, f1, prec, rec = _binary_prf(y_true, y_pred)
        m[f"{prefix}/accuracy"] = acc
        m[f"{prefix}/f1"] = f1
        m[f"{prefix}/precision"] = prec
        m[f"{prefix}/recall"] = rec
        single_class = bool((y_true == y_true[0]).all()) if len(y_true) else True
        m[f"{prefix}/auc"] = (0.0 if single_class
                              else binary_roc_auc(y_true, y_prob))
    else:
        acc, f1, prec, rec = _macro_prf(y_true, y_pred)
        m[f"{prefix}/accuracy"] = acc
        m[f"{prefix}/f1"] = f1
        m[f"{prefix}/precision"] = prec
        m[f"{prefix}/recall"] = rec
        if len(np.unique(y_true)) < 2 or not np.isfinite(y_prob).all():
            m[f"{prefix}/auc"] = 0.0
        else:
            m[f"{prefix}/auc"] = multiclass_ovr_auc(y_true, y_prob)

    m[f"{prefix}/loss"] = float(loss)
    m["num_samples"] = int(len(y_true))
    return m


def aggregate_batch_metrics(batch_metrics: List[Dict[str, float]], epoch: int,
                            prefix: str) -> Dict[str, float]:
    metrics: Dict[str, float] = {}
    names = set(batch_metrics[0].keys()) - {"num_samples"}
    total = sum(b["num_samples"] for b in batch_metrics)
    for name in names:
        metrics[name] = sum(b[name] * b["num_samples"]
                            for b in batch_metrics) / total
    if prefix != "val":
        metrics[f"{prefix}/progress/epoch"] = epoch
    return metrics


def compute_global_auc(domain_name: str, all_targets: np.ndarray,
                       all_probs: np.ndarray, prefix: str) -> Dict[str, float]:
    """Side-by-side corrected metric (not in the reference)."""
    is_binary = config.NUM_CLASSES[domain_name] == 2
    y_prob = all_probs[:, 1] if is_binary else all_probs
    if len(np.unique(all_targets)) < 2 or not np.isfinite(y_prob).all():
        auc = 0.0
    elif is_binary:
        auc = binary_roc_auc(np.asarray(all_targets), y_prob)
    else:
        auc = multiclass_ovr_auc(np.asarray(all_targets), y_prob)
    return {f"{prefix}/auc_global": auc}


def compute_training_metrics(epoch: int, step: int, loss: float,
                             lrs: Dict[str, float], domain_name: str,
                             targets, predictions, probabilities,
                             step_start_time: float,
                             grad_norm: float) -> Dict[str, float]:
    m = compute_batch_metrics(domain_name, targets, predictions, probabilities,
                              loss, "train")
    for name, lr in lrs.items():
        m[f"train/lr/{name}"] = lr
    m["train/gradients/model_grad_norm"] = float(grad_norm)
    m["train/progress/epoch"] = epoch
    m["train/progress/step"] = step
    m["train/system/time_per_step"] = time.time() - step_start_time
    return m


def compute_validation_metrics(batch_metrics, epoch):
    return aggregate_batch_metrics(batch_metrics, epoch, "val")


def compute_test_metrics(batch_metrics, epoch: int,
                         epochs_since_improvement: int,
                         training_start_time: float,
                         total_parameters: int,
                         trainable_parameters: int,
                         train_steps: int | None = None,
                         train_wall: float | None = None,
                         edges_per_step: float | None = None
                         ) -> Dict[str, float]:
    """Reference columns (analysis/data_collection.py:85-113) plus per-cell
    throughput telemetry: ``steps_per_sec`` is training steps over the
    training-loop wall (including per-epoch validation — the real sweep
    throughput), ``edges_per_sec`` scales it by real (mask-valid) edges
    aggregated per training step."""
    m = aggregate_batch_metrics(batch_metrics, epoch, "test")
    m["test/convergence_epochs"] = epoch - epochs_since_improvement
    m["test/training_time"] = time.time() - training_start_time
    m["test/total_parameters"] = total_parameters
    m["test/trainable_parameters"] = trainable_parameters
    if train_steps is not None and train_wall and train_wall > 0:
        sps = train_steps / train_wall
        m["test/steps_per_sec"] = sps
        if edges_per_step is not None:
            m["test/edges_per_sec"] = sps * edges_per_step
    return m
