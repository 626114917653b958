"""The fine-tune metrics and the msgpack checkpoint writer against the JAX
package's, on the CPU: the batch, global, aggregated and run-level metrics
(rtol 1e-6 where both sides do the same f32 arithmetic), the AUC of a label
outside the score columns (0.0, where the JAX function raises), and
``packb`` / ``save_checkpoint`` read back by flax and by both packages. The
other building blocks of the fine-tune path are in
``test_torch_finetune_parts.py`` and ``test_torch_finetune_loaders.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.finetune import metrics as jax_metrics
from gnn_pretraining_tpu.utils import checkpoint as jax_checkpoint
from gnn_pretraining_tpu_torch.finetune import metrics
from gnn_pretraining_tpu_torch.utils import checkpoint
from gnn_pretraining_tpu_torch.utils._msgpack import packb, unpackb

torch.set_num_threads(1)


def metric_cases():
    rng = np.random.default_rng(0)
    y2 = rng.integers(0, 2, 80)
    p2 = rng.random(80)
    p2_ties = np.round(p2, 1)
    probs2 = np.stack([1 - p2, p2], 1)
    y6 = rng.integers(0, 6, 90)
    p6 = rng.random((90, 6))
    p6 /= p6.sum(1, keepdims=True)
    nonfinite = probs2.copy()
    nonfinite[3] = np.nan
    return {
        "binary": ("PTC_MR", y2, probs2),
        "binary_ties": ("Cora_LP", y2, np.stack([1 - p2_ties, p2_ties], 1)),
        "binary_single_class": ("Cora_LP", np.ones(40, np.int64), probs2[:40]),
        "binary_nonfinite": ("PTC_MR", y2, nonfinite),
        "multiclass": ("ENZYMES", y6, p6),
        "multiclass_missing_class": ("ENZYMES", np.where(y6 == 5, 0, y6), p6),
        "multiclass_single_class": ("ENZYMES", np.zeros(20, np.int64), p6[:20]),
    }


@pytest.mark.parametrize("case", sorted(metric_cases()))
def test_batch_and_global_metrics_equal_jax(case):
    domain, y, probs = metric_cases()[case]
    preds = probs.argmax(1)
    want = jax_metrics.compute_batch_metrics(domain, y, preds, probs, 0.7, "val")
    got = metrics.compute_batch_metrics(domain, y, preds, probs, 0.7, "val")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    # sklearn runs on the JAX side only; the port's closed form must equal it.
    want = jax_metrics.compute_global_auc(domain, y, probs, "test")
    got = metrics.compute_global_auc(domain, y, probs, "test")
    np.testing.assert_allclose(got["test/auc_global"], want["test/auc_global"],
                               rtol=1e-12, atol=1e-12)


def test_multiclass_auc_label_outside_columns_is_zero():
    """The JAX function indexes a column that is not there (IndexError);
    the port records 0.0, as for every case sklearn refuses."""
    y = np.array([0, 1, 3])
    probs = np.full((3, 3), 1 / 3)
    assert metrics.multiclass_ovr_auc(y, probs) == 0.0
    with pytest.raises(IndexError):
        jax_metrics.multiclass_ovr_auc(y, probs)


def test_aggregated_and_run_level_metrics_equal_jax():
    domain, y, probs = metric_cases()["multiclass"]
    batches_j, batches_t = [], []
    for lo, hi in ((0, 32), (32, 64), (64, 90)):
        args = (domain, y[lo:hi], probs[lo:hi].argmax(1), probs[lo:hi], 1.0 + lo, "test")
        batches_j.append(jax_metrics.compute_batch_metrics(*args))
        batches_t.append(metrics.compute_batch_metrics(*args))
    assert (metrics.compute_validation_metrics(batches_t, 3)
            == jax_metrics.compute_validation_metrics(batches_j, 3))
    want = jax_metrics.compute_test_metrics(batches_j, 5, 2, 0.0, 10, 4, train_steps=7,
                                            train_wall=2.0, edges_per_step=3.0)
    got = metrics.compute_test_metrics(batches_t, 5, 2, 0.0, 10, 4, train_steps=7,
                                       train_wall=2.0, edges_per_step=3.0)
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want if k != "test/training_time")
    lrs = {"backbone": 1e-4, "head": 1e-3}
    want = jax_metrics.compute_training_metrics(2, 9, 0.5, lrs, domain, y, probs.argmax(1),
                                                probs, 0.0, 1.5)
    got = metrics.compute_training_metrics(2, 9, 0.5, lrs, domain, y, probs.argmax(1),
                                           probs, 0.0, 1.5)
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want if k != "train/system/time_per_step")


def test_packb_round_trips_and_flax_restores_it():
    from flax import serialization

    rng = np.random.default_rng(0)
    tree = {"params": {"a": rng.normal(size=(3, 300)).astype(np.float32),
                       "eps": np.float32(0.25).reshape(()),
                       "half": rng.normal(size=70000).astype(np.float16)},
            "meta": {"epoch": 7, "neg": -40000, "big": 2 ** 40, "flag": True,
                     "none": None, "name": "x" * 300, "vals": [0.5, 1, "s"],
                     "scalar": np.float32(1.5)},
            "wide": {f"k{i}": i for i in range(20)}}
    blob = packb(tree)
    for restored in (unpackb(blob), serialization.msgpack_restore(blob)):
        np.testing.assert_array_equal(restored["params"]["a"], tree["params"]["a"])
        assert restored["params"]["eps"].shape == () and restored["params"]["eps"] == 0.25
        np.testing.assert_array_equal(restored["params"]["half"], tree["params"]["half"])
        assert restored["params"]["half"].dtype == np.float16
        meta = dict(restored["meta"])
        assert float(meta.pop("scalar")) == 1.5
        assert meta == {k: v for k, v in tree["meta"].items() if k != "scalar"}
        assert restored["wide"] == tree["wide"]
    # And the other way: what flax writes, packb reproduces byte for byte
    # wherever the encodings are canonical (arrays, small ints, strings).
    small = {"a": tree["params"]["a"], "n": 3, "s": "abc"}
    assert packb(small) == serialization.msgpack_serialize(small)
    with pytest.raises(TypeError):
        packb({"x": object()})


def test_save_checkpoint_loads_in_both_packages(tmp_path):
    rng = np.random.default_rng(1)
    params = {"head": {"kernel": rng.normal(size=(4, 3)).astype(np.float32)}}
    stats = {"bn": {"mean": np.zeros(3, np.float32), "var": np.ones(3, np.float32)}}
    path = tmp_path / "sub" / "model.msgpack"
    checkpoint.save_checkpoint(path, params, stats, 4, {"val/accuracy": np.float64(0.5)})
    assert not path.with_name(path.name + ".tmp").exists()
    for loaded in (checkpoint.load_checkpoint(path), jax_checkpoint.load_checkpoint(path)):
        np.testing.assert_array_equal(loaded["params"]["head"]["kernel"],
                                      params["head"]["kernel"])
        np.testing.assert_array_equal(loaded["batch_stats"]["bn"]["var"], stats["bn"]["var"])
        assert loaded["meta"] == {"epoch": 4, "val_metrics": {"val/accuracy": 0.5}}
