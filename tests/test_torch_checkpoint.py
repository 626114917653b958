"""The port's flax-msgpack reader against flax itself.

``gnn_pretraining_tpu_torch.utils._msgpack`` decodes what
``flax.serialization`` writes without the msgpack package; every leaf it
returns must equal flax's ``msgpack_restore``, exactly, on the tracked
transfer artifacts and on checkpoints the JAX package writes here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from flax import serialization

from gnn_pretraining_tpu import config
from gnn_pretraining_tpu.utils import checkpoint as jax_checkpoint
from gnn_pretraining_tpu_torch.utils import _msgpack
from gnn_pretraining_tpu_torch.utils import checkpoint as torch_checkpoint

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

TRANSFER = sorted((config.ARTIFACTS_DIR / "transfer").glob("*.msgpack"))


def assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_all_transfer_artifacts_tracked():
    assert len(TRANSFER) == 8


@pytest.mark.parametrize("path", TRANSFER, ids=lambda p: p.stem)
def test_transfer_artifact_equals_flax(path):
    want = serialization.msgpack_restore(path.read_bytes())
    assert_same_tree(torch_checkpoint.load_checkpoint(path), want)


def test_transfer_artifact_promotion_equals_jax():
    path = config.ARTIFACTS_DIR / "transfer" / "backbone_b2_42.msgpack"
    got = torch_checkpoint.load_transfer_artifact(path)
    want = jax_checkpoint.load_transfer_artifact(path)
    assert_same_tree(got, want)
    eps = got["params"]["gnn_backbone"]["layers_0"]["eps"]
    assert eps.dtype == np.float32 and eps.shape == ()


def test_jax_save_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    params = {"gnn_backbone": {"layers_0": {
        "eps": np.float32(0.25),
        "mlp_0": {"kernel": rng.normal(size=(5, 7)).astype(np.float32),
                  "bias": rng.normal(size=7).astype(np.float32)}}}}
    stats = {"gnn_backbone": {"layers_0": {"mlp_bn": {
        "mean": np.zeros(7, np.float32), "var": np.ones(7, np.float32)}}}}
    extra = {"scheme": "b2" * 200, "ints": [0, 127, 128, 300, 70000, 2**40,
                                           -1, -33, -200, -40000, -2**40],
             "flags": [True, False, None], "many": {f"k{i}": i for i in range(20)},
             "long_list": list(range(20)), "blob": b"\x00\x01" * 10,
             "half": np.arange(4, dtype=np.float16), "ids": np.arange(3)}
    path = tmp_path / "ckpt.msgpack"
    jax_checkpoint.save_checkpoint(path, params, stats, epoch=3,
                                   val_metrics={"val/loss": 0.5}, extra=extra)
    assert_same_tree(torch_checkpoint.load_checkpoint(path),
                     jax_checkpoint.load_checkpoint(path))


def test_npscalar_extension_is_a_0d_array():
    blob = serialization.msgpack_serialize({"s": np.float16(1.5),
                                            "f": np.float32(-2.0)})
    got = _msgpack.unpackb(blob)
    assert got["s"].shape == () and got["s"].dtype == np.float16
    assert float(got["s"]) == 1.5 and float(got["f"]) == -2.0


def test_unknown_extension_raises():
    with pytest.raises(ValueError, match="extension code 5"):
        _msgpack.unpackb(bytes([0xD4, 0x05, 0x00]))        # fixext1, code 5
    with pytest.raises(ValueError, match="type byte 0xc1"):
        _msgpack.unpackb(bytes([0xC1]))                     # never used
