"""The port's offline preprocessing against the JAX package's, on the CPU.

``data.setup.main`` of both packages on the raw fixtures in
``tests/fixtures/{tu_raw,planetoid_raw}`` (in the PyG-nested layout; ENZYMES
and Cora): the same files, stores with the same keys, dtypes and ``meta__*``
values and equal arrays, the goldens of ``tests/test_parsers.py``, and
``data_fidelity`` reading the same block. The helpers here serve the other
files of the port's preprocessing tests: the synthetic fallback at scale
0.05 (``test_torch_data_setup_synthetic.py``), the parsers and the CLI
(``test_torch_data_parsers.py``), the generators
(``test_torch_data_generators.py``) and the split replicas
(``test_torch_split_replicas.py``).
"""

from __future__ import annotations

import contextlib
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.data import setup as jax_setup
from gnn_pretraining_tpu.utils import fidelity as jax_fidelity
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import setup
from gnn_pretraining_tpu_torch.utils import fidelity

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SCALE = 0.05
# graph_properties: the port computes them with numpy and scipy, the JAX
# package with networkx; the bound of test_torch_pretrain_parts.py's
# test_graph_properties_match_networkx. Measured: bitwise equal on every
# store here and at scale 1 (max |diff| 0.0).
PROPS_RTOL, PROPS_ATOL = 1e-5, 1e-6


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def nested_raw(root: Path) -> Path:
    """The fixtures in the ``<root>/<name>/raw/`` layout a PyG download has."""
    for name, src in (("ENZYMES", "tu_raw"), ("Cora", "planetoid_raw")):
        shutil.copytree(FIXTURES / src, root / name / "raw")
    return root


def assert_same_arrays(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_arrays(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_arrays(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


MODES = {"raw": lambda root: dict(raw_dir=nested_raw(root / "raw"), only=["ENZYMES", "Cora"]),
         "synthetic": lambda root: dict(raw_dir=root / "empty", synthetic_scale=SCALE)}


def make_stores(tmp_path_factory, mode):
    """(mode, package) -> the directory ``main()`` of that package wrote:
    on the nested raw fixtures (ENZYMES and Cora) or on the synthetic
    fallback at scale 0.05 (every dataset)."""
    root = tmp_path_factory.mktemp(f"setup_{mode}")
    kw = MODES[mode](root)
    out = {}
    for pkg, main in (("port", setup.main), ("jax", jax_setup.main)):
        out[mode, pkg] = root / mode / pkg
        quiet(main, processed_dir=out[mode, pkg], **kw)
    return out


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return make_stores(tmp_path_factory, "raw")


STORES = ([("raw", s) for s in ("ENZYMES", "Cora_NC", "Cora_LP")]
          + [("synthetic", s) for s in config.TUDATASETS]
          + [("synthetic", f"{p}_{t}") for p in config.PLANETOID_DATASETS for t in ("NC", "LP")])


@pytest.mark.parametrize("mode", ["raw"])
def test_main_writes_the_same_files(made, mode):
    names = sorted(p.name for p in made[mode, "port"].iterdir())
    assert names == sorted(p.name for p in made[mode, "jax"].iterdir())
    assert names == sorted(f"{s}.npz" for m, s in STORES if m == mode)


@pytest.mark.parametrize("mode,store", [c for c in STORES if c[0] == "raw"])
def test_main_stores_equal_jax(made, mode, store):
    with np.load(made[mode, "port"] / f"{store}.npz") as got, \
            np.load(made[mode, "jax"] / f"{store}.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        meta = {k: str(want[k]) for k in want.files if k.startswith("meta__")}
        assert meta["meta__source"] == mode
        assert meta["meta__scale"] == str(SCALE if mode == "synthetic" else 1.0)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if k == "graph_properties":
                np.testing.assert_allclose(got[k], want[k], rtol=PROPS_RTOL, atol=PROPS_ATOL)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# The goldens of tests/test_parsers.py (ENZYMES sorted val / test splits and
# the first graph's standardized properties; the Cora LP edge splits).
GOLDENS = {
    "ENZYMES val": ("ENZYMES", "split__val", [6, 15, 29]),
    "ENZYMES test": ("ENZYMES", "split__test", [5, 12, 24]),
    "ENZYMES props[0]": ("ENZYMES", "graph_properties",
                         [1.351691, 1.194792, -1.416671, 0.610796, 0.803358, 0.845154,
                          -1.510438, -1.444856, 0.0, 0.845154, -0.150188, 0.542266]),
    "Cora_LP val_pos": ("Cora_LP", "split__val_pos", [[2, 10, 13, 18, 11], [3, 1, 3, 16, 19]]),
    "Cora_LP test_pos": ("Cora_LP", "split__test_pos", [[9, 1, 7, 12, 18], [13, 7, 18, 4, 13]]),
    "Cora_LP val_neg": ("Cora_LP", "split__val_neg", [[1, 9, 1, 4, 15], [16, 18, 14, 1, 16]]),
}


@pytest.mark.parametrize("case", list(GOLDENS))
def test_port_holds_the_jax_goldens(made, case):
    store, key, want = GOLDENS[case]
    with np.load(made["raw", "port"] / f"{store}.npz") as z:
        got = z[key]
    if key == "graph_properties":
        np.testing.assert_allclose(got[0], want, atol=1e-4)
    elif got.ndim == 1:
        np.testing.assert_array_equal(np.sort(got), want)
    else:
        np.testing.assert_array_equal(got, want)


FIDELITY_CASES = [
    ("raw", ("ENZYMES",)), ("raw", ("ENZYMES", "Cora_NC")),
    ("synthetic", config.PRETRAIN_TUDATASETS), ("synthetic", ("Cora_NC",)),
    ("synthetic", ("PTC_MR", "Cora_LP")), ("synthetic", ("ENZYMES", "absent"))]


@pytest.mark.parametrize("mode,domains", [c for c in FIDELITY_CASES if c[0] == "raw"])
def test_data_fidelity_reads_the_same_block(made, mode, domains):
    blocks = [f(made[mode, pkg], domains) for pkg in ("port", "jax")
              for f in (fidelity.data_fidelity, jax_fidelity.data_fidelity)]
    assert all(b == blocks[0] for b in blocks)
    if mode == "synthetic" and "absent" not in domains:
        assert blocks[0] == {"data_source": "synthetic", "synthetic_scale": SCALE,
                             "calibration": 0.0}


