"""The port's offline preprocessing against the JAX package's, on the CPU.

The port's parsers, calibrated generators, scikit-learn-free splits and
``data.setup.main`` are held against the JAX package's on the same inputs:
the raw fixtures in ``tests/fixtures/{tu_raw,planetoid_raw}`` (flat and in
the PyG-nested layout) and the seeded synthetic fallback at scale 0.05. The
stores must have the same keys, dtypes and ``meta__*`` values and equal
arrays; the split replicas must equal scikit-learn's ``StratifiedShuffleSplit``
and ``ShuffleSplit`` (imported here only), raising where they raise.
"""

from __future__ import annotations

import contextlib
import io
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from sklearn.model_selection import ShuffleSplit, StratifiedShuffleSplit

from gnn_pretraining_tpu.data import parsers as jax_parsers
from gnn_pretraining_tpu.data import setup as jax_setup
from gnn_pretraining_tpu.data import synthetic as jax_synthetic
from gnn_pretraining_tpu.utils import fidelity as jax_fidelity
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import parsers, setup, synthetic
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


@pytest.mark.parametrize("kind", ["tu", "planetoid"])
@pytest.mark.parametrize("layout", ["flat", "nested", "missing"])
def test_parsers_equal_jax(tmp_path, kind, layout):
    name, fixture = {"tu": ("ENZYMES", "tu_raw"), "planetoid": ("Cora", "planetoid_raw")}[kind]
    raw = {"flat": lambda: FIXTURES / fixture, "nested": lambda: nested_raw(tmp_path),
           "missing": lambda: tmp_path}[layout]()
    port_fn, jax_fn = {"tu": (parsers.parse_tu_dataset, jax_parsers.parse_tu_dataset),
                       "planetoid": (parsers.parse_planetoid, jax_parsers.parse_planetoid)}[kind]
    if layout == "missing":
        for fn in (port_fn, jax_fn):
            with pytest.raises(FileNotFoundError):
                fn(raw, name)
        return
    assert_same_arrays(port_fn(raw, name), jax_fn(raw, name))


def _labels(rng, counts):
    return rng.permutation(np.repeat(np.arange(len(counts)) * 3 + 1, counts))


# (labels or a sample count for the plain split, test share). None of the
# labelled cases raises unless its id says so.
SPLIT_CASES = {
    "2 classes balanced": ((15, 15), 0.2),
    "3 classes uneven": ((20, 9, 8), 0.1),
    "5 classes odd": ((31, 7, 25, 19, 19), 0.5),
    "6 classes ENZYMES": ((100,) * 6, 0.2),
    "4 classes remainder ties": ((13, 13, 13, 22), 0.2),
    "6 classes 2 each": ((2,) * 6, 0.5),
    "raises: singleton class": ((12, 1, 9), 0.2),
    "raises: test slots < classes": ((5,) * 6, 0.1),
    "plain 30": (30, 0.1),
    "plain 411": (411, 0.1),
    "plain 7": (7, 0.5),
    "raises: plain empty train": (1, 0.5),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_replicas_equal_sklearn(case):
    spec, share = SPLIT_CASES[case]
    seed = config.PREPROCESS_RANDOM_SEED
    if isinstance(spec, int):
        port = lambda: setup.shuffle_split(spec, share, seed)  # noqa: E731
        ref = lambda: next(ShuffleSplit(1, test_size=share,  # noqa: E731
                                        random_state=seed).split(np.arange(spec)))
    else:
        y = _labels(np.random.default_rng(len(case)), spec)
        port = lambda: setup.stratified_shuffle_split(y, share, seed)  # noqa: E731
        ref = lambda: next(StratifiedShuffleSplit(  # noqa: E731
            1, test_size=share, random_state=seed).split(np.arange(len(y)), y))
    if case.startswith("raises"):
        for fn in (port, ref):
            with pytest.raises(ValueError):
                fn()
        return
    assert_same_arrays(port(), ref())


def test_generator_constants_equal_jax():
    import dataclasses

    assert {k: dataclasses.astuple(v) for k, v in synthetic.TU_SPECS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_synthetic.TU_SPECS.items()}
    for name in ("TU_SIGNAL", "PLANETOID_WPC", "PLANETOID_MIX", "PLANETOID_FLIP",
                 "PLANETOID_SPECS"):
        assert getattr(synthetic, name) == getattr(jax_synthetic, name), name
    # The stand-in stores' sizes come from the same table.
    assert synthetic.PRETRAIN_SIZES == {
        "MUTAG": (188, 17.9, 2.2), "PROTEINS": (1113, 39.1, 3.7),
        "NCI1": (4110, 29.9, 2.2), "ENZYMES": (600, 32.6, 3.8)}


@pytest.mark.parametrize("name,homophily",
                         [(n, h) for n in config.TUDATASETS for h in (0.0, 0.5)]
                         + [(n, None) for n in config.PLANETOID_DATASETS])
def test_generators_equal_jax(name, homophily):
    if homophily is None:
        assert_same_arrays(synthetic.generate_planetoid(name, seed=3, scale=SCALE),
                           jax_synthetic.generate_planetoid(name, seed=3, scale=SCALE))
    else:
        kw = dict(seed=3, scale=SCALE, homophily=homophily)
        assert_same_arrays(synthetic.generate_tu_dataset(name, **kw),
                           jax_synthetic.generate_tu_dataset(name, **kw))


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """``main()`` of each package on the nested raw fixtures (ENZYMES and
    Cora) and on the synthetic fallback at scale 0.05 (every dataset)."""
    root = tmp_path_factory.mktemp("setup")
    raw = nested_raw(root / "raw")
    out = {}
    for mode, kw in (("raw", dict(raw_dir=raw, only=["ENZYMES", "Cora"])),
                     ("synthetic", dict(raw_dir=root / "empty", synthetic_scale=SCALE))):
        for pkg, main in (("port", setup.main), ("jax", jax_setup.main)):
            out[mode, pkg] = root / mode / pkg
            quiet(main, processed_dir=out[mode, pkg], **kw)
    return out


STORES = ([("raw", s) for s in ("ENZYMES", "Cora_NC", "Cora_LP")]
          + [("synthetic", s) for s in config.TUDATASETS]
          + [("synthetic", f"{p}_{t}") for p in config.PLANETOID_DATASETS for t in ("NC", "LP")])


@pytest.mark.parametrize("mode", ["raw", "synthetic"])
def test_main_writes_the_same_files(made, mode):
    names = sorted(p.name for p in made[mode, "port"].iterdir())
    assert names == sorted(p.name for p in made[mode, "jax"].iterdir())
    assert names == sorted(f"{s}.npz" for m, s in STORES if m == mode)


@pytest.mark.parametrize("mode,store", STORES)
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


@pytest.mark.parametrize("mode,domains", [
    ("raw", ("ENZYMES",)), ("raw", ("ENZYMES", "Cora_NC")),
    ("synthetic", config.PRETRAIN_TUDATASETS), ("synthetic", ("Cora_NC",)),
    ("synthetic", ("PTC_MR", "Cora_LP")), ("synthetic", ("ENZYMES", "absent"))])
def test_data_fidelity_reads_the_same_block(made, mode, domains):
    blocks = [f(made[mode, pkg], domains) for pkg in ("port", "jax")
              for f in (fidelity.data_fidelity, jax_fidelity.data_fidelity)]
    assert all(b == blocks[0] for b in blocks)
    if mode == "synthetic" and "absent" not in domains:
        assert blocks[0] == {"data_source": "synthetic", "synthetic_scale": SCALE,
                             "calibration": 0.0}


def test_cli_flags_reach_main(tmp_path):
    argv = ["--processed_dir", str(tmp_path / "out"), "--raw_dir", str(tmp_path / "none"),
            "--synthetic_scale", str(SCALE), "--synthetic_seed", "3",
            "--synthetic_homophily", "0.5", "--only", "MUTAG", "Cora"]
    quiet(setup.main, **vars(setup.parse_args(argv)))
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "Cora_LP.npz", "Cora_NC.npz", "MUTAG.npz"]
    want = quiet(jax_setup.process_tu_dataset, "MUTAG", tmp_path / "none", SCALE, 3, 0.5)
    want.save(tmp_path / "want.npz")
    with np.load(tmp_path / "out" / "MUTAG.npz") as got, np.load(tmp_path / "want.npz") as w:
        assert sorted(got.files) == sorted(w.files)
        assert str(got["meta__homophily"]) == "0.5"
        for k in w.files:
            assert got[k].dtype == w[k].dtype
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
