"""The port's raw-file parsers and the preprocessing CLI against the JAX
package's, on the CPU: the TU and Planetoid parsers on the raw fixtures in
``tests/fixtures`` (flat, in the PyG-nested layout, and missing, where both
raise), and ``data.setup``'s flags reaching ``main`` (the store equals the
JAX package's ``process_tu_dataset`` with the same scale, seed and
homophily).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.data import parsers as jax_parsers
from gnn_pretraining_tpu.data import setup as jax_setup
from gnn_pretraining_tpu_torch.data import parsers, setup
from test_torch_data_setup import FIXTURES, SCALE, assert_same_arrays, nested_raw, quiet

torch.set_num_threads(1)


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
