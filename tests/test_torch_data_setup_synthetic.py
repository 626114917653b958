"""``data.setup.main`` of both packages on the seeded synthetic fallback at
scale 0.05 (every dataset), on the CPU: the same files, stores with the
same keys, dtypes and ``meta__*`` values and equal arrays
(``graph_properties`` at the bound of ``test_graph_properties_match_networkx``),
and ``data_fidelity`` reading the same block from either package's
directory. The raw-fixture mode is in ``test_torch_data_setup.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.utils import fidelity as jax_fidelity
from gnn_pretraining_tpu_torch.utils import fidelity
from test_torch_data_setup import FIDELITY_CASES, PROPS_ATOL, PROPS_RTOL, SCALE, STORES, make_stores

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return make_stores(tmp_path_factory, "synthetic")


@pytest.mark.parametrize("mode", ["synthetic"])
def test_main_writes_the_same_files(made, mode):
    names = sorted(p.name for p in made[mode, "port"].iterdir())
    assert names == sorted(p.name for p in made[mode, "jax"].iterdir())
    assert names == sorted(f"{s}.npz" for m, s in STORES if m == mode)


@pytest.mark.parametrize("mode,store", [c for c in STORES if c[0] == "synthetic"])
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


@pytest.mark.parametrize("mode,domains", [c for c in FIDELITY_CASES if c[0] == "synthetic"])
def test_data_fidelity_reads_the_same_block(made, mode, domains):
    blocks = [f(made[mode, pkg], domains) for pkg in ("port", "jax")
              for f in (fidelity.data_fidelity, jax_fidelity.data_fidelity)]
    assert all(b == blocks[0] for b in blocks)
    if mode == "synthetic" and "absent" not in domains:
        assert blocks[0] == {"data_source": "synthetic", "synthetic_scale": SCALE,
                             "calibration": 0.0}
