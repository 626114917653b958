"""The run records a sweep resumes on, against the JAX package's
``utils/fidelity.py``, on the CPU: ``data_fidelity`` reads the same block
from a store directory, and ``cell_completed`` gives the same verdict on
the same summary files (complete, cut short, at other epochs, aggregation
or stores, absent or malformed).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.utils import fidelity as jax_fidelity
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.utils import fidelity

torch.set_num_threads(1)


def write_npz(path, **meta):
    np.savez(path, x=np.zeros(3), **{f"meta__{k}": v for k, v in meta.items()})


# The cases of tests/test_fidelity.py, on the same files for both packages.
STORES = {
    "provenance": {"A": dict(source=np.str_("synthetic"), scale=np.float64(0.25),
                             homophily=np.float64(0.0)),
                   "B": dict(source=np.str_("synthetic"), scale=np.float64(0.25),
                             homophily=np.float64(0.0))},
    "mixed provenance": {"A": dict(source=np.str_("synthetic"), scale=np.float64(1.0)),
                         "B": dict(source=np.str_("raw"), scale=np.float64(1.0))},
    "missing file": {"nope": None},
    "legacy store": {"A": {}},
    "calibration": {"A": dict(source=np.str_("synthetic"), homophily=np.float64(0.45))},
    "mixed calibration": {"A": dict(homophily=np.float64(0.45)),
                          "B": dict(homophily=np.float64(0.0))},
}


@pytest.mark.parametrize("case", list(STORES) + ["port store"])
def test_data_fidelity_matches_jax(tmp_path, case):
    if case == "port store":
        synthetic_pretrain_store("MUTAG", np.random.default_rng(0), 8).save(tmp_path / "M.npz")
        domains = ["M"]
    else:
        for name, meta in STORES[case].items():
            if meta is not None:
                write_npz(tmp_path / f"{name}.npz", **meta)
        domains = list(STORES[case])
    got = fidelity.data_fidelity(tmp_path, domains)
    assert got == jax_fidelity.data_fidelity(tmp_path, domains)
    assert fidelity.fidelity_block(50, 42, "pallas", tmp_path, domains) == \
        jax_fidelity.fidelity_block(50, 42, "pallas", tmp_path, domains)


@pytest.mark.parametrize("case", ["matching", "smoke run", "incomplete", "absent",
                                  "garbled", "pre-fidelity"])
def test_cell_completed_matches_jax(tmp_path, case):
    write_npz(tmp_path / "D.npz", source=np.str_("synthetic"), scale=np.float64(0.5),
              homophily=np.float64(0.0))
    block = fidelity.fidelity_block(50, 42, "pallas", tmp_path, ["D"])
    path = tmp_path / "run.summary.json"
    text = {"matching": json.dumps(block),
            "smoke run": json.dumps({**block, "fidelity/epochs": 2}),
            "incomplete": json.dumps({**block, "fidelity/completed": 0}),
            "absent": None, "garbled": "{not json",
            "pre-fidelity": json.dumps({"test/accuracy": 0.9})}[case]
    if text is not None:
        path.write_text(text)
    got = fidelity.cell_completed(path, block)
    assert got == jax_fidelity.cell_completed(path, block)
    assert got == (case == "matching")
