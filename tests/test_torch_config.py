"""The PyTorch port's config equals the JAX one, and the port imports no JAX.

The port (``gnn_pretraining_tpu_torch``) keeps its own copy of every constant;
these tests hold each UPPERCASE name equal to its JAX counterpart, and check
in a fresh interpreter that importing every port module pulls in none of
jax, flax, msgpack or the JAX package. ``chip_smoke.py`` runs when imported,
so its import statements are read from its source.
"""

from __future__ import annotations

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import gnn_pretraining_tpu_torch
from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu_torch import config as torch_config

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONSTANTS = sorted(n for n in dir(jax_config) if n.isupper())
FORBIDDEN = ("jax", "flax", "msgpack", "gnn_pretraining_tpu")
# The port's own dispatch values: the JAX package's are TPU crossovers. The
# fused NT-Xent (K2) takes every single-device NT-Xent on the card until it is
# redesigned for the H100; its crossover against the plain formula is measured
# by chip_smoke.py and recorded in PERF.md.
PORT_DISPATCH = {"FUSED_NTXENT_MIN_ROWS": 0}


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_constants_equal_jax():
    assert sorted(n for n in dir(torch_config) if n.isupper()) == CONSTANTS
    assert set(PORT_DISPATCH) <= set(CONSTANTS)
    for name in CONSTANTS:
        want = PORT_DISPATCH.get(name, getattr(jax_config, name))
        assert getattr(torch_config, name) == want, name


def test_forbidden_prefix_spares_the_port():
    assert _forbidden("gnn_pretraining_tpu.ops.spmm")
    assert _forbidden("jax.numpy")
    assert not _forbidden("gnn_pretraining_tpu_torch.ops.spmm")
    assert not _forbidden("jaxtyping")


def test_port_modules_import_no_jax():
    modules = ["gnn_pretraining_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            gnn_pretraining_tpu_torch.__path__, "gnn_pretraining_tpu_torch.")]
    assert {"gnn_pretraining_tpu_torch.ops._build", "gnn_pretraining_tpu_torch.ops.spmm_csr",
            "gnn_pretraining_tpu_torch.finetune.runners"} <= set(modules)
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(modules) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert "gnn_pretraining_tpu_torch" in imported
    assert [m for m in imported if _forbidden(m)] == []
