"""Helpers shared by the port's driver tests (``tests/test_torch_drivers.py``,
``test_torch_driver_grids.py``, ``test_torch_driver_cells.py``): the JAX
package's root drivers loaded by path, ``main(argv)`` with spies, and one
fine-tune cell's flags."""

from __future__ import annotations

import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SHARD = ["--num_shards", "24", "--shard_index", "12"]          # s2 under seed 42
FT_EPOCHS = 2


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_run_pretrain = _load("jax_run_pretrain", REPO / "run_pretrain.py")
jax_run_finetune = _load("jax_run_finetune", REPO / "run_finetune.py")


def call(main, argv, **spies):
    """``main(argv)`` with stdout captured and each ``name=module`` of
    ``spies`` having its ``name`` replaced by a recorder that must not run;
    -> (exit code, stdout, recorded calls)."""
    calls = []
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        for name, module in spies.items():
            mp.setattr(module, name, lambda *a, **k: calls.append((a, k)))
        rc = main(argv)
    return rc, out.getvalue(), calls


def cell(strategy, scheme):
    return ["--domain_name", "ENZYMES", "--finetune_strategy", strategy,
            "--pretrained_scheme", scheme, "--seed", "42", "--epochs", str(FT_EPOCHS)]
