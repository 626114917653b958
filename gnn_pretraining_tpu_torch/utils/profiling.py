"""Throughput accounting, device traces and NaN checks of the training loops.

The port's copy of ``gnn_pretraining_tpu/utils/profiling.py``:

  * ``trace`` -- a ``torch.profiler`` trace of a block, written under a
    directory (view in Perfetto or chrome://tracing);
  * ``ThroughputMeter`` -- accumulate the real edge count of each step and
    read edges/s and steps/s over the window since ``reset``;
  * ``enable_nan_checks`` -- the counterpart of ``jax_debug_nans``
    (``pretrain --debug_nans``): autograd's anomaly mode, and a finite check
    of each task loss, the combined gradient and the updated parameters of
    every pretrain step and of every eval loss. The first non-finite value
    raises ``FloatingPointError`` naming where it was found. The switch is
    process-wide, as JAX's flag is; off (the default) the step reads one
    Python bool and does nothing else.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterable

import torch

_nan_checks = False


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True):
    """``with trace('outputs/profile'): step(...)`` writes a chrome trace of
    the block (host ops, and the card's kernels where there is one) to
    ``log_dir/trace_<time>.json``."""
    if not enabled:
        yield None
        return
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns()}.json"))


class ThroughputMeter:
    """Sliding accounting of processed edges (and steps) per second."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._edges = 0
        self._steps = 0

    def update(self, num_edges: int, num_spmm_calls: int = 1) -> None:
        """Record one step that aggregated ``num_edges`` real edges through
        ``num_spmm_calls`` aggregations (layers × forwards)."""
        self._edges += num_edges * num_spmm_calls
        self._steps += 1

    @property
    def edges_per_s(self) -> float:
        return self._edges / max(time.perf_counter() - self._t0, 1e-9)

    @property
    def steps_per_s(self) -> float:
        return self._steps / max(time.perf_counter() - self._t0, 1e-9)

    def metrics(self, prefix: str = "train/system") -> dict:
        return {f"{prefix}/edges_per_s": self.edges_per_s,
                f"{prefix}/steps_per_s": self.steps_per_s}


def enable_nan_checks(enabled: bool = True) -> None:
    """Switch the checked mode of pretraining on (or off): autograd's anomaly
    detection names a backward op that makes a NaN, and ``nan_checks_enabled``
    tells the steps to call ``check_finite``."""
    global _nan_checks
    _nan_checks = bool(enabled)
    torch.autograd.set_detect_anomaly(_nan_checks)


def nan_checks_enabled() -> bool:
    return _nan_checks


def check_finite(where: str, named: Iterable[tuple]) -> None:
    """Raise ``FloatingPointError`` at the first (name, tensor) of ``named``
    holding a NaN or an infinity, naming ``where`` and it. One host sync per
    call."""
    named = list(named)
    flags = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if not bool(flags.all()):
        name = named[int((~flags).nonzero()[0])][0]
        raise FloatingPointError(f"non-finite value at {where}: {name}")
