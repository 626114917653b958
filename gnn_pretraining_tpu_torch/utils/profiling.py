"""Throughput accounting of the training loops.

The port's copy of ``ThroughputMeter`` from
``gnn_pretraining_tpu/utils/profiling.py``: accumulate the real edge count of
each step and read edges/s and steps/s over the window since ``reset``.
"""

from __future__ import annotations

import time


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
