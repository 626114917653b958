"""Metric sink: local JSONL (the source of truth) with optional wandb mirroring.

Port of ``gnn_pretraining_tpu/utils/logging.py:54-100``: the same metric
namespaces go to ``<out_dir>/<project>/<run>.jsonl`` and a
``<run>.summary.json`` of the last value of every key. ``wandb`` is imported
only when the caller asks for it.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

from gnn_pretraining_tpu_torch import config


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


class MetricLogger:
    def __init__(self, project: str, run_name: str,
                 out_dir: Optional[Path] = None, use_wandb: bool = False):
        self.project = project
        self.run_name = run_name
        out_dir = Path(out_dir or config.METRICS_DIR) / project
        out_dir.mkdir(parents=True, exist_ok=True)
        self.path = out_dir / f"{run_name}.jsonl"
        self._fh = open(self.path, "a", buffering=1)
        self._summary: Dict[str, float] = {}
        self._wandb = None
        if use_wandb:
            import wandb  # only on request: the card's machine has none

            self._wandb = wandb
            wandb.init(project=project, name=run_name)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        row = {k: _to_float(v) for k, v in metrics.items()}
        row["_step"] = int(step)
        row["_time"] = time.time()
        self._fh.write(json.dumps(row) + "\n")
        self._summary.update({k: v for k, v in row.items()
                              if not k.startswith("_")})
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self, extra: Optional[Dict] = None) -> None:
        """Write the summary (atomic replace), ``extra`` merged in."""
        if extra:
            self._summary.update(extra)
        summary_path = self.path.with_suffix(".summary.json")
        tmp = summary_path.with_name(summary_path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self._summary, f, indent=2)
        os.replace(tmp, summary_path)
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


class SilentLogger:
    """A ``MetricLogger`` that writes nothing: the logger of every rank of a
    data-parallel run but rank 0."""

    def log(self, metrics: Dict[str, float], step: int) -> None:
        pass

    def finish(self, extra: Optional[Dict] = None) -> None:
        pass
