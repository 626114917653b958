"""Run-completion markers that carry the run's fidelity.

Port of ``gnn_pretraining_tpu/utils/fidelity.py``. Every run summary ends
with a ``fidelity/*`` block (epochs asked for, seed, aggregation, where the
stores came from, ``completed``), and a sweep script's ``--resume`` counts a
cell as done only when that block matches the fidelity it asks for now: a
2-epoch smoke run on cut stores never stands in for a production cell, and a
run that died before its summary was written never counts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from gnn_pretraining_tpu_torch import config

# The block's entries that must match for a cell to count as done.
MATCHED_KEYS = ("fidelity/epochs", "fidelity/aggregation", "fidelity/data_source",
                "fidelity/synthetic_scale", "fidelity/calibration")


def data_fidelity(processed_dir: Optional[Path],
                  domains: Sequence[str]) -> Dict[str, object]:
    """Provenance of the stores a run reads: the ``meta__source`` /
    ``meta__scale`` / ``meta__homophily`` entries of each ``<domain>.npz``.
    A store without them reports "unknown" / -1.0 / 0.0, a missing store
    "missing" / -1.0 / -1.0; stores that disagree report "mixed" / -1.0 /
    -1.0 for that entry."""
    processed_dir = Path(processed_dir or config.PROCESSED_DIR)
    sources, scales, homs = set(), set(), set()
    for d in domains:
        path = processed_dir / f"{d}.npz"
        if not path.exists():
            sources.add("missing")
            scales.add(-1.0)
            homs.add(-1.0)
            continue
        with np.load(path, allow_pickle=False) as z:
            sources.add(str(z["meta__source"]) if "meta__source" in z.files else "unknown")
            scales.add(float(z["meta__scale"]) if "meta__scale" in z.files else -1.0)
            homs.add(float(z["meta__homophily"]) if "meta__homophily" in z.files else 0.0)
    return {"data_source": sources.pop() if len(sources) == 1 else "mixed",
            "synthetic_scale": scales.pop() if len(scales) == 1 else -1.0,
            "calibration": homs.pop() if len(homs) == 1 else -1.0}


def fidelity_block(epochs: int, seed: int, aggregation: str,
                   processed_dir: Optional[Path],
                   domains: Sequence[str]) -> Dict[str, object]:
    """The ``fidelity/*`` entries merged into a run's summary at finish()."""
    d = data_fidelity(processed_dir, domains)
    return {
        "fidelity/epochs": int(epochs),
        "fidelity/seed": int(seed),
        "fidelity/aggregation": aggregation,
        "fidelity/data_source": d["data_source"],
        "fidelity/synthetic_scale": d["synthetic_scale"],
        "fidelity/calibration": d["calibration"],
        "fidelity/completed": 1,
    }


def cell_completed(summary_path: Path, expected: Dict[str, object]) -> bool:
    """True iff the summary exists, says ``completed``, and matches
    ``expected`` (a ``fidelity_block``) on ``MATCHED_KEYS``. A summary that
    cannot be read, or has no fidelity block, never counts as complete."""
    summary_path = Path(summary_path)
    if not summary_path.exists():
        return False
    try:
        with open(summary_path) as f:
            s = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    return bool(s.get("fidelity/completed")) and all(
        s.get(k) == expected.get(k) for k in MATCHED_KEYS)
