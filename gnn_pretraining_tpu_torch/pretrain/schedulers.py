"""Step schedulers as functions of the step counter, and their tables.

Port of ``gnn_pretraining_tpu/pretrain/schedulers.py`` (reference
src/pretrain/schedulers.py:10-45), evaluated in f32 on the host as the JAX
functions evaluate them in f32 on the device:

  * temperature: geometric anneal τ = 0.5 · (0.2/0.5)^progress;
  * GRL λ: 0 for the first 40% of steps, then (2/(1+e^{−10p}) − 1) · 0.01.

``temperature_table`` / ``grl_lambda_table`` hold each function's value at
every step 0..total_steps, built once on the host; the train step uploads
them once and indexes them with its device step counter, so a step replayed
from a CUDA graph reads the value of its own step, bit for bit the host
function's.
"""

from __future__ import annotations

import functools

import numpy as np

from gnn_pretraining_tpu_torch import config

_F = np.float32


def temperature_at(step: int, total_steps: int) -> float:
    progress = min(_F(1.0), _F(step) / _F(max(total_steps, 1)))
    ratio = _F(config.FINAL_TEMP) / _F(config.INITIAL_TEMP)
    return float(_F(config.INITIAL_TEMP) * ratio ** _F(progress))


def grl_lambda_at(step: int, total_steps: int) -> float:
    start = config.START_ADVERSARIAL_EPOCH_FRACTION * total_steps
    if step < start:
        return 0.0
    remaining = _F(max(total_steps - start, 1.0))
    p = (_F(step) - _F(start)) / remaining
    lam = (_F(2.0) / (_F(1.0) + np.exp(-_F(config.GRL_GAMMA) * p)) - _F(1.0))
    return float(lam * _F(config.MAX_LAMBDA))


def _table(fn, total_steps: int) -> np.ndarray:
    values = np.array([fn(step, total_steps) for step in range(total_steps + 1)],
                      np.float64)
    out = values.astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=8)
def temperature_table(total_steps: int) -> np.ndarray:
    """[total_steps + 1] f32: ``temperature_at(step, total_steps)`` per step."""
    return _table(temperature_at, total_steps)


@functools.lru_cache(maxsize=8)
def grl_lambda_table(total_steps: int) -> np.ndarray:
    """[total_steps + 1] f32: ``grl_lambda_at(step, total_steps)`` per step."""
    return _table(grl_lambda_at, total_steps)
