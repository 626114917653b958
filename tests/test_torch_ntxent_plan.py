"""K2's grid plan (``ops.ntxent.plan``) on the CPU: every (row, column)
pair of S falls in exactly one block's chunk, no chunk is empty, and from
400 rows on the grid fills the H100's 132 SMs. The kernels' arithmetic is
in ``tests/test_torch_ntxent_split.py``."""

from __future__ import annotations

import numpy as np
import pytest

from gnn_pretraining_tpu_torch.ops import ntxent

H100_SMS = 132


@pytest.mark.parametrize("rows", [16, 400, 832, 2640, 4104, 8192])
def test_plan_covers_every_pair_once(rows):
    tiles, chunks, per = ntxent.plan(rows, H100_SMS)
    assert tiles * ntxent.TILE >= rows > (tiles - 1) * ntxent.TILE
    covered = np.zeros((rows, rows), np.int8)
    for i in range(tiles):
        for c in range(chunks):
            cols = slice(c * per * ntxent.TILE, min((c + 1) * per * ntxent.TILE, rows))
            assert cols.start < cols.stop                    # no empty chunk
            covered[i * ntxent.TILE:(i + 1) * ntxent.TILE, cols] += 1
    assert (covered == 1).all()
    if rows >= 400:
        assert tiles * chunks >= H100_SMS


def test_plan_fills_the_card_from_400_rows_on():
    for rows in range(400, 8194, 2):
        tiles, chunks, per = ntxent.plan(rows, H100_SMS)
        assert tiles * chunks >= H100_SMS, rows
        assert (chunks - 1) * per < tiles <= chunks * per, rows
