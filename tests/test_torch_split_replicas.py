"""The port's scikit-learn-free splits (``data.setup.stratified_shuffle_split``
and ``shuffle_split``) against scikit-learn's ``StratifiedShuffleSplit`` and
``ShuffleSplit`` (imported here only), on the CPU: the same index arrays on
2 to 6 classes, odd sizes, test shares 0.1 / 0.2 / 0.5 and remainder ties,
and a ``ValueError`` where scikit-learn raises (a singleton class, fewer
test slots than classes, an empty train set).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from sklearn.model_selection import ShuffleSplit, StratifiedShuffleSplit

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import setup
from test_torch_data_setup import assert_same_arrays

torch.set_num_threads(1)


# (labels or a sample count for the plain split, test share). None of the
# labelled cases raises unless its id says so.
SPLIT_CASES = {
    "2 classes balanced": ((15, 15), 0.2),
    "3 classes uneven": ((20, 9, 8), 0.1),
    "5 classes odd": ((31, 7, 25, 19, 19), 0.5),
    "6 classes ENZYMES": ((100,) * 6, 0.2),
    "4 classes remainder ties": ((13, 13, 13, 22), 0.2),
    "6 classes 2 each": ((2,) * 6, 0.5),
    "raises: singleton class": ((12, 1, 9), 0.2),
    "raises: test slots < classes": ((5,) * 6, 0.1),
    "plain 30": (30, 0.1),
    "plain 411": (411, 0.1),
    "plain 7": (7, 0.5),
    "raises: plain empty train": (1, 0.5),
}


def _labels(rng, counts):
    return rng.permutation(np.repeat(np.arange(len(counts)) * 3 + 1, counts))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_replicas_equal_sklearn(case):
    spec, share = SPLIT_CASES[case]
    seed = config.PREPROCESS_RANDOM_SEED
    if isinstance(spec, int):
        port = lambda: setup.shuffle_split(spec, share, seed)  # noqa: E731
        ref = lambda: next(ShuffleSplit(1, test_size=share,  # noqa: E731
                                        random_state=seed).split(np.arange(spec)))
    else:
        y = _labels(np.random.default_rng(len(case)), spec)
        port = lambda: setup.stratified_shuffle_split(y, share, seed)  # noqa: E731
        ref = lambda: next(StratifiedShuffleSplit(  # noqa: E731
            1, test_size=share, random_state=seed).split(np.arange(len(y)), y))
    if case.startswith("raises"):
        for fn in (port, ref):
            with pytest.raises(ValueError):
                fn()
        return
    assert_same_arrays(port(), ref())
