"""The port's calibrated generators (``data/synthetic.py``) against the JAX
package's, on the CPU: the same constants and size table, and the same
arrays from every TU generator at homophily 0 and 0.5 and from both
Planetoid generators, at scale 0.05 and seed 3.
"""

from __future__ import annotations

import pytest
import torch

from gnn_pretraining_tpu.data import synthetic as jax_synthetic
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import synthetic
from test_torch_data_setup import SCALE, assert_same_arrays

torch.set_num_threads(1)


def test_generator_constants_equal_jax():
    import dataclasses

    assert {k: dataclasses.astuple(v) for k, v in synthetic.TU_SPECS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_synthetic.TU_SPECS.items()}
    for name in ("TU_SIGNAL", "PLANETOID_WPC", "PLANETOID_MIX", "PLANETOID_FLIP",
                 "PLANETOID_SPECS"):
        assert getattr(synthetic, name) == getattr(jax_synthetic, name), name
    # The stand-in stores' sizes come from the same table.
    assert synthetic.PRETRAIN_SIZES == {
        "MUTAG": (188, 17.9, 2.2), "PROTEINS": (1113, 39.1, 3.7),
        "NCI1": (4110, 29.9, 2.2), "ENZYMES": (600, 32.6, 3.8)}


@pytest.mark.parametrize("name,homophily",
                         [(n, h) for n in config.TUDATASETS for h in (0.0, 0.5)]
                         + [(n, None) for n in config.PLANETOID_DATASETS])
def test_generators_equal_jax(name, homophily):
    if homophily is None:
        assert_same_arrays(synthetic.generate_planetoid(name, seed=3, scale=SCALE),
                           jax_synthetic.generate_planetoid(name, seed=3, scale=SCALE))
    else:
        kw = dict(seed=3, scale=SCALE, homophily=homophily)
        assert_same_arrays(synthetic.generate_tu_dataset(name, **kw),
                           jax_synthetic.generate_tu_dataset(name, **kw))
