"""The port's AdamW param groups against ``optax.multi_transform``, alone.

The same numpy gradients go three steps through the JAX package's
``create_finetune_optimizer`` and through the port's ``torch.optim.AdamW``
groups, for the three freeze patterns: ENZYMES/linear_probe (only the head
trains), ENZYMES/full_finetune (encoder frozen) and Cora_NC/full_finetune
(everything trains). Parameters must agree at atol=1e-6 (the two libraries
order the same f32 operations differently), frozen leaves bit for bit, and
the group learning rates and parameter counts exactly; the masked gradient
norm skips the frozen leaves. Each parameter's group against JAX's label is
in ``test_torch_finetune_optimizer.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.finetune import finetune as jax_ft
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu_torch import FinetuneGNN, config
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.utils.convert import (
    load_variables,
    model_variables,
    variables_to_state_dict,
)

torch.set_num_threads(1)


CELLS = [("ENZYMES", "linear_probe"), ("ENZYMES", "full_finetune"),
         ("Cora_NC", "full_finetune")]


_PARAMS = {}


def jax_params(domain):
    """Init once per domain (the tree does not depend on the graph's size)."""
    if domain not in _PARAMS:
        model = JaxFinetuneGNN(domain_name=domain, aggregation="coo")
        d = jax_config.DOMAIN_DIMENSIONS[domain]
        kw = dict(senders=jnp.zeros(4, jnp.int32), receivers=jnp.ones(4, jnp.int32),
                  edge_mask=jnp.ones(4))
        if jax_config.TASK_TYPES[domain] == "graph_classification":
            kw.update(node_graph=jnp.zeros(6, jnp.int32), num_graphs=2)
        init = jax.jit(lambda rngs, x, mask: model.init(rngs, x, mask, True, **kw))
        variables = init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.ones((6, d)), jnp.ones(6))
        _PARAMS[domain] = jax.device_get(dict(variables))
    return _PARAMS[domain]


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("domain,strategy", CELLS)
def test_adamw_groups_equal_optax_multi_transform(domain, strategy):
    variables = jax_params(domain)
    params = variables["params"]
    jcfg = jax_config.FinetuneConfig(domain, strategy, "b1", 0)
    cfg = config.FinetuneConfig(domain, strategy, "b1", 0)
    optimizer, labels, lrs = jax_ft.create_finetune_optimizer(params, jcfg)
    model = load_variables(FinetuneGNN(domain, "dense", device="cpu"), variables)
    toptimizer, tlabels, tlrs = ft.create_finetune_optimizer(model, cfg)

    assert tlrs == lrs
    assert ft.param_counts(model, tlabels) == jax_ft.param_counts(params, labels)
    frozen = {n for n, g in tlabels.items() if g == "frozen"}
    assert all(model.get_parameter(n).requires_grad != (n in frozen) for n in tlabels)

    rng = np.random.default_rng(1)
    state = optimizer.init(params)

    @jax.jit
    def update(grads, state, params):
        updates, state = optimizer.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for _ in range(3):
        # Gradients of mixed size, some tiny: AdamW's lr*g/(|g|+1e-8) regime.
        grads = jax.tree.map(
            lambda p: (rng.normal(size=np.shape(p)) * 10.0 ** rng.integers(-9, 1))
            .astype(np.float32), params)
        params, state = update(grads, state, params)
        tgrads = variables_to_state_dict({"params": grads})
        for name, p in model.named_parameters():
            p.grad = None if name in frozen else tgrads[name].clone()
        toptimizer.step()

    got, want, start = (flat(model_variables(model)["params"]), flat(params),
                        flat(variables["params"]))
    assert got.keys() == want.keys()
    jax_frozen = {k for k, g in flat(labels).items() if g == "frozen"}
    assert len(jax_frozen) == len(frozen)
    for key in want:
        if key in jax_frozen:
            np.testing.assert_array_equal(got[key], start[key], err_msg=key)
            np.testing.assert_array_equal(want[key], start[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
            assert not np.array_equal(got[key], start[key])      # it did move


def test_masked_grad_norm_skips_frozen_leaves():
    variables = jax_params("ENZYMES")
    cfg = config.FinetuneConfig("ENZYMES", "full_finetune", "b1", 0)
    jcfg = jax_config.FinetuneConfig("ENZYMES", "full_finetune", "b1", 0)
    model = load_variables(FinetuneGNN("ENZYMES", "dense", device="cpu"), variables)
    _, tlabels, _ = ft.create_finetune_optimizer(model, cfg)
    _, labels, _ = jax_ft.create_finetune_optimizer(variables["params"], jcfg)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32),
                         variables["params"])
    tgrads = variables_to_state_dict({"params": grads})
    for name, p in model.named_parameters():
        p.grad = tgrads[name].clone()           # frozen leaves too: they must not count
    want = jax_ft._masked_grad_norm(grads, labels)
    np.testing.assert_allclose(float(ft.masked_grad_norm(model, tlabels)), float(want),
                               rtol=1e-6)
