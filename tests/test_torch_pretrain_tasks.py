"""The four pretraining tasks besides the contrastive two, and their parts, in
the port against the JAX package, on the CPU.

Node-feature masking, link prediction, graph properties and
domain-adversarial: each task's loss, per-domain losses, gradients (every
parameter) and BatchNorm statistics after it, from the same carried weights
(the port's init with BatchNorm statistics, scales and GIN eps moved off
their init values, handed to JAX through ``utils/convert.py``) and the same
sampled batches, against the jitted JAX task (``_make_step_parts``'
``task_grad``) in train mode. The masking scores and the negative-sampling
uniforms are rebuilt from the JAX task's own key splits and injected into
the port (``TaskDraws``); the port's side of every ReLU kink is forced on the
JAX task. Dropout is at rate 0 on both sides, the domain classifier's too.
The step is past 40% of the run, so the gradient reversal's λ is above 0 and
the domain-adversarial gradient reaches the backbone. The model is cut to 2
GIN layers at the full width of 256 and two domains (MUTAG, ENZYMES), as in
``test_torch_pretrain_step.py``.

Tolerances: losses rtol 1e-4; gradients rtol 1e-4 / atol 1e-5; BatchNorm
statistics rtol 1e-4 (those of ``test_torch_pretrain_step.py``). Negative
sampling given JAX's uniforms must give JAX's pairs exactly; the gradient
reversal JAX's forward and backward exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.models.pretrain_model import PretrainableGNN as JaxPretrainableGNN
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.pretrain import tasks
from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource
from gnn_pretraining_tpu_torch.pretrain.schedulers import grl_lambda_at, temperature_at
from gnn_pretraining_tpu_torch.utils import relu_branches
from gnn_pretraining_tpu_torch.utils.convert import (
    load_variables,
    model_variables,
    state_dict_to_variables,
)
from test_torch_pretrain_step import (
    DOMAINS,
    GRAD_TOL,
    LAYERS,
    flat,
    forced_kinks,
    jax_mask_scores,
    jax_negatives,
    perturb,
)

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

SCHEME = "s5"
NEW_TASKS = ("node_feat_mask", "link_pred", "graph_prop", "domain_adv")
TOTAL_STEPS, STEP = 10, 7


@pytest.fixture(scope="module", autouse=True)
def small():
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "DROPOUT_RATE", 0.0)
            mp.setattr(c, "DOMAIN_CLASSIFIER_DROPOUT_RATE", 0.0)
            mp.setattr(c, "GNN_NUM_LAYERS", LAYERS)
            mp.setitem(c.PRETRAIN_DOMAINS, SCHEME, DOMAINS)
        yield


@pytest.fixture(scope="module")
def start(small, tmp_path_factory):
    """The carried weights, the JAX task step and the batches of one step."""
    tmp = tmp_path_factory.mktemp("task_stores")
    rng = np.random.default_rng(0)
    for domain in DOMAINS:
        synthetic_pretrain_store(domain, rng, num_graphs=30).save(tmp / f"{domain}.npz")
    task_names = config.ACTIVE_TASKS[SCHEME]
    model = PretrainableGNN(DOMAINS, task_names, "dense",
                            generator=torch.Generator().manual_seed(0), device="cpu")
    variables = perturb(state_dict_to_variables(model.state_dict()), 4)
    jmodel = JaxPretrainableGNN(domain_names=DOMAINS, task_names=task_names,
                                aggregation="dense")
    joptimizer = jax_opt.create_task_specific_optimizer(variables["params"], task_names)
    task_grad, _, _, _ = jax_pretrain._make_step_parts(
        jmodel, jax_config.PretrainConfig(SCHEME, 0), joptimizer, TOTAL_STEPS)
    return {
        "model": model, "variables": variables, "task_grad": task_grad,
        "jb": jax_loaders.create_pretrain_train_loader(
            DOMAINS, np.random.default_rng(1), tmp).sample_step(),
        "batches": loaders.create_pretrain_train_loader(
            DOMAINS, np.random.default_rng(1), tmp).sample_step(),
    }


@pytest.fixture(scope="module", params=NEW_TASKS)
def task_case(request, start):
    """One task on both sides from the same start, with JAX's draws."""
    task, model, variables = request.param, start["model"], start["variables"]
    load_variables(model, variables)
    model.train()
    key = jax.random.PRNGKey(11)
    batches = start["batches"]
    draws = tasks.TaskDraws()
    draws.inject(jax_mask_scores(key, batches) if task == "node_feat_mask" else [],
                 jax_negatives(key, batches) if task == "link_pred" else [])
    ctx = tasks.TaskContext(
        temperature=torch.tensor([temperature_at(STEP, TOTAL_STEPS)]), views=ViewSource(),
        grl_lambda=torch.tensor([grl_lambda_at(STEP, TOTAL_STEPS)]), draws=draws)
    names = [n for n, _ in model.named_parameters()]
    with relu_branches.record(model) as branches:
        loss, per_domain = tasks.compute_task_loss(task, model, batches, ctx)
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True)
    assert not draws.injected_masks and not draws.injected_negatives
    with forced_kinks(branches, []) as left:
        jloss, jper_domain, jstats, jgrads = jax.jit(
            start["task_grad"], static_argnames=("task",))(
            variables["params"], variables["batch_stats"], task, start["jb"], key,
            jnp.int32(STEP))
        assert left == ([], [])                        # every kink was taken
    zeros = dict(zip(names, (torch.zeros_like(p) for _, p in model.named_parameters())))
    port_grads = {**zeros, **{n: g for n, g in zip(names, grads) if g is not None}}
    return {
        "task": task, "lambda": float(ctx.grl_lambda),
        "loss": (float(loss.detach()), float(jloss)),
        "per_domain": ({d: float(v) for d, v in per_domain.items()},
                       {d: float(v) for d, v in jper_domain.items()}),
        "grads": (flat(state_dict_to_variables(port_grads)["params"]), flat(jgrads)),
        "stats": (flat(model_variables(model)["batch_stats"]), flat(jax.device_get(jstats))),
        "start_stats": flat(variables["batch_stats"]),
    }


def test_task_loss_and_per_domain_losses(task_case):
    got, want = task_case["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(got) and got > 0
    got, want = task_case["per_domain"]
    assert sorted(got) == sorted(want) == sorted(DOMAINS)
    for d, w in want.items():
        np.testing.assert_allclose(got[d], w, rtol=1e-4, err_msg=d)


def test_task_gradients(task_case):
    got, want = task_case["grads"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **GRAD_TOL)
    task = task_case["task"]
    reached = {k for k, v in got.items() if v.any()}
    # Its own heads, the backbone; the encoders for every task but masking
    # (an encode without a gradient), the mask token for masking alone.
    assert any(task in k for k in reached)
    assert any(k.startswith("['gnn_backbone']") for k in reached)
    assert any(k.startswith("['input_encoders_") for k in reached) == (task != "node_feat_mask")
    assert ("['mask_token']" in reached) == (task == "node_feat_mask")
    assert all(task in k for k in reached if k.startswith("['heads_"))
    if task == "domain_adv":
        assert task_case["lambda"] > 0


def test_task_batch_norm_statistics(task_case):
    got, want = task_case["stats"]
    assert got.keys() == want.keys()
    moved = 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        moved += not np.allclose(w, task_case["start_stats"][k])
    assert moved == len(want)            # every encoder and layer ran in train mode


