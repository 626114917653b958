"""The port's pretraining update parts against the JAX package's, on the CPU.

Schedulers, the loss balancer (warm-up, adaptive weights, clamp) and its host
mirror, PCGrad (the JAX permutation injected, participation included), the
optimizer's labels and learning rates, clipping and one AdamW step with
zero-gradient leaves against optax. Tolerances: f32 rounding (rtol 1e-6)
where both sides compute the same expression, exact where the result is
integral or boolean. The data path (views, sampler, stores, evaluation) is
in ``test_torch_pretrain_data.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.pretrain import balancer as jax_balancer
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu.pretrain import pcgrad as jax_pcgrad
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu.pretrain import schedulers as jax_sched
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.pretrain import balancer, optimizers, pcgrad, schedulers
from gnn_pretraining_tpu_torch.utils.convert import state_dict_to_variables

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("total", [1, 7, 463])
def test_schedulers_match_jax(total):
    for step in sorted({0, 1, total // 3, int(0.4 * total), total - 1, total, total + 5}):
        want_t = float(jax_sched.temperature_at(jnp.int32(step), total))
        want_l = float(jax_sched.grl_lambda_at(jnp.int32(step), total))
        np.testing.assert_allclose(schedulers.temperature_at(step, total), want_t, rtol=1e-6)
        np.testing.assert_allclose(schedulers.grl_lambda_at(step, total), want_l,
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("count", [0, 99, 100, 150])
def test_balancer_matches_jax(count):
    for losses in ({"a": 2.5, "b": 0.7, "c": 1.1}, {"a": -3.0, "b": 1.0}, {"only": 0.4}):
        want_total, want_w, want_count = jax_balancer.balance_losses(
            {k: jnp.float32(v) for k, v in losses.items()}, jnp.int32(count))
        total, w, new_count = balancer.balance_losses(
            {k: torch.tensor(v) for k, v in losses.items()}, count)
        assert new_count == int(want_count)
        np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
        for k in losses:
            np.testing.assert_allclose(float(w[k]), float(want_w[k]), rtol=1e-6)
        host_total, host_count = balancer.np_balance(losses, count)
        assert (host_total, host_count) == jax_pretrain._np_balance(losses, count)
    # Past the warm-up, the weights follow 1/|L|; the total is clamped at 1e-6.
    total, w, _ = balancer.balance_losses({"a": torch.tensor(-2.0), "b": torch.tensor(1.0)},
                                          config.BALANCER_WARMUP_STEPS)
    np.testing.assert_allclose([float(w["a"]), float(w["b"])], [1 / 3, 2 / 3], rtol=1e-6)
    assert float(total) == pytest.approx(config.BALANCER_MIN_TOTAL_LOSS)


PCGRAD_TREE = {"gnn_backbone": {"eps": (), "w": (6, 5)},
               "heads_node_contrast": {"MUTAG": (5, 3)},
               "heads_graph_contrast": {"MUTAG": (4,)},
               "input_encoders_MUTAG": {"w": (3, 5)},
               "mask_token": (5,)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcgrad_matches_jax(seed):
    """Three tasks with their participation: node_feat_mask reaches the mask
    token and not the encoders, each task its own heads."""
    rng = np.random.default_rng(seed)
    tasks = ("node_feat_mask", "node_contrast", "graph_contrast")

    def grads_of(task):
        def leaf(path, shape):
            top = jax.tree_util.keystr(path[:1])[2:-2]
            on = jax_pcgrad.task_participates(top, task)
            return jnp.asarray(rng.normal(size=shape) * on, jnp.float32)
        return jax.tree_util.tree_map_with_path(leaf, PCGRAD_TREE,
                                                is_leaf=lambda x: isinstance(x, tuple))

    # In sorted order, as the jitted JAX step hands the dict to apply_pcgrad.
    jgrads = {task: grads_of(task) for task in sorted(tasks)}
    key = jax.random.PRNGKey(seed)
    want, want_metrics = jax_pcgrad.apply_pcgrad(jgrads, key)
    perm = np.array(jax.random.permutation(key, len(tasks)))
    top_keys = jax_pcgrad._leaf_top_keys(jgrads[tasks[0]])
    got, metrics = pcgrad.apply_pcgrad(
        {task: [t(x) for x in jax.tree.leaves(g)] for task, g in jgrads.items()},
        top_keys, perm=perm)
    for g, w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    assert metrics.keys() == want_metrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=1e-6)
    assert float(metrics["gradient_surgery/total_conflicts"]) > 0
    # One task: passed through untouched, no metrics.
    only, none = pcgrad.apply_pcgrad({"node_contrast": got}, top_keys)
    assert none == {} and all(a is b for a, b in zip(only, got))


@pytest.fixture(scope="module")
def s2_model():
    return PretrainableGNN(("MUTAG", "ENZYMES"), ("node_contrast", "graph_contrast"),
                           "dense", generator=torch.Generator().manual_seed(0),
                           device="cpu")


def test_optimizer_labels_and_learning_rates_match_jax(s2_model):
    tasks = ("node_contrast", "graph_contrast")
    params = state_dict_to_variables(dict(s2_model.named_parameters()))["params"]
    want = flat(jax_opt.param_labels(params, tasks))
    labels = optimizers.param_labels(s2_model, tasks)
    names = [n for n, _ in s2_model.named_parameters()]
    index = flat(state_dict_to_variables(
        {n: torch.full(p.shape, float(i)) for i, (n, p) in
         enumerate(s2_model.named_parameters())})["params"])
    assert {k: labels[names[int(v.flat[0])]] for k, v in index.items()} == want
    assert {str(v) for v in want.values()} == {"default", *tasks}
    _, _, lrs = optimizers.create_task_specific_optimizer(s2_model, tasks)
    assert lrs == {"default": jax_config.DEFAULT_LR,
                   **{k: jax_config.TASK_SPECIFIC_LR[k] for k in tasks}}


def test_clip_matches_jax():
    rng = np.random.default_rng(4)
    for scale in (0.01, 3.0):
        leaves = [rng.normal(size=s).astype(np.float32) * scale for s in ((7, 3), (5,), ())]
        want, want_norm = jax_opt.clip_grads_torch([jnp.asarray(x) for x in leaves])
        got, norm = optimizers.clip_grads_torch([t(x) for x in leaves])
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_one_adamw_step_with_zero_gradient_leaves_matches_optax(s2_model):
    """Zeros (not None) where no task reaches a leaf: the mask token here.
    optax decays such a leaf and moves its moments; so must the port."""
    tasks = ("node_contrast", "graph_contrast")
    model = PretrainableGNN(("MUTAG", "ENZYMES"), tasks, "dense", device="cpu")
    model.load_state_dict(s2_model.state_dict())
    rng = np.random.default_rng(5)
    grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             * (0.0 if n == "mask_token" else 1.0)
             for n, p in model.named_parameters()}
    params = state_dict_to_variables(dict(model.named_parameters()))["params"]
    jgrads = state_dict_to_variables(grads)["params"]
    opt = jax_opt.create_task_specific_optimizer(params, tasks)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        updates, state = opt.update(jgrads, state, params)
        return optax.apply_updates(params, updates), state

    for _ in range(2):
        params, state = step(params, state)

    optimizer, _, _ = optimizers.create_task_specific_optimizer(model, tasks)
    start = model.mask_token.detach().clone()
    for _ in range(2):
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        optimizer.step()
    got = flat(state_dict_to_variables(dict(model.named_parameters()))["params"])
    for k, want in flat(params).items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-9, err_msg=k)
    decayed = start * (1 - config.DEFAULT_LR * config.DEFAULT_WEIGHT_DECAY) ** 2
    np.testing.assert_allclose(model.mask_token.detach().numpy(), decayed.numpy(), rtol=1e-7)


