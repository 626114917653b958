"""One scheme-s2 train step and one eval call of the port against the JAX
package's, on the CPU.

The same carried weights (the port's init, with BatchNorm statistics, scales
and GIN eps moved off their init values, handed to JAX through
``utils/convert.py``), the same sampled batches and the same views go through
the JAX step (``_make_step_parts``: each task's ``task_grad``, then
``update_core``, both jitted) and the port's ``make_train_step``, both on
the dense f32 aggregation and with dropout at rate 0. The views are drawn
once by the port's ``create_two_views`` and handed to both sides (the views
themselves are held against JAX's in ``test_torch_pretrain_parts.py``); the
JAX PCGrad permutation is injected into the port; the port's side of every
ReLU kink and the winners of every max pool (``utils/relu_branches.py``) are
forced on the jitted JAX step, where a value within rounding of a kink could
otherwise fall either way and move every gradient below it. The model is cut
to 2 GIN layers at the full width of 256 and to two domains (MUTAG, ENZYMES:
16 graphs each per step).

Tolerances: losses rtol 1e-4; per-task and combined gradients rtol 1e-4 /
atol 1e-5 (as the dense fine-tune step tests, ``test_torch_finetune_steps.py``);
BatchNorm statistics rtol 1e-4; parameters after the AdamW step relative to
the learning rate, as there (AdamW moves each element by about lr whatever
its gradient's size).
"""

from __future__ import annotations

import contextlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.models.pretrain_model import PretrainableGNN as JaxPretrainableGNN
from gnn_pretraining_tpu.pretrain import augmentations as jax_aug
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu.pretrain import tasks as jax_tasks
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.pretrain import optimizers
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain import tasks
from gnn_pretraining_tpu_torch.pretrain.augmentations import ViewSource, create_two_views
from gnn_pretraining_tpu_torch.utils import relu_branches
from gnn_pretraining_tpu_torch.utils.convert import (
    load_variables,
    model_variables,
    state_dict_to_variables,
)

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

DOMAINS = ("MUTAG", "ENZYMES")
LAYERS = 2
TASKS = ("node_contrast", "graph_contrast")
TOTAL_STEPS, STEP = 10, 3           # a step past 0: τ is not its initial value
EVAL_DOMAIN = "ENZYMES"
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def small_s2():
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "DROPOUT_RATE", 0.0)
            mp.setattr(c, "GNN_NUM_LAYERS", LAYERS)
            mp.setitem(c.PRETRAIN_DOMAINS, "s2", DOMAINS)
        yield


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("s2_stores")
    rng = np.random.default_rng(0)
    for domain in DOMAINS:
        synthetic_pretrain_store(domain, rng, num_graphs=30).save(tmp / f"{domain}.npz")
    return tmp


def perturb(variables, seed):
    """Move BN stats, BN scales and GIN eps off their init values."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = jax.tree_util.keystr(path[-1:])
        v = np.asarray(v)
        if "'mean'" in name:
            return (0.2 * rng.normal(size=v.shape)).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        if "'scale'" in name:
            return (1 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
        if "'eps'" in name:
            return np.float32(rng.uniform(-0.3, 0.3))
        return v

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(dict(variables)))


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def draw_views(batches, generator):
    """The port's views of each batch, in the tasks' call order: per task, per
    domain in sorted order (as jit hands the JAX step its batch dict)."""
    return [create_two_views(batch, generator)
            for _ in TASKS for _, batch in sorted(batches.items())]


@contextlib.contextmanager
def jax_takes_views(views):
    """Within the block each ``create_two_views`` of the JAX tasks returns the
    next of ``views`` (traced once per jit, in call order)."""
    view = lambda v: jax_aug.GraphView(*(jnp.asarray(a.numpy()) for a in v))  # noqa: E731
    queue = [(view(v1), view(v2), jnp.asarray(common.numpy())) for v1, v2, common in views]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tasks, "create_two_views", lambda key, batch: queue.pop(0))
        yield queue


@contextlib.contextmanager
def forced_kinks(branches, winners):
    """Within the block each ``nn.relu`` the JAX models trace takes the next of
    ``branches`` (the port's, in call order) as ``where(on, x, 0)``, and each
    max pool of the JAX tasks the mean over the next of ``winners``: both
    sides then pass value and gradient through the same units and nodes."""
    queue = [np.asarray(b) for b in branches]
    pools = [np.asarray(w) for w in winners]

    def relu(x):
        on = queue.pop(0)
        assert on.shape == x.shape, (on.shape, x.shape)
        return jnp.where(on, x, 0.0)

    def segment_max(data, ids, num, mask=None):
        w = jnp.asarray(pools.pop(0), data.dtype)
        w = w / jnp.maximum(jax.ops.segment_sum(w, ids, num), 1.0)[ids]
        return jax.ops.segment_sum(data * w, ids, num)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "relu", relu)
        mp.setattr(jax_tasks, "segment_max", segment_max)
        yield queue, pools


def run_case(processed_dir):
    jcfg, cfg = jax_config.PretrainConfig("s2", 0), config.PretrainConfig("s2", 0)
    jb = jax_loaders.create_pretrain_train_loader(
        DOMAINS, np.random.default_rng(1), processed_dir).sample_step()
    batches = loaders.create_pretrain_train_loader(
        DOMAINS, np.random.default_rng(1), processed_dir).sample_step()
    jval = jax_loaders.create_pretrain_val_loader(EVAL_DOMAIN, processed_dir=processed_dir)[0]
    val = loaders.create_pretrain_val_loader(EVAL_DOMAIN, processed_dir=processed_dir)[0]
    model = PretrainableGNN(DOMAINS, TASKS, "dense",
                            generator=torch.Generator().manual_seed(0), device="cpu")
    variables = perturb(state_dict_to_variables(model.state_dict()), 4)
    load_variables(model, variables)
    jmodel = JaxPretrainableGNN(domain_names=DOMAINS, task_names=TASKS, aggregation="dense")
    params, stats = variables["params"], variables["batch_stats"]
    joptimizer = jax_opt.create_task_specific_optimizer(params, TASKS)
    task_grad, update_core, assemble_metrics, _ = jax_pretrain._make_step_parts(
        jmodel, jcfg, joptimizer, TOTAL_STEPS)
    step = jnp.int32(STEP)
    keys = jax.random.split(jax.random.PRNGKey(5), len(TASKS) + 1)
    perm = np.array(jax.random.permutation(keys[-1], len(TASKS)))
    case = {"start": flat(params), "start_stats": flat(stats)}

    optimizer, labels, lrs = optimizers.create_task_specific_optimizer(model, TASKS)
    source = ViewSource()
    names = [n for n, _ in model.named_parameters()]
    generator = torch.Generator().manual_seed(7)

    # One eval call per task, on the first val batch, before the step.
    views = draw_views({EVAL_DOMAIN: val}, generator)
    jeval = jax_pretrain.make_eval_fn(jmodel, jcfg, TOTAL_STEPS)
    with jax_takes_views(views) as left:
        case["jax_eval"] = {task: float(jeval(params, stats, task, EVAL_DOMAIN, jval,
                                              jax.random.PRNGKey(9), step))
                            for task in TASKS}
        assert not left                                # every view was taken
    source.inject(views)
    port_eval = pt.make_eval_fn(model, cfg, TOTAL_STEPS, source)
    case["port_eval"] = {task: float(port_eval(task, EVAL_DOMAIN, val, STEP)) for task in TASKS}

    # The port's step on the views and the JAX PCGrad order, recording its
    # ReLU branches; then the JAX step on the views, taking those branches.
    views = draw_views(batches, generator)
    source.inject(views)
    train_step = pt.make_train_step(model, cfg, optimizer, TOTAL_STEPS, source)
    state = pt.PretrainState(opt_step=STEP)
    pooled = []
    with relu_branches.record(model) as branches, \
            relu_branches.max_pool(tasks, record=pooled):
        out = train_step(state, batches, perm=perm)
    assert not source.injected                         # every view was taken
    losses, per_domain, grads = {}, {}, {}
    s = stats
    with forced_kinks(branches, pooled) as left, jax_takes_views(views) as left_views:
        jtask_grad = jax.jit(task_grad, static_argnames=("task",))
        for i, task in enumerate(TASKS):
            losses[task], per_domain[task], s, grads[task] = jtask_grad(
                params, s, task, jb, keys[i], step)
        assert left == ([], []) and not left_views     # every kink and view was taken
    new_params, opt_state, _, metrics = jax.jit(update_core)(
        params, joptimizer.init(params), jnp.int32(0), losses, grads, None, keys[-1])
    metrics = assemble_metrics(metrics, per_domain, losses, None, step)

    case.update(
        jax_metrics={k: float(v) for k, v in metrics.items()},
        port_metrics={k: float(v) for k, v in out.items()},
        jax_task_grads={task: flat(g) for task, g in grads.items()},
        port_task_grads={task: flat(state_dict_to_variables(
            dict(zip(names, g)))["params"]) for task, g in train_step.last_task_grads.items()},
        jax_grads={k: v / 0.1 for group in ("default", *TASKS)
                   for k, v in flat(opt_state.inner_states[group].inner_state[0].mu).items()},
        port_grads=flat(state_dict_to_variables(
            {n: p.grad for n, p in model.named_parameters()})["params"]),
        jax_stats=flat(jax.device_get(s)), port_stats=flat(model_variables(model)["batch_stats"]),
        jax_params=flat(jax.device_get(new_params)),
        port_params=flat(model_variables(model)["params"]),
        lrs=lrs, labels=flat(jax_opt.param_labels(params, TASKS)), state=state)
    return case


@pytest.fixture(scope="module")
def case(processed_dir, small_s2):
    return run_case(processed_dir)


def test_losses_and_metric_keys_of_one_train_step(case):
    jm, pm = case["jax_metrics"], case["port_metrics"]
    assert pm.keys() == jm.keys()
    for k, want in jm.items():
        if k.startswith("gradient_surgery/"):
            continue
        np.testing.assert_allclose(pm[k], want, rtol=1e-4, err_msg=k)
    assert pm["gradient_surgery/total_projections"] == jm["gradient_surgery/total_projections"]
    assert case["state"].opt_step == STEP + 1 and case["state"].balancer_step == 1


def test_per_task_gradients_of_one_train_step(case):
    for task, want in case["jax_task_grads"].items():
        got = case["port_task_grads"][task]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, err_msg=f"{task} {k}", **GRAD_TOL)
        # The other task's heads and the mask token get zeros, not nothing.
        other = [k for k in got if "heads_" in k and task not in k] + ["['mask_token']"]
        assert other and all(not got[k].any() for k in other)


def flipped_conflicts(case):
    """Leaves where PCGrad's conflict test, the sign of ⟨g_nc, g_gc⟩, came out
    otherwise on the two sides: (the JAX dot product, the bound on its error
    that the per-task gradients' differences imply)."""
    out = {}
    jax_g, port_g = case["jax_task_grads"], case["port_task_grads"]
    for k, a in jax_g["node_contrast"].items():
        b, pa, pb = (jax_g["graph_contrast"][k], port_g["node_contrast"][k],
                     port_g["graph_contrast"][k])
        dot, port_dot = float(np.sum(a * b)), float(np.sum(pa * pb))
        if (dot < 0) != (port_dot < 0):
            out[k] = (dot, float(np.sum(np.abs(a - pa) * np.abs(b))
                                 + np.sum(np.abs(pa) * np.abs(b - pb))))
    return out


def test_combined_gradients_after_pcgrad_and_clipping(case):
    """Strict on every leaf where both sides took PCGrad's conflict decision
    alike. A decision is the sign of a per-leaf dot product of the two tasks'
    gradients; where that dot product lies within the error the per-task
    gradients' own differences allow (a bias in front of a BatchNorm, whose
    gradient is rounding noise), the sides may decide otherwise, and that
    leaf then differs by PCGrad's projection."""
    got, want = case["port_grads"], case["jax_grads"]
    assert got.keys() == want.keys()
    flipped = flipped_conflicts(case)
    for k, (dot, bound) in flipped.items():
        assert abs(dot) <= bound, (k, dot, bound)
    assert len(flipped) <= 0.1 * len(want)
    for k, w in want.items():
        if k not in flipped:
            np.testing.assert_allclose(got[k], w, err_msg=k, **GRAD_TOL)
    assert abs(case["port_metrics"]["gradient_surgery/total_conflicts"]
               - case["jax_metrics"]["gradient_surgery/total_conflicts"]) <= len(flipped)


def test_batch_norm_statistics_after_one_train_step(case):
    assert case["port_stats"].keys() == case["jax_stats"].keys()
    for k, want in case["jax_stats"].items():
        np.testing.assert_allclose(case["port_stats"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)
        assert not np.allclose(want, case["start_stats"][k]), k


def test_parameters_after_one_train_step(case):
    """Where the gradient is clear (|g| > 1e-4, on a leaf whose PCGrad
    decision both sides took alike) the two AdamW updates agree within
    0.05 lr in all but 0.5% of a leaf's elements; everywhere within 2 lr (a
    rounding-noise gradient's sign decides an element's direction).
    The mask token, which no task reaches, is only decayed."""
    moved = 0
    flipped = flipped_conflicts(case)
    for k, want in case["jax_params"].items():
        got, lr = case["port_params"][k], case["lrs"][str(case["labels"][k])]
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr * 1.01 + 1e-7, (k, diff.max() / lr)
        clear = np.abs(case["jax_grads"][k]) > 1e-4
        if clear.any() and k not in flipped:
            assert np.mean(diff[clear] > 0.05 * lr) <= 0.005, (k, diff[clear].max() / lr)
            moved += int((np.abs(want - case["start"][k])[clear] > 0.5 * lr).sum())
    assert moved > 1000
    np.testing.assert_allclose(case["port_params"]["['mask_token']"],
                               case["start"]["['mask_token']"] * (1 - 1e-5 * 1e-5), rtol=1e-7)


def test_eval_call_matches_jax(case):
    for task, want in case["jax_eval"].items():
        np.testing.assert_allclose(case["port_eval"][task], want, rtol=1e-4, err_msg=task)

