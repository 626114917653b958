"""One train step and one evaluation of the port against the JAX package's,
on the CPU, for schemes s2 (node + graph contrast), s5 (all six tasks) and
b4 (five tasks on ENZYMES alone, 32 graphs per step).

The same carried weights (the port's init, with BatchNorm statistics, scales
and GIN eps moved off their init values, handed to JAX through
``utils/convert.py``), the same sampled batches and the same views go through
the JAX step (``_make_step_parts``: each task's ``task_grad``, then
``update_core``, both jitted) and the port's ``make_train_step``, both on
the dense f32 aggregation and with dropout at rate 0 (the domain
classifier's too). The views are drawn once by the port's
``create_two_views`` and handed to both sides (the views themselves are held
against JAX's in ``test_torch_pretrain_parts.py``); node-feature masking's
scores and link prediction's negative-sampling uniforms are rebuilt from the
JAX tasks' own key splits and injected into the port (``TaskDraws``); the
JAX PCGrad permutation is injected into the port; the port's side of every
ReLU kink and the winners of every max pool (``utils/relu_branches.py``) are
forced on the jitted JAX step, where a value within rounding of a kink could
otherwise fall either way and move every gradient below it. The model is cut
to 2 GIN layers at the full width of 256 and, for s2 and s5, to two domains
(MUTAG, ENZYMES: 16 graphs each per step). s5 and b4 take a step past 40% of
the run, where the gradient reversal's λ is above 0, so the
domain-adversarial gradient reaches the backbone; it is added after PCGrad.

Tolerances: losses rtol 1e-4; per-task and combined gradients rtol 1e-4 /
atol 1e-5 (as the dense fine-tune step tests, ``test_torch_finetune_steps.py``);
BatchNorm statistics rtol 1e-4; parameters after the AdamW step relative to
the learning rate, as there (AdamW moves each element by about lr whatever
its gradient's size).
"""

from __future__ import annotations

import contextlib
import types

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
from gnn_pretraining_tpu_torch.ops.sampling import NegativeDraws
from gnn_pretraining_tpu_torch.pretrain import optimizers
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain import tasks as port_tasks
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
TOTAL_STEPS = 10
# The step each scheme takes: past 0, so τ is not its initial value; for the
# schemes that run domain_adv (and b4 with them) past 40% of the run, so the
# gradient reversal's λ is above 0.
STEPS = {"s2": 3, "s5": 7, "b4": 7}
CONTRASTIVE = ("node_contrast", "graph_contrast")
EVAL_DOMAIN = "ENZYMES"
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def small():
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "DROPOUT_RATE", 0.0)
            mp.setattr(c, "DOMAIN_CLASSIFIER_DROPOUT_RATE", 0.0)
            mp.setattr(c, "GNN_NUM_LAYERS", LAYERS)
            mp.setitem(c.PRETRAIN_DOMAINS, "s2", DOMAINS)
            mp.setitem(c.PRETRAIN_DOMAINS, "s5", DOMAINS)
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


def draw_views(batches, generator, tasks):
    """The port's views of each batch, in the tasks' call order: per
    contrastive task, per domain in sorted order (as jit hands the JAX step
    its batch dict)."""
    return [create_two_views(batch, generator)
            for t in tasks if t in CONTRASTIVE for _, batch in sorted(batches.items())]


def jax_mask_scores(key, batches):
    """Node-feature masking's node scores as the JAX task draws them from
    its key: per domain in sorted order, ``key, k_enc, k_sel, k_bb, k_head =
    split(key, 5)``, then ``uniform(k_sel, (N,))``."""
    out = []
    for _, batch in sorted(batches.items()):
        key, _, k_sel, _, _ = jax.random.split(key, 5)
        out.append(torch.from_numpy(np.array(
            jax.random.uniform(k_sel, (batch.num_nodes,)))))
    return out


def jax_negatives(key, batches):
    """Link prediction's negative-sampling uniforms as the JAX task draws
    them: per domain in sorted order ``key, k_neg, k_fwd, k_head =
    split(key, 4)``; of ``split(k_neg, ROUNDS + 1)`` each round splits its
    key into the u and v draws, the last key draws the fallback."""
    out = []
    for _, batch in sorted(batches.items()):
        key, k_neg, _, _ = jax.random.split(key, 4)
        e = batch.num_edges
        keys = jax.random.split(k_neg, jax_config.NEG_SAMPLING_ROUNDS + 1)
        rounds = [jax.random.split(k) for k in keys[:-1]]
        draw = lambda k: np.array(jax.random.uniform(k, (e,)))  # noqa: E731
        out.append(NegativeDraws(torch.from_numpy(np.stack([draw(ku) for ku, _ in rounds])),
                                 torch.from_numpy(np.stack([draw(kv) for _, kv in rounds])),
                                 torch.from_numpy(draw(keys[-1]))))
    return out


def inject_jax_draws(draws, tasks, keys, batches):
    """Hand the port the draws the JAX tasks make from ``keys`` (one per
    task, in the scheme's order)."""
    masks = (jax_mask_scores(keys[tasks.index("node_feat_mask")], batches)
             if "node_feat_mask" in tasks else [])
    negatives = (jax_negatives(keys[tasks.index("link_pred")], batches)
                 if "link_pred" in tasks else [])
    draws.inject(masks, negatives)


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


class _Logger:
    def log(self, metrics, step):
        pass


def run_case(processed_dir, scheme):
    domains = ("ENZYMES",) if scheme == "b4" else DOMAINS
    jcfg, cfg = jax_config.PretrainConfig(scheme, 0), config.PretrainConfig(scheme, 0)
    tasks = cfg.active_tasks
    main = [t for t in tasks if t != "domain_adv"]
    step_no = STEPS[scheme]
    jb = jax_loaders.create_pretrain_train_loader(
        domains, np.random.default_rng(1), processed_dir).sample_step()
    batches = loaders.create_pretrain_train_loader(
        domains, np.random.default_rng(1), processed_dir).sample_step()
    jval = jax_loaders.create_pretrain_val_loader(EVAL_DOMAIN, processed_dir=processed_dir)[0]
    val = loaders.create_pretrain_val_loader(EVAL_DOMAIN, processed_dir=processed_dir)[0]
    model = PretrainableGNN(domains, tasks, "dense",
                            generator=torch.Generator().manual_seed(0), device="cpu")
    variables = perturb(state_dict_to_variables(model.state_dict()), 4)
    load_variables(model, variables)
    jmodel = JaxPretrainableGNN(domain_names=domains, task_names=tasks, aggregation="dense")
    params, stats = variables["params"], variables["batch_stats"]
    joptimizer = jax_opt.create_task_specific_optimizer(params, tasks)
    task_grad, update_core, assemble_metrics, _ = jax_pretrain._make_step_parts(
        jmodel, jcfg, joptimizer, TOTAL_STEPS)
    step = jnp.int32(step_no)
    keys = jax.random.split(jax.random.PRNGKey(5), len(tasks) + 1)
    perm = np.array(jax.random.permutation(keys[-1], len(main)))
    case = {"start": flat(params), "start_stats": flat(stats), "scheme": scheme,
            "tasks": tasks, "main": main, "perm": perm, "step": step_no}

    optimizer, labels, lrs = optimizers.create_task_specific_optimizer(model, tasks)
    source, draws = ViewSource(), port_tasks.TaskDraws()
    names = [n for n, _ in model.named_parameters()]
    generator = torch.Generator().manual_seed(7)

    # run_evaluation over one val batch, before the step: each (task, batch)
    # call takes the next of the JAX loop's keys.
    views = draw_views({EVAL_DOMAIN: val}, generator, tasks)
    jeval = jax_pretrain.make_eval_fn(jmodel, jcfg, TOTAL_STEPS)
    jstate = types.SimpleNamespace(params=params, batch_stats=stats, opt_step=step,
                                   balancer_step=jnp.int32(0))
    eval_key = jax.random.PRNGKey(9)
    subs = []
    for _ in tasks:
        eval_key, sub = jax.random.split(eval_key)
        subs.append(sub)
    with jax_takes_views(views) as left:
        jtotal, jmetrics, jbalancer = jax_pretrain.run_evaluation(
            jeval, jstate, jcfg, {EVAL_DOMAIN: [jval]}, jax.random.PRNGKey(9), 1,
            _Logger(), 0)
        assert not left                                # every view was taken
    source.inject(views)
    inject_jax_draws(draws, tasks, subs, {EVAL_DOMAIN: val})
    port_eval = pt.make_eval_fn(model, cfg, TOTAL_STEPS, source, draws)
    ptotal, pmetrics, pbalancer = pt.run_evaluation(
        port_eval, pt.PretrainState(opt_step=step_no), cfg, {EVAL_DOMAIN: [val]},
        _Logger(), 0)
    assert not source.injected and not draws.injected_masks and not draws.injected_negatives
    case["jax_eval"] = {**jmetrics, "balancer_step": jbalancer, "total": jtotal}
    case["port_eval"] = {**pmetrics, "balancer_step": pbalancer, "total": ptotal}

    # The port's step on the views, the JAX draws and the JAX PCGrad order,
    # recording its ReLU branches; then the JAX step on the views, taking
    # those branches.
    views = draw_views(batches, generator, tasks)
    source.inject(views)
    inject_jax_draws(draws, tasks, keys, batches)
    train_step = pt.make_train_step(model, cfg, optimizer, TOTAL_STEPS, source, draws=draws)
    state = pt.PretrainState(opt_step=step_no)
    pooled = []
    with relu_branches.record(model) as branches, \
            relu_branches.max_pool(port_tasks, record=pooled):
        out = train_step(state, batches, perm=perm)
    assert not source.injected                         # every view was taken
    assert not draws.injected_masks and not draws.injected_negatives
    losses, per_domain, grads = {}, {}, {}
    s, da_loss, da_grads = stats, None, None
    with forced_kinks(branches, pooled) as left, jax_takes_views(views) as left_views:
        jtask_grad = jax.jit(task_grad, static_argnames=("task",))
        for i, task in enumerate(main):
            losses[task], per_domain[task], s, grads[task] = jtask_grad(
                params, s, task, jb, keys[i], step)
        if "domain_adv" in tasks:
            da_loss, per_domain["domain_adv"], s, da_grads = jtask_grad(
                params, s, "domain_adv", jb, keys[len(main)], step)
        assert left == ([], []) and not left_views     # every kink and view was taken
    new_params, opt_state, _, metrics = jax.jit(update_core)(
        params, joptimizer.init(params), jnp.int32(0), losses, grads, da_grads, keys[-1])
    metrics = assemble_metrics(metrics, per_domain, losses, da_loss, step)
    jax_task_grads = dict(grads, **({"domain_adv": da_grads} if da_grads else {}))

    case.update(
        jax_metrics={k: float(v) for k, v in metrics.items()},
        port_metrics={k: float(v) for k, v in out.items()},
        jax_task_grads={task: flat(g) for task, g in jax_task_grads.items()},
        port_task_grads={task: flat(state_dict_to_variables(
            dict(zip(names, g)))["params"]) for task, g in train_step.last_task_grads.items()},
        jax_grads={k: v / 0.1 for group in ("default", *tasks)
                   for k, v in flat(opt_state.inner_states[group].inner_state[0].mu).items()},
        port_grads=flat(state_dict_to_variables(
            {n: p.grad for n, p in model.named_parameters()})["params"]),
        jax_stats=flat(jax.device_get(s)), port_stats=flat(model_variables(model)["batch_stats"]),
        jax_params=flat(jax.device_get(new_params)),
        port_params=flat(model_variables(model)["params"]),
        lrs=lrs, labels=flat(jax_opt.param_labels(params, tasks)), state=state)
    return case


@pytest.fixture(scope="module")
def case(processed_dir, small):
    return run_case(processed_dir, "s2")


@pytest.fixture(scope="module", params=["s5", "b4"])
def multi_case(request, processed_dir, small):
    return run_case(processed_dir, request.param)


def check_losses_and_metric_keys(case):
    jm, pm = case["jax_metrics"], case["port_metrics"]
    assert pm.keys() == jm.keys()
    for k, want in jm.items():
        if k.startswith("gradient_surgery/"):
            continue
        np.testing.assert_allclose(pm[k], want, rtol=1e-4, err_msg=k)
    flipped = sum(len(v) for v in flipped_conflicts(case).values())
    assert abs(pm["gradient_surgery/total_projections"]
               - jm["gradient_surgery/total_projections"]) <= flipped
    assert case["state"].opt_step == case["step"] + 1 and case["state"].balancer_step == 1


def check_per_task_gradients(case):
    for task, want in case["jax_task_grads"].items():
        got = case["port_task_grads"][task]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, err_msg=f"{task} {k}", **GRAD_TOL)
        # The other tasks' heads get zeros, not nothing; the mask token too,
        # but for node-feature masking.
        other = [k for k in got if "heads_" in k and task not in k]
        if task != "node_feat_mask":
            other.append("['mask_token']")
        assert other and all(not got[k].any() for k in other)
    if "domain_adv" in case["tasks"]:       # λ > 0: the reversal reaches the backbone
        assert any(v.any() for k, v in case["port_task_grads"]["domain_adv"].items()
                   if k.startswith("['gnn_backbone']"))


def flipped_conflicts(case):
    """Leaves where one of PCGrad's conflict decisions came out otherwise on
    the two sides -> per such decision (the JAX dot product, the bound on its
    error that the per-task gradients' differences imply). A decision is the
    sign of <g_i, g_j> for the (already projected) i-th task in the permuted
    order and every earlier j; each side goes on with its own decision."""
    out = {}
    jax_g, port_g = case["jax_task_grads"], case["port_task_grads"]
    order = [sorted(case["main"])[i] for i in case["perm"]]
    for k in jax_g[order[0]]:
        ja = [jax_g[t][k].astype(np.float64) for t in order]
        pa = [port_g[t][k].astype(np.float64) for t in order]
        jm, pm = list(ja), list(pa)
        for i in range(len(order)):
            for j in range(i):
                dot, port_dot = float(np.sum(jm[i] * ja[j])), float(np.sum(pm[i] * pa[j]))
                if (dot < 0) != (port_dot < 0):
                    out.setdefault(k, []).append(
                        (dot, float(np.sum(np.abs(jm[i] - pm[i]) * np.abs(ja[j]))
                                    + np.sum(np.abs(pm[i]) * np.abs(ja[j] - pa[j])))))
                if dot < 0:
                    jm[i] = jm[i] - dot / np.sum(ja[j] ** 2) * ja[j]
                if port_dot < 0:
                    pm[i] = pm[i] - port_dot / np.sum(pa[j] ** 2) * pa[j]
    return out


def check_combined_gradients(case):
    got, want = case["port_grads"], case["jax_grads"]
    assert got.keys() == want.keys()
    flipped = flipped_conflicts(case)
    for k, decisions in flipped.items():
        for dot, bound in decisions:
            assert abs(dot) <= bound, (k, dot, bound)
    # At most a tenth of the decisions: one per leaf and task pair.
    pairs = len(case["main"]) * (len(case["main"]) - 1) // 2
    assert sum(len(v) for v in flipped.values()) <= 0.1 * len(want) * pairs
    for k, w in want.items():
        if k not in flipped:
            np.testing.assert_allclose(got[k], w, err_msg=k, **GRAD_TOL)
    assert abs(case["port_metrics"]["gradient_surgery/total_conflicts"]
               - case["jax_metrics"]["gradient_surgery/total_conflicts"]) <= sum(
                   len(v) for v in flipped.values())


def check_batch_norm_statistics(case):
    assert case["port_stats"].keys() == case["jax_stats"].keys()
    for k, want in case["jax_stats"].items():
        np.testing.assert_allclose(case["port_stats"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)
        assert not np.allclose(want, case["start_stats"][k]), k


def check_parameters(case):
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
    if "node_feat_mask" not in case["tasks"]:
        np.testing.assert_allclose(case["port_params"]["['mask_token']"],
                                   case["start"]["['mask_token']"] * (1 - 1e-5 * 1e-5),
                                   rtol=1e-7)


def check_evaluation(case):
    want, got = case["jax_eval"], case["port_eval"]
    assert got.keys() == want.keys()
    assert got["balancer_step"] == want["balancer_step"]
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
    assert ("val/domain_adv/loss" in got) == ("domain_adv" in case["tasks"])


def test_losses_and_metric_keys_of_one_train_step(case):
    check_losses_and_metric_keys(case)
    assert case["port_metrics"]["gradient_surgery/total_projections"] == \
        case["jax_metrics"]["gradient_surgery/total_projections"]


def test_per_task_gradients_of_one_train_step(case):
    check_per_task_gradients(case)


def test_combined_gradients_after_pcgrad_and_clipping(case):
    """Strict on every leaf where both sides took PCGrad's conflict decision
    alike. A decision is the sign of a per-leaf dot product of two tasks'
    gradients; where that dot product lies within the error the per-task
    gradients' own differences allow (a bias in front of a BatchNorm, whose
    gradient is rounding noise), the sides may decide otherwise, and that
    leaf then differs by PCGrad's projection."""
    check_combined_gradients(case)


def test_batch_norm_statistics_after_one_train_step(case):
    check_batch_norm_statistics(case)


def test_parameters_after_one_train_step(case):
    """Where the gradient is clear (|g| > 1e-4, on a leaf whose PCGrad
    decisions both sides took alike) the two AdamW updates agree within
    0.05 lr in all but 0.5% of a leaf's elements; everywhere within 2 lr (a
    rounding-noise gradient's sign decides an element's direction).
    The mask token, which no task of s2 reaches, is only decayed."""
    check_parameters(case)


def test_eval_call_matches_jax(case):
    check_evaluation(case)


def test_multi_task_losses_and_metric_keys(multi_case):
    check_losses_and_metric_keys(multi_case)


def test_multi_task_per_task_gradients(multi_case):
    check_per_task_gradients(multi_case)


def test_multi_task_combined_gradients_after_pcgrad_da_and_clipping(multi_case):
    """PCGrad over the main tasks, then the domain-adversarial gradient
    added, then the clip: a DA gradient sent through PCGrad or clipped on
    its own would part from JAX here."""
    check_combined_gradients(multi_case)


def test_multi_task_batch_norm_statistics(multi_case):
    check_batch_norm_statistics(multi_case)


def test_multi_task_parameters_after_adamw(multi_case):
    check_parameters(multi_case)


def test_multi_task_evaluation_matches_jax(multi_case):
    check_evaluation(multi_case)
