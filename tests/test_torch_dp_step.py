"""The port's data-parallel steps on two gloo ranks against the JAX package's
single-device steps on the union of the ranks' graphs, on the CPU (the
counterpart of ``tests/test_sharding.py::TestDataParallelTasks``, held
against JAX's single-device semantics).

Pretraining, scheme s5 (all six tasks) at the full width of 256, cut to 2
GIN layers and two domains (MUTAG, ENZYMES: 16 graphs each per step), a
step past 40% of the run (λ > 0): each rank takes its share of the balanced
sampler's draw (``parallel.data_parallel.shard_sampler_step``) and runs
``make_dp_train_step``; the JAX step (``_make_step_parts``: each task's
``task_grad``, then ``update_core``) runs on one batch of the same graphs,
rank 0's first. The views are drawn by the port on that union batch, and
the masking scores and negative-sampling uniforms rebuilt from the JAX
tasks' keys on it; each rank gets its rows of them. The JAX PCGrad order is
injected. Each rank's side of every ReLU kink and the winners of every max
pool are recorded and forced on the JAX step, row for row. Held:

  * each of the six tasks' loss, per-domain losses and gradient (averaged
    over the ranks, as ``make_dp_train_step`` keeps it) against JAX's
    ``compute_task_loss`` gradient;
  * the step's metrics, the combined gradient after PCGrad, the DA gradient
    and the clip, the BatchNorm statistics and the parameters after AdamW;
  * after a second step on the ranks' own draws, the two ranks' parameters
    and BatchNorm statistics are equal bit for bit.

Fine-tuning: one ENZYMES ``full_finetune`` graph-classification batch of 16
graphs dealt over the ranks (``build_sharded_gc_batches``) through the
data-parallel train and eval steps (``make_gc_steps_data_parallel``, a
``coo`` model with SyncBN) against JAX ``make_gc_steps`` on the whole batch.

Resume: ``pretrain(data_parallel=True, resume=True)`` (b4 on the ENZYMES
store) for 1 epoch; its file restored on each rank gives every rank the
same weights, BatchNorm statistics, AdamW state and counters and the rank
its own random streams; a 2-epoch run then carries on from it.

Tolerances: ``tests/test_sharding.py``'s (losses rtol 1e-4, gradients rtol
2e-3 / atol 2e-5); BatchNorm statistics rtol 1e-4; parameters after AdamW
relative to the learning rate, as ``test_torch_pretrain_step.py`` holds them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data import batch as jax_batch
from gnn_pretraining_tpu.finetune import finetune as jax_ft
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.models.pretrain_model import PretrainableGNN as JaxPretrainableGNN
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import batch as port_batch
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.synthetic import synthetic_pretrain_store
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.finetune.gc_data_parallel import build_sharded_gc_batches
from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.ops.sampling import NegativeDraws
from gnn_pretraining_tpu_torch.parallel import data_parallel as dp
from gnn_pretraining_tpu_torch.pretrain import optimizers
from gnn_pretraining_tpu_torch.pretrain.augmentations import GraphView
from gnn_pretraining_tpu_torch.utils.convert import state_dict_to_variables, variables_to_state_dict
from test_torch_pretrain_step import (
    check_batch_norm_statistics,
    check_parameters,
    draw_views,
    flat,
    flipped_conflicts,
    forced_kinks,
    jax_mask_scores,
    jax_negatives,
    jax_takes_views,
    perturb,
)
from torch_dp_helpers import RANKS, run_ranks

torch.set_num_threads(1)

SCHEME = "s5"
DOMAINS = ("MUTAG", "ENZYMES")
LAYERS = 2
TOTAL_STEPS, STEP = 10, 7
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
GC_BATCH = 16


@pytest.fixture(scope="module", autouse=True)
def small():
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "DROPOUT_RATE", 0.0)
            mp.setattr(c, "DOMAIN_CLASSIFIER_DROPOUT_RATE", 0.0)
            mp.setattr(c, "GNN_NUM_LAYERS", LAYERS)
            mp.setitem(c.PRETRAIN_DOMAINS, SCHEME, DOMAINS)
        yield


def shares_of_steps(stores, steps):
    """Per step: each rank's share (``{domain: GraphBatch}``) and its graph
    indices, from one sampler state copied to every rank."""
    samplers = [loaders.create_pretrain_train_loader(DOMAINS, np.random.default_rng(1), stores)
                for _ in range(RANKS)]
    pads = dp.dp_pads(samplers[0], RANKS)
    picked = []
    real_build = dp.build_batch
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dp, "build_batch", lambda store, ix, *a, **k: (
            picked.append(np.asarray(ix)), real_build(store, ix, *a, **k))[1])
        for _ in range(steps):
            step = []
            for r, sampler in enumerate(samplers):
                picked.clear()
                batches = dp.shard_sampler_step(sampler, RANKS, r, pads)
                step.append((batches, dict(zip(sampler.domain_stores, picked))))
            out.append(step)
    return out


class Layout:
    """Where the real rows of each rank's batch sit in the union batch (rank
    0's graphs first): node, edge and graph rows."""

    def __init__(self, rank_batches):
        self.nodes, self.edges, self.pads = [], [], []
        n_off = e_off = 0
        for b in rank_batches:
            n, e = int(b.node_mask.sum()), int(b.edge_mask.sum())
            self.nodes.append(n_off + np.arange(n))
            self.edges.append(e_off + np.arange(e))
            self.pads.append((b.num_nodes, b.num_edges, b.num_graphs))
            n_off, e_off = n_off + n, e_off + e
        self.union = (port_batch.round_up(n_off), port_batch.round_up(e_off))

    def to_rank(self, a, kind, r, axis=0):
        """Rank r's rows of the union rows ``a`` (its padding rows 0)."""
        a = torch.as_tensor(np.asarray(a))
        rows = {"node": self.nodes, "edge": self.edges}[kind][r]
        size = self.pads[r][0 if kind == "node" else 1]
        out = torch.zeros(a.shape[:axis] + (size,) + a.shape[axis + 1:], dtype=a.dtype)
        index = [slice(None)] * a.dim()
        index[axis] = slice(0, len(rows))
        out[tuple(index)] = a.index_select(axis, torch.as_tensor(rows))
        return out

    def to_union(self, arrays, kind):
        """The union rows of the ranks' ``arrays`` (node, pair = [positive
        edges; negatives], graph); the union's padding rows False."""
        if kind == "graph":
            return np.concatenate([np.asarray(a) for a in arrays])
        n_u, e_u = self.union
        size = n_u if kind == "node" else 2 * e_u
        out = np.zeros((size,) + tuple(arrays[0].shape[1:]), bool)
        for r, a in enumerate(arrays):
            a = np.asarray(a)
            if kind == "node":
                out[self.nodes[r]] = a[:len(self.nodes[r])]
            else:
                e_r, rows = self.pads[r][1], self.edges[r]
                out[rows] = a[:len(rows)]
                out[e_u + rows] = a[e_r:e_r + len(rows)]
        return out


def union_batches(stores, shares, layouts, pkg):
    out = {}
    for d in DOMAINS:
        store = pkg.GraphStore.load(stores / f"{d}.npz")
        ix = np.concatenate([picked[d] for _, picked in shares])
        out[d] = pkg.build_batch(store, ix, *layouts[d].union, len(ix), with_properties=True)
    return out


def map_branches(rank_arrays, layouts, kind_of):
    """Each recorded call's union branches from the ranks' (same shapes on
    every rank: the ranks share their pads)."""
    out = []
    for arrays in zip(*rank_arrays):
        domain, kind = kind_of[arrays[0].shape[0]]
        out.append(layouts[domain].to_union(arrays, kind) if domain else
                   np.concatenate([np.asarray(a) for a in arrays]))
    return out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    stores = tmp / "stores"
    stores.mkdir()
    rng = np.random.default_rng(0)
    for domain in DOMAINS:
        synthetic_pretrain_store(domain, rng, num_graphs=30).save(stores / f"{domain}.npz")
    cfg = config.PretrainConfig(SCHEME, 0)
    tasks = cfg.active_tasks
    main = [t for t in tasks if t != "domain_adv"]
    first, second = shares_of_steps(stores, 2)
    layouts = {d: Layout([batches[d] for batches, _ in first]) for d in DOMAINS}
    ub = union_batches(stores, first, layouts, port_batch)
    jb = union_batches(stores, first, layouts, jax_batch)
    model = PretrainableGNN(DOMAINS, tasks, "dense", generator=torch.Generator().manual_seed(0),
                            device="cpu")
    variables = perturb(state_dict_to_variables(model.state_dict()), 4)
    params, stats = variables["params"], variables["batch_stats"]

    keys = jax.random.split(jax.random.PRNGKey(5), len(tasks) + 1)
    perm = np.array(jax.random.permutation(keys[-1], len(main)))
    views = draw_views(ub, torch.Generator().manual_seed(7), tasks)
    masks = jax_mask_scores(keys[tasks.index("node_feat_mask")], ub)
    negatives = jax_negatives(keys[tasks.index("link_pred")], ub)
    order = sorted(DOMAINS)          # the tasks' domain order (JAX jit sorts them)
    view_domains = [d for t in tasks if t in ("node_contrast", "graph_contrast") for d in order]

    def rank_views(r):
        out = []
        for (v1, v2, common), d in zip(views, view_domains):
            lay = layouts[d]
            v = lambda g: GraphView(lay.to_rank(g.x, "node", r),  # noqa: E731
                                    lay.to_rank(g.node_keep, "node", r),
                                    lay.to_rank(g.edge_keep, "edge", r))
            out.append((v(v1), v(v2), lay.to_rank(common, "node", r)))
        return out

    ranks_in = [{
        "batches": first[r][0], "second_batches": second[r][0], "views": rank_views(r),
        "mask_scores": [layouts[d].to_rank(m, "node", r) for m, d in zip(masks, order)],
        "negatives": [NegativeDraws(layouts[d].to_rank(n.u, "edge", r, axis=1),
                                    layouts[d].to_rank(n.v, "edge", r, axis=1),
                                    layouts[d].to_rank(n.fallback, "edge", r))
                      for n, d in zip(negatives, order)],
    } for r in range(RANKS)]

    # Fine-tuning: one batch of ENZYMES graphs dealt over the ranks.
    fcfg, jfcfg = (c.FinetuneConfig("ENZYMES", "full_finetune", "b1", 0)
                   for c in (config, jax_config))
    fmodel = FinetuneGNN("ENZYMES", "coo", generator=torch.Generator().manual_seed(1),
                         device="cpu")
    fvars = perturb(state_dict_to_variables(fmodel.state_dict()), 6)
    gc_store = port_batch.GraphStore.load(stores / "ENZYMES.npz")
    subs = build_sharded_gc_batches(gc_store, "train", GC_BATCH, RANKS)[0]
    ix = np.asarray(gc_store.splits["train"], np.int64)[:GC_BATCH]
    gc_ix = np.concatenate([ix[r::RANKS] for r in range(RANKS)])
    gc_layout = Layout(subs)
    jgc = jax_batch.build_batch(jax_batch.GraphStore.load(stores / "ENZYMES.npz"), gc_ix,
                                *gc_layout.union, GC_BATCH)

    ranks = run_ranks(tmp, "step", {
        "config": {"DROPOUT_RATE": 0.0, "DOMAIN_CLASSIFIER_DROPOUT_RATE": 0.0,
                   "GNN_NUM_LAYERS": LAYERS, "PRETRAIN_DOMAINS": {SCHEME: DOMAINS}},
        "scheme": SCHEME, "state_dict": variables_to_state_dict(variables),
        "total_steps": TOTAL_STEPS, "step": STEP, "perm": perm, "ranks": ranks_in,
        "gc": {"state_dict": variables_to_state_dict(fvars), "batches": subs},
        "resume": {"stores": str(stores), "root": str(tmp / "resume_root")}})

    # The JAX step on the union batch, taking the ranks' kinks row for row.
    kind_of = {}
    for d in DOMAINS:
        n_pad, e_pad, g_local = layouts[d].pads[0]
        kind_of.update({n_pad: (d, "node"), 2 * e_pad: (d, "pair")})
    assert len(kind_of) == 2 * len(DOMAINS) and g_local not in kind_of
    kind_of[g_local] = (None, "graph")
    branches = map_branches([out["branches"] for out in ranks], layouts, kind_of)
    pooled = map_branches([out["pooled"] for out in ranks], layouts, kind_of)
    jmodel = JaxPretrainableGNN(domain_names=DOMAINS, task_names=tasks, aggregation="dense")
    joptimizer = jax_opt.create_task_specific_optimizer(params, tasks)
    task_grad, update_core, assemble_metrics, _ = jax_pretrain._make_step_parts(
        jmodel, jax_config.PretrainConfig(SCHEME, 0), joptimizer, TOTAL_STEPS)
    step = jnp.int32(STEP)
    losses, per_domain, grads = {}, {}, {}
    s, da_loss, da_grads = stats, None, None
    with forced_kinks(branches, pooled) as left, jax_takes_views(views) as left_views:
        jtask_grad = jax.jit(task_grad, static_argnames=("task",))
        for i, task in enumerate(main):
            losses[task], per_domain[task], s, grads[task] = jtask_grad(
                params, s, task, jb, keys[i], step)
        da_loss, per_domain["domain_adv"], s, da_grads = jtask_grad(
            params, s, "domain_adv", jb, keys[len(main)], step)
        assert left == ([], []) and not left_views
    new_params, opt_state, _, metrics = jax.jit(update_core)(
        params, joptimizer.init(params), jnp.int32(0), losses, grads, da_grads, keys[-1])
    metrics = assemble_metrics(metrics, per_domain, losses, da_loss, step)

    names = [n for n, _ in model.named_parameters()]
    _, _, lrs = optimizers.create_task_specific_optimizer(model, tasks)
    port_flat = lambda sd: flat(state_dict_to_variables(sd)["params"])  # noqa: E731
    c = {"tasks": tasks, "main": main, "perm": perm, "start": flat(params),
         "start_stats": flat(stats), "ranks": ranks,
         "jax_metrics": {k: float(v) for k, v in metrics.items()},
         "port_metrics": ranks[0]["metrics"],
         "jax_task_grads": {t: flat(g) for t, g in dict(grads, domain_adv=da_grads).items()},
         "port_task_grads": {t: port_flat(dict(zip(names, g)))
                             for t, g in ranks[0]["task_grads"].items()},
         "jax_grads": {k: v / 0.1 for group in ("default", *tasks)
                       for k, v in flat(opt_state.inner_states[group].inner_state[0].mu).items()},
         "port_grads": port_flat(ranks[0]["grads"]),
         "jax_stats": flat(jax.device_get(s)),
         "port_stats": flat(state_dict_to_variables(ranks[0]["after_one"])["batch_stats"]),
         "jax_params": flat(jax.device_get(new_params)),
         "port_params": port_flat(ranks[0]["after_one"]),
         "lrs": lrs, "labels": flat(jax_opt.param_labels(params, tasks))}

    # The JAX fine-tune steps on the whole batch.
    jfmodel = JaxFinetuneGNN(domain_name="ENZYMES", aggregation="coo")
    jfopt, jflabels, flrs = jax_ft.create_finetune_optimizer(fvars["params"], jfcfg)
    fstate = jax_ft.FTState(params=fvars["params"], batch_stats=fvars["batch_stats"],
                            opt_state=jfopt.init(fvars["params"]))
    jtrain, jeval = jax_ft.make_gc_steps(jfmodel, jfcfg, jfopt, jflabels)
    n_pad, _, g_local = gc_layout.pads[0]
    gc_branches = map_branches([out["gc_branches"] for out in ranks], {"gc": gc_layout},
                               {n_pad: ("gc", "node"), g_local: (None, "graph")})
    with forced_kinks(gc_branches, []) as left:
        fstate, *jtrain_out = jtrain(fstate, jgc, jax.random.PRNGKey(0))
        assert left == ([], [])
    _, flabels, _ = ft.create_finetune_optimizer(fmodel, fcfg)
    c["gc"] = {
        "jax_train": [np.asarray(x) for x in jtrain_out],
        "jax_eval": [np.asarray(x) for x in jeval(fstate, jgc)],
        "jax_grads": {k: v / 0.1 for g in flrs
                      for k, v in flat(fstate.opt_state.inner_states[g].inner_state[0].mu).items()},
        "jax_params": flat(jax.device_get(fstate.params)),
        "jax_stats": flat(jax.device_get(fstate.batch_stats)),
        "start": flat(fvars["params"]), "lrs": flrs,
        "labels": {k: str(v) for k, v in flat(jflabels).items()},
        "graph_mask": np.asarray(jgc.graph_mask) > 0}
    return c


@pytest.mark.parametrize("task", config.ACTIVE_TASKS[SCHEME])
def test_task_loss_and_gradients_equal_the_single_device_tasks(case, task):
    jm, pm = case["jax_metrics"], case["port_metrics"]
    for k in [f"train/loss/{task}"] + [f"train/loss/{d}/{task}" for d in DOMAINS]:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=k)
    got, want = case["port_task_grads"][task], case["jax_task_grads"][task]
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=f"{task} {k}", **GRAD_TOL)
    assert any(v.any() for k, v in got.items() if k.startswith("['gnn_backbone']"))


def test_step_metrics(case):
    jm, pm = case["jax_metrics"], case["port_metrics"]
    assert pm.keys() == jm.keys()
    for k, want in jm.items():
        if not k.startswith("gradient_surgery/"):
            np.testing.assert_allclose(pm[k], want, rtol=1e-4, err_msg=k)
    flipped = sum(len(v) for v in flipped_conflicts(case).values())
    for k in ("total_conflicts", "total_projections"):
        k = f"gradient_surgery/{k}"
        assert abs(pm[k] - jm[k]) <= flipped, k


def test_combined_gradient_after_pcgrad_da_and_clipping(case):
    got, want = case["port_grads"], case["jax_grads"]
    assert got.keys() == want.keys()
    flipped = flipped_conflicts(case)
    for k, decisions in flipped.items():
        for dot, bound in decisions:
            assert abs(dot) <= bound, (k, dot, bound)
    for k, w in want.items():
        if k not in flipped:
            np.testing.assert_allclose(got[k], w, err_msg=k, **GRAD_TOL)


def test_batch_norm_statistics_after_the_step(case):
    check_batch_norm_statistics(case)


def test_parameters_after_adamw(case):
    check_parameters(case)


def test_ranks_stay_equal_bit_for_bit_after_two_steps(case):
    a, b = (out["after_two"] for out in case["ranks"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not all(torch.equal(a[k], case["ranks"][0]["after_one"][k]) for k in a)


def test_gc_train_step_equals_the_single_device_step(case):
    gc = case["gc"]
    jloss, jy, jpreds, jprobs, jgnorm = gc["jax_train"]
    for out in case["ranks"]:
        loss, y, preds, probs, gnorm = (x.numpy() for x in out["gc_train"])
        np.testing.assert_allclose(loss, jloss, rtol=1e-4)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(preds[gc["graph_mask"]], jpreds[gc["graph_mask"]])
        np.testing.assert_allclose(gnorm, jgnorm, rtol=1e-3)
    got = flat(state_dict_to_variables(case["ranks"][0]["gc_grads"])["params"])
    assert got.keys() == {k for k, g in gc["labels"].items() if g != "frozen"}
    for k, want in gc["jax_grads"].items():
        np.testing.assert_allclose(got[k], want, err_msg=k, **GRAD_TOL)


def test_gc_parameters_and_statistics_after_the_step(case):
    gc = case["gc"]
    after = [state_dict_to_variables(out["gc_after"]) for out in case["ranks"]]
    for k, want in gc["jax_params"].items():
        got = flat(after[0]["params"])[k]
        np.testing.assert_array_equal(got, flat(after[1]["params"])[k], err_msg=k)
        if gc["labels"][k] == "frozen":
            np.testing.assert_array_equal(got, gc["start"][k], err_msg=k)
        else:
            assert np.abs(got - want).max() <= 2 * gc["lrs"][gc["labels"][k]] * 1.01, k
    for k, want in gc["jax_stats"].items():
        np.testing.assert_allclose(flat(after[0]["batch_stats"])[k], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_gc_eval_step_equals_the_single_device_step(case):
    jloss, jy, jpreds, jprobs = case["gc"]["jax_eval"]
    for out in case["ranks"]:
        loss, y, preds, probs = (x.numpy() for x in out["gc_eval"])
        np.testing.assert_allclose(loss, jloss, rtol=2e-3)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(probs, jprobs, rtol=0, atol=2e-3)


def test_every_rank_restores_the_same_state_from_a_dp_resume_file(case):
    a, b = (out["restored"] for out in case["ranks"])
    assert a["counters"] == b["counters"] and a["counters"]["epoch"] == 1
    assert a["state"].keys() == b["state"].keys()
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])
    for name in ("sampler", "pcgrad"):                 # the same on every rank
        assert str(a["streams"][name]) == str(b["streams"][name]), name
    for name in ("views", "task_draws", "dropout"):    # each rank's own
        assert not np.array_equal(a["streams"][name], b["streams"][name]), name
    for out in case["ranks"]:
        assert [run["epochs"] for run in out["resume_runs"]] == [1, 2]
