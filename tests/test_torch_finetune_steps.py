"""The port's fine-tune train/eval steps against ``make_*_steps``, on the CPU.

For each task family (PTC_MR: binary graph classification; ENZYMES:
multiclass, encoder frozen; Cora_NC-shaped; CiteSeer_LP-shaped) and for the
``pallas`` (K1, ``split`` mode: the JAX kernel in interpret mode, the port's
plain versions) and ``dense`` aggregations, the same carried weights and the
same batches go through the JAX step and the port's step, twice, and then
through the (jitted) eval step. Stores are tiny and seeded (<= 9-node graphs, 60
and 40 nodes).

A pre-activation within rounding of 0 falls on either side of a ReLU's kink,
and then every gradient below that unit moves visibly. So the port is made to
take the JAX model's branches (``utils.relu_branches.replay``, read from the
JAX forward with ``capture_intermediates``), which lets every tolerance below
hold for every element of every leaf; the units where the port's own sign
said otherwise are counted and bounded.

Both sides build 3 GIN layers at the full width of 256 (``GNN_NUM_LAYERS``),
and dropout is set to rate 0 on both (the JAX modules read
``config.DROPOUT_RATE`` when they are traced, the port's when they are
built); the LP miner gets the JAX side's Gumbel draw of ``k_mine``. The JAX
gradients are read back from AdamW's first moment after step 1
(mu = (1 - b1) * g from zero, exact to an f32 rounding).

Tolerances: loss rtol 1e-4; gradients rtol 1e-3 / atol 1e-5 with ``pallas``
(bf16-split products summed in another order) and rtol 1e-4 / atol 1e-5 with
``dense`` (a bias in front of a BatchNorm has a gradient that is pure
rounding noise, ~1e-6); new BN running statistics rtol 1e-4; outputs rtol 1e-4 / atol 1e-5.
Parameters after two steps are held relative to their group's learning rate,
see ``test_parameters_after_two_steps``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.finetune import finetune as jax_ft
from gnn_pretraining_tpu.finetune import mining as jax_mining
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.ops.spmm import build_dense_adjacency as jax_adjacency
from gnn_pretraining_tpu_torch import FinetuneGNN, config
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.synthetic import (
    synthetic_graph_store,
    synthetic_planetoid_stores,
)
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.finetune import mining
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
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

FAMILIES = {"PTC_MR": 8, "ENZYMES": 8, "Cora_NC": -1, "CiteSeer_LP": 32}
LP_NUM_HARD = 10                       # of 32 negatives: 22 come from the Gumbel draw
GRAD_TOL = {"pallas": dict(rtol=1e-3, atol=1e-5), "dense": dict(rtol=1e-4, atol=1e-5)}


LAYERS = 3                             # GIN layers on both sides (5 at full size)


@pytest.fixture(scope="module", autouse=True)
def small_model_without_dropout():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config, "DROPOUT_RATE", 0.0)
        mp.setattr(config, "DROPOUT_RATE", 0.0)
        mp.setattr(jax_config, "GNN_NUM_LAYERS", LAYERS)
        mp.setattr(config, "GNN_NUM_LAYERS", LAYERS)
        yield


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny_stores")
    rng = np.random.default_rng(0)
    for domain in ("PTC_MR", "ENZYMES"):
        synthetic_graph_store(domain, rng, rng.integers(5, 10, 24)).save(tmp / f"{domain}.npz")
    for name, nodes, edges in (("Cora", 60, 110), ("CiteSeer", 40, 55)):
        for key, store in synthetic_planetoid_stores(name, rng, nodes, edges, 16, 10, 10).items():
            store.save(tmp / f"{key}.npz")
    return tmp


def perturb(variables, seed):
    """Move BN stats, BN affine params and GIN eps off their init values."""
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


def adam_first_moment_grads(opt_state, groups):
    """g = mu / (1 - b1) after the first AdamW step, per trainable leaf."""
    out = {}
    for group in groups:
        mu = opt_state.inner_states[group].inner_state[0].mu
        out.update({k: v / 0.1 for k, v in flat(mu).items()})
    return out


def jax_relu_branches(jmodel, variables, task, args, **kwargs):
    """``x > 0`` at every ReLU of one train-mode forward of the JAX model, in
    call order: the encoder's BN, each GIN layer's MLP BN and outer BN, the
    head's hidden layer (none in the node-classification head)."""
    _, mut = jmodel.apply(variables, *args, True, capture_intermediates=True,
                          mutable=["batch_stats", "intermediates"],
                          rngs={"dropout": jax.random.PRNGKey(0)}, **kwargs)
    return relu_branches_of(mut["intermediates"], task)


def relu_branches_of(got, task):
    on = lambda sub: np.asarray(sub["__call__"][0]) > 0  # noqa: E731
    branches = [on(got["input_encoder"]["batch_norm"])]
    for i in range(jax_config.GNN_NUM_LAYERS):
        layer = got["gnn_backbone"][f"layers_{i}"]
        branches += [on(layer["mlp_bn"]), on(layer["batch_norm"])]
    head = got.get("classification_head", {})
    if task == "graph_classification":
        branches.append(on(head["linear_0"]))
    elif task == "link_prediction":
        branches.append(on(head["predictor"]["linear_0"]))
    return branches


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def np_out(seq):
    return [np.asarray(x.detach() if torch.is_tensor(x) else x) for x in seq]


def run_case(domain, aggregation, processed_dir):
    bs = FAMILIES[domain]
    jcfg = jax_config.FinetuneConfig(domain, "full_finetune", "b1", 0)
    cfg = config.FinetuneConfig(domain, "full_finetune", "b1", 0)
    jdata = {s: jax_loaders.create_finetune_arrays(domain, s, bs, processed_dir)
             for s in ("train", "val")}
    data = {s: loaders.create_finetune_arrays(domain, s, bs, processed_dir)
            for s in ("train", "val")}

    jmodel, variables = jax_ft._init_finetune_model(jcfg, jdata, aggregation, 0)
    variables = perturb(variables, 4)
    joptimizer, jlabels, lrs = jax_ft.create_finetune_optimizer(variables["params"], jcfg)
    state = jax_ft.FTState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=joptimizer.init(variables["params"]))

    model = load_variables(FinetuneGNN(domain, aggregation, device="cpu"), variables)
    optimizer, labels, tlrs = ft.create_finetune_optimizer(model, cfg)
    assert tlrs == lrs
    key = jax.random.PRNGKey(5)
    task = cfg.task_type

    if task == "graph_classification":
        jtrain, jeval = jax_ft.make_gc_steps(jmodel, jcfg, joptimizer, jlabels)
        train, evaluate = ft.make_gc_steps(model, cfg, optimizer, labels)
        jsteps = [(b, key) for b in jdata["train"].batches[:2]]
        steps = [((b,), {}) for b in data["train"].batches[:2]]
        jdtype = jnp.bfloat16 if aggregation == "pallas" else jnp.float32

        def branches(state, b, _key):
            jadj = jax_adjacency(b.senders, b.receivers, b.edge_mask, b.num_nodes,
                                 dtype=jdtype)
            return jax_relu_branches(
                jmodel, {"params": state.params, "batch_stats": state.batch_stats},
                task, (b.x, b.node_mask), adj=jadj, senders=b.senders,
                receivers=b.receivers, edge_mask=b.edge_mask,
                node_graph=b.node_graph, num_graphs=b.num_graphs)
        jeval_args, eval_args = (jdata["val"].batches[0],), (data["val"].batches[0],)
    else:
        jg, g = jdata["train"].graph, data["train"].graph
        jdtype = jnp.bfloat16 if aggregation == "pallas" else jnp.float32
        dtype = torch.bfloat16 if aggregation == "pallas" else torch.float32
        jadj = jax_adjacency(jnp.asarray(jg.senders), jnp.asarray(jg.receivers),
                             jnp.asarray(jg.edge_mask), jg.num_nodes, dtype=jdtype)
        adj = build_dense_adjacency(g.senders, g.receivers, g.edge_mask, g.num_nodes,
                                    dtype=dtype)
        graph_kwargs = dict(adj=jadj, senders=jg.senders, receivers=jg.receivers,
                            edge_mask=jg.edge_mask)
        if task == "node_classification":
            jtrain, jeval = jax_ft.make_nc_steps(jmodel, jcfg, joptimizer, jlabels, jg, jadj)
            train, evaluate = ft.make_nc_steps(model, cfg, optimizer, labels, g, adj)
            ix, y = data["train"].node_indices[0], data["train"].labels[0]
            jsteps = [(jnp.asarray(ix), jnp.asarray(y), key)] * 2
            steps = [((t(ix), t(y)), {})] * 2
            vix, vy = data["val"].node_indices[0], data["val"].labels[0]
            jeval_args, eval_args = (jnp.asarray(vix), jnp.asarray(vy)), (t(vix), t(vy))

            def branches(state, *_step):
                return jax_relu_branches(
                    jmodel, {"params": state.params, "batch_stats": state.batch_stats},
                    task, (jg.x, jg.node_mask), **graph_kwargs)
        else:
            n = g.num_nodes
            train_edges = data["train"].train_edges
            jforb = jax_mining.build_forbidden_mask(n, train_edges, node_mask=jg.node_mask)
            forb = mining.build_forbidden_mask(n, train_edges, node_mask=g.node_mask.numpy())
            jtrain, jeval = jax_ft.make_lp_steps(jmodel, jcfg, joptimizer, jlabels, jg, jadj,
                                                 jforb, LP_NUM_HARD)
            train, evaluate = ft.make_lp_steps(model, cfg, optimizer, labels, g, adj,
                                               forb, LP_NUM_HARD)
            gumbel = t(np.asarray(jax.random.gumbel(jax.random.split(key, 3)[1], (n * n,))))
            d, v = data["train"], data["val"]
            jsteps = [(jnp.asarray(e), jnp.asarray(m), key)
                      for e, m in zip(d.edges[1:3], d.edge_mask[1:3])]
            # Step 1 mines inside the port's step, from the JAX side's Gumbel
            # draw. Step 2 starts from weights that differ by step 1's
            # tolerance, where the top-k may break a near-tie otherwise, so it
            # scores the pairs the JAX side mined (``mined``, filled by
            # ``branches`` before each step).
            mined = []
            steps = [((t(e), t(m)), kw) for (e, m), kw in zip(
                zip(d.edges[1:3], d.edge_mask[1:3]),
                ({"gumbel": gumbel}, {"negatives": mined}))]
            assert d.edge_mask[2].sum() < bs                 # a ragged-tail batch
            jeval_args = tuple(jnp.asarray(a) for a in (v.edges[0], v.labels[0], v.edge_mask[0]))
            eval_args = tuple(t(a) for a in (v.edges[0], v.labels[0], v.edge_mask[0]))

            def branches(state, pos, _mask, key):
                """The scored forward's branches, after the no-grad embedding
                pass (11 ReLU calls, left alone) has updated the BN stats and
                fed the miner, as in the JAX step."""
                emb, mut = jmodel.apply(
                    {"params": state.params, "batch_stats": state.batch_stats},
                    jg.x, jg.node_mask, True, mutable=["batch_stats"],
                    rngs={"dropout": key}, method=JaxFinetuneGNN.embed, **graph_kwargs)
                neg_s, neg_r = jax_mining.mine_hard_negatives(
                    emb, jforb, jax.random.split(key, 3)[1],
                    num_negatives=pos.shape[1], num_hard=LP_NUM_HARD)
                scored = jax_relu_branches(
                    jmodel, {"params": state.params, "batch_stats": mut["batch_stats"]},
                    task, (jg.x, jg.node_mask),
                    score_senders=jnp.concatenate([pos[0], neg_s]),
                    score_receivers=jnp.concatenate([pos[1], neg_r]),
                    return_logits=True, **graph_kwargs)
                mined.append((t(np.asarray(neg_s)), t(np.asarray(neg_r))))
                return [None] * (1 + 2 * jax_config.GNN_NUM_LAYERS) + scored

    case = {"lrs": lrs, "labels": {k: str(v) for k, v in flat(jlabels).items()}, "start": flat(variables["params"]),
            "task": task, "relu_flips": 0, "relu_units": 0}
    for i, (jargs, (args, kwargs)) in enumerate(zip(jsteps, steps)):
        # The port takes the side of every ReLU kink that the JAX model takes
        # from the same state (utils/relu_branches.py); the units where its own
        # sign said otherwise are counted. The JAX train step runs with jit
        # off, so that its forward is, operation for operation, the one the
        # branches were read from: a jitted step fuses otherwise, rounds
        # otherwise, and can itself land on the other side of a kink.
        taken = branches(state, *jargs)
        with jax.disable_jit():
            state, *jout = jtrain(state, *jargs)
        if "negatives" in kwargs:
            kwargs = {"negatives": kwargs["negatives"][-1]}
        with relu_branches.replay(model, taken) as flips:
            out = train(*args, **kwargs)
        case["relu_flips"] += sum(flips)
        case["relu_units"] += sum(b.size for b in taken if b is not None)
        if i == 0:
            case["jax_step"], case["port_step"] = np_out(jout), np_out(out)
            case["jax_grads"] = adam_first_moment_grads(state.opt_state, lrs)
            case["port_grads"] = flat(state_dict_to_variables(
                {name: p.grad for name, p in model.named_parameters()
                 if p.grad is not None})["params"])
            case["jax_stats"] = flat(jax.device_get(state.batch_stats))
            case["port_stats"] = flat(model_variables(model)["batch_stats"])
            case["start_stats"] = flat(variables["batch_stats"])
    case["jax_params"] = flat(jax.device_get(state.params))
    case["port_params"] = flat(model_variables(model)["params"])
    case["jax_eval"] = np_out(jeval(state, *jeval_args))
    case["port_eval"] = np_out(evaluate(*eval_args))
    case["port_training_flag_after_eval"] = model.training
    return case


_CASES = {}


def case_fixture(domains):
    """A ``case`` fixture over ``domains`` x (pallas, dense); each case is
    computed once per process and shared by the tests that read it."""

    @pytest.fixture(params=[(d, a) for d in domains for a in ("pallas", "dense")],
                    ids=lambda p: f"{p[0]}-{p[1]}")
    def case(request, processed_dir, small_model_without_dropout):
        if request.param not in _CASES:
            _CASES[request.param] = run_case(*request.param, processed_dir)
        return request.param, _CASES[request.param]

    return case


# Every family in one file, so that one process compiles the JAX package's
# operations once for all of them: in two processes the graph-classification
# families alone took 110 s against 58 s in one.
case = case_fixture(("Cora_NC", "CiteSeer_LP", "PTC_MR", "ENZYMES"))


def test_loss_gnorm_and_outputs_of_one_train_step(case):
    _, c = case
    jloss, jy, jpreds, jprobs, *jrest = c["jax_step"]
    loss, y, preds, probs, *rest = c["port_step"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(rest[-1], jrest[-1], rtol=1e-3)           # gnorm
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-5)
    # Predictions may differ only where the two top probabilities tie.
    top2 = np.sort(jprobs, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    np.testing.assert_array_equal(preds[clear], jpreds[clear])
    if c["task"] == "link_prediction":
        np.testing.assert_array_equal(rest[0], jrest[0])                 # the doubled mask
        assert y[:32].all() and not y[32:].any()


def test_gradients_of_one_train_step(case):
    (_, aggregation), c = case
    assert c["port_grads"].keys() == c["jax_grads"].keys()
    trainable = {k for k, g in c["labels"].items() if g != "frozen"}
    assert c["port_grads"].keys() == trainable
    for k, want in c["jax_grads"].items():
        np.testing.assert_allclose(c["port_grads"][k], want, err_msg=k,
                                   **GRAD_TOL[aggregation])
    # Both sides took the same side of every ReLU kink; the port would have
    # chosen otherwise at no more than one unit in 10^4.
    assert c["relu_flips"] <= 1e-4 * c["relu_units"], c["relu_flips"]


def test_batch_norm_statistics_after_one_train_step(case):
    (domain, _), c = case
    assert c["port_stats"].keys() == c["jax_stats"].keys()
    for k, want in c["jax_stats"].items():
        np.testing.assert_allclose(c["port_stats"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)
        # Frozen or not (ENZYMES' encoder), every BN moved in train mode.
        assert not np.allclose(want, c["start_stats"][k]), k


def test_parameters_after_two_steps(case):
    """AdamW moves an element by about lr per step whatever its gradient's
    size: where |g| is rounding noise (a bias in front of a BatchNorm, ~1e-8)
    the noise's sign decides the direction, so such an element may differ by up
    to 2 lr per step (4 lr here). After step 1 the two models therefore differ
    by ~lr in those elements, and not all of them are without effect (the
    encoder's weights for a word that few nodes have), so the second gradients
    agree less well than the first. Where the first gradient is well above the gradient tolerance
    (|g| > 1e-4) the two updates must agree within 0.05 lr in all but 0.5% of
    a leaf's elements. Frozen leaves stay exactly where they were."""
    _, c = case
    moved = 0
    for k, want in c["jax_params"].items():
        got, group = c["port_params"][k], c["labels"][k]
        if group == "frozen":
            np.testing.assert_array_equal(got, c["start"][k], err_msg=k)
            np.testing.assert_array_equal(want, c["start"][k], err_msg=k)
            continue
        lr = c["lrs"][group]
        diff = np.abs(got - want)
        assert diff.max() <= 4 * lr * 1.01 + 1e-7, (k, diff.max() / lr)
        clear = np.abs(c["jax_grads"][k]) > 1e-4
        if clear.any():
            assert np.mean(diff[clear] > 0.05 * lr) <= 0.005, (k, diff[clear].max() / lr)
            moved += int((np.abs(want - c["start"][k])[clear] > 0.5 * lr).sum())
    assert moved > 1000                                        # it trained


def test_eval_step_after_training(case):
    _, c = case
    jloss, jy, jpreds, jprobs = c["jax_eval"]
    loss, y, preds, probs = c["port_eval"]
    # Weights differ by the parameter tolerance above, so outputs agree to ~lr.
    np.testing.assert_allclose(loss, jloss, rtol=2e-3)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=2e-3)
    assert preds.shape == jpreds.shape
    assert c["port_training_flag_after_eval"] is False


def test_train_mode_forward_and_gradients_with_the_jax_dropout_draws(processed_dir):
    """Dropout on (rate 0.2) on both sides: the keep-masks that the JAX model's
    ``nn.Dropout`` modules drew go into the port through
    ``DropoutSource.inject`` (keep = output != 0; where a ReLU already gave 0
    the draw changes nothing), the ReLU branches through ``replay``. PTC_MR has
    every dropout site: the encoder's, one per GIN layer, the head's. Logits
    rtol 1e-4 / atol 1e-5, gradients and new BN statistics as in the dense
    step tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config, "DROPOUT_RATE", 0.2)
        mp.setattr(config, "DROPOUT_RATE", 0.2)
        jcfg = jax_config.FinetuneConfig("PTC_MR", "full_finetune", "b1", 0)
        jdata = {"train": jax_loaders.create_finetune_arrays("PTC_MR", "train", 8, processed_dir)}
        jb = jdata["train"].batches[0]
        b = loaders.create_finetune_arrays("PTC_MR", "train", 8, processed_dir).batches[0]
        jmodel, variables = jax_ft._init_finetune_model(jcfg, jdata, "dense", 0)
        variables = perturb(variables, 4)
        weights = np.random.default_rng(6).normal(size=(8, 2)).astype(np.float32)
        jadj = jax_adjacency(jb.senders, jb.receivers, jb.edge_mask, jb.num_nodes)

        def loss_fn(params):
            logits, mut = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jb.x, jb.node_mask, True, capture_intermediates=True,
                mutable=["batch_stats", "intermediates"],
                rngs={"dropout": jax.random.PRNGKey(7)}, adj=jadj, senders=jb.senders,
                receivers=jb.receivers, edge_mask=jb.edge_mask,
                node_graph=jb.node_graph, num_graphs=jb.num_graphs)
            return jnp.sum(logits * weights), (logits, mut)

        (_, (jlogits, mut)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        got = mut["intermediates"]
        dropped = [got["input_encoder"]["Dropout_0"]]
        dropped += [got["gnn_backbone"][f"layers_{i}"]["Dropout_0"]
                    for i in range(jax_config.GNN_NUM_LAYERS)]
        dropped.append(got["classification_head"]["Dropout_0"])
        keeps = [t(np.asarray(d["__call__"][0]) != 0) for d in dropped]
        assert all(0 < float(k.float().mean()) < 0.8 for k in keeps)     # ReLU zeros too

        model = load_variables(FinetuneGNN("PTC_MR", "dense", device="cpu"), variables)
        model.train()
        model.dropout.inject(keeps)
        adj = build_dense_adjacency(b.senders, b.receivers, b.edge_mask, b.num_nodes)
        with relu_branches.replay(model, relu_branches_of(got, "graph_classification")) as flips:
            logits = model(b.x, b.node_mask, adj=adj, senders=b.senders,
                           receivers=b.receivers, edge_mask=b.edge_mask,
                           node_graph=b.node_graph, num_graphs=b.num_graphs)
        (logits * t(weights)).sum().backward()
    assert not model.dropout.injected                      # every draw was taken
    assert sum(flips) <= 5
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-4, atol=1e-5)
    grads = flat(state_dict_to_variables(
        {name: p.grad for name, p in model.named_parameters()})["params"])
    for k, want in flat(jgrads).items():
        np.testing.assert_allclose(grads[k], want, err_msg=k, **GRAD_TOL["dense"])
    stats = flat(model_variables(model)["batch_stats"])
    for k, want in flat(jax.device_get(mut["batch_stats"])).items():
        np.testing.assert_allclose(stats[k], want, rtol=1e-4, atol=1e-6, err_msg=k)


def test_train_mode_dropout_is_seeded_and_lp_draws_twice(processed_dir):
    """With dropout on, a step repeats under the same seeds and changes under
    another; the LP step runs two train-mode forwards (two BN updates, two
    dropout draws per layer), the first under no_grad."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "DROPOUT_RATE", 0.2)
        cfg = config.FinetuneConfig("CiteSeer_LP", "full_finetune", "b1", 0)
        data = {"train": loaders.create_finetune_arrays("CiteSeer_LP", "train",
                                                        cfg.batch_size, processed_dir)}

        def one_step(seed):
            model = FinetuneGNN("CiteSeer_LP", "pallas", device="cpu",
                                generator=torch.Generator().manual_seed(0))
            model.seed_dropout(seed)
            optimizer, labels, _ = ft.create_finetune_optimizer(model, cfg)
            train, _, batches, _ = ft.build_steps(cfg, model, optimizer, labels, data, "cpu")
            draws = []
            real = model.dropout.keep_mask
            model.dropout.keep_mask = lambda x, rate: draws.append(x.requires_grad) or real(x, rate)
            _, args = next(iter(batches()))
            loss = train(*args)[0]
            bn = model.gnn_backbone.layers[0].batch_norm
            return float(loss), draws, bn.running_mean.clone()

        loss_a, draws, mean_a = one_step(1)
        loss_b, _, mean_b = one_step(1)
        loss_c, _, _ = one_step(2)
    assert loss_a == loss_b and torch.equal(mean_a, mean_b)
    assert loss_a != loss_c
    # encoder + every GIN layer + the predictor's hidden layer, twice minus the
    # predictor in the embedding pass: at 5 layers 6 draws without grad, 7 with.
    assert draws == [False] * (1 + LAYERS) + [True] * (2 + LAYERS)
