"""The port's edge- and node-partitioned fine-tune steps on two gloo ranks
against the JAX package's single-device ``coo`` steps, on the CPU.

One random graph (96 nodes, 400 edges of which 23 masked, 40 features) and
a Cora_NC- and a Cora_LP-shaped model at 2 GIN layers, dropout on (rate
0.2), BatchNorm statistics and ε moved off their init values. The JAX side
runs ``make_nc_steps`` / ``make_lp_steps`` (jitted) from one key; its
dropout keep-masks are read from the same forwards with
``capture_intermediates`` (keep = output ≠ 0) and its miner's Gumbel draw is
``gumbel(split(key, 3)[1])``. The ranks (``tests/torch_dp_helpers.py``
``partition_steps``, started once for the module) take those: the
edge-partitioned ranks all of them, the node-partitioned ranks their rows
of the encoder's and the backbone's and all of the link predictor's. For
each of NC and LP, edge and node: the eval step on the starting weights,
one train step, then a second on the ranks' own draws. The first train
step takes the JAX forwards' ReLU branches too (``utils/relu_branches``,
read from the same captured forwards): a pre-activation within rounding of
0 falls on either side of the kink otherwise, and every gradient below it
moves. The starting weights are a port model's, carried into the JAX tree
by ``utils.convert``.

Tolerances (the JAX package's, ``tests/test_node_parallel.py``): eval loss
rtol 1e-5 / atol 1e-5, probabilities rtol 1e-4 / atol 1e-5, predictions
equal; train loss rtol 1e-5 / atol 1e-6; new BatchNorm statistics rtol 1e-4
/ atol 1e-6; gradients within 1e-5 of the JAX gradients' norm, and each
element within rtol 1e-4 / atol 1e-5 (the port's dense step parity,
``tests/test_torch_finetune_steps.py``: a bias in front of a BatchNorm, and
ε, whose gradient sums terms that cancel, carry ~1e-8 of rounding noise on
either side). The parameters after AdamW
as in ``tests/test_torch_finetune_steps.py``: within 2 lr of JAX's
everywhere (the first step moves an element by ±lr whatever its
gradient's size) and within 0.05 lr in all but 0.5% of the elements whose
gradient is clear of the noise. After the second step the ranks' states are
equal bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data.batch import GraphBatch as JaxGraphBatch
from gnn_pretraining_tpu.finetune import finetune as jax_ft
from gnn_pretraining_tpu.finetune import mining as jax_mining
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.ops.spmm import build_dense_adjacency as jax_adjacency
from gnn_pretraining_tpu_torch import FinetuneGNN, config
from gnn_pretraining_tpu_torch.utils.convert import (
    model_variables,
    state_dict_to_variables,
    variables_to_state_dict,
)
from test_torch_finetune_steps import adam_first_moment_grads, flat, perturb, relu_branches_of
from torch_dp_helpers import run_ranks

torch.set_num_threads(1)

LAYERS = 2
N, E, D, MASKED = 96, 400, 40, 23
LP_BATCH, LP_NUM_HARD = 16, 6             # 10 of 16 negatives from the Gumbel draw
CASES = [("nc", "edge"), ("nc", "node"), ("lp", "edge"), ("lp", "node")]
IDS = [f"{t}-{m}" for t, m in CASES]
DOMAINS = {"nc": "Cora_NC", "lp": "Cora_LP"}


def graph_arrays():
    rng = np.random.default_rng(0)
    edge_mask = np.ones(E, np.float32)
    edge_mask[rng.choice(E, MASKED, replace=False)] = 0.0
    return {"x": rng.normal(size=(N, D)).astype(np.float32),
            "senders": rng.integers(0, N, E).astype(np.int32),
            "receivers": rng.integers(0, N, E).astype(np.int32),
            "edge_mask": edge_mask, "node_mask": np.ones(N, np.float32)}


def jax_graph(g):
    return JaxGraphBatch(
        x=g["x"], senders=g["senders"], receivers=g["receivers"], edge_mask=g["edge_mask"],
        edge_graph=np.zeros(E, np.int32), node_mask=g["node_mask"],
        node_graph=np.zeros(N, np.int32), graph_mask=np.ones(1, np.float32),
        node_start=np.zeros(1, np.int32), n_node=np.full(1, N, np.int32),
        n_edge=np.full(1, E, np.int32), y=np.zeros(1, np.int32),
        graph_properties=np.zeros((1, 12), np.float32))


def keeps(intermediates, head: bool):
    """The keep-masks of one train-mode forward, in call order."""
    got = intermediates
    out = [got["input_encoder"]["Dropout_0"]]
    out += [got["gnn_backbone"][f"layers_{i}"]["Dropout_0"] for i in range(LAYERS)]
    if head:
        out.append(got["classification_head"]["predictor"]["Dropout_0"])
    return [torch.from_numpy(np.asarray(d["__call__"][0]) != 0).float() for d in out]


def branches(intermediates, task):
    """``x > 0`` at every ReLU of one captured JAX forward, in call order."""
    return [torch.from_numpy(b) for b in relu_branches_of(intermediates, task)]


def jax_case(task, g, key):
    """JAX's eval step and first train step, and what the ranks take."""
    domain = DOMAINS[task]
    jg = jax_graph(g)
    jcfg = jax_config.FinetuneConfig(domain, "full_finetune", "b1", 0)
    jmodel = JaxFinetuneGNN(domain_name=domain, aggregation="coo")
    edges = dict(senders=jnp.asarray(g["senders"]), receivers=jnp.asarray(g["receivers"]),
                 edge_mask=jnp.asarray(g["edge_mask"]))
    # The starting weights: a port model's (the JAX init, op by op, takes
    # seconds), carried into the JAX tree by utils.convert.
    variables = model_variables(FinetuneGNN(domain, "coo", device="cpu",
                                            generator=torch.Generator().manual_seed(0)))
    variables = perturb(variables, 4)
    optimizer, labels, lrs = jax_ft.create_finetune_optimizer(variables["params"], jcfg)
    state = jax_ft.FTState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=optimizer.init(variables["params"]))
    adj = jax_adjacency(edges["senders"], edges["receivers"], edges["edge_mask"], N)
    rng = np.random.default_rng(7)
    spec = {"domain": domain, "state_dict": variables_to_state_dict(variables),
            "lrs": lrs, "labels": {k: str(v) for k, v in flat(labels).items()},
            "start": flat(variables["params"])}
    x, nm = jnp.asarray(g["x"]), jnp.asarray(g["node_mask"])

    def captured(stats, rngs_key, **kw):
        _, mut = jmodel.apply({"params": state.params, "batch_stats": stats}, x, nm, True,
                              capture_intermediates=True,
                              mutable=["batch_stats", "intermediates"],
                              rngs={"dropout": rngs_key}, **edges, **kw)
        return mut

    if task == "nc":
        train, evaluate = jax_ft.make_nc_steps(jmodel, jcfg, optimizer, labels, jg, adj)
        ix = np.arange(0, N, 2, dtype=np.int32)
        y = rng.integers(0, 7, len(ix)).astype(np.int32)
        vix = np.arange(1, N, 3, dtype=np.int32)
        vy = rng.integers(0, 7, len(vix)).astype(np.int32)
        got = captured(state.batch_stats, key)["intermediates"]
        spec["trunk_masks"] = keeps(got, False)
        spec["branches"] = branches(got, "node_classification")
        spec["head_masks"] = []
        jtrain_args, jeval_args = (ix, y, key), (vix, vy)
        spec["train_args"] = (torch.from_numpy(ix), torch.from_numpy(y))
        spec["eval_args"] = (torch.from_numpy(vix), torch.from_numpy(vy))
    else:
        train_edges = np.stack([g["senders"][:100], g["receivers"][:100]])
        forbidden = jax_mining.build_forbidden_mask(N, train_edges, node_mask=g["node_mask"])
        train, evaluate = jax_ft.make_lp_steps(jmodel, jcfg, optimizer, labels, jg, adj,
                                               forbidden, LP_NUM_HARD)
        pos = np.stack([g["senders"][100:100 + LP_BATCH], g["receivers"][100:100 + LP_BATCH]])
        m = np.ones(LP_BATCH, np.float32)
        m[-3:] = 0.0                                        # a ragged last batch
        k_emb, k_mine, k_drop = jax.random.split(key, 3)
        emb_mut = captured(state.batch_stats, k_emb, method=JaxFinetuneGNN.embed)
        emb = jmodel.apply({"params": state.params, "batch_stats": state.batch_stats}, x, nm,
                           True, mutable=["batch_stats"], rngs={"dropout": k_emb},
                           method=JaxFinetuneGNN.embed, **edges)[0]
        neg_s, neg_r = jax_mining.mine_hard_negatives(emb, forbidden, k_mine,
                                                      num_negatives=LP_BATCH,
                                                      num_hard=LP_NUM_HARD)
        scored = captured(emb_mut["batch_stats"], k_drop,
                          score_senders=jnp.concatenate([pos[0], neg_s]),
                          score_receivers=jnp.concatenate([pos[1], neg_r]),
                          return_logits=True)
        trunk = keeps(scored["intermediates"], True)
        spec["trunk_masks"] = keeps(emb_mut["intermediates"], False) + trunk[:-1]
        spec["head_masks"] = trunk[-1:]
        spec["branches"] = (branches(emb_mut["intermediates"], "node_classification")
                            + branches(scored["intermediates"], "link_prediction"))
        spec["gumbel"] = torch.from_numpy(np.array(jax.random.gumbel(k_mine, (N * N,))))
        spec.update(train_edges=train_edges, num_hard=LP_NUM_HARD)
        vedges = np.stack([g["senders"][200:220], g["receivers"][200:220]])
        vy = (np.arange(20) % 2).astype(np.float32)
        vm = np.ones(20, np.float32)
        jtrain_args, jeval_args = (pos, m, key), (vedges, vy, vm)
        spec["train_args"] = (torch.from_numpy(pos), torch.from_numpy(m))
        spec["eval_args"] = tuple(torch.from_numpy(a) for a in (vedges, vy, vm))
    spec["jax_eval"] = [np.asarray(a) for a in evaluate(state, *jeval_args)]
    state1, *out = train(jax.tree.map(jnp.array, state), *jtrain_args)
    spec["jax_train"] = [np.asarray(a) for a in out]
    spec["jax_grads"] = adam_first_moment_grads(state1.opt_state, lrs)
    spec["jax_stats"] = flat(jax.device_get(state1.batch_stats))
    spec["jax_params"] = flat(jax.device_get(state1.params))
    return spec


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config, "DROPOUT_RATE", 0.2)
        mp.setattr(jax_config, "GNN_NUM_LAYERS", LAYERS)
        mp.setattr(config, "GNN_NUM_LAYERS", LAYERS)
        for domain in DOMAINS.values():
            mp.setitem(config.DOMAIN_DIMENSIONS, domain, D)
        g = graph_arrays()
        key = jax.random.PRNGKey(5)
        specs = {task: jax_case(task, g, key) for task in ("nc", "lp")}
    inputs = {"graph": g, "cases": CASES,
              "config": {"DROPOUT_RATE": 0.2, "GNN_NUM_LAYERS": LAYERS,
                         "DOMAIN_DIMENSIONS": {d: D for d in DOMAINS.values()}},
              **{task: {k: v for k, v in s.items() if not k.startswith("jax_")}
                 for task, s in specs.items()}}
    ranks = run_ranks(tmp_path_factory.mktemp("partition_steps"), "partition_steps", inputs)
    return specs, ranks


def tree_of(state: dict, collection: str) -> dict:
    return flat(state_dict_to_variables(state)[collection])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_eval_step_equals_jax(run, case):
    specs, ranks = run
    jloss, jy, jpreds, jprobs = specs[case[0]]["jax_eval"]
    for out in ranks:
        loss, y, preds, probs = (a.numpy() for a in out["-".join(case)]["eval"])
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(preds, jpreds)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_train_step_equals_jax(run, case):
    spec = run[0][case[0]]
    jloss, jy, jpreds, jprobs, *jrest = spec["jax_train"]
    for out in run[1]:
        got = out["-".join(case)]
        loss, y, preds, probs, *rest = (a.numpy() for a in got["train"])
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-5)
        top2 = np.sort(jprobs, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-4
        np.testing.assert_array_equal(preds[clear], jpreds[clear])
        if case[0] == "lp":
            np.testing.assert_array_equal(rest[0], jrest[0])       # the doubled mask
        np.testing.assert_allclose(rest[-1], jrest[-1], rtol=1e-4)  # the grad norm
        # The JAX forward's ReLU branches, forced on the rank (its rows); the
        # rank's own sign said otherwise at no more than one unit in 10^4.
        assert got["relu_flips"] <= 1e-4 * sum(b.numel() for b in spec["branches"])

        for k, want in spec["jax_stats"].items():
            np.testing.assert_allclose(tree_of(got["after_one"], "batch_stats")[k], want,
                                       rtol=1e-4, atol=1e-6, err_msg=k)

        grads = flat(state_dict_to_variables(got["grads"])["params"])
        want = spec["jax_grads"]
        assert grads.keys() == want.keys()
        norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want.values()))
        diff = np.sqrt(sum(float(np.sum((grads[k] - v).astype(np.float64) ** 2))
                           for k, v in want.items()))
        assert diff / norm < 1e-5, diff / norm
        for k, v in want.items():
            np.testing.assert_allclose(grads[k], v, rtol=1e-4, atol=1e-5, err_msg=k)

        params = tree_of(got["after_one"], "params")
        for k, want_p in spec["jax_params"].items():
            lr = spec["lrs"][spec["labels"][k]]
            diff = np.abs(params[k] - want_p)
            assert diff.max() <= 2 * lr * 1.01 + 1e-7, (k, diff.max() / lr)
            clear = np.abs(spec["jax_grads"][k]) > 1e-4
            if clear.any():
                assert np.mean(diff[clear] > 0.05 * lr) <= 0.005, k


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ranks_bitwise_equal_after_two_steps(run, case):
    specs, ranks = run
    first, *rest = [out["-".join(case)] for out in ranks]
    for other in rest:
        for key in ("after_one", "after_two"):
            assert first[key].keys() == other[key].keys()
            for k, v in first[key].items():
                assert torch.equal(v, other[key][k]), (key, k)
    moved = [k for k, v in first["after_two"].items()
             if not torch.equal(v, first["after_one"][k])]
    assert moved                                         # the second step moved them
