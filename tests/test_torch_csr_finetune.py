"""``aggregation="csr"`` through the port's fine-tuning against the JAX package.

On the scale-0.06 Cora stores of the JAX package's own setup (162 nodes, as
tests/test_csr_finetune.py builds them), on the CPU, where K3 runs its plain
version and the JAX kernel runs in interpret mode:

  * ``finetune.runners.csr_graph_aux`` equals the JAX ``_csr_graph_aux``
    (the RCM permutation, the permuted graph, the tiles);
  * ``FinetuneGNN`` eval logits on the permuted graph equal the JAX csr
    model's, and mapped back through ``inv`` the JAX coo model's, within
    2e-4 (tests/test_csr_finetune.py:59);
  * the first NC and LP train steps built by ``build_steps`` under ``csr``
    equal JAX ``runners._nc_fns`` / ``_lp_fns`` on the same permuted graph,
    in loss and in the gradient of every leaf, with the harness and
    tolerances of tests/test_torch_finetune_steps.py (3 GIN layers at full
    width, dropout 0, ReLU branches of the JAX model replayed, the JAX step
    with jit off, the JAX side's mined negatives handed to the port);
  * ``finetune(aggregation="csr", device="cpu")`` trains Cora_NC and
    Cora_LP to metrics in [0, 1], ends its summary with the JAX package's
    ``fidelity/*`` block for the same arguments, lands within 0.15 test
    accuracy of the coo run of the same cell (tests/test_csr_finetune.py:85),
    and refuses a graph-classification domain before any work.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data import loaders as jax_loaders
from gnn_pretraining_tpu.data import setup as jax_setup
from gnn_pretraining_tpu.finetune import finetune as jax_ft
from gnn_pretraining_tpu.finetune import mining as jax_mining
from gnn_pretraining_tpu.finetune import runners as jax_runners
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.utils.fidelity import fidelity_block as jax_fidelity_block
from gnn_pretraining_tpu_torch import FinetuneGNN, config
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.finetune.runners import csr_graph_aux
from gnn_pretraining_tpu_torch.utils import relu_branches
from gnn_pretraining_tpu_torch.utils.convert import (
    load_variables,
    model_variables,
    state_dict_to_variables,
)
from test_torch_finetune_steps import (
    GRAD_TOL,
    adam_first_moment_grads,
    flat,
    jax_relu_branches,
    perturb,
    t,
)

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

LAYERS = 3                             # GIN layers of the step cases (5 at full size)


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cora_006")
    jax_setup.main(processed_dir=tmp, raw_dir=tmp / "raw", synthetic_scale=0.06,
                   only=("Cora",))
    return tmp


@pytest.mark.parametrize("domain", ["Cora_NC", "Cora_LP"])
def test_csr_graph_aux_equals_jax(processed_dir, domain):
    jg = jax_loaders.create_finetune_arrays(domain, "train", -1, processed_dir).graph
    g = loaders.create_finetune_arrays(domain, "train", -1, processed_dir).graph
    jgd, jbsr, jinv = jax_runners._csr_graph_aux(jg)
    graph, bsr, inv = csr_graph_aux(g)
    np.testing.assert_array_equal(inv, jinv)
    assert inv.dtype == jinv.dtype
    for name in ("x", "senders", "receivers", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(graph, name).numpy(), np.asarray(jgd[name]),
                                      err_msg=name)
    for name in ("vals", "rows", "cols", "vals_t", "rows_t", "cols_t"):
        np.testing.assert_array_equal(getattr(bsr, name).numpy(),
                                      np.asarray(getattr(jbsr, name)), err_msg=name)
    assert bsr.num_nodes == jbsr.num_nodes == g.num_nodes


def test_csr_eval_logits_match_jax(processed_dir):
    jdata = {"train": jax_loaders.create_finetune_arrays("Cora_NC", "train", -1, processed_dir)}
    g = loaders.create_finetune_arrays("Cora_NC", "train", -1, processed_dir).graph
    jcfg = jax_config.FinetuneConfig("Cora_NC", "full_finetune", "b1", 0)
    jmodel, variables = jax_ft._init_finetune_model(jcfg, jdata, "csr", 0)
    variables = perturb(variables, 3)
    jgd, jbsr, _ = jax_runners._csr_graph_aux(jdata["train"].graph)
    jg = jdata["train"].graph
    want_csr = np.asarray(jmodel.apply(
        variables, jgd["x"], jgd["node_mask"], False, senders=jgd["senders"],
        receivers=jgd["receivers"], edge_mask=jgd["edge_mask"], bsr=jbsr))
    want_coo = np.asarray(JaxFinetuneGNN(domain_name="Cora_NC", aggregation="coo").apply(
        variables, jnp.asarray(jg.x), jnp.asarray(jg.node_mask), False,
        senders=jnp.asarray(jg.senders), receivers=jnp.asarray(jg.receivers),
        edge_mask=jnp.asarray(jg.edge_mask)))

    graph, bsr, inv = csr_graph_aux(g)
    model = load_variables(FinetuneGNN("Cora_NC", "csr", device="cpu"), variables).eval()
    with torch.no_grad():
        got = model(graph.x, graph.node_mask, senders=graph.senders,
                    receivers=graph.receivers, edge_mask=graph.edge_mask,
                    bsr=bsr).numpy()
    np.testing.assert_allclose(got, want_csr, rtol=2e-4, atol=2e-4)
    # Node i (old ids) sits at row inv[i] of the permuted output.
    np.testing.assert_allclose(got[inv], want_coo, rtol=2e-4, atol=2e-4)


def run_step_case(domain, processed_dir):
    """One csr train step of the port (``build_steps``) and of the JAX
    runner's step function from the same weights on the same permuted graph."""
    jcfg = jax_config.FinetuneConfig(domain, "full_finetune", "b1", 0)
    cfg = config.FinetuneConfig(domain, "full_finetune", "b1", 0)
    bs = cfg.batch_size
    jdata = {"train": jax_loaders.create_finetune_arrays(domain, "train", bs, processed_dir)}
    data = {"train": loaders.create_finetune_arrays(domain, "train", bs, processed_dir)}
    jmodel, variables = jax_ft._init_finetune_model(jcfg, jdata, "csr", 0)
    variables = perturb(variables, 4)
    joptimizer, jlabels, lrs = jax_ft.create_finetune_optimizer(variables["params"], jcfg)
    jstate = (variables["params"], variables["batch_stats"],
              joptimizer.init(variables["params"]))
    gd, jbsr, jinv = jax_runners._csr_graph_aux(jdata["train"].graph)
    aux = {"graph": gd, "bsr": jbsr}
    graph_kwargs = dict(bsr=jbsr, senders=gd["senders"], receivers=gd["receivers"],
                        edge_mask=gd["edge_mask"])
    jvars = {"params": jstate[0], "batch_stats": jstate[1]}
    key = jax.random.PRNGKey(5)

    model = load_variables(FinetuneGNN(domain, "csr", device="cpu"), variables)
    optimizer, labels, tlrs = ft.create_finetune_optimizer(model, cfg)
    assert tlrs == lrs
    train, _, batches, _ = ft.build_steps(cfg, model, optimizer, labels, data, "cpu")
    _, args = next(iter(batches()))
    kwargs = {}

    if cfg.task_type == "node_classification":
        train_one, _ = jax_runners._nc_fns(jmodel, jcfg, joptimizer, jlabels)
        b = jax.tree.map(lambda a: a[0], jax_runners._nc_stack(jdata["train"], jinv))
        np.testing.assert_array_equal(args[0].numpy(), np.asarray(b["idx"]))
        taken = jax_relu_branches(jmodel, jvars, cfg.task_type, (gd["x"], gd["node_mask"]),
                                  **graph_kwargs)
    else:
        jg = jdata["train"].graph
        train_edges = jinv[np.asarray(jdata["train"].train_edges)]
        node_mask = np.asarray(jg.node_mask)[np.argsort(jinv)]
        aux["forbidden"] = jnp.asarray(jax_mining.build_forbidden_mask(
            jg.num_nodes, train_edges, node_mask=node_mask))
        num_hard = jax_mining.hard_count(jax_mining.candidate_count(
            jg.num_nodes, train_edges, num_real_nodes=int(node_mask.sum())), bs)
        train_one, _ = jax_runners._lp_fns(jmodel, jcfg, joptimizer, jlabels, num_hard)
        b = jax.tree.map(lambda a: a[0], jax_runners._lp_stack(jdata["train"], "train", jinv))
        np.testing.assert_array_equal(args[0].numpy(), np.asarray(b["edges"]))
        # The scored forward's branches, after the no-grad embedding pass
        # (left alone) has updated the BN stats and fed the miner, whose
        # pairs the port then scores too.
        k_emb, k_mine, _ = jax.random.split(key, 3)
        emb, mut = jmodel.apply(jvars, gd["x"], gd["node_mask"], True,
                                mutable=["batch_stats"], rngs={"dropout": k_emb},
                                method=JaxFinetuneGNN.embed, **graph_kwargs)
        neg_s, neg_r = jax_mining.mine_hard_negatives(
            emb, aux["forbidden"], k_mine, num_negatives=bs, num_hard=num_hard)
        pos = b["edges"]
        scored = jax_relu_branches(
            jmodel, {"params": jstate[0], "batch_stats": mut["batch_stats"]},
            cfg.task_type, (gd["x"], gd["node_mask"]),
            score_senders=jnp.concatenate([pos[0], neg_s]),
            score_receivers=jnp.concatenate([pos[1], neg_r]),
            return_logits=True, **graph_kwargs)
        taken = [None] * (1 + 2 * jax_config.GNN_NUM_LAYERS) + scored
        kwargs = {"negatives": (t(np.array(neg_s)), t(np.array(neg_r)))}

    with jax.disable_jit():
        jstate2, jout = train_one(jstate, b, aux, key)
    with relu_branches.replay(model, taken) as flips:
        out = train(*args, **kwargs)
    return {
        "jax_out": [np.asarray(x) for x in jout], "port_out": [x.detach().numpy() for x in out],
        "jax_grads": adam_first_moment_grads(jstate2[2], lrs),
        "port_grads": flat(state_dict_to_variables(
            {name: p.grad for name, p in model.named_parameters()
             if p.grad is not None})["params"]),
        "jax_stats": flat(jax.device_get(jstate2[1])),
        "port_stats": flat(model_variables(model)["batch_stats"]),
        "relu_flips": sum(flips), "relu_units": sum(b_.size for b_ in taken if b_ is not None),
    }


_CASES = {}


@pytest.fixture(params=["Cora_NC", "Cora_LP"])
def step_case(request, processed_dir):
    if request.param not in _CASES:
        with pytest.MonkeyPatch.context() as mp:
            for cfg in (jax_config, config):
                mp.setattr(cfg, "DROPOUT_RATE", 0.0)
                mp.setattr(cfg, "GNN_NUM_LAYERS", LAYERS)
            _CASES[request.param] = run_step_case(request.param, processed_dir)
    return _CASES[request.param]


def test_first_train_step_matches_jax(step_case):
    c = step_case
    jloss, jy, jpreds, jprobs, *_, jgnorm = c["jax_out"]
    loss, y, preds, probs, *_, gnorm = c["port_out"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(gnorm, jgnorm, rtol=1e-3)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-5)
    assert c["port_grads"].keys() == c["jax_grads"].keys()
    for k, want in c["jax_grads"].items():
        np.testing.assert_allclose(c["port_grads"][k], want, err_msg=k, **GRAD_TOL["pallas"])
    assert c["relu_flips"] <= 1e-4 * c["relu_units"], c["relu_flips"]
    assert c["port_stats"].keys() == c["jax_stats"].keys()
    for k, want in c["jax_stats"].items():
        np.testing.assert_allclose(c["port_stats"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)


_CSR_RUNS = {}


def csr_run(domain, epochs, processed_dir, tmp_path_factory):
    """``finetune(aggregation="csr")`` of ``domain`` from scratch, once per
    process: (config, result, out_root)."""
    if domain not in _CSR_RUNS:
        cfg = config.FinetuneConfig(domain, "full_finetune", "b1", 42)
        out = tmp_path_factory.mktemp(f"csr_{domain}")
        res = ft.finetune(cfg, aggregation="csr", processed_dir=processed_dir, epochs=epochs,
                          out_root=out, device="cpu")
        _CSR_RUNS[domain] = cfg, res, out
    return _CSR_RUNS[domain]


@pytest.mark.parametrize("domain,epochs", [("Cora_NC", 3), ("Cora_LP", 2)])
def test_csr_trains_through_finetune(processed_dir, tmp_path_factory, domain, epochs):
    _, res, _ = csr_run(domain, epochs, processed_dir, tmp_path_factory)
    metric = "test/auc" if domain.endswith("LP") else "test/accuracy"
    assert 0.0 <= res[metric] <= 1.0
    assert np.isfinite(res["test/loss"]) and res["test/steps_per_sec"] > 0


@pytest.mark.parametrize("domain,epochs", [("Cora_NC", 3), ("Cora_LP", 2)])
def test_csr_summary_fidelity_block_equals_jax(processed_dir, tmp_path_factory, domain, epochs):
    cfg, _, out = csr_run(domain, epochs, processed_dir, tmp_path_factory)
    summary = json.loads((out / "metrics" / config.FINETUNE_PROJECT_NAME
                          / f"{cfg.run_name}.summary.json").read_text())
    assert {k: v for k, v in summary.items() if k.startswith("fidelity/")} == \
        jax_fidelity_block(epochs, 42, "csr", processed_dir, (domain,))


def test_csr_close_to_coo_test_accuracy(processed_dir, tmp_path):
    cfg = config.FinetuneConfig("Cora_NC", "linear_probe", "b1", 42)
    runs = {agg: ft.finetune(cfg, aggregation=agg, processed_dir=processed_dir, epochs=4,
                             out_root=tmp_path / agg, device="cpu")
            for agg in ("coo", "csr")}
    assert abs(runs["coo"]["test/accuracy"] - runs["csr"]["test/accuracy"]) < 0.15


def test_csr_rejects_graph_classification(tmp_path):
    """Before any work: the stores directory does not even exist."""
    cfg = config.FinetuneConfig("ENZYMES", "full_finetune", "b1", 42)
    with pytest.raises(ValueError, match="csr"):
        ft.finetune(cfg, aggregation="csr", processed_dir=tmp_path / "missing",
                    epochs=1, out_root=tmp_path, device="cpu")
