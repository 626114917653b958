"""The parts of the four pretraining tasks besides the contrastive two, in the
port against the JAX package, on the CPU: batched negative sampling given
JAX's uniforms gives JAX's pairs exactly, the gradient reversal JAX's forward
and backward exactly, the domain classifier's dropout drops half in train
mode, and every head's optimizer label and learning rate are JAX's. The
tasks themselves are in ``test_torch_pretrain_tasks.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.models import heads as jax_heads
from gnn_pretraining_tpu.ops import sampling as jax_sampling
from gnn_pretraining_tpu.pretrain import optimizers as jax_opt
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.models.heads import DomainClassifierHead, grad_reverse
from gnn_pretraining_tpu_torch.models.pretrain_model import PretrainableGNN
from gnn_pretraining_tpu_torch.ops.sampling import batched_negative_sampling
from gnn_pretraining_tpu_torch.pretrain import optimizers
from gnn_pretraining_tpu_torch.utils.convert import state_dict_to_variables
from test_torch_pretrain_step import DOMAINS, flat, jax_negatives
from test_torch_pretrain_tasks import SCHEME

torch.set_num_threads(1)


def negative_sampling_case():
    """Three graphs: a complete one of 4 nodes (every draw rejected, the
    fallback decides), one node alone, 6 nodes on a path; 24 slots, the last
    4 padding."""
    sizes, start = np.array([4, 1, 6]), np.array([0, 4, 5])
    adj = np.zeros((12, 12), np.float32)
    adj[:4, :4] = 1 - np.eye(4)
    for i in range(5, 10):
        adj[i, i + 1] = adj[i + 1, i] = 1
    edge_graph = np.array([0] * 12 + [1] * 2 + [2] * 6 + [0] * 4, np.int32)
    edge_mask = np.array([1] * 20 + [0] * 4, np.float32)
    return adj, edge_graph, edge_mask, start.astype(np.int32), sizes.astype(np.int32)


def test_batched_negative_sampling_equals_jax():
    adj, edge_graph, edge_mask, start, sizes = negative_sampling_case()
    key = jax.random.PRNGKey(3)
    # jax_negatives rebuilds the draws of the task's key split: split(key, 4)[1].
    fake_batch = type("B", (), {"num_edges": len(edge_graph)})()
    draws = jax_negatives(key, {"only": fake_batch})[0]
    got = batched_negative_sampling(
        torch.from_numpy(adj), torch.from_numpy(edge_graph), torch.from_numpy(edge_mask),
        torch.from_numpy(start), torch.from_numpy(sizes), draws=draws)
    want = jax_sampling.batched_negative_sampling(
        jax.random.split(key, 4)[1], jnp.asarray(adj), jnp.asarray(edge_graph),
        jnp.asarray(edge_mask), jnp.asarray(start), jnp.asarray(sizes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    u, v = (g.numpy() for g in got)
    real = edge_mask > 0
    assert (u[real] != v[real]).all() or (sizes[edge_graph[real]] == 1).any()
    assert not (u[real & (edge_graph == 2)] == v[real & (edge_graph == 2)]).any()
    assert (u[~real] == start[edge_graph[~real]]).all()


def test_grad_reverse_matches_jax():
    rng = np.random.default_rng(0)
    x, g = rng.normal(size=(2, 5, 7)).astype(np.float32)
    lam = np.float32(0.37)
    want, vjp = jax.vjp(jax_heads.grad_reverse, jnp.asarray(x), jnp.asarray(lam))
    xt = torch.from_numpy(x).requires_grad_()
    out = grad_reverse(xt, torch.tensor([lam]))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


def test_domain_classifier_drops_half_in_train_mode(monkeypatch):
    monkeypatch.setattr(config, "DOMAIN_CLASSIFIER_DROPOUT_RATE", 0.5)
    head = DomainClassifierHead(generator=torch.Generator().manual_seed(0), device="cpu")
    dropout = head.classifier.mlp[2]
    dropout.source.seed(1)
    assert dropout.rate == 0.5
    seen = []
    dropout.register_forward_hook(lambda m, args, out: seen.append((args[0], out)))
    x = torch.randn(4096, config.GNN_HIDDEN_DIM, generator=torch.Generator().manual_seed(2))
    head.train()
    head(x, torch.tensor([0.0]))
    head.eval()
    head(x, torch.tensor([0.0]))
    (hidden, dropped), (eval_in, eval_out) = seen
    on = hidden > 0
    kept = dropped[on] != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01       # 4096 x 128 units
    torch.testing.assert_close(dropped[on][kept], 2 * hidden[on][kept])
    assert torch.equal(eval_in, eval_out)


def test_optimizer_labels_and_learning_rates_of_every_head():
    """heads_link_pred 5e-7, heads_domain_adv 5e-6, the per-domain heads of
    masking and graph properties (and the contrastive ones) 1e-5, as the JAX
    labels give them."""
    names = config.ACTIVE_TASKS[SCHEME]
    model = PretrainableGNN(DOMAINS, names, "dense", device="cpu")
    params = state_dict_to_variables(model.state_dict())["params"]
    want = {k: str(v) for k, v in flat(jax_opt.param_labels(params, names)).items()}
    labels = optimizers.param_labels(model, names)
    got = {}
    for n, p in model.named_parameters():
        (k,) = flat(state_dict_to_variables({n: p})["params"])
        got[k] = labels[n]
    assert got == want
    _, _, lrs = optimizers.create_task_specific_optimizer(model, names)
    assert lrs == {"default": 1e-5, "node_feat_mask": 1e-5, "link_pred": 5e-7,
                   "node_contrast": 1e-5, "graph_contrast": 1e-5, "graph_prop": 1e-5,
                   "domain_adv": 5e-6}
    assert lrs == {"default": jax_config.DEFAULT_LR,
                   **{t: jax_config.TASK_SPECIFIC_LR[t] for t in names}}
    for head, task in (("heads_link_pred", "link_pred"), ("heads_domain_adv", "domain_adv"),
                       ("heads_node_feat_mask_MUTAG", "node_feat_mask"),
                       ("heads_graph_prop_ENZYMES", "graph_prop")):
        assert {v for k, v in want.items() if k.startswith(f"['{head}']")} == {task}
