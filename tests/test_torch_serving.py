"""The port's serving slice end to end, against the JAX package, on the CPU.

At full width: the b2 transfer artifact loaded into the port, ENZYMES
embeddings at the serving bucket (1056 nodes / 3992 edges) held against

  (a) JAX ``FinetuneGNN("ENZYMES", "pallas").embed`` on the same promoted
      fp16 weights and the same bf16 adjacency, at rtol=1e-4, atol=1e-4;
  (b) the replay of the tracked ``artifacts/serving/ENZYMES_embed_b2.stablehlo``,
      at rtol=atol=1e-2. That artifact baked the f32 pretrain weights, while
      the transfer artifact holds them in fp16 (relative rounding up to
      2^-11 per weight). Measured on this input, the gap is 8.8e-3 absolute
      at most (1.2e-3 of max |embedding| = 7.4), and JAX's own embed on the
      fp16 weights shows the same gap; the test also holds the two gaps
      equal, so what it allows is the fp16 rounding and not a port error.

Then the GC/NC/LP serving functions against JAX ``serving.make_serving_fn``
at small size, and the device rule of the entry points.
"""

from __future__ import annotations

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config
from gnn_pretraining_tpu import serving as jax_serving
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.ops.spmm import build_dense_adjacency as jax_adjacency
from gnn_pretraining_tpu.utils.checkpoint import load_transfer_artifact
from gnn_pretraining_tpu_torch import (
    FinetuneGNN,
    load_serving_model,
    make_embedding_fn,
    make_serving_fn,
)
from gnn_pretraining_tpu_torch.models import gnn as torch_gnn
from gnn_pretraining_tpu_torch.utils.convert import variables_to_state_dict

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

ARTIFACT = config.ARTIFACTS_DIR / "transfer" / "backbone_b2_42.msgpack"
REPLAY = config.ARTIFACTS_DIR / "serving" / "ENZYMES_embed_b2.stablehlo"
GRAPH = ("x", "node_mask", "senders", "receivers", "edge_mask")


def molecule_batch(rng, graphs=32, n_pad=1056, e_pad=3992, dim=21):
    """Seeded random multigraphs at a padding bucket, both edge directions."""
    sizes = 20 + rng.multinomial(n_pad - 20 * graphs - 8, [1 / graphs] * graphs)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    send, recv = [], []
    for n_g, s0 in zip(sizes, starts):
        m = int(1.85 * n_g)
        u = rng.integers(0, n_g, m)
        v = (u + rng.integers(1, n_g, m)) % n_g
        send.append(np.concatenate([u, v]) + s0)
        recv.append(np.concatenate([v, u]) + s0)
    n, e = int(sizes.sum()), sum(len(s) for s in send)
    assert n <= n_pad and e <= e_pad

    def pad(a, size):
        return np.pad(a, (0, size - len(a)))

    return {
        "x": np.pad(np.clip(rng.normal(size=(n, dim)), -3, 3),
                    ((0, n_pad - n), (0, 0))).astype(np.float32),
        "node_mask": pad(np.ones(n, np.float32), n_pad),
        "senders": pad(np.concatenate(send).astype(np.int32), e_pad),
        "receivers": pad(np.concatenate(recv).astype(np.int32), e_pad),
        "edge_mask": pad(np.ones(e, np.float32), e_pad),
        "node_graph": pad(np.repeat(np.arange(graphs), sizes).astype(np.int32), n_pad),
    }


@pytest.fixture(scope="module")
def enzymes_embeddings():
    batch = molecule_batch(np.random.default_rng(0))
    model = load_serving_model("ENZYMES", ARTIFACT, device="cpu")
    fn, names = make_embedding_fn(model)
    assert names == GRAPH
    got = fn(*(torch.from_numpy(batch[k]) for k in names)).numpy()
    return batch, got


def test_enzymes_embed_matches_jax_pallas(enzymes_embeddings):
    batch, got = enzymes_embeddings
    art = load_transfer_artifact(ARTIFACT)
    variables = {c: {"input_encoder": art[c]["input_encoders_ENZYMES"],
                     "gnn_backbone": art[c]["gnn_backbone"]}
                 for c in ("params", "batch_stats")}
    x, mask, s, r, m = (jnp.asarray(batch[k]) for k in GRAPH)
    adj = jax_adjacency(s, r, m, x.shape[0], dtype=jnp.bfloat16)
    model = JaxFinetuneGNN("ENZYMES", "pallas")
    want = model.apply(variables, x, mask, False, adj=adj, senders=s,
                       receivers=r, edge_mask=m, method=model.embed)
    assert got.shape == (1056, config.GNN_HIDDEN_DIM)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_enzymes_embed_matches_stablehlo_replay(enzymes_embeddings):
    batch, got = enzymes_embeddings
    replay = jax_serving.load_artifact(REPLAY)
    want = np.asarray(replay(*(jnp.asarray(batch[k]) for k in GRAPH)))
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    # The gap is the fp16 rounding of the transfer artifact: JAX's embed on
    # the same fp16 weights (test above) sits as far from the replay.
    gap = np.abs(got - want).max()
    assert 1e-4 < gap < 1e-2


def _small_example(domain, rng, n=24, e=60, g=3, s=16):
    ex = {"x": rng.normal(size=(n, config.DOMAIN_DIMENSIONS[domain])).astype(np.float32),
          "node_mask": (np.arange(n) < n - 2).astype(np.float32),
          "senders": rng.integers(0, n - 2, e).astype(np.int32),
          "receivers": rng.integers(0, n - 2, e).astype(np.int32),
          "edge_mask": (np.arange(e) < e - 4).astype(np.float32)}
    task = config.TASK_TYPES[domain]
    if task == "graph_classification":
        ex["node_graph"] = np.sort(rng.integers(0, g, n)).astype(np.int32)
    elif task == "link_prediction":
        ex["score_senders"] = rng.integers(0, n, s).astype(np.int32)
        ex["score_receivers"] = rng.integers(0, n, s).astype(np.int32)
    return ex


@pytest.mark.parametrize("domain", ["ENZYMES", "Cora_NC", "Cora_LP"])
def test_serving_fn_matches_jax(domain, monkeypatch):
    rng = np.random.default_rng(1)
    ex = _small_example(domain, rng)
    jmodel = JaxFinetuneGNN(domain, "coo")
    task = config.TASK_TYPES[domain]
    kw = {k: jnp.asarray(v) for k, v in ex.items() if k not in ("x", "node_mask")}
    if task == "graph_classification":
        kw["num_graphs"] = 3
    variables = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(ex["x"]), jnp.asarray(ex["node_mask"]), False, **kw))
    variables["params"]["gnn_backbone"]["layers_0"]["eps"] = np.float32(0.25)
    jfn, jnames = jax_serving.make_serving_fn(jmodel, variables)
    tmodel = FinetuneGNN(domain, "pallas", device="cpu")
    tmodel.load_state_dict(variables_to_state_dict(variables))
    tfn, tnames = make_serving_fn(tmodel)
    assert tnames == jnames
    if task == "graph_classification":
        jfn, tfn = jfn(3), tfn(3)

    calls = []
    spmm = torch_gnn.spmm
    monkeypatch.setattr(torch_gnn, "spmm",
                        lambda *a, **k: calls.append(1) or spmm(*a, **k))
    want = np.asarray(jfn(*(jnp.asarray(ex[k]) for k in jnames)))
    got = tfn(*(torch.from_numpy(ex[k]) for k in tnames)).numpy()
    assert len(calls) == config.GNN_NUM_LAYERS     # every layer on K1's path
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving_model("ENZYMES", ARTIFACT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FinetuneGNN("Cora_NC")
    model = load_serving_model("Cora_NC", ARTIFACT, device="cpu", seed=3)
    assert next(model.parameters()).device.type == "cpu" and not model.training
