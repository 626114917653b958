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

The serving artifacts (``serving.export_serving`` / ``load_serving``, a
``torch.export`` program per device): for each task type and each exportable
aggregation (``coo``, ``dense``) the replayed CPU program against the JAX
package's exported artifact on the same weights and inputs (rtol = atol =
1e-4, as the eager functions) and against the port's eager function (1e-6,
the JAX package's own round-trip bound, tests/test_serving.py:68); the
ENZYMES embedding artifact at the 1056-node bucket against the tracked
StableHLO replay under the fp16 gap rule above; the kernel aggregations and
a ``cuda`` export without a card refused; and the export CLI
(``python -m gnn_pretraining_tpu_torch.export_model``) in-process. Each
artifact is made once, by the CLI from a checkpoint file, and read by every
test that needs it (one ``torch.export`` per task type and aggregation, and
one for the embedding bucket).
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
    export_model,
    load_serving_model,
    make_embedding_fn,
    make_serving_fn,
    serving,
)
from gnn_pretraining_tpu_torch.models import gnn as torch_gnn
from gnn_pretraining_tpu_torch.utils.checkpoint import load_transfer_artifact as port_load_transfer_artifact
from gnn_pretraining_tpu_torch.utils.checkpoint import save_checkpoint
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


@pytest.fixture(scope="module")
def stablehlo_replay(enzymes_embeddings):
    batch, _ = enzymes_embeddings
    replay = jax_serving.load_artifact(REPLAY)
    return np.asarray(replay(*(jnp.asarray(batch[k]) for k in GRAPH)))


def assert_fp16_gap(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    # The gap is the fp16 rounding of the transfer artifact: JAX's embed on
    # the same fp16 weights (test above) sits as far from the replay.
    gap = np.abs(got - want).max()
    assert 1e-4 < gap < 1e-2


def test_enzymes_embed_matches_stablehlo_replay(enzymes_embeddings, stablehlo_replay):
    assert_fp16_gap(enzymes_embeddings[1], stablehlo_replay)


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


@pytest.fixture(scope="module")
def jax_initialised():
    """domain -> (example, JAX variables with a non-zero GIN eps, the JAX
    package's exported ``coo`` artifact replayed on the example): one JAX
    init and one JAX export per domain, shared by the eager and the export
    tests."""
    out = {}
    for domain in ("ENZYMES", "Cora_NC", "Cora_LP"):
        ex = _small_example(domain, np.random.default_rng(1))
        jmodel = JaxFinetuneGNN(domain, "coo")
        kw = {k: jnp.asarray(v) for k, v in ex.items() if k not in ("x", "node_mask")}
        if config.TASK_TYPES[domain] == "graph_classification":
            kw["num_graphs"] = ex["num_graphs"] = 3
        variables = jax.device_get(jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.asarray(ex["x"]), jnp.asarray(ex["node_mask"]), False, **kw))
        variables["params"]["gnn_backbone"]["layers_0"]["eps"] = np.float32(0.25)
        blob = jax_serving.export_serving(jmodel, variables, ex, platforms=("cpu",))
        names = jax_serving.make_serving_fn(jmodel, variables)[1]
        replay = jax_serving.load_serving(blob)(*(jnp.asarray(ex[k]) for k in names))
        out[domain] = ex, variables, np.asarray(replay)
    return out


@pytest.mark.parametrize("domain", ["ENZYMES", "Cora_NC", "Cora_LP"])
def test_serving_fn_matches_jax(domain, monkeypatch, jax_initialised):
    ex, variables, _ = jax_initialised[domain]
    jmodel = JaxFinetuneGNN(domain, "coo")
    task = config.TASK_TYPES[domain]
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


def _cli(out, ckpt, domain, *extra, nodes=24, edges=60):
    """``export_model.main(argv)`` at a bucket of ``_small_example``'s shape
    (or ``nodes`` / ``edges``) for the CPU; -> its exit code."""
    return export_model.main(["--checkpoint", str(ckpt), "--domain_name", domain,
                              "--num_nodes", str(nodes), "--num_edges", str(edges),
                              "--num_graphs", "3", "--num_score_edges", "16",
                              "--platforms", "cpu", "--out", str(out), *extra])


@pytest.fixture(scope="module")
def exported(jax_initialised, tmp_path_factory):
    """(domain, aggregation) -> the port's artifact file, made once by the
    export CLI (``export_serving`` and ``save_artifact``) from a checkpoint
    of the domain's JAX-initialised weights, at the example's bucket: one
    ``torch.export`` per case, shared by the export, CLI and device tests."""
    tmp = tmp_path_factory.mktemp("exported")
    made = {}

    def get(domain, aggregation):
        if (domain, aggregation) not in made:
            _, variables, _ = jax_initialised[domain]
            ckpt = tmp / f"{domain}.msgpack"
            save_checkpoint(ckpt, variables["params"], variables["batch_stats"], epoch=1)
            out = tmp / f"{domain}_{aggregation}.pt2"
            assert _cli(out, ckpt, domain, "--aggregation", aggregation) == 0
            made[domain, aggregation] = out
        return made[domain, aggregation]

    return get


def eager_model(domain, aggregation, variables):
    model = FinetuneGNN(domain, aggregation, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables))
    return model


@pytest.mark.parametrize("aggregation", ["coo", "dense"])
@pytest.mark.parametrize("domain", ["ENZYMES", "Cora_NC", "Cora_LP"])
def test_export_matches_jax_export(jax_initialised, exported, domain, aggregation):
    """The port's artifact, replayed from its file, against the JAX
    package's (its ``coo`` export: the JAX ``dense`` one computes the same
    function) and against the port's eager function."""
    ex, variables, want = jax_initialised[domain]
    eager, names = make_serving_fn(eager_model(domain, aggregation, variables))
    if config.TASK_TYPES[domain] == "graph_classification":
        eager = eager(3)
    served = serving.load_artifact(exported(domain, aggregation), device="cpu")
    assert [n for n, _, _ in served.header["inputs"]] == list(names)
    args = [torch.from_numpy(ex[k]) for k in names]
    got = served(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, eager(*args).numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def embed_artifact(tmp_path_factory):
    """The b2 transfer weights as a pretrain checkpoint, exported by the CLI
    with ``--embed`` at the tracked ENZYMES bucket (1056 nodes, 3992 edges,
    ``coo``): shared by the StableHLO replay test and the CLI test."""
    tmp = tmp_path_factory.mktemp("embed")
    tree = port_load_transfer_artifact(ARTIFACT)
    save_checkpoint(tmp / "b2.msgpack", tree["params"], tree["batch_stats"], epoch=0)
    assert _cli(tmp / "embed.pt2", tmp / "b2.msgpack", "ENZYMES", "--embed",
                nodes=1056, edges=3992) == 0
    return tmp / "embed.pt2"


def test_embed_artifact_matches_stablehlo_replay(enzymes_embeddings, stablehlo_replay,
                                                 embed_artifact):
    """The b2 transfer weights exported as an embedding artifact at the
    tracked bucket (1056 nodes, 3992 edges, ``coo``) replay within the fp16
    gap of the tracked StableHLO, and within 1e-4 of the eager K1 path's
    plain version (split bf16 products against the artifact's f32 scatter)."""
    batch, eager = enzymes_embeddings
    got = serving.load_artifact(embed_artifact, device="cpu")(
        *(torch.from_numpy(batch[k]) for k in GRAPH)).numpy()
    assert got.shape == (1056, config.GNN_HIDDEN_DIM)
    np.testing.assert_allclose(got, eager, rtol=1e-4, atol=1e-4)
    assert_fp16_gap(got, stablehlo_replay)


def test_export_and_replay_need_their_device(monkeypatch, exported):
    """A cuda program is never quietly dropped: exporting one without a card
    raises, replay runs on the card unless device="cpu", and an artifact
    without a program for the device raises."""
    ex = _small_example("Cora_NC", np.random.default_rng(1))
    model = FinetuneGNN("Cora_NC", "coo", device="cpu")
    blob = exported("Cora_NC", "coo").read_bytes()      # a cpu program only
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serving.export_serving(model, ex)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_serving(blob)
    with pytest.raises(ValueError, match="no program for 'cuda'"):
        serving.load_serving(blob, device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        serving.export_serving(model, ex, platforms=("tpu",))


@pytest.mark.parametrize("source", ["finetune ENZYMES", "pretrain ENZYMES --embed"])
def test_cli_exports_runnable_artifact(source, request):
    """``export_model.main(argv)`` on a checkpoint file: the artifact replays
    bitwise what the eager function gives on the checkpoint's weights (a
    pretrain checkpoint through the transfer contract)."""
    if source.endswith("--embed"):
        batch, _ = request.getfixturevalue("enzymes_embeddings")
        served = serving.load_artifact(request.getfixturevalue("embed_artifact"), device="cpu")
        model = FinetuneGNN("ENZYMES", "coo", device="cpu")
        model.load_state_dict(load_serving_model("ENZYMES", ARTIFACT, device="cpu").state_dict())
        want, names = make_embedding_fn(model)
        args = [torch.from_numpy(batch[k]) for k in names]
    else:
        ex, variables, _ = request.getfixturevalue("jax_initialised")["ENZYMES"]
        served = serving.load_artifact(request.getfixturevalue("exported")("ENZYMES", "coo"),
                                       device="cpu")
        make, names = make_serving_fn(eager_model("ENZYMES", "coo", variables))
        want, args = make(3), [torch.from_numpy(ex[k]) for k in names]
    np.testing.assert_array_equal(served(*args).numpy(), want(*args).numpy())


