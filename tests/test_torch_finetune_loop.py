"""The fine-tune slice as a whole: the port's ``finetune()`` beside the JAX one.

Both packages fine-tune the same tiny seeded stores on the CPU for four
epochs: one GC, one NC and one LP domain from scratch, plus ENZYMES
``linear_probe`` from the tracked b2 transfer artifact. The JAX side runs
that last cell on its default runner (``fused=True``, one epoch per
dispatch) and the others on its per-step path (``fused=False``, quicker to
compile here). With four epochs the patience is 2, so at least three epochs
run, and the port and the fused runner both write the steady rates (the port
from its third epoch, the fused runner from its third dispatch); the
per-step path writes none. The two runs draw different random numbers (init, dropout), so
metric *values* are not compared; held equal are the metric key sets of every
logged row and of the result, the parameter counts, the summary's
``fidelity/*`` block, the columns ``analysis/data_collection.py`` reads from
the summaries, and the checkpoint format: the best checkpoint the port wrote
must load with the JAX package's ``load_checkpoint`` and give the port's eval
logits in the JAX model at rtol=1e-4, atol=1e-5
(tests/test_model_parity.py:213-216). A second port run of a cell gives the
same metrics at rtol 1e-6, times and rates aside
(tests/test_fused_finetune.py:35-42).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.finetune.finetune import finetune as jax_finetune
from gnn_pretraining_tpu.models.finetune_model import FinetuneGNN as JaxFinetuneGNN
from gnn_pretraining_tpu.ops.spmm import build_dense_adjacency as jax_adjacency
from gnn_pretraining_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from gnn_pretraining_tpu.utils.fidelity import fidelity_block as jax_fidelity_block
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data import loaders
from gnn_pretraining_tpu_torch.data.synthetic import (
    synthetic_graph_store,
    synthetic_planetoid_stores,
)
from gnn_pretraining_tpu_torch.finetune import finetune as ft
from gnn_pretraining_tpu_torch.ops.spmm import build_dense_adjacency
from gnn_pretraining_tpu_torch.utils.convert import load_variables

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

EPOCHS = 4
STEADY = {"test/steady_steps_per_sec", "test/steady_edges_per_sec"}
CELLS = [("PTC_MR", "full_finetune", "b1"), ("Cora_NC", "full_finetune", "b1"),
         ("CiteSeer_LP", "full_finetune", "b1"), ("ENZYMES", "linear_probe", "b2")]
FUSED_CELL = CELLS[3]                  # the JAX side's fused runner: one GC cell
RTOL, ATOL = 1e-4, 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop_stores")
    rng = np.random.default_rng(1)
    for domain in ("PTC_MR", "ENZYMES"):
        synthetic_graph_store(domain, rng, rng.integers(5, 10, 40)).save(tmp / f"{domain}.npz")
    # 26 nodes: 0.3 * candidates < 256, so the LP miner also draws a remainder.
    for name, nodes, edges in (("Cora", 60, 110), ("CiteSeer", 26, 40)):
        for key, store in synthetic_planetoid_stores(name, rng, nodes, edges, 16, 10, 10).items():
            store.save(tmp / f"{key}.npz")
    return tmp


def rows(out_root, cfg):
    path = out_root / "metrics" / config.FINETUNE_PROJECT_NAME / f"{cfg.run_name}.jsonl"
    return [json.loads(line) for line in open(path)]


def key_sets(logged):
    """Row kind -> union of metric keys over the rows of that kind."""
    out = {"train": set(), "val": set(), "test": set()}
    for row in logged:
        kind = next(k for k in out if any(name.startswith(k + "/") for name in row))
        out[kind] |= set(row)
    return out


_RUNS = {}


def get_run(cell, processed_dir, tmp_path_factory):
    if cell not in _RUNS:
        domain, strategy, scheme = cell
        out = {side: tmp_path_factory.mktemp(f"{domain}_{side}") for side in ("port", "jax")}
        cfg = config.FinetuneConfig(domain, strategy, scheme, 42)
        jcfg = jax_config.FinetuneConfig(domain, strategy, scheme, 42)
        result = ft.finetune(cfg, aggregation="pallas", processed_dir=processed_dir,
                             epochs=EPOCHS, out_root=out["port"], device="cpu")
        fused = cell == FUSED_CELL
        jresult = jax_finetune(jcfg, aggregation="pallas", processed_dir=processed_dir,
                               use_wandb=False, epochs=EPOCHS, out_root=out["jax"],
                               fused=fused, chunk_epochs=1)
        _RUNS[cell] = dict(cfg=cfg, result=result, jresult=jresult, out=out, fused=fused,
                           logged=rows(out["port"], cfg), jlogged=rows(out["jax"], jcfg))
    return _RUNS[cell]


def run_fixture(cells):
    @pytest.fixture(params=cells, ids=lambda c: "-".join(c))
    def run(request, processed_dir, tmp_path_factory):
        return get_run(request.param, processed_dir, tmp_path_factory)

    return run


# The graph-classification cells here; the NC and LP cells run the same tests
# from test_torch_finetune_loop_graph.py (two files, two test workers).
run = run_fixture([CELLS[0], CELLS[3]])


@pytest.fixture
def probe_run(processed_dir, tmp_path_factory):
    return get_run(CELLS[3], processed_dir, tmp_path_factory)


def test_metric_keys_and_parameter_counts_equal_jax(run):
    assert STEADY <= run["result"].keys()
    assert (STEADY <= run["jresult"].keys()) == run["fused"]
    assert run["result"].keys() == run["jresult"].keys() | STEADY
    want = key_sets(run["jlogged"])
    want["test"] |= STEADY
    assert key_sets(run["logged"]) == want
    for key in ("test/total_parameters", "test/trainable_parameters"):
        assert run["result"][key] == run["jresult"][key]
    # One row per train step, then one val row per epoch at that epoch's last
    # step, on both sides (how many epochs ran depends on the values).
    for logged in (run["logged"], run["jlogged"]):
        steps = [r["_step"] for r in logged]
        assert steps == sorted(steps) and steps[0] == 1
    values = [v for r in run["logged"] for k, v in r.items() if k.endswith("/loss")]
    assert values and np.isfinite(values).all()
    summary = json.load(open(
        run["out"]["port"] / "metrics" / config.FINETUNE_PROJECT_NAME
        / f"{run['cfg'].run_name}.summary.json"))
    assert summary["test/accuracy"] == run["result"]["test/accuracy"]


def test_selection_patience_and_best_reload(run):
    cfg, result = run["cfg"], run["result"]
    sel = "val/auc" if cfg.task_type == "link_prediction" else "val/accuracy"
    vals = [r[sel] for r in run["logged"] if sel in r]
    patience = int(EPOCHS * config.FINETUNE_PATIENCE_FRACTION)        # 2
    best, since, expect_epochs = -np.inf, 0, 0
    for epoch, v in enumerate(vals, 1):
        best, since = (v, 0) if v > best else (best, since + 1)
        expect_epochs = epoch
        if since >= patience:
            break
    assert len(vals) == expect_epochs == result["test/progress/epoch"]
    best_epoch = int(np.argmax(vals)) + 1                             # first max wins
    assert result["test/convergence_epochs"] == best_epoch
    ckpt = jax_load_checkpoint(run["out"]["port"] / "finetune" / f"model_{cfg.run_name}.msgpack")
    assert ckpt["meta"]["epoch"] == best_epoch
    assert ckpt["meta"]["val_metrics"][sel] == vals[best_epoch - 1]


def test_port_checkpoint_reproduces_eval_logits_in_the_jax_model(run, processed_dir):
    cfg = run["cfg"]
    path = run["out"]["port"] / "finetune" / f"model_{cfg.run_name}.msgpack"
    ckpt = jax_load_checkpoint(path)
    variables = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    model = load_variables(
        ft.build_finetune_model(cfg, "pallas", "cpu", run["out"]["port"]), variables).eval()
    jmodel = JaxFinetuneGNN(domain_name=cfg.domain_name, aggregation="pallas")
    data = loaders.create_finetune_arrays(cfg.domain_name, "val", cfg.batch_size, processed_dir)
    g = data.batches[0] if cfg.task_type == "graph_classification" else data.graph
    adj = build_dense_adjacency(g.senders, g.receivers, g.edge_mask, g.num_nodes,
                                dtype=torch.bfloat16)
    j = {k: jnp.asarray(getattr(g, k).numpy())
         for k in ("x", "node_mask", "senders", "receivers", "edge_mask", "node_graph")}
    jkw = dict(adj=jax_adjacency(j["senders"], j["receivers"], j["edge_mask"], g.num_nodes,
                                 dtype=jnp.bfloat16),
               senders=j["senders"], receivers=j["receivers"], edge_mask=j["edge_mask"])
    kw = dict(adj=adj, senders=g.senders, receivers=g.receivers, edge_mask=g.edge_mask)
    if cfg.task_type == "graph_classification":
        kw.update(node_graph=g.node_graph, num_graphs=g.num_graphs)
        jkw.update(node_graph=j["node_graph"], num_graphs=g.num_graphs)
    elif cfg.task_type == "link_prediction":
        e = torch.from_numpy(data.edges[0])
        kw.update(score_senders=e[0], score_receivers=e[1], return_logits=True)
        jkw.update(score_senders=jnp.asarray(data.edges[0][0]),
                   score_receivers=jnp.asarray(data.edges[0][1]), return_logits=True)
    with torch.no_grad():
        got = model(g.x, g.node_mask, **kw)
    want = jmodel.apply(variables, j["x"], j["node_mask"], False, **jkw)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_linear_probe_trains_the_head_only(probe_run):
    run = probe_run
    cfg = run["cfg"]
    first = ft.build_finetune_model(cfg, "pallas", "cpu", run["out"]["port"]).state_dict()
    best = load_variables(ft.build_finetune_model(cfg, "pallas", "cpu"), jax_load_checkpoint(
        run["out"]["port"] / "finetune" / f"model_{cfg.run_name}.msgpack")).state_dict()
    for name, value in first.items():
        frozen = not name.startswith("classification_head")
        if frozen and "running_" not in name and "num_batches" not in name:
            assert torch.equal(best[name], value), name           # backbone from the artifact
        if frozen and name.endswith("running_mean"):
            assert not torch.equal(best[name], value), name       # BN stats still moved
    assert run["result"]["test/trainable_parameters"] == 256 * 128 + 128 + 128 * 6 + 6


def summary(out_root, cfg):
    return json.loads((out_root / "metrics" / config.FINETUNE_PROJECT_NAME
                       / f"{cfg.run_name}.summary.json").read_text())


def test_summary_fidelity_block_equals_jax(run, processed_dir):
    cfg = run["cfg"]
    want = jax_fidelity_block(EPOCHS, cfg.seed, "pallas", processed_dir, (cfg.domain_name,))
    for side in ("port", "jax"):
        got = {k: v for k, v in summary(run["out"][side], cfg).items()
               if k.startswith("fidelity/")}
        assert got == want, side


def test_dense_summary_fidelity_block_equals_jax(processed_dir, tmp_path):
    """The block names the aggregation that ran: here the plain dense one."""
    cfg = config.FinetuneConfig("PTC_MR", "full_finetune", "b1", 42)
    ft.finetune(cfg, aggregation="dense", processed_dir=processed_dir, epochs=1,
                out_root=tmp_path, device="cpu")
    got = {k: v for k, v in summary(tmp_path, cfg).items() if k.startswith("fidelity/")}
    assert got == jax_fidelity_block(1, 42, "dense", processed_dir, ("PTC_MR",))


def test_a_second_run_gives_the_same_metrics(run, processed_dir, tmp_path):
    cfg = run["cfg"]
    again = ft.finetune(cfg, aggregation="pallas", processed_dir=processed_dir,
                        epochs=EPOCHS, out_root=tmp_path, device="cpu")
    assert again.keys() == run["result"].keys()
    for k, v in run["result"].items():
        if "time" not in k and "_per_sec" not in k:
            np.testing.assert_allclose(again[k], v, rtol=1e-6, err_msg=k)


def test_data_collection_reads_port_cells_as_jax_cells(run):
    """``analysis/data_collection.extract_all_finetune_results`` over each
    package's metrics directory: one row for the cell, the same columns, the
    steady rates among them (which the JAX per-step path does not write)."""
    spec = importlib.util.spec_from_file_location(
        "data_collection", REPO / "analysis" / "data_collection.py")
    collection = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(collection)
    frames = {side: collection.extract_all_finetune_results(
        metrics_dir=run["out"][side] / "metrics" / config.FINETUNE_PROJECT_NAME)
        for side in ("port", "jax")}
    assert len(frames["port"]) == len(frames["jax"]) == 1
    steady = {"steady_steps_per_sec", "steady_edges_per_sec"}
    assert steady <= set(frames["port"].columns)
    assert (steady <= set(frames["jax"].columns)) == run["fused"]
    assert set(frames["port"].columns) == set(frames["jax"].columns) | steady
    row = frames["port"].iloc[0]
    assert (row["domain"], row["strategy"], row["scheme"], row["seed"]) == (
        run["cfg"].domain_name, run["cfg"].finetune_strategy, run["cfg"].pretrained_scheme, 42)
