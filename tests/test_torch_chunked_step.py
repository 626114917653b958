"""The port's chunked pretrain runner against its per-step step, on the CPU.

``make_chunked_train_step`` runs the step body that ``make_train_step``
runs, on views into one row of words per step (``chunked.StepLayout``),
with the device counters, the τ / λ tables and PCGrad's order read on the
device. Four steps through it, in chunks of 3 and 1 (a ragged tail), must
equal four per-step steps on the same batches and seeded streams bit for
bit: every metric, every parameter and BatchNorm statistic, AdamW's state,
the counters and every generator's state. Its ``metric_names`` equal the
names the JAX package's chunk program packs (read by tracing ``chunk_fn``
at a small size, built as ``tests/test_chunked_step.py`` builds it), for a
one-task scheme and the six-task one. The schedule
tables equal ``temperature_at`` / ``grl_lambda_at`` at every step, and the
device balancer the JAX ``balance_losses`` across its warm-up boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_pretraining_tpu import config as jax_config
from gnn_pretraining_tpu.data.loaders import create_pretrain_train_loader as jax_loader
from gnn_pretraining_tpu.pretrain import balancer as jax_balancer
from gnn_pretraining_tpu.pretrain import optimizers as jax_optimizers
from gnn_pretraining_tpu.pretrain import pretrain as jax_pretrain
from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.data.loaders import create_pretrain_train_loader
from gnn_pretraining_tpu_torch.data.synthetic import attach_graph_properties, synthetic_graph_store
from gnn_pretraining_tpu_torch.pretrain import balancer, schedulers
from gnn_pretraining_tpu_torch.pretrain import pretrain as pt
from gnn_pretraining_tpu_torch.pretrain.chunked import StepLayout, stack_batches
from gnn_pretraining_tpu_torch.pretrain.optimizers import create_task_specific_optimizer

# Small CPU shapes: one intra-op thread per test process. The default, a
# thread per core in every pytest-xdist worker, spends most of its time
# spinning and starves the other workers.
torch.set_num_threads(1)

DOMAINS = ("MUTAG", "ENZYMES")
LAYERS = 1
STEPS = 4
CHUNKS = (3, 1)                  # a chunk and a ragged tail
SCHEMES = ("b2", "s3", "s5")


@pytest.fixture(scope="module", autouse=True)
def small():
    with pytest.MonkeyPatch.context() as mp:
        for c in (jax_config, config):
            mp.setattr(c, "GNN_NUM_LAYERS", LAYERS)
            for scheme in SCHEMES:
                mp.setitem(c.PRETRAIN_DOMAINS, scheme, DOMAINS)
        yield


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunked_stores")
    rng = np.random.default_rng(5)
    for domain in DOMAINS:
        sizes = np.maximum(3, rng.poisson(6, 30))
        attach_graph_properties(synthetic_graph_store(domain, rng, sizes, 3.8)).save(
            tmp / f"{domain}.npz")
    return tmp


def fresh(cfg):
    model = pt.build_pretrain_model(cfg, "pallas", "cpu")
    optimizer, _, _ = create_task_specific_optimizer(model, cfg.active_tasks)
    return model, optimizer, pt.random_streams(cfg, model, "cpu")


def stream_bytes(streams):
    return {name: st if isinstance(st, dict) else bytes(np.asarray(st))
            for name, st in pt.stream_states(streams).items()}


def assert_same_tensors(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


_RUNS = {}


def run_scheme(scheme, processed_dir):
    """Four steps of ``scheme`` per step and chunked, from the same seeds
    (once per scheme in the module)."""
    if scheme not in _RUNS:
        _RUNS[scheme] = _run(scheme, processed_dir)
    return _RUNS[scheme]


@pytest.fixture(scope="module", params=SCHEMES)
def runs(request, processed_dir):
    return run_scheme(request.param, processed_dir)


def _run(scheme, processed_dir):
    cfg = config.PretrainConfig(scheme, 11)
    loader = create_pretrain_train_loader(cfg.pretrain_domains, np.random.default_rng(0),
                                          processed_dir)
    batches = [loader.sample_step() for _ in range(STEPS)]
    k = len([t for t in cfg.active_tasks if t != "domain_adv"])

    model_a, opt_a, streams_a = fresh(cfg)
    step = pt.make_train_step(model_a, cfg, opt_a, STEPS, streams_a["views"],
                              streams_a["pcgrad"], streams_a["task_draws"])
    state_a = pt.PretrainState()
    per_step = [{n: v.detach().clone() for n, v in step(state_a, b).items()} for b in batches]

    model_b, opt_b, streams_b = fresh(cfg)
    run_chunk, names = pt.make_chunked_train_step(model_b, cfg, opt_b, STEPS, streams_b)
    layout = StepLayout.of_loader(loader, k)
    perms = [torch.randperm(k, generator=streams_b["pcgrad"]).numpy() if k > 1 else None
             for _ in range(STEPS)]
    state_b = pt.PretrainState()
    packed, start = [], 0
    for c in CHUNKS:
        words = stack_batches(batches[start:start + c], layout, perms[start:start + c])
        packed.append(run_chunk(state_b, words, layout))
        start += c
    return {"cfg": cfg, "names": list(names), "per_step": per_step,
            "packed": torch.cat(packed, dim=1), "models": (model_a, model_b),
            "optimizers": (opt_a, opt_b), "streams": (streams_a, streams_b),
            "states": (state_a, state_b)}


def test_chunked_metrics_equal_per_step(runs):
    names, packed = runs["names"], runs["packed"]
    assert names == sorted(runs["per_step"][0]) and packed.shape == (len(names), STEPS)
    for j, metrics in enumerate(runs["per_step"]):
        want = torch.stack([metrics[n].to(torch.float32).reshape(()) for n in names])
        assert torch.equal(packed[:, j], want), f"step {j}"


def test_chunked_state_equals_per_step(runs):
    model_a, model_b = runs["models"]
    assert_same_tensors(model_b.state_dict(), model_a.state_dict(), "weights")
    opt_a, opt_b = runs["optimizers"]
    params_a, params_b = list(model_a.parameters()), list(model_b.parameters())
    for pa, pb in zip(params_a, params_b):
        assert_same_tensors(opt_b.state[pb], opt_a.state[pa], "AdamW state")
    streams_a, streams_b = runs["streams"]
    assert stream_bytes(streams_b) == stream_bytes(streams_a)
    state_a, state_b = runs["states"]
    multi = int(len(runs["cfg"].active_tasks) - ("domain_adv" in runs["cfg"].active_tasks) > 1)
    assert (state_b.opt_step, state_b.balancer_step) == (STEPS, STEPS * multi)
    assert (state_a.opt_step, state_a.balancer_step) == (state_b.opt_step, state_b.balancer_step)
    assert state_b.device_counters("cpu").tolist() == [STEPS, STEPS * multi]


@pytest.mark.parametrize("scheme", ["b2", "s5"])       # one task; all six
def test_metric_names_equal_jax_chunk_program(scheme, processed_dir):
    """The JAX chunk program's packed rows, read at trace time by tracing
    ``chunk_fn`` on two of its steps (``jax.eval_shape``: nothing is
    compiled or run)."""
    runs = run_scheme(scheme, processed_dir)
    cfg = jax_config.PretrainConfig(scheme, 11)
    loader = jax_loader(cfg.pretrain_domains, np.random.default_rng(0),
                        processed_dir=processed_dir)
    batches = [loader.sample_step() for _ in range(2)]
    model, variables = jax_pretrain.init_model(cfg, batches[0], "dense")
    optimizer = jax_optimizers.create_task_specific_optimizer(variables["params"],
                                                              cfg.active_tasks)
    state = jax_pretrain.TrainState(params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=optimizer.init(variables["params"]),
                                    opt_step=jnp.int32(0), balancer_step=jnp.int32(0))
    chunk_fn, jax_names = jax_pretrain.make_chunked_train_step(model, cfg, optimizer, 2)
    jax.eval_shape(chunk_fn, state, jax_pretrain.stack_batches(batches),
                   jax.random.PRNGKey(0))
    assert runs["names"] == list(jax_names)


@pytest.mark.parametrize("total", [1, 7, 463])
def test_schedule_tables_equal_the_functions(total):
    temps = schedulers.temperature_table(total)
    lams = schedulers.grl_lambda_table(total)
    assert temps.dtype == lams.dtype == np.float32 and temps.shape == (total + 1,)
    for step in range(total + 1):
        assert temps[step] == np.float32(schedulers.temperature_at(step, total)), step
        assert lams[step] == np.float32(schedulers.grl_lambda_at(step, total)), step
    # The step reads them on the device with its counter, past the end the last.
    table = torch.from_numpy(temps.copy())
    for step in (0, total // 2, total, total + 3):
        got = pt._at(table, torch.tensor([step]))
        assert torch.equal(got, table[min(step, total):min(step, total) + 1])
        assert torch.equal(pt._at(table, step), got)


def test_device_balancer_equals_jax_across_the_warm_up():
    losses = {"a": 2.5, "b": 0.7, "c": -1.1}
    for count in range(config.BALANCER_WARMUP_STEPS - 2, config.BALANCER_WARMUP_STEPS + 3):
        want_total, want_w, want_count = jax_balancer.balance_losses(
            {k: jnp.float32(v) for k, v in losses.items()}, jnp.int32(count))
        total, w, new_count = balancer.balance_losses(
            {k: torch.tensor(v) for k, v in losses.items()}, torch.tensor(count))
        assert torch.is_tensor(new_count) and int(new_count) == int(want_count) == count + 1
        np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
        for k in losses:
            np.testing.assert_allclose(float(w[k]), float(want_w[k]), rtol=1e-6)
