"""Data-parallel pretraining: each rank steps on its share of every batch.

Port of ``gnn_pretraining_tpu/parallel/data_parallel.py``. The graphs of
every domain batch are dealt round-robin over the ranks of the data axis
(``parallel.mesh.DataAxis``), and a step computes exactly the
single-device step on the union of the ranks' graphs:

  * the additive task losses sum their sums and sizes over the ranks
    (``pretrain/tasks.py`` ``_preduce``);
  * the contrastive tasks gather their projections, so the NT-Xent
    negatives span the global batch (``ops/sddmm.gather_pairs``, then K2);
  * every BatchNorm is a SyncBN (``models/norm.py`` ``axis``), normalizing
    with the statistics of the global batch;
  * each task's gradient is averaged over the ranks right after its
    ``autograd.grad`` (``DataAxis.pmean``; each rank's gradient is n times
    its share of the loss every rank computes), then the balancer, PCGrad
    (the same permutation generator on every rank), the domain-adversarial
    gradient, the clip and AdamW run replicated on every rank, so the
    parameters and BatchNorm statistics stay equal bit for bit.

Dropout, views, masks and negatives draw from streams seeded from (seed,
rank) (``rank_seed``), the counterpart of JAX's ``fold_in(key,
axis_index)``: independent draws on every rank. Every rank draws the same
graphs from the same sampler state (``shard_sampler_step``) and builds only
its own share.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gnn_pretraining_tpu_torch.data.batch import GraphBatch, build_batch, round_up
from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's own stream, from the run's seed and the rank."""
    return int(np.random.SeedSequence((int(seed), int(rank))).generate_state(1)[0])


def dp_pads(sampler, n_dev: int) -> Dict[str, tuple]:
    """Per-rank padded shapes ``{domain: (n_pad, e_pad, g_local)}``: the
    largest graph plus the 0.95 quantile for each other local slot, capped
    at the worst case (the single-device sampler's policy,
    ``data/loaders.py``), never ``g_local`` times the largest graph."""
    pads = {}
    for d, s in sampler.domain_stores.items():
        ix = sampler.train_indices[d]
        nn = np.diff(s.node_offsets)[ix]
        ne = np.diff(s.edge_offsets)[ix]
        g_local = max(1, -(-sampler.samples_per_domain // n_dev))
        n_pad = int(nn.max()) + int(np.ceil(np.quantile(nn, 0.95))) * (g_local - 1)
        e_pad = int(ne.max()) + int(np.ceil(np.quantile(ne, 0.95))) * (g_local - 1)
        pads[d] = (round_up(min(n_pad, int(nn.max()) * g_local)),
                   round_up(max(min(e_pad, int(ne.max()) * g_local), 1)),
                   g_local)
    return pads


def shard_sampler_step(sampler, n_dev: int, rank: int,
                       pads: Optional[dict] = None) -> Dict[str, GraphBatch]:
    """Rank ``rank``'s share of one balanced multi-domain step.

    The sampler's ``samples_per_domain`` graphs per domain are dealt
    round-robin over ``n_dev`` ranks (rank r takes ``chosen[r::n_dev]``).
    Every rank draws the same ``chosen`` from its copy of the sampler state
    and redraws it whole while any rank's share exceeds the pads, so the
    ranks stay in step; 100 draws over the pads in a row raise, as the
    single-device sampler does."""
    pads = pads or dp_pads(sampler, n_dev)
    out = {}
    for d, store in sampler.domain_stores.items():
        ix = sampler.train_indices[d]
        n_pad, e_pad, g_local = pads[d]
        nn, ne = sampler.graph_sizes[d]
        for _ in range(100):
            chosen = ix[sampler.rng.integers(0, len(ix), sampler.samples_per_domain)]
            if all(nn[chosen[r::n_dev]].sum() <= n_pad and ne[chosen[r::n_dev]].sum() <= e_pad
                   for r in range(n_dev)):
                break
        else:
            raise RuntimeError(f"{d}: 100 consecutive draws exceeded the per-rank pad "
                               f"budget (n_pad={n_pad}, e_pad={e_pad})")
        out[d] = build_batch(store, chosen[rank::n_dev], n_pad, e_pad, g_local,
                             with_properties=True)
    return out


def make_dp_train_step(model, cfg, optimizer, total_steps: int, axis: DataAxis, views,
                       pcgrad_generator=None, draws=None):
    """The data-parallel train step: ``pretrain.make_train_step`` on
    ``axis`` (``model`` built with the same axis; ``views`` and ``draws``
    this rank's own streams, ``pcgrad_generator`` the same on every rank)."""
    from gnn_pretraining_tpu_torch.pretrain.pretrain import make_train_step

    return make_train_step(model, cfg, optimizer, total_steps, views, pcgrad_generator,
                           draws, axis=axis)
