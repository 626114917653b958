"""Static-shape random selection.

Port of ``gnn_pretraining_tpu/ops/sampling.py``:

  * ``masked_randperm_select`` (:22-61): a per-group "randperm[:k]" selection
    as a boolean mask over a padded row axis (node drop, edge drop, node
    masking);
  * ``batched_negative_sampling`` (:64-124): one uniform non-edge, non-self
    node pair per positive edge slot, inside the slot's graph, by a fixed
    number of rejection rounds.

The draws come from an explicit ``torch.Generator`` on the rows' device, or
are given (``scores``, ``NegativeDraws``), so that a test can hand over
another implementation's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gnn_pretraining_tpu_torch import config


def masked_randperm_select(group_ids: torch.Tensor, row_mask: torch.Tensor,
                           num_select: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None,
                           scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Select ``num_select[g]`` uniformly random valid rows of each group.

    ``group_ids`` [R] ints in [0, G) (padding rows may carry any id but must
    have ``row_mask`` 0), ``row_mask`` [R], ``num_select`` [G]. ``scores`` [R]
    are the uniform draws in [0, 1); without them they are drawn from
    ``generator``. Returns the [R] bool selection (a subset of ``row_mask``)."""
    r = group_ids.shape[0]
    device = group_ids.device
    if scores is None:
        scores = torch.rand(r, generator=generator, device=device)
    valid = row_mask.bool()
    # Sort key (valid first, group ascending, score ascending), in f32 as in JAX.
    sort_key = torch.where(valid, group_ids.to(torch.float32) * 2.0 + scores,
                           torch.full((r,), 1e9, device=device))
    order = torch.argsort(sort_key, stable=True)
    inv = torch.empty(r, dtype=torch.long, device=device)
    inv[order] = torch.arange(r, device=device)

    num_groups = num_select.shape[0]
    gid = group_ids.long().clamp(0, num_groups - 1)
    counts = torch.zeros(num_groups, dtype=torch.long, device=device).index_add_(
        0, gid, valid.long())
    starts = torch.cumsum(counts, 0) - counts
    rank = inv - starts[gid]
    return (rank < num_select.long()[gid]) & valid


class NegativeDraws(NamedTuple):
    """The uniform draws of one ``batched_negative_sampling`` call, in [0, 1)."""
    u: torch.Tensor          # [ROUNDS, E] the rounds' source draws
    v: torch.Tensor          # [ROUNDS, E] the rounds' target draws
    fallback: torch.Tensor   # [E] the last-resort offset draw


def draw_negatives(num_edges: int, generator: Optional[torch.Generator],
                   device) -> NegativeDraws:
    rounds = config.NEG_SAMPLING_ROUNDS
    u = lambda *shape: torch.rand(shape, generator=generator,  # noqa: E731
                                  device=device)
    return NegativeDraws(u(rounds, num_edges), u(rounds, num_edges), u(num_edges))


def batched_negative_sampling(undirected_adj: torch.Tensor, edge_graph: torch.Tensor,
                              edge_mask: torch.Tensor, node_start: torch.Tensor,
                              n_node: torch.Tensor, *,
                              generator: Optional[torch.Generator] = None,
                              draws: Optional[NegativeDraws] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One negative pair per positive edge slot (reference: PyG
    ``batched_negative_sampling(to_undirected(E), batch, num_neg=|E|)``,
    src/pretrain/tasks.py:107-111).

    Per graph, uniform ordered pairs; a pair that is a self loop or an edge
    of ``undirected_adj`` [N, N] (nonzero = edge) is drawn again, for
    ``config.NEG_SAMPLING_ROUNDS`` rounds; a pair still bad after them gets a
    target that is not its source. Returns ``(neg_senders, neg_receivers)``,
    [E] int64 global node ids; a padding slot (``edge_mask`` 0) points at its
    graph's ``node_start``."""
    e = edge_graph.shape[0]
    if draws is None:
        draws = draw_negatives(e, generator, edge_graph.device)
    graph = edge_graph.long()
    g_start = node_start.long()[graph]
    g_size = torch.clamp(n_node.long()[graph], min=1)
    is_edge = undirected_adj > 0

    def pair(r):
        # f32 products truncated toward zero, as JAX's astype(int32).
        u = g_start + (draws.u[r] * g_size.to(torch.float32)).long()
        v = g_start + (draws.v[r] * g_size.to(torch.float32)).long()
        return u, v

    def bad(u, v):
        return (u == v) | is_edge[u, v]

    u, v = pair(0)
    need = bad(u, v)
    for r in range(1, config.NEG_SAMPLING_ROUNDS):
        nu, nv = pair(r)
        u = torch.where(need, nu, u)
        v = torch.where(need, nv, v)
        need = need & bad(u, v)

    # The last resort: no self loop (possibly a true edge, with probability
    # ~(E_g / n_g^2)^ROUNDS).
    off = 1 + (draws.fallback * torch.clamp(g_size - 1, min=1).to(torch.float32)).long()
    v_fb = g_start + (u - g_start + off) % g_size
    v = torch.where(need & (g_size > 1), v_fb, v)

    valid = edge_mask.bool()
    return torch.where(valid, u, g_start), torch.where(valid, v, g_start)
