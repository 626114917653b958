"""Node-partitioned message passing with a halo exchange.

Port of ``gnn_pretraining_tpu/parallel/node_partition.py``.
``edge_partition.edge_partitioned_aggregate`` sums a full ``[N, F]`` partial
over the ranks in every layer, whatever the cut. Here the node rows
themselves are split:

  * nodes are cut into ``n_dev`` contiguous ranges; rank d owns rows
    ``[d*n_loc, (d+1)*n_loc)`` of the activations, which are never
    replicated;
  * each edge lives on the rank that owns its receiver, so the masked
    ``index_add_`` writes only owned rows and the output needs no sum;
  * the only traffic is the halo: the sender rows that another rank's edges
    read. The host-side plan (``build_node_partition_plan``, numpy, array
    for array the JAX package's) lists them per (owner, reader) pair, padded
    to one ``h_pad``, and each layer exchanges them with one all-to-all
    (``DataAxis.all_to_all``);
  * each rank's edges are split into a local-sender list and a halo-sender
    list; the local partial needs nothing from the exchange;
  * bytes per rank per layer: ``2 (n_dev-1) h_pad F 4``, which shrink with
    the cut (``NodePartitionPlan.halo_bytes_per_layer``).

Exact: every edge adds its sender's row once to its receiver's owned row,
and the all-to-all's backward is the reverse exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnn_pretraining_tpu_torch.parallel.mesh import DataAxis


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


PLAN_ARRAYS = ("loc_senders", "loc_receivers", "loc_mask", "halo_senders",
               "halo_receivers", "halo_mask", "send_idx")


@dataclasses.dataclass(frozen=True)
class NodePartitionPlan:
    """Static (host-built) layout of one graph over ``n_dev`` ranks."""

    n_dev: int
    n_loc: int            # owned rows per rank (N padded to n_dev*n_loc)
    h_pad: int            # halo rows exchanged per rank pair
    num_nodes: int        # true N (rows beyond it are padding)
    # Per-rank edge lists, receivers local to [0, n_loc):
    loc_senders: np.ndarray    # [n_dev, E_loc]  sender ids local to the rank
    loc_receivers: np.ndarray  # [n_dev, E_loc]
    loc_mask: np.ndarray       # [n_dev, E_loc]
    halo_senders: np.ndarray   # [n_dev, E_hal]  row of the received halo buffer
    halo_receivers: np.ndarray  # [n_dev, E_hal]
    halo_mask: np.ndarray      # [n_dev, E_hal]
    # send_idx[d, q] = owned rows rank d ships to rank q (pad: row 0):
    send_idx: np.ndarray       # [n_dev, n_dev, h_pad]

    def halo_bytes_per_layer(self, feature_dim: int, bytes_per_el: int = 4) -> int:
        """Bytes moved per rank per layer (send + receive)."""
        return 2 * (self.n_dev - 1) * self.h_pad * feature_dim * bytes_per_el

    def psum_bytes_per_layer(self, feature_dim: int, bytes_per_el: int = 4) -> int:
        """What the full-[N, F] sum of the edge-partitioned path moves per
        rank (ring all-reduce), for comparison."""
        n = self.n_dev * self.n_loc
        return 2 * (self.n_dev - 1) * (n // self.n_dev) * feature_dim * bytes_per_el

    def rank_arrays(self, rank: int) -> tuple:
        """Rank ``rank``'s slices of the plan's arrays, in ``PLAN_ARRAYS``
        order."""
        return tuple(getattr(self, name)[rank] for name in PLAN_ARRAYS)


def build_node_partition_plan(senders, receivers, edge_mask, num_nodes: int,
                              n_dev: int, lane: int = 8) -> NodePartitionPlan:
    """Partition the edges by their receiver's owner and lay out the halo
    exchange. The halo order of each (reader, owner) pair is the order in
    which the reader's edges (by global edge index) first name each sender."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask)
    valid = edge_mask > 0
    n_loc = _round_up(max(num_nodes, n_dev), n_dev) // n_dev

    dev_edges = []   # (senders, receivers_local, mask, owner, rank) per reader
    needed = [[np.empty(0, np.int64)] * n_dev for _ in range(n_dev)]
    for d in range(n_dev):
        lo, hi = d * n_loc, (d + 1) * n_loc
        rows = np.nonzero(valid & (receivers >= lo) & (receivers < hi))[0]
        s = senders[rows]
        owner = s // n_loc
        rank = np.zeros(len(s), np.int32)  # position within the owner's block
        for p in np.unique(owner[owner != d]):
            sel = np.nonzero(owner == p)[0]
            uniq, first, inv = np.unique(s[sel], return_index=True, return_inverse=True)
            order = np.argsort(first, kind="stable")
            r_of = np.empty(len(uniq), np.int32)
            r_of[order] = np.arange(len(uniq), dtype=np.int32)
            rank[sel] = r_of[inv]
            needed[d][p] = uniq[order]
        dev_edges.append((s, receivers[rows] - lo, edge_mask[rows], owner, rank))

    h_pad = max(1, _round_up(
        max((len(needed[d][p]) for d in range(n_dev) for p in range(n_dev)), default=1),
        lane))

    # send_idx[p, d]: rows p owns that d reads, in d's halo order.
    send_idx = np.zeros((n_dev, n_dev, h_pad), np.int32)
    for d in range(n_dev):
        for p in range(n_dev):
            ids = needed[d][p]
            send_idx[p, d, :len(ids)] = ids.astype(np.int32) - p * n_loc

    loc_lists, hal_lists = [], []
    for d in range(n_dev):
        s, r, m, owner, rank = dev_edges[d]
        is_loc = owner == d
        pos = (owner * h_pad + rank).astype(np.int32)   # owner's block, then position
        loc_lists.append((s[is_loc] - d * n_loc, r[is_loc], m[is_loc]))
        hal_lists.append((pos[~is_loc], r[~is_loc], m[~is_loc]))

    def pad_stack(lists, width_lane=128):
        e_max = max(1, _round_up(max(len(a[0]) for a in lists), width_lane))
        out_s = np.zeros((n_dev, e_max), np.int32)
        out_r = np.zeros((n_dev, e_max), np.int32)
        out_m = np.zeros((n_dev, e_max), np.float32)
        for d, (s, r, m) in enumerate(lists):
            out_s[d, :len(s)] = s
            out_r[d, :len(r)] = r
            out_m[d, :len(m)] = m
        return out_s, out_r, out_m

    ls, lr, lm = pad_stack(loc_lists)
    hs, hr, hm = pad_stack(hal_lists)
    return NodePartitionPlan(
        n_dev=n_dev, n_loc=n_loc, h_pad=h_pad, num_nodes=num_nodes,
        loc_senders=ls, loc_receivers=lr, loc_mask=lm,
        halo_senders=hs, halo_receivers=hr, halo_mask=hm, send_idx=send_idx)


def halo_aggregate_local(h_loc: torch.Tensor, eps, ls, lr, lm, hs, hr, hm, send_idx,
                         axis: DataAxis) -> torch.Tensor:
    """This rank's share of the halo-exchange GIN aggregation: ``h_loc`` is
    its ``[n_loc, F]`` owned rows, the plan arrays its slices (tensors on
    ``h_loc``'s device). The send buffer ``h_loc[send_idx]`` goes through
    one all-to-all; the local-sender partial needs nothing from it."""
    n_loc, f = h_loc.shape
    halo = axis.all_to_all(h_loc[send_idx.long()])          # [n_dev, H, F]
    msgs_l = h_loc[ls.long()] * lm.to(h_loc.dtype)[:, None]
    partial = h_loc.new_zeros((n_loc, f)).index_add_(0, lr.long(), msgs_l)
    msgs_h = halo.reshape(-1, f)[hs.long()] * hm.to(h_loc.dtype)[:, None]
    partial = partial + h_loc.new_zeros((n_loc, f)).index_add_(0, hr.long(), msgs_h)
    return partial + (1.0 + eps) * h_loc


def plan_tensors(plan: NodePartitionPlan, rank: int, device) -> tuple:
    """Rank ``rank``'s plan slices as tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in plan.rank_arrays(rank))


def node_partitioned_aggregate(axis: DataAxis, h: torch.Tensor, plan: NodePartitionPlan,
                               eps) -> torch.Tensor:
    """``Σ_{j∈N(i)} h_j + (1+eps) h`` with the nodes and the edges split over
    the ranks: ``h`` is this rank's ``[n_loc, F]`` rows of the plan's
    ``[n_dev * n_loc, F]`` layout, or the whole of it (this rank's rows are
    taken); returns this rank's rows."""
    if h.shape[0] == plan.n_dev * plan.n_loc and plan.n_dev > 1:
        h = h[axis.rank * plan.n_loc:(axis.rank + 1) * plan.n_loc]
    return halo_aggregate_local(h, eps, *plan_tensors(plan, axis.rank, h.device), axis)


def pad_node_rows(h, plan: NodePartitionPlan):
    """Pad a [N, F] host array to the plan's [n_dev*n_loc, F] layout."""
    n_tot = plan.n_dev * plan.n_loc
    h = np.asarray(h)
    if h.shape[0] < n_tot:
        h = np.pad(h, ((0, n_tot - h.shape[0]), (0, 0)))
    return h
