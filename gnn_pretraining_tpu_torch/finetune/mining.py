"""Link-prediction hard-negative mining.

Port of ``gnn_pretraining_tpu/finetune/mining.py`` (reference
``LinkPredictionHardNegativeMiner``, src/finetune/finetune.py:45-106):
cosine-similarity matrix over node embeddings; candidates exclude existing
(undirected) train edges and the diagonal; ``num_hard = min(max(8, ⌊0.3·P⌋),
P, num_negatives)`` most-similar candidates are taken, the remainder sampled
uniformly without replacement from the rest by Gumbel top-k. The Gumbel noise
comes from an explicit ``torch.Generator`` or is handed in (``gumbel=``), so
a test can inject another implementation's draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnn_pretraining_tpu_torch import config
from gnn_pretraining_tpu_torch.ops.sddmm import cosine_similarity_matrix, l2_normalize
from gnn_pretraining_tpu_torch.ops.topk import exact_top_k

_NEG_INF = float("-inf")


def candidate_count(num_nodes: int, train_edges,
                    num_real_nodes: Optional[int] = None) -> int:
    """Number of candidate (ordered, non-self, non-edge) pairs.

    ``num_real_nodes`` (≤ ``num_nodes``) counts only un-padded rows: pairs
    that touch a padding row are not candidates."""
    n = num_nodes if num_real_nodes is None else num_real_nodes
    te = np.asarray(train_edges)
    pairs = {(int(u), int(v)) for u, v in te.T}
    pairs |= {(v, u) for u, v in pairs}
    pairs -= {(u, u) for u, _ in pairs}
    return n * n - n - len(pairs)


def hard_count(num_candidates: int, num_negatives: int) -> int:
    """The reference's num_hard formula (:69-70)."""
    nh = max(config.MIN_HARD_NEGATIVES,
             int(num_candidates * config.HARD_NEGATIVE_RATIO))
    return min(nh, num_candidates, num_negatives)


def build_forbidden_mask(num_nodes: int, train_edges,
                         node_mask=None) -> torch.Tensor:
    """[N, N] bool on the CPU: undirected train edges + diagonal (reference
    :53-59), plus every pair that touches a padding row of ``node_mask``."""
    m = np.zeros((num_nodes, num_nodes), bool)
    te = np.asarray(train_edges)
    if te.size:
        m[te[0], te[1]] = True
        m[te[1], te[0]] = True
    np.fill_diagonal(m, True)
    if node_mask is not None:
        pad = np.asarray(node_mask) == 0
        m[pad, :] = True
        m[:, pad] = True
    return torch.from_numpy(m)


def sample_gumbel(size: int, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u in [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(size, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _noise(gumbel, size, generator, device) -> torch.Tensor:
    if gumbel is not None:
        if gumbel.numel() != size:
            raise ValueError(f"gumbel has {gumbel.numel()} entries, need {size}")
        return gumbel.to(device).reshape(-1)
    if generator is None:
        raise ValueError("the uniform remainder needs a generator or gumbel=")
    return sample_gumbel(size, generator, device)


def mine_hard_negatives(embeddings: torch.Tensor, forbidden: torch.Tensor,
                        num_negatives: int, num_hard: int, *,
                        generator: Optional[torch.Generator] = None,
                        gumbel: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``num_hard`` most-similar allowed pairs + a uniform remainder.

    ``embeddings`` [N, H] (no grad), ``forbidden`` [N, N] bool. ``gumbel``
    ([N·N], optional) replaces the generator's draw for the remainder.
    Returns (senders, receivers), each [num_negatives] int32."""
    n = embeddings.shape[0]
    if n >= config.STREAMING_MINER_MIN_NODES:
        return mine_hard_negatives_streaming(
            embeddings, forbidden, num_negatives, num_hard,
            generator=generator, gumbel=gumbel)
    sim = cosine_similarity_matrix(embeddings)
    masked = sim.masked_fill(forbidden, _NEG_INF).reshape(-1)
    _, hard_idx = exact_top_k(masked, num_hard)

    num_rand = num_negatives - num_hard
    if num_rand > 0:
        # Uniform without replacement over allowed minus hard: Gumbel top-k.
        # Both orientations of each hard pair leave the pool, as in the
        # reference (finetune.py:84-86 clears [src,dst] AND [dst,src]).
        noise = _noise(gumbel, n * n, generator, embeddings.device)
        rev_idx = (hard_idx % n) * n + hard_idx // n
        taken = forbidden.reshape(-1).clone()
        taken[hard_idx] = True
        taken[rev_idx] = True
        _, rand_idx = exact_top_k(noise.masked_fill(taken, _NEG_INF), num_rand)
        idx = torch.cat([hard_idx, rand_idx])
    else:
        idx = hard_idx
    return (idx // n).to(torch.int32), (idx % n).to(torch.int32)


def mine_hard_negatives_streaming(embeddings: torch.Tensor,
                                  forbidden: torch.Tensor,
                                  num_negatives: int, num_hard: int, *,
                                  generator: Optional[torch.Generator] = None,
                                  gumbel: Optional[torch.Tensor] = None,
                                  row_block: int = 512
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same miner without the [N, N] similarity matrix.

    Row blocks of the masked similarity matrix are formed one at a time and
    reduced at once to their top-``num_hard`` entries, so peak memory is
    O(row_block·N). Every global winner is a winner of its own block, so the
    hard set equals the dense path's. The uniform remainder streams too:
    per-block Gumbel noise over allowed slots (hard slots included), a global
    top-(``num_rand + 2·num_hard``) pool, then collisions with the hard set in
    either orientation are dropped and the first ``num_rand`` survivors kept;
    ranking i.i.d. Gumbels is a uniform permutation and deleting elements
    leaves a uniform permutation of the rest, so the distribution is the dense
    path's (the sampled set for a given generator state is not). ``gumbel``
    ([ceil(N/row_block)·row_block·N], optional) replaces the draws."""
    n = embeddings.shape[0]
    device = embeddings.device
    z = l2_normalize(embeddings)
    nb = -(-n // row_block)
    num_rand = num_negatives - num_hard
    num_cand = num_rand + 2 * num_hard
    kk = min(num_hard, row_block * n)
    gk = min(num_cand, row_block * n)
    noise = None
    if num_rand > 0 and gumbel is not None:
        noise = _noise(gumbel, nb * row_block * n, None, device).view(nb, -1)

    hard_v, hard_i, rand_v, rand_i = [], [], [], []
    for b in range(nb):
        r0 = b * row_block
        rows = min(row_block, n - r0)
        fb = torch.ones(row_block, n, dtype=torch.bool, device=device)
        fb[:rows] = forbidden[r0:r0 + rows]
        sim = torch.full((row_block, n), _NEG_INF, device=device)
        sim[:rows] = z[r0:r0 + rows] @ z.t()
        v, i = torch.topk(sim.masked_fill(fb, _NEG_INF).reshape(-1), kk)
        hard_v.append(v)
        hard_i.append(i)
        if num_rand > 0:
            g = (noise[b] if noise is not None
                 else _noise(None, row_block * n, generator, device))
            v, i = torch.topk(g.masked_fill(fb.reshape(-1), _NEG_INF), gk)
            rand_v.append(v)
            rand_i.append(i)

    def decode(flat_sel, local, per_block):
        """[nb·per_block] winners → global (row, col) of the selections."""
        blk = flat_sel // per_block
        loc = local[flat_sel]
        return blk * row_block + loc // n, loc % n

    _, sel = torch.topk(torch.cat(hard_v), num_hard)
    hr, hc = decode(sel, torch.cat(hard_i), kk)
    if num_rand > 0:
        _, gsel = torch.topk(torch.cat(rand_v), num_cand)  # Gumbel descending
        rr, rc = decode(gsel, torch.cat(rand_i), gk)
        collide = (((rr[:, None] == hr[None, :]) & (rc[:, None] == hc[None, :]))
                   | ((rr[:, None] == hc[None, :]) & (rc[:, None] == hr[None, :]))
                   ).any(dim=1)
        keep = torch.argsort(collide.to(torch.int32), stable=True)[:num_rand]
        hr = torch.cat([hr, rr[keep]])
        hc = torch.cat([hc, rc[keep]])
    return hr.to(torch.int32), hc.to(torch.int32)
