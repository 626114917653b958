#!/usr/bin/env python3
"""Data parallelism and partitioned fine-tuning over every card of one host,
on NCCL.

    python3 tools/dp_cards.py

chip_smoke.py's dp phase (12c) with one rank per card instead of two gloo
ranks on one: the s5 data-parallel step (each rank's K1 and K2 launches, its
losses and gradients against one process stepping on the union of the
ranks' shares with the same draws, kinks and keep-masks, the ranks bitwise
equal after two steps, the step's CUDA-event median beside the single
process's), the ENZYMES graph-classification step and eval step, then
``run_pretrain --dp auto`` with no launcher, which starts one rank per card
(``parallel.mesh.spawn_local_ranks``). Then its partition phase (12d) the
same way: the edge- and node-partitioned Cora_NC and Cora_LP steps against
one process's ``coo`` steps, the 6x store's step medians, halo and psum
bytes and the all-to-all on its native NCCL route, and ``run_finetune
--partition edge`` and ``--partition node`` with no launcher (one rank per
card, dropout off) against ``--partition none``. Needs two or more cards;
prints one JSON line per check and exits non-zero when one fails.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def main() -> int:
    card = chip_smoke.device_phase()
    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"tools/dp_cards.py needs two or more cards, this host has {cards}")
    chip_smoke.import_port()
    chip_smoke.build_phase()
    with tempfile.TemporaryDirectory(prefix="dp_cards_") as tmp:
        processed, entry, resume = (Path(tmp) / d for d in ("processed", "entry", "resume"))
        for d in (processed, entry, resume):
            d.mkdir()
        chip_smoke.write_stores(processed)
        chip_smoke.write_pretrain_stores(processed, entry)
        chip_smoke.resume_stores(resume)
        launches = chip_smoke.dp_phase(torch.device("cuda"), processed, resume,
                                       Path(tmp) / "dp", card, n=cards, backend="nccl")
        partition = chip_smoke.partition_phase(torch.device("cuda"), processed,
                                               Path(tmp) / "partition", card, n=cards,
                                               backend="nccl")
    chip_smoke.emit({"phase": "dp_cards", "cards": cards, "launches": launches,
                     "partition_launches": partition, "ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
