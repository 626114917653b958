"""Export a checkpoint as a serving artifact (``serving.export_serving``).

The port's counterpart of ``scripts/export_model.py``. Reads a fine-tune
checkpoint of either package (``finetune/model_<run>.msgpack``), bakes its
weights into the eval-mode inference function of one padded serving bucket,
one program per platform, and writes the artifact; ``serving.load_artifact``
replays it without the model code:

  python -m gnn_pretraining_tpu_torch.export_model \\
      --checkpoint outputs/torch/finetune/model_Cora_NC_full_finetune_b1_42.msgpack \\
      --domain_name Cora_NC --num_nodes 2712 --num_edges 10560 \\
      --out outputs/torch/serving/Cora_NC_b1.pt2 --platforms cuda,cpu

``--platforms cpu`` exports on a machine without a card. A pretrain
checkpoint exports only with ``--embed --domain_name ENZYMES``, through the
transfer contract (backbone, and the ENZYMES encoder); anything else from a
pretrain checkpoint is refused: fine-tune first.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gnn_pretraining_tpu_torch import config, serving
from gnn_pretraining_tpu_torch.models.finetune_model import FinetuneGNN
from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint
from gnn_pretraining_tpu_torch.utils.convert import (
    load_pretrained_into_finetune,
    variables_to_state_dict,
)
from gnn_pretraining_tpu_torch.utils.device import resolve_device


def bucket_example(domain: str, num_nodes: int, num_edges: int, num_graphs: int = 1,
                   num_score_edges: int = 256) -> dict:
    """Zero-filled inputs of a serving bucket: the shapes and dtypes that fix
    the exported program."""
    n, e = num_nodes, num_edges
    example = {"x": np.zeros((n, config.DOMAIN_DIMENSIONS[domain]), np.float32),
               "node_mask": np.ones(n, np.float32),
               "senders": np.zeros(e, np.int32),
               "receivers": np.zeros(e, np.int32),
               "edge_mask": np.ones(e, np.float32)}
    task_type = config.TASK_TYPES[domain]
    if task_type == "graph_classification":
        example["node_graph"] = np.zeros(n, np.int32)
        example["num_graphs"] = num_graphs
    elif task_type == "link_prediction":
        example["score_senders"] = np.zeros(num_score_edges, np.int32)
        example["score_receivers"] = np.zeros(num_score_edges, np.int32)
    return example


def load_model(checkpoint, domain: str, aggregation: str, embed: bool,
               device) -> FinetuneGNN:
    """A ``FinetuneGNN`` on ``device`` with the weights of a fine-tune
    checkpoint, or, for ``embed`` on ENZYMES, those a pretrain checkpoint
    transfers; ``SystemExit`` for any other use of a pretrain checkpoint."""
    ckpt = load_checkpoint(checkpoint)
    pretrained = "input_encoder" not in ckpt["params"]
    if pretrained and (not embed or domain != "ENZYMES"):
        # A pretrain checkpoint (per-domain encoders): only the transfer
        # contract's part of it reaches a fine-tune model (backbone always,
        # the encoder only for ENZYMES); the rest would be a fresh init,
        # fine for embeddings of ENZYMES and meaningless otherwise.
        raise SystemExit(
            "pretrain checkpoints export only with --embed and "
            "--domain_name ENZYMES (no transferred encoder/head exists "
            "for other domains); fine-tune first for task serving")
    model = FinetuneGNN(domain, aggregation, device=device)
    state = variables_to_state_dict({"params": ckpt["params"],
                                     "batch_stats": ckpt["batch_stats"]})
    if pretrained:
        state = load_pretrained_into_finetune(model.state_dict(), state, domain)
    model.load_state_dict(state)
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--domain_name", required=True, choices=sorted(config.TASK_TYPES))
    p.add_argument("--out", required=True)
    p.add_argument("--num_nodes", type=int, required=True,
                   help="padded node count of the serving bucket")
    p.add_argument("--num_edges", type=int, required=True,
                   help="padded (directed) message-passing edge count")
    p.add_argument("--num_graphs", type=int, default=1,
                   help="padded graph count (graph classification)")
    p.add_argument("--num_score_edges", type=int, default=256,
                   help="edges scored per call (link prediction)")
    p.add_argument("--aggregation", default="coo", choices=["coo", "dense"])
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated, of cuda and cpu")
    p.add_argument("--embed", action="store_true",
                   help="export node embeddings (encoder+backbone) instead "
                        "of task outputs")
    args = p.parse_args(argv)
    platforms = tuple(args.platforms.split(","))
    # The card when a cuda program is asked for (raises without one).
    device = resolve_device(None if "cuda" in platforms else "cpu")
    model = load_model(args.checkpoint, args.domain_name, args.aggregation, args.embed,
                       device)
    example = bucket_example(args.domain_name, args.num_nodes, args.num_edges,
                             args.num_graphs, args.num_score_edges)
    blob = serving.export_serving(model, example, platforms=platforms,
                                  embed_only=args.embed)
    serving.save_artifact(args.out, blob)
    print(f"Wrote {args.out} ({len(blob) / 1e6:.2f} MB, platforms={args.platforms}, "
          f"bucket N={args.num_nodes} E={args.num_edges}"
          f"{', embeddings' if args.embed else ''})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
