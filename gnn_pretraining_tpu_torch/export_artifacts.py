"""Export a finished sweep's durable artifacts, with a checksummed manifest.

The port's counterpart of ``scripts/export_artifacts.py``:

    python -m gnn_pretraining_tpu_torch.export_artifacts [--seeds 42] \\
        [--out_root outputs/torch] [--artifacts_dir outputs/torch/artifacts] \\
        [--platforms cuda,cpu] [--processed_dir data/processed] [--no_serving]

From the sweep's outputs under ``--out_root`` (``pretrain/`` and
``finetune/``) it writes under ``--artifacts_dir`` (default
``config.OUTPUT_DIR / "artifacts"``, i.e. ``outputs/torch/artifacts/``):

  transfer/backbone_<scheme>_<seed>.msgpack
      the fp16 transfer subtrees (backbone, BN statistics, the ENZYMES
      encoder) of every scheme's pretrain checkpoint at ``--seeds``
      (``utils/checkpoint.save_transfer_artifact``), which both packages read;
  serving/<domain>_<scheme>.pt2
      one serving artifact per task family of ``SERVING_CELLS`` from its
      fine-tune checkpoint (``serving.export_serving``: one ``torch.export``
      program per platform of ``--platforms``), at the padded bucket of the
      domain's first test batch (graph) or its whole graph (node, link);
  serving/<domain>_embed_<scheme>.pt2
      node embeddings from a pretrain checkpoint (``EMBED_DOMAINS_SCHEMES``),
      through the transfer contract;
  MANIFEST.json
      sha256, bytes and provenance (source checkpoint, epoch, val metrics,
      bucket) of each artifact, keyed by its path under the root, in the
      layout of the JAX package's ``artifacts/MANIFEST.json``; merged with
      the one already there, entries whose file is gone pruned.

A checkpoint that is missing is reported and skipped. It never writes under
``config.ARTIFACTS_DIR``, the JAX package's tracked tree. Exporting a cuda
program needs the card; ``--platforms cpu`` runs on a machine without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from gnn_pretraining_tpu_torch import config, serving
from gnn_pretraining_tpu_torch.data.loaders import create_finetune_arrays
from gnn_pretraining_tpu_torch.export_model import load_model
from gnn_pretraining_tpu_torch.utils.checkpoint import load_checkpoint, save_transfer_artifact
from gnn_pretraining_tpu_torch.utils.device import resolve_device

# One fine-tune cell per task family, as the JAX package's exporter takes
# them: scheme b2, seed 42, full_finetune.
SERVING_CELLS = (
    ("ENZYMES", "full_finetune", "b2", 42),
    ("Cora_NC", "full_finetune", "b2", 42),
    ("Cora_LP", "full_finetune", "b2", 42),
)

# Embeddings straight from a pretrain checkpoint: only ENZYMES has a
# transferred encoder.
EMBED_DOMAINS_SCHEMES = (("ENZYMES", "b2"),)

MANIFEST = "MANIFEST.json"
SUFFIX = ".pt2"


def default_root() -> Path:
    return config.OUTPUT_DIR / "artifacts"


def check_root(root: Path) -> Path:
    """``root`` resolved; ``SystemExit`` when it is, or lies under, the JAX
    package's tracked ``config.ARTIFACTS_DIR``."""
    root = Path(root).resolve()
    tracked = config.ARTIFACTS_DIR.resolve()
    if root == tracked or tracked in root.parents:
        raise SystemExit(f"{root} is the JAX package's tracked artifacts tree; the port "
                         f"writes its own (default {default_root()})")
    return root


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def file_entry(root: Path, path: Path, **provenance) -> tuple:
    """(manifest key, entry) of one written artifact."""
    return (str(path.relative_to(root)),
            {"sha256": sha256(path), "bytes": path.stat().st_size, **provenance})


def export_transfer(out_root: Path, root: Path, seeds, manifest: dict) -> int:
    n = 0
    for scheme in config.ALL_SCHEMES:
        for seed in seeds:
            src = out_root / "pretrain" / f"model_{scheme}_{seed}.msgpack"
            if not src.exists():
                print(f"  skip {scheme}_{seed}: {src} missing")
                continue
            ckpt = load_checkpoint(src)
            meta = dict(ckpt.get("meta", {}))
            meta.update(scheme=scheme, seed=seed)
            dst = root / "transfer" / f"backbone_{scheme}_{seed}.msgpack"
            save_transfer_artifact(dst, ckpt["params"], ckpt["batch_stats"], meta)
            key, entry = file_entry(root, dst, source=str(src), epoch=meta.get("epoch"),
                                    val_metrics=meta.get("val_metrics", {}))
            manifest[key] = entry
            print(f"  {dst.name}: {entry['bytes'] / 1e6:.2f} MB (epoch {meta.get('epoch')})")
            n += 1
    return n


def serving_example(domain: str, processed_dir, embed: bool = False) -> dict:
    """The inputs that fix an artifact's bucket: the domain's first test
    batch (graph classification, and embeddings) or its whole graph (node,
    link), as numpy arrays."""
    data = create_finetune_arrays(domain, "test", config.FINETUNE_BATCH_SIZES[domain],
                                  processed_dir)
    task_type = config.TASK_TYPES[domain]
    b = data.batches[0] if task_type == "graph_classification" else data.graph
    example = {"x": b.x.numpy().astype(np.float32),
               "node_mask": b.node_mask.numpy().astype(np.float32),
               "senders": b.senders.numpy().astype(np.int32),
               "receivers": b.receivers.numpy().astype(np.int32),
               "edge_mask": b.edge_mask.numpy().astype(np.float32)}
    if embed:
        return example
    if task_type == "graph_classification":
        example["node_graph"] = b.node_graph.numpy().astype(np.int32)
        example["num_graphs"] = int(b.graph_mask.shape[0])
    elif task_type == "link_prediction":
        ne = data.edges[0].shape[1]
        example["score_senders"] = np.zeros(ne, np.int32)
        example["score_receivers"] = np.zeros(ne, np.int32)
    return example


def bucket(example: dict) -> dict:
    return {"num_nodes": int(example["x"].shape[0]), "num_edges": int(example["senders"].shape[0])}


def export_serving_artifacts(out_root: Path, root: Path, processed_dir, platforms, device,
                             manifest: dict) -> int:
    n = 0
    for domain, strategy, scheme, seed in SERVING_CELLS:
        run = f"{domain}_{strategy}_{scheme}_{seed}"
        src = out_root / "finetune" / f"model_{run}.msgpack"
        if not src.exists():
            print(f"  skip {run}: {src} missing")
            continue
        example = serving_example(domain, processed_dir)
        model = load_model(src, domain, "coo", False, device)
        dst = root / "serving" / f"{domain}_{scheme}{SUFFIX}"
        serving.save_artifact(dst, serving.export_serving(model, example, platforms=platforms))
        extra = ({"score_edges": int(example["score_senders"].shape[0])}
                 if config.TASK_TYPES[domain] == "link_prediction" else {})
        key, entry = file_entry(root, dst, source=str(src), bucket=bucket(example), **extra)
        manifest[key] = entry
        print(f"  {dst.name}: {entry['bytes'] / 1e6:.2f} MB")
        n += 1
    return n


def export_embed_artifacts(out_root: Path, root: Path, seeds, processed_dir, platforms, device,
                           manifest: dict) -> int:
    """Embedding artifacts from pretrain checkpoints (there as soon as a
    scheme's pretrain is, before any fine-tune cell): a fresh fine-tune
    model filled by the transfer contract, as ``export_model --embed``."""
    n = 0
    for (domain, scheme), seed in ((ds, sd) for ds in EMBED_DOMAINS_SCHEMES for sd in seeds):
        src = out_root / "pretrain" / f"model_{scheme}_{seed}.msgpack"
        if not src.exists():
            print(f"  skip embed {scheme}_{seed}: {src} missing")
            continue
        example = serving_example(domain, processed_dir, embed=True)
        meta = dict(load_checkpoint(src).get("meta", {}))
        model = load_model(src, domain, "coo", True, device)
        dst = root / "serving" / f"{domain}_embed_{scheme}{SUFFIX}"
        serving.save_artifact(dst, serving.export_serving(model, example, platforms=platforms,
                                                          embed_only=True))
        key, entry = file_entry(root, dst, source=str(src), domain=domain, embed=True,
                                epoch=meta.get("epoch"), val_metrics=meta.get("val_metrics", {}),
                                bucket=bucket(example))
        manifest[key] = entry
        print(f"  {dst.name}: {entry['bytes'] / 1e6:.2f} MB (embeddings)")
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[42])
    p.add_argument("--out_root", default=str(config.OUTPUT_DIR),
                   help="the sweep's output root, holding pretrain/ and finetune/")
    p.add_argument("--artifacts_dir", default=None,
                   help=f"where to write (default {default_root()}); never the JAX "
                        "package's tracked artifacts/")
    p.add_argument("--processed_dir", default=None,
                   help="the stores whose test split fixes the serving buckets "
                        "(default: data/processed)")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated, of cuda and cpu: a program for each")
    p.add_argument("--no_serving", action="store_true",
                   help="transfer artifacts only (no stores needed)")
    args = p.parse_args(argv)
    root = check_root(args.artifacts_dir or default_root())
    out_root = Path(args.out_root)
    platforms = tuple(args.platforms.split(","))

    manifest_path = root / MANIFEST
    manifest = json.loads(manifest_path.read_text()) if manifest_path.exists() else {}

    print("transfer artifacts:")
    nt = export_transfer(out_root, root, args.seeds, manifest)
    ns = 0
    if not args.no_serving:
        # The card when a cuda program is asked for (raises without one).
        device = resolve_device(None if "cuda" in platforms else "cpu")
        print("serving artifacts:")
        ns = export_serving_artifacts(out_root, root, args.processed_dir, platforms, device,
                                      manifest)
        ns += export_embed_artifacts(out_root, root, args.seeds, args.processed_dir, platforms,
                                     device, manifest)

    root.mkdir(parents=True, exist_ok=True)
    # The manifest is merged across runs: drop what was deleted or renamed,
    # or a stale key would stay for ever.
    for key in [k for k in manifest if not (root / k).exists()]:
        del manifest[key]
        print(f"  pruned stale manifest entry {key}")
    manifest_path.write_text(json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    print(f"wrote {nt} transfer + {ns} serving artifacts; manifest at {manifest_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
