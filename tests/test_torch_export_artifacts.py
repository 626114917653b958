"""The port's artifact exporter (``python -m
gnn_pretraining_tpu_torch.export_artifacts``) on the CPU.

On tiny seeded stores (ENZYMES 24 graphs, Cora 60 nodes) and checkpoints of
random one-layer port models (fine-tune cells ENZYMES, Cora_NC, Cora_LP
under b2 seed 42; pretrain b2 and s2 under seed 42), ``main(argv)`` with
``--platforms cpu`` writes under a temporary root. Held here:

  * the manifest's keys and each entry's fields are those of the tracked
    ``artifacts/MANIFEST.json`` that the JAX package's exporter wrote (its
    artifact names with the port's ``.pt2`` in place of ``.stablehlo``);
    sha256 and bytes recomputed from the files;
  * each serving artifact replays its eager model bitwise, at the bucket
    of the store's test split;
  * a transfer artifact reads in both packages as the checkpoint's
    transfer subtrees in fp16;
  * a second run merges into the manifest and prunes the entry of a file
    that is gone; a missing checkpoint is skipped;
  * the JAX package's tracked ``artifacts/`` is refused, and the default
    root is the port's own, under its git-ignored output root.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_pretraining_tpu.utils.checkpoint import load_transfer_artifact as jax_load_transfer
from gnn_pretraining_tpu_torch import FinetuneGNN, config, export_artifacts, serving
from gnn_pretraining_tpu_torch.data.synthetic import (
    synthetic_planetoid_stores,
    synthetic_pretrain_store,
)
from gnn_pretraining_tpu_torch.serving import make_embedding_fn, make_serving_fn
from gnn_pretraining_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_transfer_artifact,
    save_checkpoint,
)
from gnn_pretraining_tpu_torch.utils.convert import state_dict_to_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TRACKED = json.loads((config.ARTIFACTS_DIR / "MANIFEST.json").read_text())
CELLS = ("ENZYMES", "Cora_NC", "Cora_LP")


def save_model(path, model, epoch, pretrain=False):
    state = model.state_dict()
    if pretrain:    # the transfer contract's part, keyed as a pretrain model's
        state = {k.replace("input_encoder.", "input_encoders.ENZYMES.", 1): v
                 for k, v in state.items()
                 if k.startswith(("gnn_backbone.", "input_encoder."))}
    variables = state_dict_to_variables(state)
    save_checkpoint(path, variables["params"], variables["batch_stats"], epoch,
                    {"val/loss/total": 0.25 * epoch})


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = export_artifacts.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export_artifacts")
    stores, out_root, root = tmp / "processed", tmp / "out", tmp / "artifacts"
    stores.mkdir()
    rng = np.random.default_rng(5)
    synthetic_pretrain_store("ENZYMES", rng, num_graphs=24).save(stores / "ENZYMES.npz")
    for name, store in synthetic_planetoid_stores("Cora", rng, 60, 120, 20, 10, 20).items():
        store.save(stores / f"{name}.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "GNN_NUM_LAYERS", 1)
        torch.manual_seed(0)
        models = {d: FinetuneGNN(d, "coo", device="cpu").eval() for d in CELLS}
        for d, model in models.items():
            save_model(out_root / "finetune" / f"model_{d}_full_finetune_b2_42.msgpack", model, 3)
        for scheme, epoch in (("b2", 4), ("s2", 5)):
            save_model(out_root / "pretrain" / f"model_{scheme}_42.msgpack",
                       FinetuneGNN("ENZYMES", "coo", device="cpu"), epoch, pretrain=True)
        argv = ["--out_root", str(out_root), "--artifacts_dir", str(root),
                "--processed_dir", str(stores), "--platforms", "cpu", "--seeds", "42"]
        first = run(argv)
        manifest = json.loads((root / "MANIFEST.json").read_text())
        embed_model = FinetuneGNN("ENZYMES", "coo", device="cpu").eval()
        embed_model.load_state_dict(export_artifacts.load_model(
            out_root / "pretrain" / "model_b2_42.msgpack", "ENZYMES", "coo", True,
            torch.device("cpu")).state_dict())
        yield {"first": first, "manifest": manifest, "root": root, "out_root": out_root,
               "stores": stores, "argv": argv, "models": models, "embed_model": embed_model}


def kind(key: str, entry: dict) -> str:
    if key.startswith("transfer/"):
        return "transfer"
    if entry.get("embed"):
        return "embed"
    return "link" if "score_edges" in entry else "serving"


def test_manifest_layout_equals_the_tracked_one(exported):
    got, want = exported["manifest"], TRACKED
    stems = {k.rsplit(".", 1)[0] for k in want if k.startswith("serving/")}
    assert {k.rsplit(".", 1)[0] for k in got if k.startswith("serving/")} == stems
    assert all(k.endswith(export_artifacts.SUFFIX) for k in got if k.startswith("serving/"))
    assert {k for k in got if k.startswith("transfer/")} == {
        "transfer/backbone_b2_42.msgpack", "transfer/backbone_s2_42.msgpack"}
    fields = {}
    for key, entry in want.items():
        fields.setdefault(kind(key, entry), set(entry))
    assert {kind(k, e): set(e) for k, e in got.items()} == fields
    embed = got["serving/ENZYMES_embed_b2.pt2"]
    assert embed["epoch"] == 4 and embed["val_metrics"] == {"val/loss/total": 1.0}
    assert embed["domain"] == "ENZYMES" and embed["embed"] is True
    assert got["transfer/backbone_s2_42.msgpack"]["source"] == str(
        exported["out_root"] / "pretrain" / "model_s2_42.msgpack")
    assert exported["first"][0] == 0
    assert "wrote 2 transfer + 4 serving artifacts" in exported["first"][1]


def test_manifest_hashes_and_bytes_are_the_files(exported):
    root = exported["root"]
    files = {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}
    assert files == set(exported["manifest"]) | {"MANIFEST.json"}
    for key, entry in exported["manifest"].items():
        data = (root / key).read_bytes()
        assert entry["bytes"] == len(data), key
        assert entry["sha256"] == hashlib.sha256(data).hexdigest(), key


@pytest.mark.parametrize("name", ["ENZYMES_b2", "Cora_NC_b2", "Cora_LP_b2", "ENZYMES_embed_b2"])
def test_serving_artifacts_replay_their_eager_model(exported, name):
    """At the bucket the manifest records, on the store's own test batch."""
    entry = exported["manifest"][f"serving/{name}.pt2"]
    domain = name.split("_embed")[0].replace("_b2", "")
    embed = entry.get("embed", False)
    example = export_artifacts.serving_example(domain, exported["stores"], embed=embed)
    assert entry["bucket"] == export_artifacts.bucket(example)
    served = serving.load_artifact(exported["root"] / f"serving/{name}.pt2", device="cpu")
    if embed:
        eager, names = make_embedding_fn(exported["embed_model"])
    else:
        eager, names = make_serving_fn(exported["models"][domain])
        if config.TASK_TYPES[domain] == "graph_classification":
            eager = eager(example["num_graphs"])
    rng = np.random.default_rng(1)
    for key in ("score_senders", "score_receivers"):
        if key in example:
            example[key] = rng.integers(0, entry["bucket"]["num_nodes"],
                                        example[key].shape).astype(np.int32)
    args = [torch.from_numpy(np.asarray(example[k])) for k in names]
    with torch.no_grad():
        np.testing.assert_array_equal(served(*args).numpy(), eager(*args).numpy())


def test_transfer_artifacts_read_in_both_packages(exported):
    path = exported["root"] / "transfer" / "backbone_s2_42.msgpack"
    ckpt = load_checkpoint(exported["out_root"] / "pretrain" / "model_s2_42.msgpack")
    port, jax = load_transfer_artifact(path), jax_load_transfer(path)
    assert port["meta"]["epoch"] == jax["meta"]["epoch"] == 5.0
    assert port["meta"]["scheme"] == "s2" and jax["meta"]["seed"] == 42

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items()
                    for k2, v in flat(sub, f"{prefix}{k}/").items()}
        return {prefix: np.asarray(tree)}

    want = flat({k: ckpt["params"][k] for k in ("gnn_backbone", "input_encoders_ENZYMES")})
    for tree in (port["params"], jax["params"]):
        got = flat(tree)
        assert got.keys() == want.keys()
        for k, v in want.items():
            expect = v.astype(np.float16).astype(np.float32) if v.dtype == np.float32 else v
            np.testing.assert_array_equal(np.asarray(got[k]), expect, err_msg=k)


def test_a_second_run_merges_and_prunes(exported, tmp_path):
    """Rerun on a copy with seed 84 asked for (no such checkpoint), after
    one artifact was deleted: the entries whose files stay are kept, the
    deleted one's and an unknown one's are pruned, the missing checkpoint
    is reported."""
    root = tmp_path / "again"
    shutil.copytree(exported["root"], root)
    (root / "transfer" / "backbone_b2_42.msgpack").unlink()
    manifest = {**exported["manifest"], "serving/gone_b2.pt2": {"sha256": "0", "bytes": 0}}
    (root / "MANIFEST.json").write_text(json.dumps(manifest))
    rc, out = run([*exported["argv"][:2], "--artifacts_dir", str(root), "--seeds", "84",
                   "--no_serving"])
    assert rc == 0 and "skip b2_84:" in out
    assert "pruned stale manifest entry serving/gone_b2.pt2" in out
    want = {k: v for k, v in exported["manifest"].items()
            if k != "transfer/backbone_b2_42.msgpack"}
    assert json.loads((root / "MANIFEST.json").read_text()) == want


@pytest.mark.parametrize("where", ["root", "under"])
def test_the_tracked_tree_is_refused(where, tmp_path):
    target = config.ARTIFACTS_DIR / ("" if where == "root" else "transfer")
    before = sorted((p.name, p.stat().st_mtime_ns) for p in config.ARTIFACTS_DIR.rglob("*"))
    with pytest.raises(SystemExit, match="tracked"):
        export_artifacts.main(["--out_root", str(tmp_path), "--artifacts_dir", str(target),
                               "--no_serving"])
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in config.ARTIFACTS_DIR.rglob("*")) == before


def test_the_default_root_is_the_ports_git_ignored_own():
    root = export_artifacts.default_root()
    assert root == config.OUTPUT_DIR / "artifacts"
    assert config.ARTIFACTS_DIR not in (root, *root.parents)
    ignored = (REPO / ".gitignore").read_text().split()
    assert "outputs/" in ignored and root.relative_to(REPO).parts[0] == "outputs"
