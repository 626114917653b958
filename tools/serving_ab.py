#!/usr/bin/env python3
"""Whether the port's eager serving forwards got slower with ServingModule,
or after the work of chip_smoke.py's artifacts phase, on one CUDA card.

    python3 tools/serving_ab.py [--out results.jsonl]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the port's kernels and, at chip_smoke.py's four serving buckets
(ENZYMES embeddings and graph logits, Cora node logits and link
probabilities, all on K1), times two versions of the same forward:

  * P: the closures make_serving_fn built before ServingModule (copied
    below, as they were);
  * C: serving.make_serving_fn / make_embedding_fn over ServingModule.

It builds the kernels once, then runs six processes in turn: fresh, after,
fresh, after, fresh, after. An "after"
process first does what the artifacts phase leaves behind in its process:
a torch.export program exported, loaded and called on the card, a
torch.profiler session around one call, and anomaly mode switched on and
off. Each process checks that P and C agree (a relative 1e-5: the scatter
of graph pooling adds in the order its atomics land), times 5 rounds of
P C C P per bucket (chip_smoke.median_ms: CUDA events around 30 calls made
back to back, the host included) and prints the min and median per
version, then profiles C (chip_smoke.profile_phase: device busy time and
kernels per call). Each line carries the card's name and power limit;
with --out, the timing lines are also appended to that file.

Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("fresh", "after") * 3
DEVICE = "cuda"


def parent_forwards(models, enz, cora, score, graph):
    """The eager forwards as make_serving_fn / make_embedding_fn built them
    before ServingModule: one closure per task, under inference mode."""
    import torch

    from gnn_pretraining_tpu_torch.serving import _graph_kwargs

    model = models["ENZYMES"].eval()

    @torch.inference_mode()
    def embed(x, node_mask, senders, receivers, edge_mask):
        return model.embed(x, node_mask, **_graph_kwargs(model, x, senders, receivers,
                                                         edge_mask))

    @torch.inference_mode()
    def gc(x, node_mask, senders, receivers, edge_mask, node_graph):
        return model(x, node_mask, node_graph=node_graph, num_graphs=enz.num_graphs,
                     **_graph_kwargs(model, x, senders, receivers, edge_mask))

    nc_model, lp_model = models["Cora_NC"].eval(), models["Cora_LP"].eval()

    @torch.inference_mode()
    def nc(x, node_mask, senders, receivers, edge_mask):
        return nc_model(x, node_mask, **_graph_kwargs(nc_model, x, senders, receivers,
                                                      edge_mask))

    @torch.inference_mode()
    def lp(x, node_mask, senders, receivers, edge_mask, score_senders, score_receivers):
        return lp_model(x, node_mask, score_senders=score_senders,
                        score_receivers=score_receivers,
                        **_graph_kwargs(lp_model, x, senders, receivers, edge_mask))

    return {"ENZYMES_embed": lambda: embed(*graph(enz)),
            "ENZYMES_GC": lambda: gc(*graph(enz), enz.node_graph),
            "Cora_NC": lambda: nc(*graph(cora["NC"])),
            "Cora_LP": lambda: lp(*graph(cora["LP"]), score[0], score[1])}


def leave_artifacts_state(models, cora, graph, device) -> None:
    """What chip_smoke.py's artifacts phase does in its process that a later
    phase could feel: torch.export on the card, a profiler session, anomaly
    mode on and off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnn_pretraining_tpu_torch import FinetuneGNN, serving
    from gnn_pretraining_tpu_torch.utils.profiling import enable_nan_checks

    dense = FinetuneGNN("Cora_NC", "dense", device=device)
    dense.load_state_dict(models["Cora_NC"].state_dict())
    blob = serving.export_serving(dense, dict(zip(serving.GRAPH, graph(cora["NC"]))),
                                  platforms=(device.type,))
    served = serving.load_serving(blob, device.type)
    served(*graph(cora["NC"]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        served(*graph(cora["NC"]))
        torch.cuda.synchronize()
    enable_nan_checks(True)
    enable_nan_checks(False)


def measure(mode: str, out) -> None:
    import torch

    import chip_smoke as cs
    from gnn_pretraining_tpu_torch import load_serving_model

    card = cs.device_phase()
    cs.import_port()           # the kernels main() built load at first use
    device = torch.device(DEVICE)
    models = {d: load_serving_model(d, cs.ARTIFACT, device=device, seed=cs.SEED)
              for d in ("ENZYMES", "Cora_NC", "Cora_LP")}
    enz, cora, score = cs.serving_inputs(device)
    graph = lambda b: (b.x, b.node_mask, b.senders, b.receivers, b.edge_mask)  # noqa: E731
    versions = {"P": parent_forwards(models, enz, cora, score, graph),
                "C": cs.serving_forwards(models, enz, cora, score)}
    for name in versions["P"]:
        p, c = versions["P"][name](), versions["C"][name]()
        rel = float((p - c).abs().max() / p.abs().max())
        if not rel <= 1e-5:
            raise AssertionError(f"{name}: P and C differ by {rel}")
    if mode == "after":
        leave_artifacts_state(models, cora, graph, device)
    rows = {}
    for name in versions["P"]:
        times = {"P": [], "C": []}
        for _ in range(5):
            for v in ("P", "C", "C", "P"):
                times[v].append(cs.median_ms(versions[v][name]))
        rows[name] = {v: {"min": min(t), "median": statistics.median(t)}
                      for v, t in times.items()}
    line = json.dumps({"serving_ab": mode, "card": card, "torch": torch.__version__,
                       "event_ms": rows})
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")
    cs.profile_phase(versions["C"], {n: r["C"]["median"] for n, r in rows.items()})


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=sorted(set(MODES)))
    p.add_argument("--out")
    args = p.parse_args()
    if args.mode:
        measure(args.mode, args.out)
        return 0
    import chip_smoke as cs

    cs.device_phase()
    cs.import_port()
    cs.build_phase()
    for mode in MODES:
        subprocess.run([sys.executable, __file__, "--mode", mode,
                        *(["--out", args.out] if args.out else [])], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
