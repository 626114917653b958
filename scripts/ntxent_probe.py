#!/usr/bin/env python3
"""Where K2 (the port's fused NT-Xent, csrc/ntxent.cu) spends its time on
one CUDA card.

    python3 scripts/ntxent_probe.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the port's kernels and prints, one JSON line each:

  * each K2 kernel's ptxas registers, stack and spills, and how many blocks
    of the two product kernels one SM holds;
  * per row count (16 to 8192, d = 128, 70% of node pairs valid as
    chip_smoke.py makes them): the device time of a forward and a backward
    call (chip_smoke.device_ms) and, from torch.profiler, the device time of
    each kernel of the call (the hi/lo split, then the product kernel);
  * the forward and backward device times at 832 and 4104 rows for every
    column-chunk count from 1 to the plan's maximum (ops.ntxent.plan
    replaced for the sweep), beside the plan's own choice.

Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ROWS = (16, 400, 832, 2640, 4104, 8192)
SWEEP_ROWS = (832, 4104)
PROFILE_REPS = 20


def kernel_ms(fn) -> dict:
    """Device ms per call of each kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]: e.self_device_time_total / PROFILE_REPS / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def main() -> int:
    cs.device_phase()
    cs.import_port()
    from gnn_pretraining_tpu_torch.ops import _build, ntxent

    rows = cs.ptxas_report(str(_build.build()["log"]))
    lib = _build.library()
    cs.emit({"ptxas": [r for r in rows if r["source"] == "ntxent.cu"],
             "blocks_per_sm": {name: lib.ntxent_blocks_per_sm(backward, 0)
                               for backward, name in enumerate(("fwd", "bwd"))}})
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(cs.SEED)
    plan = ntxent.plan
    for r in ROWS:
        zhat, vv, temp, _, _ = cs.ntxent_inputs(rng, r, device)
        g = (0.8 * vv).contiguous()
        _, mx, den = ntxent.ntxent_fwd_reference(zhat, vv, temp)
        calls = {"fwd": lambda: ntxent.ntxent_fwd(zhat, vv, temp),
                 "bwd": lambda: ntxent.ntxent_bwd(zhat, vv, temp, mx, den, g)}
        cs.emit({"rows": r, "plan": plan(r, sms),
                 **{f"{name}_ms": cs.device_ms(fn) for name, fn in calls.items()},
                 **{f"{name}_kernels_ms": kernel_ms(fn) for name, fn in calls.items()}})
        if r not in SWEEP_ROWS:
            continue
        tiles = plan(r, sms)[0]
        try:
            for chunks in range(1, min(tiles, ntxent.MAX_CHUNKS) + 1):
                per = -(-tiles // chunks)
                if -(-tiles // per) != chunks:
                    continue                    # the same grid as a smaller count
                ntxent.plan = lambda _r, _s, grid=(tiles, chunks, per): grid
                cs.emit({"rows": r, "chunks": chunks, "tiles_per_chunk": per,
                         "blocks": tiles * chunks,
                         **{f"{name}_ms": cs.device_ms(fn) for name, fn in calls.items()}})
        finally:
            ntxent.plan = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
