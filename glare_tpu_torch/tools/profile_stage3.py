"""Device profile of stage-3 inference on the card (counterpart of
``tools/profile_stage3.py``).

Traces ``--iters`` calls of ``VQLLFLOWDModel.get_sr`` (``latent_half`` ->
``VQModel.decode`` -> ``aft_half``) at the JAX tool's shapes (batch 8, 620x420,
bf16, ``dcn_impl: pallas``) with ``torch.profiler`` after two warm-up calls, and
reduces the trace with ``utils.profiling.aggregate``: device time by kernel
category and the largest kernels, per image, beside the host clock's time and
the device's idle share. The Chrome trace stays under ``--log_dir``.

    python -m glare_tpu_torch.tools.profile_stage3 [--batch 8] [--iters 3]
        [--dtype bfloat16] [--dcn_impl pallas] [--device cpu]
        [--log_dir results/stage3_trace] [--out results/profile_stage3.json]

Runs on ``cuda`` unless ``--device cpu`` is given (the CPU trace has no device
time). Seeded weights and images.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..utils import profiling
from .flops_audit import build_stage3


def report(prof, wall_s, n_img, what):
    """The aggregate of a finished trace, per image, with the idle share."""
    agg = profiling.aggregate(prof)
    wall_ms = wall_s * 1e3 / n_img
    busy = agg["device_busy_ms"] / n_img
    return {"what": what, "wall_ms_per_img": wall_ms, "device_ms_per_img": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            "kernel_launches_per_img": agg["kernel_launches"] / n_img,
            "device_ms_per_img_by_category": {k: v / n_img for k, v in agg["device_ms_by_category"].items()},
            "top_kernels_ms_per_img": [(k, v / n_img) for k, v in agg["top_kernels_ms"]]}


def write(out, payload):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--height", type=int, default=420)
    ap.add_argument("--width", type=int, default=620)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--dcn_impl", default="pallas")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--log_dir", default="results/stage3_trace")
    ap.add_argument("--out", default="results/profile_stage3.json")
    args = ap.parse_args(argv)

    model, lq = build_stage3(args.height, args.width, args.dtype, args.dcn_impl, args.device)
    lq = lq.expand(args.batch, -1, -1, -1).contiguous()
    for _ in range(2):
        profiling.host_sync(model.get_sr(lq))
    t0 = time.perf_counter()
    with profiling.trace(args.log_dir, cuda=model.device.type == "cuda") as prof:
        for _ in range(args.iters):
            out = model.get_sr(lq)
        profiling.host_sync(out)
    wall = time.perf_counter() - t0
    payload = report(prof, wall, args.batch * args.iters,
                     f"stage-3 get_sr {args.width}x{args.height} {args.dtype} B={args.batch} "
                     f"dcn_impl={args.dcn_impl}, {args.iters} traced calls")
    print(json.dumps({k: payload[k] for k in ("what", "wall_ms_per_img", "device_ms_per_img",
                                              "device_idle_share", "kernel_launches_per_img")}))
    for k, v in payload["device_ms_per_img_by_category"].items():
        print(f"  {v:9.3f} ms/img  {k}")
    if args.out:
        write(args.out, payload)
    return payload


if __name__ == "__main__":
    main()
