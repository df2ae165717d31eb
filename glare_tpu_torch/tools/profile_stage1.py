"""Device profile of the stage-1 GAN iteration on the card (counterpart of
``tools/profile_stage1.py``).

Traces ``--iters`` calls of ``VQDehazeModel.optimize_parameters`` (the g step,
``z_gt``, the spectral-norm d step, the EMA) at the JAX tool's shapes
(confs/stage1_HQ_pretrain.yml: 256x256, batch 4, float32) after two warm-up
iterations, and reduces the trace with ``utils.profiling.aggregate`` (as
``profile_stage3``): device time by kernel category per image, the host clock's
time and the device's idle share, the host gap.

    python -m glare_tpu_torch.tools.profile_stage1 [--batch 4] [--gt_size 256]
        [--iters 3] [--device cpu] [--log_dir results/stage1_trace]
        [--out results/profile_stage1.json]

Runs on ``cuda`` unless ``--device cpu`` is given. Seeded weights and images.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..utils import profiling
from .flops_audit import stage1_opt
from .profile_stage3 import report, write


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gt_size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--log_dir", default="results/stage1_trace")
    ap.add_argument("--out", default="results/profile_stage1.json")
    args = ap.parse_args(argv)

    from ..sr.models import build_model

    b, s = args.batch, args.gt_size
    model = build_model(stage1_opt(s), device=args.device)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(b, s, s, 3).astype(np.float32), device=model.device)
    data = {"lq": x, "gt": x}
    it = 0
    for _ in range(2):
        it += 1
        logs = model.optimize_parameters(it, data)
    float(logs["l_g_total"])
    t0 = time.perf_counter()
    with profiling.trace(args.log_dir, cuda=model.device.type == "cuda") as prof:
        for _ in range(args.iters):
            it += 1
            logs = model.optimize_parameters(it, data)
        float(logs["l_g_total"])
    wall = time.perf_counter() - t0
    payload = report(prof, wall, b * args.iters,
                     f"stage-1 HQ iteration (g + z_gt + d + EMA) b={b} {s}px float32, {args.iters} traced")
    payload["host_gap_ms_per_img"] = payload["wall_ms_per_img"] - payload["device_ms_per_img"]
    print(json.dumps({k: payload[k] for k in ("what", "wall_ms_per_img", "device_ms_per_img",
                                              "device_idle_share", "host_gap_ms_per_img")}))
    if args.out:
        write(args.out, payload)
    return payload


if __name__ == "__main__":
    main()
