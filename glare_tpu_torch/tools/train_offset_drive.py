"""Training drive for the DCN offset evidence (counterpart of
``tools/train_offset_drive.py``).

Synthesises a LOL-layout dataset (structured images: gradients and discs, their
dark copies), trains stage 2 briefly through ``python -m
glare_tpu_torch.cli.train --stage 2`` (the warm start), then stage 3 at 256 px
with the shipped ``chain`` DCN, and runs ``tools/offset_histogram`` on the final
stage-3 checkpoint at the 620x420 protocol shape.

    python -m glare_tpu_torch.tools.train_offset_drive [--root results/offset_drive]
        [--s2_iters 600] [--s3_iters 500] [--device cpu]

Everything goes under ``--root`` (the dataset, the patched confs, and, through
``GLARE_ROOT``, the experiments). Needs ``cv2`` and ``yaml``. Runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synth_lol(root, n_train=30, n_eval=4, hw=(400, 600), seed=0):
    """``root/{our485,eval15}/{low,high}/NNN.png``: structured seeded images
    (sinusoids and discs, not white noise) and their 5-20% dark copies."""
    import cv2

    rng = np.random.RandomState(seed)
    for split, n in (("our485", n_train), ("eval15", n_eval)):
        for sub in ("low", "high"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(n):
            yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
            img = np.stack([
                0.5 + 0.5 * np.sin(xx / (20 + 10 * rng.rand()) + rng.rand() * 6),
                0.5 + 0.5 * np.sin(yy / (25 + 10 * rng.rand()) + rng.rand() * 6),
                rng.rand() * np.ones_like(xx),
            ], -1)
            for _ in range(6):
                cy, cx = rng.randint(0, hw[0]), rng.randint(0, hw[1])
                r = int(rng.randint(20, 80))
                cv2.circle(img, (int(cx), int(cy)), r, [float(c) for c in rng.rand(3)], -1)
            hi = np.clip(img * 255, 0, 255).astype(np.uint8)
            lo = (hi * rng.uniform(0.05, 0.2)).astype(np.uint8)
            cv2.imwrite(os.path.join(root, split, "high", f"{i:03d}.png"), hi)
            cv2.imwrite(os.path.join(root, split, "low", f"{i:03d}.png"), lo)


def patch(conf_path, name, out_path, data_root, **over):
    """The conf at ``conf_path`` with the synthetic data, no validation, no
    tensorboard, and ``over`` (dotted keys) -> written to ``out_path``."""
    import yaml

    with open(conf_path) as f:
        opt = yaml.safe_load(f)
    opt["name"] = name
    for split in ("train", "val"):
        opt["datasets"][split]["root"] = data_root
    opt["dataroot_GT"] = os.path.join(data_root, "eval15", "high")
    opt["dataroot_LR"] = os.path.join(data_root, "eval15", "low")
    opt["train"]["val_freq"] = 10 ** 9
    opt["use_tb_logger"] = False
    for k, v in over.items():
        node = opt
        *head, last = k.split(".")
        for kk in head:
            node = node.setdefault(kk, {})
        node[last] = v
    with open(out_path, "w") as f:
        yaml.safe_dump(opt, f)
    return opt


def run(cmd, root):
    print("running:", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, env={**os.environ, "GLARE_ROOT": root}, cwd=REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="results/offset_drive")
    ap.add_argument("--s2_iters", type=int, default=600)
    ap.add_argument("--s3_iters", type=int, default=500)
    ap.add_argument("--s2_gt", type=int, default=256,
                    help="stage-2 crop; stage 3's 256 keeps the frozen flow in distribution")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    data_root = os.path.join(root, "LOLdataset")
    if not os.path.exists(os.path.join(data_root, "our485", "low")):
        synth_lol(data_root)
        print("synthetic dataset written", flush=True)
    train = [sys.executable, "-m", "glare_tpu_torch.cli.train", "--device", args.device]

    s2_conf = os.path.join(root, "drive_s2.yml")
    patch(os.path.join(REPO, "confs", "train_stage2_LOL.yml"), "offsetdrive_s2", s2_conf, data_root,
          **{"datasets.train.GT_size": args.s2_gt, "datasets.train.batch_size": 4,
             "logger.save_checkpoint_freq": float(args.s2_iters)})
    s2_ckpt = os.path.join(root, "experiments", "offsetdrive_s2", "models", f"{args.s2_iters}_G.pth")
    if not os.path.exists(s2_ckpt):
        run(train + ["--stage", "2", "--opt", s2_conf, "--niter", str(args.s2_iters)], root)
    print(f"stage-2 drive done: {s2_ckpt}", flush=True)

    s3_conf = os.path.join(root, "drive_s3.yml")
    over3 = {"datasets.train.GT_size": 256, "datasets.train.batch_size": 2,
             "path.pretrain_model_G": s2_ckpt, "path.pretrained_vqgan": "",
             # frequent states: the trainer's non-finite recovery reloads the newest
             "logger.save_checkpoint_freq": 50.0, "train.lr_G": 2.5e-5}
    patch(os.path.join(REPO, "confs", "train_stage3_LOL.yml"), "offsetdrive_s3", s3_conf, data_root, **over3)
    s3_ckpt = os.path.join(root, "experiments", "offsetdrive_s3", "models", f"{args.s3_iters}_G.pth")
    if not os.path.exists(s3_ckpt):
        run(train + ["--stage", "3", "--opt", s3_conf, "--niter", str(args.s3_iters)], root)
    print(f"stage-3 drive done: {s3_ckpt}", flush=True)

    run([sys.executable, "-m", "glare_tpu_torch.tools.offset_histogram", "--ckpt", s3_ckpt,
         "--images", os.path.join(data_root, "eval15", "low"), "--height", "420", "--width", "620",
         "--n", "4", "--dtype", "float32", "--dcn_impl", "chain", "--device", args.device,
         "--out", os.path.join(root, "offset_histogram.jsonl")], root)


if __name__ == "__main__":
    main()
