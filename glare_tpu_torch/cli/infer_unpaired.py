"""Unpaired enhancement, on the GPU (counterpart of ``glare_tpu/cli/infer_unpaired.py``).

    python -m glare_tpu_torch.cli.infer_unpaired --opt confs/LOL.yml [-n NAME] [--device cpu]

Per image under the conf's ``dataroot_unpaired``: reflect-pad to a multiple of
16, enhance, crop back, check the shape, save under ``results/<conf>/<name>/``.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..utils.imgproc import auto_padding, imread, imwrite, log_transform
from ..utils.metrics import img_as_ubyte
from ..utils.util import natsorted, opt_get
from .infer_paired import load_model


def enhance_image(model, lr, apply_log):
    """uint8 HWC -> enhanced uint8 HWC of the same shape."""
    raw_shape = lr.shape
    lr, (h1, h2, w1, w2) = auto_padding(lr, times=16)
    lr_t = lr.astype(np.float32) / 255.0
    if apply_log:
        lr_t = log_transform(lr_t)
    sr = model.get_sr(lq=lr_t[None], heat=None).cpu().numpy()[0]
    sr = sr[h1: sr.shape[0] - h2, w1: sr.shape[1] - w2, :]
    assert sr.shape == raw_shape, (sr.shape, raw_shape)
    return img_as_ubyte(np.clip(sr, 0, 1))


def main(default_conf="./confs/LOL.yml"):
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", default=default_conf)
    parser.add_argument("-n", "--name", default="unpaired")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    conf = os.path.basename(args.opt).replace(".yml", "")
    model, opt = load_model(args.opt, device=args.device)

    lr_dir = opt["dataroot_unpaired"]
    lr_paths = natsorted(
        glob.glob(os.path.join(lr_dir, "*.png"))
        + glob.glob(os.path.join(lr_dir, "*.jpg"))
        + glob.glob(os.path.join(lr_dir, "*.bmp"))
    )
    assert lr_paths, f"no images under {lr_dir}"
    test_dir = os.path.join("results", conf, args.name)
    os.makedirs(test_dir, exist_ok=True)
    apply_log = bool(opt_get(opt, ["datasets", "train", "log_low"], False))

    for lr_path in lr_paths:
        out = enhance_image(model, imread(lr_path), apply_log)
        imwrite(os.path.join(test_dir, os.path.basename(lr_path)), out)
        print(f"{lr_path} -> {test_dir}")


if __name__ == "__main__":
    main()
