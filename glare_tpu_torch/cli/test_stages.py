"""Checkpoint-sweep evaluators for stages 2 and 3, on the GPU (counterpart of
``glare_tpu/cli/test_stages.py``).

    python -m glare_tpu_torch.cli.test_stages --stage 2 [--opt CONF] [--models_dir DIR] [--device cpu]

Iterates every ``*_G.pth`` under an experiment's models dir, runs the conf's
evaluation set, reports adjusted + unadjusted PSNR/SSIM and the LPIPS of the
adjusted image (``measure.Measure`` on the model's device; NaN with a note
without ``GLARE_LPIPS_NPZ``), and writes a per-checkpoint CSV.

Stage 2: the generator's output is a latent; it is decoded through the frozen
VQGAN (codebook retrieval + decoder); the input is padded to a multiple of 4,
the latent stride. Stage 3: the input is reflect-padded bottom/left by 20 px and
the output cropped back.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import OrderedDict

import numpy as np

from ..measure import Measure
from ..models import create_model
from ..options import dict_to_nonedict, parse
from ..utils.imgproc import impad, imread, imwrite, log_transform
from ..utils.metrics import PSNR, calculate_ssim, gray_mean_adjust, img_as_ubyte
from ..utils.util import natsorted, opt_get
from .infer_paired import format_measurements


def run_checkpoint_sweep(stage, conf_path, models_dir=None, device="cuda"):
    import pandas as pd

    opt = parse(conf_path, is_train=False)
    opt["gpu_ids"] = None
    opt = dict_to_nonedict(opt)
    model = create_model(opt, device=device)

    if models_dir is None:
        models_dir = os.path.join("experiments", f"train_stage{stage}_LOL", "models")
    ckpts = natsorted(glob.glob(os.path.join(models_dir, "*_G.pth")))
    if not ckpts:
        print(f"No checkpoints under {models_dir}")
        return None

    lr_paths = natsorted(glob.glob(os.path.join(opt["dataroot_LR"], "*.png")))
    hr_paths = natsorted(glob.glob(os.path.join(opt["dataroot_GT"], "*.png")))

    measure = Measure(device=model.device)
    rows = []
    for ckpt in ckpts:
        model.load_network(ckpt)
        metrics = evaluate_once(stage, model, opt, lr_paths, hr_paths, measure)
        row = OrderedDict(checkpoint=os.path.basename(ckpt), **metrics)
        rows.append(row)
        print(format_measurements(row))

    df = pd.DataFrame(rows)
    out_csv = os.path.join(models_dir, f"test_stage{stage}_metrics.csv")
    df.to_csv(out_csv, index=False)
    print(f"Wrote {out_csv}")
    return df


def evaluate_once(stage, model, opt, lr_paths, hr_paths, measure, save_dir=None):
    """Metrics of ``model`` over the pairs; ``measure`` (a ``measure.Measure``)
    computes the LPIPS of the adjusted images."""
    psnrs, ssims, lpips_l, psnrs_adj, ssims_adj = [], [], [], [], []
    log_low = opt_get(opt, ["datasets", "train", "log_low"], False)
    for lr_path, hr_path in zip(lr_paths, hr_paths):
        lr = imread(lr_path)
        hr = imread(hr_path)
        h, w, _ = lr.shape

        if stage == 3:
            lr_p = impad(lr, bottom=20, left=20)
        else:
            # pad to a multiple of 4 for the latent stride
            lr_p = impad(lr, bottom=(-h) % 4, right=(-w) % 4)

        lr_t = lr_p.astype(np.float32) / 255.0
        if log_low:
            lr_t = log_transform(lr_t)
        sr = model.get_sr(lr_t[None])
        if stage == 2:
            sr = model.decode_latent(sr).cpu().numpy()[0][:h, :w]
        else:
            sr = sr.cpu().numpy()[0][:h, 20:]

        restored = np.clip(sr, 0, 1)
        target = hr.astype(np.float64) / 255.0
        psnrs.append(PSNR(target, restored))
        ssims.append(calculate_ssim(img_as_ubyte(target), img_as_ubyte(restored)))
        adj = gray_mean_adjust(restored, target)
        psnrs_adj.append(PSNR(target, adj))
        ssims_adj.append(calculate_ssim(img_as_ubyte(target), img_as_ubyte(adj)))
        lpips_l.append(measure.lpips(img_as_ubyte(adj), img_as_ubyte(target)))
        if save_dir:
            imwrite(os.path.join(save_dir, os.path.basename(hr_path)), img_as_ubyte(adj))

    return {
        "PSNR": float(np.mean(psnrs)),
        "SSIM": float(np.mean(ssims)),
        "PSNR_adj": float(np.mean(psnrs_adj)),
        "SSIM_adj": float(np.mean(ssims_adj)),
        "LPIPS": float(np.mean(lpips_l)),
    }


def main(stage=None):
    parser = argparse.ArgumentParser()
    if stage is None:
        parser.add_argument("--stage", type=int, choices=(2, 3), required=True)
    parser.add_argument("--opt", default=None,
                        help="default: confs/train_stage2_LOL.yml (stage 2), confs/LOL.yml (stage 3)")
    parser.add_argument("--models_dir", default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    stage = stage if stage is not None else args.stage
    conf = args.opt or ("./confs/LOL.yml" if stage == 3 else "./confs/train_stage2_LOL.yml")
    run_checkpoint_sweep(stage, conf, args.models_dir, device=args.device)


if __name__ == "__main__":
    main()
