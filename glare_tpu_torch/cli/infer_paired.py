"""Paired-dataset inference (the judged config), on the GPU.

    python -m glare_tpu_torch.cli.infer_paired --opt confs/LOL.yml [--batch N] [--device cpu]

Counterpart of ``glare_tpu/cli/infer_paired.py``, same per-image protocol:
reflect pad (bottom 20, left 20), /255 + log transform, stage-3 forward, crop
back, gray-mean brightness adjust, PSNR/SSIM, per-image CSV + metrics.txt.
Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no explicit
``--device cpu`` it raises.

Weights: torch ``state_dict`` files beside the paths the conf names
(``model_path`` / ``path.pretrained_vqgan`` with the extension ``.pth``).
LPIPS is not computed yet (its network is not ported).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from collections import OrderedDict

import numpy as np

from ..models import create_model
from ..options import dict_to_nonedict, parse
from ..utils.imgproc import hiseq_color_cv2_img, impad, imread, imwrite, preprocess_padded
from ..utils.metrics import PSNR, calculate_ssim, gray_mean_adjust, img_as_ubyte
from ..utils.util import natsorted, opt_get


def load_model(conf_path, device="cuda"):
    opt = parse(conf_path, is_train=False)
    opt["gpu_ids"] = None
    opt = dict_to_nonedict(opt)
    model = create_model(opt, device=device)
    model_path = opt_get(opt, ["model_path"], None)
    if model_path and os.path.exists(model._torchify(model_path)):
        model.load_network(load_path=model_path)
    else:
        print(f"WARNING: model weights not found at {model_path}; using fresh init")
    return model, opt


def main(default_conf="./confs/LOL.yml"):
    import pandas as pd

    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", default=default_conf)
    parser.add_argument("--batch", type=int, default=1, help="images per device call")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    conf_path = args.opt
    conf = os.path.basename(conf_path).replace(".yml", "")
    model, opt = load_model(conf_path, device=args.device)

    lr_dir = opt["dataroot_LR"]
    hr_dir = opt["dataroot_GT"]
    lr_paths = natsorted(glob.glob(os.path.join(lr_dir, "*.png")))
    hr_paths = natsorted(glob.glob(os.path.join(hr_dir, "*.png")))
    assert len(lr_paths) == len(hr_paths) and lr_paths, (lr_dir, hr_dir)

    test_dir = os.path.join("results", conf)
    os.makedirs(test_dir, exist_ok=True)
    print(f"Out dir: {test_dir}")
    path_out_measures_final = os.path.join(test_dir, f"{conf}.csv")
    df = None

    apply_log = bool(opt_get(opt, ["datasets", "train", "log_low"], False))

    def prep(lr_path):
        lr = imread(lr_path)
        his = hiseq_color_cv2_img(lr)
        if opt.get("histeq_as_input", False):
            lr = his
        h, w, _ = lr.shape
        lr_t = preprocess_padded(lr, bottom=20, left=20, apply_log=apply_log)
        if opt.get("concat_histeq", False):
            his_t = impad(his, bottom=20, left=20).astype(np.float32) / 255.0
            lr_t = np.concatenate([lr_t, his_t], axis=-1)
        return lr_t, h

    print("DCN offset audit skipped: audit_dcn_offsets/auto_configure_dcn are not ported yet; "
          f"running network_G.dcn_impl={model.netG.dcn_impl!r} as configured")

    t0 = time.time()
    n_images = 0
    i = 0
    while i < len(lr_paths):
        # fuse same-shape consecutive images into one device call
        group = [(lr_paths[i], hr_paths[i], *prep(lr_paths[i]))]
        i += 1
        while len(group) < args.batch and i < len(lr_paths):
            lr_t, h = prep(lr_paths[i])
            if lr_t.shape != group[0][2].shape:
                break
            group.append((lr_paths[i], hr_paths[i], lr_t, h))
            i += 1

        lr_b = np.stack([g[2] for g in group])
        sr_b = model.get_sr(lq=lr_b, heat=None).cpu().numpy()

        ov = model.last_dcn_overflow()
        if ov and (ov["overflow_blocks"] or ov["taps_beyond_tail"]):
            print(f"WARNING: DCN overflow {ov} on {group[0][0]}..: offsets beyond the clamp "
                  "radius, output is clamp-approximate (set network_G.dcn_impl: xla for exact)")

        for (lr_path, hr_path, lr_t, h), sr in zip(group, sr_b):
            hr = imread(hr_path)
            sr = sr[:h, 20:, :]  # crop the pad back
            restored = np.clip(sr, 0, 1)
            target = hr.astype(np.float64) / 255.0
            restored = gray_mean_adjust(restored, target)
            n_images += 1

            meas = OrderedDict(conf=conf, name=os.path.basename(hr_path))
            meas["PSNR"] = PSNR(target, restored)
            meas["SSIM"] = calculate_ssim(img_as_ubyte(target), img_as_ubyte(restored))

            imwrite(os.path.join(test_dir, os.path.basename(hr_path)), img_as_ubyte(restored))
            print(format_measurements(meas))
            df = pd.DataFrame([meas]) if df is None else pd.concat([pd.DataFrame([meas]), df])

    dt = time.time() - t0
    df.to_csv(path_out_measures_final, index=False)
    str_out = format_measurements(df.mean(numeric_only=True))
    print(f"Results in: {path_out_measures_final}")
    print("Mean: " + str_out)
    print(f"Throughput: {n_images / dt:.3f} img/s (incl. IO + metrics)")
    with open(os.path.join(test_dir, "metrics.txt"), "a") as f:
        f.write(f"{conf} {str_out}\n")


def format_measurements(meas):
    s_out = []
    for k, v in meas.items():
        if isinstance(v, float):
            v = f"{v:0.4f}"
        s_out.append(f"{k}: {v}")
    return ", ".join(s_out)


if __name__ == "__main__":
    main()
