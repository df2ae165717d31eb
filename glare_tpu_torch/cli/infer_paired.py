"""Paired-dataset inference (the judged config), on the GPU.

    python -m glare_tpu_torch.cli.infer_paired --opt confs/LOL.yml [--batch N] [--device cpu]

Counterpart of ``glare_tpu/cli/infer_paired.py``, same per-image protocol:
reflect pad (bottom 20, left 20), /255 + log transform (the C++ core of
``data/native.py``), stage-3 forward, crop
back, gray-mean brightness adjust, PSNR/SSIM/LPIPS, per-image CSV + metrics.txt.
Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no explicit
``--device cpu`` it raises.

Checkpoint-aware DCN dispatch, as the JAX CLI: unless ``network_G.dcn_auto:
false``, the loaded weights' offsets are audited on the first up to four
same-shape images (``auto_configure_dcn``); and every batch goes through
:func:`enhance_exact`, which re-dispatches and re-runs a batch whose DCN
overflow counters are not zero, so that the shipped output stays exact DCNv2.

The per-image step works on arrays (:func:`prep`, then the model through
:func:`enhance_exact`, then :func:`measure_output`), so that other callers run
the protocol without file IO. LPIPS runs on the model's device
(``measure.Measure``); without its weights (``GLARE_LPIPS_NPZ``) the column is
NaN with a note.

Weights: torch ``state_dict`` files beside the paths the conf names
(``model_path`` / ``path.pretrained_vqgan`` with the extension ``.pth``).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from collections import OrderedDict

import numpy as np

from ..measure import Measure
from ..models import create_model
from ..options import dict_to_nonedict, parse
from ..data.native import preprocess_padded
from ..utils.imgproc import hiseq_color_cv2_img, impad, imread, imwrite
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


def audit_on_sample(model, opt, samples):
    """The start-up audit: ``auto_configure_dcn`` on the first up to four arrays of
    ``samples`` that share the first one's shape, unless ``network_G.dcn_auto`` is
    false. Returns the stats dict, or None when switched off."""
    if opt_get(opt, ["network_G", "dcn_auto"], True) is False \
            or not hasattr(model, "auto_configure_dcn"):
        return None
    sample = [s for s in samples[:4] if s.shape == samples[0].shape]
    stats = model.auto_configure_dcn(np.stack(sample))
    print(f"DCN offset audit ({len(sample)} images): {stats.get('action')}")
    return stats


def enhance_exact(model, lr_b, tag=""):
    """``model.get_sr(lr_b)`` with the exactness guard: the configuration audited
    on another batch may not hold for this one, and the DCN packs report their
    own overflow. On a hit: one re-audit on this batch when a plain clamped warp
    saw taps beyond its radius; then, for cascade warps, capacity doubled (up to
    1.0) on block overflow and R_tail doubled (up to 16) on taps beyond it; the
    batch is re-run each time. Ends with zero counters, or with a warning when
    nothing is left to raise. Returns ``(sr, overflow)``: the output tensor
    ``[B, H, W, 3]`` and the last counters (None for exact impls)."""
    sr_b = model.get_sr(lq=lr_b, heat=None)
    ov = model.last_dcn_overflow() if hasattr(model, "last_dcn_overflow") else None
    reaudited = False

    def aslist(v):
        # the dcn knobs may be per-warp pairs; the counters are summed over packs,
        # so one overflowing cascade warp upgrades every cascade warp
        return list(v) if isinstance(v, (tuple, list)) and len(v) == 2 else [v, v]

    def collapse(vals):
        return vals[0] if len(set(vals)) == 1 else tuple(vals)

    while ov and (ov["overflow_blocks"] or ov["taps_beyond_tail"]):
        netG = model.netG
        impls = aslist(netG.dcn_impl)
        if ov["taps_beyond_tail"] and not reaudited and any(i == "pallas" for i in impls):
            reaudited = True
            stats = model.auto_configure_dcn(lr_b)
            print(f"DCN overflow {ov} on {tag}..: re-audited on the offending batch: "
                  f"{stats.get('action')}")
            sr_b = model.get_sr(lq=lr_b, heat=None)
            ov = model.last_dcn_overflow()
            continue
        caps = [float(c) for c in aslist(netG.dcn_hybrid_capacity)]
        r_tails = [int(r) for r in aslist(netG.dcn_hybrid_tail_offset)]
        changed = False
        for w, impl_w in enumerate(impls):
            if impl_w != "hybrid":
                continue
            if ov["overflow_blocks"] and caps[w] < 1.0:
                caps[w] = min(1.0, 2 * caps[w])
                changed = True
            if ov["taps_beyond_tail"] and r_tails[w] < 16:
                r_tails[w] = min(16, 2 * r_tails[w])
                changed = True
        if not changed:
            print(f"WARNING: DCN cascade overflow {ov} at max capacity/radius — output is "
                  f"clamp-approximate for {tag}..")
            break
        kw = {"dcn_hybrid_capacity": collapse(caps), "dcn_hybrid_tail_offset": collapse(r_tails)}
        print(f"DCN cascade overflow {ov} on {tag}..: re-dispatching with {kw}")
        netG.configure_dcn(**kw)
        sr_b = model.get_sr(lq=lr_b, heat=None)
        ov = model.last_dcn_overflow()
    return sr_b, ov


def prep(lr, opt):
    """uint8 HWC RGB low-light image -> the model's input: reflect pad (bottom 20,
    left 20), /255, the log transform when ``datasets.train.log_low``, fused in the
    C++ core (``data.native``, as the JAX CLI; bit-equal to the numpy plain
    version ``utils.imgproc.preprocess_padded``; a failed build raises); the
    histogram-equalised image instead of it (``histeq_as_input``) or beside it
    (``concat_histeq``) when the conf asks. -> (float32 [H+20, W+20, C], H)."""
    apply_log = bool(opt_get(opt, ["datasets", "train", "log_low"], False))
    his = hiseq_color_cv2_img(lr) if opt.get("histeq_as_input") or opt.get("concat_histeq") else None
    if opt.get("histeq_as_input", False):
        lr = his
    lr_t = preprocess_padded(lr, bottom=20, left=20, apply_log=apply_log)
    if opt.get("concat_histeq", False):
        his_t = impad(his, bottom=20, left=20).astype(np.float32) / 255.0
        lr_t = np.concatenate([lr_t, his_t], axis=-1)
    return lr_t, lr.shape[0]


def measure_output(sr, h, hr, measure):
    """One image's metrics from the model's padded output ``sr`` (float
    [H+20, W+20, 3]): crop the pad back, clip to [0, 1], gray-mean adjust to the
    target ``hr`` (uint8 HWC RGB), then PSNR, SSIM and LPIPS (``measure``'s).
    -> (the adjusted image as uint8, OrderedDict PSNR / SSIM / LPIPS)."""
    restored = np.clip(sr[:h, 20:, :], 0, 1)
    target = hr.astype(np.float64) / 255.0
    restored = gray_mean_adjust(restored, target)
    out = img_as_ubyte(restored)
    meas = OrderedDict()
    meas["PSNR"] = PSNR(target, restored)
    meas["SSIM"] = calculate_ssim(img_as_ubyte(target), out)
    meas["LPIPS"] = measure.lpips(out, img_as_ubyte(target))
    return out, meas


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
    measure = Measure(device=model.device)

    audit_on_sample(model, opt, [prep(imread(p), opt)[0] for p in lr_paths[:4]])

    t0 = time.time()
    n_images = 0
    i = 0
    while i < len(lr_paths):
        # fuse same-shape consecutive images into one device call
        group = [(lr_paths[i], hr_paths[i], *prep(imread(lr_paths[i]), opt))]
        i += 1
        while len(group) < args.batch and i < len(lr_paths):
            lr_t, h = prep(imread(lr_paths[i]), opt)
            if lr_t.shape != group[0][2].shape:
                break
            group.append((lr_paths[i], hr_paths[i], lr_t, h))
            i += 1

        lr_b = np.stack([g[2] for g in group])
        sr_b = enhance_exact(model, lr_b, tag=group[0][0])[0].cpu().numpy()

        for (lr_path, hr_path, lr_t, h), sr in zip(group, sr_b):
            out, metrics = measure_output(sr, h, imread(hr_path), measure)
            n_images += 1
            meas = OrderedDict(conf=conf, name=os.path.basename(hr_path), **metrics)
            imwrite(os.path.join(test_dir, os.path.basename(hr_path)), out)
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
            # per image, not just per run: a NaN column hides that LPIPS had no weights
            v = f"{v:0.4f}" if np.isfinite(v) else "NaN (weights missing; set GLARE_LPIPS_NPZ)"
        s_out.append(f"{k}: {v}")
    return ", ".join(s_out)


if __name__ == "__main__":
    main()
