"""LOL / LOL-v2 paired low-light datasets, numpy/NHWC (the port's own copy of
``glare_tpu/data/lol_dataset.py``; reference: code/data/LoL_dataset.py).

Pipelines kept:
  * LoLDatasetRIDCP (the shipped stage-2/3 train set, :250-403):
    random resize (crop_size..full, or upscale past crop_size+1), paired
    random crop, flip/rot augment, optional Gaussian noise,
    log-domain transform, optional histeq concat; val split modes 0/1/2
    (split 1 returns six overlapping 256^2 tiles).
  * LoLDataset (:409-502): crop/flip/rotation variant.
  * LoLDatasetV2 (:505-612): Synthetic + Real_captured trees, gamma aug.

Images are preloaded once as uint8 RGB (the reference preloads float32;
uint8 halves resident memory) and converted per sample. ``cv2`` is imported
inside the functions that use it, not at package import.
"""

from __future__ import annotations

import os
import random
from typing import Any, List

import numpy as np

from ..utils.imgproc import hiseq_color_cv2_img, random_resize  # noqa: F401  (one of this module's names in JAX)


def _imread_rgb(path):
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def paired_random_crop(hr, lr, his, gt_patch_size, scale=1):
    h_lq, w_lq = lr.shape[:2]
    lq_patch = gt_patch_size // scale
    top = random.randint(0, h_lq - lq_patch)
    left = random.randint(0, w_lq - lq_patch)
    lr = lr[top : top + lq_patch, left : left + lq_patch]
    if his is not None:
        his = his[top : top + lq_patch, left : left + lq_patch]
    top_gt, left_gt = top * scale, left * scale
    hr = hr[top_gt : top_gt + gt_patch_size, left_gt : left_gt + gt_patch_size]
    return hr, lr, his


def augment(imgs, hflip=True, rotation=True):
    hflip = hflip and random.random() < 0.5
    vflip = rotation and random.random() < 0.5
    rot90 = rotation and random.random() < 0.5

    def _augment(img):
        if img is None:
            return None
        if hflip:
            img = img[:, ::-1]
        if vflip:
            img = img[::-1]
        if rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_augment(im) for im in imgs]


def log_low_np(lr):
    return np.log(np.clip(lr + 1e-3, 1e-3, None)).astype(np.float32)


class _PairedBase:
    """Shared option parsing (reference: LoL_dataset.py:250-272)."""

    def __init__(self, opt, train, all_opt):
        self.opt = opt
        self.train = train
        self.concat_histeq = bool(all_opt.get("concat_histeq") or False)
        self.histeq_as_input = bool(all_opt.get("histeq_as_input") or False)
        self.log_low = bool(opt.get("log_low") or False)
        self.use_flip = bool(opt.get("use_flip") or False)
        self.use_rot = bool(opt.get("use_rot") or False)
        self.use_crop = bool(opt.get("use_crop") or False)
        self.noise_prob = opt.get("noise_prob") or 0
        self.noise_level = opt.get("noise_level") or 0
        self.center_crop_hr_size = opt.get("center_crop_hr_size")
        self.crop_size = opt.get("GT_size")
        self.pairs: List[Any] = []

    def __len__(self):
        return len(self.pairs)

    def _finalize(self, lr, hr, his, rng=random):
        """float conversion, noise, log transform, histeq concat."""
        lr = lr.astype(np.float32) / 255.0 if lr.dtype == np.uint8 else lr
        hr = hr.astype(np.float32) / 255.0 if hr.dtype == np.uint8 else hr
        if self.noise_prob and rng.random() < self.noise_prob:
            lr = lr + np.random.standard_normal(lr.shape).astype(np.float32) * (
                self.noise_level / 255.0
            )
        if self.log_low:
            lr = log_low_np(lr)
        if self.concat_histeq and his is not None:
            his = his.astype(np.float32) / 255.0 if his.dtype == np.uint8 else his
            lr = np.concatenate([lr, his], axis=-1)
        return lr.astype(np.float32), hr.astype(np.float32)


class LoLDatasetRIDCP(_PairedBase):
    """The shipped train/val dataset (reference: LoL_dataset.py:250-403)."""

    def __init__(self, opt, train, all_opt):
        super().__init__(opt, train, all_opt)
        root = os.path.join(opt["root"], "our485" if train else "eval15")
        self.root = root
        self._load_pairs(root)

    def _load_pairs(self, folder):
        low_dir = os.path.join(folder, "low")
        for f_name in sorted(os.listdir(low_dir)):
            lr = _imread_rgb(os.path.join(folder, "low", f_name))
            hr = _imread_rgb(os.path.join(folder, "high", f_name))
            his = hiseq_color_cv2_img(lr)
            self.pairs.append([lr, hr, f_name.split(".")[0], his])

    def __getitem__(self, item):
        lr, hr, f_name, his = self.pairs[item]
        lr = lr.astype(np.float32) / 255.0
        hr = hr.astype(np.float32) / 255.0
        his = his.astype(np.float32) / 255.0

        if self.train:
            input_gt_size = min(hr.shape[:2])
            input_lq_size = min(lr.shape[:2])
            scale = input_gt_size // input_lq_size
            if self.opt.get("use_resize_crop"):
                if input_gt_size > self.crop_size:
                    target = random.randint(self.crop_size, input_gt_size)
                    target -= target % scale
                    resize_factor = target / input_gt_size
                else:
                    resize_factor = (self.crop_size + 1) / input_gt_size
                hr = random_resize(hr, resize_factor)
                lr = random_resize(lr, resize_factor)
                his = random_resize(his, resize_factor)
                hr, lr, his = paired_random_crop(hr, lr, his, self.crop_size, scale)
            hr, lr, his = augment([hr, lr, his], self.use_flip, self.use_rot)
            lq, gt = self._finalize(lr, hr, his)
            return {"LQ": lq, "GT": gt, "LQ_path": f_name, "GT_path": f_name}

        # val modes (reference: LoL_dataset.py:344-403)
        split = self.opt.get("split", 0)
        lq, gt = self._finalize(lr, hr, his)
        if split == 1:
            tiles = {
                "up_left": lq[0:256, 0:256],
                "up_middle": lq[0:256, 172:428],
                "up_right": lq[0:256, 344:],
                "down_left": lq[144:, 0:256],
                "down_middle": lq[144:, 172:428],
                "down_right": lq[144:, 344:],
            }
            return {"tiles": tiles, "LQ": lq, "GT": gt, "name": f_name}
        if split == 2:
            return {
                "LQ_left": lq[:, 0:592],
                "LQ_right": lq[:, 8:],
                "name": f_name,
                "GT": gt,
            }
        return {"LQ": lq, "GT": gt, "LQ_path": f_name, "GT_path": f_name}


class LoLDataset(_PairedBase):
    """Classic LOL loader (reference: LoL_dataset.py:409-502)."""

    def __init__(self, opt, train, all_opt):
        super().__init__(opt, train, all_opt)
        root = os.path.join(opt["root"], "our485" if train else "eval15")
        self._load_pairs(root)

    def _load_pairs(self, folder):
        low_dir = os.path.join(folder, "low")
        names = sorted(x for x in os.listdir(low_dir) if "png" in x)
        for f_name in names:
            lr = _imread_rgb(os.path.join(folder, "low", f_name))
            hr = _imread_rgb(os.path.join(folder, "high", f_name))
            his = hiseq_color_cv2_img(lr)
            self.pairs.append([lr, hr, f_name.split(".")[0], his])

    def __getitem__(self, item):
        lr, hr, f_name, his = self.pairs[item]
        if self.histeq_as_input:
            lr = his
        if self.use_crop:
            hr, lr, his = _random_crop3(hr, lr, his, self.crop_size)
        if self.use_flip:
            hr, lr, his = _random_flip3(hr, lr, his)
        if self.use_rot:
            hr, lr, his = _random_rot3(hr, lr, his)
        lq, gt = self._finalize(lr, hr, his)
        return {"LQ": lq, "GT": gt, "LQ_path": f_name, "GT_path": f_name}


class LoLDatasetV2(_PairedBase):
    """LOL-v2 Synthetic + Real_captured (reference: LoL_dataset.py:505-612)."""

    def __init__(self, opt, train, all_opt):
        super().__init__(opt, train, all_opt)
        self.gamma_aug = bool(opt.get("gamma_aug") or False)
        for sub_data in ["Synthetic", "Real_captured"]:
            root = os.path.join(opt["root"], sub_data, "Train" if train else "Test")
            if os.path.isdir(root):
                self._load_pairs(root, train)

    def _load_pairs(self, folder, train):
        low_name = "Low" if train else "low"
        high_name = "Normal" if train else "high"
        lows = sorted(x for x in os.listdir(os.path.join(folder, low_name)) if "png" in x)
        highs = sorted(x for x in os.listdir(os.path.join(folder, high_name)) if "png" in x)
        for f_low, f_high in zip(lows, highs):
            lr = _imread_rgb(os.path.join(folder, low_name, f_low))
            hr = _imread_rgb(os.path.join(folder, high_name, f_high))
            his = hiseq_color_cv2_img(lr)
            self.pairs.append([lr, hr, f_high.split(".")[0], his])

    def __getitem__(self, item):
        lr, hr, f_name, his = self.pairs[item]
        if self.histeq_as_input:
            lr = his
        if self.use_crop:
            hr, lr, his = _random_crop3(hr, lr, his, self.crop_size)
        if self.use_flip:
            hr, lr, his = _random_flip3(hr, lr, his)
        if self.use_rot:
            hr, lr, his = _random_rot3(hr, lr, his)
        if self.gamma_aug:
            gamma = random.uniform(0.4, 2.8)
            lr = _gamma_aug(lr, gamma)
        lq, gt = self._finalize(lr, hr, his)
        return {"LQ": lq, "GT": gt, "LQ_path": f_name, "GT_path": f_name}


def _random_crop3(hr, lr, his, size):
    h, w = lr.shape[:2]
    sx = np.random.randint(0, h - size + 1) if h > size else 0
    sy = np.random.randint(0, w - size + 1) if w > size else 0
    crop = lambda im: None if im is None else im[sx : sx + size, sy : sy + size]
    return crop(hr), crop(lr), crop(his)


def _random_flip3(hr, lr, his):
    if np.random.choice([True, False]):
        return hr, lr, his
    f = lambda im: None if im is None else np.ascontiguousarray(np.flip(im, 1))
    return f(hr), f(lr), f(his)


def _random_rot3(hr, lr, his):
    k = int(np.random.choice([0, 1, 3]))
    r = lambda im: None if im is None else np.ascontiguousarray(np.rot90(im, k, axes=(0, 1)))
    return r(hr), r(lr), r(his)


def _gamma_aug(img, gamma):
    img = img.astype(np.float32)
    max_val = img.max()
    if max_val <= 0:
        return img
    out = np.power(img / max_val, gamma) * max_val
    return out
