"""On-the-fly haze synthesis (counterpart of ``glare_tpu/sr/data/haze_online_dataset.py``;
reference: basicsr/data/haze_online_dataset.py:17-192). Host numpy and cv2.

lq = gamma(gt) (+ Gaussian noise) * t + A * (1 - t) (+ JPEG noise), with the
transmission t = exp(-(1 - depth_norm) * 2 * beta), beta ~ U(beta_range), the
airlight A ~ U(A_range) (+ a per-channel colour cast with probability
``color_p``), then the RIDCP random resize-crop and flip / rotation in training.
Draws come from Python's ``random`` and ``np.random`` in the JAX module's order,
so an item under the same seeds is bit-equal to its. Items are NHWC float32 RGB
in [0, 1]; ``dataroot_depth`` holds ``<name>.npy`` depth maps beside the GT
images. ``cv2`` (and scipy, for the correlated noise) is imported where it is used.
"""

from __future__ import annotations

import os
import random

import numpy as np

from ...data.lol_dataset import augment, paired_random_crop, random_resize
from ..registry import DATASET_REGISTRY

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def make_dataset(folder):
    """Sorted paths of the images under ``folder`` (recursively)."""
    paths = []
    for root, _, names in sorted(os.walk(folder)):
        for n in sorted(names):
            if n.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(root, n))
    return paths


def add_gaussian_noise(img, noise_level1=2, noise_level2=25):
    """Colour (p 0.4), grayscale (p 0.4) or correlated colour noise (p 0.2) of a
    level drawn from [noise_level1, noise_level2] / 255; clipped to [0, 1]."""
    noise_level = random.randint(noise_level1, noise_level2)
    rnum = np.random.rand()
    if rnum > 0.6:  # colour noise
        img = img + np.random.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:  # grayscale noise
        img = img + np.random.normal(0, noise_level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
    else:  # correlated colour noise
        from scipy.linalg import orth

        L = noise_level2 / 255.0
        D = np.diag(np.random.rand(3))
        U = orth(np.random.rand(3, 3))
        conv = np.dot(np.dot(np.transpose(U), D), U)
        img = img + np.random.multivariate_normal([0, 0, 0], np.abs(L ** 2 * conv),
                                                  img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img_rgb):
    """An OpenCV JPEG round trip at a quality drawn from [30, 95]."""
    import cv2

    quality = random.randint(30, 95)
    bgr = cv2.cvtColor((np.clip(img_rgb, 0, 1) * 255.0).round().astype(np.uint8), cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.cvtColor(cv2.imdecode(enc, 1), cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


@DATASET_REGISTRY.register()
class HazeOnlineDataset:
    def __init__(self, opt):
        self.opt = opt
        self.gt_folder = opt["dataroot_gt"]
        self.depth_folder = opt["dataroot_depth"]
        self.gt_paths = make_dataset(self.gt_folder)
        self.beta_range = opt.get("beta_range", [0.3, 1.5])
        self.A_range = opt.get("A_range", [0.25, 1.0])
        self.color_p = opt.get("color_p", 1.0)
        self.color_range = opt.get("color_range", [-0.025, 0.025])

    def __len__(self):
        return len(self.gt_paths)

    def __getitem__(self, index):
        import cv2

        gt_path = self.gt_paths[index]
        img = cv2.imread(gt_path)
        if img is None:
            raise IOError(f"cannot read {gt_path}")
        img_gt = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0

        base = os.path.splitext(os.path.basename(gt_path))[0]
        img_depth = np.load(os.path.join(self.depth_folder, base + ".npy"))
        img_depth = (img_depth - img_depth.min()) / (img_depth.max() - img_depth.min() + 1e-8)

        beta = np.random.rand() * (self.beta_range[1] - self.beta_range[0]) + self.beta_range[0]
        t = np.exp(-(1 - img_depth) * 2.0 * beta)[:, :, None].astype(np.float32)

        A = np.random.rand() * (self.A_range[1] - self.A_range[0]) + self.A_range[0]
        if np.random.rand() < self.color_p:
            A = A + (np.random.rand(3) * (self.color_range[1] - self.color_range[0]) + self.color_range[0])

        img_lq = img_gt.copy()
        if np.random.rand() < 0.5:  # luminance
            img_lq = np.power(img_lq, np.random.rand() * 1.5 + 1.5)
        if np.random.rand() < 0.5:
            img_lq = add_gaussian_noise(img_lq)
        img_lq = img_lq * t + A * (1 - t)
        if np.random.rand() < 0.5:
            img_lq = add_jpeg_noise(img_lq)

        if self.opt.get("phase") == "train":
            input_gt_size = int(np.min(img_gt.shape[:2]))
            gt_size = self.opt["gt_size"]
            if self.opt.get("use_resize_crop", True):
                if input_gt_size > gt_size:
                    resize_factor = random.randint(gt_size, input_gt_size) / input_gt_size
                else:
                    resize_factor = (gt_size + 1) / input_gt_size
                img_gt = random_resize(img_gt, resize_factor)
                img_lq = random_resize(img_lq, resize_factor)
                img_gt, img_lq, _ = paired_random_crop(img_gt, img_lq, None, gt_size, 1)
            img_gt, img_lq = augment([img_gt, img_lq], self.opt.get("use_flip", True),
                                     self.opt.get("use_rot", True))
        return {"lq": np.ascontiguousarray(img_lq.astype(np.float32)),
                "gt": np.ascontiguousarray(img_gt.astype(np.float32)),
                "lq_path": gt_path, "gt_path": gt_path}
