"""Evaluation metrics of the published protocol (the port's own copy of what the
paired-inference CLI needs from ``glare_tpu/utils/metrics.py``).

  * :func:`PSNR` -- [0,1]-domain PSNR.
  * :func:`calculate_ssim` / :func:`ssim_single` -- MATLAB-style SSIM with an
    11x11 sigma=1.5 Gaussian window, per-channel mean for colour images.
  * :func:`img_as_ubyte` -- float [0,1] -> uint8 (round-half-even).
  * :func:`gray_mean_adjust` -- the gray-mean brightness adjustment applied
    before PSNR in the published protocol.

``cv2`` is imported inside the functions that use it.
"""

from __future__ import annotations

import math

import numpy as np


def img_as_ubyte(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    if np.issubdtype(img.dtype, np.floating):
        if img.min() < -1e-6 or img.max() > 1 + 1e-6:
            raise ValueError("img_as_ubyte: float image must be in [0, 1]")
        return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
    raise TypeError(f"unsupported dtype {img.dtype}")


def PSNR(img1, img2):
    """[0,1]-domain PSNR; returns 100 on exact match."""
    mse_ = np.mean((np.asarray(img1, np.float64) - np.asarray(img2, np.float64)) ** 2)
    if mse_ == 0:
        return 100
    return 10 * math.log10(1 / mse_)


def ssim_single(img1, img2):
    """Single-channel MATLAB SSIM, inputs in [0,255]."""
    import cv2

    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = np.outer(kernel, kernel.transpose())
    mu1 = cv2.filter2D(img1, -1, window)[5:-5, 5:-5]
    mu2 = cv2.filter2D(img2, -1, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = cv2.filter2D(img1 ** 2, -1, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = cv2.filter2D(img2 ** 2, -1, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = cv2.filter2D(img1 * img2, -1, window)[5:-5, 5:-5] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def calculate_ssim(img1, img2, border=0):
    """MATLAB-style SSIM, per-channel mean for colour."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border: h - border or None, border: w - border or None]
    img2 = img2[border: h - border or None, border: w - border or None]
    if img1.ndim == 2:
        return ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([ssim_single(img1[:, :, i], img2[:, :, i]) for i in range(3)]))
        if img1.shape[2] == 1:
            return ssim_single(img1[:, :, 0], img2[:, :, 0])
    raise ValueError("Wrong input image dimensions.")


def gray_mean_adjust(restored, target):
    """Scale ``restored`` so its gray mean matches ``target``'s, then clip.
    Inputs are HWC RGB float [0,1]. The reference calls COLOR_BGR2GRAY on RGB
    arrays; that quirk is part of the published protocol and is kept."""
    import cv2

    mean_restored = cv2.cvtColor(restored.astype(np.float32), cv2.COLOR_BGR2GRAY).mean()
    mean_target = cv2.cvtColor(target.astype(np.float32), cv2.COLOR_BGR2GRAY).mean()
    return np.clip(restored * (mean_target / mean_restored), 0, 1)
