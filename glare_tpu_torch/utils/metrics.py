"""Evaluation metrics of the published protocol (the port's own copy of what the
paired-inference CLI needs from ``glare_tpu/utils/metrics.py``).

  * :func:`PSNR` -- [0,1]-domain PSNR; :func:`calculate_psnr` -- [0,255]-domain.
  * :func:`calculate_ssim` / :func:`ssim_single` -- MATLAB-style SSIM with an
    11x11 sigma=1.5 Gaussian window, per-channel mean for colour images.
  * :func:`img_as_ubyte` -- float [0,1] -> uint8 (round-half-even).
  * :func:`gray_mean_adjust` -- the gray-mean brightness adjustment applied
    before PSNR in the published protocol.

numpy and scipy in float64, no ``cv2``: SSIM's window is separable, so two
1-D correlations give ``cv2.filter2D``'s valid region, and ``COLOR_BGR2GRAY`` is
the weighted sum 0.114 / 0.587 / 0.299.
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


def _gaussian_1d(size=11, sigma=1.5):
    """``cv2.getGaussianKernel(size, sigma)`` as a float64 vector."""
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * x * x / (sigma * sigma))
    return g / g.sum()


def _window_valid(img, k):
    """The 2-D correlation of ``img`` with ``outer(k, k)`` on its valid region
    (what ``cv2.filter2D(img, -1, window)[5:-5, 5:-5]`` keeps), float64."""
    from scipy.ndimage import correlate1d

    r = len(k) // 2
    rows = correlate1d(img, k, axis=0, mode="constant")[r:-r]
    return correlate1d(rows, k, axis=1, mode="constant")[:, r:-r]


def calculate_psnr(img1, img2, border=0):
    """[0,255]-domain PSNR; inf on exact match."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border: h - border or None, border: w - border or None].astype(np.float64)
    img2 = img2[border: h - border or None, border: w - border or None].astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def ssim_single(img1, img2):
    """Single-channel MATLAB SSIM, inputs in [0,255]."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    k = _gaussian_1d()
    mu1 = _window_valid(img1, k)
    mu2 = _window_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _window_valid(img1 ** 2, k) - mu1_sq
    sigma2_sq = _window_valid(img2 ** 2, k) - mu2_sq
    sigma12 = _window_valid(img1 * img2, k) - mu1_mu2
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
    arrays (gray = 0.114 c0 + 0.587 c1 + 0.299 c2); that quirk is part of the
    published protocol and is kept. The means are taken in float64 (cv2 works
    in float32)."""
    bgr2gray = np.array([0.114, 0.587, 0.299])
    mean_restored = (np.asarray(restored, np.float64) @ bgr2gray).mean()
    mean_target = (np.asarray(target, np.float64) @ bgr2gray).mean()
    return np.clip(restored * (mean_target / mean_restored), 0, 1)
