"""Registered evaluation metrics (counterpart of ``glare_tpu/sr/metrics.py``;
reference: basicsr/metrics): PSNR / SSIM in the [0, 255] convention with
``crop_border`` and the BT.601 Y channel (``test_y_channel``), and
:func:`build_metric`. NIQE needs pristine-model parameters and is not ported:
it raises. The [0, 255] PSNR and the Y conversion are the port's own copies
(``glare_tpu/utils/metrics.py``, ``glare_tpu/utils/matlab_functions.py``).
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.metrics import calculate_ssim as _ssim_255
from .registry import METRIC_REGISTRY


def rgb2ycbcr_y(img):
    """BT.601 luma of float RGB in [0, 1], as MATLAB's ``rgb2ycbcr`` gives it
    (in [16/255, 235/255]), in the input's float type."""
    y = (np.dot(img.astype(np.float32), [65.481, 128.553, 24.966]) + 16.0) / 255.0
    return y.astype(img.dtype)


def _psnr_255(img1, img2):
    mse = np.mean((np.asarray(img1, np.float64) - np.asarray(img2, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _prep(img, crop_border, test_y_channel, input_order="HWC"):
    img = np.asarray(img)
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel and img.ndim == 3 and img.shape[2] == 3:
        imgf = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
        img = rgb2ycbcr_y(imgf) * 255.0
    return img


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border=0, input_order="HWC", test_y_channel=False, **_):
    """PSNR in the [0, 255] convention."""
    a = _prep(img, crop_border, test_y_channel, input_order)
    b = _prep(img2, crop_border, test_y_channel, input_order)
    if a.shape != b.shape:
        raise ValueError("Input images must have the same dimensions.")
    return _psnr_255(a, b)


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border=0, input_order="HWC", test_y_channel=False, **_):
    """MATLAB-style SSIM (11x11 Gaussian window, per-channel mean)."""
    a = _prep(img, crop_border, test_y_channel, input_order)
    b = _prep(img2, crop_border, test_y_channel, input_order)
    return _ssim_255(a, b)


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border=0, input_order="HWC", convert_to="y", **_):
    raise NotImplementedError(
        "NIQE needs the pristine-model parameters (niqe_pris_params.npz or "
        "modelparameters.mat) and is not ported to glare_tpu_torch yet (ROADMAP.md, queue 1); "
        "the JAX package's glare_tpu.utils.niqe computes it (GLARE_NIQE_PARAMS)")


def build_metric(name):
    return METRIC_REGISTRY.get(name)
