"""Registered evaluation metrics (counterpart of ``glare_tpu/sr/metrics.py``;
reference: basicsr/metrics): PSNR / SSIM in the [0, 255] convention with
``crop_border`` and the BT.601 Y channel (``test_y_channel``), NIQE
(``utils/niqe.py``: pristine-model parameters from ``pris_params=(mu, cov)`` or
``$GLARE_NIQE_PARAMS``, else JAX's informative error), FID (``metrics_fid.py``,
registered on import) and :func:`build_metric`. Host-side numpy and scipy.
"""

from __future__ import annotations

import numpy as np

from ..utils.matlab_functions import rgb2ycbcr
from ..utils.metrics import calculate_psnr as _psnr_255
from ..utils.metrics import calculate_ssim as _ssim_255
from .registry import METRIC_REGISTRY


def _prep(img, crop_border, test_y_channel, input_order="HWC"):
    img = np.asarray(img)
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel and img.ndim == 3 and img.shape[2] == 3:
        imgf = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
        img = rgb2ycbcr(imgf, y_only=True) * 255.0
    return img


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border=0, input_order="HWC", test_y_channel=False, **_):
    """PSNR in the [0, 255] convention."""
    a = _prep(img, crop_border, test_y_channel, input_order)
    b = _prep(img2, crop_border, test_y_channel, input_order)
    return _psnr_255(a, b)


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border=0, input_order="HWC", test_y_channel=False, **_):
    """MATLAB-style SSIM (11x11 Gaussian window, per-channel mean)."""
    a = _prep(img, crop_border, test_y_channel, input_order)
    b = _prep(img2, crop_border, test_y_channel, input_order)
    return _ssim_255(a, b)


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border=0, input_order="HWC", convert_to="y", **kw):
    """NIQE (``utils/niqe.py:calculate_niqe``): parameters from ``pris_params=(mu,
    cov)``, ``$GLARE_NIQE_PARAMS`` or ``utils.niqe.fit_niqe_params``; without any
    of them it raises an informative NotImplementedError."""
    from ..utils.niqe import calculate_niqe as _niqe

    return _niqe(img, crop_border=crop_border, input_order=input_order,
                 convert_to=convert_to, **kw)


# importing registers `calculate_fid` (the Frechet distance and its stats-file workflow)
from . import metrics_fid  # noqa: F401,E402


def build_metric(name):
    return METRIC_REGISTRY.get(name)
