"""NIQE — Natural Image Quality Evaluator (no-reference metric).

The port's own copy of ``glare_tpu/utils/niqe.py`` (numpy and scipy only).

MATLAB-convention reimplementation (Mittal, Soundararajan, Bovik, "Making a
'Completely Blind' Image Quality Analyzer", IEEE SPL 2013) matching the
basicsr/MATLAB pipeline the reference's `calculate_niqe` CLI expects
(reference: defor_cuda_ext/basicsr/metrics/calculate_niqe.py — the CLI
imports `basicsr.metrics.calculate_niqe`, never vendored; this is the
working equivalent, SURVEY.md §2.2).

Pipeline: Y-channel [0,255] → per-scale MSCN coefficients (7×7 Gaussian
local mean/std, σ=7/6) → per-96×96-block GGD/AGGD fits (18 features ×2
scales) → Mahalanobis distance between the image's MVG and a pristine-model
MVG.

The pristine-model parameters (mu 36-vector + 36×36 covariance, fitted on
125 pristine images in the original release) are a published artifact we
cannot download offline. Three supported sources, in order:
  1. ``GLARE_NIQE_PARAMS`` env → ``.npz`` with ``mu_pris_param``/
     ``cov_pris_param`` (basicsr's niqe_pris_params.npz layout) or the
     original ``modelparameters.mat`` (keys ``pop_mu``/``pop_cov``).
  2. an explicit ``pris_params=(mu, cov)`` argument.
  3. :func:`fit_niqe_params` — fit the MVG on your own pristine corpus
     (exactly how the published file was produced).
Everything is numpy on the host: no device is involved.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as _gamma

from .matlab_functions import bgr2ycbcr, imresize, rgb2ycbcr

# Candidate shape parameters for the (A)GGD grid searches (MATLAB: 0.2:0.001:10)
_GAM = np.arange(0.2, 10.001, 0.001)
_GAM_RECIP = 1.0 / _GAM
# GGD: rho(g) = Γ(1/g)Γ(3/g)/Γ(2/g)² , matched against m2/m1²
_GGD_RHO = _gamma(_GAM_RECIP) * _gamma(3 * _GAM_RECIP) / (_gamma(2 * _GAM_RECIP) ** 2)
# AGGD: r(g) = Γ(2/g)²/(Γ(1/g)Γ(3/g)), matched against the normalized rhat
_AGGD_R = (_gamma(2 * _GAM_RECIP) ** 2) / (_gamma(_GAM_RECIP) * _gamma(3 * _GAM_RECIP))


def _gaussian_window(size=7, sigma=7.0 / 6.0):
    """MATLAB fspecial('gaussian', 7, 7/6), normalized to sum 1."""
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    g = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    return g / g.sum()


def estimate_ggd_param(vec):
    """Fit a zero-mean generalized Gaussian: returns (alpha, sigma)."""
    vec = vec.ravel()
    sigma_sq = float(np.mean(vec**2))
    e_abs = float(np.mean(np.abs(vec)))
    if e_abs == 0.0:
        return _GAM[0], math.sqrt(sigma_sq)
    rho = sigma_sq / (e_abs * e_abs)
    alpha = _GAM[np.argmin((_GGD_RHO - rho) ** 2)]
    return float(alpha), math.sqrt(sigma_sq)


def estimate_aggd_param(vec):
    """Fit an asymmetric GGD: returns (alpha, beta_l, beta_r)."""
    vec = vec.ravel()
    neg = vec[vec < 0]
    pos = vec[vec > 0]
    left_std = math.sqrt(np.mean(neg**2)) if neg.size else 0.0
    right_std = math.sqrt(np.mean(pos**2)) if pos.size else 0.0
    if left_std == 0.0 or right_std == 0.0:
        gammahat = 1.0 if left_std == right_std else np.inf
    else:
        gammahat = left_std / right_std
    m1 = float(np.mean(np.abs(vec)))
    m2 = float(np.mean(vec**2))
    rhat = (m1 * m1 / m2) if m2 > 0 else 0.0
    denom = (gammahat * gammahat + 1.0) ** 2
    rhatnorm = rhat * (gammahat**3 + 1.0) * (gammahat + 1.0) / denom if np.isfinite(gammahat) else 0.0
    alpha = _GAM[np.argmin((_AGGD_R - rhatnorm) ** 2)]
    scale = math.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    return float(alpha), left_std * scale, right_std * scale


def compute_niqe_feature(block):
    """18 NIQE features of one MSCN block (2 GGD-style + 4 orientations×4)."""
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2.0])
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def niqe_features(img, block_size=96):
    """Per-block 36-feature matrix of a [0,255] float grayscale image.

    Two scales; blocks are block_size² at scale 1 and (block_size/2)² at
    scale 2, aligned so the same image region feeds both scales' features.
    """
    img = np.asarray(img, np.float64)
    assert img.ndim == 2, "niqe expects a single-channel [0,255] image"
    h, w = img.shape
    num_bh, num_bw = h // block_size, w // block_size
    if num_bh == 0 or num_bw == 0:
        raise ValueError(
            f"image {img.shape} smaller than one {block_size}x{block_size} NIQE block"
        )
    img = img[: num_bh * block_size, : num_bw * block_size]
    window = _gaussian_window()

    scale_feats = []
    for scale in (1, 2):
        mu = convolve(img, window, mode="nearest")
        sigma = np.sqrt(np.abs(convolve(img * img, window, mode="nearest") - mu * mu))
        mscn = (img - mu) / (sigma + 1.0)

        bs = block_size // scale
        feats = [
            compute_niqe_feature(mscn[bi * bs : (bi + 1) * bs, bj * bs : (bj + 1) * bs])
            for bi in range(num_bh)
            for bj in range(num_bw)
        ]
        scale_feats.append(np.asarray(feats, np.float64))
        if scale == 1:
            # MATLAB: next scale works on imresize(img/255, 0.5)*255
            img = imresize(img / 255.0, 0.5, antialiasing=True) * 255.0
    return np.concatenate(scale_feats, axis=1)  # [num_blocks, 36]


def niqe(img, mu_pris_param, cov_pris_param, block_size=96):
    """NIQE score of a [0,255] grayscale image (lower = more natural)."""
    feats = niqe_features(img, block_size=block_size)
    finite = np.all(np.isfinite(feats), axis=1)
    mu_dist = np.nanmean(feats, axis=0)
    cov_dist = np.cov(feats[finite], rowvar=False)
    mid_cov = (np.asarray(cov_pris_param) + cov_dist) / 2.0
    diff = np.asarray(mu_pris_param) - mu_dist
    quality = diff @ np.linalg.pinv(mid_cov) @ diff
    return float(np.sqrt(max(quality, 0.0)))


def fit_niqe_params(images, block_size=96):
    """Fit the pristine MVG (mu, cov) from an iterable of [0,255] grayscale
    images — the same procedure that produced the published
    modelparameters.mat (fitted there on 125 pristine photographs)."""
    all_feats = [niqe_features(np.asarray(im, np.float64), block_size) for im in images]
    feats = np.concatenate(all_feats, axis=0)
    feats = feats[np.all(np.isfinite(feats), axis=1)]
    return np.mean(feats, axis=0), np.cov(feats, rowvar=False)


def load_niqe_params(path=None):
    """Load pristine parameters from ``path`` or ``$GLARE_NIQE_PARAMS``.

    Accepts basicsr's ``niqe_pris_params.npz`` (mu_pris_param/cov_pris_param)
    or the original MATLAB ``modelparameters.mat`` (pop_mu/pop_cov).
    Returns (mu, cov) or None when no file is configured/present.
    """
    path = path or os.environ.get("GLARE_NIQE_PARAMS")
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".mat"):
        from scipy.io import loadmat

        m = loadmat(path)
        return np.asarray(m["pop_mu"]).ravel(), np.asarray(m["pop_cov"])
    data = np.load(path)
    if "mu_pris_param" in data:
        return np.asarray(data["mu_pris_param"]).ravel(), np.asarray(data["cov_pris_param"])
    return np.asarray(data["mu"]).ravel(), np.asarray(data["cov"])


def calculate_niqe(img, crop_border=0, input_order="HWC", convert_to="y",
                   pris_params=None, block_size=96, **_):
    """basicsr-surface NIQE (reference CLI: metrics/calculate_niqe.py:21).

    ``img``: uint8/float image, HWC (BGR, cv2 convention) / CHW / HW.
    ``convert_to``: 'y' (BT.601 Y from BGR input, like basicsr) or 'gray'.
    """
    if pris_params is None:
        pris_params = load_niqe_params()
    if pris_params is None:
        raise NotImplementedError(
            "NIQE needs the pristine-model parameters: set GLARE_NIQE_PARAMS "
            "to niqe_pris_params.npz or modelparameters.mat, pass "
            "pris_params=(mu, cov), or fit your own with "
            "glare_tpu_torch.utils.niqe.fit_niqe_params (the reference's CLI is "
            "non-functional as shipped too — it imports a never-vendored "
            "basicsr.metrics)."
        )
    mu_pris, cov_pris = pris_params

    img = np.asarray(img)
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
    imgf = img.astype(np.float64) / 255.0 if img.dtype == np.uint8 else img.astype(np.float64)
    if img.dtype != np.uint8 and imgf.max() > 2.0:
        imgf = imgf / 255.0
    if imgf.ndim == 3 and imgf.shape[2] == 3:
        if convert_to == "y":
            imgf = bgr2ycbcr(imgf.astype(np.float32), y_only=True).astype(np.float64)
        elif convert_to == "gray":
            # cv2 BGR2GRAY weights
            imgf = imgf @ np.asarray([0.114, 0.587, 0.299], np.float64)
        else:
            raise ValueError(f"unknown convert_to={convert_to!r}")
    elif imgf.ndim == 3:
        imgf = imgf[:, :, 0]
    img_y = imgf * 255.0
    # MATLAB rounds to integer gray levels before MSCN
    img_y = np.round(img_y)
    if crop_border:
        img_y = img_y[crop_border:-crop_border, crop_border:-crop_border]
    return niqe(img_y, mu_pris, cov_pris, block_size=block_size)
