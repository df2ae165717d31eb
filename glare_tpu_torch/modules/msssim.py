"""Differentiable SSIM / MS-SSIM loss (counterpart of ``glare_tpu/modules/msssim.py``).

Semantics kept: 11x11 sigma=1.5 Gaussian window (smaller on images under 11
px), *valid* (no-pad) depthwise convolution, a per-level 2x2 average-pool
pyramid with weights [0.0448, 0.2856, 0.3001, 0.2363, 0.1333];
``normalize=True`` maps ssim and cs through (x+1)/2 (stage-3 training uses it).
The NaN guards: the window convolutions in float32 (no TF32: the package turns
it off), variances clamped at 0, and a 1e-6 floor under the fractional powers.
The reference's combination ``prod(pow1[:-1] * pow2[-1])`` is kept bug for bug.
NHWC inputs, like the JAX functions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(window_size=11, sigma=1.5, device=None):
    g = torch.tensor([math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
                      for x in range(window_size)], dtype=torch.float64)
    g = g / g.sum()
    return torch.outer(g, g).to(device=device, dtype=torch.float32)


def _filter_valid(img, window):
    """Depthwise valid convolution of NHWC ``img`` with a 2-D window, in float32."""
    c = img.shape[-1]
    x = img.float().permute(0, 3, 1, 2)
    k = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(x, k, groups=c).permute(0, 2, 3, 1)


def ssim(img1, img2, window_size=11, val_range=1.0, full=False, batch_mean=torch.mean):
    """Mean SSIM over the batch; NHWC inputs in [0, 1]. ``batch_mean`` takes the two
    means over batch and space (data parallelism passes ``parallel.global_mean``)."""
    h, w = img1.shape[1], img1.shape[2]
    window = _gaussian_window(min(window_size, h, w), device=img1.device)
    mu1 = _filter_valid(img1, window)
    mu2 = _filter_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    # E[x^2] - mu^2 cancels to a residue that may dip below 0: clamp it, so that
    # v2 = sigma1 + sigma2 + C2 stays >= C2 > 0
    sigma1_sq = torch.clamp(_filter_valid(img1 * img1, window) - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(_filter_valid(img2 * img2, window) - mu2_sq, min=0.0)
    sigma12 = _filter_valid(img1 * img2, window) - mu1_mu2
    C1 = (0.01 * val_range) ** 2
    C2 = (0.03 * val_range) ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    cs = batch_mean(v1 / v2)
    ret = batch_mean(((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2))
    return (ret, cs) if full else ret


def msssim(img1, img2, window_size=11, val_range=1.0, normalize=False, batch_mean=torch.mean):
    """5-level MS-SSIM (reference: pytorch_msssim/__init__.py:71-104). The levels'
    means combine non-linearly, so a data-parallel step passes the whole batch's
    mean as ``batch_mean`` (see :func:`ssim`)."""
    mssim, mcs = [], []
    for _ in _WEIGHTS:
        sim, cs = ssim(img1, img2, window_size=window_size, val_range=val_range, full=True,
                       batch_mean=batch_mean)
        mssim.append(sim)
        mcs.append(cs)
        img1 = F.avg_pool2d(img1.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        img2 = F.avg_pool2d(img2.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    weights = torch.tensor(_WEIGHTS, dtype=torch.float32, device=mssim[0].device)
    return _combine(torch.stack(mssim), torch.stack(mcs), weights, normalize)


def _combine(mssim, mcs, weights, normalize):
    """Per-level ssim / cs -> scalar MS-SSIM."""
    if normalize:
        mssim = (mssim + 1) / 2
        mcs = (mcs + 1) / 2
    # a fractional power of a (slightly) negative base is NaN: floor the bases
    pow1 = torch.clamp(mcs, min=1e-6) ** weights
    pow2 = torch.clamp(mssim, min=1e-6) ** weights
    # the reference's quirk, kept: prod(pow1[:-1] * pow2[-1]) = prod(pow1[:-1]) * pow2[-1]**4
    return torch.prod(pow1[:-1] * pow2[-1])
