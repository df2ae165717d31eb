"""USM sharpening and batched 2-D filtering (counterpart of
``glare_tpu/sr/utils/img_process_util.py``; reference: basicsr/utils/img_process_util.py).

``usm_sharp`` is the host path (numpy / cv2, one HWC image); ``filter2D`` and
``USMSharp`` run on the device, NCHW: a depthwise convolution over a reflect
pad, with ``groups=C`` for one shared kernel or ``groups=B*C`` on a
[1, B*C, H, W] view for per-sample kernels, as in the reference. ``cv2`` is
imported where it is used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def usm_sharp(img, weight=0.5, radius=50, threshold=10):
    """Unsharp masking of one HWC float32 image in [0, 1]."""
    import cv2

    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype("float32")
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def filter2D(img, kernel):
    """img [B, C, H, W]; kernel [k, k] or [1, k, k] (shared) or [B, k, k]
    (per sample), k odd. -> [B, C, H, W]."""
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError("Wrong kernel size")
    b, c, h, w = img.shape
    kernel = kernel.to(img.dtype).reshape(-1, k, k)
    x = F.pad(img, (k // 2, k // 2, k // 2, k // 2), mode="reflect")
    ph, pw = x.shape[-2:]
    if kernel.shape[0] == 1:
        return F.conv2d(x, kernel[None].expand(c, 1, k, k), groups=c)
    if kernel.shape[0] != b:
        raise ValueError(f"filter2D: {kernel.shape[0]} kernels for a batch of {b}")
    weight = kernel[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    return F.conv2d(x.reshape(1, b * c, ph, pw), weight, groups=b * c).reshape(b, c, h, w)


class USMSharp(torch.nn.Module):
    """Device unsharp masking; the Gaussian is ``cv2.getGaussianKernel(radius,
    sigma)`` (an even radius becomes the next odd one: 50 -> 51), a buffer
    ``kernel`` [1, k, k]."""

    def __init__(self, radius=50, sigma=0):
        import cv2

        super().__init__()
        if radius % 2 == 0:
            radius += 1
        self.radius = radius
        g = cv2.getGaussianKernel(radius, sigma)
        self.register_buffer("kernel", torch.tensor(np.dot(g, g.T), dtype=torch.float32)[None])

    def mask(self, img, threshold=10):
        """The stage before the soft mask: -> (residual ``img - blur``, the step
        mask ``|residual| * 255 > threshold`` as floats)."""
        residual = img - filter2D(img, self.kernel)
        return residual, (torch.abs(residual) * 255 > threshold).to(img.dtype)

    def forward(self, img, weight=0.5, threshold=10):
        residual, mask = self.mask(img, threshold)
        soft_mask = filter2D(mask, self.kernel)
        sharp = torch.clamp(img + weight * residual, 0, 1)
        return soft_mask * sharp + (1 - soft_mask) * img
