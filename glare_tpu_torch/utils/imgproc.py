"""Image IO and the GLARE preprocessing chain (the port's own copy of what the
inference CLIs need from ``glare_tpu/utils/imgproc.py``).

  * BGR->RGB reads, reflect padding (``impad``), the log-domain transform
    ``log(clamp(x + 1e-3, 1e-3))``, per-channel histogram equalization.
  * ``to_float01`` (uint8 -> float32 in [0, 1]), ``to_nhwc_batch`` (HWC -> 1HWC
    float32) and ``from_nhwc_batch`` (1HWC or HWC -> HWC clipped to [0, 1]).

``cv2`` is imported inside the functions that use it, not at package import.
"""

from __future__ import annotations

import os

import numpy as np


def imread(path):
    """Read as RGB HWC uint8."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"Failed to read image: {path}")
    return img[:, :, [2, 1, 0]]


def imwrite(path, img_rgb):
    import cv2

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if not cv2.imwrite(path, np.asarray(img_rgb)[:, :, [2, 1, 0]]):
        raise IOError(f"Failed to write image: {path}")


def impad(img, top=0, bottom=0, left=0, right=0):
    """Reflect-pad HWC."""
    return np.pad(img, [(top, bottom), (left, right), (0, 0)], "reflect")


def random_resize(img, scale_factor=1.0):
    """Bicubic resize of an HWC image by ``scale_factor`` (cv2.INTER_CUBIC)."""
    import cv2

    return cv2.resize(img, None, fx=scale_factor, fy=scale_factor, interpolation=cv2.INTER_CUBIC)


def auto_padding(img, times=16):
    """Reflect-pad HWC (edge pixel repeated, as ``cv2.BORDER_REFLECT``) to a
    multiple of ``times``; returns (padded, [h1, h2, w1, w2]). An image that is
    already a multiple gets a full ``times`` more, as in the reference."""
    h, w, _ = img.shape
    h1, w1 = (times - h % times) // 2, (times - w % times) // 2
    h2, w2 = (times - h % times) - h1, (times - w % times) - w1
    return np.pad(img, [(h1, h2), (w1, w2), (0, 0)], "symmetric"), [h1, h2, w1, w2]


def hiseq_color_cv2_img(img):
    """Per-channel histogram equalization."""
    import cv2

    b, g, r = cv2.split(img)
    return cv2.merge((cv2.equalizeHist(b), cv2.equalizeHist(g), cv2.equalizeHist(r)))


def log_transform(x, eps=1e-3):
    """``log(clamp(x + eps, eps))`` on float arrays in [0, 1]."""
    return np.log(np.clip(np.asarray(x, np.float32) + eps, eps, None))


def to_float01(img_uint8):
    return np.asarray(img_uint8).astype(np.float32) / 255.0


def to_nhwc_batch(img_hwc):
    """HWC float -> 1HWC float32 batch."""
    return np.expand_dims(np.asarray(img_hwc, np.float32), axis=0)


def from_nhwc_batch(x):
    """1HWC (or HWC) -> HWC numpy, clipped to [0, 1]. Takes numpy arrays and CPU
    tensors."""
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    return np.clip(x, 0.0, 1.0)


def preprocess_padded(img_u8, top=0, bottom=0, left=0, right=0, apply_log=False, eps=1e-3):
    """uint8 HWC -> reflect-padded float32 HWC in [0, 1], optionally log-domain."""
    x = np.asarray(img_u8).astype(np.float32) / 255.0
    if apply_log:
        x = log_transform(x, eps)
    return np.pad(x, [(top, bottom), (left, right), (0, 0)], "reflect")
