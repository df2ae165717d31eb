"""Image IO and the GLARE preprocessing chain (the port's own copy of what the
paired-inference CLI needs from ``glare_tpu/utils/imgproc.py``).

  * BGR->RGB reads, reflect padding (``impad``), the log-domain transform
    ``log(clamp(x + 1e-3, 1e-3))``, per-channel histogram equalization.

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


def hiseq_color_cv2_img(img):
    """Per-channel histogram equalization."""
    import cv2

    b, g, r = cv2.split(img)
    return cv2.merge((cv2.equalizeHist(b), cv2.equalizeHist(g), cv2.equalizeHist(r)))


def log_transform(x, eps=1e-3):
    """``log(clamp(x + eps, eps))`` on float arrays in [0, 1]."""
    return np.log(np.clip(np.asarray(x, np.float32) + eps, eps, None))


def preprocess_padded(img_u8, top=0, bottom=0, left=0, right=0, apply_log=False, eps=1e-3):
    """uint8 HWC -> reflect-padded float32 HWC in [0, 1], optionally log-domain."""
    x = np.asarray(img_u8).astype(np.float32) / 255.0
    if apply_log:
        x = log_transform(x, eps)
    return np.pad(x, [(top, bottom), (left, right), (0, 0)], "reflect")
