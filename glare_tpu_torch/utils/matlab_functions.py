"""MATLAB-exact image functions (reference: basicsr/utils/matlab_functions.py).

The port's own copy of ``glare_tpu/utils/matlab_functions.py`` (numpy only).

Many SR eval protocols are defined on MATLAB's conventions; these match
MATLAB bit-for-bit within float tolerance:

  * :func:`rgb2ycbcr` / :func:`bgr2ycbcr` / :func:`ycbcr2rgb` — ITU-R BT.601
    with MATLAB's offset/scale (y_only option used for Y-channel PSNR/SSIM).
  * :func:`imresize` — bicubic resize with antialiasing, the MATLAB
    algorithm (cubic kernel a=-0.5, kernel widening when downscaling,
    boundary replication), operating on float [0,1] or uint8 arrays.
"""

from __future__ import annotations

import math

import numpy as np


def _convert_input(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0, np.uint8
    return img.astype(np.float32), img.dtype


def _convert_output(img, dtype):
    if dtype == np.uint8:
        return (img * 255.0).round().clip(0, 255).astype(np.uint8)
    return img.astype(dtype)


def rgb2ycbcr(img, y_only=False):
    """img in [0,1] float or uint8, RGB. Output same type convention."""
    img_f, dtype = _convert_input(img)
    if y_only:
        out = np.dot(img_f, [65.481, 128.553, 24.966]) + 16.0
    else:
        out = np.matmul(
            img_f,
            np.array(
                [
                    [65.481, -37.797, 112.0],
                    [128.553, -74.203, -93.786],
                    [24.966, 112.0, -18.214],
                ]
            ),
        ) + [16, 128, 128]
    out = out / 255.0
    return _convert_output(out, dtype)


def bgr2ycbcr(img, y_only=False):
    img_f, dtype = _convert_input(img)
    if y_only:
        out = np.dot(img_f, [24.966, 128.553, 65.481]) + 16.0
    else:
        out = np.matmul(
            img_f,
            np.array(
                [
                    [24.966, 112.0, -18.214],
                    [128.553, -74.203, -93.786],
                    [65.481, -37.797, 112.0],
                ]
            ),
        ) + [16, 128, 128]
    out = out / 255.0
    return _convert_output(out, dtype)


def ycbcr2rgb(img):
    img_f, dtype = _convert_input(img)
    img_f = img_f * 255.0
    out = (
        np.matmul(
            img_f,
            np.array(
                [
                    [0.00456621, 0.00456621, 0.00456621],
                    [0, -0.00153632, 0.00791071],
                    [0.00625893, -0.00318811, 0],
                ]
            ),
        ) * 255.0
        + [-222.921, 135.576, -276.836]
    ) / 255.0
    return _convert_output(out, dtype)


def _cubic(x):
    """MATLAB's bicubic kernel (a = -0.5)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return (1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) + (
        -0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2
    ) * ((absx > 1) & (absx <= 2))


def _calculate_weights_indices(in_length, out_length, scale, kernel_width, antialiasing):
    if (scale < 1) and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1).astype(np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2

    indices = left[:, None] + np.arange(p)[None, :]
    dist = u[:, None] - indices

    if (scale < 1) and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights_sum = np.sum(weights, axis=1, keepdims=True)
    weights = weights / weights_sum

    # trim zero columns
    weights_zero_tmp = np.sum(weights == 0, axis=0)
    if not math.isclose(weights_zero_tmp[0], 0, rel_tol=1e-6):
        indices = indices[:, 1 : 1 + p - 2]
        weights = weights[:, 1 : 1 + p - 2]
    if not math.isclose(weights_zero_tmp[-1], 0, rel_tol=1e-6):
        indices = indices[:, : p - 2]
        weights = weights[:, : p - 2]
    weights = np.ascontiguousarray(weights)
    indices = np.ascontiguousarray(indices)
    sym_len_s = max(int(-indices.min() + 1), 0)
    sym_len_e = max(int(indices.max() - in_length), 0)
    indices = indices + sym_len_s - 1
    return weights, indices.astype(np.int64), sym_len_s, sym_len_e


def imresize(img, scale, antialiasing=True):
    """MATLAB bicubic imresize. img: HWC or HW, float [0,1] or uint8."""
    img_f, dtype = _convert_input(img)
    squeeze = False
    if img_f.ndim == 2:
        img_f = img_f[:, :, None]
        squeeze = True
    in_h, in_w, in_c = img_f.shape
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)
    kernel_width = 4

    wh, ih, sym_s_h, sym_e_h = _calculate_weights_indices(in_h, out_h, scale, kernel_width, antialiasing)
    ww, iw, sym_s_w, sym_e_w = _calculate_weights_indices(in_w, out_w, scale, kernel_width, antialiasing)

    # symmetric-pad rows (edge-inclusive flip, MATLAB convention)
    parts = [img_f]
    if sym_s_h > 0:
        parts.insert(0, img_f[:sym_s_h][::-1])
    if sym_e_h > 0:
        parts.append(img_f[in_h - sym_e_h :][::-1])
    img_aug = np.concatenate(parts, axis=0) if len(parts) > 1 else img_f
    out1 = np.empty((out_h, in_w, in_c), np.float64)
    for i in range(out_h):
        out1[i] = np.tensordot(wh[i], img_aug[ih[i]], axes=(0, 0))

    # symmetric-pad cols
    parts = [out1]
    if sym_s_w > 0:
        parts.insert(0, out1[:, :sym_s_w][:, ::-1])
    if sym_e_w > 0:
        parts.append(out1[:, in_w - sym_e_w :][:, ::-1])
    out1_aug = np.concatenate(parts, axis=1) if len(parts) > 1 else out1
    out2 = np.empty((out_h, out_w, in_c), np.float64)
    for j in range(out_w):
        out2[:, j] = np.tensordot(ww[j], out1_aug[:, iw[j]], axes=(0, 1))

    if squeeze:
        out2 = out2[:, :, 0]
    return _convert_output(out2, dtype)
