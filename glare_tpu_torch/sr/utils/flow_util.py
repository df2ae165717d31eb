"""Optical-flow file IO and (de)quantization (counterpart of
``glare_tpu/sr/utils/flow_util.py``; reference: basicsr/utils/flow_util.py, from
mmcv's optflow).

Host numpy: Middlebury ``.flo`` read / write (the 'PIEH' header) and the
255-level uint8 quantization that stores a flow as an image pair (dx, dy
concatenated along ``concat_axis``). ``cv2`` is imported where images are read
or written.
"""

from __future__ import annotations

import os

import numpy as np


def flowread(flow_path, quantize=False, concat_axis=0, *args, **kwargs):
    """Read an (h, w, 2) optical flow map (reference: flow_util.py:7-43)."""
    if quantize:
        import cv2

        assert concat_axis in [0, 1]
        cat_flow = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
        if cat_flow.ndim != 2:
            raise IOError(
                f"{flow_path} is not a valid quantized flow file, "
                f"its dimension is {cat_flow.ndim}."
            )
        assert cat_flow.shape[concat_axis] % 2 == 0
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        flow = dequantize_flow(dx, dy, *args, **kwargs)
    else:
        with open(flow_path, "rb") as f:
            header = f.read(4)
            if header != b"PIEH":
                raise IOError(
                    f"Invalid flow file: {flow_path}, header does not contain PIEH"
                )
            w = int(np.fromfile(f, np.int32, 1).squeeze())
            h = int(np.fromfile(f, np.int32, 1).squeeze())
            flow = np.fromfile(f, np.float32, w * h * 2).reshape((h, w, 2))
    return flow.astype(np.float32)


def flowwrite(flow, filename, quantize=False, concat_axis=0, *args, **kwargs):
    """Write flow as lossless .flo, or quantized to an image
    (reference: flow_util.py:46-75)."""
    if not quantize:
        with open(filename, "wb") as f:
            f.write(b"PIEH")
            np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
            f.flush()
    else:
        import cv2

        assert concat_axis in [0, 1]
        dx, dy = quantize_flow(flow, *args, **kwargs)
        dxdy = np.concatenate((dx, dy), axis=concat_axis)
        if os.path.dirname(filename):
            os.makedirs(os.path.dirname(filename), exist_ok=True)
        cv2.imwrite(filename, dxdy)


def quantize_flow(flow, max_val=0.02, norm=True):
    """Quantize flow to uint8 [0, 255] (reference: flow_util.py:78-102).
    255 levels keep 0 exactly 0 after dequantization."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(
        quantize(d, -max_val, max_val, 255, np.uint8) for d in [dx, dy]
    )


def dequantize_flow(dx, dy, max_val=0.02, denorm=True):
    """Recover flow from quantized dx/dy (reference: flow_util.py:105-126)."""
    assert dx.shape == dy.shape
    assert dx.ndim == 2 or (dx.ndim == 3 and dx.shape[-1] == 1)
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in [dx, dy])
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """Map (-inf, inf) to integer levels [0, levels-1]
    (reference: flow_util.py:129-149)."""
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f"levels must be a positive integer, but got {levels}")
    if min_val >= max_val:
        raise ValueError(f"min_val ({min_val}) must be smaller than max_val ({max_val})")
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(
        np.floor(levels * arr / (max_val - min_val)).astype(dtype), levels - 1
    )


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """Inverse of :func:`quantize`, mapping to bin centers
    (reference: flow_util.py:152-170)."""
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f"levels must be a positive integer, but got {levels}")
    if min_val >= max_val:
        raise ValueError(f"min_val ({min_val}) must be smaller than max_val ({max_val})")
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val
