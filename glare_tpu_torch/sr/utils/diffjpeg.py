"""Differentiable JPEG on the device (counterpart of ``glare_tpu/sr/utils/diffjpeg.py``;
reference: basicsr/utils/diffjpeg.py). NCHW RGB in [0, 1].

RGB -> YCbCr, 4:2:0 chroma subsampling (2x2 mean), the 8x8 DCT as the separable
product ``C @ block @ C^T`` with ``DCT_BASIS``, quantization by the standard's
tables (ITU T.81 Annex K) times the quality factor with ``diff_round`` (or
``torch.round``, half to even as ``jnp.round``), then the inverse chain.
Per-sample ``quality`` broadcasts over the batch. Inputs are zero-padded to a
multiple of 16 and cropped back.

The tables are used transposed, as in the JAX module and the reference: the
DCT's first frequency axis runs over image rows here, while T.81 prints each
table with the row frequency second.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
C_TABLE = np.full((8, 8), 99, np.float32)
C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]], np.float32)

# separable DCT-II basis: C[u, x] = 0.5 * alpha_u * cos((2x+1) u pi / 16)
_alpha = np.array([1.0 / np.sqrt(2)] + [1.0] * 7, np.float32)
_x = np.arange(8)
DCT_BASIS = (0.5 * _alpha[:, None] * np.cos((2 * _x[None, :] + 1) * _x[:, None] * np.pi / 16)).astype(np.float32)

_RGB2YCBCR = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)
_YCBCR_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)
_YCBCR2RGB = np.array([[1.0, 0.0, 1.402],
                       [1.0, -0.344136, -0.714136],
                       [1.0, 1.772, 0.0]], np.float32)


def diff_round(x):
    """Differentiable rounding surrogate: ``round(x) + (x - round(x))^3``."""
    r = torch.round(x)
    return r + (x - r) ** 3


def quality_to_factor(quality):
    """JPEG quality in (0, 100] -> the quantization factor (scalar or tensor)."""
    q = torch.as_tensor(quality, dtype=torch.float32)
    return torch.where(q < 50, 5000.0 / q, 200.0 - q * 2) / 100.0


def _const(a, like):
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _to_blocks(x):
    """[B, H, W] -> [B, H/8 * W/8, 8, 8]."""
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).transpose(2, 3).reshape(b, -1, 8, 8)


def _from_blocks(x, h, w):
    b = x.shape[0]
    return x.reshape(b, h // 8, w // 8, 8, 8).transpose(2, 3).reshape(b, h, w)


def quantized_coefficients(x, quality):
    """The stage of :func:`diff_jpeg` before rounding: x [B, 3, H, W] in [0, 1] ->
    ({'y', 'cb', 'cr'}: DCT coefficient / quantization step, [B, blocks, 8, 8]),
    {name: the steps [B, 1, 8, 8]}, the padded (H, W))."""
    b, _, h, w = x.shape
    factor = quality_to_factor(quality).to(x.device)
    factor = factor.reshape(-1, 1, 1, 1) if factor.ndim else factor.expand(b).reshape(-1, 1, 1, 1)
    hp, wp = h + (16 - h % 16) % 16, w + (16 - w % 16) % 16
    x = F.pad(x, (0, wp - w, 0, hp - h))
    ycbcr = x.permute(0, 2, 3, 1) * 255.0 @ _const(_RGB2YCBCR.T, x) + _const(_YCBCR_SHIFT, x)
    cbcr = ycbcr[..., 1:].reshape(b, hp // 2, 2, wp // 2, 2, 2).mean(dim=(2, 4))
    c = _const(DCT_BASIS, x)
    tables = {"y": _const(Y_TABLE.T, x) * factor, "cb": _const(C_TABLE.T, x) * factor}
    tables["cr"] = tables["cb"]
    quot = {}
    for name, comp in (("y", ycbcr[..., 0]), ("cb", cbcr[..., 0]), ("cr", cbcr[..., 1])):
        quot[name] = (c @ (_to_blocks(comp) - 128.0) @ c.T) / tables[name]
    return quot, tables, (hp, wp)


def diff_jpeg(x, quality, differentiable=True):
    """JPEG round trip on x [B, 3, H, W] in [0, 1]; ``quality`` a scalar or [B]
    in (0, 100]; ``differentiable``: the rounding surrogate, else a hard round.
    -> [B, 3, H, W] in [0, 1]."""
    rounding = diff_round if differentiable else torch.round
    h, w = x.shape[-2:]
    quot, tables, (hp, wp) = quantized_coefficients(x, quality)
    c = _const(DCT_BASIS, x)
    comps = {}
    for name, q in quot.items():
        blocks = c.T @ (rounding(q) * tables[name]) @ c + 128.0
        comps[name] = _from_blocks(blocks, hp, wp) if name == "y" else _from_blocks(blocks, hp // 2, wp // 2)
    up = lambda t: t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # noqa: E731
    ycbcr = torch.stack([comps["y"], up(comps["cb"]), up(comps["cr"])], dim=-1)
    rgb = (ycbcr - _const(_YCBCR_SHIFT, x)) @ _const(_YCBCR2RGB.T, x)
    rgb = torch.clamp(rgb, 0.0, 255.0) / 255.0
    return rgb[:, :h, :w, :].permute(0, 3, 1, 2)


class DiffJPEG(torch.nn.Module):
    """``DiffJPEG(differentiable)(x, quality)``: :func:`diff_jpeg` as a module."""

    def __init__(self, differentiable=True):
        super().__init__()
        self.differentiable = differentiable

    def forward(self, x, quality):
        return diff_jpeg(x, quality, differentiable=self.differentiable)
