"""Generic arch utilities (counterpart of ``glare_tpu/sr/archs/arch_util.py``;
reference: basicsr/archs/arch_util.py). NCHW.

``make_layer`` / ``ResidualBlockNoBN`` / ``Upsample`` (the pixel-shuffle head),
``flow_warp`` / ``resize_flow`` (video-SR warping), ``pixel_shuffle`` /
``pixel_unshuffle`` (torch's own operations, channel order (c, sy, sx)) and the
scaled Kaiming init of ``default_init_weights`` (``nn.layers.ScaledKaimingConv``).
``Upsample`` is the reference's ``nn.Sequential``: its convolutions are
``{0, 2, ...}`` (the JAX module names them ``conv{n}``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv, ScaledKaimingConv


def pixel_shuffle(x, scale):
    """[B, C*s^2, H, W] -> [B, C, H*s, W*s], channel c*s^2 + sy*s + sx."""
    return F.pixel_shuffle(x, scale)


def pixel_unshuffle(x, scale):
    """[B, C, H*s, W*s] -> [B, C*s^2, H, W], the inverse of :func:`pixel_shuffle`."""
    return F.pixel_unshuffle(x, scale)


def make_layer(basic_block, num_basic_block, **kwarg):
    """``num_basic_block`` blocks ``basic_block(**kwarg)`` in an ``nn.Sequential``."""
    return nn.Sequential(*[basic_block(**kwarg) for _ in range(num_basic_block)])


class ResidualBlockNoBN(nn.Module):
    """``x + res_scale * conv2(relu(conv1(x)))``; ``pytorch_init=False`` (the
    default) draws the convolutions by the scaled Kaiming rule (scale 0.1), True
    keeps the port's ``Conv`` init."""

    def __init__(self, num_feat=64, res_scale=1.0, pytorch_init=False):
        super().__init__()
        self.res_scale = res_scale
        if pytorch_init:
            self.conv1 = Conv(num_feat, num_feat, 3, padding=1)
            self.conv2 = Conv(num_feat, num_feat, 3, padding=1)
        else:
            self.conv1 = ScaledKaimingConv(num_feat, num_feat, scale=0.1)
            self.conv2 = ScaledKaimingConv(num_feat, num_feat, scale=0.1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Sequential):
    """A 3x3 conv to ``4 * num_feat`` and a pixel shuffle per factor of 2 (or one
    x3 step). Scale 2^n or 3."""

    def __init__(self, scale, num_feat):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [Conv(num_feat, 4 * num_feat, 3, padding=1), nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [Conv(num_feat, 9 * num_feat, 3, padding=1), nn.PixelShuffle(3)]
        else:
            raise ValueError(f"scale {scale} is not supported. Supported scales: 2^n and 3.")
        super().__init__(*layers)


def flow_warp(x, flow, interp_mode="bilinear", padding_mode="zeros", align_corners=True):
    """``grid_sample(x, grid + flow)``: x [B, C, H, W]; flow [B, H, W, 2] as (dx, dy)
    pixel displacements (flow[..., 0] moves along W).

    The positions are normalised as the reference does, with ``max(S - 1, 1)``,
    for both ``align_corners``: with ``align_corners=False`` ``grid_sample`` then
    denormalises with S, so the sample position is the scale-and-shift
    ``p * S / max(S - 1, 1) - 0.5`` (the JAX module computes it so)."""
    b, c, h, w = x.shape
    if tuple(flow.shape) != (b, h, w, 2):
        raise ValueError(f"flow_warp: flow {tuple(flow.shape)} for x {tuple(x.shape)}")
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    vx = gx[None] + flow[..., 0].float()
    vy = gy[None] + flow[..., 1].float()
    grid = torch.stack((2.0 * vx / max(w - 1, 1) - 1.0, 2.0 * vy / max(h - 1, 1) - 1.0), dim=3)
    return F.grid_sample(x, grid.to(x.dtype), mode=interp_mode, padding_mode=padding_mode,
                         align_corners=align_corners)


def resize_flow(flow, size_type, sizes: Sequence, interp_mode="bilinear", align_corners=False):
    """Resize a [B, 2, H, W] flow field and rescale its (dx, dy) by the ratio.

    ``size_type`` 'ratio' (sizes are factors) or 'shape' (sizes are the output
    H, W). ``interp_mode`` 'bilinear' (``align_corners`` honoured) or 'nearest':
    torch's legacy rule ``src = floor(dst * in / out)``, ``align_corners`` unused.
    This keeps the JAX module's behaviour: the reference passes
    ``align_corners`` with 'nearest' too, which ``F.interpolate`` refuses."""
    if interp_mode not in ("bilinear", "nearest"):
        raise ValueError(f"interp_mode must be 'bilinear' or 'nearest', got {interp_mode!r}")
    _, _, h, w = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == "shape":
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f"size_type must be ratio or shape, got {size_type}")
    ratio = torch.tensor([out_w / w, out_h / h], dtype=torch.float32, device=flow.device)
    scaled = flow.float() * ratio.reshape(1, 2, 1, 1)
    if interp_mode == "nearest":
        return F.interpolate(scaled, size=(out_h, out_w), mode="nearest")
    return F.interpolate(scaled, size=(out_h, out_w), mode="bilinear", align_corners=align_corners)
