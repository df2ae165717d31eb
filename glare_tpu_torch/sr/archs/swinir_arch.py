"""The full SwinIR restoration network (counterpart of
``glare_tpu/sr/archs/swinir_arch.py``; reference: network_swinir.py:619 SwinIR). NCHW.

All four reconstruction heads: 'pixelshuffle', 'pixelshuffledirect',
'nearest+conv' (x4 only) and '' (the residual denoising head); '1conv' /
'3conv' residual connections, ``ape``, ``patch_norm``, the RGB mean and
``img_range``, and a reflect pad to a multiple of the window (cropped after).
The RSTB stack is ``sr/archs/swin.py``'s (window attention in plain torch, as
JAX computes it outside Pallas; LayerNorm eps 1e-6 and the tanh GELU, flax's).

Names are the reference's ``state_dict`` (what ``tools/torch2flax.py``'s
``convert_swinir`` reads): ``conv_first``, ``patch_embed.norm``,
``absolute_pos_embed``, ``layers.{i}.residual_group.blocks.{j}.*``,
``layers.{i}.conv[.{0,2,4}]``, ``norm``, ``conv_after_body[.{0,2,4}]``,
``conv_before_upsample.0``, ``upsample.{0,2,...}`` (pixelshuffle) or
``upsample.0`` (pixelshuffledirect), ``conv_up1``, ``conv_up2``, ``conv_hr``,
``conv_last``. ``img_size`` sizes ``absolute_pos_embed`` only (an ``ape``
network takes inputs of that size, as the reference's); drop rates are
inference-irrelevant and not accepted, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv
from ..registry import ARCH_REGISTRY
from .arch_util import Upsample
from .swin import RSTB

_RGB_MEAN = (0.4488, 0.4371, 0.4040)


class PatchEmbed(nn.Module):
    """[B, C, H, W] -> tokens [B, H*W, C], LayerNorm'd when ``patch_norm``."""

    def __init__(self, embed_dim, patch_norm=True):
        super().__init__()
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6) if patch_norm else None

    def forward(self, x):
        x = x.flatten(2).transpose(1, 2)
        return self.norm(x) if self.norm is not None else x


def _conv_after_body(dim, resi_connection):
    if resi_connection == "1conv":
        return Conv(dim, dim, 3, padding=1)
    if resi_connection == "3conv":
        return nn.Sequential(Conv(dim, dim // 4, 3, padding=1), nn.LeakyReLU(0.2),
                             Conv(dim // 4, dim // 4, 1, padding=0), nn.LeakyReLU(0.2),
                             Conv(dim // 4, dim, 3, padding=1))
    raise ValueError(f"resi_connection {resi_connection!r}: '1conv' or '3conv'")


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    def __init__(self, img_size=64, patch_size=1, in_chans=3, embed_dim=96, depths=(6, 6, 6, 6),
                 num_heads=(6, 6, 6, 6), window_size=7, mlp_ratio=4.0, qkv_bias=True, ape=False,
                 patch_norm=True, upscale=2, img_range=1.0, upsampler="", resi_connection="1conv"):
        super().__init__()
        if patch_size != 1 or not qkv_bias:
            raise ValueError("SwinIR: patch_size 1 and qkv_bias True only, as the JAX module")
        if upsampler not in ("pixelshuffle", "pixelshuffledirect", "nearest+conv", ""):
            raise ValueError(f"SwinIR: unknown upsampler {upsampler!r}")
        if upsampler == "nearest+conv" and upscale != 4:
            raise ValueError("nearest+conv only supports x4")
        self.window_size, self.upscale, self.img_range = window_size, upscale, img_range
        self.upsampler, self.ape = upsampler, ape
        self.register_buffer("mean", torch.tensor(_RGB_MEAN if in_chans == 3 else (0.0,)).reshape(1, -1, 1, 1),
                             persistent=False)
        num_feat = 64
        self.conv_first = Conv(in_chans, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, img_size * img_size, embed_dim))
        self.layers = nn.ModuleList([
            RSTB(embed_dim, depth, heads, window_size, mlp_ratio, resi_connection)
            for depth, heads in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.conv_after_body = _conv_after_body(embed_dim, resi_connection)
        if upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Sequential(Conv(embed_dim, num_feat, 3, padding=1),
                                                      nn.LeakyReLU(0.01))
        if upsampler == "pixelshuffle":
            self.upsample = Upsample(upscale, num_feat)
            self.conv_last = Conv(num_feat, in_chans, 3, padding=1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(Conv(embed_dim, in_chans * upscale ** 2, 3, padding=1),
                                          nn.PixelShuffle(upscale))
        elif upsampler == "nearest+conv":
            self.conv_up1 = Conv(num_feat, num_feat, 3, padding=1)
            self.conv_up2 = Conv(num_feat, num_feat, 3, padding=1)
            self.conv_hr = Conv(num_feat, num_feat, 3, padding=1)
            self.conv_last = Conv(num_feat, in_chans, 3, padding=1)
        else:
            self.conv_last = Conv(embed_dim, in_chans, 3, padding=1)

    def seeded_reset(self, generator):
        """``absolute_pos_embed``: a normal of std 0.02 truncated at 2 std (the
        children redraw their own parameters)."""
        if self.ape:
            with torch.no_grad():
                self.absolute_pos_embed.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)

    def forward_features(self, x):
        b, c, h, w = x.shape
        tokens = self.patch_embed(x)
        if self.ape:
            tokens = tokens + self.absolute_pos_embed
        for layer in self.layers:
            tokens = layer(tokens, (h, w))
        return self.norm(tokens).transpose(1, 2).reshape(b, c, h, w)

    def forward(self, x):
        h, w = x.shape[-2:]
        ws = self.window_size
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        if self.upsampler == "":
            x_first = self.conv_first(x)
            res = self.conv_after_body(self.forward_features(x_first)) + x_first
            x = x + self.conv_last(res)
        else:
            x = self.conv_first(x)
            x = self.conv_after_body(self.forward_features(x)) + x
            if self.upsampler == "pixelshuffle":
                x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
            elif self.upsampler == "pixelshuffledirect":
                x = self.upsample(x)
            else:  # nearest+conv
                x = self.conv_before_upsample(x)
                x = F.leaky_relu(self.conv_up1(F.interpolate(x, scale_factor=2, mode="nearest")), 0.2)
                x = F.leaky_relu(self.conv_up2(F.interpolate(x, scale_factor=2, mode="nearest")), 0.2)
                x = self.conv_last(F.leaky_relu(self.conv_hr(x), 0.2))
        x = x / self.img_range + mean
        return x[:, :, : h * self.upscale, : w * self.upscale]
