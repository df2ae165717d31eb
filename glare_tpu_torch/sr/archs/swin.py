"""Swin transformer blocks of the RIDCP LQ-stage encoder (counterpart of
``glare_tpu/sr/archs/swin.py``; reference: basicsr/archs/network_swinir.py).

Window attention is plain torch (JAX computes it with einsums, outside Pallas):
one batched product over all windows of 64 tokens. Tokens are ``[B, H*W, C]``
in row-major (h, w) order; H and W must be multiples of the window. flax
semantics where torch's defaults differ: LayerNorm eps 1e-6 and the
tanh-approximated GELU.

Names are SwinIR's: ``swin_blks.{i}`` (RSTB) -> ``residual_group.blocks.{j}``
(``norm1``, ``attn.{qkv, proj, relative_position_bias_table}``, ``norm2``,
``mlp.{fc1, fc2}``) and ``conv`` (``1conv``) or ``conv.{0, 2, 4}`` (``3conv``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv


def window_partition(x, ws):
    """[B, H, W, C] -> [B*nW, ws*ws, C]"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws, h, w):
    """[B*nW, ws*ws, C] -> [B, H, W, C]"""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # [ws*ws, ws*ws]


def shift_attn_mask(h, w, ws, shift):
    """Attention mask of shifted windows, [nW, ws*ws, ws*ws] float32 (0 / -100)."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mask_windows = mask_windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class Dense(nn.Linear):
    """``nn.Linear`` with a seeded init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias, as the port's ``Conv``."""

    def seeded_reset(self, generator):
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads, qkv_bias=True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.qkv = Dense(dim, dim * 3, bias=qkv_bias)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window_size).reshape(-1)),
                             persistent=False)

    def seeded_reset(self, generator):
        """The table: a normal of std 0.02 truncated at 2 std."""
        with torch.no_grad():
            t = self.relative_position_bias_table
            t.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        nh, ws = self.num_heads, self.window_size
        hd = c // nh
        qkv = self.qkv(x).reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(ws * ws, ws * ws, nh).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(-1, nh, n, n)
        out = torch.softmax(attn, dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, in_features, hidden, out):
        super().__init__()
        self.fc1 = Dense(in_features, hidden)
        self.fc2 = Dense(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size=8, shift_size=0, mlp_ratio=4.0):
        super().__init__()
        self.dim, self.window_size, self.shift_size = dim, window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self._masks = {}

    def _mask(self, h, w, ws, shift, device):
        key = (h, w, ws, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(device)
        return self._masks[key]

    def forward(self, x, x_size):
        h, w = x_size
        b, n, c = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift_size if ws == self.window_size else 0

        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = self._mask(h, w, ws, shift, x.device)
        x = window_reverse(self.attn(window_partition(x, ws), mask=mask), ws, h, w)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, n, c)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=4.0):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 shift_size=0 if i % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio)
            for i in range(depth)])

    def forward(self, x, x_size):
        for blk in self.blocks:
            x = blk(x, x_size)
        return x


class RSTB(nn.Module):
    """Residual Swin Transformer Block: tokens + conv(BasicLayer(tokens))."""

    def __init__(self, dim, depth=6, num_heads=8, window_size=8, mlp_ratio=4.0, resi_connection="1conv"):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size, mlp_ratio)
        if resi_connection == "1conv":
            self.conv = Conv(dim, dim, 3, padding=1)
        elif resi_connection == "3conv":  # the parameter-saving bottleneck
            self.conv = nn.Sequential(
                Conv(dim, dim // 4, 3, padding=1), nn.LeakyReLU(0.2),
                Conv(dim // 4, dim // 4, 1, padding=0), nn.LeakyReLU(0.2),
                Conv(dim // 4, dim, 3, padding=1))
        else:
            raise ValueError(f"resi_connection {resi_connection!r}: '1conv' or '3conv'")

    def forward(self, x, x_size):
        h, w = x_size
        b, n, c = x.shape
        y = self.residual_group(x, x_size).transpose(1, 2).reshape(b, c, h, w)
        return x + self.conv(y).flatten(2).transpose(1, 2)


class SwinLayers(nn.Module):
    """4 RSTB over the flattened map: [B, C, H, W] -> [B, C, H, W]."""

    def __init__(self, embed_dim=256, blk_depth=6, num_heads=8, window_size=8):
        super().__init__()
        self.swin_blks = nn.ModuleList([RSTB(embed_dim, blk_depth, num_heads, window_size)
                                        for _ in range(4)])

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)
        for blk in self.swin_blks:
            tokens = blk(tokens, (h, w))
        return tokens.transpose(1, 2).reshape(b, c, h, w)
