"""Foundation layers (counterpart of ``glare_tpu/nn/layers.py``).

ldm-style building blocks: ResnetBlock (GroupNorm32 + swish), ResBlockGN
(RIDCP's variant, a 1x1 ``conv_out`` shortcut), AttnBlock (single-head full
spatial attention), Up/Downsample (nearest x2 / zero-pad stride-2 conv). Modules carry the reference PyTorch ``state_dict`` names
(``norm1``, ``conv1``, ``nin_shortcut``, ``q``/``k``/``v``/``proj_out`` ...)
with OIHW weights. Feature maps are logical NCHW in ``torch.channels_last``
memory, so a pixel's channels are contiguous -- the layout the kernels read.

Initialization: every module with random parameters has
``seeded_reset(generator)``; :func:`seed_init_` walks a model and redraws all of
them from one explicit ``torch.Generator``. Convolutions draw
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias (the ``nn.Conv2d``
default distribution).

Compute dtype, two ways to what ``dtype=jnp.bfloat16`` does in the JAX package
(parameters float32 in the tree, cast where they are used; activations in bf16):
:func:`cast_convs_` stores the convolutions of a sub-network in bf16 (serving),
:func:`set_conv_compute_dtype_` keeps them float32 and has each :class:`Conv`
cast its weight and bias at use (training: float32 master weights under
autograd). Either way a :class:`Conv` casts its input to its compute dtype.
Norm statistics stay f32 (``GLARE_GN_BF16=1`` keeps a bf16 norm's result in
bf16, as in JAX).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attn as attn_ops


def swish(x):
    return x * torch.sigmoid(x)


def at_least_float32(t):
    """``t`` in float32, or as it is when it is float64 (a float64 reference run)."""
    return t if t.dtype == torch.float64 else t.float()


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` (None: the weight's dtype):
    input, weight and bias are cast to it at use. Optional zero init; ``bias=False``
    leaves the bias out."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=0,
                 zero_init=False, bias=True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         bias=bias)
        self.zero_init = zero_init
        self.compute_dtype = None
        if zero_init:
            nn.init.zeros_(self.weight)
            if self.bias is not None:
                nn.init.zeros_(self.bias)

    def seeded_reset(self, generator):
        if self.zero_init:
            return
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    @property
    def dtype(self):
        return self.compute_dtype or self.weight.dtype

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ScaledKaimingConv(Conv):
    """``Conv`` with ``default_init_weights``' init (arch_util.py:17-44):
    ``kaiming_normal`` (fan_in, a = 0) times ``scale``, bias 0."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=1, scale=0.1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.init_scale = scale
        self.seeded_reset(None)

    def seeded_reset(self, generator):
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator).mul_(self.init_scale)
            self.bias.zero_()


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6, affine) computed in float32 (float64 for a float64
    input), result in x's dtype.

    ``bf16_io`` (default: ``GLARE_GN_BF16=1``, read at construction, as the JAX
    module reads it) on a bf16 input follows flax's ``GroupNorm(dtype=bfloat16)``: statistics in
    float32 (mean, and E[x^2] - mean^2 clamped at 0), then ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in float32 and a bf16 result."""

    def __init__(self, num_channels, num_groups=32, eps=1e-6, bf16_io=None):
        super().__init__(num_groups, num_channels, eps=eps, affine=True)
        self.bf16_io = (os.environ.get("GLARE_GN_BF16", "0") == "1" if bf16_io is None
                        else bool(bf16_io))

    def forward(self, x):
        if self.bf16_io and x.dtype == torch.bfloat16:
            b, c, g = x.shape[0], x.shape[1], self.num_groups
            xg = x.float().reshape(b, g, c // g, -1)
            mean = xg.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp((xg * xg).mean(dim=(2, 3), keepdim=True) - mean * mean, min=0.0)
            mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(1, g, c // g, 1)
            y = (xg - mean) * mul + self.bias.float().reshape(1, g, c // g, 1)
            return y.reshape(x.shape).to(torch.bfloat16)
        xf = at_least_float32(x)
        y = F.group_norm(xf, self.num_groups, self.weight.to(xf.dtype), self.bias.to(xf.dtype),
                         self.eps)
        return y.to(x.dtype)


class Upsample(nn.Module):
    """Nearest x2 then optional 3x3 conv."""

    def __init__(self, in_channels, with_conv=True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv(in_channels, in_channels, 3, padding=1)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if self.with_conv else x


class Downsample(nn.Module):
    """Asymmetric zero-pad (0,1,0,1) + stride-2 valid conv, or 2x2 average pool."""

    def __init__(self, in_channels, with_conv=True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv(in_channels, in_channels, 3, stride=2, padding=0)

    def forward(self, x):
        if self.with_conv:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class ResnetBlock(nn.Module):
    """GroupNorm -> swish -> conv, twice, with a 1x1 ``nin_shortcut`` on channel change."""

    def __init__(self, in_channels, out_channels=None, conv_shortcut=False, dropout=0.0):
        super().__init__()
        out_channels = out_channels or in_channels
        self.in_channels, self.out_channels = in_channels, out_channels
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = Conv(in_channels, out_channels, 3, padding=1)
            else:
                self.nin_shortcut = Conv(in_channels, out_channels, 1, padding=0)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        if self.in_channels != self.out_channels:
            x = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else self.nin_shortcut(x)
        return x.to(h.dtype) + h


class ResBlockGN(nn.Module):
    """RIDCP-style residual block: GroupNorm -> swish -> 3x3 conv, twice, with a 1x1
    ``conv_out`` shortcut on a channel change (reference:
    deformableDecoder_arch.py:157-183)."""

    def __init__(self, in_channels, out_channels=None):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_out = Conv(in_channels, out_channels, 1, padding=0)

    def forward(self, x_in):
        x = self.conv1(swish(self.norm1(x_in)))
        x = self.conv2(swish(self.norm2(x)))
        if hasattr(self, "conv_out"):
            x_in = self.conv_out(x_in)
        return x + x_in


def _env_tristate(name) -> Optional[bool]:
    return {"1": True, "0": False}.get(os.environ.get(name, ""), None)


class AttnBlock(nn.Module):
    """Single-head full spatial self-attention with 1x1 q/k/v convs.

    Dispatch, mirroring the JAX block:
      * fused: bf16 q/k/v (or ``use_fused=True``), more than ``chunk_threshold``
        tokens and ``c % 128 == 0`` -> ``ops.attn.flash_attention_nhc`` (the
        hand-written kernel on a CUDA tensor, its plain version on a CPU
        tensor). The normalized map is padded ONCE to a multiple of 2048 tokens
        before the q/k/v projections and the real count passed as ``n_true``.
      * dense (``n <= chunk_threshold``) and q-chunked (above it): plain matrix
        products + softmax, bf16 score storage when q/k are bf16.
    ``GLARE_ATTN_FUSED`` / ``GLARE_ATTN_QCHUNK`` / ``GLARE_ATTN_MAT_BF16`` keep
    their meaning and are read at construction; ``GLARE_ATTN_FLASH=1`` (a stock
    library kernel in the JAX package) routes to the same fused kernel here.
    """

    FUSED_PAD = 2048

    def __init__(self, in_channels, chunk_threshold=8192, q_chunk=None, use_fused=None,
                 softmax_bf16=None):
        super().__init__()
        self.in_channels = in_channels
        self.norm = GroupNorm32(in_channels)
        self.q = Conv(in_channels, in_channels, 1)
        self.k = Conv(in_channels, in_channels, 1)
        self.v = Conv(in_channels, in_channels, 1)
        self.proj_out = Conv(in_channels, in_channels, 1)
        self.chunk_threshold = chunk_threshold
        self.q_chunk = q_chunk or int(os.environ.get("GLARE_ATTN_QCHUNK", "2048"))
        if use_fused is None:
            use_fused = _env_tristate("GLARE_ATTN_FUSED")
        if use_fused is None and os.environ.get("GLARE_ATTN_FLASH", "0") == "1":
            use_fused = True
        self.use_fused = use_fused
        self.softmax_bf16 = (softmax_bf16 if softmax_bf16 is not None
                             else _env_tristate("GLARE_ATTN_MAT_BF16"))

    def _proj_tokens(self, conv, t):
        c, dt = self.in_channels, conv.dtype
        return F.linear(t.to(dt), conv.weight.view(c, c).to(dt), conv.bias.to(dt))

    def _scores_to_out(self, q_blk, k, v, scale, mat_bf16, out_dtype):
        if mat_bf16:
            a = (q_blk @ k.transpose(1, 2)).to(torch.bfloat16).float() * scale
            m = a.max(dim=-1, keepdim=True).values
            e = torch.exp(a - m).to(torch.bfloat16)
            s = e.float().sum(dim=-1, keepdim=True)
            a = e / s.to(torch.bfloat16)
        else:
            a = torch.softmax(at_least_float32(q_blk @ k.transpose(1, 2)) * scale, dim=-1)
        return (a.to(v.dtype) @ v).to(out_dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        h_ = self.norm(x)
        qkv_bf16 = self.q.dtype == torch.bfloat16
        want_fused = self.use_fused if self.use_fused is not None else qkv_bf16
        if want_fused and n > self.chunk_threshold and c % 128 == 0:
            t = h_.permute(0, 2, 3, 1).reshape(b, n, c)
            pad = (-n) % self.FUSED_PAD
            if pad:
                t = F.pad(t, (0, 0, 0, pad))
            q = self._proj_tokens(self.q, t)
            k = self._proj_tokens(self.k, t)
            v = self._proj_tokens(self.v, t)
            out = attn_ops.flash_attention_nhc(q, k, v, n_true=n).to(x.dtype)
            out = out[:, :n].reshape(b, h, w, c).permute(0, 3, 1, 2)
            return x + self.proj_out(out).to(x.dtype)

        def tokens(conv):
            return conv(h_).permute(0, 2, 3, 1).reshape(b, n, c)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        scale = float(c) ** -0.5
        mat_bf16 = self.softmax_bf16 if self.softmax_bf16 is not None else q.dtype == torch.bfloat16
        if n <= self.chunk_threshold:
            out = self._scores_to_out(q, k, v, scale, mat_bf16, x.dtype)
        else:
            out = torch.cat([
                self._scores_to_out(q[:, i:i + self.q_chunk], k, v, scale, mat_bf16, x.dtype)
                for i in range(0, n, self.q_chunk)], dim=1)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out).to(x.dtype)


def seed_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every random parameter under ``module`` from ``generator``."""
    for m in module.modules():
        if hasattr(m, "seeded_reset"):
            m.seeded_reset(generator)
    return module


def cast_convs_(module: nn.Module, dtype) -> nn.Module:
    """Cast the convolutions under ``module`` to ``dtype`` (norms, scalars and the
    codebook stay float32); they compute in their weights' dtype."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.to(dtype)
            m.compute_dtype = None
    return module


def set_conv_compute_dtype_(module: nn.Module, dtype) -> nn.Module:
    """Keep the convolutions under ``module`` in float32 and have them compute in
    ``dtype`` (weight and bias cast at use, so gradients reach the float32
    parameters)."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.to(torch.float32)
            m.compute_dtype = None if dtype == torch.float32 else dtype
    return module
