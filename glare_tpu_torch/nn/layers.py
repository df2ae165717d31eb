"""Foundation layers (counterpart of ``glare_tpu/nn/layers.py``).

ldm-style building blocks: ResnetBlock (GroupNorm32 + swish), AttnBlock
(single-head full spatial attention), Up/Downsample (nearest x2 / zero-pad
stride-2 conv). Modules carry the reference PyTorch ``state_dict`` names
(``norm1``, ``conv1``, ``nin_shortcut``, ``q``/``k``/``v``/``proj_out`` ...)
with OIHW weights. Feature maps are logical NCHW in ``torch.channels_last``
memory, so a pixel's channels are contiguous -- the layout the kernels read.

Initialization: every module with random parameters has
``seeded_reset(generator)``; :func:`seed_init_` walks a model and redraws all of
them from one explicit ``torch.Generator``. Convolutions draw
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias (the ``nn.Conv2d``
default distribution).

Compute dtype: :func:`cast_convs_` casts the convolutions of a sub-network to
bf16 and every :class:`Conv` casts its input to its weight's dtype, which is
what ``dtype=jnp.bfloat16`` does in the JAX package. Norm statistics stay f32.
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


class Conv(nn.Conv2d):
    """``nn.Conv2d`` that casts its input to the weight's dtype; optional zero init."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=0,
                 zero_init=False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.zero_init = zero_init
        if zero_init:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def seeded_reset(self, generator):
        if self.zero_init:
            return
        fan_in = self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3]
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6, affine) computed in float32, result in x's dtype."""

    def __init__(self, num_channels, num_groups=32, eps=1e-6):
        super().__init__(num_groups, num_channels, eps=eps, affine=True)

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
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
        c = self.in_channels
        return F.linear(t.to(conv.weight.dtype), conv.weight.view(c, c), conv.bias)

    def _scores_to_out(self, q_blk, k, v, scale, mat_bf16, out_dtype):
        if mat_bf16:
            a = (q_blk @ k.transpose(1, 2)).to(torch.bfloat16).float() * scale
            m = a.max(dim=-1, keepdim=True).values
            e = torch.exp(a - m).to(torch.bfloat16)
            s = e.float().sum(dim=-1, keepdim=True)
            a = e / s.to(torch.bfloat16)
        else:
            a = torch.softmax((q_blk @ k.transpose(1, 2)).float() * scale, dim=-1)
        return (a.to(v.dtype) @ v).to(out_dtype)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        h_ = self.norm(x)
        qkv_bf16 = self.q.weight.dtype == torch.bfloat16
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
    codebook stay float32)."""
    for m in module.modules():
        if isinstance(m, Conv):
            m.to(dtype)
    return module
