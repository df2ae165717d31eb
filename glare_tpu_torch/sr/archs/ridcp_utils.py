"""RIDCP building blocks (counterpart of ``glare_tpu/sr/archs/ridcp_utils.py``;
reference: basicsr/archs/ridcp_utils.py): the norm / activation dispatch, the
pre-activation :class:`ResBlock` and :class:`CombineQuantBlock`. NCHW.

Names are the reference's: a ResBlock is ``conv.{0..5}`` = norm, act, conv,
norm, act, conv (the norms' parameters under ``conv.0.norm`` / ``conv.3.norm``),
a CombineQuantBlock's conv is ``conv``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import Conv, GroupNorm32


def act_layer(x, act_type="leakyrelu"):
    """``jax.nn`` semantics: leaky slope 0.2, the tanh-approximated GELU."""
    act_type = act_type.lower()
    if act_type == "relu":
        return F.relu(x)
    if act_type == "leakyrelu":
        return F.leaky_relu(x, 0.2)
    if act_type == "silu":
        return F.silu(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="tanh")
    if act_type == "none":
        return x
    raise ValueError(f"activation type {act_type} not supported")


class ActLayer(nn.Module):
    def __init__(self, act_type="leakyrelu"):
        super().__init__()
        if act_type.lower() not in ("relu", "leakyrelu", "silu", "gelu", "none"):
            raise ValueError(f"activation type {act_type} not supported")
        self.act_type = act_type

    def forward(self, x):
        return act_layer(x, self.act_type)


class NormLayer(nn.Module):
    """``gn``: GroupNorm32 (32 groups, eps 1e-6, float32 statistics); ``bn``: batch
    norm on its running statistics (the JAX module's ``use_running_average``, in
    training too), eps 1e-5; ``in``: instance norm without affine, eps 1e-5;
    ``none``."""

    def __init__(self, channels, norm_type="gn"):
        super().__init__()
        self.norm_type = norm_type.lower()
        if self.norm_type == "gn":
            self.norm = GroupNorm32(channels)
        elif self.norm_type == "bn":
            self.norm = nn.BatchNorm2d(channels, eps=1e-5)
        elif self.norm_type not in ("in", "none"):
            raise ValueError(f"Norm type {norm_type} not supported")

    def forward(self, x):
        if self.norm_type == "gn":
            return self.norm(x)
        if self.norm_type == "bn":
            n = self.norm
            return F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0, n.eps)
        if self.norm_type == "in":
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
            return (x - mean) * torch.rsqrt(var + 1e-5)
        return x


class ResBlock(nn.Module):
    """Pre-activation residual block: ``x + conv(act(norm(conv(act(norm(x))))))``."""

    def __init__(self, in_channels, out_channels, norm_type="gn", act_type="leakyrelu"):
        super().__init__()
        self.conv = nn.Sequential(
            NormLayer(in_channels, norm_type), ActLayer(act_type),
            Conv(in_channels, out_channels, 3, padding=1),
            NormLayer(out_channels, norm_type), ActLayer(act_type),
            Conv(out_channels, out_channels, 3, padding=1))

    def forward(self, x):
        return self.conv(x) + x


class CombineQuantBlock(nn.Module):
    """3x3 conv over ``input1`` concatenated with ``input2`` resized to its size
    (nearest with half-pixel centres, as ``jax.image.resize`` samples)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 3, padding=1)

    def forward(self, input1, input2=None):
        if input2 is not None:
            input2 = F.interpolate(input2, size=input1.shape[-2:], mode="nearest-exact")
            input1 = torch.cat([input1, input2.to(input1.dtype)], dim=1)
        return self.conv(input1)
