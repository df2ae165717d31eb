"""Normalizing-flow primitive layers (counterpart of
``glare_tpu/modules/flow_layers.py``), NCHW, with the reference checkpoint
shapes: ActNorm ``bias``/``logs`` are ``[1, C, 1, 1]``, ``Conv2dZeros.logs`` is
``[C, 1, 1]``, conv weights are OIHW.

Conventions: ``logdet`` is a per-sample vector ``[B]`` or None; ``reverse`` is a
plain bool. The data-dependent ActNorm initialisation belongs to training and
is not ported yet; parameters come from a checkpoint or the seeded init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def pixels(x):
    """Spatial pixel count of an NCHW tensor."""
    return x.shape[2] * x.shape[3]


def sum_per_sample(x):
    """Sum over all non-batch axes -> [B]."""
    return x.sum(dim=tuple(range(1, x.dim())))


def split_feature_cross(h):
    """'cross' split: (even channels, odd channels)."""
    return h[:, 0::2], h[:, 1::2]


def cat_feature(a, b):
    return torch.cat([a, b], dim=1)


class ActNorm2d(nn.Module):
    """Per-channel learned bias + log-scale."""

    def __init__(self, num_features, scale=1.0):
        super().__init__()
        self.num_features, self.scale = num_features, scale
        self.bias = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.logs = nn.Parameter(torch.zeros(1, num_features, 1, 1))

    def forward(self, x, logdet=None, reverse=False):
        assert x.shape[1] == self.num_features, (x.shape, self.num_features)
        bias = self.bias.to(x.dtype)
        if not reverse:
            x = (x + bias) * torch.exp(self.logs).to(x.dtype)
        else:
            x = x * torch.exp(-self.logs).to(x.dtype) - bias
        if logdet is not None:
            dlogdet = self.logs.sum() * pixels(x)
            logdet = logdet - dlogdet if reverse else logdet + dlogdet
        return x, logdet


def _det_and_inv(w):
    """Closed-form determinant and inverse for the tiny channel-mixing matrices
    the flow uses (C <= 3), same arithmetic as the JAX package."""
    c = w.shape[0]
    if c == 1:
        det = w[0, 0]
        return det, (1.0 / det).reshape(1, 1)
    if c == 2:
        det = w[0, 0] * w[1, 1] - w[0, 1] * w[1, 0]
        inv = torch.stack([torch.stack([w[1, 1], -w[0, 1]]),
                           torch.stack([-w[1, 0], w[0, 0]])]) / det
        return det, inv
    if c == 3:
        cof00 = w[1, 1] * w[2, 2] - w[1, 2] * w[2, 1]
        cof01 = w[1, 2] * w[2, 0] - w[1, 0] * w[2, 2]
        cof02 = w[1, 0] * w[2, 1] - w[1, 1] * w[2, 0]
        det = w[0, 0] * cof00 + w[0, 1] * cof01 + w[0, 2] * cof02
        adj = torch.stack([
            torch.stack([cof00, w[0, 2] * w[2, 1] - w[0, 1] * w[2, 2],
                         w[0, 1] * w[1, 2] - w[0, 2] * w[1, 1]]),
            torch.stack([cof01, w[0, 0] * w[2, 2] - w[0, 2] * w[2, 0],
                         w[0, 2] * w[1, 0] - w[0, 0] * w[1, 2]]),
            torch.stack([cof02, w[0, 1] * w[2, 0] - w[0, 0] * w[2, 1],
                         w[0, 0] * w[1, 1] - w[0, 1] * w[1, 0]]),
        ])
        return det, adj / det
    return torch.linalg.det(w), torch.linalg.inv(w)


class InvertibleConv1x1(nn.Module):
    """1x1 invertible channel-mixing conv; logdet = log|det W| * pixels.
    Reverse applies W^-1 (closed-form float32 adjugate at C <= 3)."""

    def __init__(self, num_channels):
        super().__init__()
        self.num_channels = num_channels
        self.weight = nn.Parameter(torch.eye(num_channels))

    def seeded_reset(self, generator):
        a = torch.randn(self.num_channels, self.num_channels, generator=generator)
        q, _ = torch.linalg.qr(a)
        with torch.no_grad():
            self.weight.copy_(q)

    def forward(self, x, logdet=None, reverse=False):
        w32 = self.weight.float()
        det, w_inv = _det_and_inv(w32)
        dlogdet = torch.log(torch.abs(det)) * pixels(x)
        w = (w_inv if reverse else self.weight).to(x.dtype)
        z = F.conv2d(x, w.reshape(self.num_channels, self.num_channels, 1, 1))
        if logdet is not None:
            logdet = logdet - dlogdet if reverse else logdet + dlogdet
        return z, logdet


class Conv2dNormed(nn.Module):
    """Same-pad conv, weight ~ N(0, 0.05), no bias, followed by ActNorm."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3), weight_std=0.05):
        super().__init__()
        kh, kw = kernel_size
        self.padding = ((kh - 1) // 2, (kw - 1) // 2)
        self.weight_std = weight_std
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kh, kw))
        self.actnorm = ActNorm2d(out_channels)

    def seeded_reset(self, generator):
        with torch.no_grad():
            self.weight.normal_(0.0, self.weight_std, generator=generator)

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), padding=self.padding)
        y, _ = self.actnorm(y, None, reverse=False)
        return y


class Conv2dZeros(nn.Module):
    """Zero-init conv with output scaling exp(logs * 3)."""

    def __init__(self, in_channels, out_channels, kernel_size=(3, 3), logscale_factor=3.0):
        super().__init__()
        kh, kw = kernel_size
        self.padding = ((kh - 1) // 2, (kw - 1) // 2)
        self.logscale_factor = logscale_factor
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.logs = nn.Parameter(torch.zeros(out_channels, 1, 1))

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=self.padding)
        return y * torch.exp(self.logs * self.logscale_factor).to(x.dtype)
