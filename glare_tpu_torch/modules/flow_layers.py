"""Normalizing-flow primitive layers (counterpart of
``glare_tpu/modules/flow_layers.py``), NCHW, with the reference checkpoint
shapes: ActNorm ``bias``/``logs`` are ``[1, C, 1, 1]``, ``Conv2dZeros.logs`` is
``[C, 1, 1]``, conv weights are OIHW.

Conventions: ``logdet`` is a per-sample vector ``[B]`` or None; ``reverse`` is a
plain bool. Data-dependent ActNorm init: call the flow once with ``ddinit=True``
(under ``torch.no_grad()``); each ActNorm computes its batch statistics, writes
them into its ``bias`` / ``logs`` *and* uses them at once, so later layers see
the output of the initialized ones (torch's lazy in-forward init, in one
sequential pass; the JAX package writes an ``actnorm_init`` collection and merges
it). No ``state_dict`` key is added.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import at_least_float32
from ..parallel.mesh import moments_over_ranks


def pixels(x):
    """Spatial pixel count of an NCHW tensor."""
    return x.shape[2] * x.shape[3]


def sum_per_sample(x):
    """Sum over all non-batch axes -> [B]."""
    return x.sum(dim=tuple(range(1, x.dim())))


LOG2PI = math.log(2 * math.pi)


class GaussianDiag:
    """Diagonal-Gaussian likelihood helpers; ``logs`` may be a float."""

    @staticmethod
    def likelihood(mean, logs, x):
        if mean is None and logs is None:
            return -0.5 * (x ** 2 + LOG2PI)
        logs = torch.as_tensor(logs, dtype=x.dtype, device=x.device)
        return -0.5 * (logs * 2.0 + ((x - mean) ** 2) / torch.exp(logs * 2.0) + LOG2PI)

    @staticmethod
    def logp(mean, logs, x):
        return sum_per_sample(GaussianDiag.likelihood(mean, logs, x))

    @staticmethod
    def sample(generator, mean, logs, eps_std=1.0):
        """``mean + exp(logs) * eps``, eps ~ N(0, eps_std^2) of mean's shape and dtype,
        drawn from ``generator`` on its device (None: torch's global generator on
        mean's device), as ``Split2d`` draws."""
        device = generator.device if generator is not None else mean.device
        eps = torch.randn(mean.shape, generator=generator, device=device,
                          dtype=mean.dtype).to(mean.device) * eps_std
        return mean + torch.exp(torch.as_tensor(logs, dtype=mean.dtype, device=mean.device)) * eps

    @staticmethod
    def sample_eps(generator, shape, eps_std=1.0, dtype=torch.float32):
        """N(0, eps_std^2) of ``shape`` on ``generator``'s device (None: the CPU and
        torch's global generator)."""
        device = generator.device if generator is not None else None
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype) * eps_std


def split_feature_cross(h):
    """'cross' split: (even channels, odd channels)."""
    return h[:, 0::2], h[:, 1::2]


def cat_feature(a, b):
    return torch.cat([a, b], dim=1)


class ActNorm2d(nn.Module):
    """Per-channel learned bias + log-scale, with data-dependent init.

    ``stats_over_ranks`` (set by a data-parallel model) takes the init's statistics
    over the whole batch of the ``torch.distributed`` group, not the rank's block."""

    stats_over_ranks = False

    def __init__(self, num_features, scale=1.0):
        super().__init__()
        self.num_features, self.scale = num_features, scale
        self.bias = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.logs = nn.Parameter(torch.zeros(1, num_features, 1, 1))

    @torch.no_grad()
    def initialize(self, x):
        """Set ``bias`` / ``logs`` from the float32 statistics (float64 in a float64
        run) of ``x`` over batch and space: b = -mean(x), var = mean((x + b)^2) (the
        population variance), logs = log(scale / (sqrt(var) + 1e-6)). Under data
        parallelism both are all-reduced sums over the ranks' blocks, in two passes."""
        xf = at_least_float32(x)
        if self.stats_over_ranks:
            mean, var = moments_over_ranks(xf, (0, 2, 3))
            b = -mean
        else:
            b = -xf.mean(dim=(0, 2, 3), keepdim=True)
            var = ((xf + b) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        self.bias.copy_(b)
        self.logs.copy_(torch.log(self.scale / (torch.sqrt(var) + 1e-6)))

    def forward(self, x, logdet=None, reverse=False, ddinit=False):
        assert x.shape[1] == self.num_features, (x.shape, self.num_features)
        if ddinit:
            self.initialize(x)
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
    Reverse applies W^-1 (closed-form adjugate at C <= 3, in float32 or float64)."""

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
        det, w_inv = _det_and_inv(at_least_float32(self.weight))
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

    def forward(self, x, ddinit=False):
        y = F.conv2d(x, self.weight.to(x.dtype), padding=self.padding)
        y, _ = self.actnorm(y, None, reverse=False, ddinit=ddinit)
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


def squeeze2d(x, factor=2):
    """Space-to-channel, channel order (C, fy, fx): output channel
    ``c * factor**2 + fy * factor + fx``."""
    if factor == 1:
        return x
    b, c, h, w = x.shape
    assert h % factor == 0 and w % factor == 0, (h, w, factor)
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    x = x.permute(0, 1, 3, 5, 2, 4)  # B, C, fy, fx, H/f, W/f
    return x.reshape(b, c * factor * factor, h // factor, w // factor)


def unsqueeze2d(x, factor=2):
    """Inverse of :func:`squeeze2d`."""
    if factor == 1:
        return x
    b, c, h, w = x.shape
    f2 = factor ** 2
    assert c % f2 == 0, c
    x = x.reshape(b, c // f2, factor, factor, h, w)
    x = x.permute(0, 1, 4, 2, 5, 3)  # B, C/f2, H, fy, W, fx
    return x.reshape(b, c // f2, h * factor, w * factor)


class SqueezeLayer(nn.Module):
    def __init__(self, factor=2):
        super().__init__()
        self.factor = factor

    def forward(self, x, logdet=None, reverse=False):
        if not reverse:
            return squeeze2d(x, self.factor), logdet
        return unsqueeze2d(x, self.factor), logdet
