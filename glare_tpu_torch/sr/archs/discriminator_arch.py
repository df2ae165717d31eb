"""UNet discriminator with spectral norm (counterpart of
``glare_tpu/sr/archs/discriminator_arch.py``; reference: Real-ESRGAN's
basicsr/archs/discriminator_arch.py). NCHW.

Spectral normalization is written out here, with a persistent power-iteration
vector ``u`` (a buffer), not ``torch.nn.utils.spectral_norm`` (which updates
``u`` on every train-mode forward). Each forward runs ONE power iteration from
the stored ``u``: ``v = norm(W^T u)``, ``u_new = norm(W v)`` (no gradient), and
convolves with ``W / sigma``, ``sigma = v . (W^T u_new)`` (gradient through W).
``u_new`` is stored only when ``update_stats`` is set: the training step sets
it on the d step's real forward alone, as the JAX step does (its g step and
the fake forward leave ``u`` alone). Every conv, ``conv0`` and ``conv9``
included, is spectral-normed, as in the JAX module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import ARCH_REGISTRY


class SNConv(nn.Module):
    """Conv2d with spectral weight normalization: ``weight`` (OIHW), ``bias``, ``u`` [out]."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=1, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer("u", torch.randn(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def seeded_reset(self, generator):
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)
            self.u.normal_(generator=generator)

    def normalized_weight(self, update_stats=True):
        w2d = self.weight.reshape(self.weight.shape[0], -1)  # [out, fan_in]
        with torch.no_grad():
            v = w2d.t() @ self.u
            v = v / (v.norm() + 1e-12)
            u_new = w2d @ v
            u_new = u_new / (u_new.norm() + 1e-12)
        sigma = v @ (w2d.t() @ u_new)
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u_new)
        return self.weight / sigma

    def forward(self, x, update_stats=True):
        return F.conv2d(x, self.normalized_weight(update_stats), self.bias, self.stride, self.padding)


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """U-Net discriminator with skip connections; bilinear 2x upsampling
    (``align_corners=False``, which is ``jax.image.resize`` bilinear at 2x)."""

    def __init__(self, num_in_ch=3, num_feat=64, skip_connection=True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = SNConv(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SNConv(nf, nf * 2, 4, 2, 1)
        self.conv2 = SNConv(nf * 2, nf * 4, 4, 2, 1)
        self.conv3 = SNConv(nf * 4, nf * 8, 4, 2, 1)
        self.conv4 = SNConv(nf * 8, nf * 4, 3, 1, 1)
        self.conv5 = SNConv(nf * 4, nf * 2, 3, 1, 1)
        self.conv6 = SNConv(nf * 2, nf, 3, 1, 1)
        self.conv7 = SNConv(nf, nf, 3, 1, 1)
        self.conv8 = SNConv(nf, nf, 3, 1, 1)
        self.conv9 = SNConv(nf, 1, 3, 1, 1)

    def forward(self, x, update_stats=True):
        def lrelu(t):
            return F.leaky_relu(t, 0.2)

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)

        x0 = lrelu(self.conv0(x, update_stats))
        x1 = lrelu(self.conv1(x0, update_stats))
        x2 = lrelu(self.conv2(x1, update_stats))
        x3 = lrelu(self.conv3(x2, update_stats))
        x4 = lrelu(self.conv4(up(x3), update_stats))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = lrelu(self.conv5(up(x4), update_stats))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = lrelu(self.conv6(up(x5), update_stats))
        if self.skip_connection:
            x6 = x6 + x0
        out = lrelu(self.conv7(x6, update_stats))
        out = lrelu(self.conv8(out, update_stats))
        return self.conv9(out, update_stats)
