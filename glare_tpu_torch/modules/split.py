"""Split2d: channel split with a learned conditional-Gaussian prior over the
consumed half (counterpart of ``glare_tpu/modules/split.py``). Disabled in every
shipped conf (``flow.split.enable: false``); kept as far as ``FlowUpsamplerNet``
constructs it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .flow_layers import Conv2dZeros, split_feature_cross, sum_per_sample

LOG2PI = math.log(2 * math.pi)


def gaussian_logp(mean, logs, x):
    ll = -0.5 * (logs * 2.0 + ((x - mean) ** 2) / torch.exp(logs * 2.0) + LOG2PI)
    return sum_per_sample(ll)


class Split2d(nn.Module):
    def __init__(self, num_channels, logs_eps=0.0, consume_ratio=0.5, cond_channels=0):
        super().__init__()
        self.num_channels_consume = int(round(num_channels * consume_ratio))
        self.num_channels_pass = num_channels - self.num_channels_consume
        self.logs_eps = logs_eps
        self.conv = Conv2dZeros(self.num_channels_pass + cond_channels,
                                self.num_channels_consume * 2)

    def split2d_prior(self, z, ft):
        if ft is not None:
            z = torch.cat([z, ft.to(z.dtype)], dim=1)
        return split_feature_cross(self.conv(z))

    def forward(self, z, logdet=None, reverse=False, eps=None, eps_std=None, ft=None,
                generator=None):
        if not reverse:
            z1, z2 = z[:, : self.num_channels_pass], z[:, self.num_channels_pass:]
            mean, logs = self.split2d_prior(z1, ft)
            eps_out = (z2 - mean) / torch.exp(logs + self.logs_eps)
            if logdet is not None:
                logdet = logdet + gaussian_logp(mean, logs + self.logs_eps, z2)
            return z1, logdet, eps_out
        z1 = z
        mean, logs = self.split2d_prior(z1, ft)
        if eps is None:
            assert generator is not None, "Split2d reverse sampling needs a torch.Generator"
            eps = torch.randn(mean.shape, generator=generator, device=generator.device,
                              dtype=mean.dtype).to(mean.device) * (eps_std or 0.0)
        z2 = mean + torch.exp(logs + self.logs_eps) * eps
        z = torch.cat([z1, z2], dim=1)
        if logdet is not None:
            logdet = logdet - gaussian_logp(mean, logs + self.logs_eps, z2)
        return z, logdet, None
