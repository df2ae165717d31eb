"""Conditional affine coupling (counterpart of ``glare_tpu/modules/coupling.py``).

CondAffineSeparatedAndCond, two sub-transforms per step:
  (a) feature-conditional affine on ALL channels: (shift, scale) = F(ft)
  (b) self-conditional affine on the co-half:     (shift, scale) = F([z1, ft])
scale = sigmoid(raw + 2) + eps; 'cross' channel split for (shift, scale).
The optional ``le_curve`` power-curve branch (off in all shipped confs) is kept.
"""

from __future__ import annotations

import torch
from torch import nn

from .flow_layers import Conv2dNormed, Conv2dZeros, cat_feature, split_feature_cross, sum_per_sample


def FNet(in_channels, out_channels, hidden_channels=64, kernel_hidden=1, n_hidden_layers=1):
    """Conv(+ActNorm) -> ReLU -> 1x1(+ActNorm) -> ReLU -> Conv2dZeros, as a
    ``Sequential`` so the checkpoint keys are ``0.weight``, ``2.weight``, ``4.weight``."""
    layers = [Conv2dNormed(in_channels, hidden_channels, (3, 3)), nn.ReLU()]
    for _ in range(n_hidden_layers):
        layers += [Conv2dNormed(hidden_channels, hidden_channels, (kernel_hidden, kernel_hidden)),
                   nn.ReLU()]
    layers.append(Conv2dZeros(hidden_channels, out_channels, (3, 3)))
    return nn.Sequential(*layers)


class CondAffineSeparatedAndCond(nn.Module):
    def __init__(self, in_channels, in_channels_rrdb=64, hidden_channels=64, affine_eps=0.0001,
                 le_curve=False):
        super().__init__()
        self.in_channels = in_channels
        self.affine_eps = affine_eps
        self.le_curve = le_curve
        self.channels_for_nn = in_channels // 2
        self.channels_for_co = in_channels - self.channels_for_nn
        self.fAffine = FNet(self.channels_for_nn + in_channels_rrdb, self.channels_for_co * 2,
                            hidden_channels)
        self.fFeatures = FNet(in_channels_rrdb, in_channels * 2, hidden_channels)
        if le_curve:
            self.fCurve = FNet(in_channels_rrdb, in_channels, hidden_channels)

    def _scale_shift(self, h):
        shift, scale = split_feature_cross(h)
        return torch.sigmoid(scale + 2.0) + self.affine_eps, shift

    def _split(self, z):
        return z[:, : self.channels_for_nn], z[:, self.channels_for_nn:]

    def forward(self, z, logdet=None, reverse=False, ft=None):
        assert z.shape[1] == self.in_channels, (z.shape, self.in_channels)
        ft = ft.to(z.dtype)
        if not reverse:
            scale_ft, shift_ft = self._scale_shift(self.fFeatures(ft))
            z = (z + shift_ft) * scale_ft
            if logdet is not None:
                logdet = logdet + sum_per_sample(torch.log(scale_ft))
            if self.le_curve:
                alpha = torch.relu(self.fCurve(ft)) + self.affine_eps
                if logdet is not None:
                    logdet = logdet + sum_per_sample(
                        torch.log(alpha * torch.pow(torch.abs(z), alpha - 1)) + self.affine_eps)
                z = torch.pow(torch.abs(z), alpha) * torch.sign(z)
            z1, z2 = self._split(z)
            scale, shift = self._scale_shift(self.fAffine(cat_feature(z1, ft)))
            z2 = (z2 + shift) * scale
            if logdet is not None:
                logdet = logdet + sum_per_sample(torch.log(scale))
            z = cat_feature(z1, z2)
        else:
            z1, z2 = self._split(z)
            scale, shift = self._scale_shift(self.fAffine(cat_feature(z1, ft)))
            z2 = z2 / scale - shift
            z = cat_feature(z1, z2)
            if logdet is not None:
                logdet = logdet - sum_per_sample(torch.log(scale))
            if self.le_curve:
                alpha = torch.relu(self.fCurve(ft)) + self.affine_eps
                z = torch.pow(torch.abs(z), 1.0 / alpha) * torch.sign(z)
            scale_ft, shift_ft = self._scale_shift(self.fFeatures(ft))
            z = z / scale_ft - shift_ft
            if logdet is not None:
                logdet = logdet - sum_per_sample(torch.log(scale_ft))
        return z, logdet
