"""One Glow step: ActNorm -> InvertibleConv1x1 -> (optional) conditional
coupling (counterpart of ``glare_tpu/modules/flow_step.py``).

Permutation 'invconv'; couplings 'CondAffineSeparatedAndCond' and 'noCoupling'.
"""

from __future__ import annotations

from torch import nn

from .coupling import CondAffineSeparatedAndCond
from .flow_layers import ActNorm2d, InvertibleConv1x1


class FlowStep(nn.Module):
    def __init__(self, in_channels, hidden_channels=64, actnorm_scale=1.0,
                 flow_permutation="invconv", flow_coupling="CondAffineSeparatedAndCond",
                 in_channels_rrdb=64, le_curve=False):
        super().__init__()
        assert flow_permutation == "invconv", flow_permutation
        self.actnorm = ActNorm2d(in_channels, actnorm_scale)
        self.invconv = InvertibleConv1x1(in_channels)
        self.affine = None
        if flow_coupling == "CondAffineSeparatedAndCond":
            self.affine = CondAffineSeparatedAndCond(
                in_channels=in_channels, in_channels_rrdb=in_channels_rrdb,
                hidden_channels=hidden_channels, le_curve=le_curve)
        elif flow_coupling != "noCoupling":
            raise ValueError(f"coupling not found: {flow_coupling}")

    def forward(self, z, logdet=None, reverse=False, ft=None, ddinit=False):
        if not reverse:
            z, logdet = self.actnorm(z, logdet, reverse=False, ddinit=ddinit)
            z, logdet = self.invconv(z, logdet, reverse=False)
            if self.affine is not None:
                z, logdet = self.affine(z, logdet, reverse=False, ft=ft, ddinit=ddinit)
        else:
            if self.affine is not None:
                z, logdet = self.affine(z, logdet, reverse=True, ft=ft, ddinit=ddinit)
            z, logdet = self.invconv(z, logdet, reverse=True)
            z, logdet = self.actnorm(z, logdet, reverse=True, ddinit=ddinit)
        return z, logdet
