"""FlowUpsamplerNet: assembles the conditional-flow graph (counterpart of
``glare_tpu/modules/flow_upsampler.py``).

For the shipped GLARE confs (scale=1, L=2, K=12, additionalFlowNoAffine=2,
split disabled) this builds, per level,

    2 x FlowStep(noCoupling)  +  K x FlowStep(CondAffineSeparatedAndCond)

all at the latent resolution with 3 channels, every coupling conditioned on
``rrdbResults['cond_feat']``. ``encode`` walks the steps forward accumulating
+logdet, ``decode`` walks them reversed with -logdet. Steps live in
``self.layers`` (checkpoint keys ``layers.{i}....``).
"""

from __future__ import annotations

import torch
from torch import nn

from .flow_step import FlowStep
from .split import Split2d


class FlowUpsamplerNet(nn.Module):
    def __init__(self, in_channels=3, hidden_channels=64, K=12, L=2, additional_flow_no_affine=2,
                 flow_coupling="CondAffineSeparatedAndCond", in_channels_rrdb=64,
                 split_enable=False, split_consume_ratio=0.5, split_logs_eps=0.0,
                 sigmoid_output=False, le_curve=False):
        super().__init__()
        self.sigmoid_output = sigmoid_output
        self.layers = nn.ModuleList()
        kinds = []
        C = in_channels
        for level in range(1, L + 1):
            for _ in range(additional_flow_no_affine):
                self.layers.append(FlowStep(C, hidden_channels, flow_coupling="noCoupling"))
                kinds.append("step")
            for _ in range(K):
                self.layers.append(FlowStep(C, hidden_channels, flow_coupling=flow_coupling,
                                            in_channels_rrdb=in_channels_rrdb, le_curve=le_curve))
                kinds.append("step")
            if split_enable and level < L:
                self.layers.append(Split2d(C, consume_ratio=split_consume_ratio,
                                           logs_eps=split_logs_eps))
                kinds.append("split")
                C = C - int(round(C * split_consume_ratio))
        self._layer_kinds = tuple(kinds)
        self.C_out = C

    def forward(self, z, rrdbResults=None, logdet=None, reverse=False, epses=None, eps_std=None,
                generator=None):
        if reverse:
            return self.decode(z, rrdbResults, logdet=logdet, epses=epses, eps_std=eps_std,
                               generator=generator)
        return self.encode(z, rrdbResults, logdet=logdet, epses=epses)

    @staticmethod
    def _ft(rrdbResults):
        if rrdbResults is None:
            return None
        return rrdbResults["cond_feat"] if isinstance(rrdbResults, dict) else rrdbResults

    def encode(self, gt, rrdbResults=None, logdet=None, epses=None):
        ft = self._ft(rrdbResults)
        z = gt
        eps_list = [] if isinstance(epses, list) else None
        for layer, kind in zip(self.layers, self._layer_kinds):
            if kind == "step":
                z, logdet = layer(z, logdet, reverse=False, ft=ft)
            else:
                z, logdet, eps = layer(z, logdet, reverse=False, ft=None)
                if eps_list is not None:
                    eps_list.append(eps)
        if eps_list is not None:
            eps_list.append(z)
            return eps_list, logdet
        return z, logdet

    def decode(self, z, rrdbResults=None, logdet=None, epses=None, eps_std=None, generator=None):
        ft = self._ft(rrdbResults)
        if isinstance(epses, list):
            epses = list(epses)
            z = epses.pop()
        x = z
        for layer, kind in zip(reversed(self.layers), reversed(self._layer_kinds)):
            if kind == "step":
                x, logdet = layer(x, logdet, reverse=True, ft=ft)
            else:
                eps = epses.pop() if isinstance(epses, list) else None
                x, logdet, _ = layer(x, logdet, reverse=True, eps=eps, eps_std=eps_std, ft=None,
                                     generator=generator)
        if self.sigmoid_output:
            x = torch.sigmoid(x)
        return x, logdet
