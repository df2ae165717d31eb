"""Stage-2 network: conditional flow over the VQGAN latent (counterpart of
``glare_tpu/modules/llflow_vqgan2.py``).

normal_flow(gt_latent, lr):
    lr_enc = ConEncoder1(lr)
    z, logdet = flow.encode(gt_latent, cond=lr_enc)
    nll = -(logdet + logp(color_map, 0, z)) / (ln2 * pixels)
reverse_flow(lr):
    z := lr_enc['color_map']; x = flow.decode(z, cond=lr_enc)  -> VQGAN latent

Tensors are NCHW. Sub-module names are the reference checkpoint's: ``RRDB``,
``flowUpsamplerNet``. The flow always runs in float32; ``set_compute_dtype``
casts the convolutions of the encoder. The training-only options (``ddinit``,
the ActNorm data-dependent init, and ``add_gt_noise``) are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import cast_convs_
from .condition_encoder import ConEncoder1
from .flow_layers import GaussianDiag, pixels
from .flow_upsampler import FlowUpsamplerNet

LOG2 = math.log(2.0)
_TRAINING = ("LLFlowVQGAN2: {} belongs to stage-2 training, which is not ported yet (a later "
             "slice of the port)")


class LLFlowVQGAN2(nn.Module):
    def __init__(self, K=12, L=2, additional_flow_no_affine=2, hidden_channels=64,
                 coupling="CondAffineSeparatedAndCond", quant=32.0,
                 # structural miniaturization knobs (shipped geometry 128/2) for the tests
                 enc_ch=128, enc_num_res_blocks=2):
        super().__init__()
        self.quant = quant
        self.RRDB = ConEncoder1(ch=enc_ch, num_res_blocks=enc_num_res_blocks)
        self.flowUpsamplerNet = FlowUpsamplerNet(
            K=K, L=L, additional_flow_no_affine=additional_flow_no_affine,
            hidden_channels=hidden_channels, flow_coupling=coupling)

    def set_compute_dtype(self, dtype):
        cast_convs_(self.RRDB, dtype)
        return self

    def forward(self, lr, gt=None, reverse=True, **kw):
        if reverse:
            return self.reverse_flow(lr, **kw)
        return self.normal_flow(gt, lr, **kw)

    def encode_cond(self, lr, mid_feat=False):
        return self.RRDB(lr, mid_feat=mid_feat)

    def normal_flow(self, gt, lr, lr_enc=None, add_gt_noise=False, ddinit=False):
        """Returns (z, nll, logdet). gt is the VQGAN latent [B, 3, h, w]."""
        if add_gt_noise:
            raise NotImplementedError(_TRAINING.format("add_gt_noise=True"))
        if ddinit:
            raise NotImplementedError(_TRAINING.format("ddinit=True (the ActNorm init)"))
        if lr_enc is None:
            lr_enc = self.RRDB(lr)
        pix = pixels(gt)
        z = gt.float()
        logdet = torch.zeros(gt.shape[0], dtype=torch.float32, device=gt.device)
        z, logdet = self.flowUpsamplerNet.encode(z, lr_enc, logdet=logdet)
        mean = lr_enc["color_map"].float()
        objective = logdet + GaussianDiag.logp(mean, 0.0, z)
        nll = -objective / (LOG2 * pix)
        return z, nll, logdet

    def reverse_flow(self, lr, lr_enc=None, eps_std=None, add_gt_noise=False):
        """Returns (x_latent, logdet). The latent seed is the conditional colour map."""
        if add_gt_noise:
            raise NotImplementedError(_TRAINING.format("add_gt_noise=True"))
        if lr_enc is None:
            lr_enc = self.RRDB(lr)
        logdet = torch.zeros(lr.shape[0], dtype=torch.float32, device=lr.device)
        z = lr_enc["color_map"].float()
        return self.flowUpsamplerNet.decode(z, lr_enc, logdet=logdet, eps_std=eps_std)
