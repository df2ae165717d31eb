"""Stage-2 network: conditional flow over the VQGAN latent (counterpart of
``glare_tpu/modules/llflow_vqgan2.py``).

normal_flow(gt_latent, lr):
    lr_enc = ConEncoder1(lr)
    z, logdet = flow.encode(gt_latent | +quant noise, cond=lr_enc)
    nll = -(logdet + logp(color_map, 0, z)) / (ln2 * pixels)
reverse_flow(lr):
    z := lr_enc['color_map']; x = flow.decode(z, cond=lr_enc)  -> VQGAN latent

Tensors are NCHW. Sub-module names are the reference checkpoint's: ``RRDB``,
``flowUpsamplerNet``. The flow runs in float32 (float64 in a float64 reference
run); ``set_compute_dtype`` casts the convolutions of the encoder. Training options of ``normal_flow``:
``ddinit`` (the ActNorm data-dependent init, see ``flow_layers``) and
``add_gt_noise`` (uniform dequantization noise of width 1/quant, from a given
``noise`` tensor, and -log(quant) * pixels in the logdet).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.layers import at_least_float32, cast_convs_
from .condition_encoder import ConEncoder1
from .flow_layers import GaussianDiag, pixels
from .flow_upsampler import FlowUpsamplerNet

LOG2 = math.log(2.0)


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

    def normal_flow(self, gt, lr, lr_enc=None, add_gt_noise=False, ddinit=False, noise=None,
                    generator=None):
        """Returns (z, nll, logdet). gt is the VQGAN latent [B, 3, h, w].
        ``add_gt_noise``: z = gt + (u - 0.5) / quant with u ~ U[0, 1) the given
        ``noise`` (gt's shape), or without it drawn from ``generator`` on its device
        (the JAX method's ``noise_rng``; None: torch's global generator)."""
        if lr_enc is None:
            lr_enc = self.RRDB(lr)
        pix = pixels(gt)
        z = at_least_float32(gt)
        logdet = torch.zeros(gt.shape[0], dtype=z.dtype, device=gt.device)
        if add_gt_noise:
            if noise is None:
                noise = torch.rand(gt.shape, generator=generator, dtype=z.dtype,
                                   device=generator.device if generator is not None else gt.device)
            z = z + (noise.to(z) - 0.5) / self.quant
            logdet = logdet + float(-math.log(self.quant) * pix)
        z, logdet = self.flowUpsamplerNet.encode(z, lr_enc, logdet=logdet, ddinit=ddinit)
        mean = lr_enc["color_map"].to(z.dtype)
        objective = logdet + GaussianDiag.logp(mean, 0.0, z)
        nll = -objective / (LOG2 * pix)
        return z, nll, logdet

    def reverse_flow(self, lr, lr_enc=None, eps_std=None, add_gt_noise=False):
        """Returns (x_latent, logdet). The latent seed is the conditional colour map;
        ``add_gt_noise`` takes the dequantization term, -log(quant) * pixels of
        ``lr``, out of the logdet (as the JAX package does)."""
        if lr_enc is None:
            lr_enc = self.RRDB(lr)
        logdet = torch.zeros(lr.shape[0], dtype=torch.float32, device=lr.device)
        if add_gt_noise:
            logdet = logdet - float(-math.log(self.quant) * pixels(lr))
        z = lr_enc["color_map"].float()
        return self.flowUpsamplerNet.decode(z, lr_enc, logdet=logdet, eps_std=eps_std)
