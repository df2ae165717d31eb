"""Conditional encoder over the log-domain low-light input (counterpart of
``glare_tpu/modules/condition_encoder.py``).

A VQGAN-shaped Encoder produces a 3-channel latent-resolution map; two heads
derive ``cond_feat`` (Conv 3->64 + sigmoid: coupling conditioning) and
``color_map`` (Conv 3->3: the reverse flow's seed); ``mid_feat`` are the
encoder's pre-downsample skips for the AFT decoder's Mix blocks.
``cond_conv`` is a ``Sequential(conv, sigmoid)`` as in the reference, so the
checkpoint key is ``cond_conv.0.weight``.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn.layers import Conv
from .encoder_decoder import Encoder


class ConEncoder1(nn.Module):
    def __init__(self, resolution=256, z_channels=3, in_channels=3, out_ch=3, ch=128,
                 ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (64,), dropout=0.0):
        super().__init__()
        self.encoder = Encoder(ch=ch, out_ch=out_ch, ch_mult=tuple(ch_mult),
                               num_res_blocks=num_res_blocks,
                               attn_resolutions=tuple(attn_resolutions), dropout=dropout,
                               in_channels=in_channels, resolution=resolution,
                               z_channels=z_channels, double_z=False)
        self.cond_conv = nn.Sequential(Conv(z_channels, 64, 3, padding=1), nn.Sigmoid())
        self.color_conv = Conv(z_channels, 3, 3, padding=1)

    def forward(self, x, mid_feat: bool = False):
        enc_feat, skips = self.encoder(x, mid_feat=True)
        results = {"cond_feat": self.cond_conv(enc_feat), "color_map": self.color_conv(enc_feat)}
        if mid_feat:
            results["mid_feat"] = skips
        return results
