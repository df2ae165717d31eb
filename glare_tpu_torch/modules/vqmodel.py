"""Frozen VQGAN prior (counterpart of ``glare_tpu/modules/vqmodel.py``).

encode(x) = quant_conv(encoder(x))
decode(h) = decoder(post_quant_conv(quantize(h))) -> (dec, emb_loss, code_decoder_output)

Tensors are NCHW (channels_last memory).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn.layers import Conv
from .encoder_decoder import Decoder, Encoder
from .quantize import VectorQuantizer2


class VQModel(nn.Module):
    def __init__(self, resolution=256, n_embed=8192, embed_dim=3, z_channels=3, in_channels=3,
                 out_ch=3, ch=128, ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (64,), dropout=0.0):
        super().__init__()
        kw = dict(ch=ch, out_ch=out_ch, ch_mult=tuple(ch_mult), num_res_blocks=num_res_blocks,
                  attn_resolutions=tuple(attn_resolutions), dropout=dropout,
                  in_channels=in_channels, resolution=resolution, z_channels=z_channels)
        self.encoder = Encoder(double_z=False, **kw)
        self.decoder = Decoder(**kw)
        self.quantize = VectorQuantizer2(n_e=n_embed, e_dim=embed_dim, beta=0.25)
        self.quant_conv = Conv(z_channels, embed_dim, 1)
        self.post_quant_conv = Conv(embed_dim, z_channels, 1)

    def encode(self, x):
        return self.quant_conv(self.encoder(x)), None  # (latent, vgg_feat placeholder)

    def decode(self, h):
        quant, emb_loss, _info = self.quantize(h)
        dec, code_decoder_output = self.decoder(self.post_quant_conv(quant))
        return dec, emb_loss, code_decoder_output

    def forward(self, x):
        h, _ = self.encode(x)
        dec, diff, _ = self.decode(h)
        return dec, diff
