"""Stage-3 network: frozen flow + AFT deformable decoder (counterpart of
``glare_tpu/modules/vqllflow_deformable.py``).

The reverse pass decomposes into two halves around the frozen VQGAN decode
(which lives in a separate :class:`VQModel`):

    latent_half(lr):  lr_enc = ConEncoder1(lr, mid_feat=True)
                      x = flow.decode(color_map, cond=lr_enc)
    [outside]         rec, _, code_decoder_output = vqmodel.decode(x)
    aft_half(...):    rec_def = MultiScaleDecoder2(x, code_decoder_output, lr_enc['mid_feat'])

Sub-module names are the reference checkpoint's: ``RRDB``, ``flowUpsamplerNet``,
``deformable_decoder``. The flow always runs in float32; ``set_compute_dtype``
casts the convolutions of the encoder and the AFT decoder.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from ..nn.layers import cast_convs_
from .condition_encoder import ConEncoder1
from .deformable_decoder import MultiScaleDecoder2
from .flow_upsampler import FlowUpsamplerNet


class VQLLFLOWDeformable(nn.Module):
    def __init__(self, K=12, L=2, additional_flow_no_affine=2, hidden_channels=64,
                 coupling="CondAffineSeparatedAndCond", quant=32.0, warp_mode="dcn",
                 dcn_impl: Any = "xla", dcn_max_offset: Any = 2,
                 # structural miniaturization knobs (shipped geometry 2/2/128/128): the
                 # tests shrink all of them together with the VQGAN's ch
                 enc_num_res_blocks=2, dec_num_res_blocks=2, decoder_ch=128, enc_ch=128):
        super().__init__()
        self.quant = quant
        self.dcn_impl, self.dcn_max_offset = dcn_impl, dcn_max_offset
        self.RRDB = ConEncoder1(ch=enc_ch, num_res_blocks=enc_num_res_blocks)
        self.flowUpsamplerNet = FlowUpsamplerNet(
            K=K, L=L, additional_flow_no_affine=additional_flow_no_affine,
            hidden_channels=hidden_channels, flow_coupling=coupling)
        self.deformable_decoder = MultiScaleDecoder2(
            ch=decoder_ch, num_res_blocks=dec_num_res_blocks, warp_mode=warp_mode,
            dcn_impl=dcn_impl, dcn_max_offset=dcn_max_offset)

    def set_compute_dtype(self, dtype):
        cast_convs_(self.RRDB, dtype)
        cast_convs_(self.deformable_decoder, dtype)
        return self

    def forward(self, lr, code_decoder_output=None):
        x, lr_enc = self.latent_half(lr)
        if code_decoder_output is None:
            raise ValueError("VQLLFLOWDeformable needs the frozen VQGAN decode: run "
                             "latent_half, vqmodel.decode, then aft_half.")
        return self.aft_half(x, code_decoder_output, lr_enc["mid_feat"])

    def latent_half(self, lr, lr_enc=None, eps_std=None):
        """Conditional encode + frozen flow inverse -> VQGAN latent (float32)."""
        if lr_enc is None:
            lr_enc = self.RRDB(lr, mid_feat=True)
        z = lr_enc["color_map"].float()
        x, _logdet = self.flowUpsamplerNet.decode(z, lr_enc, logdet=None, eps_std=eps_std)
        return x, lr_enc

    def encode_cond(self, lr, mid_feat=True):
        return self.RRDB(lr, mid_feat=mid_feat)

    def aft_half(self, x_latent, code_decoder_output, mid_feat):
        """AFT decoder fusion."""
        return self.deformable_decoder(x_latent, code_decoder_output, mid_feat)
