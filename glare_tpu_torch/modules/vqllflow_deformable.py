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
sets the compute dtype of the convolutions of the encoder and the AFT decoder
(stored in it for serving, or float32 master weights cast at use for training).
``remat`` recomputes the AFT decoder's blocks in the backward of a training
forward (:class:`MultiScaleDecoder2`); ``dcn_audit_offsets`` starts both DCN
packs with ``audit_offsets`` on.
"""

from __future__ import annotations

from typing import Any

from torch import nn

from ..nn.layers import cast_convs_, set_conv_compute_dtype_
from .condition_encoder import ConEncoder1
from .deformable_decoder import MultiScaleDecoder2
from .flow_upsampler import FlowUpsamplerNet


class VQLLFLOWDeformable(nn.Module):
    def __init__(self, K=12, L=2, additional_flow_no_affine=2, hidden_channels=64,
                 coupling="CondAffineSeparatedAndCond", quant=32.0, warp_mode="dcn",
                 dcn_impl: Any = "xla", dcn_max_offset: Any = 2,
                 dcn_hybrid_capacity: Any = 0.125, dcn_hybrid_tail_offset: Any = 8,
                 dcn_audit_offsets=False, remat=False,
                 # structural miniaturization knobs (shipped geometry 2/2/128/128): the
                 # tests shrink all of them together with the VQGAN's ch
                 enc_num_res_blocks=2, dec_num_res_blocks=2, decoder_ch=128, enc_ch=128):
        super().__init__()
        self.quant = quant
        self.dcn_impl, self.dcn_max_offset = dcn_impl, dcn_max_offset
        self.dcn_hybrid_capacity = dcn_hybrid_capacity
        self.dcn_hybrid_tail_offset = dcn_hybrid_tail_offset
        self.RRDB = ConEncoder1(ch=enc_ch, num_res_blocks=enc_num_res_blocks)
        self.flowUpsamplerNet = FlowUpsamplerNet(
            K=K, L=L, additional_flow_no_affine=additional_flow_no_affine,
            hidden_channels=hidden_channels, flow_coupling=coupling)
        self.deformable_decoder = MultiScaleDecoder2(
            ch=decoder_ch, num_res_blocks=dec_num_res_blocks, warp_mode=warp_mode,
            dcn_impl=dcn_impl, dcn_max_offset=dcn_max_offset,
            dcn_hybrid_capacity=dcn_hybrid_capacity,
            dcn_hybrid_tail_offset=dcn_hybrid_tail_offset,
            dcn_audit_offsets=dcn_audit_offsets, remat=remat)

    def configure_dcn(self, **knobs):
        """Change any of ``dcn_impl`` / ``dcn_max_offset`` / ``dcn_hybrid_capacity`` /
        ``dcn_hybrid_tail_offset`` (scalar or per-warp pair) and re-dispatch the two
        DCN packs in place; the weights stay (what ``netG.clone(**knobs)`` does in
        the JAX package)."""
        names = ("dcn_impl", "dcn_max_offset", "dcn_hybrid_capacity", "dcn_hybrid_tail_offset")
        unknown = set(knobs) - set(names)
        if unknown:
            raise TypeError(f"configure_dcn: unknown knobs {sorted(unknown)}")
        new = {n: knobs.get(n, getattr(self, n)) for n in names}
        self.deformable_decoder.configure_dcn(**new)  # raises before anything is changed here
        for n, v in new.items():
            setattr(self, n, v)
        return self

    def set_compute_dtype(self, dtype, master_weights=False):
        """Convolutions of ``RRDB`` and ``deformable_decoder`` compute in ``dtype``:
        stored in it, or (``master_weights``) kept float32 and cast at use."""
        cast = set_conv_compute_dtype_ if master_weights else cast_convs_
        cast(self.RRDB, dtype)
        cast(self.deformable_decoder, dtype)
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
