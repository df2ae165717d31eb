"""RIDCP weighted-codebook VQ autoencoder (counterpart of
``glare_tpu/sr/archs/vq_weight_arch.py``; reference:
basicsr/archs/dehaze_vq_weight_arch.py, registered as ``VQWeightDehazeNet``:
GLARE trains its stage-1 codebook prior with it). NCHW.

  * :class:`MultiScaleEncoder`: 4x4 ``in_conv`` (padding 1: 256 -> 255 before the
    first stride-2 conv, as in the JAX module) + per level a stride-2 conv and two
    ResBlocks, + 4 RSTB Swin blocks in the LQ stage.
  * the weighted quantizer (``modules/quantize.py:WeightedVectorQuantizer``) at
    the codebook scale, a 1x1 conv before it and a CombineQuantBlock after it.
  * ``decoder_group``: DecoderBlocks (nearest 2x, conv, two ResBlocks).
  * LQ stage: the residual :class:`MultiScaleDecoder`, whose per-level
    ``WarpBlock`` (``modules/deformable_decoder.py``: an offset conv on the
    concatenated features and ``DCNv2Pack(c, c, deformable_groups=4,
    impl='xla')``, exact offsets) aligns the code decoder's features; on the card
    the DCN runs ``ops.dcn.ModulatedDeformConvFunction`` under autograd.

``state_dict`` names follow the reference: ``multiscale_encoder.{in_conv,
blocks.{i}.{0,1,2}, swin_blks.swin_blks.{j}}``, ``quantize_group.0.{embedding.weight,
weight}``, ``before_quant_group.0``, ``after_quant_group.0.conv``,
``decoder_group.{i}.block.{1,2,3}``, ``out_conv``, ``residual_conv``,
``multiscale_decoder.{upsampler.{i}.{1,2,3}, warp.{i}.{offset, dcn}}``,
``conv_semantic.0`` (``convert.flax_to_torch_stage1`` maps the JAX tree onto them).
As in the JAX module, a sub-network that its configuration never calls has no
parameters: ``residual_conv`` / ``multiscale_decoder`` exist in the LQ stage with
``use_residual``, the warps unless ``only_residual`` or not ``use_warp``,
``conv_semantic`` with ``use_semantic_loss``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...modules.deformable_decoder import WarpBlock
from ...modules.quantize import WeightedVectorQuantizer
from ...nn.layers import Conv
from ..registry import ARCH_REGISTRY
from .ridcp_utils import CombineQuantBlock, ResBlock
from .swin import SwinLayers

CHANNEL_QUERY_DICT = {8: 256, 16: 256, 32: 256, 64: 256, 128: 128, 256: 64, 512: 32}


def _up_block(in_ch, out_ch, norm_type, act_type):
    """Nearest 2x, 3x3 conv, two ResBlocks (the reference's Sequential, index 0 the upsample)."""
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"), Conv(in_ch, out_ch, 3, padding=1),
                         ResBlock(out_ch, out_ch, norm_type, act_type),
                         ResBlock(out_ch, out_ch, norm_type, act_type))


class MultiScaleEncoder(nn.Module):
    def __init__(self, in_channel, max_depth, input_res=256, norm_type="gn", act_type="silu",
                 LQ_stage=True, swin_embed_dim=256):
        super().__init__()
        self.in_conv = Conv(in_channel, CHANNEL_QUERY_DICT[input_res], 4, padding=1)
        blocks, res = [], input_res
        for _ in range(max_depth):
            in_ch, out_ch = CHANNEL_QUERY_DICT[res], CHANNEL_QUERY_DICT[res // 2]
            blocks.append(nn.Sequential(Conv(in_ch, out_ch, 3, stride=2, padding=1),
                                        ResBlock(out_ch, out_ch, norm_type, act_type),
                                        ResBlock(out_ch, out_ch, norm_type, act_type)))
            res //= 2
        self.blocks = nn.ModuleList(blocks)
        self.LQ_stage = LQ_stage
        if LQ_stage:
            self.swin_blks = SwinLayers(embed_dim=swin_embed_dim)

    def forward(self, x):
        x = self.in_conv(x)
        for blk in self.blocks:
            x = blk(x)
        return self.swin_blks(x) if self.LQ_stage else x


class DecoderBlock(nn.Module):
    def __init__(self, in_channel, out_channel, norm_type="gn", act_type="silu"):
        super().__init__()
        self.block = _up_block(in_channel, out_channel, norm_type, act_type)

    def forward(self, x):
        return self.block(x)


class MultiScaleDecoder(nn.Module):
    """LQ-stage residual decoder: per level an upsampling block, then (unless
    ``only_residual``) the warped code-decoder feature added at the ratio of the
    means, ``x + x_vq * mean(x) / mean(x_vq)`` (or added plainly without warp)."""

    def __init__(self, max_depth, input_res=256, norm_type="gn", act_type="silu",
                 only_residual=False, use_warp=True):
        super().__init__()
        self.only_residual, self.use_warp = only_residual, use_warp
        res = [input_res // 2 ** max_depth * 2 ** i for i in range(max_depth + 1)]
        self.upsampler = nn.ModuleList(
            _up_block(CHANNEL_QUERY_DICT[r], CHANNEL_QUERY_DICT[r * 2], norm_type, act_type) for r in res[:-1])
        if use_warp and not only_residual:
            self.warp = nn.ModuleList(WarpBlock(CHANNEL_QUERY_DICT[r], dcn_impl="xla") for r in res[1:])

    def forward(self, x, code_decoder_output):
        for i, up in enumerate(self.upsampler):
            x = up(x)
            if self.only_residual:
                continue
            if self.use_warp:
                x_vq = self.warp[i](code_decoder_output[i], x)
                x = x + x_vq * (x.mean() / x_vq.mean())
            else:
                x = x + code_decoder_output[i]
        return x


@ARCH_REGISTRY.register()
class VQWeightDehazeNet(nn.Module):
    """``encode_and_decode(x, gt_indices=None, weight_alpha=None)`` -> (out,
    out_residual or None, codebook loss, feat_to_quant, z_quant, [indices]).
    ``frozen_module_keywords`` is the reference's argument; the trainer
    (``sr/models/vq_model.py``) applies it in the LQ stage."""

    def __init__(self, in_channel=3, codebook_params=((64, 1024, 512),), gt_resolution=256,
                 LQ_stage=False, norm_type="gn", act_type="silu", use_quantize=True,
                 use_residual=True, only_residual=False, use_weight=False, use_warp=True,
                 weight_alpha=1.0, use_semantic_loss=False, semantic_dim=256,
                 frozen_module_keywords=None):
        super().__init__()
        cps = np.asarray(codebook_params, np.float64).reshape(-1, 3)
        scales, emb_nums, emb_dims = (cps[:, j].astype(int).tolist() for j in range(3))
        self.gt_resolution, self.LQ_stage = gt_resolution, LQ_stage
        self.use_quantize, self.use_residual, self.only_residual = use_quantize, use_residual, only_residual
        self.frozen_module_keywords = frozen_module_keywords
        self.scales = tuple(scales)
        self.codebook_scale = scales[0]
        self.max_depth = int(math.log2(gt_resolution // self.codebook_scale))

        self.multiscale_encoder = MultiScaleEncoder(
            in_channel, self.max_depth, gt_resolution, norm_type, act_type, LQ_stage,
            swin_embed_dim=CHANNEL_QUERY_DICT[scales[0]])
        if LQ_stage and use_residual:
            self.multiscale_decoder = MultiScaleDecoder(
                self.max_depth, gt_resolution, norm_type, act_type, only_residual, use_warp)
            self.residual_conv = Conv(CHANNEL_QUERY_DICT[gt_resolution], 3, 3, padding=1)

        dec, res = [], gt_resolution // 2 ** self.max_depth
        for _ in range(self.max_depth):
            dec.append(DecoderBlock(CHANNEL_QUERY_DICT[res], CHANNEL_QUERY_DICT[res * 2], norm_type, act_type))
            res *= 2
        self.decoder_group = nn.ModuleList(dec)
        self.out_conv = Conv(CHANNEL_QUERY_DICT[gt_resolution], 3, 3, padding=1)

        quant, before, after = [], [], []
        for s, scale in enumerate(scales):
            quant.append(WeightedVectorQuantizer(emb_nums[s], emb_dims[s], weight_alpha=weight_alpha,
                                                 use_weight=use_weight, LQ_stage=LQ_stage))
            # scale 0 quantizes the encoder's map; a later scale the decoder's map
            # concatenated with itself (the JAX module's prev_dec_feat)
            in_ch = CHANNEL_QUERY_DICT[scale] * (1 if s == 0 else 2)
            before.append(Conv(in_ch, emb_dims[s], 1, padding=0))
            after.append(CombineQuantBlock(emb_dims[s] + (emb_dims[s - 1] if s else 0),
                                           CHANNEL_QUERY_DICT[scale]))
        self.quantize_group = nn.ModuleList(quant)
        self.before_quant_group = nn.ModuleList(before)
        self.after_quant_group = nn.ModuleList(after)
        if use_semantic_loss:
            # 1x1 conv + ReLU projecting the quantized latent onto frozen VGG16
            # relu3_3 features (the trainer's semantic loss)
            self.conv_semantic = nn.Sequential(Conv(emb_dims[0], semantic_dim, 1, padding=0), nn.ReLU())

    def encode_and_decode(self, x, gt_indices=None, weight_alpha=None, quantize_only=False):
        """``quantize_only``: stop after the last quantization (out and
        out_residual None): the latent without the decoders."""
        enc_feats = self.multiscale_encoder(x)
        losses, indices_list, code_decoder_output = [], [], []
        prev_dec_feat = prev_quant_feat = feat_to_quant = z_quant = None
        quant_idx, h = 0, enc_feats
        for i in range(self.max_depth):
            cur_res = self.gt_resolution // 2 ** self.max_depth * 2 ** i
            if cur_res in self.scales:
                before = h if prev_dec_feat is None else torch.cat([h, prev_dec_feat], dim=1)
                feat_to_quant = self.before_quant_group[quant_idx](before)
                gt_i = gt_indices[quant_idx] if gt_indices is not None else None
                z_quant, cb_loss, indices = self.quantize_group[quant_idx](
                    feat_to_quant, gt_indices=gt_i, weight_alpha=weight_alpha)
                if not self.use_quantize:
                    z_quant = feat_to_quant
                h = self.after_quant_group[quant_idx](z_quant, prev_quant_feat)
                losses.append(cb_loss)
                indices_list.append(indices)
                quant_idx += 1
                prev_quant_feat = z_quant
                if quantize_only and quant_idx == len(self.scales):
                    return None, None, sum(losses), feat_to_quant, z_quant, indices_list
            h = self.decoder_group[i](h)
            code_decoder_output.append(h)
            prev_dec_feat = h

        out_img = self.out_conv(h)
        out_img_residual = None
        if self.LQ_stage and self.use_residual:
            src = enc_feats if self.only_residual else enc_feats.detach()
            out_img_residual = self.residual_conv(self.multiscale_decoder(src, code_decoder_output))
        codebook_loss = sum(losses) if losses else 0.0
        return out_img, out_img_residual, codebook_loss, feat_to_quant, z_quant, indices_list

    def forward(self, x, gt_indices=None, weight_alpha=None):
        return self.encode_and_decode(x, gt_indices=gt_indices, weight_alpha=weight_alpha)

    def semantic_embed(self, z_quant):
        """Project the quantized latent for the semantic cluster loss."""
        return self.conv_semantic(z_quant)

    def decode_indices(self, indices):
        """indices [B, h, w] -> image [B, 3, H, W]."""
        b, h, w = indices.shape
        z_q = self.quantize_group[0].embed(indices, shape=(b, h, w, -1)).permute(0, 3, 1, 2)
        x = self.after_quant_group[0](z_q)
        for m in self.decoder_group:
            x = m(x)
        return self.out_conv(x)
