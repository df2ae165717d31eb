"""Adaptive Feature Transformation (AFT) decoder (counterpart of
``glare_tpu/modules/deformable_decoder.py``).

  * :class:`DCNv2Pack` -- modulated deformable conv whose offsets/masks are
    predicted from a *different* feature map, zero-initialized so it starts as
    a plain conv.
  * :class:`WarpBlock` -- offset conv + DCNv2 alignment of VQGAN decoder
    features to the current hidden state.
  * :class:`Mix` -- learned sigmoid-scalar blend.
  * :class:`MultiScaleDecoder2` -- VQGAN-shaped decoder fusing (flow latent,
    VQGAN ``code_decoder_output``, conditional-encoder ``mid_feat``).

Checkpoint names are the reference's: ``warp.{w}.offset``,
``warp.{w}.dcn.conv_offset`` / ``.weight`` (OIHW) / ``.bias``, ``mix.{w}.w``,
``residual_conv``. ``conv_offset`` keeps the reference channel packing:
``o1, o2, mask = chunk(out, 3)``, ``offset = cat(o1, o2)`` read as
``[G, K, (dy, dx)]`` -- channel ``g*2K + 2k`` is dy of tap k, ``+1`` is dx.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from ..nn.layers import AttnBlock, Conv, GroupNorm32, ResnetBlock, Upsample, swish
from ..ops import dcn as dcn_ops

_LATER = ("dcn_impl '{}' is not ported yet: the DCN cascade (hybrid) with its offset audit, the "
          "chain op and the gather hybrid come in a later slice of the port; use 'xla' (exact) "
          "or 'pallas' (clamped at dcn_max_offset)")


class DCNv2Pack(nn.Module):
    """Modulated deformable conv, offsets from a side feature map.

    impl: ``'xla'`` = exact, unbounded offsets; ``'pallas'`` = offsets clamped
    to ``max_offset`` (an int, or a ``[G][K]`` nested tuple of per-tap radii).
    The names are the JAX package's option values; here both run the one
    hand-written CUDA kernel on the card (``ops/dcn.py``). The other impls of
    the JAX package raise ``NotImplementedError``.

    After a forward with a clamped impl, ``dcn_overflow`` holds the int64 tensor
    ``[0, n_taps_beyond_clamp]`` (the JAX module's ``dcn_overflow`` sow): non-zero
    means this batch's output deviates from exact DCNv2.
    """

    def __init__(self, in_channels, features, deformable_groups=4, kernel_size=3, impl="xla",
                 max_offset: Any = 2):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("DCNv2Pack: only 3x3 is ported")
        if impl not in ("xla", "pallas"):
            raise NotImplementedError(_LATER.format(impl))
        self.G, self.K = deformable_groups, kernel_size * kernel_size
        self.impl, self.max_offset = impl, max_offset
        self.conv_offset = Conv(in_channels, self.G * 3 * self.K, 3, padding=1, zero_init=True)
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dcn_overflow = None
        self.last_shapes = None

    def seeded_reset(self, generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.K)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.zero_()

    def offsets_and_mask(self, feat):
        """-> offset [B,H,W,G,K,2] (dy,dx) float32, mask [B,H,W,G,K] float32."""
        raw = self.conv_offset(feat).float()
        B, _, H, W = raw.shape
        G, K = self.G, self.K
        o1, o2, m = torch.chunk(raw, 3, dim=1)
        offset = torch.cat([o1, o2], dim=1).reshape(B, G, K, 2, H, W).permute(0, 4, 5, 1, 2, 3)
        mask = torch.sigmoid(m).reshape(B, G, K, H, W).permute(0, 3, 4, 1, 2)
        return offset.contiguous(), mask.contiguous()

    def forward(self, x, feat):
        offset, mask = self.offsets_and_mask(feat)
        if self.impl == "pallas":
            max_offset = self.max_offset
            thresh = dcn_ops.clamp_table(max_offset, self.G, self.K).to(offset.device)
            beyond = (offset.abs().amax(dim=-1) > thresh).sum()
            self.dcn_overflow = torch.stack([torch.zeros_like(beyond), beyond])
        else:
            max_offset = None
            self.dcn_overflow = None
        x_nhwc = x.permute(0, 2, 3, 1)
        self.last_shapes = {"x": list(x_nhwc.shape), "offset": list(offset.shape),
                            "mask": list(mask.shape), "dtype": str(x.dtype).split(".")[-1]}
        out = dcn_ops.modulated_deform_conv(
            x_nhwc, offset, mask, self.weight.permute(2, 3, 1, 0), self.bias,
            max_offset=max_offset)
        return out.permute(0, 3, 1, 2)


class WarpBlock(nn.Module):
    """Align VQGAN features to the hidden state via DCNv2 (``warp_mode='dcn'``;
    the bounded group-flow alignment ``'flow'`` is not ported yet)."""

    def __init__(self, channels, warp_mode="dcn", dcn_impl="xla", dcn_max_offset: Any = 2):
        super().__init__()
        if warp_mode != "dcn":
            raise NotImplementedError(
                f"warp_mode '{warp_mode}' is not ported yet (only 'dcn'); it comes in a later "
                "slice of the port")
        self.offset = Conv(channels * 2, channels, 3, padding=1)
        self.dcn = DCNv2Pack(channels, channels, deformable_groups=4, impl=dcn_impl,
                             max_offset=dcn_max_offset)

    def forward(self, x_vq, x_residual):
        side = self.offset(torch.cat([x_vq, x_residual.to(x_vq.dtype)], dim=1))
        return self.dcn(x_vq, side)


class Mix(nn.Module):
    """out = sigmoid(w)*fea1 + (1-sigmoid(w))*fea2 with a scalar learned w."""

    def __init__(self, m=-0.80):
        super().__init__()
        self.w = nn.Parameter(torch.tensor([float(m)]))

    def forward(self, fea1, fea2):
        mix_factor = torch.sigmoid(self.w)[0].to(fea1.dtype)
        return fea1 * mix_factor + fea2.to(fea1.dtype) * (1 - mix_factor)


def _per_warp(v, w):
    """A 2-sequence is indexed by warp id; anything else (a scalar, or a [G][K]
    table of per-tap radii with G != 2 rows) is shared by both warps."""
    if isinstance(v, (tuple, list)) and len(v) == 2:
        return v[w]
    return v


class MultiScaleDecoder2(nn.Module):
    """AFT decoder.

    forward(z, code_decoder_output, enc_feat): VQGAN-decoder trunk from the flow
    latent z; at levels != 2:
        h = Mix(enc_feat[level], h)
        x_vq = WarpBlock(code_decoder_output[1-level], h)
        h = h + x_vq * (mean(h) / mean(x_vq))
    final: GroupNorm -> swish -> residual_conv(ch -> 3).

    ``dcn_impl`` / ``dcn_max_offset`` accept a scalar (shared by both warps) or a
    2-sequence indexed by warp id (warp 0 = quarter-res level, warp 1 = half-res).
    """

    def __init__(self, ch=128, out_ch=3, ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (64,), dropout=0.0, resolution=256,
                 z_channels=3, warp_mode="dcn", dcn_impl: Any = "xla", dcn_max_offset: Any = 2):
        super().__init__()
        self.num_resolutions = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * ch_mult[self.num_resolutions - 1]
        curr_res = resolution // 2 ** (self.num_resolutions - 1)
        self.conv_in = Conv(z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, dropout=dropout)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, dropout=dropout)
        levels = [None] * self.num_resolutions
        warps, mixes = [None, None], [None, None]
        for i_level in reversed(range(self.num_resolutions)):
            block_out = ch * ch_mult[i_level]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 2:
                w = 1 - i_level
                warps[w] = WarpBlock(block_in, warp_mode=warp_mode,
                                     dcn_impl=_per_warp(dcn_impl, w),
                                     dcn_max_offset=_per_warp(dcn_max_offset, w))
                mixes[w] = Mix(m=-1.0 if i_level == 1 else -0.6)
            if i_level != 0:
                level.upsample = Upsample(block_in, True)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.warp = nn.ModuleList(warps)
        self.mix = nn.ModuleList(mixes)
        self.norm_out = GroupNorm32(block_in)
        self.residual_conv = Conv(block_in, out_ch, 3, padding=1)

    def forward(self, z, code_decoder_output, enc_feat):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i_level in reversed(range(self.num_resolutions)):
            level = self.up[i_level]
            for i_block in range(self.num_res_blocks + 1):
                h = level.block[i_block](h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if i_level != 2:
                w = 1 - i_level
                x_code = code_decoder_output[w].to(h.dtype)
                h = self.mix[w](enc_feat[i_level].to(h.dtype), h)
                x_vq = self.warp[w](x_code, h)
                ratio = (h.float().mean() / x_vq.float().mean()).to(h.dtype)
                h = h + x_vq * ratio
            if i_level != 0:
                h = level.upsample(h)
        return self.residual_conv(swish(self.norm_out(h)))

    def dcn_overflow(self):
        """Per-warp ``dcn_overflow`` tensors of the last forward (None for exact impls)."""
        return [w.dcn.dcn_overflow for w in self.warp]

    def last_dcn_shapes(self):
        return {f"warp_{i}": w.dcn.last_shapes for i, w in enumerate(self.warp)}
