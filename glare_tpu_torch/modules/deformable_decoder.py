"""Adaptive Feature Transformation (AFT) decoder (counterpart of
``glare_tpu/modules/deformable_decoder.py``).

  * :class:`DCNv2Pack` -- modulated deformable conv whose offsets/masks are
    predicted from a *different* feature map, zero-initialized so it starts as
    a plain conv.
  * :class:`WarpBlock` -- offset conv + DCNv2 alignment of VQGAN decoder
    features to the current hidden state (``warp_mode='dcn'``), or the bounded
    group-flow alignment ``'flow'`` (``ops/warp.py``) and a 3x3 conv.
  * :class:`Mix` -- learned sigmoid-scalar blend.
  * :class:`MultiScaleDecoder2` -- VQGAN-shaped decoder fusing (flow latent,
    VQGAN ``code_decoder_output``, conditional-encoder ``mid_feat``).

Checkpoint names are the reference's: ``warp.{w}.offset``,
``warp.{w}.dcn.conv_offset`` / ``.weight`` (OIHW) / ``.bias``, ``mix.{w}.w``,
``residual_conv``; a flow warp (no reference counterpart) has the JAX module's
``warp.{w}.flow_head`` and ``warp.{w}.post_conv``. ``conv_offset`` keeps the
reference channel packing: ``o1, o2, mask = chunk(out, 3)``,
``offset = cat(o1, o2)`` read as
``[G, K, (dy, dx)]`` -- channel ``g*2K + 2k`` is dy of tap k, ``+1`` is dx.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import AttnBlock, Conv, GroupNorm32, ResnetBlock, Upsample, swish
from ..ops import dcn as dcn_ops
from ..ops import warp as warp_ops
from ..parallel.mesh import global_mean


class DCNv2Pack(nn.Module):
    """Modulated deformable conv, offsets from a side feature map.

    impl: ``'xla'`` = exact, unbounded offsets; ``'pallas'`` = offsets clamped
    to ``max_offset`` (an int, or a ``[G][K]`` nested tuple of per-tap radii);
    ``'chain'`` = the training formulation: offsets clamped to one radius, the
    largest of a per-tap table (the JAX chain op is uniform-radius too);
    ``'hybrid'`` = the cascade: clamp ``max_offset`` everywhere, and up to
    ``hybrid_capacity`` of the row blocks that hold a tap beyond it recomputed
    at clamp ``max(hybrid_tail_offset, max_offset + 1)`` (a per-tap table is
    collapsed to its largest radius); ``'hybrid_gather'`` = exact for unbounded
    offsets: a clamp-``max_offset`` pass, and up to ``hybrid_capacity`` of the
    pixels that hold a tap beyond it recomputed by gathers
    (``ops/dcn.py:modulated_deform_conv_hybrid``; a per-tap table collapsed to
    its largest radius; pixels past the capacity keep the clamped value). The
    names are the JAX package's option values; on the card all run the
    hand-written CUDA kernels of ``ops/dcn.py``. ``'hybrid'`` always takes the
    cascade (the JAX module does so on a TPU; off a TPU it stands in its gather
    hybrid for the Mosaic kernel). Under autograd on the card every impl but the
    two hybrids (inference only there) runs the DCN autograd Function (the
    forward kernel and ``csrc/dcn_bwd.cu``).

    After a forward with a bounded impl, ``dcn_overflow`` holds an int64 ``[2]``
    tensor on the device (the JAX module's ``dcn_overflow`` sow): for
    ``'pallas'`` ``[0, taps beyond the clamp]`` (counted by the kernel on the
    card), for ``'chain'`` ``[0, taps beyond the one radius it clamps at]`` (the
    JAX module counts at the per-tap radii of a table but clamps at their
    maximum; the port counts where it clamps, and with an integer
    ``max_offset``, as in every conf, the two agree), for ``'hybrid'``
    ``[out-of-band blocks that did not fit the capacity,
    taps beyond the tail radius]`` (the cascade's selection kernel); for
    ``'hybrid_gather'`` it is None, as the JAX module sows no counter there.
    Non-zero means this batch's output deviates from exact DCNv2. With
    ``audit_offsets`` the raw ``[B, H, W, G, K, 2]`` offsets of the last forward
    are kept in ``last_offsets`` (the JAX module's ``offsets`` sow).
    """

    IMPLS = ("xla", "pallas", "chain", "hybrid", "hybrid_gather")

    def __init__(self, in_channels, features, deformable_groups=4, kernel_size=3, impl="xla",
                 max_offset: Any = 2, hybrid_capacity=0.125, hybrid_tail_offset=8,
                 audit_offsets=False):
        super().__init__()
        if kernel_size != 3:
            raise ValueError("DCNv2Pack: only 3x3 is ported")
        self.G, self.K = deformable_groups, kernel_size * kernel_size
        self.configure(impl, max_offset, hybrid_capacity, hybrid_tail_offset)
        self.audit_offsets = audit_offsets
        self.last_offsets = None
        self.conv_offset = Conv(in_channels, self.G * 3 * self.K, 3, padding=1, zero_init=True)
        self.weight = nn.Parameter(torch.zeros(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dcn_overflow = None
        self.last_shapes = None

    def configure(self, impl, max_offset, hybrid_capacity=0.125, hybrid_tail_offset=8):
        """Set the dispatch knobs (no weight changes). The clamp table of
        ``'pallas'`` / ``'xla'`` (all inf) is built here, once, on the module's
        device; ``forward`` moves it along if the module has moved since."""
        if impl not in self.IMPLS:
            raise ValueError(f"dcn_impl {impl!r} is not one of {self.IMPLS}")
        self.impl, self.max_offset = impl, max_offset
        self.hybrid_capacity = float(hybrid_capacity)
        self.hybrid_tail_offset = int(hybrid_tail_offset)
        weight = self._parameters.get("weight")
        radii = {"pallas": max_offset, "chain": _largest(max_offset)}.get(impl)
        self.clamp_radii = dcn_ops.clamp_table(radii, self.G, self.K).to(
            "cpu" if weight is None else weight.device)

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
        self.last_offsets = offset if self.audit_offsets else None
        x_nhwc = x.permute(0, 2, 3, 1)
        weight = self.weight.permute(2, 3, 1, 0)
        self.last_shapes = {"x": list(x_nhwc.shape), "offset": list(offset.shape),
                            "mask": list(mask.shape), "dtype": str(x.dtype).split(".")[-1]}
        if self.impl == "hybrid":
            mo = _largest(self.max_offset)  # the cascade is uniform-radius
            out, self.dcn_overflow = dcn_ops.modulated_deform_conv_cascade(
                x_nhwc, offset, mask, weight, self.bias, max_offset=int(mo),
                tail_offset=max(self.hybrid_tail_offset, int(mo) + 1),
                capacity_frac=self.hybrid_capacity, return_overflow=True)
            return out.permute(0, 3, 1, 2)
        if self.impl == "hybrid_gather":
            self.dcn_overflow = None
            out = dcn_ops.modulated_deform_conv_hybrid(
                x_nhwc, offset, mask, weight, self.bias, max_offset=int(_largest(self.max_offset)),
                capacity_frac=self.hybrid_capacity)
            return out.permute(0, 3, 1, 2)
        if self.clamp_radii.device != x.device:
            self.clamp_radii = self.clamp_radii.to(x.device)
        out = dcn_ops.modulated_deform_conv(x_nhwc, offset, mask, weight, self.bias,
                                            max_offset=self.clamp_radii,
                                            return_overflow=self.impl != "xla")
        if self.impl != "xla":
            out, self.dcn_overflow = out
        else:
            self.dcn_overflow = None
        return out.permute(0, 3, 1, 2)


def _largest(max_offset):
    """A ``[G][K]`` table of radii -> its largest radius (an int stays as it is)."""
    if isinstance(max_offset, (tuple, list)):
        return max(max(row) for row in max_offset)
    return max_offset


class WarpBlock(nn.Module):
    """Align VQGAN features to the hidden state. ``warp_mode='dcn'``: the offset
    conv feeds a :class:`DCNv2Pack`. ``'flow'``: the offset conv feeds
    ``flow_head`` (C -> G*2, zero-initialised), whose ``tanh`` (float32) times
    ``flow_max_offset`` is one flow vector per group and pixel;
    ``ops/warp.py:flow_warp_align`` samples x_vq there and ``post_conv`` (C -> C
    3x3) follows. A flow warp has no DCN pack: ``dcn`` is None."""

    groups = 4            # deformable groups / flow groups, as in the JAX module

    def __init__(self, channels, warp_mode="dcn", dcn_impl="xla", dcn_max_offset: Any = 2,
                 dcn_hybrid_capacity=0.125, dcn_hybrid_tail_offset=8, dcn_audit_offsets=False,
                 flow_max_offset=2):
        super().__init__()
        if warp_mode not in ("dcn", "flow"):
            raise ValueError(f"warp_mode {warp_mode!r} is not 'dcn' or 'flow'")
        self.flow_max_offset = flow_max_offset
        self.offset = Conv(channels * 2, channels, 3, padding=1)
        if warp_mode == "flow":
            self.dcn = None
            self.flow_head = Conv(channels, self.groups * 2, 3, padding=1, zero_init=True)
            self.post_conv = Conv(channels, channels, 3, padding=1)
            return
        self.dcn = DCNv2Pack(channels, channels, deformable_groups=self.groups, impl=dcn_impl,
                             max_offset=dcn_max_offset, hybrid_capacity=dcn_hybrid_capacity,
                             hybrid_tail_offset=dcn_hybrid_tail_offset,
                             audit_offsets=dcn_audit_offsets)

    def flow(self, side):
        """-> float32 flow [B, H, W, G, 2] (dy, dx) in [-flow_max_offset, flow_max_offset]."""
        raw = self.flow_head(side)
        B, _, H, W = raw.shape
        return torch.tanh(raw.float()).permute(0, 2, 3, 1).reshape(B, H, W, self.groups, 2) \
            * self.flow_max_offset

    def forward(self, x_vq, x_residual):
        side = self.offset(torch.cat([x_vq, x_residual.to(x_vq.dtype)], dim=1))
        if self.dcn is not None:
            return self.dcn(x_vq, side)
        aligned = warp_ops.flow_warp_align(x_vq.permute(0, 2, 3, 1), self.flow(side),
                                           max_offset=self.flow_max_offset)
        return self.post_conv(aligned.permute(0, 3, 1, 2))


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

    The four ``dcn_*`` knobs accept a scalar (shared by both warps) or a
    2-sequence indexed by warp id (warp 0 = quarter-res level, warp 1 = half-res).
    The two means are over the whole batch (all axes), as in JAX and the reference;
    ``means_over_ranks`` (set by a data-parallel model) takes them over the whole
    batch of the ``torch.distributed`` group (``parallel.global_mean``).

    ``remat`` (the JAX module's ``nn.remat``): in a forward with grad enabled each
    ``ResnetBlock``, ``AttnBlock`` and ``WarpBlock`` runs under
    ``torch.utils.checkpoint`` (``use_reentrant=False``, the form DDP takes): its
    activations are not kept but recomputed in the backward. The two means stay
    outside the blocks. A forward without grad (inference) is unchanged.
    """

    means_over_ranks = False

    def __init__(self, ch=128, out_ch=3, ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (64,), dropout=0.0, resolution=256,
                 z_channels=3, warp_mode="dcn", dcn_impl: Any = "xla", dcn_max_offset: Any = 2,
                 dcn_hybrid_capacity: Any = 0.125, dcn_hybrid_tail_offset: Any = 8,
                 dcn_audit_offsets=False, remat=False):
        super().__init__()
        self.remat = bool(remat)
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
                warps[w] = WarpBlock(
                    block_in, warp_mode=warp_mode, dcn_impl=_per_warp(dcn_impl, w),
                    dcn_max_offset=_per_warp(dcn_max_offset, w),
                    dcn_hybrid_capacity=_per_warp(dcn_hybrid_capacity, w),
                    dcn_hybrid_tail_offset=_per_warp(dcn_hybrid_tail_offset, w),
                    dcn_audit_offsets=dcn_audit_offsets)
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

    def _run(self, block, *args):
        """``block(*args)``; with ``remat`` and grad enabled, recomputed in the backward."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, z, code_decoder_output, enc_feat):
        h = self.conv_in(z)
        for block in (self.mid.block_1, self.mid.attn_1, self.mid.block_2):
            h = self._run(block, h)
        for i_level in reversed(range(self.num_resolutions)):
            level = self.up[i_level]
            for i_block in range(self.num_res_blocks + 1):
                h = self._run(level.block[i_block], h)
                if len(level.attn) > 0:
                    h = self._run(level.attn[i_block], h)
            if i_level != 2:
                w = 1 - i_level
                x_code = code_decoder_output[w].to(h.dtype)
                h = self.mix[w](enc_feat[i_level].to(h.dtype), h)
                x_vq = self._run(self.warp[w], x_code, h)
                # the JAX module's jnp.mean: float32 sums, a result in h's dtype
                mean = global_mean if self.means_over_ranks else torch.mean
                ratio = mean(h.float()).to(h.dtype) / mean(x_vq.float()).to(h.dtype)
                h = h + x_vq * ratio
            if i_level != 0:
                h = level.upsample(h)
        return self.residual_conv(swish(self.norm_out(h)))

    def configure_dcn(self, dcn_impl, dcn_max_offset, dcn_hybrid_capacity=0.125,
                      dcn_hybrid_tail_offset=8):
        """Re-dispatch both packs in place (scalars or per-warp 2-sequences)."""
        for w, warp in enumerate(self.warp):
            if warp.dcn is not None:   # a flow warp has no knob to set (the JAX clone neither)
                warp.dcn.configure(_per_warp(dcn_impl, w), _per_warp(dcn_max_offset, w),
                                   _per_warp(dcn_hybrid_capacity, w),
                                   _per_warp(dcn_hybrid_tail_offset, w))

    def dcn_packs(self):
        """The DCNv2Packs of the warps, in warp order (none for flow warps)."""
        return [w.dcn for w in self.warp if w.dcn is not None]

    def dcn_overflow(self):
        """Per-pack ``dcn_overflow`` tensors of the last forward (None for exact impls
        and ``'hybrid_gather'``)."""
        return [p.dcn_overflow for p in self.dcn_packs()]

    def last_dcn_shapes(self):
        return {f"warp_{i}": w.dcn.last_shapes for i, w in enumerate(self.warp) if w.dcn is not None}
