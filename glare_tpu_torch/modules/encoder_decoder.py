"""ldm-style VQGAN Encoder/Decoder (counterpart of
``glare_tpu/modules/encoder_decoder.py``), with the reference PyTorch
``state_dict`` names: ``down.{i}.block.{j}``, ``down.{i}.attn.{j}``,
``down.{i}.downsample``, ``mid.block_1`` / ``mid.attn_1`` / ``mid.block_2``,
``up.{i}.block.{j}``, ``up.{i}.attn.{j}``, ``up.{i}.upsample``.

GLARE-specific behaviours kept:
  * Encoder optionally returns ``enc_feat``: the pre-downsample skip features
    per level, which the AFT decoder's Mix blocks use as ``mid_feat``.
  * Decoder returns ``code_decoder_output``: hidden states at levels != 2 after
    their res blocks, before upsampling, which the AFT decoder's WarpBlocks use.
  * Attention is applied at levels whose *config-derived* resolution is in
    ``attn_resolutions`` (bookkeeping follows ``resolution``, not the input).
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ..nn.layers import AttnBlock, Conv, Downsample, GroupNorm32, ResnetBlock, Upsample, swish


class Encoder(nn.Module):
    def __init__(self, ch=128, out_ch=3, ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (64,), dropout=0.0, resamp_with_conv=True,
                 in_channels=3, resolution=256, z_channels=3, double_z=False):
        super().__init__()
        self.num_resolutions = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        curr_res = resolution
        self.conv_in = Conv(in_channels, ch, 3, padding=1)
        block_in = ch
        self.down = nn.ModuleList()
        for i_level in range(self.num_resolutions):
            block_out = ch * ch_mult[i_level]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != self.num_resolutions - 1:
                level.downsample = Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, dropout=dropout)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, dropout=dropout)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = Conv(block_in, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x, mid_feat: bool = False):
        enc_feat = []
        h = self.conv_in(x)
        for i_level, level in enumerate(self.down):
            for i_block in range(self.num_res_blocks):
                h = level.block[i_block](h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if i_level != self.num_resolutions - 1:
                enc_feat.append(h)
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = self.conv_out(swish(self.norm_out(h)))
        return (h, enc_feat) if mid_feat else h


class Decoder(nn.Module):
    def __init__(self, ch=128, out_ch=3, ch_mult: Sequence[int] = (1, 2, 4), num_res_blocks=2,
                 attn_resolutions: Sequence[int] = (64,), dropout=0.0, resamp_with_conv=True,
                 in_channels=3, resolution=256, z_channels=3, give_pre_end=False):
        super().__init__()
        self.num_resolutions = len(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.give_pre_end = give_pre_end
        block_in = ch * ch_mult[self.num_resolutions - 1]
        curr_res = resolution // 2 ** (self.num_resolutions - 1)
        self.conv_in = Conv(z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, dropout=dropout)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, dropout=dropout)
        levels = [None] * self.num_resolutions
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
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = Conv(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        code_decoder_output = []
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i_level in reversed(range(self.num_resolutions)):
            level = self.up[i_level]
            for i_block in range(self.num_res_blocks + 1):
                h = level.block[i_block](h)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if i_level != 2:
                code_decoder_output.append(h)
            if i_level != 0:
                h = level.upsample(h)
        if self.give_pre_end:
            return h, code_decoder_output
        h = self.conv_out(swish(self.norm_out(h)))
        return h, code_decoder_output
