"""Plain PyTorch reference of GLARE's stage-3 and stage-2 serving forward.

Written from the published architecture (LowLevelAI/GLARE, ``code/models``), in
float32 with no kernel, cache or batching trick: plain dense attention, the exact
DCNv2 (bilinear sampling by gathers, unbounded offsets), the dense codebook
argmin (ties to the lowest index), the reverse flow with each 3x3 channel mixer
inverted in float64. It imports nothing of the program. Parameter names are the
reference checkpoint's, so one ``state_dict`` loads here and into the program.

Every product (convolution, matrix product, the DCN's column product) goes
through :class:`Precision`, which rounds its two operands first:

  * ``fp32``  -- no rounding; TF32 is switched off on the card while it runs.
  * ``tf32``  -- operands rounded to TF32 (10 mantissa bits), sums in float32:
    what the tensor cores do with TF32 on.
  * ``bf16``  -- operands rounded to bf16, sums in float32, and the activations
    kept in bf16 (:meth:`Precision.store`: products' results, norm outputs,
    residual sums, the AFT's blends).
  * ``fp8``   -- operands and result scaled per tensor to the e4m3 range and
    rounded to ``float8_e4m3fn``, sums in float32: an fp8 product whose result is
    kept in fp8; and those activations kept in fp8.

A precision is one mode for the whole network, or a mode per sub-network
(``RRDB``, ``flow``, ``vqgan``, ``deformable_decoder``; one not named is
``fp32``): a bf16 configuration's program keeps its flow in float32, so its fp8
control lowers the other three, and another control lowers the flow alone.

Memory: attention is taken over blocks of query rows, the DCN over blocks of
image rows and the codebook argmin over blocks of tokens, so a full-size image
fits beside nothing else.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
ATTN_Q_BLOCK = 2048
DCN_BLOCK_VALUES = 1 << 26
VQ_BLOCK = 8192


class Precision:
    """The rounding of every product's operands (see the module docstring)."""

    MODES = ("fp32", "tf32", "bf16", "fp8")

    def __init__(self, modes="fp32"):
        self.modes = modes if isinstance(modes, dict) else {}
        self.mode = modes if isinstance(modes, str) else "fp32"
        bad = {self.mode, *self.modes.values()} - set(self.MODES)
        if bad:
            raise ValueError(f"precision {sorted(bad)} is not one of {self.MODES}")

    @contextlib.contextmanager
    def part(self, name):
        """The products inside belong to sub-network ``name``."""
        saved = self.mode
        self.mode = self.modes.get(name, saved if not self.modes else "fp32")
        try:
            yield
        finally:
            self.mode = saved

    def round(self, t):
        if self.mode == "fp32":
            return t
        if self.mode == "tf32":
            bits = t.float().contiguous().view(torch.int32)
            bits = (bits + 0x1000) & ~0x1FFF          # nearest, ties away, at 10 mantissa bits
            return bits.view(torch.float32)
        if self.mode == "bf16":
            return t.to(torch.bfloat16).float()
        amax = t.abs().amax().float().clamp(min=1e-30)
        scale = amax / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    def store(self, t):
        """An activation as the reduced mode keeps it (TF32 is a mode of the
        products, not of storage)."""
        return self.round(t) if self.mode in ("bf16", "fp8") else t

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.store(F.conv2d(self.round(x), self.round(w), b, stride=stride, padding=padding))

    def mm(self, a, b):
        return self.store(self.round(a) @ self.round(b))


def swish(x):
    return x * torch.sigmoid(x)


# ------------------------------------------------------------- building blocks --

class Conv(nn.Module):
    init = "fan_in_uniform"

    def __init__(self, cin, cout, k=3, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x, prec):
        return prec.conv(x, self.weight, self.bias, self.stride, self.padding)


class GroupNorm32(nn.Module):
    init = "norm"

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x, prec):
        return prec.store(F.group_norm(x, 32, self.weight, self.bias, 1e-6))


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm32(cin), Conv(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = GroupNorm32(cout), Conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = Conv(cin, cout, 1)

    def forward(self, x, prec):
        h = self.conv1(swish(self.norm1(x, prec)), prec)
        h = self.conv2(swish(self.norm2(h, prec)), prec)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x, prec)
        return prec.store(x + h)


class AttnBlock(nn.Module):
    """Single-head self-attention over all pixels: softmax(q k^T / sqrt(C)) v."""

    def __init__(self, c):
        super().__init__()
        self.norm = GroupNorm32(c)
        self.q, self.k, self.v, self.proj_out = (Conv(c, c, 1) for _ in range(4))

    def forward(self, x, prec):
        b, c, h, w = x.shape
        hn = self.norm(x, prec)
        q, k, v = (m(hn, prec).reshape(b, c, h * w).transpose(1, 2) for m in (self.q, self.k, self.v))
        kt = k.transpose(1, 2)
        out = torch.empty_like(q)
        for i in range(0, h * w, ATTN_Q_BLOCK):
            s = prec.mm(q[:, i:i + ATTN_Q_BLOCK], kt) * c ** -0.5
            out[:, i:i + ATTN_Q_BLOCK] = prec.mm(torch.softmax(s, dim=-1), v)
        return prec.store(x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w), prec))


class Upsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3, padding=1)

    def forward(self, x, prec):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), prec)


class Downsample(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2)

    def forward(self, x, prec):
        return self.conv(F.pad(x, (0, 1, 0, 1)), prec)


def _levels(ch, ch_mult, n_blocks, attn_at, encoder):
    """The ldm level lists: (level modules, channels after the last level)."""
    levels, res = [], 256 if encoder else 256 // 2 ** (len(ch_mult) - 1)
    block_in = ch if encoder else ch * ch_mult[-1]
    order = range(len(ch_mult)) if encoder else reversed(range(len(ch_mult)))
    out = [None] * len(ch_mult)
    for i in order:
        lv = nn.Module()
        lv.block, lv.attn = nn.ModuleList(), nn.ModuleList()
        for _ in range(n_blocks if encoder else n_blocks + 1):
            lv.block.append(ResnetBlock(block_in, ch * ch_mult[i]))
            block_in = ch * ch_mult[i]
            if res in attn_at:
                lv.attn.append(AttnBlock(block_in))
        if encoder and i != len(ch_mult) - 1:
            lv.downsample, res = Downsample(block_in), res // 2
        if not encoder and i != 0:
            lv.upsample, res = Upsample(block_in), res * 2
        out[i] = lv
    levels.extend(out)
    return nn.ModuleList(levels), block_in


def _mid(c):
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = ResnetBlock(c, c), AttnBlock(c), ResnetBlock(c, c)
    return mid


def _run_mid(mid, h, prec):
    return mid.block_2(mid.attn_1(mid.block_1(h, prec), prec), prec)


def _run_level(lv, h, prec):
    for j, blk in enumerate(lv.block):
        h = blk(h, prec)
        if len(lv.attn):
            h = lv.attn[j](h, prec)
    return h


class Encoder(nn.Module):
    def __init__(self, ch, ch_mult, n_blocks, attn_at, zc=3):
        super().__init__()
        self.conv_in = Conv(3, ch, 3, padding=1)
        self.down, c = _levels(ch, ch_mult, n_blocks, attn_at, encoder=True)
        self.mid = _mid(c)
        self.norm_out, self.conv_out = GroupNorm32(c), Conv(c, zc, 3, padding=1)

    def forward(self, x, prec):
        skips, h = [], self.conv_in(x, prec)
        for i, lv in enumerate(self.down):
            h = _run_level(lv, h, prec)
            if hasattr(lv, "downsample"):
                skips.append(h)
                h = lv.downsample(h, prec)
        h = _run_mid(self.mid, h, prec)
        return self.conv_out(swish(self.norm_out(h, prec)), prec), skips


class Decoder(nn.Module):
    """The VQGAN decoder; also returns the hidden states of the two upper levels
    (after their blocks, before upsampling), which the AFT decoder warps."""

    def __init__(self, ch, ch_mult, n_blocks, attn_at, zc=3):
        super().__init__()
        self.conv_in = Conv(zc, ch * ch_mult[-1], 3, padding=1)
        self.mid = _mid(ch * ch_mult[-1])
        self.up, c = _levels(ch, ch_mult, n_blocks, attn_at, encoder=False)
        self.norm_out, self.conv_out = GroupNorm32(c), Conv(c, 3, 3, padding=1)

    def forward(self, z, prec, image=True):
        feats, h = [], _run_mid(self.mid, self.conv_in(z, prec), prec)
        for i in reversed(range(len(self.up))):
            h = _run_level(self.up[i], h, prec)
            if i != len(self.up) - 1:
                feats.append(h)
            if i != 0:
                h = self.up[i].upsample(h, prec)
        return (self.conv_out(swish(self.norm_out(h, prec)), prec) if image else None), feats


class VectorQuantizer(nn.Module):
    def __init__(self, n_e, e_dim):
        super().__init__()
        self.embedding = nn.Embedding(n_e, e_dim)
        self.embedding.weight.init = "codebook"

    def forward(self, z, prec):
        """Nearest code by |e|^2 - 2 z.e (|z|^2 does not move the argmin)."""
        b, c, h, w = z.shape
        zf = z.permute(0, 2, 3, 1).reshape(-1, c)
        e = self.embedding.weight
        e2 = (e * e).sum(dim=1)
        idx = torch.cat([torch.argmin(e2[None, :] - 2.0 * prec.mm(zf[i:i + VQ_BLOCK], e.t()), dim=1)
                         for i in range(0, zf.shape[0], VQ_BLOCK)])
        zq = e[idx].reshape(b, h, w, c).permute(0, 3, 1, 2)
        return z + (zq - z)


class VQModel(nn.Module):
    def __init__(self, ch, ch_mult, n_blocks, attn_at, n_embed, embed_dim):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, n_blocks, attn_at)
        self.decoder = Decoder(ch, ch_mult, n_blocks, attn_at)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv, self.post_quant_conv = Conv(3, embed_dim, 1), Conv(embed_dim, 3, 1)

    def decode(self, h, prec, image=True):
        return self.decoder(self.post_quant_conv(self.quantize(h, prec), prec), prec, image)


class ConEncoder1(nn.Module):
    def __init__(self, ch, n_blocks):
        super().__init__()
        self.encoder = Encoder(ch, (1, 2, 4), n_blocks, (64,))
        self.cond_conv = nn.Sequential(Conv(3, 64, 3, padding=1))
        self.color_conv = Conv(3, 3, 3, padding=1)

    def forward(self, x, prec):
        feat, skips = self.encoder(x, prec)
        return prec.store(torch.sigmoid(self.cond_conv[0](feat, prec))), self.color_conv(feat, prec), skips


# ------------------------------------------------------------------- the flow --

class ActNorm(nn.Module):
    init = "actnorm"

    def __init__(self, c):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(1, c, 1, 1))
        self.logs = nn.Parameter(torch.empty(1, c, 1, 1))

    def forward(self, x):
        return (x + self.bias) * torch.exp(self.logs)

    def reverse(self, x):
        return x * torch.exp(-self.logs) - self.bias


class InvConv(nn.Module):
    init = "orthogonal"

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, c))

    def reverse(self, x, prec):
        w_inv = torch.linalg.inv(self.weight.double()).float()
        return prec.conv(x, w_inv[:, :, None, None])


class ConvNormed(nn.Module):
    init = "normal_0.05"

    def __init__(self, cin, cout, k):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.actnorm = ActNorm(cout)

    def forward(self, x, prec):
        return self.actnorm(prec.conv(x, self.weight, padding=self.weight.shape[-1] // 2))


class ConvZeros(nn.Module):
    init = "zeros_conv"

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.logs = nn.Parameter(torch.empty(cout, 1, 1))

    def forward(self, x, prec):
        return prec.conv(x, self.weight, self.bias, padding=1) * torch.exp(self.logs * 3.0)


class FNet(nn.Sequential):
    def __init__(self, cin, cout, hidden=64):
        super().__init__(ConvNormed(cin, hidden, 3), nn.ReLU(), ConvNormed(hidden, hidden, 1), nn.ReLU(),
                         ConvZeros(hidden, cout))

    def forward(self, x, prec):
        for m in self:
            x = m(x) if isinstance(m, nn.ReLU) else m(x, prec)
        return x


class Coupling(nn.Module):
    """CondAffineSeparatedAndCond, reversed: the self-conditioned half, then the
    feature-conditioned affine on all channels; scale = sigmoid(raw + 2) + 1e-4,
    shift and scale from the even and odd channels."""

    def __init__(self, c=3, cond=64, hidden=64):
        super().__init__()
        self.n_nn = c // 2
        self.fAffine = FNet(self.n_nn + cond, (c - self.n_nn) * 2, hidden)
        self.fFeatures = FNet(cond, c * 2, hidden)

    @staticmethod
    def _scale_shift(h):
        return torch.sigmoid(h[:, 1::2] + 2.0) + 1e-4, h[:, 0::2]

    def reverse(self, z, ft, prec):
        z1, z2 = z[:, :self.n_nn], z[:, self.n_nn:]
        scale, shift = self._scale_shift(self.fAffine(torch.cat([z1, ft], dim=1), prec))
        z = torch.cat([z1, z2 / scale - shift], dim=1)
        scale, shift = self._scale_shift(self.fFeatures(ft, prec))
        return z / scale - shift


class FlowStep(nn.Module):
    def __init__(self, c, coupling):
        super().__init__()
        self.actnorm, self.invconv = ActNorm(c), InvConv(c)
        self.affine = Coupling(c) if coupling else None

    def reverse(self, z, ft, prec):
        if self.affine is not None:
            z = self.affine.reverse(z, ft, prec)
        return self.actnorm.reverse(self.invconv.reverse(z, prec))


class FlowUpsamplerNet(nn.Module):
    def __init__(self, K, L, no_affine):
        super().__init__()
        self.layers = nn.ModuleList(FlowStep(3, coupling=j >= no_affine)
                                    for _ in range(L) for j in range(no_affine + K))

    def decode(self, z, ft, prec):
        for step in reversed(self.layers):
            z = step.reverse(z, ft, prec)
        return z


# ----------------------------------------------------------------- the AFT decoder --

def deform_conv(x, offset, mask, weight, bias, prec):
    """Exact modulated deformable convolution (DCNv2), 3x3, stride 1, pad 1.

    x [B, C, H, W]; offset [B, G*9*2, H, W] packed (dy, dx) per (group, tap);
    mask [B, G*9, H, W] (after the sigmoid); weight [O, C, 3, 3]. A sample
    (py, px) outside (-1, H) x (-1, W) is 0; inside, each of its four corners
    counts where it lies in the image, weighted bilinearly."""
    B, C, H, W = x.shape
    G = mask.shape[1] // 9
    Cg, O = C // G, weight.shape[0]
    dev = x.device
    xg = x.permute(0, 2, 3, 1).reshape(B, H * W, G, Cg).permute(0, 2, 1, 3)     # [B, G, HW, Cg]
    off = offset.reshape(B, G, 9, 2, H, W).permute(0, 4, 5, 1, 2, 3)            # [B, H, W, G, 9, 2]
    msk = mask.reshape(B, G, 9, H, W).permute(0, 3, 4, 1, 2)                    # [B, H, W, G, 9]
    w2 = weight.permute(2, 3, 1, 0).reshape(9 * C, O)                           # row k*C + c
    ky = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], dtype=torch.float32, device=dev)
    kx = torch.tensor([-1, 0, 1, -1, 0, 1, -1, 0, 1], dtype=torch.float32, device=dev)
    rows = max(1, DCN_BLOCK_VALUES // (B * W * 9 * C))
    out = []
    for h0 in range(0, H, rows):
        h1 = min(H, h0 + rows)
        R = h1 - h0
        hh = torch.arange(h0, h1, dtype=torch.float32, device=dev).view(1, R, 1, 1, 1)
        ww = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W, 1, 1)
        py = hh + ky + off[:, h0:h1, ..., 0]
        px = ww + kx + off[:, h0:h1, ..., 1]
        inside = (py > -1) & (py < H) & (px > -1) & (px < W)
        y0, x0 = torch.floor(py), torch.floor(px)
        ly, lx = py - y0, px - x0
        col = 0
        for dy, dx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                           (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yi, xi = y0 + dy, x0 + dx
            ok = inside & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()          # [B, R, W, G, 9]
            lin = lin.permute(0, 3, 1, 2, 4).reshape(B, G, R * W * 9, 1)
            vals = torch.gather(xg, 2, lin.expand(B, G, R * W * 9, Cg))
            wv = (wt * ok * msk[:, h0:h1]).permute(0, 3, 1, 2, 4).reshape(B, G, R * W * 9, 1)
            col = col + vals * wv
        col = col.reshape(B, G, R * W, 9, Cg).permute(0, 2, 3, 1, 4).reshape(B * R * W, 9 * C)
        out.append((prec.mm(col, w2) + bias).reshape(B, R, W, O))
    return torch.cat(out, dim=1).permute(0, 3, 1, 2)


class DCNv2Pack(nn.Module):
    init = "dcn"

    def __init__(self, c):
        super().__init__()
        self.conv_offset = Conv(c, 4 * 27, 3, padding=1)
        self.conv_offset.init = "offset_head"
        self.weight = nn.Parameter(torch.empty(c, c, 3, 3))
        self.bias = nn.Parameter(torch.empty(c))

    def raw_offsets(self, side, prec):
        """[B, 4*27, H, W]: channels (dy, dx) of every (group, tap) first, then the masks."""
        return self.conv_offset(side, prec)

    def forward(self, x, side, prec):
        o1, o2, m = torch.chunk(self.raw_offsets(side, prec), 3, dim=1)
        return deform_conv(x, torch.cat([o1, o2], dim=1), torch.sigmoid(m), self.weight, self.bias, prec)


class WarpBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.offset = Conv(2 * c, c, 3, padding=1)
        self.dcn = DCNv2Pack(c)

    def side(self, x_vq, h, prec):
        return self.offset(torch.cat([x_vq, h], dim=1), prec)

    def forward(self, x_vq, h, prec):
        return self.dcn(x_vq, self.side(x_vq, h, prec), prec)


class Mix(nn.Module):
    init = "mix"

    def __init__(self, m):
        super().__init__()
        self.init_value = float(m)
        self.w = nn.Parameter(torch.full((1,), float(m)))

    def forward(self, fea1, fea2, prec):
        s = torch.sigmoid(self.w)[0]
        return prec.store(fea1 * s + fea2 * (1 - s))


class MultiScaleDecoder2(nn.Module):
    """VQGAN-shaped trunk from the flow latent; at the two upper levels the
    encoder's skip is mixed in, the VQGAN decoder's features are warped onto the
    hidden state and added, scaled by mean(h) / mean(x_vq) over the whole batch."""

    def __init__(self, ch, n_blocks):
        super().__init__()
        ch_mult = (1, 2, 4)
        self.conv_in = Conv(3, ch * 4, 3, padding=1)
        self.mid = _mid(ch * 4)
        self.up, c = _levels(ch, ch_mult, n_blocks, (64,), encoder=False)
        self.warp = nn.ModuleList([WarpBlock(ch * 2), WarpBlock(ch)])
        self.mix = nn.ModuleList([Mix(-1.0), Mix(-0.6)])
        self.norm_out, self.residual_conv = GroupNorm32(c), Conv(c, 3, 3, padding=1)
        self.residual_conv.init = "output_head"

    def forward(self, z, code_feats, skips, prec, offsets_hook=None):
        h = _run_mid(self.mid, self.conv_in(z, prec), prec)
        for i in reversed(range(len(self.up))):
            h = _run_level(self.up[i], h, prec)
            if i != len(self.up) - 1:
                w = 1 - i
                h = self.mix[w](skips[i], h, prec)
                if offsets_hook is not None:
                    offsets_hook(w, self.warp[w], code_feats[w], h)
                x_vq = self.warp[w](code_feats[w], h, prec)
                h = prec.store(h + x_vq * (h.mean() / x_vq.mean()))
            if i != 0:
                h = self.up[i].upsample(h, prec)
        return self.residual_conv(swish(self.norm_out(h, prec)), prec)


# ------------------------------------------------------------------ the models --

def _vqgan(cfg):
    v = cfg["network_VQGAN"]
    return VQModel(v["ch"], tuple(v["ch_mult"]), v["num_res_blocks"], tuple(v["attn_resolutions"]),
                   v["n_embed"], v["embed_dim"])


def _flow(cfg):
    f = cfg["network_G"]["flow"]
    return FlowUpsamplerNet(f["K"], f["L"], f["additionalFlowNoAffine"])


class Stage3Generator(nn.Module):
    """VQLLFLOWDeformable: conditional encoder ``RRDB``, the frozen flow, the AFT
    decoder."""

    def __init__(self, cfg):
        super().__init__()
        g = cfg["network_G"]
        self.RRDB = ConEncoder1(g.get("enc_ch", 128), g.get("enc_num_res_blocks", 2))
        self.flowUpsamplerNet = _flow(cfg)
        self.deformable_decoder = MultiScaleDecoder2(g.get("decoder_ch", 128), g.get("dec_num_res_blocks", 2))


class Stage2Generator(nn.Module):
    """LLFlowVQGAN2: conditional encoder ``RRDB`` and the flow."""

    def __init__(self, cfg):
        super().__init__()
        g = cfg["network_G"]
        self.RRDB = ConEncoder1(g.get("enc_ch", 128), g.get("enc_num_res_blocks", 2))
        self.flowUpsamplerNet = _flow(cfg)


class Reference(nn.Module):
    """The whole served network: ``netG`` (the stage's generator) and ``net_hq``
    (the VQGAN). ``forward(x)`` takes the log-domain input ``[B, 3, H, W]`` and
    returns the served image ``[B, 3, H, W]``."""

    def __init__(self, cfg):
        super().__init__()
        self.stage = 3 if cfg["network_G"]["which_model_G"] == "VQLLFLOWDeformable" else 2
        self.netG = (Stage3Generator if self.stage == 3 else Stage2Generator)(cfg)
        self.net_hq = _vqgan(cfg)

    def latent(self, x, prec):
        with prec.part("RRDB"):
            cond, color, skips = self.netG.RRDB(x, prec)
        with prec.part("flow"):
            return self.netG.flowUpsamplerNet.decode(color, cond, prec), skips

    def forward(self, x, prec, offsets_hook=None):
        z, skips = self.latent(x, prec)
        with prec.part("vqgan"):
            img, feats = self.net_hq.decode(z, prec, image=self.stage == 2)
        if self.stage == 2:
            return img
        with prec.part("deformable_decoder"):
            return self.netG.deformable_decoder(z, feats, skips, prec, offsets_hook)


def run(model, x, precision="fp32", offsets_hook=None):
    """``model(x)`` under ``precision`` (a mode, or {sub-network: mode}), without
    a graph, TF32 off on the card;
    ``offsets_hook(w, warp, x_vq, h)`` is called before each warp."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return model(x, Precision(precision or "fp32"), offsets_hook)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def init_kinds(model):
    """{parameter name: its init kind}: a module's ``init`` names the kind of its
    parameters, a parameter's own ``init`` overrides it."""
    kinds = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            kind = getattr(p, "init", None) or getattr(mod, "init", None)
            if kind is None:
                raise ValueError(f"no init kind for {mname}.{pname}")
            kinds[f"{mname}.{pname}" if mname else pname] = kind
    return kinds


def fan_in(shape):
    return math.prod(shape[1:]) if len(shape) > 1 else 1
