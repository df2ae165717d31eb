"""Legacy architecture modules of the reference that the shipped confs do not use
(counterpart of ``glare_tpu/modules/legacy_archs.py``). NCHW.

  * ``RRDBNet_arch.py``: :class:`ResidualDenseBlock5C`, :class:`RRDB`,
    :class:`RRDBNet` (the ESRGAN trunk with GLARE's stride-2 stem; ``get_steps``
    returns the ``fea_up*`` pyramid, ``block_idxs`` the chosen trunk outputs).
  * ``color_encoder.py``: :class:`ColorEncoder` (a U-Net reflectance head, then
    a same-size average blur).
  * ``base_layers.py``: :class:`Conv2D`, :class:`ConvTranspose2D`,
    :class:`ConvBNRelu`, :class:`DoubleConv`, :class:`ChannelAttention`,
    :class:`SpatialAttention`, :class:`CBAM`, :class:`ResConv`, :class:`MSIA`,
    :func:`pad_concat`.
  * ``loss.py``: :func:`charbonnier_sum_loss`, :class:`LegacyGANLoss`,
    :func:`gradient_penalty_loss` (``torch.autograd.grad`` with ``create_graph``).

Two reference quirks are kept, as in the JAX module, because they are part of the
trained network's function: ``CBAM`` returns the channel-attended tensor and
discards the spatial-attention product, and ``ResConv`` applies ``bn1`` twice
(its ``bn2`` exists and is never used).

BatchNorm (:class:`FlaxBatchNorm2d`) follows flax's ``nn.BatchNorm``: in
``.eval()`` (JAX's ``use_running_average=True``, the JAX modules' default) it
normalizes with the running statistics; in ``.train()`` with the batch's mean
and biased variance (E[x^2] - E[x]^2), and updates
``running = momentum * running + (1 - momentum) * batch`` with the biased
variance, where ``momentum`` is flax's (0.99 in ``ConvBNRelu``, 0.8 in
``ResConv``). torch's own rule would update with the unbiased variance. JAX's
``MSIA`` cannot put its BatchNorms in training; the port's follows ``.train()``.

Names follow the reference ``state_dict`` where the repository's tests show it
(``RRDB_trunk.{i}.RDB{k}.conv{n}``, ``conv_relu.0``, ``deconv_relu.0``,
``conv_bn_relu.{0,1}``, ``sharedMLP.{0,2}``, ``conv_bn_relu_{1,2,4}``,
``deconv_{2,4_1,4_2}``), else the JAX module's (``DoubleConv.c1`` / ``c2``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv, ScaledKaimingConv


def _act(activation, slope):
    return nn.ReLU() if activation == "relu" else nn.LeakyReLU(slope)


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with a seeded init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def seeded_reset(self, generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[2] * self.weight.shape[3])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5) with flax's statistics: see the module docstring.
    ``momentum`` is flax's: the weight of the running value."""

    def __init__(self, num_features, momentum=0.99):
        super().__init__(num_features, eps=1e-5, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.detach() * (1 - m))
            self.running_var.mul_(m).add_(var.detach() * (1 - m))
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(x.dtype)


# -------------------------------------------------------------------- RRDBNet


class ResidualDenseBlock5C(nn.Module):
    """Five 3x3 convolutions on a growing concatenation, a 0.2-scaled residual;
    each convolution drawn by the 0.1-scaled Kaiming rule, bias 0."""

    def __init__(self, nf=64, gc=32):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv{i}", ScaledKaimingConv(nf + (i - 1) * gc, gc))
        self.conv5 = ScaledKaimingConv(nf + 4 * gc, nf)

    def forward(self, x):
        x1 = F.leaky_relu(self.conv1(x), 0.2)
        x2 = F.leaky_relu(self.conv2(torch.cat((x, x1), 1)), 0.2)
        x3 = F.leaky_relu(self.conv3(torch.cat((x, x1, x2), 1)), 0.2)
        x4 = F.leaky_relu(self.conv4(torch.cat((x, x1, x2, x3), 1)), 0.2)
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """Residual in residual dense block."""

    def __init__(self, nf, gc=32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc)
        self.RDB2 = ResidualDenseBlock5C(nf, gc)
        self.RDB3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """The ESRGAN RRDB trunk with GLARE's stride-2 stem and feature pyramid.
    ``forward(x, get_steps=True)`` returns the ``fea_up*`` dict the flow network
    reads (post-activation values: the reference's in-place LeakyReLU mutates
    them after capture, and the JAX module replicates that); ``block_idxs``
    picks trunk outputs (``block_{i}``), ``fea_up0`` adds the half-size level."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=23, gc=32, scale=4, block_idxs: Sequence[int] = (),
                 fea_up0=False):
        super().__init__()
        self.scale, self.block_idxs, self.fea_up0 = scale, tuple(block_idxs), fea_up0
        self.conv_first = Conv(in_nc, nf, 3, stride=2, padding=1)
        self.RRDB_trunk = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = Conv(nf, nf, 3, stride=2, padding=1)
        self.upconv1 = Conv(nf, nf, 3, padding=1)
        self.upconv2 = Conv(nf, nf, 3, padding=1)
        for i, s in ((3, 8), (4, 16), (5, 32)):
            if scale >= s:
                setattr(self, f"upconv{i}", Conv(nf, nf, 3, padding=1))
        self.HRconv = Conv(nf, nf, 3, padding=1)
        self.conv_last = Conv(nf, out_nc, 3, padding=1)

    def forward(self, x, get_steps=False):
        fea = self.conv_first(x)
        block_results = {}
        for idx, blk in enumerate(self.RRDB_trunk):
            fea = blk(fea)
            if idx in self.block_idxs:
                block_results[f"block_{idx}"] = fea
        trunk = self.trunk_conv(fea)
        last_lr_fea = F.max_pool2d(fea, 2, 2) + trunk

        def lrelu(t):
            return F.leaky_relu(t, 0.2)

        fea_up2 = lrelu(self.upconv1(F.interpolate(last_lr_fea, scale_factor=2, mode="nearest")))
        fea = fea_up4 = lrelu(self.upconv2(F.interpolate(fea_up2, scale_factor=2, mode="nearest")))
        ups = {}
        for i, s in ((3, 8), (4, 16), (5, 32)):
            if self.scale >= s:
                fea = lrelu(getattr(self, f"upconv{i}")(fea))
            ups[f"fea_up{s}"] = fea if self.scale >= s else None
        out = self.conv_last(lrelu(self.HRconv(fea)))
        if not get_steps:
            return out

        def down_bilinear(z, factor):  # F.interpolate does not antialias on a downscale
            return F.interpolate(z, size=(z.shape[2] // factor, z.shape[3] // factor), mode="bilinear",
                                 align_corners=False)

        results = {"last_lr_fea": last_lr_fea, "fea_up1": last_lr_fea, "fea_up2": fea_up2,
                   "fea_up4": fea_up4, **ups, "out": out}
        if self.fea_up0:
            results["fea_up0"] = down_bilinear(last_lr_fea, 2)
        results["fea_up-1"] = down_bilinear(last_lr_fea, 4)
        results.update(block_results)
        return results


# ---------------------------------------------------------------- base_layers


class Conv2D(nn.Module):
    """3x3 conv + LeakyReLU(0.01) (torch's default slope) or ReLU."""

    def __init__(self, in_channels, out_channels, activation="lrelu", stride=1):
        super().__init__()
        self.conv_relu = nn.Sequential(Conv(in_channels, out_channels, 3, stride=stride, padding=1),
                                       _act(activation, 0.01))

    def forward(self, x):
        return self.conv_relu(x)


class ConvTranspose2D(nn.Module):
    """2x2 stride-2 transposed conv + activation."""

    def __init__(self, in_channels, out_channels, activation="lrelu"):
        super().__init__()
        self.deconv_relu = nn.Sequential(ConvTranspose(in_channels, out_channels, 2, stride=2),
                                         _act(activation, 0.01))

    def forward(self, x):
        return self.deconv_relu(x)


class ConvBNRelu(nn.Module):
    """conv -> BatchNorm (flax momentum 0.99) -> activation."""

    def __init__(self, in_channels, out_channels, activation="lrelu", kernel=3):
        super().__init__()
        self.conv_bn_relu = nn.Sequential(Conv(in_channels, out_channels, kernel, padding=kernel // 2),
                                          FlaxBatchNorm2d(out_channels, momentum=0.99),
                                          _act(activation, 0.01))

    def forward(self, x):
        return self.conv_bn_relu(x)


class DoubleConv(nn.Module):
    """Two :class:`Conv2D` blocks."""

    def __init__(self, in_channels, out_channels, activation="lrelu"):
        super().__init__()
        self.c1 = Conv2D(in_channels, out_channels, activation)
        self.c2 = Conv2D(out_channels, out_channels, activation)

    def forward(self, x):
        return self.c2(self.c1(x))


class ChannelAttention(nn.Module):
    """Global average- and max-pooled shared MLP (two bias-free 1x1 convs) -> sigmoid."""

    def __init__(self, in_planes, ratio=16):
        super().__init__()
        self.sharedMLP = nn.Sequential(Conv(in_planes, in_planes // ratio, 1, bias=False), nn.ReLU(),
                                       Conv(in_planes // ratio, in_planes, 1, bias=False))

    def forward(self, x):
        avg = self.sharedMLP(x.mean(dim=(2, 3), keepdim=True))
        mx = self.sharedMLP(x.amax(dim=(2, 3), keepdim=True))
        return torch.sigmoid(avg + mx)


class SpatialAttention(nn.Module):
    """Channel mean and max concatenated -> a bias-free conv (padding 1) -> sigmoid."""

    def __init__(self, kernel_size=3):
        super().__init__()
        self.conv = Conv(2, 1, kernel_size, padding=1, bias=False)

    def forward(self, x):
        y = torch.cat((x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)), 1)
        return torch.sigmoid(self.conv(y))


class CBAM(nn.Module):
    """Channel then spatial attention; returns the channel-attended tensor and
    discards the spatial product (the reference quirk, kept)."""

    def __init__(self, n_channels):
        super().__init__()
        self.ca = ChannelAttention(n_channels)
        self.sa = SpatialAttention()

    def forward(self, x):
        x = self.ca(x) * x
        _ = self.sa(x) * x
        return x


class ResConv(nn.Module):
    """conv1 -> bn1 -> act -> CBAM -> conv2 -> bn1 again (the reference quirk,
    kept: ``bn2`` is never used) + the input. act: ReLU or LeakyReLU(0.2), as JAX."""

    def __init__(self, in_channels, out_channels, activation="lrelu"):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1)
        self.bn1 = FlaxBatchNorm2d(out_channels, momentum=0.8)
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1)
        self.bn2 = FlaxBatchNorm2d(out_channels, momentum=0.8)
        self.cbam = CBAM(out_channels)
        self.act = _act(activation, 0.2)

    def forward(self, x):
        h = self.cbam(self.act(self.bn1(self.conv1(x))))
        return self.bn1(self.conv2(h)) + x


class MSIA(nn.Module):
    """Multi-scale illumination attention: ``forward(r, i_att)``, r with ``filters`` channels."""

    def __init__(self, filters, activation="lrelu"):
        super().__init__()
        self.conv_bn_relu_1 = ConvBNRelu(filters, filters, activation)
        self.conv_bn_relu_2 = ConvBNRelu(filters, filters, activation)
        self.deconv_2 = ConvTranspose2D(filters, filters, activation)
        self.conv_bn_relu_4 = ConvBNRelu(filters, filters, activation, kernel=1)
        self.deconv_4_1 = ConvTranspose2D(filters, filters, activation)
        self.deconv_4_2 = ConvTranspose2D(filters, filters, activation)
        self.out = Conv2D(filters * 4, filters)

    def forward(self, r, i_att):
        r_att = r * i_att
        m1 = self.conv_bn_relu_1(r_att)
        d2 = F.max_pool2d(r_att, 2, 2)
        m2 = self.deconv_2(self.conv_bn_relu_2(d2))
        d4 = F.max_pool2d(d2, 2, 2)
        m4 = self.deconv_4_2(self.deconv_4_1(self.conv_bn_relu_4(d4)))
        return self.out(torch.cat((r, m1, m2, m4), 1))


def pad_concat(x, y):
    """Zero-pad y about its centre to x's spatial size, concatenate the channels."""
    dy, dx = x.shape[2] - y.shape[2], x.shape[3] - y.shape[3]
    y = F.pad(y, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
    return torch.cat((x, y), 1)


# -------------------------------------------------------------- color_encoder


class ColorEncoder(nn.Module):
    """U-Net reflectance head -> sigmoid -> a same-size ``avg_kernel_size`` box blur."""

    def __init__(self, nf=64, avg_kernel_size=5, in_nc=3):
        super().__init__()
        self.avg_kernel_size = avg_kernel_size
        self.conv_input = Conv2D(in_nc, nf)
        self.conv_r1 = Conv2D(nf, nf * 2)
        self.conv_r2 = Conv2D(nf * 2, nf * 4)
        self.deconv_r1 = ConvTranspose2D(nf * 4, nf * 2)
        self.conv_r3 = Conv2D(nf * 4, nf * 2)
        self.deconv_r2 = ConvTranspose2D(nf * 2, nf)
        self.conv_r4 = Conv2D(nf * 2, nf)
        self.conv_r5 = Conv(nf, 3, 3, padding=1)

    def forward(self, x):
        conv_input = self.conv_input(x)
        c1 = self.conv_r1(F.max_pool2d(conv_input, 2, 2))
        c2 = self.conv_r2(F.max_pool2d(c1, 2, 2))
        c3 = self.conv_r3(pad_concat(c1, self.deconv_r1(c2)))
        c4 = self.conv_r4(pad_concat(conv_input, self.deconv_r2(c3)))
        r_out = torch.sigmoid(self.conv_r5(c4))
        k = self.avg_kernel_size
        return F.avg_pool2d(r_out, k, stride=1, padding=k // 2, count_include_pad=True)


# ---------------------------------------------------------------------- loss


def charbonnier_sum_loss(x, y, eps=1e-6):
    """``sum(sqrt(diff^2 + eps))``: eps, not eps^2, and a sum, as the reference."""
    diff = x - y
    return torch.sum(torch.sqrt(diff * diff + eps))


class LegacyGANLoss:
    """gan / ragan (BCE with logits), lsgan (MSE), wgan-gp (the sign loss)."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0):
        self.gan_type = gan_type.lower()
        self.real_label_val, self.fake_label_val = real_label_val, fake_label_val
        if self.gan_type not in ("gan", "ragan", "lsgan", "wgan-gp"):
            raise NotImplementedError(f"GAN type [{self.gan_type}] is not found")

    def __call__(self, logits, target_is_real):
        if self.gan_type == "wgan-gp":
            return -torch.mean(logits) if target_is_real else torch.mean(logits)
        target = torch.full_like(logits, self.real_label_val if target_is_real else self.fake_label_val)
        if self.gan_type == "lsgan":
            return torch.mean((logits - target) ** 2)
        return torch.mean(torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs())))


def gradient_penalty_loss(critic_fn, interp):
    """WGAN-GP: ``mean((||d critic / d interp||_2 - 1)^2)`` per sample, with the
    graph kept (``create_graph``) so the penalty trains the critic."""
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(critic_fn(interp).sum(), interp, create_graph=True)
    g = g.reshape(g.shape[0], -1)
    return torch.mean((torch.sqrt((g * g).sum(dim=1) + 1e-20) - 1.0) ** 2)
