"""Registry losses (counterpart of ``glare_tpu/sr/losses.py``; reference:
basicsr/losses/losses.py). NCHW tensors.

Arithmetic in float32 at least (a float64 input stays float64: a reference run).
L1 / MSE / Charbonnier with ``mean | sum | none`` reduction and element
weights, ``WeightedTVLoss``, ``PerceptualLoss`` (VGG taps + optional gram
style term; criterion l1 / l2 / fro), the ``GANLoss`` family (vanilla, lsgan,
wgan, wgan_softplus, hinge; ``loss_weight`` on the generator side only),
``MultiScaleGANLoss``, :func:`r1_penalty`, :func:`gradient_penalty_loss` and
:func:`build_loss`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import at_least_float32 as f32
from .registry import LOSS_REGISTRY


def _reduce(x, weight=None, reduction="mean"):
    if weight is not None:
        x = x * weight
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


@LOSS_REGISTRY.register()
class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce((f32(pred) - f32(target)).abs(), weight, self.reduction)


@LOSS_REGISTRY.register()
class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce((f32(pred) - f32(target)) ** 2, weight, self.reduction)


@LOSS_REGISTRY.register()
class CharbonnierLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        diff = f32(pred) - f32(target)
        return self.loss_weight * _reduce(torch.sqrt(diff ** 2 + self.eps), weight, self.reduction)


@LOSS_REGISTRY.register()
class WeightedTVLoss(L1Loss):
    """Total-variation loss over NCHW maps."""

    def __call__(self, pred, weight=None):
        wy = None if weight is None else weight[:, :, :-1, :]
        wx = None if weight is None else weight[:, :, :, :-1]
        y_loss = super().__call__(pred[:, :, :-1, :], pred[:, :, 1:, :], weight=wy)
        x_loss = super().__call__(pred[:, :, :, :-1], pred[:, :, :, 1:], weight=wx)
        return y_loss + x_loss


@LOSS_REGISTRY.register()
class PerceptualLoss(nn.Module):
    """VGG multi-tap perceptual + optional gram-style loss; ``layer_weights``
    keyed by VGG layer name. ``params``: a ``VGGFeatureExtractor`` state dict
    (default: ``archs.vgg_arch.load_vgg_params``). Returns (percep or None,
    style or None). The VGG is frozen; move the loss with ``.to(device)``."""

    def __init__(self, layer_weights: Optional[Dict[str, float]] = None, vgg_type="vgg19",
                 use_input_norm=True, range_norm=False, perceptual_weight=1.0, style_weight=0.0,
                 criterion="l1", params=None, **_):
        super().__init__()
        from .archs.vgg_arch import VGGFeatureExtractor, load_vgg_params

        self.layer_weights = dict(layer_weights or {"relu1_2": 1.0, "relu2_2": 1.0, "relu3_3": 1.0})
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        taps = list(self.layer_weights)
        self.vgg = VGGFeatureExtractor(taps, vgg_type=vgg_type, use_input_norm=use_input_norm,
                                       range_norm=range_norm)
        sd = params if params is not None else load_vgg_params(vgg_type, taps)
        missing = self.vgg.load_state_dict(sd, strict=False).missing_keys
        if any(".conv" in k for k in missing):
            raise ValueError(f"PerceptualLoss: VGG weights missing {missing}")
        self.vgg.requires_grad_(False).eval()

    def _crit(self, a, b):
        d = f32(a) - f32(b)
        if self.criterion == "l1":
            return d.abs().mean()
        if self.criterion == "fro":
            return torch.linalg.vector_norm(d)
        return (d ** 2).mean()

    @staticmethod
    def _gram(x):
        b, c, h, w = x.shape
        f = f32(x.reshape(b, c, h * w))
        return f @ f.transpose(1, 2) / (h * w * c)

    def forward(self, pred, target):
        fp = self.vgg(pred)
        fg = self.vgg(target.detach())
        percep = style = None
        if self.perceptual_weight > 0:
            percep = sum(self.layer_weights[n] * self._crit(fp[n], fg[n]) for n in self.layer_weights)
            percep = percep * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self.layer_weights[n] * self._crit(self._gram(fp[n]), self._gram(fg[n]))
                        for n in self.layer_weights)
            style = style * self.style_weight
        return percep, style


@LOSS_REGISTRY.register()
class GANLoss:
    """vanilla | lsgan | wgan | wgan_softplus | hinge."""

    def __init__(self, gan_type="vanilla", real_label_val=1.0, fake_label_val=0.0, loss_weight=1.0):
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred, target_is_real, is_disc=False):
        pred = f32(pred)
        t = self.gan_type
        if t == "vanilla":
            label = self.real_label_val if target_is_real else self.fake_label_val
            loss = (pred.clamp(min=0) - pred * label + torch.log1p(torch.exp(-pred.abs()))).mean()
        elif t == "lsgan":
            label = self.real_label_val if target_is_real else self.fake_label_val
            loss = ((pred - label) ** 2).mean()
        elif t == "wgan":
            loss = -pred.mean() if target_is_real else pred.mean()
        elif t == "wgan_softplus":
            loss = F.softplus(-pred).mean() if target_is_real else F.softplus(pred).mean()
        elif t == "hinge":
            if is_disc:
                pred = -pred if target_is_real else pred
                loss = F.relu(1 + pred).mean()
            else:
                loss = -pred.mean()
        else:
            raise NotImplementedError(f"GAN type {t} not implemented")
        return loss if is_disc else loss * self.loss_weight


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a list of multi-scale predictions (the last of a
    nested list)."""

    def __call__(self, preds, target_is_real, is_disc=False):
        if isinstance(preds, (list, tuple)):
            total = 0.0
            for p in preds:
                if isinstance(p, (list, tuple)):
                    p = p[-1]
                total = total + super().__call__(p, target_is_real, is_disc) / len(preds)
            return total
        return super().__call__(preds, target_is_real, is_disc)


def r1_penalty(disc_fn, real):
    """R1 gradient penalty: mean over images of |d sum(D(x)) / dx|^2 at the real
    images, differentiable in D's parameters."""
    x = real.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return (f32(grad) ** 2).sum(dim=(1, 2, 3)).mean()


def gradient_penalty_loss(disc_fn, real, fake, generator=None):
    """WGAN-GP: mean of (|grad D| - 1)^2 at random interpolates of real and fake
    (``generator``: a ``torch.Generator`` on their device, or None)."""
    alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator, device=real.device)
    interp = (alpha * real.detach() + (1 - alpha) * fake.detach()).requires_grad_(True)
    (grad,) = torch.autograd.grad(disc_fn(interp).sum(), interp, create_graph=True)
    norm = torch.sqrt((f32(grad) ** 2).sum(dim=(1, 2, 3)) + 1e-12)
    return ((norm - 1) ** 2).mean()


def build_loss(opt):
    opt = dict(opt)
    loss_type = opt.pop("type")
    return LOSS_REGISTRY.get(loss_type)(**opt)
