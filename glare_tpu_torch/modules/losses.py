"""Training losses (counterpart of ``glare_tpu/modules/losses.py``).

  * :func:`smooth_l1_loss`, :func:`charbonnier_loss`.
  * :class:`VGG16Features` / :class:`PerceptualNetwork` -- frozen VGG16
    relu1_2 / relu2_2 / relu3_3 feature MSE, averaged over the three taps. As in
    the reference, [0, 1] RGB goes into the VGG without ImageNet normalization.
    Written with ``nn.Conv2d`` (no vision package: the card's machine has none);
    the 7 convolutions carry the released VGG16 checkpoint's
    ``features.{0,2,5,7,10,12,14}`` weights.

Weights, in this order (:func:`load_vgg16_params`): ``GLARE_VGG16_NPZ`` (the
npz of ``tools/torch2flax.py --kind vgg16``), then a cached VGG16 checkpoint
``vgg16-*.pth`` under ``$TORCH_HOME`` read as a ``state_dict`` (torch only),
then a fixed-seed random VGG from a ``torch.Generator`` with the JAX package's
warning. The random weights are not the JAX package's; the parity tests carry
its weights over (``convert.flax_to_torch_vgg16``).
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def smooth_l1_loss(pred, target, beta=1.0, reduction="mean"):
    diff = (pred.float() - target.float()).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def charbonnier_loss(pred, target, eps=1e-12, reduction="mean"):
    loss = torch.sqrt((pred.float() - target.float()) ** 2 + eps)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


# vgg16.features through relu3_3: conv widths, "M" = 2x2 max pool
_VGG16_PREFIX = [64, 64, "M", 128, 128, "M", 256, 256, 256]
_TAPS = (1, 3, 6)  # conv indices whose relu output is a tap (relu1_2, relu2_2, relu3_3)
# vgg16.features indices of the 7 convs through relu3_3 (the checkpoint's names)
VGG16_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14)


class VGG16Features(nn.Module):
    """First 16 layers of VGG16 (through relu3_3) on NCHW input; returns the
    three tap activations. ``convs.{i}`` is the checkpoint's ``features.{idx[i]}``."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for spec in _VGG16_PREFIX:
            if spec != "M":
                convs.append(nn.Conv2d(cin, spec, 3, padding=1))
                cin = spec
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        taps, i, h = [], 0, x
        for spec in _VGG16_PREFIX:
            if spec == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            h = F.relu(self.convs[i](h))
            if i in _TAPS:
                taps.append(h)
            i += 1
        return taps


def probe_torch_vgg16_cache() -> Optional[str]:
    """A locally cached VGG16 checkpoint, without network access:
    ``$TORCH_HOME/hub/checkpoints/vgg16-*.pth`` or ``~/.torch/models/vgg16-*.pth``."""
    torch_home = os.environ.get("TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    for pat in (os.path.join(torch_home, "hub", "checkpoints", "vgg16-*.pth"),
                os.path.join(os.path.expanduser("~"), ".torch", "models", "vgg16-*.pth")):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def _state_dict_from_checkpoint(sd) -> dict:
    return {f"convs.{i}.{n}": torch.as_tensor(sd[f"features.{fi}.{n}"]).float()
            for i, fi in enumerate(VGG16_TORCH_CONV_IDX) for n in ("weight", "bias")}


def load_vgg16_params(seed: int = 0, return_source: bool = False, rng_seed=None):
    """A :class:`VGG16Features` ``state_dict`` from the best source there is (see
    the module docstring); ``return_source`` adds 'npz', 'torch-cache:<path>' or
    'random'. ``rng_seed`` is the JAX package's name for ``seed``."""
    if rng_seed is not None:
        if seed not in (0, rng_seed):
            raise ValueError(f"pass seed ({seed}) or rng_seed ({rng_seed}), not both")
        seed = rng_seed
    path = os.environ.get("GLARE_VGG16_NPZ", "")
    if path and os.path.exists(path):
        data = np.load(path)
        sd = {f"convs.{i}.{n}": torch.from_numpy(np.asarray(data[f"conv_{i}.{n}"], np.float32))
              for i in range(7) for n in ("weight", "bias")}
        return (sd, "npz") if return_source else sd
    cached = probe_torch_vgg16_cache()
    if cached is not None:
        sd = _state_dict_from_checkpoint(torch.load(cached, map_location="cpu", weights_only=True))
        return (sd, f"torch-cache:{cached}") if return_source else sd
    warnings.warn(
        "No pretrained VGG16 weights found (GLARE_VGG16_NPZ unset and no cached vgg16-*.pth "
        "under $TORCH_HOME) -- using a fixed-seed RANDOM VGG. The perceptual loss is "
        "structured but NOT parity with the reference objective "
        "(code/models/modules/losses.py:12-40).", stacklevel=2)
    module = VGG16Features()
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for conv in module.convs:
            bound = 1.0 / float(np.sqrt(conv.weight[0].numel()))
            conv.weight.uniform_(-bound, bound, generator=gen)
            conv.bias.zero_()
    sd = module.state_dict()
    return (sd, "random") if return_source else sd


class PerceptualNetwork(nn.Module):
    """Frozen VGG16 multi-tap MSE: ``loss = mean over taps of MSE(vgg(pred),
    vgg(gt))``. Inputs NHWC in [0, 1] (the JAX callable's layout)."""

    def __init__(self, params=None):
        super().__init__()
        self.vgg = VGG16Features()
        if params is not None:
            sd, self.source = params, "explicit"
        else:
            sd, self.source = load_vgg16_params(return_source=True)
        self.vgg.load_state_dict(sd)
        self.vgg.requires_grad_(False).eval()
        self.pretrained = self.source != "random"

    def features(self, x):
        """VGG16 features of an NHWC image batch ``x``."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.vgg(x.to(self.vgg.convs[0].weight.dtype))

    def forward(self, pred, gt):
        fp, fg = self.features(pred), self.features(gt)
        losses = [((a.float() - b.float()) ** 2).mean() for a, b in zip(fp, fg)]
        return sum(losses) / len(losses)
