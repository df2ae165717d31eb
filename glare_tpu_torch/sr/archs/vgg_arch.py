"""VGG feature extractor with named-layer taps (counterpart of
``glare_tpu/sr/archs/vgg_arch.py``; reference: basicsr/archs/vgg_arch.py). NCHW.

Only the prefix of the chosen VGG up to the deepest requested tap is built
(``vgg_net.{conv1_1, ...}``, the reference's layer names); inputs are mapped
[-1, 1] -> [0, 1] with ``range_norm`` and normalized with the ImageNet mean and
std with ``use_input_norm``. The ``_bn`` variants' batch norms run on their
running statistics.

Weights (:func:`load_vgg_params`), in this order: the npz at ``GLARE_VGG_NPZ``
(``<layer>.weight`` OIHW / ``<layer>.bias``), a cached checkpoint of the released VGG
``<vgg>-*.pth`` under ``$TORCH_HOME/hub/checkpoints`` (plain variants; read as a
``state_dict``), else a fixed-seed random net with the JAX package's warning.
The random net is not the JAX package's (``jax.random`` cannot be reproduced):
the parity tests carry its parameters over (``convert.flax_to_torch_vgg``).
"""

from __future__ import annotations

import glob
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NAMES = {
    "vgg11": [
        "conv1_1", "relu1_1", "pool1", "conv2_1", "relu2_1", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "pool3", "conv4_1",
        "relu4_1", "conv4_2", "relu4_2", "pool4", "conv5_1", "relu5_1",
        "conv5_2", "relu5_2", "pool5",
    ],
    "vgg13": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1", "conv2_1",
        "relu2_1", "conv2_2", "relu2_2", "pool2", "conv3_1", "relu3_1",
        "conv3_2", "relu3_2", "pool3", "conv4_1", "relu4_1", "conv4_2",
        "relu4_2", "pool4", "conv5_1", "relu5_1", "conv5_2", "relu5_2",
        "pool5",
    ],
    "vgg16": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1", "conv2_1",
        "relu2_1", "conv2_2", "relu2_2", "pool2", "conv3_1", "relu3_1",
        "conv3_2", "relu3_2", "conv3_3", "relu3_3", "pool3", "conv4_1",
        "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3", "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
        "pool5",
    ],
    "vgg19": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1", "conv2_1",
        "relu2_1", "conv2_2", "relu2_2", "pool2", "conv3_1", "relu3_1",
        "conv3_2", "relu3_2", "conv3_3", "relu3_3", "conv3_4", "relu3_4",
        "pool3", "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3",
        "relu4_3", "conv4_4", "relu4_4", "pool4", "conv5_1", "relu5_1",
        "conv5_2", "relu5_2", "conv5_3", "relu5_3", "conv5_4", "relu5_4",
        "pool5",
    ],
}

_BLOCK_CH = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def insert_bn(names):
    """A bn layer name after each conv."""
    out = []
    for name in names:
        out.append(name)
        if "conv" in name:
            out.append("bn" + name.replace("conv", ""))
    return out


def layer_names(vgg_type, layer_name_list=()):
    """The variant's layers up to the deepest of ``layer_name_list`` (all without)."""
    names = NAMES[vgg_type.replace("_bn", "")]
    if "bn" in vgg_type:
        names = insert_bn(names)
    last = max(names.index(v) for v in layer_name_list) if layer_name_list else len(names) - 1
    return names[:last + 1]


class VGGFeatureExtractor(nn.Module):
    """``forward(x [B, 3, H, W]) -> {tap name: feature}``."""

    def __init__(self, layer_name_list, vgg_type="vgg19", use_input_norm=True, range_norm=False,
                 remove_pooling=False, pooling_stride=2):
        super().__init__()
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm, self.range_norm = use_input_norm, range_norm
        self.remove_pooling, self.pooling_stride = remove_pooling, pooling_stride
        self.names = layer_names(vgg_type, self.layer_name_list)
        layers, in_ch = {}, 3
        for name in self.names:
            if name.startswith("conv"):
                out_ch = _BLOCK_CH[int(name[4])]
                layers[name] = nn.Conv2d(in_ch, out_ch, 3, padding=1)
                in_ch = out_ch
            elif name.startswith("bn"):
                layers[name] = nn.BatchNorm2d(in_ch, eps=1e-5)
        self.vgg_net = nn.ModuleDict(layers)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, x):
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        taps = {}
        for name in self.names:
            if name.startswith("conv"):
                x = self.vgg_net[name](x)
            elif name.startswith("bn"):
                n = self.vgg_net[name]
                x = F.batch_norm(x, n.running_mean, n.running_var, n.weight, n.bias, False, 0.0, n.eps)
            elif name.startswith("relu"):
                x = F.relu(x)
            elif not self.remove_pooling:  # pool
                x = F.max_pool2d(x, 2, self.pooling_stride)
            if name in self.layer_name_list:
                taps[name] = x
        return taps


def load_vgg_params(vgg_type="vgg19", layer_name_list=(), rng_seed=0):
    """The convolutions' ``{vgg_net.<conv>.weight / .bias}`` for a
    :class:`VGGFeatureExtractor` from the best source there is (module docstring)."""
    wanted = [n for n in layer_names(vgg_type, layer_name_list) if n.startswith("conv")]

    path = os.environ.get("GLARE_VGG_NPZ", "")
    if path and os.path.exists(path):
        npz = np.load(path)
        return {f"vgg_net.{n}.{k}": torch.from_numpy(np.asarray(npz[f"{n}.{k}"], np.float32))
                for n in wanted for k in ("weight", "bias")}

    torch_home = os.environ.get("TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    base = vgg_type.replace("_bn", "")
    hits = [] if "bn" in vgg_type else sorted(glob.glob(
        os.path.join(torch_home, "hub", "checkpoints", f"{base}-*.pth")))
    if hits:
        sd = torch.load(hits[0], map_location="cpu", weights_only=True)
        # a plain released vgg: its features.* weights are the convs, in NAMES order
        feat = sorted({int(k.split(".")[1]) for k in sd if k.startswith("features") and k.endswith(".weight")})
        convs = [m for m in NAMES[base] if m.startswith("conv")]
        params = {f"vgg_net.{n}.{k}": sd[f"features.{fi}.{k}"].float()
                  for n, fi in zip(convs, feat) if n in wanted for k in ("weight", "bias")}
        if len(params) == 2 * len(wanted):
            return params

    warnings.warn(
        "GLARE_VGG_NPZ not set or missing — VGGFeatureExtractor uses a "
        "fixed-seed RANDOM net. Feature losses are well-defined but NOT "
        "parity with the ImageNet-pretrained reference.",
        stacklevel=2,
    )
    gen = torch.Generator(device="cpu").manual_seed(rng_seed)
    params, in_ch = {}, 3
    for n in wanted:
        out_ch = _BLOCK_CH[int(n[4])]
        std = (2.0 / (9 * in_ch)) ** 0.5
        params[f"vgg_net.{n}.weight"] = torch.randn(out_ch, in_ch, 3, 3, generator=gen) * std
        params[f"vgg_net.{n}.bias"] = torch.zeros(out_ch)
        in_ch = out_ch
    return params
