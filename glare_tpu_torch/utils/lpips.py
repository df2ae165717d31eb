"""LPIPS-AlexNet perceptual metric (counterpart of ``glare_tpu/utils/lpips_jax.py``;
reference dependency: ``lpips.LPIPS(net='alex')``, code/Measure.py:17-30).

The metric: the five conv taps of AlexNet's ``features`` (each after its ReLU;
3x3 stride-2 max pools between the first three), each unit-normalized over its
channels (eps 1e-10), the squared difference weighted by a 1x1 linear head,
averaged over batch and space, summed over the five taps. Inputs in [-1, 1]
are first scaled by the LPIPS ``_SHIFT`` / ``_SCALE`` layer. Float32, on the
device the module is moved to.

The AlexNet and linear weights cannot be downloaded here: :func:`load_lpips`
reads the npz that ``tools/convert_torch_lpips.py`` writes (``$GLARE_LPIPS_NPZ``)
or, with local files only, the torch cache that :func:`probe_lpips_cache`
finds; it returns None otherwise, and callers report LPIPS as NaN.

npz layout: ``conv_{i}.weight`` (OIHW), ``conv_{i}.bias``, ``lin_{i}.weight``
(``[C]`` or ``[1, C, 1, 1]``), i = 0..4.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out channels, kernel, stride, padding) of AlexNet.features' five convolutions;
# a 3x3 stride-2 max pool follows the first two
_ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _normalize_tensor(x, eps=1e-10):
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """``forward(a, b)``: NCHW float images in [-1, 1] -> scalar LPIPS distance
    (the mean over the batch)."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, k, s, p in _ALEX:
            convs.append(nn.Conv2d(cin, cout, k, stride=s, padding=p))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList([nn.Parameter(torch.zeros(c)) for c, *_ in _ALEX])
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    @classmethod
    def from_arrays(cls, data):
        """A module holding the weights of an npz-layout mapping."""
        net = cls()
        with torch.no_grad():
            for i, conv in enumerate(net.convs):
                conv.weight.copy_(torch.as_tensor(np.asarray(data[f"conv_{i}.weight"], np.float32)))
                conv.bias.copy_(torch.as_tensor(np.asarray(data[f"conv_{i}.bias"], np.float32)))
                net.lins[i].copy_(torch.as_tensor(np.asarray(data[f"lin_{i}.weight"], np.float32))
                                  .reshape(-1))
        return net

    def taps(self, x):
        h, out = x, []
        for i, conv in enumerate(self.convs):
            if i in (1, 2):
                h = F.max_pool2d(h, 3, stride=2)
            h = F.relu(conv(h))
            out.append(h)
        return out

    def forward(self, a, b):
        fa = self.taps((a.float() - self.shift) / self.scale)
        fb = self.taps((b.float() - self.shift) / self.scale)
        total = 0.0
        for ta, tb, w in zip(fa, fb, self.lins):
            d = (_normalize_tensor(ta) - _normalize_tensor(tb)) ** 2
            total = total + (d * w.view(1, -1, 1, 1)).sum(dim=1).mean()
        return total


def probe_lpips_cache() -> Optional[dict]:
    """Assemble LPIPS-Alex weights from locally cached torch files, with no
    network access: the AlexNet backbone checkpoint
    (``$TORCH_HOME/hub/checkpoints/alexnet-*.pth``) and the lpips package's
    linear calibration (``lpips/weights/v0.1/alex.pth``, when that package is
    installed). Returns npz-layout arrays or None."""
    import glob as _glob

    torch_home = os.environ.get("TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    backbones = sorted(_glob.glob(os.path.join(torch_home, "hub", "checkpoints", "alexnet-*.pth")))
    lin_path = None
    try:
        import lpips as _lpips_pkg

        cand = os.path.join(os.path.dirname(_lpips_pkg.__file__), "weights", "v0.1", "alex.pth")
        if os.path.exists(cand):
            lin_path = cand
    except ImportError:
        pass
    if not backbones or lin_path is None:
        return None
    bb = torch.load(backbones[0], map_location="cpu", weights_only=True)
    lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    feat_keys = sorted({int(k.split(".")[1]) for k in bb
                        if k.startswith("features") and k.endswith(".weight")})
    data = {}
    for i, fi in enumerate(feat_keys[:5]):
        data[f"conv_{i}.weight"] = bb[f"features.{fi}.weight"].numpy()
        data[f"conv_{i}.bias"] = bb[f"features.{fi}.bias"].numpy()
    for i in range(5):
        data[f"lin_{i}.weight"] = lin[f"lin{i}.model.1.weight"].numpy()
    return data


def load_lpips(device="cuda") -> Optional[LPIPS]:
    """The LPIPS module on ``device`` (eval, float32) from ``$GLARE_LPIPS_NPZ`` or
    the local torch cache, or None when neither has the weights."""
    path = os.environ.get("GLARE_LPIPS_NPZ", "")
    if path and os.path.exists(path):
        with np.load(path) as f:
            data = {k: f[k] for k in f.files}
    else:
        data = probe_lpips_cache()
    if data is None:
        return None
    return LPIPS.from_arrays(data).to(device).eval()
