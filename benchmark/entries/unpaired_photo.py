"""Unpaired enhancement as ``cli.infer_unpaired`` runs it, on photos in memory.

A call is one photo through ``enhance_image``: reflect-pad to a multiple of 16
(a whole 16 more where it already is one), /255, the log transform, ``get_sr``,
crop back, clip to [0, 1], uint8. The answer compared is that uint8 image.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import serving
from benchmark.harness.program import build_model


class Program:
    def __init__(self, cfg, state, device, pool):
        from glare_tpu_torch.cli.infer_unpaired import enhance_image

        self._enhance = enhance_image
        self.model, self.opt = build_model(cfg, state, device)
        self.apply_log = bool(cfg["datasets"]["train"]["log_low"])

    def __call__(self, photos):
        with record_function("cli.enhance_image"):
            return [self._enhance(self.model, p, self.apply_log) for p in photos]


def _pads(n):
    extra = 16 - n % 16
    return extra // 2, extra - extra // 2


def model_shape(photo):
    h, w, _ = photo.shape
    return h + sum(_pads(h)), w + sum(_pads(w))


def reference_inputs(photos, device):
    h, w, _ = photos[0].shape
    (t, b), (l, r) = _pads(h), _pads(w)
    x = np.stack([np.pad(p, [(t, b), (l, r), (0, 0)], "symmetric") for p in photos])
    x = torch.as_tensor(x, device=device).float().div(255.0)
    return torch.log(torch.clamp(x + 1e-3, min=1e-3)).permute(0, 3, 1, 2)


def reference_outputs(y, photos):
    h, w, _ = photos[0].shape
    (t, _), (l, _) = _pads(h), _pads(w)
    y = y[:, :, t:t + h, l:l + w].clamp(0.0, 1.0).mul(255.0).round().to(torch.uint8)
    return list(y.permute(0, 2, 3, 1).cpu().numpy())


def prepare(cfg, pool, seed, device, log):
    return serving.prepare(cfg, pool, seed, device, log, reference_inputs)


def reference(cfg, state, device, precision=None):
    return serving.reference(cfg, state, device, precision, reference_inputs, reference_outputs)
