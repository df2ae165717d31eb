"""Stage-2 evaluation, the per-image step of ``cli.test_stages.evaluate_once``.

A call is one photo: reflect-pad to a multiple of 4 (bottom, right), /255, the
log transform, ``LLFlowModel.get_sr`` (the latent), ``decode_latent`` through the
VQGAN, to the host, cropped back. The answer compared is that float32 image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from benchmark.harness import serving
from benchmark.harness.program import build_model


class Program:
    def __init__(self, cfg, state, device, pool):
        from glare_tpu_torch.utils.imgproc import impad, log_transform

        self._impad, self._log = impad, log_transform
        self.model, self.opt = build_model(cfg, state, device)
        self.apply_log = bool(cfg["datasets"]["train"]["log_low"])

    def __call__(self, photos):
        out = []
        for p in photos:
            h, w, _ = p.shape
            with record_function("host.prep"):
                lr_t = self._impad(p, bottom=(-h) % 4, right=(-w) % 4).astype(np.float32) / 255.0
                if self.apply_log:
                    lr_t = self._log(lr_t)
            with record_function("model.get_sr"):
                latent = self.model.get_sr(lr_t[None])
            with record_function("model.decode_latent"):
                sr = self.model.decode_latent(latent)
            with record_function("host.to_numpy"):
                out.append(sr.cpu().numpy()[0][:h, :w])
        return out


def model_shape(photo):
    h, w, _ = photo.shape
    return h + (-h) % 4, w + (-w) % 4


def reference_inputs(photos, device):
    h, w, _ = photos[0].shape
    x = torch.as_tensor(np.stack(photos), device=device).float().div(255.0)
    x = torch.log(torch.clamp(x + 1e-3, min=1e-3)).permute(0, 3, 1, 2)
    return F.pad(x, (0, (-w) % 4, 0, (-h) % 4), mode="reflect")


def reference_outputs(y, photos):
    h, w, _ = photos[0].shape
    return list(y[:, :, :h, :w].permute(0, 2, 3, 1).float().cpu().numpy())


def prepare(cfg, pool, seed, device, log):
    return serving.prepare(cfg, pool, seed, device, log, reference_inputs)


def reference(cfg, state, device, precision=None):
    return serving.reference(cfg, state, device, precision, reference_inputs, reference_outputs)
