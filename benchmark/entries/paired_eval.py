"""Paired evaluation as ``cli.infer_paired`` runs it, without file IO.

Set-up: the start-up offset audit on the first four photos (``audit_on_sample``).
A call: each photo through ``prep`` (reflect pad bottom 20 and left 20, /255, the
log transform), the batch through ``enhance_exact`` (``get_sr`` with the DCN
exactness guard), the padded output brought to the host. The answer compared is
that float32 output, ``[H + 20, W + 20, 3]`` per photo.
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
        from glare_tpu_torch.cli.infer_paired import audit_on_sample, enhance_exact, prep

        self._prep, self._enhance = prep, enhance_exact
        self.model, self.opt = build_model(cfg, state, device)
        audit_on_sample(self.model, self.opt, [prep(p, self.opt)[0] for p in pool[:4]])

    def __call__(self, photos):
        with record_function("host.prep"):
            lr_b = np.stack([self._prep(p, self.opt)[0] for p in photos])
        with record_function("model.enhance_exact"):
            sr = self._enhance(self.model, lr_b)[0]
        with record_function("host.to_numpy"):
            return list(sr.cpu().numpy())


def model_shape(photo):
    h, w, _ = photo.shape
    return h + 20, w + 20


def reference_inputs(photos, device):
    """The reference's own preprocessing: [B, 3, H + 20, W + 20] float32."""
    x = torch.as_tensor(np.stack(photos), device=device).float().div(255.0)
    x = torch.log(torch.clamp(x + 1e-3, min=1e-3)).permute(0, 3, 1, 2)
    return F.pad(x, (20, 0, 0, 20), mode="reflect")


def reference_outputs(y, photos):
    return list(y.permute(0, 2, 3, 1).float().cpu().numpy())


def prepare(cfg, pool, seed, device, log):
    return serving.prepare(cfg, pool, seed, device, log, reference_inputs)


def reference(cfg, state, device, precision=None):
    return serving.reference(cfg, state, device, precision, reference_inputs, reference_outputs)
