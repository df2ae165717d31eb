"""Generator ``photos``: synthetic low-light photos and the order they are sent in.

A mix (``traffic/<mix>.json``) that names ``"generator": "photos"`` gives

    "sizes":  [{"hw": [H, W], "count": n}, ...]   the pool: n photos of each size
    "batch":  images per call (same-size images only)
    "loop":   "closed" -- each call is sent when the one before has returned
              (the harness's window; it refuses any other value)

A generator module has two functions: ``pool(mix, seed, device)``, the inputs
made at set-up, and ``calls(mix, seed, pool)``, an endless iterator over calls,
each a list of indices into the pool.

Every seed gets the same pool sizes; the seed draws the scenes and the order.
The order is the pool shuffled anew for every pass over it. Photos are made on
the device in one batch per size, then brought to the host as uint8 HWC RGB, as
a folder of images is read.

A scene is smooth colour (a low-resolution Gaussian field, bicubically enlarged)
with finer texture, squashed into [0, 1], then darkened as a low-light shot:
scaled by a per-photo exposure in [0.04, 0.22] with a gamma of 1.4, plus sensor
noise of standard deviation 0.004.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _scenes(n, h, w, gen, device):
    coarse = torch.randn(n, 3, max(2, h // 48), max(2, w // 48), generator=gen, device=device)
    fine = torch.randn(n, 3, max(2, h // 8), max(2, w // 8), generator=gen, device=device)
    field = (F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False) * 1.5
             + F.interpolate(fine, size=(h, w), mode="bicubic", align_corners=False) * 0.5)
    scene = torch.sigmoid(field)
    exposure = 0.04 + 0.18 * torch.rand(n, 1, 1, 1, generator=gen, device=device)
    noise = 0.004 * torch.randn(n, 3, h, w, generator=gen, device=device)
    low = (scene.pow(1.4) * exposure + noise).clamp(0.0, 1.0)
    return (low * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def pool(mix, seed, device="cpu"):
    """The pool: a list of uint8 [H, W, 3] arrays, sizes in the order of ``mix["sizes"]``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for size in mix["sizes"]:
        h, w = size["hw"]
        out.extend(_scenes(int(size["count"]), int(h), int(w), gen, device))
    return out


def order(mix, seed, n_pool):
    """An endless iterator over pool indices: the pool shuffled anew each pass."""
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield from (int(i) for i in rng.permutation(n_pool))


def calls(mix, seed, photos):
    """An endless iterator over calls: lists of ``mix["batch"]`` photos indices of one size.

    Requests are taken in ``order``; a request whose size differs from the call's
    first waits for the next call (a folder read in order with same-shape
    batching would send a shorter call; here every call is full)."""
    batch = int(mix.get("batch", 1))
    waiting = []
    it = order(mix, seed, len(photos))
    while True:
        call = [waiting.pop(0)] if waiting else [next(it)]
        keep = []
        for i in waiting:
            (call if len(call) < batch and photos[i].shape == photos[call[0]].shape else keep).append(i)
        waiting = keep
        while len(call) < batch:
            i = next(it)
            (call if photos[i].shape == photos[call[0]].shape else waiting).append(i)
        yield call
