"""Metric harness (counterpart of ``glare_tpu/measure.py``; reference:
code/Measure.py:17-109).

``Measure(device=...).measure(imgA, imgB)`` -> (psnr, ssim, lpips) of two uint8
HWC RGB images. PSNR and SSIM are host numpy (``utils/metrics.py``); LPIPS is
the AlexNet network of ``utils/lpips.py`` on ``device`` (float32), built at the
first call; without its weights (``$GLARE_LPIPS_NPZ``) it is NaN, with one
warning. ``device`` is ``cuda`` unless the caller asks for the CPU; with no GPU
and no ``device="cpu"`` the constructor raises. The JAX keyword ``use_gpu`` is
taken too: True is ``cuda``, False ``cpu`` (not both keywords at once).

    python -m glare_tpu_torch.measure -dirA a -dirB b [-v] [--device cpu]

measures every pair of PNGs of two folders (``cv2`` reads them).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from .models.base_model import resolve_device
from .utils.metrics import calculate_psnr, calculate_ssim
from .utils.util import natsorted


def t(img, device="cpu"):
    """uint8 HWC -> NCHW float32 in [-1, 1] on ``device`` (reference: Measure.py:66-67)."""
    img = np.asarray(img).astype(np.float32) / 255.0 * 2 - 1
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None])).to(device)


def _measure_device(use_gpu, device):
    """``use_gpu`` (the JAX keyword: True ``cuda``, False ``cpu``) or ``device``;
    neither: ``cuda``."""
    if use_gpu is not None and device is not None:
        raise ValueError(f"pass use_gpu ({use_gpu!r}) or device ({device!r}), not both")
    if use_gpu is not None:
        return "cuda" if use_gpu else "cpu"
    return device or "cuda"


class Measure:
    def __init__(self, net="alex", use_gpu=None, device=None):
        if net != "alex":
            raise ValueError(f"only the AlexNet LPIPS is ported, not {net!r}")
        self.device = resolve_device(_measure_device(use_gpu, device))
        self._lpips_fn = None
        self._lpips_tried = False

    def measure(self, imgA, imgB):
        return [f(imgA, imgB) for f in [self.psnr, self.ssim, self.lpips]]

    def lpips(self, imgA, imgB, model=None):
        if not self._lpips_tried:
            from .utils.lpips import load_lpips

            self._lpips_fn = load_lpips(self.device)
            self._lpips_tried = True
            if self._lpips_fn is None:
                logging.getLogger("base").warning(
                    "LPIPS weights unavailable (set GLARE_LPIPS_NPZ); reporting NaN")
        if self._lpips_fn is None:
            return float("nan")
        with torch.inference_mode():
            return float(self._lpips_fn(t(imgA, self.device), t(imgB, self.device)))

    def psnr(self, imgA, imgB):
        return calculate_psnr(imgA, imgB)

    def ssim(self, imgA, imgB):
        return calculate_ssim(imgA, imgB)


def format_result(psnr, ssim, lpips):
    return f"{psnr:0.2f}, {ssim:0.3f}, {lpips:0.3f}"


def measure_dirs(dirA, dirB, use_gpu=None, verbose=False, device=None):
    """(psnr, ssim, lpips) of each pair of PNGs (natural order, recursive) ->
    a list of ``{name, psnr, ssim, lpips}``; the device as :class:`Measure` takes it."""
    import cv2

    vprint = print if verbose else (lambda x: None)
    t_init = time.time()
    paths_A = natsorted(glob.glob(os.path.join(dirA, "**", "*.png"), recursive=True))
    paths_B = natsorted(glob.glob(os.path.join(dirB, "**", "*.png"), recursive=True))
    vprint(f"Measuring: {dirA} vs {dirB}")
    measure = Measure(use_gpu=use_gpu, device=device)
    results = []
    for pathA, pathB in zip(paths_A, paths_B):
        imgA = cv2.imread(pathA)[:, :, ::-1]
        imgB = cv2.imread(pathB)[:, :, ::-1]
        result = OrderedDict(name=os.path.basename(pathA))
        result["psnr"], result["ssim"], result["lpips"] = measure.measure(imgA, imgB)
        results.append(result)
        vprint(format_result(result["psnr"], result["ssim"], result["lpips"]))
    psnr = np.mean([r["psnr"] for r in results])
    ssim = np.mean([r["ssim"] for r in results])
    lpips_v = np.mean([r["lpips"] for r in results])
    vprint(f"Final Result: {format_result(psnr, ssim, lpips_v)}, {time.time() - t_init:0.1f}s")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-dirA", default="", type=str)
    parser.add_argument("-dirB", default="", type=str)
    parser.add_argument("-v", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if not (args.dirA and args.dirB):
        parser.error("-dirA and -dirB are required")
    return measure_dirs(args.dirA, args.dirB, device=args.device, verbose=args.v)


if __name__ == "__main__":
    main()
