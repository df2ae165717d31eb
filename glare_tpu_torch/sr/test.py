"""Config-driven stage-1 evaluation (counterpart of ``glare_tpu/sr/test.py``;
reference: basicsr/test.py).

    python -m glare_tpu_torch.sr.test -opt CONF [--device cpu]

Each dataset of the conf through ``VQDehazeModel.test`` (the generator of
``path.pretrain_network_g``): mean PSNR / SSIM in the log, images under
``results/<name>/visualization`` with ``val.save_img``.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..models.base_model import resolve_device
from ..utils import setup_logger
from ..utils.imgproc import imwrite
from ..utils.metrics import PSNR, calculate_ssim, img_as_ubyte
from .data import build_dataloader, build_dataset
from .models import build_model
from .utils import get_env_info, parse_options


def test_pipeline(root_path=None, argv=None):
    """-> (model, {phase: (psnr, ssim)})."""
    opt, _ = parse_options(root_path, is_train=False, argv=argv)
    device = resolve_device(opt["device"])
    os.makedirs(opt["path"]["results_root"], exist_ok=True)
    setup_logger("base", opt["path"]["log"], "test", screen=True, tofile=True)
    logger = logging.getLogger("base")
    logger.info(get_env_info())

    loaders = [(phase, build_dataloader(build_dataset(dataset_opt), dataset_opt))
               for phase, dataset_opt in sorted(opt["datasets"].items())]
    model = build_model(opt, device=device)
    save_img = bool((opt.get("val") or {}).get("save_img"))
    results = {}
    for phase, loader in loaders:
        psnrs, ssims = [], []
        for batch in loader:
            out = np.clip(model.test(batch["lq"]).cpu().numpy()[0], 0, 1)
            gt = np.asarray(batch["gt"])[0]
            psnrs.append(PSNR(gt, out))
            ssims.append(calculate_ssim(img_as_ubyte(gt), img_as_ubyte(out)))
            if save_img:
                name = os.path.splitext(os.path.basename(batch["gt_path"][0]))[0]
                imwrite(os.path.join(opt["path"]["visualization"], f"{name}.png"), img_as_ubyte(out))
        results[phase] = (float(np.mean(psnrs)), float(np.mean(ssims)))
        logger.info(f"[{phase}] PSNR: {results[phase][0]:.4f} SSIM: {results[phase][1]:.4f}")
    return model, results


if __name__ == "__main__":
    test_pipeline()
