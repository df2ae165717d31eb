"""Config-driven stage-1 training (counterpart of ``glare_tpu/sr/train.py``;
reference: basicsr/train.py).

    python -m glare_tpu_torch.sr.train -opt confs/stage1_HQ_pretrain.yml [--auto_resume] \
        [--debug] [--device cpu]
    torchrun --nproc_per_node=N -m glare_tpu_torch.sr.train -opt CONF --launcher pytorch

Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no explicit
``--device cpu`` it raises. Kept from the JAX loop: resume (``--auto_resume``:
the newest ``{iter}.state``; else ``path.resume_state``), the experiment tree
under ``$GLARE_ROOT/experiments/<name>`` (an existing one is archived), the
tensorboard logger (``logger.use_tb_logger``, not for ``debug`` names) and, before
it, the wandb run that syncs it (``logger.wandb.project``; without the wandb
package a warning, and training goes on), the train / val loaders (prefetched
under the train set's ``prefetch_mode``), the print / checkpoint / validation cadence
(``logger.print_freq``, ``logger.save_checkpoint_freq``, ``val.val_freq``),
best-PSNR snapshots, and a final save and validation. The final checkpoint is
labelled with the updates made (``total_iter``).

Data parallelism (``--launcher pytorch`` under ``torchrun``): each rank draws its
own batches through an ``EnlargedSampler`` (``set_epoch`` every epoch; an epoch
is ``ceil(len * ratio / (batch_size_per_gpu * world_size))`` iterations), the
model averages the gradients over the ranks, and rank 0 alone logs, validates and
writes the experiment tree and checkpoints. In one process the loader keeps its
own seeded shuffle, as the JAX loop's does.
"""

from __future__ import annotations

import datetime
import glob
import logging
import math
import os
import time

import numpy as np

from ..models.base_model import resolve_device
from ..parallel.mesh import EnlargedSampler
from ..utils import mkdir_and_rename, set_random_seed, setup_logger
from ..utils.metrics import PSNR, calculate_ssim, img_as_ubyte
from ..utils.util import natsorted
from .data import build_dataloader, build_dataset
from .models import build_model
from .utils import AvgTimer, MessageLogger, get_env_info, parse_options
from .utils.logger import init_tb_logger, init_wandb_logger


def load_resume_state(opt):
    if opt.get("auto_resume"):
        states = natsorted(glob.glob(os.path.join(opt["path"]["training_states"], "*.state")))
        if states:
            opt["path"]["resume_state"] = states[-1]
            return states[-1]
        return None
    return opt["path"].get("resume_state")


def create_train_val_dataloader(opt, logger):
    """-> (train loader, its sampler (None in one process), val loaders, epochs, iterations)."""
    train_loader, train_sampler, val_loaders, total_iters, total_epochs = None, None, [], 0, 0
    world = opt.get("world_size") or 1
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_set = build_dataset(dataset_opt)
            ratio = dataset_opt.get("dataset_enlarge_ratio", 1) or 1
            if world > 1:
                train_sampler = EnlargedSampler(len(train_set), world, opt["rank"], ratio)
            train_loader = build_dataloader(train_set, dataset_opt, seed=opt["manual_seed"],
                                            sampler=train_sampler)
            per_epoch = math.ceil(len(train_set) * ratio / (
                (dataset_opt.get("batch_size_per_gpu") or dataset_opt.get("batch_size") or 1) * world))
            total_iters = int(opt["train"]["total_iter"])
            total_epochs = math.ceil(total_iters / max(per_epoch, 1))
            logger.info(f"Training statistics:\n\tNumber of train images: {len(train_set)}"
                        f"\n\tTotal epochs: {total_epochs}; iters: {total_iters}.")
        elif phase.split("_")[0] == "val":
            val_loaders.append(build_dataloader(build_dataset(dataset_opt), dataset_opt,
                                                seed=opt["manual_seed"]))
    return train_loader, train_sampler, val_loaders, total_epochs, total_iters


def validate(model, val_loader, current_iter, logger, tb_logger, opt):
    """Mean PSNR / SSIM of ``model.test`` over the first ``val.n_max`` images (16);
    a better PSNR saves ``net_g_best_.pth``."""
    psnrs, ssims = [], []
    n_max = (opt["val"] or {}).get("n_max", 16) or 16
    for i, batch in enumerate(val_loader):
        if i >= n_max:
            break
        out = np.clip(model.test(batch["lq"]).cpu().numpy()[0], 0, 1)
        gt = np.asarray(batch["gt"])[0]
        psnrs.append(PSNR(gt, out))
        ssims.append(calculate_ssim(img_as_ubyte(gt), img_as_ubyte(out)))
    psnr, ssim = float(np.mean(psnrs)), float(np.mean(ssims))
    logger.info(f"# Validation # iter {current_iter} PSNR {psnr:.4f} SSIM {ssim:.4f}")
    if tb_logger:
        tb_logger.add_scalar("val/psnr", psnr, current_iter)
        tb_logger.add_scalar("val/ssim", ssim, current_iter)
    model._initialize_best_metric_results("val")
    if "psnr" in (opt["val"] or {}).get("metrics", {"psnr": {}}):
        if model._update_best_metric_result("val", "psnr", psnr, current_iter):
            model.save_best(current_iter)
    return psnr


def train_pipeline(root_path=None, argv=None):
    """-> (model, iterations done)."""
    opt, _ = parse_options(root_path, is_train=True, argv=argv)
    device = resolve_device(opt["device"])
    if opt["val"] is None:
        opt["val"] = {"metrics": {"psnr": {"type": "psnr", "better": "higher"}}}
    elif opt["val"].get("metrics") is None:
        opt["val"]["metrics"] = {"psnr": {"type": "psnr", "better": "higher"}}

    main_rank = opt["rank"] == 0   # rank 0 alone writes the tree, logs, validates and saves
    resume_state_path = load_resume_state(opt)
    if resume_state_path is None and main_rank:
        mkdir_and_rename(opt["path"]["experiments_root"])
        os.makedirs(opt["path"]["models"], exist_ok=True)
        os.makedirs(opt["path"]["training_states"], exist_ok=True)
    if opt["world_size"] > 1:
        import torch.distributed as dist

        dist.barrier()

    setup_logger("base", opt["path"]["log"], "train", level=logging.INFO if main_rank else logging.WARNING,
                 screen=True, tofile=main_rank)
    logger = logging.getLogger("base")
    logger.info(get_env_info())
    set_random_seed(opt["manual_seed"])

    tb_logger = None
    if main_rank and (opt.get("logger") or {}).get("use_tb_logger") and "debug" not in opt["name"]:
        if (opt["logger"].get("wandb") or {}).get("project") is not None:
            init_wandb_logger(opt)  # first, so that it can sync the tensorboard logs
        tb_logger = init_tb_logger(os.path.join(opt["path"]["experiments_root"], "tb_logger"))

    train_loader, train_sampler, val_loaders, total_epochs, total_iters = create_train_val_dataloader(
        opt, logger)
    model = build_model(opt, device=device)

    start_epoch, current_iter = 0, 0
    if resume_state_path is not None:
        start_epoch, current_iter = model.resume_training(resume_state_path)
        logger.info(f"Resuming training from epoch {start_epoch}, iter {current_iter}")

    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    iter_timer, data_timer = AvgTimer(), AvgTimer()
    start_time = time.time()
    logger_opt = opt.get("logger") or {}
    val_freq = int((opt.get("val") or {}).get("val_freq") or 10 ** 12)
    save_freq = int(logger_opt.get("save_checkpoint_freq") or 10 ** 12)
    print_freq = int(logger_opt.get("print_freq") or 100)

    epoch = start_epoch
    for epoch in range(start_epoch, total_epochs + 1):
        if current_iter >= total_iters:
            break
        if train_sampler is not None:
            train_sampler.set_epoch(epoch)
        for batch in train_loader:
            if current_iter >= total_iters:
                break
            data_timer.record()
            current_iter += 1
            model.optimize_parameters(current_iter, batch)
            iter_timer.record()
            if current_iter % print_freq == 0 and main_rank:
                log_vars = {"epoch": epoch, "iter": current_iter,
                            "lrs": [float(opt["train"]["optim_g"].get("lr", 0))],
                            "time": iter_timer.get_avg_time(), "data_time": data_timer.get_avg_time()}
                log_vars.update(model.get_current_log().items())
                msg_logger(log_vars)
            if current_iter % save_freq == 0 and main_rank:
                logger.info("Saving models and training states.")
                model.save(epoch, current_iter)
            if current_iter % val_freq == 0 and main_rank:
                for vl in val_loaders:
                    validate(model, vl, current_iter, logger, tb_logger, opt)
            data_timer.start()
            iter_timer.start()

    consumed = datetime.timedelta(seconds=int(time.time() - start_time))
    logger.info(f"End of training. Time consumed: {consumed}")
    if main_rank:
        model.save(epoch=-1, current_iter=current_iter)
        for vl in val_loaders:
            validate(model, vl, current_iter, logger, tb_logger, opt)
    if tb_logger:
        tb_logger.close()
    return model, current_iter


if __name__ == "__main__":
    train_pipeline()
