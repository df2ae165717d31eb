"""Stage-2 and stage-3 training on the GPU (counterpart of ``glare_tpu/cli/train.py``).

    python -m glare_tpu_torch.cli.train --stage 2 [--opt confs/train_stage2_LOL.yml] \
        [--niter N] [--device cpu]
    python -m glare_tpu_torch.cli.train --stage 3 [--opt confs/train_stage3_LOL.yml] \
        [--niter N] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no explicit
``--device cpu`` it raises. Kept from the JAX loop: ``resume_state: auto``
discovery, experiment-dir archival, the ``--niter`` override (with
``lr_steps_rel`` re-expanded), ``print_freq`` logging, the checkpoint cadence
(``save_checkpoint_freq``, denser past 30k / 40k / 50k iterations), a non-finite
loss reloading the newest training state, validation every ``val_freq`` through
``get_sr`` (stage 2: and ``decode_latent``) with best-PSNR snapshots, 2 kept
training states, and tensorboard scalars under ``experiments_root/tb_logger``
when the conf sets ``use_tb_logger`` and its name holds no ``debug`` (rank 0;
without the tensorboard package a warning, and training goes on): every
``print_freq`` iterations ``loss/{k}``, ``lr``, ``time/iteration``, ``time/data``
and ``eta_h``, and ``val/psnr`` at each validation. Artifacts: ``{iter}_G.pth`` under ``models/`` (a ``state_dict``
the inference CLIs and ``cli/test_stages.py`` load) and ``{iter}.state`` under
``training_state/``. ``--stage`` picks the default conf and the validation; the
conf's ``model`` must be that stage's (stage 2 ``LLFlow``, stage 3 ``VQLLFLOWD``).

Data parallelism: under ``torchrun`` (``WORLD_SIZE`` in the environment),

    torchrun --nproc_per_node=N -m glare_tpu_torch.cli.train --stage 3 [--opt CONF]

each process joins the group (``parallel.init_distributed``: NCCL on the card,
gloo with ``--device cpu``) on its own card, loads the same global batch (the same
seed, the same order) and trains on its block of it; the model averages the
gradients. Rank 0 alone logs, validates and writes the experiment tree and the
checkpoints. Without ``torchrun`` nothing changes.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time

import numpy as np

from ..data import create_dataloader, create_dataset
from ..models import create_model
from ..models.base_model import resolve_device
from ..options import dict2str, dict_to_nonedict, parse
from ..parallel.mesh import init_distributed, local_device
from ..utils import Timer, TickTock, mkdir_and_rename, mkdirs, set_random_seed, setup_logger
from ..sr.utils.logger import init_tb_logger
from ..utils.metrics import PSNR, gray_mean_adjust
from ..utils.util import get_resume_paths, opt_get


STAGE_MODEL = {2: "LLFlow", 3: "VQLLFLOWD"}


def get_resume_state(opt):
    resume_state_path, _ = get_resume_paths(opt)
    if resume_state_path is None or not os.path.isfile(resume_state_path):
        return None
    return resume_state_path


def main(stage=3, argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage", type=int, default=stage)
    parser.add_argument("--opt", default=None)
    parser.add_argument("--niter", type=int, default=None, help="override train.niter")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    if args.stage not in STAGE_MODEL:
        raise NotImplementedError(
            f"--stage {args.stage}: this CLI trains stages 2 and 3; stage 1 (the codebook "
            "framework) trains with `python -m glare_tpu_torch.sr.train -opt CONF`")
    device = resolve_device(args.device)
    main_rank = True   # rank 0 alone writes the tree, logs, validates and saves
    if "WORLD_SIZE" in os.environ:
        main_rank = init_distributed(device)[0] == 0
        device = local_device(device)
    opt = parse(args.opt or f"./confs/train_stage{args.stage}_LOL.yml", is_train=True)
    if opt["model"] != STAGE_MODEL[args.stage]:
        raise ValueError(f"--stage {args.stage} trains model {STAGE_MODEL[args.stage]!r}; the conf "
                         f"names {opt['model']!r}")
    if args.niter:
        opt["train"]["niter"] = args.niter
        if opt["train"].get("lr_steps_rel"):
            opt["train"]["lr_steps"] = [int(x * args.niter) for x in opt["train"]["lr_steps_rel"]]
    opt = dict_to_nonedict(opt)

    resume_state_path = get_resume_state(opt)
    if resume_state_path is None and main_rank:
        mkdir_and_rename(opt["path"]["experiments_root"])
        mkdirs(path for key, path in opt["path"].items()
               if isinstance(path, str) and key not in ("experiments_root", "root")
               and "pretrain" not in key and "resume" not in key and "strict" not in key)
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        dist.barrier()

    setup_logger("base", opt["path"]["log"], "train_" + opt["name"],
                 level=logging.INFO if main_rank else logging.WARNING, screen=True, tofile=main_rank)
    logger = logging.getLogger("base")
    logger.info(dict2str(opt))

    tb_logger = None
    if main_rank and opt.get("use_tb_logger") and "debug" not in opt["name"]:
        tb_logger = init_tb_logger(os.path.join(opt["path"]["experiments_root"], "tb_logger"))

    seed = opt_get(opt, ["train", "manual_seed"], 10) or 10
    set_random_seed(seed)

    train_set = create_dataset(opt["datasets"]["train"], train=True, all_opt=opt)
    train_loader = create_dataloader(True, train_set, opt["datasets"]["train"], opt, seed=seed)
    val_set = create_dataset(opt["datasets"]["val"], train=False, all_opt=opt)
    val_loader = create_dataloader(False, val_set, opt["datasets"]["val"], opt, seed=seed)

    total_iters = int(opt["train"]["niter"])
    total_epochs = int(math.ceil(total_iters / max(len(train_loader), 1)))
    logger.info("Total epochs: %d, iters: %d", total_epochs, total_iters)

    model = create_model(opt, device=device)
    current_step, start_epoch = 0, 0
    if resume_state_path is not None:
        logger.info("Resuming from %s", resume_state_path)
        start_epoch, current_step = model.resume_training(resume_state_path)

    timer, tick_tock = Timer(), TickTock()
    print_freq = opt["logger"]["print_freq"] or 100
    save_freq = int(opt["logger"]["save_checkpoint_freq"] or 1000)
    val_freq = int(opt["train"]["val_freq"] or 10 ** 12)
    best_psnr = -1.0

    t_start = time.time()
    epoch = start_epoch
    for epoch in range(start_epoch, total_epochs + 10):
        if current_step > total_iters:
            break
        tick_tock.tick()
        for batch in train_loader:
            tick_tock.tock()
            current_step += 1
            if current_step > total_iters:
                break
            timer.tick()
            model.optimize_parameters({"LQ": batch["LQ"], "GT": batch["GT"]}, current_step)
            timer.tock()

            # a non-finite loss reloads the newest training state
            log_vals = list(model.get_current_log().values())
            if log_vals and not all(math.isfinite(v) for v in log_vals):
                logger.warning("Non-finite loss at iter %d: %s -- reloading newest state",
                               current_step, model.get_current_log())
                state_path, _ = get_resume_paths({"path": dict(opt["path"], resume_state="auto")})
                if state_path and os.path.isfile(state_path):
                    _, current_step = model.resume_training(state_path)
                    continue
                raise FloatingPointError(
                    f"non-finite loss at iter {current_step} and no state to reload")

            if current_step % print_freq == 0:
                avg_it = timer.get_average_and_reset()
                avg_data = tick_tock.get_average_and_reset()
                eta = (total_iters - current_step) * max(avg_it, 0)
                lr_now = float(model.schedule(current_step))
                logger.info(
                    f"<epoch:{epoch:3d}, iter:{current_step:8,d}, lr:{lr_now:.3e}> "
                    + " ".join(f"{k}: {v:.4e}" for k, v in model.get_current_log().items())
                    + f" it/s:{1.0 / max(avg_it, 1e-9):.2f} eta:{eta / 3600:.2f}h")
                if tb_logger:
                    for k, v in model.get_current_log().items():
                        tb_logger.add_scalar(f"loss/{k}", v, current_step)
                    tb_logger.add_scalar("lr", lr_now, current_step)
                    tb_logger.add_scalar("time/iteration", avg_it, current_step)
                    tb_logger.add_scalar("time/data", avg_data, current_step)
                    tb_logger.add_scalar("eta_h", eta / 3600, current_step)

            dens = ((current_step > 50000 and current_step % 50 == 0)
                    or (current_step > 40000 and current_step % 100 == 0)
                    or (current_step > 30000 and current_step % 200 == 0))
            if (current_step % save_freq == 0 or dens) and main_rank:
                logger.info("Saving models and training states.")
                model.save(current_step)
                model.save_training(epoch, current_step)

            if current_step % val_freq == 0 and main_rank:
                psnr = validate(model, val_loader, opt, args.stage, current_step, logger, tb_logger)
                if psnr > best_psnr:
                    best_psnr = psnr
                    model.save(f"best_psnr_{current_step}")
            tick_tock.tick()

    # the loop leaves current_step one past the last update; the JAX loop labels
    # its final save with that count, the port with the updates made
    current_step = min(current_step, total_iters)
    if main_rank:
        model.save(current_step)
        model.save_training(epoch, current_step)
    if tb_logger:
        tb_logger.close()
    logger.info("End of training. Total time: %.1fs", time.time() - t_start)
    return model, current_step


def validate(model, val_loader, opt, stage, step, logger, tb_logger=None, n_max=4):
    """Mean PSNR (after the gray-mean adjustment) of the first ``n_max`` images,
    written to ``tb_logger`` as ``val/psnr``; stage 2 decodes its latent through
    the frozen VQGAN (``decode_latent``). ``opt`` is the JAX signature's; unread."""
    psnrs = []
    for i, batch in enumerate(val_loader):
        if i >= n_max:
            break
        gt = np.asarray(batch["GT"])[0]
        sr = model.get_sr(batch["LQ"])
        if stage == 2:
            sr = model.decode_latent(sr)
        sr = np.clip(sr.cpu().numpy()[0], 0, 1)
        if sr.shape != gt.shape:
            sr = sr[: gt.shape[0], : gt.shape[1]]
        psnrs.append(PSNR(gt, gray_mean_adjust(sr, gt)))
    mean_psnr = float(np.mean(psnrs)) if psnrs else float("nan")
    logger.info("# Validation # PSNR: %.4f (step %d)", mean_psnr, step)
    if tb_logger:
        tb_logger.add_scalar("val/psnr", mean_psnr, step)
    return mean_psnr


if __name__ == "__main__":
    main()
