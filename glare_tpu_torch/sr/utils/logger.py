"""Training observability (the port's own copy of ``glare_tpu/sr/utils/logger.py``;
reference: basicsr/utils/logger.py): :class:`AvgTimer`, :class:`MessageLogger`
(epoch / iter / lr / time / eta, mirrored to tensorboard), the optional
tensorboard writer, the optional wandb run that syncs it, and the environment
banner. ``tensorboard`` and ``wandb`` are imported inside :func:`init_tb_logger`
and :func:`init_wandb_logger`."""

from __future__ import annotations

import datetime
import logging
import time


class AvgTimer:
    def __init__(self, window=200):
        self.window = window
        self.current_time = 0
        self.total_time = 0
        self.count = 0
        self.avg_time = 0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self):
        return self.current_time

    def get_avg_time(self):
        return self.avg_time


class MessageLogger:
    """Formats per-iteration training logs and mirrors them to tensorboard."""

    def __init__(self, opt, start_iter=1, tb_logger=None):
        self.exp_name = opt["name"]
        logger_opt = opt["logger"] or {}
        self.interval = logger_opt.get("print_freq", 100)
        self.start_iter = start_iter
        self.max_iters = (opt.get("train") or {}).get("total_iter", 0)
        self.use_tb_logger = bool(logger_opt.get("use_tb_logger"))
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = logging.getLogger("base")

    def __call__(self, log_vars):
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch")
        lrs = log_vars.pop("lrs", [])

        message = f"[{self.exp_name[:20]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        message += ", ".join(f"{v:.3e}" for v in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time", 0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(max(eta_sec, 0))))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f} ({data_time:.3f})] "

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger and self.use_tb_logger:
                key = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(key, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir):
    """A tensorboard ``SummaryWriter``, or None (with a warning) when the
    tensorboard package is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logging.getLogger("base").warning(
            "logger.use_tb_logger is set but tensorboard is not installed; logging to the "
            "text log only")
        return None
    return SummaryWriter(log_dir=log_dir)


def init_wandb_logger(opt):
    """Start a wandb run that syncs the tensorboard logs (reference: logger.py:126-143)
    -> its id; ``logger.wandb.resume_id`` resumes that run. Without the wandb package
    it logs the JAX package's warning and returns None: training goes on with
    tensorboard only."""
    logger = logging.getLogger("base")
    try:
        import wandb
    except ImportError:
        logger.warning("wandb logger requested (logger.wandb.project) but the wandb package is not "
                       "installed; continuing with tensorboard only")
        return None
    project = opt["logger"]["wandb"]["project"]
    resume_id = opt["logger"]["wandb"].get("resume_id")
    if resume_id:
        wandb_id, resume = resume_id, "allow"
        logger.warning(f"Resume wandb logger with id={wandb_id}.")
    else:
        wandb_id, resume = wandb.util.generate_id(), "never"
    wandb.init(id=wandb_id, resume=resume, name=opt["name"], config=opt, project=project,
               sync_tensorboard=True)
    logger.info(f"Use wandb logger with id={wandb_id}; project={project}.")
    return wandb_id


def get_env_info():
    import torch

    cuda = torch.cuda.is_available()
    return (
        "\nglare_tpu_torch stage-1 framework"
        f"\n\ttorch: {torch.__version__}"
        f"\n\tcuda: {torch.version.cuda if cuda else 'not available'}"
        f"\n\tdevices: {torch.cuda.device_count() if cuda else 0}"
        + (f" ({torch.cuda.get_device_name(0)})" if cuda else "")
    )
