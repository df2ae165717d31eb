"""Filesystem and format helpers (the port's own copy of
``glare_tpu/sr/utils/misc.py``; reference: basicsr/utils/misc.py).
``mkdir_and_rename`` and ``set_random_seed`` are the port's
``glare_tpu_torch.utils.util`` ones, re-exported."""

from __future__ import annotations

import os
import time
from os import path as osp

from ...utils.util import mkdir_and_rename, set_random_seed  # noqa: F401


def get_time_str():
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def make_exp_dirs(opt):
    """Create the experiment (or results) tree, archiving an existing root."""
    path_opt = opt["path"].copy()
    if opt["is_train"]:
        mkdir_and_rename(path_opt.pop("experiments_root"))
    else:
        mkdir_and_rename(path_opt.pop("results_root"))
    for key, path in path_opt.items():
        if ("strict_load" in key or "pretrain_network" in key or "resume" in key
                or "param_key" in key):
            continue
        if isinstance(path, str):
            os.makedirs(path, exist_ok=True)


def scandir(dir_path, suffix=None, recursive=False, full_path=False):
    """Generator over the files under ``dir_path``, filtered by suffix."""
    if (suffix is not None) and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')

    root = dir_path

    def _scandir(dir_path):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                return_path = entry.path if full_path else osp.relpath(entry.path, root)
                if suffix is None or return_path.endswith(suffix):
                    yield return_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path)

    return _scandir(dir_path)


def check_resume(opt, resume_iter):
    """Point every ``pretrain_network_*`` at the resume iteration's checkpoint and
    read ``params`` where ``params_ema`` was asked for."""
    if not opt["path"].get("resume_state"):
        return
    networks = [key for key in opt.keys() if key.startswith("network_")]
    if any(opt["path"].get(f"pretrain_{n}") is not None for n in networks):
        print("pretrain_network path will be ignored during resuming.")
    ignore = opt["path"].get("ignore_resume_networks") or []
    for network in networks:
        if network in ignore:
            continue
        basename = network.replace("network_", "")
        name = f"pretrain_{network}"
        opt["path"][name] = osp.join(opt["path"]["models"], f"net_{basename}_{resume_iter}.pth")
        print(f"Set {name} to {opt['path'][name]}")
    for param_key in [k for k in opt["path"] if k.startswith("param_key")]:
        if opt["path"][param_key] == "params_ema":
            opt["path"][param_key] = "params"
            print(f"Set {param_key} to params")


def sizeof_fmt(size, suffix="B"):
    """Human-readable file size."""
    for unit in ["", "K", "M", "G", "T", "P", "E", "Z"]:
        if abs(size) < 1024.0:
            return f"{size:3.1f} {unit}{suffix}"
        size /= 1024.0
    return f"{size:3.1f} Y{suffix}"
