"""General utilities (the port's own copy of what inference and training need
from ``glare_tpu/utils/util.py``): option probing, natural sort, experiment
directories, the training logger, seeds, resume-state discovery and a one-time
tree copy."""

from __future__ import annotations

import glob
import logging
import os
import random
import re
import shutil
import sys
from datetime import datetime

import numpy as np


def opt_get(opt, keys, default=None):
    """Nested-key probe: ``opt_get(opt, ['network_G', 'flow', 'K'], 12)``."""
    if opt is None:
        return default
    ret = opt
    for k in keys:
        ret = ret.get(k, None) if hasattr(ret, "get") else None
        if ret is None:
            return default
    return ret


_NAT_SPLIT = re.compile(r"(\d+)")


def natsorted(items, key=None):
    """Natural sort (stands in for the natsort package of the reference CLIs)."""

    def natkey(s):
        s = key(s) if key is not None else s
        return [int(t) if t.isdigit() else t.lower() for t in _NAT_SPLIT.split(str(s))]

    return sorted(items, key=natkey)


def get_timestamp():
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdir(path):
    os.makedirs(path, exist_ok=True)


def mkdirs(paths):
    if isinstance(paths, str):
        mkdir(paths)
    else:
        for path in paths:
            mkdir(path)


def mkdir_and_rename(path):
    """Archive an existing experiment dir by renaming it, never clobber it."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        print(f"Path already exists. Rename it to [{new_name}]")
        logging.getLogger("base").info("Path already exists. Rename it to [%s]", new_name)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def set_random_seed(seed):
    """Seeds Python's and numpy's generators (the data pipeline's) and torch's."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_logger(logger_name, root, phase, level=logging.INFO, screen=False, tofile=False):
    """Named logger to the screen and / or a file under ``root``."""
    lg = logging.getLogger(logger_name)
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                                  datefmt="%y-%m-%d %H:%M:%S")
    lg.setLevel(level)
    lg.propagate = False
    if tofile:
        fh = logging.FileHandler(os.path.join(root, phase + f"_{get_timestamp()}.log"), mode="w")
        fh.setFormatter(formatter)
        lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg


def get_resume_paths(opt):
    """``path.resume_state: auto`` -> the newest state in ``path.training_state``
    and the ``{iter}_G`` beside it under ``models``; else ``path.resume_state``."""
    path = opt.get("path") or {}
    ts = opt_get(opt, ["path", "training_state"])
    if path.get("resume_state", None) == "auto" and ts is not None:
        paths = natsorted(glob.glob(os.path.join(ts, "*")))
        if paths:
            state = paths[-1]
            return state, state.replace("training_state", "models").replace(".state", "_G")
        return None, None
    return path.get("resume_state"), None


def copy_tree_once(src, dst):
    """Copy the directory ``src`` to ``dst`` unless ``dst`` exists."""
    if not os.path.exists(dst):
        shutil.copytree(src, dst)
