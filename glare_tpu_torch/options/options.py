"""YAML config system (the port's own copy of what inference and training need
from ``glare_tpu/options/options.py``).

  * ``parse(opt_path, is_train)`` -> nested dict; injects ``is_train``,
    per-phase ``phase``, ``scale``, ``data_type``; synthesizes the results path
    tree; expands relative LR milestones.
  * ``dict_to_nonedict`` wraps every nested dict in :class:`NoneDict`, whose
    missing keys read as ``None`` so feature flags can be probed by indexing.
  * ``dict2str`` renders an option tree for the training log.
  * ``save_opt`` writes an option tree as plain YAML.
  * ``check_resume`` points ``pretrain_model_G`` at the resume iteration's
    ``{iter}_G`` when a state file is resumed.

``yaml`` is imported inside :func:`parse` and :func:`save_opt`, not at package
import.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from collections import OrderedDict


def _ordered_loader():
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Loader.add_constructor(yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, dict_constructor)
    return yaml, Loader


class NoneDict(dict):
    """dict whose missing keys read as None."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def parse(opt_path, is_train=True):
    yaml, Loader = _ordered_loader()
    with open(opt_path, mode="r") as f:
        opt = yaml.load(f, Loader=Loader)

    opt["is_train"] = is_train
    if "scale" not in opt:
        opt["scale"] = 1
    scale = opt["scale"]

    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = scale
        is_lmdb = False
        for key in ("dataroot_GT", "dataroot_LQ"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])
                is_lmdb = is_lmdb or dataset[key].endswith("lmdb")
        dataset["data_type"] = "lmdb" if is_lmdb else "img"

    opt.setdefault("path", {})
    for key, path in opt["path"].items():
        if path and "resume" not in key and "strict" not in key and "pretrain" not in key:
            opt["path"][key] = osp.expanduser(path)
    opt["path"]["root"] = os.environ.get("GLARE_ROOT", os.getcwd())

    if is_train:
        experiments_root = osp.join(opt["path"]["root"], "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(opt["path"]["root"], "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    if "network_G" in opt:
        opt["network_G"]["scale"] = scale

    train = opt.get("train")
    if train is not None:
        niter = train.get("niter")
        for rel, absolute in (("T_period_rel", "T_period"), ("restarts_rel", "restarts"),
                              ("lr_steps_rel", "lr_steps"),
                              ("lr_steps_inverse_rel", "lr_steps_inverse")):
            if train.get(rel) is not None:
                train[absolute] = [int(x * niter) for x in train[rel]]
    return opt


def dict2str(opt, indent_l=1):
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


def save_opt(opt, path):
    """``opt`` (nested dicts, NoneDicts, lists, tuples) as block-style YAML of plain
    dicts and lists at ``path``."""
    import yaml

    with open(path, "w") as f:
        yaml.dump(_plain(opt), f, default_flow_style=False)


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_plain(v) for v in o]
    return o


def check_resume(opt, resume_iter):
    """With ``path.resume_state`` set, ``path.pretrain_model_G`` becomes
    ``models/{resume_iter}_G`` (a pretrain path given beside it is ignored, with a
    warning); reference: options.py:116-130."""
    logger = logging.getLogger("base")
    if opt["path"].get("resume_state"):
        if opt["path"].get("pretrain_model_G") or opt["path"].get("pretrain_model_D"):
            logger.warning("pretrain_model paths will be ignored when resuming training.")
        opt["path"]["pretrain_model_G"] = osp.join(opt["path"]["models"], f"{resume_iter}_G")
        logger.info("Set [pretrain_model_G] to %s", opt["path"]["pretrain_model_G"])
