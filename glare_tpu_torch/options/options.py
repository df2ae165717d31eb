"""YAML config system (the port's own copy of what inference needs from
``glare_tpu/options/options.py``).

  * ``parse(opt_path, is_train)`` -> nested dict; injects ``is_train``,
    per-phase ``phase``, ``scale``, ``data_type``; synthesizes the results path
    tree; expands relative LR milestones.
  * ``dict_to_nonedict`` wraps every nested dict in :class:`NoneDict`, whose
    missing keys read as ``None`` so feature flags can be probed by indexing.

``yaml`` is imported inside :func:`parse`, not at package import.
"""

from __future__ import annotations

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
