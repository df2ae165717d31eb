"""Stage-1 option parsing (the port's own copy of ``glare_tpu/sr/utils/options.py``;
reference: basicsr/utils/options.py).

``-opt CONF`` (YAML), ``--auto_resume``, ``--debug`` (a ``debug_`` name prefix
and dense print / save / validation cadence) and ``--device`` (``cuda``, the
default, or ``cpu``; ``opt["device"]``). One process on one device: the JAX
``--launcher`` / ``--local_rank`` flags and the seed's rank offset belong to
data parallelism, which the port does not have yet. The experiment tree goes
under ``$GLARE_ROOT`` (default: the working directory). ``yaml`` is imported
inside :func:`ordered_yaml_load`.
"""

from __future__ import annotations

import argparse
import os
import random

from ...options.options import _ordered_loader, dict_to_nonedict


def ordered_yaml_load(path):
    yaml, loader = _ordered_loader()
    with open(path, "r") as f:
        return yaml.load(f, Loader=loader)


def parse_options(root_path=None, is_train=True, argv=None):
    """-> (opt as a ``NoneDict`` tree, argparse namespace)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    root_path = root_path or os.environ.get("GLARE_ROOT", os.getcwd())

    opt = ordered_yaml_load(args.opt)
    opt["device"] = args.device
    if opt.get("manual_seed") is None:
        opt["manual_seed"] = random.randint(1, 10000)
    opt["auto_resume"] = args.auto_resume
    opt["is_train"] = is_train
    if args.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]

    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        if "scale" in opt:
            dataset["scale"] = opt["scale"]

    opt["path"] = opt.get("path") or {}
    if is_train:
        experiments_root = os.path.join(root_path, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = os.path.join(experiments_root, "models")
        opt["path"]["training_states"] = os.path.join(experiments_root, "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = os.path.join(experiments_root, "visualization")
        if args.debug:
            opt["val"] = opt.get("val") or {}
            opt["val"]["val_freq"] = 8
            opt["logger"] = opt.get("logger") or {}
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(root_path, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = os.path.join(results_root, "visualization")

    return dict_to_nonedict(opt), args
