"""Stage-1 option parsing (the port's own copy of ``glare_tpu/sr/utils/options.py``;
reference: basicsr/utils/options.py).

``-opt CONF`` (YAML), ``--auto_resume``, ``--debug`` (a ``debug_`` name prefix
and dense print / save / validation cadence), ``--device`` (``cuda``, the
default, or ``cpu``; ``opt["device"]``) and the JAX package's
``--launcher {none, pytorch, slurm, jax}`` / ``--local_rank`` / ``--force_yml
a:b=value`` (a conf value overridden, read as YAML). ``pytorch`` joins
the process group of ``torchrun``'s environment (``parallel.init_distributed``:
NCCL on the card, gloo on the CPU); ``slurm`` first maps ``SLURM_PROCID``,
``SLURM_NTASKS`` and ``SLURM_LOCALID`` onto that environment; ``jax`` names the
JAX package's multi-host initialisation and raises. ``opt["rank"]`` /
``opt["world_size"]`` are set, each rank takes its own card
(``LOCAL_RANK``), and the seed is offset by the rank (reference:
options.py:108-114). ``num_gpu: auto`` becomes the number of cards this process
sees (1 with ``--device cpu``). The experiment tree goes under ``$GLARE_ROOT``
(default: the working directory). ``yaml`` is imported inside :func:`ordered_yaml_load`.
"""

from __future__ import annotations

import argparse
import os
import random

import torch

from ...options.options import _ordered_loader, dict_to_nonedict
from ...parallel.mesh import init_distributed, local_device


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
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm", "jax"], default="none")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Force to update yml files. Examples: train:ema_decay=0.999")
    args = parser.parse_args(argv)
    root_path = root_path or os.environ.get("GLARE_ROOT", os.getcwd())

    opt = ordered_yaml_load(args.opt)
    opt["device"] = args.device
    opt["dist"] = args.launcher != "none"
    opt["rank"], opt["world_size"] = 0, 1
    if args.launcher == "jax":
        raise ValueError("--launcher jax is the JAX package's multi-host initialisation; the port "
                         "runs one process per card: start it with torchrun and --launcher pytorch")
    if opt["dist"]:
        if args.launcher == "slurm":
            for var, slurm in (("RANK", "SLURM_PROCID"), ("WORLD_SIZE", "SLURM_NTASKS"),
                               ("LOCAL_RANK", "SLURM_LOCALID")):
                if slurm in os.environ:
                    os.environ.setdefault(var, os.environ[slurm])
        os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
        opt["rank"], opt["world_size"] = init_distributed(args.device)
        opt["device"] = str(local_device(args.device))
    seed = opt.get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
    opt["manual_seed"] = seed + opt["rank"]
    if args.force_yml:   # "a:b:c=value", the value read as YAML
        import yaml

        for entry in args.force_yml:
            keys, value = (t.strip() for t in entry.split("="))
            try:
                value = yaml.safe_load(value)
            except Exception:
                pass
            *path, last = keys.split(":")
            node = opt
            for key in path:
                node = node[key]
            node[last] = value
    opt["auto_resume"] = args.auto_resume
    opt["is_train"] = is_train
    if args.debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    if opt.get("num_gpu") == "auto":   # the cards this process sees; 1 on the CPU
        opt["num_gpu"] = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1

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
