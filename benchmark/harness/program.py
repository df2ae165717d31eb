"""The program side: the port's model built from a configuration and the seeded weights.

Everything here goes through the port's own entry points (``create_model``,
``load_state_dicts``); the configuration file supplies the values the program
reads from its conf, and under ``load_as`` the keyword that its generator's
weights are loaded by.
"""

from __future__ import annotations


def program_opt(cfg):
    """The conf values of ``cfg`` as the program's options dict (inference)."""
    opt = {"name": "benchmark", "model": cfg["model"], "scale": 1, "is_train": False, "heat": 0,
           "datasets": cfg["datasets"], "network_G": cfg["network_G"],
           "network_VQGAN": cfg["network_VQGAN"], "path": {}, "train": {"manual_seed": 10}}
    if "inference_dtype" in cfg:
        opt["inference_dtype"] = cfg["inference_dtype"]
    return opt


def build_model(cfg, state, device):
    """-> (model, opt): the port's model for ``cfg`` holding ``state`` (the
    reference's names, the checkpoint's)."""
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.options import dict_to_nonedict

    from .weights import split_state

    opt = dict_to_nonedict(program_opt(cfg))
    model = create_model(opt, device=str(device))
    g, hq = split_state(state)
    model.load_state_dicts(**{cfg["load_as"]: g, "vqgan_sd": hq})
    return model, opt
