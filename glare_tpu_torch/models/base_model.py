"""Base model: device choice and checkpoint IO (counterpart of
``glare_tpu/models/base_model.py``, inference half).

Network weights are torch ``state_dict`` files under the reference names
(``{iter}_G.pth``); training state comes with the training slices.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """'cuda' unless the caller asks for the CPU. Never falls back by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "glare_tpu_torch runs on an NVIDIA GPU and none is available; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU explicitly")
    return dev


class BaseModel:
    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.device = resolve_device(device)
        self.is_train = opt.get("is_train", False)

    @staticmethod
    def _torchify(path):
        """The confs name ``*.flax`` files of the JAX package; the port reads the
        ``*.pth`` beside them."""
        base, ext = os.path.splitext(path)
        return path if ext in (".pth", ".pkl", ".pt") else base + ".pth"

    @staticmethod
    def load_state_dict_file(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        return {k.replace("module.", "", 1) if k.startswith("module.") else k: v
                for k, v in sd.items()}

    def load_into(self, network, path, strict=True):
        """Load a torch ``state_dict`` file into ``network`` (shape-checked)."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        sd = self.load_state_dict_file(path)
        own = network.state_dict()
        sd = {k: v.to(own[k].dtype) if k in own else v for k, v in sd.items()}
        return network.load_state_dict(sd, strict=strict)

