"""Base model: device choice and checkpoint IO (counterpart of
``glare_tpu/models/base_model.py``).

Artifacts mirror the reference's two-file split:
  * ``{iter}_G.pth`` -- the network's ``state_dict`` under the reference names,
    which ``load_network`` and the inference CLIs load;
  * ``{iter}.state`` -- the training state ``{epoch, iter, state}`` (``state``:
    the trainable ``state_dict`` and the optimizer's ``state_dict``), only the
    2 newest kept (reference: base_model.py:188-219).
"""

from __future__ import annotations

import glob
import os

import torch

from ..utils.util import get_resume_paths, natsorted, opt_get


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
        self.log_dict = {}

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

    @staticmethod
    def load_params(path, template=None, strict=True):
        """A ``state_dict`` file -> its tensors. With a ``template`` (a module or a
        ``state_dict``): strict, the file must hold exactly its names at its
        shapes; not strict, the template's tensors are kept where the file lacks
        the name or has another shape (the JAX package's loose merge)."""
        sd = BaseModel.load_state_dict_file(path)
        if template is None:
            return sd
        if isinstance(template, torch.nn.Module):
            template = template.state_dict()
        if strict:
            missing, extra = sorted(set(template) - set(sd)), sorted(set(sd) - set(template))
            shapes = sorted(k for k in template if k in sd and sd[k].shape != template[k].shape)
            if missing or extra or shapes:
                raise RuntimeError(f"{path} does not match the template: missing {missing}, "
                                   f"unexpected {extra}, other shapes {shapes}")
        return {k: sd[k].to(v.dtype) if k in sd and sd[k].shape == v.shape else v
                for k, v in template.items()}

    def load_into(self, network, path, strict=True):
        """Load a torch ``state_dict`` file into ``network`` (:meth:`load_params`
        with the network as the template)."""
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return network.load_state_dict(self.load_params(path, network, strict=strict), strict=True)

    # ---------------- training checkpoints ----------------

    def save_network(self, network, network_label, iter_label):
        """``{iter}_{label}.pth`` under ``path.models``: the float32 ``state_dict``."""
        d = self.opt["path"]["models"]
        os.makedirs(d, exist_ok=True)
        fn = os.path.join(d, f"{iter_label}_{network_label}.pth")
        torch.save({k: v.detach().float().cpu() if v.is_floating_point() else v.cpu()
                    for k, v in network.state_dict().items()}, fn)
        return fn

    def save_training_state(self, epoch, iter_step, state):
        """``{iter}.state`` under ``path.training_state``; keeps the 2 newest."""
        d = self.opt["path"]["training_state"]
        os.makedirs(d, exist_ok=True)
        fn = os.path.join(d, f"{iter_step}.state")
        torch.save({"epoch": epoch, "iter": iter_step, "state": state}, fn)
        for old in natsorted(glob.glob(os.path.join(d, "*.state")))[:-2]:
            os.remove(old)
        return fn

    @staticmethod
    def load_training_state(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    def get_current_log(self):
        return self.log_dict

    def get_network_description(self, network=None):
        """-> (the model's class name, the parameter count of ``network``, netG by
        default), as the JAX package returns them."""
        network = self.netG if network is None else network
        return type(self).__name__, sum(p.numel() for p in network.parameters())

    def load(self):
        """The reference's start-up load: the ``{iter}_G`` beside the resume state
        when there is one (strict), else ``path.pretrain_model_G``, strict as the
        model's :meth:`_pretrain_strict` says (the JAX models' rules)."""
        _, resume_model = get_resume_paths(self.opt)
        if resume_model is not None and os.path.exists(self._torchify(resume_model)):
            self.load_network(resume_model, strict=True)
            return
        load_path_G = opt_get(self.opt, ["path", "pretrain_model_G"])
        if load_path_G and os.path.exists(self._torchify(load_path_G)):
            self.load_network(load_path_G, strict=self._pretrain_strict())

    def _pretrain_strict(self):
        return True

    # ---------------- training (a model with netG, optimizer, schedule, updates) ----------------

    def trainable_parameters(self):
        return [(n, p) for n, p in self.netG.named_parameters() if p.requires_grad]

    def _update(self):
        """Apply the optimizer at ``schedule(updates so far)`` (optax's count from 0)."""
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.updates += 1

    def save(self, iter_label):
        return self.save_network(self.netG, "G", iter_label)

    def save_training(self, epoch, iter_step):
        params = {n: p.detach().cpu() for n, p in self.trainable_parameters()}
        return self.save_training_state(epoch, iter_step, {"params": params, "updates": self.updates,
                                                           "optimizer": self.optimizer.state_dict()})

    def resume_training(self, path):
        """Restore the trainable weights and the optimizer from ``{iter}.state``
        -> (epoch, iter)."""
        payload = self.load_training_state(path)
        with torch.no_grad():
            own = dict(self.netG.named_parameters())
            for k, v in payload["state"]["params"].items():
                own[k].copy_(v)
        self.optimizer.load_state_dict(payload["state"]["optimizer"])
        self.updates = payload["state"]["updates"]
        return payload["epoch"], payload["iter"]
