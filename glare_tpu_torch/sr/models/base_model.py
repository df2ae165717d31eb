"""Base trainer of the stage-1 framework (counterpart of
``glare_tpu/sr/models/base_model.py``; reference: basicsr/models/base_model.py):
the device, the flat EMA, best-metric tracking, checkpoint and training-state
IO, and the loss dict.

Artifacts: ``net_{label}_{iter}.pth`` under ``path.models`` holds
``{"params": state_dict}`` (the generator also ``"params_ema"``), and
``{iter}.state`` under ``path.training_states`` the training state; the 2
newest states are kept.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Dict

import torch

from ...models.base_model import resolve_device
from ...parallel.mesh import cross_replica_mean, is_data_parallel
from ...utils.util import natsorted


class BaseSRModel:
    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.device = resolve_device(device)
        self.is_train = opt.get("is_train", True)
        self.log_dict: Dict[str, float] = {}
        self.best_metric_results: Dict[str, Any] = {}
        self._ema_net = self.ema_flat = None

    # ---------------- EMA ----------------

    def init_ema(self, net):
        """Keep a flat float32 average of every parameter of ``net``, frozen
        ones included, starting at their values."""
        self._ema_net = net
        self.ema_flat = self._flat_params().clone()

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float() for p in self._ema_net.parameters()])

    @torch.no_grad()
    def model_ema(self, decay=0.999):
        """``ema = ema * decay + params * (1 - decay)`` on the flat copy: one
        concatenation and one pass, not one launch per tensor."""
        self.ema_flat.mul_(decay).add_(self._flat_params(), alpha=1.0 - decay)

    @staticmethod
    @torch.no_grad()
    def model_ema_flat(params, ema_flat, decay=0.999):
        """The JAX package's functional form: the tensors ``params`` (in order)
        flattened into ``ema_flat``'s dtype -> a new ``ema_flat * decay + flat *
        (1 - decay)``."""
        flat = torch.cat([p.detach().reshape(-1) for p in params]).to(ema_flat.dtype)
        return ema_flat * decay + flat * (1 - decay)

    def ema_state_dict(self):
        """The average as a ``state_dict`` of the EMA'd network (its buffers as they are)."""
        sd, off = {}, 0
        params = dict(self._ema_net.named_parameters())
        for name, t in self._ema_net.state_dict().items():
            if name in params:
                n = t.numel()
                sd[name] = self.ema_flat[off:off + n].reshape(t.shape).to(t.dtype)
                off += n
            else:
                sd[name] = t
        return sd

    # ---------------- best-metric tracking ----------------

    def _initialize_best_metric_results(self, dataset_name):
        if dataset_name in self.best_metric_results:
            return
        record = {}
        for metric, content in self.opt["val"]["metrics"].items():
            better = content.get("better", "higher")
            init_val = float("-inf") if better == "higher" else float("inf")
            record[metric] = dict(better=better, val=init_val, iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val, current_iter):
        record = self.best_metric_results[dataset_name][metric]
        improved = val >= record["val"] if record["better"] == "higher" else val <= record["val"]
        if improved:
            record["val"] = val
            record["iter"] = current_iter
        return improved

    # ---------------- persistence ----------------

    def save_network(self, state_dicts, net_label, current_iter, param_keys=("params",)):
        """``net_{label}_{iter}.pth`` with one state dict per key, on the CPU;
        three tries (the reference's retry IO)."""
        if current_iter == -1:
            current_iter = "latest"
        os.makedirs(self.opt["path"]["models"], exist_ok=True)
        save_path = os.path.join(self.opt["path"]["models"], f"net_{net_label}_{current_iter}.pth")
        payload = {key: {k: v.detach().cpu() for k, v in sd.items()}
                   for key, sd in zip(param_keys, state_dicts)}
        for retry in range(3):
            try:
                torch.save(payload, save_path)
                break
            except OSError as e:
                print(f"Save model error: {e}, remaining retry times: {2 - retry}")
                time.sleep(1)
        return save_path

    @staticmethod
    def load_network_params(path, template, param_key="params", strict=True):
        """``path``'s ``param_key`` (else its ``params``) -> a ``state_dict`` of
        ``template``'s names (a module or a ``state_dict``). ``strict``: the file
        must hold exactly those names at their shapes; else the template's tensor
        stays where the file lacks the name or has another shape (the JAX
        package's loose merge)."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        sd = payload.get(param_key, payload.get("params", payload))
        own = template.state_dict() if isinstance(template, torch.nn.Module) else template
        if strict:
            bad = sorted(set(own) ^ set(sd)) + sorted(
                k for k in own if k in sd and tuple(sd[k].shape) != tuple(own[k].shape))
            if bad:
                raise RuntimeError(f"{path} does not match the network: {bad}")
        return {k: sd[k] if k in sd and tuple(sd[k].shape) == tuple(v.shape) else v
                for k, v in own.items()}

    @staticmethod
    def load_network(network, path, param_key="params", strict=True):
        """Load :meth:`load_network_params` of ``network`` into it."""
        return network.load_state_dict(
            BaseSRModel.load_network_params(path, network, param_key, strict), strict=True)

    def save_training_state(self, epoch, current_iter, state):
        d = self.opt["path"]["training_states"]
        os.makedirs(d, exist_ok=True)
        fn = os.path.join(d, f"{current_iter}.state")
        torch.save({"epoch": epoch, "iter": current_iter, "state": state}, fn)
        for old in natsorted(glob.glob(os.path.join(d, "*.state")))[:-2]:
            os.remove(old)
        return fn

    @staticmethod
    def load_training_state(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    def resume_training_state(self, path):
        """The JAX package's name: ``{epoch, iter, state}`` of a ``{iter}.state``."""
        return self.load_training_state(path)

    def reduce_loss_dict(self, loss_dict):
        """The losses, read lazily (see :class:`_LazyLossDict`); under data
        parallelism first averaged over the ranks in one all-reduce (reference:
        base_model.py:371-396), so that rank 0 logs the global losses."""
        if is_data_parallel():
            keys = [k for k, v in loss_dict.items() if torch.is_tensor(v)]
            if keys:
                vals = cross_replica_mean(torch.stack([loss_dict[k].detach().float().reshape(()) for k in keys]))
                loss_dict = {**loss_dict, **dict(zip(keys, vals))}
        return _LazyLossDict(loss_dict)

    def get_current_log(self):
        return self.log_dict


class _LazyLossDict(dict):
    """Loss dict whose device scalars become floats on the first value access, in
    one stacked transfer: a training iteration does not wait for the device
    unless the loop reads its losses (every ``print_freq`` iterations)."""

    def __init__(self, raw):
        super().__init__(raw)
        self._materialized = False

    def _materialize(self):
        if self._materialized:
            return
        self._materialized = True
        keys = [k for k in dict.keys(self) if torch.is_tensor(dict.__getitem__(self, k))]
        if keys:
            vals = torch.stack([dict.__getitem__(self, k).detach().float().reshape(()) for k in keys])
            for k, v in zip(keys, vals.tolist()):
                dict.__setitem__(self, k, v)
        for k in dict.keys(self):
            dict.__setitem__(self, k, float(dict.__getitem__(self, k)))

    def __getitem__(self, k):
        self._materialize()
        return dict.__getitem__(self, k)

    def __iter__(self):  # also makes dict(...) / update(...) read through __getitem__
        self._materialize()
        return dict.__iter__(self)

    def keys(self):
        self._materialize()
        return dict.keys(self)

    def get(self, k, default=None):
        self._materialize()
        return dict.get(self, k, default)

    def items(self):
        self._materialize()
        return dict.items(self)

    def values(self):
        self._materialize()
        return dict.values(self)

    def copy(self):
        self._materialize()
        return dict(dict.items(self))
