"""Stage-2 model wrapper, inference half (counterpart of
``glare_tpu/models/llflow_model.py``).

The stage-2 generator's output is a VQGAN *latent*: ``get_sr(lq)`` runs the
conditional encoder and the reverse flow, ``decode_latent`` sends the latent
through the frozen VQGAN (codebook retrieval + decoder). ``get_encode_nll`` is
the evaluation of the training objective: the negative log-likelihood, in bits
per latent pixel, of the ground truth's VQGAN latent under the flow.

Public tensors are ``[B, H, W, C]`` float32 like the JAX model's; inside they are
NCHW in channels_last memory. With ``inference_dtype: bfloat16`` the convolution
stacks (conditional encoder, VQGAN) run in bf16 and the flow in float32.

Not ported yet: the train step and the ActNorm data-dependent init.
"""

from __future__ import annotations

import os

import torch

from ..modules.llflow_vqgan2 import LLFlowVQGAN2
from ..nn.layers import cast_convs_, seed_init_
from ..utils.util import opt_get
from .base_model import BaseModel
from .networks import define_Flow, find_vqgan


def _nchw(x, device):
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1).contiguous()


class LLFlowModel(BaseModel):
    def __init__(self, opt, step=0, device="cuda"):
        super().__init__(opt, device=device)
        if self.is_train:
            raise NotImplementedError(
                "stage-2 training is not ported yet (optimizer, ActNorm data-dependent init); "
                "build the model with is_train=False")
        self.heats = opt_get(opt, ["val", "heats"])
        self.dtype = (torch.bfloat16 if opt.get("inference_dtype") == "bfloat16"
                      else torch.float32)
        self.netG = define_Flow(opt, step)
        assert isinstance(self.netG, LLFlowVQGAN2)
        self.net_hq = find_vqgan(opt)

        seed = int(opt_get(opt, ["train", "manual_seed"], 10) or 10)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        seed_init_(self.net_hq, gen)
        seed_init_(self.netG, gen)

        vq_path = opt_get(opt, ["path", "pretrained_vqgan"])
        if vq_path and os.path.exists(self._torchify(vq_path)):
            self.load_into(self.net_hq, self._torchify(vq_path), strict=False)
        self._finalize()

    def _finalize(self):
        """Move to the device, set eval mode, channels_last and the compute dtype."""
        for net in (self.netG, self.net_hq):
            net.to(self.device).eval().requires_grad_(False)
            net.to(memory_format=torch.channels_last)
        self.netG.set_compute_dtype(self.dtype)  # the flow stays float32
        cast_convs_(self.net_hq, self.dtype)

    def load_network(self, load_path, strict=True):
        """Load a stage-2 ``state_dict`` file (``{iter}_G.pth``) into netG."""
        cast_convs_(self.netG, torch.float32)
        res = self.load_into(self.netG, self._torchify(load_path), strict=strict)
        self._finalize()
        return res

    def load_state_dicts(self, stage2_sd=None, vqgan_sd=None):
        """Load in-memory state dicts (e.g. from ``convert.flax_to_torch_*``)."""
        cast_convs_(self.netG, torch.float32)
        cast_convs_(self.net_hq, torch.float32)
        if stage2_sd is not None:
            self.netG.load_state_dict(stage2_sd, strict=True)
        if vqgan_sd is not None:
            self.net_hq.load_state_dict(vqgan_sd, strict=True)
        self._finalize()

    # ---------------- eval ----------------

    @torch.inference_mode()
    def get_sr(self, lq, heat=None):
        """lq [B, H, W, 3] (log-domain low-light) -> VQGAN latent [B, H/4, W/4, 3]."""
        x, _ = self.netG.reverse_flow(_nchw(lq, self.device))
        return _nhwc(x)

    @torch.inference_mode()
    def decode_latent(self, latent):
        """latent [B, h, w, 3] -> image [B, 4h, 4w, 3] through the frozen VQGAN."""
        dec, _, _ = self.net_hq.decode(_nchw(latent, self.device))
        return _nhwc(dec)

    @torch.inference_mode()
    def encode_gt_latent(self, gt):
        """gt image [B, H, W, 3] -> its VQGAN latent [B, H/4, W/4, 3] (pre-quantization)."""
        h, _ = self.net_hq.encode(_nchw(gt, self.device))
        return _nhwc(h)

    @torch.inference_mode()
    def get_encode_nll(self, lq, gt):
        gt_latent = _nchw(self.encode_gt_latent(gt), self.device)
        _, nll, _ = self.netG.normal_flow(gt_latent, _nchw(lq, self.device))
        return float(nll.mean())
