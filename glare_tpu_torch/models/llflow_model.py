"""Stage-2 model wrapper (counterpart of ``glare_tpu/models/llflow_model.py``).

The stage-2 generator's output is a VQGAN *latent*: ``get_sr(lq)`` runs the
conditional encoder and the reverse flow, ``decode_latent`` sends the latent
through the frozen VQGAN (codebook retrieval + decoder). ``get_encode_nll`` is
the evaluation of the training objective: the negative log-likelihood, in bits
per latent pixel, of the ground truth's VQGAN latent under the flow.

Public tensors are ``[B, H, W, C]`` float32 like the JAX model's; inside they are
NCHW in channels_last memory. With ``inference_dtype: bfloat16`` the convolution
stacks (conditional encoder, VQGAN) run in bf16 and the flow in float32.

Training (``is_train``), the JAX model's step:
    gt_latent = no_grad(vq.encode(GT))          (the encoder + quant_conv, no codebook)
    loss = weight_fl * mean(nll(flow.encode(gt_latent, cond=ConEncoder1(LQ))))
with the whole generator trainable in float32 and the VQGAN frozen. Adam
(beta1, beta2 from the conf, eps 1e-8) in two groups, as the JAX optax
``multi_transform``: ``RRDB.*`` (the conditional encoder) with decoupled weight
decay 1e-5, the flow with ``weight_decay_G``; AdamW's decoupled decay is optax's
``scale_by_adam -> add_decayed_weights -> schedule`` chain, at ``schedule(k)`` on
its k-th update. ``initialize_actnorm`` runs the ActNorm data-dependent init
once, on the first batch, before the first step; ``load_network`` and
``resume_training`` mark it done.

Data parallelism (the JAX model's mesh switch): when a ``torch.distributed`` group
of more than one rank is up and ``opt["use_dp"]`` is not false, every rank is
handed the same global batch and trains on its block (``shard_batch``; the whole
batch when it does not divide), the flow runs under ``DistributedDataParallel``,
and the ActNorm init takes its statistics over the whole batch (all-reduced sums,
as JAX's SPMD init sees the global batch), not over the rank's block.
"""

from __future__ import annotations

import functools
import logging
import os

import torch

from ..modules.flow_layers import ActNorm2d
from ..modules.llflow_vqgan2 import LLFlowVQGAN2
from ..nn.layers import cast_convs_, seed_init_
from ..parallel.mesh import cross_replica_mean, is_data_parallel, make_dp_train_step, shard_batch
from ..utils.util import opt_get
from .base_model import BaseModel
from .lr_scheduler import build_schedule
from .networks import define_Flow, find_vqgan

RRDB_WEIGHT_DECAY = 1e-5  # the conditional encoder's group (reference: LLFlow_model.py:90-121)


def _nchw(x, device):
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1).contiguous()


def _label_params(netG):
    """{name: 'rrdb' for the conditional encoder's parameters, 'other' for the flow's}."""
    return {n: "rrdb" if n.split(".", 1)[0] == "RRDB" else "other"
            for n, _ in netG.named_parameters()}


class LLFlowModel(BaseModel):
    def __init__(self, opt, step=0, device="cuda"):
        super().__init__(opt, device=device)
        self.heats = opt_get(opt, ["val", "heats"])
        # training keeps float32 parameters and float32 math, as the JAX model does
        self.dtype = (torch.bfloat16 if not self.is_train and opt.get("inference_dtype") == "bfloat16"
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
        self._actnorm_inited = False
        self._finalize()
        self.dp = None   # the DDP wrapper of netG under data parallelism
        if self.is_train:
            self._build_optimizer(opt.get("train") or {})
            if is_data_parallel() and opt.get("use_dp") is not False:
                for m in self.netG.modules():
                    if isinstance(m, ActNorm2d):
                        m.stats_over_ranks = True
                self.dp = make_dp_train_step(self.netG)

    def _finalize(self):
        """Move to the device, channels_last and the compute dtype. Inference: eval
        mode, no gradients. Training: netG float32 and trainable, the VQGAN frozen."""
        for net in (self.netG, self.net_hq):
            net.to(self.device).eval().requires_grad_(False)
            net.to(memory_format=torch.channels_last)
        self.netG.set_compute_dtype(self.dtype)  # the flow stays float32
        cast_convs_(self.net_hq, self.dtype)
        if self.is_train:
            self.netG.train().requires_grad_(True)

    def load_network(self, load_path, strict=True):
        """Load a stage-2 ``state_dict`` file (``{iter}_G.pth``) into netG."""
        cast_convs_(self.netG, torch.float32)
        res = self.load_into(self.netG, self._torchify(load_path), strict=strict)
        self._finalize()
        self._actnorm_inited = True
        return res

    def _pretrain_strict(self):
        # load(): pretrain_model_G as path.strict_load says (default strict)
        return bool((self.opt.get("path") or {}).get("strict_load", True))

    def load_state_dicts(self, stage2_sd=None, vqgan_sd=None):
        """Load in-memory state dicts (e.g. from ``convert.flax_to_torch_*``)."""
        cast_convs_(self.netG, torch.float32)
        cast_convs_(self.net_hq, torch.float32)
        if stage2_sd is not None:
            self.netG.load_state_dict(stage2_sd, strict=True)
        if vqgan_sd is not None:
            self.net_hq.load_state_dict(vqgan_sd, strict=True)
        self._finalize()

    # ---------------- train ----------------

    def _build_optimizer(self, train_opt):
        """AdamW in two groups (``_label_params``): 'rrdb' with decay 1e-5, 'other'
        with ``weight_decay_G``; betas (beta1, beta2) as the JAX model honours
        them (the reference's torch Adam silently ran (0.9, 0.999))."""
        self.schedule = build_schedule(train_opt)
        labels = _label_params(self.netG)
        groups = [{"params": [p for n, p in self.trainable_parameters() if labels[n] == label],
                   "weight_decay": wd, "label": label}
                  for label, wd in (("other", float(train_opt.get("weight_decay_G") or 0)),
                                    ("rrdb", RRDB_WEIGHT_DECAY))]
        self.optimizer = torch.optim.AdamW(
            groups, lr=self.schedule(0),
            betas=(float(train_opt.get("beta1") or 0.9), float(train_opt.get("beta2") or 0.99)),
            eps=1e-8)
        self.updates = 0  # updates applied: optax's count, the schedule's argument
        self.weight_fl = float(opt_get(self.opt, ["train", "weight_fl"], 1) or 1)
        self.weight_l1 = float(opt_get(self.opt, ["train", "weight_l1"], 0) or 0)
        if self.weight_l1:
            logging.getLogger("base").warning(
                "stage-2 training: train.weight_l1 = %g is ignored; the loss is weight_fl * "
                "mean(nll), as in the JAX package", self.weight_l1)

    def _encode_gt(self, gt):
        """gt [B, H, W, 3] -> its VQGAN latent, NCHW, without a graph (the JAX
        step's ``stop_gradient``; an ordinary tensor, unlike ``inference_mode``'s)."""
        with torch.no_grad():
            h, _ = self.net_hq.encode(_nchw(gt, self.device))
        return h

    def _put_batch(self, x):
        """Under data parallelism the rank's block of the global batch ``x``."""
        return x if self.dp is None else shard_batch(x)

    def initialize_actnorm(self, batch):
        """The ActNorm data-dependent init on ``batch`` = {"LQ", "GT"}: one
        ``normal_flow(ddinit=True)`` without a graph (under data parallelism on the
        rank's block, with statistics over the whole batch). Runs once."""
        if self._actnorm_inited:
            return
        with torch.no_grad():
            self.netG.normal_flow(self._encode_gt(self._put_batch(batch["GT"])),
                                  _nchw(self._put_batch(batch["LQ"]), self.device), ddinit=True)
        self._actnorm_inited = True

    def train_loss(self, lq, gt):
        """weight_fl * mean(nll) on one batch, with the graph. lq, gt [B, H, W, 3]
        (under data parallelism the global batch, of which this rank takes its block)."""
        flow = self.netG.normal_flow if self.dp is None else functools.partial(self.dp, "normal_flow")
        _, nll, _ = flow(self._encode_gt(self._put_batch(gt)), _nchw(self._put_batch(lq), self.device))
        return self.weight_fl * nll.mean()

    def optimize_parameters(self, batch, step=None):
        """One training step on ``batch`` = {"LQ", "GT"} (the ActNorm init first, on
        the first batch): the loss, its gradients, the update at
        ``schedule(updates so far)``. -> the loss."""
        if not self._actnorm_inited:
            self.initialize_actnorm(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.train_loss(batch["LQ"], batch["GT"])
        loss.backward()
        self._update()
        loss = loss.detach() if self.dp is None else cross_replica_mean(loss.detach())
        self.log_dict = {"nll_loss": float(loss)}
        return self.log_dict["nll_loss"]

    def resume_training(self, path):
        """Restore netG and the optimizer from ``{iter}.state`` -> (epoch, iter); the
        ActNorms were initialized by the run that saved it."""
        epoch_iter = super().resume_training(path)
        self._actnorm_inited = True
        return epoch_iter

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

    def encode_gt_latent(self, gt):
        """gt image [B, H, W, 3] -> its VQGAN latent [B, H/4, W/4, 3] (pre-quantization)."""
        return _nhwc(self._encode_gt(gt))

    @torch.inference_mode()
    def get_encode_nll(self, lq, gt):
        _, nll, _ = self.netG.normal_flow(self._encode_gt(gt), _nchw(lq, self.device))
        return float(nll.mean())
