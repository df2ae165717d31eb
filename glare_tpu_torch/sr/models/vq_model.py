"""Stage-1 codebook trainer: the GAN-trained weighted-VQ autoencoder
(counterpart of ``glare_tpu/sr/models/vq_model.py``; reference:
basicsr/models/dehaze_vq_model.py, registered ``VQDehazeModel``).

HQ stage: the codebook autoencoder on normal-light images with codebook +
pixel + perceptual (+ semantic) + GAN losses against ``UNetDiscriminatorSN``,
which judges the quantized latent. LQ stage (``network_g.LQ_stage``): the
generator with Swin blocks and the residual warp decoder, supervised by the GT
indices of a frozen HQ network (``net_hq``); ``frozen_module_keywords`` freezes
the matching generator tensors.

One iteration (:meth:`optimize_parameters`), as the JAX model's:
  1. the g step, against the discriminator as it stood before the iteration
     (its ``u`` not updated; the GAN term from ``current_iter >
     net_d_init_iters``);
  2. ``z_gt``: the GT's quantized latent by the generator AFTER its update (HQ)
     or by ``net_hq`` (LQ, the same forward that gave the GT indices);
  3. the d step, real = ``z_gt``, fake = the g step's ``z_q`` (detached), the
     spectral ``u`` updated by the real forward only; skipped under
     ``train.fixed_disc``;
  4. the flat EMA of the generator.
Adam (AdamW with ``weight_decay``) at the conf's lr, betas (0.9, 0.99) by
default, eps 1e-8, constant lr (the JAX model builds no scheduler).
Tensors: batches are NHWC in [0, 1]; the networks run NCHW in channels_last.

Data parallelism (``sr.train --launcher pytorch``): each rank trains on its own
batch (the sampler's indices), from rank 0's weights; after each backward the
gradients of both networks are averaged over the ranks explicitly
(``parallel.average_gradients``), not by DDP: the discriminator runs twice before
one backward in the d step and once more inside the g step, only the d step's
real forward stores the spectral ``u``, and the LQ stage's frozen tensors have no
gradient. The losses are the ranks' mean (``reduce_loss_dict``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ...models.base_model import BaseModel
from ...nn.layers import seed_init_
from ...parallel.mesh import average_gradients, is_data_parallel, replicate
from ...utils.util import opt_get
from ..archs import build_network
from ..losses import build_loss
from ..registry import MODEL_REGISTRY
from .base_model import BaseSRModel


def is_frozen(name, keywords):
    """Whether the tensor ``name`` (a dotted ``state_dict`` name) is frozen by
    ``keywords``: one of its components contains a keyword. The JAX model tests
    each key of the flax tree the same way, so keywords that name the
    generator's modules (``quantize``, ``after_quant_group``, ``decoder_group``,
    ``out_conv``, ``multiscale_encoder``, ...) freeze the same tensors in both
    packages."""
    return any(kw in part for part in name.split(".") for kw in keywords)


def _make_optimizer(o, params):
    o = dict(o)
    t = o.pop("type", "Adam")
    if t.lower() not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {t}: Adam and AdamW are ported")
    lr = float(o.pop("lr", 1e-4))
    betas = tuple(float(b) for b in o.pop("betas", (0.9, 0.99)))
    wd = float(o.pop("weight_decay", 0) or 0)
    if wd:
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)


def _pretrain_path(path):
    """The conf's checkpoint as the port reads it (``*.flax`` -> the ``.pth`` beside
    it), or None when there is none."""
    path = BaseModel._torchify(path) if path else None
    return path if path and os.path.exists(path) else None


def semantic_loss(vgg, net_g, src, z_q, weight):
    """The semantic cluster loss: ``weight * mse(net_g.semantic_embed(z_q), f)``,
    f = the VGG16 relu3_3 features of ``src`` (no gradient), resized (bilinear,
    antialiased, as ``jax.image.resize``) to the embedding's size where they differ."""
    with torch.no_grad():
        feat = vgg(src)[-1]
    sem = net_g.semantic_embed(z_q)
    if feat.shape[-2:] != sem.shape[-2:]:
        feat = F.interpolate(feat, size=sem.shape[-2:], mode="bilinear", align_corners=False, antialias=True)
    return torch.mean((sem - feat.to(sem.dtype)) ** 2) * weight


@MODEL_REGISTRY.register()
class VQDehazeModel(BaseSRModel):
    def __init__(self, opt, device="cuda"):
        super().__init__(opt, device=device)
        self.generator = torch.Generator(device="cpu").manual_seed(int(opt.get("manual_seed") or 0))
        self.net_g = self._build(opt["network_g"])
        self.LQ_stage = bool(opt["network_g"].get("LQ_stage", False))
        self.net_hq = None
        paths = opt.get("path") or {}
        if self.LQ_stage:
            self.net_hq = self._build({**opt["network_g"], "LQ_stage": False})
            hq_path = _pretrain_path(paths.get("pretrain_network_hq"))
            if hq_path:
                self.load_network(self.net_hq, hq_path, strict=False)
                self.load_network(self.net_g, hq_path, strict=False)
            self.net_hq.requires_grad_(False).eval()
        g_path = _pretrain_path(paths.get("pretrain_network_g"))
        if g_path:
            self.load_network(self.net_g, g_path, strict=False)
        self.ema_decay = 0.0
        if self.is_train:
            self._init_training()
        if self.ema_decay > 0:
            self.init_ema(self.net_g)

    def _build(self, net_opt):
        net = build_network(net_opt)
        seed_init_(net, self.generator)
        return net.to(self.device, memory_format=torch.channels_last)

    def _nchw(self, x):
        """NHWC batch -> NCHW channels_last on the device, in the generator's dtype."""
        x = torch.as_tensor(x, dtype=self.net_g.out_conv.weight.dtype, device=self.device)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    # ---------------- training setup ----------------

    def _init_training(self):
        train_opt = self.opt["train"]
        self.net_d = self._build(self.opt["network_d"])
        self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        self.cri_perceptual = None
        if train_opt.get("perceptual_opt"):
            self.cri_perceptual = build_loss(train_opt["perceptual_opt"]).to(self.device)
        self.cri_gan = build_loss(train_opt["gan_opt"]) if train_opt.get("gan_opt") else None
        self.semantic_w, self.semantic_vgg = 0.0, None
        if train_opt.get("semantic_opt") and self.opt["network_g"].get("use_semantic_loss"):
            from ...modules.losses import VGG16Features, load_vgg16_params

            self.semantic_w = float(train_opt["semantic_opt"].get("loss_weight", 0.1))
            self.semantic_vgg = VGG16Features()
            self.semantic_vgg.load_state_dict(load_vgg16_params())
            self.semantic_vgg.to(self.device).requires_grad_(False).eval()
        gan_opt = train_opt.get("gan_opt") or {}
        self.use_dis = bool(gan_opt and gan_opt.get("loss_weight", 0) != 0)
        self.net_d_init_iters = train_opt.get("net_d_init_iters", 0) or 0
        self.codebook_w = opt_get(train_opt, ["codebook_opt", "loss_weight"], 1.0) or 1.0
        # the reference's default and meaning: 0 (or unset) keeps no average
        self.ema_decay = float(train_opt.get("ema_decay") or 0)

        keywords = self.opt["network_g"].get("frozen_module_keywords") or []
        if self.LQ_stage and keywords:
            for name, p in self.net_g.named_parameters():
                if is_frozen(name, keywords):
                    p.requires_grad_(False)
        self.optimizer_g = _make_optimizer(train_opt["optim_g"], self.trainable_parameters())
        self.optimizer_d = _make_optimizer(train_opt["optim_d"], list(self.net_d.parameters()))
        # data parallelism: rank 0's weights everywhere (the seed is offset by the
        # rank), then each step's gradients averaged explicitly over the ranks
        self.dp = is_data_parallel() and self.opt.get("use_dp") is not False
        if self.dp:
            replicate(self.net_g)
            replicate(self.net_d)

    def trainable_parameters(self):
        return [p for p in self.net_g.parameters() if p.requires_grad]

    # ---------------- one iteration ----------------

    def g_losses(self, lq, gt, use_gan_now):
        """The generator's losses on NCHW ``lq`` / ``gt`` with the graph ->
        (total, {name: loss}, z_q, the GT's quantized latent by ``net_hq`` or None)."""
        z_hq = None
        if self.LQ_stage:
            with torch.no_grad():
                _, _, _, _, z_hq, gt_indices = self.net_hq.encode_and_decode(gt, quantize_only=True)
            out, out_res, l_codebook, _, z_q, _ = self.net_g.encode_and_decode(lq, gt_indices=gt_indices)
        else:
            out, out_res, l_codebook, _, z_q, _ = self.net_g.encode_and_decode(gt)
        rec = out_res if out_res is not None else out
        total = self.codebook_w * l_codebook
        losses = {"l_codebook": total}
        if self.cri_pix is not None:
            losses["l_pix"] = self.cri_pix(rec, gt)
            total = total + losses["l_pix"]
        if self.cri_perceptual is not None:
            l_percep, l_style = self.cri_perceptual(rec, gt)
            for key, val in (("l_percep", l_percep), ("l_style", l_style)):
                if val is not None:
                    losses[key] = val
                    total = total + val
        if self.semantic_w > 0:
            losses["l_semantic"] = semantic_loss(self.semantic_vgg, self.net_g, lq if self.LQ_stage else gt,
                                                 z_q, self.semantic_w)
            total = total + losses["l_semantic"]
        if self.use_dis and use_gan_now:
            self.net_d.requires_grad_(False)  # the g step moves the generator only
            try:
                fake_pred = self.net_d(z_q, update_stats=False)
            finally:
                self.net_d.requires_grad_(True)
            losses["l_g_gan"] = self.cri_gan(fake_pred, True, is_disc=False)
            total = total + losses["l_g_gan"]
        return total, losses, z_q, z_hq

    def d_losses(self, real, fake):
        """The discriminator's hinge (or other) losses: the real forward updates
        the spectral ``u``, the fake forward starts from it and leaves it."""
        real_pred = self.net_d(real, update_stats=True)
        l_d_real = self.cri_gan(real_pred, True, is_disc=True)
        fake_pred = self.net_d(fake, update_stats=False)
        l_d_fake = self.cri_gan(fake_pred, False, is_disc=True)
        return l_d_real + l_d_fake, {"l_d_real": l_d_real, "l_d_fake": l_d_fake,
                                     "out_d_real": real_pred.detach().mean(),
                                     "out_d_fake": fake_pred.detach().mean()}

    def quantized_latent(self, net, x):
        with torch.no_grad():
            return net.encode_and_decode(x, quantize_only=True)[4]

    def optimize_parameters(self, current_iter, batch):
        """One iteration on ``batch`` = {"lq", "gt"} (NHWC) -> the lazy loss dict."""
        lq, gt = self._nchw(batch["lq"]), self._nchw(batch["gt"])
        use_gan_now = self.use_dis and current_iter > self.net_d_init_iters
        self.optimizer_g.zero_grad(set_to_none=True)
        total, losses, z_q, z_hq = self.g_losses(lq, gt, use_gan_now)
        total.backward()
        if self.dp:
            average_gradients(self.trainable_parameters())
        self.optimizer_g.step()
        loss_dict = {**{k: v.detach() for k, v in losses.items()}, "l_g_total": total.detach()}

        if use_gan_now and not self.opt["train"].get("fixed_disc", False):
            z_gt = z_hq if self.LQ_stage else self.quantized_latent(self.net_g, gt)
            self.optimizer_d.zero_grad(set_to_none=True)
            l_d, d_losses = self.d_losses(z_gt, z_q.detach())
            l_d.backward()
            if self.dp:
                average_gradients(self.net_d.parameters())
            self.optimizer_d.step()
            loss_dict.update({k: v.detach() for k, v in d_losses.items()})

        if self.ema_decay > 0:
            self.model_ema(self.ema_decay)
        self.log_dict = self.reduce_loss_dict(loss_dict)
        return self.log_dict

    # ---------------- eval ----------------

    @torch.no_grad()
    def test(self, lq):
        """NHWC [B, H, W, 3] -> NHWC: flip-reflect pad to the next multiple of 32
        (a full 32 more when H or W already is one, as the reference pads),
        forward, crop."""
        lq = torch.as_tensor(lq, dtype=torch.float32, device=self.device)
        _, h_old, w_old, _ = lq.shape
        h_pad = (h_old // 32 + 1) * 32 - h_old
        w_pad = (w_old // 32 + 1) * 32 - w_old
        lq = torch.cat([lq, torch.flip(lq, [1])], 1)[:, :h_old + h_pad]
        lq = torch.cat([lq, torch.flip(lq, [2])], 2)[:, :, :w_old + w_pad]
        out, out_res = self.net_g.encode_and_decode(self._nchw(lq))[:2]
        result = out_res if out_res is not None else out
        return result.permute(0, 2, 3, 1)[:, :h_old, :w_old].float()

    def test_tile(self, lq, tile_size=240, tile_pad=16):
        """Real-ESRGAN halo tiling of :meth:`test` -> numpy NHWC."""
        lq = np.asarray(lq, np.float32)
        b, height, width, _ = lq.shape
        output = np.zeros((b, height, width, 3), np.float32)
        for y in range(math.ceil(height / tile_size)):
            for x in range(math.ceil(width / tile_size)):
                isx, isy = x * tile_size, y * tile_size
                iex, iey = min(isx + tile_size, width), min(isy + tile_size, height)
                isx_p, isy_p = max(isx - tile_pad, 0), max(isy - tile_pad, 0)
                iex_p, iey_p = min(iex + tile_pad, width), min(iey + tile_pad, height)
                out_tile = self.test(lq[:, isy_p:iey_p, isx_p:iex_p]).cpu().numpy()
                osy, osx = isy - isy_p, isx - isx_p
                output[:, isy:iey, isx:iex] = out_tile[:, osy:osy + (iey - isy), osx:osx + (iex - isx)]
        return output

    # ---------------- persistence ----------------

    def save(self, epoch, current_iter):
        """``net_g_{iter}.pth`` (params, params_ema), ``net_d_{iter}.pth`` and
        ``{iter}.state`` (both networks, both optimizers, the EMA)."""
        ema = self.ema_state_dict() if self.ema_flat is not None else self.net_g.state_dict()
        self.save_network([self.net_g.state_dict(), ema], "g", current_iter,
                          param_keys=("params", "params_ema"))
        if not hasattr(self, "net_d"):
            return
        self.save_network([self.net_d.state_dict()], "d", current_iter)
        cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
        self.save_training_state(epoch, current_iter, {
            "params_g": cpu(self.net_g.state_dict()), "opt_state_g": self.optimizer_g.state_dict(),
            "params_d": cpu(self.net_d.state_dict()), "opt_state_d": self.optimizer_d.state_dict(),
            "ema": None if self.ema_flat is None else self.ema_flat.cpu()})

    def resume_training(self, path):
        """Restore both networks, both optimizers and the EMA from ``{iter}.state``
        -> (epoch, iter)."""
        payload = self.load_training_state(path)
        state = payload["state"]
        self.net_g.load_state_dict(state["params_g"])
        self.net_d.load_state_dict(state["params_d"])
        self.optimizer_g.load_state_dict(state["opt_state_g"])
        self.optimizer_d.load_state_dict(state["opt_state_d"])
        if self.ema_flat is not None:
            self.ema_flat.copy_(state["ema"])
        return payload["epoch"], payload["iter"]

    def save_best(self, current_iter):
        self.save_network([self.net_g.state_dict()], "g_best", "")
