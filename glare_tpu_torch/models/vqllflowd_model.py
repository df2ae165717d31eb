"""Stage-3 model wrapper, inference half (counterpart of
``glare_tpu/models/vqllflowd_model.py``).

``get_sr(lq)`` is the serving path: three steps in a row,

    latent_half (ConEncoder1 + reverse flow) -> VQModel.decode -> aft_half,

under ``torch.inference_mode()``. It takes and returns ``[B, H, W, 3]`` float32
(like the JAX model); inside, tensors are NCHW in channels_last memory and the
convolutions run in bf16 when ``inference_dtype: bfloat16``.

Not ported yet: the train step, and ``audit_dcn_offsets`` / ``auto_configure_dcn``
(a cost model over the TPU cascade's select-chain cells), which wait for the
slice that ports the DCN cascade.
"""

from __future__ import annotations

import os

import torch

from ..modules.vqllflow_deformable import VQLLFLOWDeformable
from ..nn.layers import cast_convs_, seed_init_
from ..utils.util import opt_get
from .base_model import BaseModel
from .networks import define_Flow, find_vqgan


def temper_offset_heads(netG, seed=0, std=0.02):
    """Give the two zero-initialized ``conv_offset`` heads small seeded weights,
    so that a randomly initialized model exercises real (non-zero) DCN offsets.
    Kept tempered: large random heads make the offsets chaotic."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for warp in netG.deformable_decoder.warp:
            co = warp.dcn.conv_offset
            co.weight.copy_((torch.randn(co.weight.shape, generator=g) * std).to(co.weight))
            co.bias.copy_((torch.randn(co.bias.shape, generator=g) * 0.5).to(co.bias))
    return netG


class VQLLFLOWDModel(BaseModel):
    def __init__(self, opt, step=0, device="cuda"):
        super().__init__(opt, device=device)
        if self.is_train:
            raise NotImplementedError(
                "stage-3 training is not ported yet (it needs the DCN backward kernel); "
                "build the model with is_train=False")
        self.heats = opt_get(opt, ["val", "heats"])
        self.dtype = (torch.bfloat16 if opt.get("inference_dtype") == "bfloat16"
                      else torch.float32)
        self.netG = define_Flow(opt, step)
        assert isinstance(self.netG, VQLLFLOWDeformable)
        self.net_hq = find_vqgan(opt)

        seed = int(opt_get(opt, ["train", "manual_seed"], 10) or 10)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        seed_init_(self.net_hq, gen)
        seed_init_(self.netG, gen)

        # pretrained weights: VQGAN + stage-2/3 generator (torch state_dict files)
        vq_path = opt_get(opt, ["path", "pretrained_vqgan"])
        if vq_path and os.path.exists(self._torchify(vq_path)):
            self.load_into(self.net_hq, self._torchify(vq_path), strict=False)
        g_path = opt_get(opt, ["path", "pretrain_model_G"])
        if g_path and os.path.exists(self._torchify(g_path)):
            self.load_into(self.netG, self._torchify(g_path), strict=False)
        self._finalize()

    def _finalize(self):
        """Move to the device, set eval mode, channels_last and the compute dtype."""
        for net in (self.netG, self.net_hq):
            net.to(self.device).eval().requires_grad_(False)
            net.to(memory_format=torch.channels_last)
        self.netG.set_compute_dtype(self.dtype)  # the flow stays float32
        cast_convs_(self.net_hq, self.dtype)
        self._dcn_overflow_raw = None

    @staticmethod
    def _torchify(path):
        """The conf names ``*.flax`` files of the JAX package; the port reads the
        ``*.pth`` beside them."""
        base, ext = os.path.splitext(path)
        return path if ext in (".pth", ".pkl", ".pt") else base + ".pth"

    def load_network(self, load_path, strict=True):
        """Load a stage-3 ``state_dict`` file into netG (weights are cast to the
        model's compute dtype afterwards)."""
        cast_convs_(self.netG, torch.float32)
        res = self.load_into(self.netG, self._torchify(load_path), strict=strict)
        self._finalize()
        return res

    def load_state_dicts(self, stage3_sd=None, vqgan_sd=None):
        """Load in-memory state dicts (e.g. from ``convert.flax_to_torch_*``)."""
        cast_convs_(self.netG, torch.float32)
        cast_convs_(self.net_hq, torch.float32)
        if stage3_sd is not None:
            self.netG.load_state_dict(stage3_sd, strict=True)
        if vqgan_sd is not None:
            self.net_hq.load_state_dict(vqgan_sd, strict=True)
        self._finalize()

    # ---------------- eval ----------------

    @torch.inference_mode()
    def get_sr(self, lq, heat=None):
        """lq [B, H, W, 3] float32 (log-domain low-light) -> [B, H, W, 3] float32."""
        lq = torch.as_tensor(lq, dtype=torch.float32, device=self.device)
        x_in = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x, lr_enc = self.netG.latent_half(x_in)
        _, _, code_out = self.net_hq.decode(x)
        rec = self.netG.aft_half(x, code_out, lr_enc["mid_feat"])
        self._dcn_overflow_raw = self.netG.deformable_decoder.dcn_overflow()
        return rec.float().permute(0, 2, 3, 1).contiguous()

    def last_dcn_overflow(self):
        """Summed ``[overflow_blocks, taps_beyond_tail]`` over every DCNv2 pack in
        the last ``get_sr`` call, or None when every pack ran the exact impl.
        Non-zero counts mean the last batch's output deviated from exact DCNv2
        (offsets beyond the clamp radius)."""
        raw = [t for t in (self._dcn_overflow_raw or []) if t is not None]
        if not raw:
            return None
        total = torch.stack(raw).sum(dim=0).tolist()
        return {"overflow_blocks": int(total[0]), "taps_beyond_tail": int(total[1])}

    def get_sr_with_z(self, lq, heat=None, seed=None, z=None, epses=None):
        """Reference-API parity: the latent seed is the conditional colour map, so
        z is accepted and unused, exactly as in the reference reverse path."""
        sr = self.get_sr(lq, heat)
        return sr, self.get_z(heat or 0, seed, lq.shape[0], lq.shape)

    def get_z(self, heat, seed=None, batch_size=1, lr_shape=None):
        """z placeholder of the reference's shape convention; unused by the
        colour-map-seeded reverse flow."""
        fac = 2 ** 3
        h = lr_shape[1] // fac if lr_shape is not None else 8
        w = lr_shape[2] // fac if lr_shape is not None else 8
        size = (batch_size, h, w, 3 * fac * fac)
        if heat and heat > 0:
            g = torch.Generator(device="cpu").manual_seed(seed or 0)
            return (torch.randn(size, generator=g) * heat).to(self.device)
        return torch.zeros(size, device=self.device)
