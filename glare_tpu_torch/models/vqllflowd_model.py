"""Stage-3 model wrapper (counterpart of ``glare_tpu/models/vqllflowd_model.py``).

``get_sr(lq)`` is the serving path: three steps in a row,

    latent_half (ConEncoder1 + reverse flow) -> VQModel.decode -> aft_half,

under ``torch.inference_mode()``. It takes and returns ``[B, H, W, 3]`` float32
(like the JAX model); inside, tensors are NCHW in channels_last memory and the
convolutions run in bf16 when ``inference_dtype: bfloat16``.

``audit_dcn_offsets`` / ``auto_configure_dcn`` measure the loaded weights' DCN
offsets on a batch and pick, per warp, the cheapest configuration that is exact
for it: the same stats and the same choices as the JAX model makes on a TPU,
the gather hybrid (``dcn_impl: hybrid_gather``) included. A network whose warps
are flow warps (``warp_mode: flow``) has no offsets to audit: as in the JAX
model, its audit raises ``KeyError('intermediates')`` (``auto_configure_dcn``
with ``dcn_impl: xla`` audits nothing and returns).

Training (``is_train``): ``optimize_parameters`` is the reference's step,
    rec = AFT(no_grad(flow^-1(color map)), no_grad(vq.decode(...)), no_grad(mid_feat))
    sr = clamp(rec, 0, 1) with NaN masking
    loss = l1 + 0.01 * VGG16 perceptual + 0.2 * (1 - msssim(sr, gt, normalize=True)),
with ``RRDB`` and ``flowUpsamplerNet`` frozen (``requires_grad`` False, out of
the optimizer) and Adam (beta1, beta2, eps 1e-8; decoupled weight decay when
``weight_decay_G`` > 0, as the JAX optax chain) at ``schedule(k)`` on its k-th
update. ``train.mixed_precision`` is the JAX package's ``dtype=bfloat16`` for
training: the parameters stay float32 (AdamW's master weights and moments), the
convolutions of the encoder and the AFT decoder compute in bf16 (weights cast at
use), the VQGAN decodes in bf16 as in serving, the flow, the losses and the
optimizer stay float32. On the card the DCNs run the forward kernel and
``csrc/dcn_bwd.cu`` under autograd (float32: the ``f32`` forward entry; bf16: the
Hopper entry and the bf16 backward entries).

Data parallelism (the JAX model's mesh switch): when a ``torch.distributed`` group
of more than one rank is up and ``opt["use_dp"]`` is not false, every rank is
handed the same global batch and trains on its block of it (``shard_batch``; the
whole batch when it does not divide), the AFT runs under
``DistributedDataParallel`` (its gradients averaged over the ranks; ``parallelize``
offers FSDP2 instead), and the batch means inside the
step (the AFT's ``mean(h) / mean(x_vq)``, MS-SSIM's level means) are taken over
the whole batch (``parallel.global_mean``, a differentiable all-reduce), so that
the step equals the single-process step on the global batch. The logged losses
are the ranks' mean.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from ..modules.losses import PerceptualNetwork
from ..modules.msssim import msssim
from ..modules.vqllflow_deformable import VQLLFLOWDeformable
from ..nn.layers import cast_convs_, seed_init_
from ..ops.dcn import cascade_rows_per_block
from ..parallel.mesh import (cross_replica_mean, global_mean, is_data_parallel, make_dp_train_step,
                             make_fsdp_train_step, make_mesh, shard_batch)
from ..utils.util import opt_get
from .base_model import BaseModel
from .lr_scheduler import build_schedule
from .networks import define_Flow, find_vqgan

FROZEN = ("RRDB", "flowUpsamplerNet")  # the stage-3 generator's frozen sub-networks


def temper_offset_heads(netG, seed=0, std=0.02):
    """Give the two zero-initialized ``conv_offset`` heads small seeded weights,
    so that a randomly initialized model exercises real (non-zero) DCN offsets.
    Kept tempered: large random heads make the offsets chaotic."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for pack in netG.deformable_decoder.dcn_packs():
            co = pack.conv_offset
            co.weight.copy_((torch.randn(co.weight.shape, generator=g) * std).to(co.weight))
            co.bias.copy_((torch.randn(co.bias.shape, generator=g) * 0.5).to(co.bias))
    return netG


class VQLLFLOWDModel(BaseModel):
    def __init__(self, opt, step=0, device="cuda"):
        super().__init__(opt, device=device)
        self.heats = opt_get(opt, ["val", "heats"])
        if self.is_train:
            bf16 = bool(opt_get(opt, ["train", "mixed_precision"]))
        else:
            bf16 = opt.get("inference_dtype") == "bfloat16"
        self.dtype = torch.bfloat16 if bf16 else torch.float32  # the compute dtype
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
        self.dp = None   # the wrapper of netG under data parallelism (parallelize)
        if self.is_train:
            self._build_optimizer(opt.get("train") or {})
            if is_data_parallel() and opt.get("use_dp") is not False:
                self.parallelize("ddp")
            self.perceptual = PerceptualNetwork().to(self.device)
            if not self.perceptual.pretrained:
                import logging

                logging.getLogger("base").warning(
                    "stage-3 training: perceptual loss is using a fixed-seed RANDOM VGG16 (no "
                    "GLARE_VGG16_NPZ and no cached vgg16-*.pth) -- NOT the reference objective. "
                    "Convert weights with tools/torch2flax.py --kind vgg16 to restore parity.")

    def _finalize(self):
        """Move to the device, set eval mode, channels_last and the compute dtype;
        when training, label the trainable parameters (:meth:`_label_trainable`)."""
        for net in (self.netG, self.net_hq):
            net.to(self.device).eval().requires_grad_(False)
            net.to(memory_format=torch.channels_last)
        # the flow stays float32; training keeps float32 parameters (cast at use)
        self.netG.set_compute_dtype(self.dtype, master_weights=self.is_train)
        cast_convs_(self.net_hq, self.dtype)  # frozen and not saved: stored as it computes
        self._dcn_overflow_raw = None
        if self.is_train:
            self._label_trainable()

    def _label_trainable(self):
        """``RRDB`` and ``flowUpsamplerNet`` frozen, the rest of netG trainable
        (the JAX package's ``_label_trainable``); the VQGAN stays frozen."""
        for name, p in self.netG.named_parameters():
            p.requires_grad_(name.split(".", 1)[0] not in FROZEN)

    def load_network(self, load_path, strict=True):
        """Load a stage-3 ``state_dict`` file into netG (weights are cast to the
        model's compute dtype afterwards)."""
        cast_convs_(self.netG, torch.float32)
        res = self.load_into(self.netG, self._torchify(load_path), strict=strict)
        self._finalize()
        return res

    def _pretrain_strict(self):
        # load(): the stage-2 generator's file lacks the AFT decoder: never strict
        return False

    def load_state_dicts(self, stage3_sd=None, vqgan_sd=None):
        """Load in-memory state dicts (e.g. from ``convert.flax_to_torch_*``)."""
        cast_convs_(self.netG, torch.float32)
        cast_convs_(self.net_hq, torch.float32)
        if stage3_sd is not None:
            self.netG.load_state_dict(stage3_sd, strict=True)
        if vqgan_sd is not None:
            self.net_hq.load_state_dict(vqgan_sd, strict=True)
        self._finalize()

    # ---------------- train ----------------

    def _build_optimizer(self, train_opt):
        """Adam over the trainable parameters, as the optax chain of the JAX model
        (``scale_by_adam`` -> ``add_decayed_weights`` -> the schedule): AdamW's
        decoupled decay is that chain's ``p -= lr * (adam + wd * p)``."""
        self.schedule = build_schedule(train_opt)
        self.optimizer = torch.optim.AdamW(
            [p for _, p in self.trainable_parameters()], lr=self.schedule(0),
            betas=(float(train_opt.get("beta1") or 0.9), float(train_opt.get("beta2") or 0.99)),
            eps=1e-8, weight_decay=float(train_opt.get("weight_decay_G") or 0))
        self.updates = 0  # updates applied: optax's count, the schedule's argument

    def parallelize(self, mode="ddp", mesh=None):
        """Train data-parallel over the ``torch.distributed`` group: ``"ddp"`` wraps
        netG in ``DistributedDataParallel`` (what a group of more than one rank
        gets by itself); ``"fsdp"`` shards it with FSDP2 over ``mesh`` (default:
        ``make_mesh()``) by ``parallel.auto_shardings``' rule and rebuilds the
        optimizer on the sharded parameters. Either way the step's netG calls go
        through the wrapper and each rank takes its block of the batch.
        Checkpoints are written from a one-process or DDP model."""
        if mode == "fsdp":
            self.dp, self.fsdp_specs = make_fsdp_train_step(self.netG, mesh or make_mesh())
            self._build_optimizer(self.opt.get("train") or {})
        elif mode == "ddp":
            self.dp = make_dp_train_step(self.netG, mesh)
        else:
            raise ValueError(f"parallelize: mode {mode!r} is 'ddp' or 'fsdp'")
        return self.dp

    def _pipeline(self, x_in):
        """latent_half and the VQGAN decode without a graph (both frozen, and the
        JAX step stops their gradient), then the AFT decoder with one."""
        net = functools.partial(getattr, self.netG) if self.dp is None else \
            (lambda method: functools.partial(self.dp, method))
        with torch.no_grad():
            x, lr_enc = net("latent_half")(x_in)
            _, _, code_out = self.net_hq.decode(x)
        # under data parallelism the AFT's two means span the ranks' blocks: every
        # rank runs this step; get_sr (rank 0's validation) keeps its own batch's
        aft = self.netG.deformable_decoder
        aft.means_over_ranks = self.dp is not None
        try:
            return net("aft_half")(x, code_out, lr_enc["mid_feat"])
        finally:
            aft.means_over_ranks = False

    def train_losses(self, lq, gt):
        """-> (total, (l1, percep, ssim)) of the reference's stage-3 objective, with
        the graph. lq, gt [B, H, W, 3] float32 (under data parallelism the global
        batch, of which this rank takes its block)."""
        lq = torch.as_tensor(lq, dtype=torch.float32, device=self.device)
        gt = torch.as_tensor(gt, dtype=torch.float32, device=self.device)
        if self.dp is not None:
            lq, gt = shard_batch(lq), shard_batch(gt)
        x_in = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        rec = self._pipeline(x_in).float().permute(0, 2, 3, 1)
        self._dcn_overflow_raw = self.netG.deformable_decoder.dcn_overflow()
        sr = torch.clamp(rec, 0.0, 1.0)
        not_nan = ~torch.isnan(sr)
        sr = torch.nan_to_num(sr)
        l1 = ((sr - gt) * not_nan).abs().mean()
        percep = self.perceptual(sr, gt) * 0.01
        ssim_l = (1.0 - msssim(sr, gt, normalize=True,
                               batch_mean=torch.mean if self.dp is None else global_mean)) * 0.2
        return l1 + percep + ssim_l, (l1, percep, ssim_l)

    def optimize_parameters(self, batch, step=None):
        """One training step on ``batch`` = {"LQ", "GT"}: the loss, its gradients,
        then the update at ``schedule(updates so far)``. -> (total, percep, l1, ssim)."""
        self.optimizer.zero_grad(set_to_none=True)
        total, (l1, percep, ssim_l) = self.train_losses(batch["LQ"], batch["GT"])
        total.backward()
        self._update()
        losses = torch.stack([total, l1, percep, ssim_l]).detach()
        if self.dp is not None:
            losses = cross_replica_mean(losses)
        self.log_dict = dict(zip(("total_loss", "l1_loss", "percep_loss", "ssim_loss"), losses.tolist()))
        return (self.log_dict["total_loss"], self.log_dict["percep_loss"],
                self.log_dict["l1_loss"], self.log_dict["ssim_loss"])

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
        (offsets beyond the clamp or tail radius, or more out-of-band row blocks
        than the cascade's capacity). The counters stay on the device until this
        is called."""
        raw = [t for t in (self._dcn_overflow_raw or []) if t is not None]
        if not raw:
            return None
        total = torch.stack(raw).sum(dim=0).tolist()
        return {"overflow_blocks": int(total[0]), "taps_beyond_tail": int(total[1])}

    # ---------------- checkpoint-aware DCN dispatch ----------------

    @torch.inference_mode()
    def audit_dcn_offsets(self, lq, radii=(1, 2, 4, 8)):
        """Measured offset stats of the LOADED weights on one batch.

        Runs the stage-3 forward once with the DCN packs keeping their raw
        offsets (``DCNv2Pack.audit_offsets``) and returns Linf stats at tap,
        pixel and row-block granularity, at every radius in ``radii`` (callers
        pass the actual clamp radius). Row-block granularity is the cascade's
        unit, reported for both block sizes it can run (16 rows for
        R_tail < 6, 8 otherwise). Same keys and values as the JAX model's."""
        packs = self.netG.deformable_decoder.dcn_packs()
        if not packs:
            # flow warps sow no offsets; the JAX audit fails on the absent collection
            raise KeyError("intermediates")
        saved_overflow = self._dcn_overflow_raw
        for p in packs:
            p.audit_offsets = True
        try:
            self.get_sr(lq)
            # reduce over (dy, dx) on the device; everything below needs only that
            linf = [p.last_offsets.abs().amax(dim=-1).cpu().numpy() for p in packs]
        finally:
            for p in packs:
                p.audit_offsets = False
                p.last_offsets = None
            self._dcn_overflow_raw = saved_overflow

        radii = tuple(sorted({int(r) for r in radii}))
        rpbs = (8, 16)
        tap_linf, pix_linf = [], []
        blk_fr = {rpb: {r: [] for r in radii} for rpb in rpbs}
        per_warp = {}
        for w, taps in enumerate(linf):            # taps: [B, H, W, G, K]
            taps_w = taps.reshape(-1)
            pix_w = taps.max(axis=(3, 4)).reshape(-1)
            row = taps.max(axis=(2, 3, 4))         # [B, H]
            B_, H_ = row.shape
            blks_w = {}
            for rpb in rpbs:
                Hb = -(-H_ // rpb) * rpb
                rowp = np.pad(row, [(0, 0), (0, Hb - H_)])
                blks_w[rpb] = rowp.reshape(B_, -1, rpb).max(axis=2).reshape(-1)
            tap_linf.append(taps_w)
            pix_linf.append(pix_w)
            for rpb in rpbs:
                for r in radii:
                    blk_fr[rpb][r].append(blks_w[rpb] > r)
            per_warp[f"warp_{w}"] = {
                "tap_p99": float(np.percentile(taps_w, 99)),
                "tap_max": float(taps_w.max()),
                "per_gk_max": [[float(v) for v in r_] for r_ in taps.max(axis=(0, 1, 2))],
                "tap_frac_exceed": {r: float((taps_w > r).mean()) for r in radii},
                "pix_frac_exceed": {r: float((pix_w > r).mean()) for r in radii},
                "rowblk_frac_exceed_by_rpb": {
                    rpb: {r: float((blks_w[rpb] > r).mean()) for r in radii} for rpb in rpbs},
            }
        taps = np.concatenate(tap_linf)
        pix = np.concatenate(pix_linf)
        return {
            "tap_p99": float(np.percentile(taps, 99)),
            "tap_max": float(taps.max()),
            "tap_frac_exceed": {r: float((taps > r).mean()) for r in radii},
            "pix_frac_exceed": {r: float((pix > r).mean()) for r in radii},
            "rowblk_frac_exceed": {r: float(np.concatenate(v).mean())
                                   for r, v in blk_fr[8].items()},
            "rowblk_frac_exceed_by_rpb": {
                rpb: {r: float(np.concatenate(v).mean()) for r, v in by_r.items()}
                for rpb, by_r in blk_fr.items()},
            "warps": per_warp,
        }

    def auto_configure_dcn(self, lq, tap_tol=1e-3, capacity_margin=4.0):
        """Pick a parity-safe DCN path for the loaded checkpoint.

        The clamped impl is exact only while the learned offsets stay inside
        [-R, R]; reference-trained weights are not guaranteed to. This measures
        the loaded weights on a real batch and, per warp, takes the cheapest
        configuration that is exact for it: the clamp as configured, a plain
        wider clamp, per-tap radii, or the cascade ('hybrid') with R_tail above
        the measured tap max and capacity = ``capacity_margin`` x the measured
        out-of-band row-block fraction. A warp beyond the cascade's 16 px menu
        takes the gather hybrid ('hybrid_gather': R as configured, capacity =
        ``capacity_margin`` x the out-of-band pixel fraction at R, between 1/64
        and 1; R_tail kept), and a warp already on it is retuned the same way.
        'xla' needs nothing.

        The cost of an option is the JAX package's proxy (select-chain cells per
        pixel of its TPU kernels), kept as it is so that a checkpoint gets the
        same configuration in both packages; the choices are those the JAX model
        makes on a TPU. Returns the stats dict with ``action`` and ``decisions``
        added.
        """
        def aslist(v):
            return list(v) if isinstance(v, (tuple, list)) and len(v) == 2 else [v, v]

        netG = self.netG
        impls = aslist(netG.dcn_impl)
        if all(i == "xla" for i in impls):
            return {"action": "none (exact xla path)"}
        # a per-warp entry may itself be a [G][K] per-tap radius table: keep it a tuple
        Rs = [tuple(tuple(int(r) for r in row) for row in v)
              if isinstance(v, (tuple, list)) else int(v)
              for v in aslist(netG.dcn_max_offset)]
        caps0 = aslist(netG.dcn_hybrid_capacity)
        tails0 = aslist(netG.dcn_hybrid_tail_offset)
        # audit at the actual clamp radii, not a fixed menu
        int_Rs = {r for r in Rs if isinstance(r, int)} | {
            r for v in Rs if isinstance(v, tuple) for row in v for r in row}
        stats = self.audit_dcn_offsets(lq, radii=sorted({1, 2, 4, 8, 16} | int_Rs))

        def cells(r):
            return (2 * int(r) + 1) ** 2

        def decide(w, ws):
            """Min-cost exact configuration for one warp, from its stats. Cost
            proxy: plain clamp R' costs cells(R'); the cascade costs
            cells(R) + capacity * cells(R_tail)."""
            impl_w, R_w = impls[w], Rs[w]
            tap_max = ws["tap_max"]
            per_gk = np.array(ws["per_gk_max"], float) if "per_gk_max" in ws else None
            opts = []
            if isinstance(R_w, tuple):
                # per-tap radii: exact iff every tap's measured max is inside its own
                r_arr = np.array(R_w, float)
                if (per_gk is not None and impl_w in ("pallas", "chain")
                        and (per_gk <= r_arr).all()):
                    opts.append(dict(impl=impl_w, R=R_w, cap=caps0[w], r_tail=tails0[w],
                                     cost=float(((2 * r_arr + 1) ** 2).mean()),
                                     note="kept (per-tap radii cover audit)"))
                R_base = 2  # rebuild the option menu from the default base
            else:
                tail = ws["tap_frac_exceed"][R_w]
                if impl_w in ("pallas", "chain") and tail <= tap_tol:
                    opts.append(dict(impl=impl_w, R=R_w, cap=caps0[w], r_tail=tails0[w],
                                     cost=cells(R_w),
                                     note=f"kept (tail {tail:.6f} <= {tap_tol})"))
                R_base = R_w
            # plain clamped kernel at a radius covering tap max + 1 px margin
            plain_impl = "pallas"
            r_plain = max(1, int(math.ceil(tap_max + 1.0)))
            if r_plain <= 15:
                opts.append(dict(impl=plain_impl, R=r_plain, cap=caps0[w],
                                 r_tail=max(tails0[w], r_plain + 1), cost=cells(r_plain),
                                 note=f"plain clamp R={r_plain} covers tap "
                                      f"max {tap_max:.1f} + 1 px"))
            # per-tap radii: each (g, k) clamps at its own audited max plus a
            # relative margin (50% of the max, bounded to [0.5, 1] px)
            if per_gk is not None and per_gk.max() <= 14.0:
                radii = tuple(
                    tuple(max(1, min(15, int(math.ceil(m + min(1.0, max(0.5, 0.5 * m))))))
                          for m in row)
                    for row in ws["per_gk_max"])
                r_np = np.array(radii, float)
                mean_cells = float(((2 * r_np + 1) ** 2).mean())
                opts.append(dict(impl="pallas", R=radii, cap=caps0[w],
                                 r_tail=max(tails0[w], int(r_np.max()) + 1), cost=mean_cells,
                                 note=f"per-tap radii {int(r_np.min())}-{int(r_np.max())} px "
                                      f"(mean {mean_cells:.0f} cells/tap)"))
            # cascade: capacity from the measured block tail at the block size the
            # cascade will use, uncapped to 1.0
            for r_t in (4, 8, 16):
                if r_t > R_base and tap_max <= r_t - 1.0:
                    rpb = cascade_rows_per_block(r_t, 16)
                    frac = ws["rowblk_frac_exceed_by_rpb"][rpb][R_base]
                    cap = min(1.0, max(1 / 64, capacity_margin * frac))
                    opts.append(dict(impl="hybrid", R=R_base, cap=cap, r_tail=r_t,
                                     cost=cells(R_base) + cap * cells(r_t),
                                     note=f"cascade R={R_base}/R_tail={r_t} cap {cap:.4f} "
                                          f"= {capacity_margin}x {rpb}-row-block tail "
                                          f"{frac:.4f}"))
            if not opts:
                # beyond the 16 px cascade menu: the unbounded gather tail
                frac = ws["pix_frac_exceed"][R_base]
                cap = min(1.0, max(1 / 64, capacity_margin * frac))
                return dict(impl="hybrid_gather", R=R_base, cap=cap, r_tail=tails0[w],
                            cost=float("inf"),
                            note=f"tap max {tap_max:.1f} beyond the 16 px cascade menu; gather "
                                 f"capacity {cap:.4f} = {capacity_margin}x pixel tail {frac:.4f}")
            best = min(opts, key=lambda o: o["cost"])
            # hysteresis: keep the exact-as-configured option unless the winner is
            # more than 15% cheaper
            kept = next((o for o in opts if o["note"].startswith("kept")), None)
            if kept is not None and kept["cost"] <= 1.15 * best["cost"]:
                return kept
            return best

        warp_names = sorted(stats["warps"])
        decisions = [decide(w, stats["warps"][name]) for w, name in enumerate(warp_names)]
        if len(decisions) == 1:
            decisions = decisions * 2

        def collapse(vals):
            vals = tuple(vals)
            if any(isinstance(v, (tuple, list)) for v in vals):
                return vals  # never collapse per-tap tables to a bare value
            return vals[0] if len(set(vals)) == 1 else vals

        new = dict(dcn_impl=collapse(d["impl"] for d in decisions),
                   dcn_max_offset=collapse(d["R"] for d in decisions),
                   dcn_hybrid_capacity=collapse(d["cap"] for d in decisions),
                   dcn_hybrid_tail_offset=collapse(d["r_tail"] for d in decisions))
        cur = dict(dcn_impl=collapse(impls), dcn_max_offset=collapse(Rs),
                   dcn_hybrid_capacity=collapse(caps0),
                   dcn_hybrid_tail_offset=collapse(tails0))
        per_warp_note = "; ".join(f"{name}: {d['impl']} {d['note']}"
                                  for name, d in zip(warp_names, decisions))
        if new != cur:
            netG.configure_dcn(**new)
            stats["action"] = f"reconfigured per-warp: {per_warp_note}"
        else:
            stats["action"] = f"kept: {per_warp_note}"
        stats["decisions"] = {name: dict(d) for name, d in zip(warp_names, decisions)}
        return stats

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
