"""FLOP audit of the port (counterpart of ``tools/flops_audit.py``).

Counts the FLOPs of one stage-3 image at the protocol shape (620x420 after the
reflect pad), per component (``latent_half``, ``VQModel.decode``, ``aft_half``),
with ``torch.utils.flop_counter.FlopCounterMode``, and converts them into the
images per second one H100 could reach at 100% of its peak; ``--measured IMG_S``
turns a measured rate into the MFU. ``--train`` adds the training steps of
stages 2, 3 and 1 at their confs' shapes, and ``--stage2`` stage-2 inference.

What is counted: the products of the torch ops the dispatcher sees (matmuls,
convolutions; ``FlopCounterMode``'s rules: 2 FLOPs a multiply-add), not
elementwise work. The hand-written kernels are ``ctypes`` launches the dispatcher
never sees, so every call of a kernel-bearing entry (``ops.attn``, ``ops.dcn``,
``ops.vq``) is recorded with its shapes and counted by its formula (PERF.md
section 6): attention 4 * n_true^2 * C an image, the DCN 2 * P * 9 * C * O,
``vq_argmin`` 2 * N * K * (D + 1). On the CPU the same entries run their plain
versions, whose products the counter does see; those are taken out and the
formula put in, so the total is the same on either device. A DCN backward adds
its two products (torch matmuls on the card: counted as they run).

This is not XLA's cost model, so it does not equal the JAX package's
``FLOPS_AUDIT.json`` (whose ceiling is a TPU's). The peaks are the published
dense peaks of one H100 SXM from NVIDIA's data sheet (989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s float32 without TF32), not a measurement.

    python -m glare_tpu_torch.tools.flops_audit [--height 420 --width 620]
        [--dtype bfloat16] [--measured IMG_S] [--train] [--stage2] [--device cpu]
        [--out results/flops_audit.json]

Runs on ``cuda`` unless ``--device cpu`` is given. Seeded random weights (the
count does not depend on them). Writes only ``--out`` (under ``results/`` by
default, git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

PEAK_BF16 = 989e12   # H100 SXM data sheet, dense bf16 tensor-core peak
PEAK_F32 = 67e12     # H100 SXM data sheet, float32 (no TF32)


# ---------------------------------------------------------------- confs --

def stage3_opt(dtype="bfloat16", dcn_impl="pallas", **widths):
    """The values of confs/LOL.yml that the stage-3 forward reads (no yaml needed);
    ``widths`` override ``network_G`` / ``network_VQGAN`` keys (tests: mini sizes)."""
    flow = {"K": 12, "L": 2, "coupling": "CondAffineSeparatedAndCond", "additionalFlowNoAffine": 2,
            "split": {"enable": False}}
    vq = {"type": "VQModel", "resolution": 256, "n_embed": 8192, "embed_dim": 3, "z_channels": 3,
          "in_channels": 3, "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4], "num_res_blocks": 2,
          "attn_resolutions": [64]}
    net = {"which_model_G": "VQLLFLOWDeformable", "dcn_impl": dcn_impl, "dcn_max_offset": 2, "flow": flow}
    for k, v in widths.items():
        (vq if k.startswith("vq_") else net)[k[3:] if k.startswith("vq_") else k] = v
    return {"name": "GLARE_LOL", "model": "VQLLFLOWD", "scale": 1, "is_train": False, "heat": 0,
            "inference_dtype": dtype, "datasets": {"train": {"quant": 32, "GT_size": 256, "log_low": True}},
            "network_G": net, "network_VQGAN": vq, "path": {}, "train": {"manual_seed": 10}}


def stage3_train_opt(**widths):
    """confs/train_stage3_LOL.yml's training values: float32, ``chain`` R 2, Adam."""
    opt = stage3_opt("float32", "chain", **widths)
    opt.pop("inference_dtype")
    opt.update(is_train=True, name="train_stage3_LOL")
    opt["train"] = {"manual_seed": 10, "lr_G": 5e-5, "weight_decay_G": 0, "beta1": 0.9, "beta2": 0.99,
                    "lr_scheme": "MultiStepLR", "warmup_iter": -1, "lr_gamma": 0.5, "lr_steps": [20000]}
    return opt


def stage2_opt(dtype="bfloat16", is_train=False):
    """confs/train_stage2_LOL.yml's network (float32 and Adam when ``is_train``)."""
    opt = stage3_opt(dtype)
    opt.update(model="LLFlow", name="train_stage2_LOL", is_train=is_train)
    opt["network_G"] = {"which_model_G": "LLFlowVQGAN2", "flow": dict(opt["network_G"]["flow"])}
    if is_train:
        opt.pop("inference_dtype")
        opt["train"] = {"manual_seed": 10, "lr_G": 5e-4, "weight_decay_G": 0, "beta1": 0.9, "beta2": 0.99,
                        "lr_scheme": "MultiStepLR", "warmup_iter": -1, "lr_gamma": 0.5, "lr_steps": [40000],
                        "weight_l1": 0, "weight_fl": 1}
    return opt


def stage1_opt(gt_size=256, tmp="results/flops_audit_stage1"):
    """confs/stage1_HQ_pretrain.yml's HQ stage: codebook [gt/4, 1024, 512], UNet-SN."""
    return {
        "name": "stage1_HQ_pretrain", "model_type": "VQDehazeModel", "is_train": True, "manual_seed": 0,
        "network_g": {"type": "VQWeightDehazeNet", "gt_resolution": gt_size, "norm_type": "gn",
                      "act_type": "silu", "use_quantize": True,
                      "codebook_params": [[gt_size // 4, 1024, 512]]},
        "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 512},
        "datasets": {"train": {"gt_size": gt_size}},
        "path": {"models": os.path.join(tmp, "models"), "training_states": os.path.join(tmp, "states")},
        "train": {"optim_g": {"type": "Adam", "lr": 1e-4}, "optim_d": {"type": "Adam", "lr": 1e-4},
                  "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                  "perceptual_opt": {"type": "PerceptualLoss", "perceptual_weight": 1.0, "style_weight": 0,
                                     "layer_weights": {"relu1_2": 1.0, "relu2_2": 1.0, "relu3_3": 1.0}},
                  "gan_opt": {"type": "GANLoss", "gan_type": "hinge", "loss_weight": 0.1},
                  "codebook_opt": {"loss_weight": 1.0}, "net_d_init_iters": 0},
        "val": {"metrics": {"psnr": {"type": "psnr", "better": "higher"}}},
    }


def build_stage3(height=420, width=620, dtype="bfloat16", dcn_impl="pallas", device="cuda", **widths):
    """-> (the stage-3 model with seeded weights and tempered offset heads, a seeded
    log-domain low-light image [1, height, width, 3] on the model's device)."""
    from ..models import create_model
    from ..models.vqllflowd_model import temper_offset_heads

    model = create_model(stage3_opt(dtype, dcn_impl, **widths), device=device)
    temper_offset_heads(model.netG, seed=7, std=0.02)
    rng = np.random.RandomState(0)
    lq = np.log(np.clip(rng.rand(1, height, width, 3).astype(np.float32) * 0.15 + 1e-3, 1e-3, None))
    return model, torch.as_tensor(lq, device=model.device)


# ---------------------------------------------------------------- kernels --

def attention_flops(q, n_true=None):
    b, n, c = q.shape
    n_true = n if n_true is None else int(n_true)
    return 4 * b * n_true * n_true * c


def dcn_flops(x, weight):
    b, h, w, c = x.shape
    return 2 * b * h * w * 9 * c * weight.shape[-1]


def vq_flops(z_flat, codebook):
    return 2 * z_flat.shape[0] * codebook.shape[0] * (codebook.shape[1] + 1)


@contextlib.contextmanager
def recorded_kernels(counter, calls):
    """Inside the block every call of a kernel-bearing entry appends
    {kind, formula FLOPs, the FLOPs the counter saw inside it} to ``calls``."""
    from ..ops import attn, dcn, vq

    entries = [(attn, "flash_attention_nhc", "attention", lambda a, k: attention_flops(a[0], k.get("n_true"))),
               (vq, "nearest_code", "vq_argmin", lambda a, k: vq_flops(a[0], a[1])),
               (dcn, "modulated_deform_conv", "dcn", lambda a, k: dcn_flops(a[0], a[3])),
               (dcn, "modulated_deform_conv_cascade", "dcn", lambda a, k: dcn_flops(a[0], a[3])),
               (dcn, "modulated_deform_conv_hybrid", "dcn", lambda a, k: dcn_flops(a[0], a[3]))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in entries]

    def wrap(fn, kind, formula):
        def call(*a, **k):
            seen0 = counter.get_total_flops()
            out = fn(*a, **k)
            calls.append({"kind": kind, "flops": int(formula(a, k)), "seen": counter.get_total_flops() - seen0})
            return out
        return call

    for (mod, name, kind, formula), (_, _, fn) in zip(entries, saved):
        setattr(mod, name, wrap(fn, kind, formula))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def count(fn):
    """FLOPs of ``fn()``: the counter's total with every kernel-bearing call's
    share replaced by its formula -> {total, kernels: {kind: FLOPs}, calls: {kind: n},
    counted_outside_kernels}."""
    from torch.utils.flop_counter import FlopCounterMode

    calls = []
    with FlopCounterMode(display=False) as counter, recorded_kernels(counter, calls):
        fn()
    seen = counter.get_total_flops()
    inside = sum(c["seen"] for c in calls)
    kernels, n = {}, {}
    for c in calls:
        kernels[c["kind"]] = kernels.get(c["kind"], 0) + c["flops"]
        n[c["kind"]] = n.get(c["kind"], 0) + 1
    return {"total": seen - inside + sum(kernels.values()), "kernels": kernels, "calls": n,
            "counted_outside_kernels": seen - inside}


# ---------------------------------------------------------------- paths --

def stage3_flops(model, lq):
    """One stage-3 forward, per component -> {component: count(...)}, "total"."""
    netG, vq = model.netG, model.net_hq
    x_in = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    parts, state = {}, {}
    with torch.inference_mode():
        def latent():
            state["x"], state["enc"] = netG.latent_half(x_in)

        def decode():
            state["code"] = vq.decode(state["x"])[2]

        def aft():
            netG.aft_half(state["x"], state["code"], state["enc"]["mid_feat"])

        for name, fn in (("latent_half", latent), ("vq_decode", decode), ("aft_half", aft)):
            parts[name] = count(fn)
    return {**parts, "total": sum(p["total"] for p in parts.values())}


def stage2_infer_flops(model, lq):
    """Stage-2 serving: the reverse flow, then the VQGAN decode, per image."""
    return count(lambda: model.decode_latent(model.get_sr(lq)))["total"] / lq.shape[0]


def train_step_flops(step, batch_size):
    """FLOPs per image of one training step ``step()`` (forward, backward, update)."""
    return count(step)["total"] / batch_size


def ceiling(flops_per_img, peak):
    return peak / flops_per_img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=420)
    ap.add_argument("--width", type=int, default=620)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--dcn_impl", default="pallas")
    ap.add_argument("--measured", type=float, default=None, help="measured img/s to turn into MFU")
    ap.add_argument("--train", action="store_true", help="also the training steps of stages 2, 3 and 1")
    ap.add_argument("--stage2", action="store_true", help="also stage-2 inference")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="results/flops_audit.json", help="JSON output ('' skips)")
    args = ap.parse_args(argv)

    peak = PEAK_BF16 if args.dtype == "bfloat16" else PEAK_F32
    model, lq = build_stage3(args.height, args.width, args.dtype, args.dcn_impl, args.device)
    res = stage3_flops(model, lq)
    del model
    total = res["total"]
    print(f"stage-3 forward @ {args.height}x{args.width} ({args.dtype}, dcn={args.dcn_impl})")
    for name in ("latent_half", "vq_decode", "aft_half"):
        print(f"  {name:24s} {res[name]['total'] / 1e12:8.4f} TFLOP  kernels {res[name]['kernels']}")
    print(f"  {'TOTAL':24s} {total / 1e12:8.4f} TFLOP/img")
    ceil = ceiling(total, peak)
    print(f"H100 SXM data-sheet peak {peak / 1e12:.0f} TFLOP/s -> {ceil:.1f} img/s at 100% MFU")
    payload = {"stage3": {"height": args.height, "width": args.width, "dtype": args.dtype,
                          "dcn_impl": args.dcn_impl, "tflop_per_img": total / 1e12,
                          "parts_tflop": {k: res[k]["total"] / 1e12 for k in ("latent_half", "vq_decode", "aft_half")},
                          "kernel_tflop": {k: v / 1e12 for p in ("latent_half", "vq_decode", "aft_half")
                                           for k, v in res[p]["kernels"].items()},
                          "peak_tflops_datasheet": peak / 1e12, "ceiling_img_s_100mfu": ceil,
                          "source": "torch.utils.flop_counter products + kernel formulas"}}
    if args.measured:
        mfu = args.measured / ceil
        print(f"measured {args.measured} img/s -> MFU {mfu * 100:.2f}%")
        payload["stage3"].update(measured_img_s=args.measured, mfu=mfu)
    if args.stage2:
        from ..models import create_model

        m2 = create_model(stage2_opt(args.dtype), device=args.device)
        f2 = stage2_infer_flops(m2, lq)
        del m2
        print(f"stage-2 infer @ {args.width}x{args.height}: {f2 / 1e12:.4f} TFLOP/img")
        payload["stage2_infer"] = {"tflop_per_img": f2 / 1e12, "ceiling_img_s_100mfu": ceiling(f2, peak)}
    if args.train:
        payload.update(train_audits(args.device))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.out}")
    return payload


def train_audits(device):
    """The three training steps at their confs' shapes, FLOPs per image and the
    float32 ceiling (the steps run float32)."""
    from ..models import create_model
    from ..sr.models import build_model

    out = {}
    rng = np.random.RandomState(0)
    for name, opt, b, s in (("stage2_train", stage2_opt(is_train=True), 4, 320),
                            ("stage3_train", stage3_train_opt(), 2, 256)):
        model = create_model(opt, device=device)
        batch = {"LQ": torch.as_tensor(np.log(rng.rand(b, s, s, 3).astype(np.float32) * 0.2 + 1e-3), device=device),
                 "GT": torch.as_tensor(rng.rand(b, s, s, 3).astype(np.float32), device=device)}
        model.optimize_parameters(batch)          # stage 2: the ActNorm init first, outside the count
        f = train_step_flops(lambda: model.optimize_parameters(batch), b)
        out[name] = {"gt_size": s, "batch": b, "dtype": "float32", "tflop_per_img": f / 1e12,
                     "ceiling_img_s_100mfu": ceiling(f, PEAK_F32)}
        print(f"{name} @{s}^2 b{b} (f32): {f / 1e12:.4f} TFLOP/img")
        del model
    model = build_model(stage1_opt(), device=device)
    x = torch.as_tensor(rng.rand(4, 256, 256, 3).astype(np.float32), device=device)
    f = train_step_flops(lambda: model.optimize_parameters(1, {"lq": x, "gt": x}), 4)
    out["stage1_train"] = {"gt_size": 256, "batch": 4, "dtype": "float32", "tflop_per_img": f / 1e12,
                           "ceiling_img_s_100mfu": ceiling(f, PEAK_F32)}
    print(f"stage1_train @256^2 b4 (f32): {f / 1e12:.4f} TFLOP/img")
    return out


if __name__ == "__main__":
    main()
