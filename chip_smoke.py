#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device; exits non-zero without

Phases, each printing one JSON line:
  device     the card (nvidia-smi name + power limit), torch / CUDA versions
  build      compiles the seven csrc/*.cu with nvcc (one process per source, all
             started together; dcn_fwd.cu and dcn_bwd.cu include csrc/dcn_tap.cuh)
             and loads them; ptxas registers and spills of vq_argmin.cu,
             attn_fused.cu, dcn_fwd.cu, dcn_bwd.cu and of the three Hopper sources
             (attn_hopper.cu, attn_hopper_f32.cu, dcn_hopper.cu), with their shared
             memory: a spill, or warning C7515 (a serialized wgmma pipeline), fails
             the run
  kernels    every hand-written kernel entry against its plain PyTorch version on
             the card, at the shapes the main path gives it and at small ragged
             shapes; times by CUDA events (median after a warm-up). Attention:
             the entry the wrapper picks for each case (hopper for bf16 C = 512,
             wmma for other bf16 widths, hopper_f32 -- 3xTF32 on wgmma -- for
             float32), the wmma entry also timed at the main shape; float32 at
             the main shape and ragged shapes (n and n_true not multiples of the
             64-query tile, C % 4 != 0) held to the plain version (5e-5) and to
             a float64 dense oracle (at most F32_ORACLE_RATIO x the plain
             version's own error), the earlier SIMT kernel (f32_simt) beside it
             in turns; SDPA under each backend as the yardstick. DCN: the entry ops.dcn.route picks (hopper for the
             paths' bf16 widths, f32 -- the tiled float32 kernel -- for float32
             inside its envelope, the first kernel's wmma / f32_flat otherwise),
             the Hopper entry's edges (ragged tiles, B = 2, borders, corners
             outside the halo, mask 0 / 1), the first kernel timed at the paths'
             shapes; the cascade with its selection kernel, which must agree
             with the plain selection exactly. The DCN backward (csrc/dcn_bwd.cu:
             grad_col product, one gather pass, grad_weight product) against
             autograd of the plain version at the two training shapes (offsets
             beyond the clamp, exactly 0, and grad_x), the gather pass against
             its plain version, its float32 column bit for bit against what the
             f32 forward multiplies, and the f32 forward there beside the first
             float32 kernel (f32_flat); its bf16 entry there by the stage-ratio
             rule against the float32 plain backward (chunked, with grad_x), its
             column bit for bit against the Hopper forward's A block, and the
             Hopper forward at the training shapes. Both backward rows also time
             the first backward design (three kernels, built from the source
             text kept in glare_tpu_torch/tools/dcn_train_designs.py). The f32
             forward and the float32 backward with grad_x also at the stage-1 LQ
             shapes (C = O = 128 at 128x128 and 64 at 256x256, batch 4,
             infinite radii) against their plain versions, timed there
  main_path  stage-3 paired inference at the full width of confs/LOL.yml
             (bf16, 620x420, dcn_impl pallas / clamp 2, seeded random weights):
             two single-image requests and one batch of two through
             VQLLFLOWDModel.get_sr; launch counters per call; a stage-wise
             comparison of the kernel path against the plain-version path
  f32_attn_path  main_path's network in float32, as cli/test_stages.py serves a
             training conf (no inference_dtype): get_sr at 620x420 with its
             AttnBlocks built under GLARE_ATTN_FUSED=1 (exactly 11 launches of
             hopper_f32 a call, none of another attention entry) and without the
             switch (the chunked path: no attention launch), in turns; ms per
             image and peak memory both ways; each stage of the fused run held to
             the chunked run on the same inputs (F32_STAGE_TOL, relative RMS)
  eval_path  on main_path's model, the per-image step of cli/infer_paired.py
             (prep, enhance_exact, measure_output) on two synthetic 600x400
             pairs: LPIPS from a seeded npz on the card against the CPU (and a
             float64 CPU run), PSNR / SSIM equal, the NaN column with its note
             without the npz, NIQE with parameters fitted in the phase, the
             host ms of each metric, whether cv2 is importable (it is not used);
             prep runs the C++ core of data/native.py, bit-equal to the numpy
             plain version on both pairs and timed beside it
  hybrid_path  the same model with dcn_impl hybrid (the DCN cascade): a request
             that overflows the cascade's capacity goes through the CLI's
             re-dispatch loop, exact requests are held against an exact ('xla')
             model with the same weights, then auto_configure_dcn audits a
             two-image batch and one request runs under what it chose
  gather_path  the main-path model with offset heads that move every tap 18 px
             at the border columns only: auto_configure_dcn takes dcn_impl
             hybrid_gather for both warps (the rule restated in gather_rule);
             each request exactly 2 Hopper DCN launches (the base passes) and no
             plain version; the tail's slots and time per warp; the stages
             against the plain versions and against the exact ('xla') DCN
  flow_path  the same conf with warp_mode flow and seeded flow heads: no DCN
             launch, the 25-shift warp timed alone, the stages against the
             plain versions
  stage2_path  stage-2 inference at the full width of confs/train_stage2_LOL.yml
             (bf16, 600x400): LLFlowModel.get_sr -> decode_latent, the same
             stage-wise comparison
  train_path  stage-3 training at the full width of confs/train_stage3_LOL.yml
             (float32, dcn_impl chain, 256 crop, batch 2, seeded weights,
             synthetic pairs): a warm-up step and three timed steps of
             VQLLFLOWDModel.optimize_parameters, each through the f32 DCN forward
             (the tiled kernel), the backward's gather pass (dcn_bwd) and
             vq_argmin and no plain version; frozen modules bit-equal;
             one step's loss and gradients against the plain versions' autograd
             then the same model with dcn_impl xla, which JAX's rule makes a
             remat step (the AFT decoder's ResnetBlocks, AttnBlocks and
             WarpBlocks under torch.utils.checkpoint): one step's loss and
             gradients between two of the same step with remat off, within their
             own spread (or 1e-6 relative); peak memory and ms of each; the
             WarpBlocks' DCN forwards recomputed (4 launches a step, not 2)
  train_path_bf16  the same with train.mixed_precision (bf16 compute, float32
             master weights and Adam moments): each step through the Hopper DCN
             forward, the bf16 gather pass and vq_argmin; one step through the
             kernels and through the plain versions, both held to a float32
             plain step on the same weights and batch by the stage-ratio rule
  train_stage2_path  stage-2 training at the full width and depth of
             confs/train_stage2_LOL.yml (float32, 320 crop, batch 4, seeded
             weights, synthetic pairs): the ActNorm data-dependent init on one
             160x160 crop, card against CPU; LLFlowModel.initialize_actnorm on
             the first batch, a warm-up step and three timed steps of
             optimize_parameters that launch no kernel and no plain version,
             cli.train.validate (stage 2) at 600x400 with one vq_argmin launch
             an image; the first step's loss and gradients on the crop, card
             against CPU, and the step at the trained weights against the CPU's
             float32 and float64 steps, then with the card's model in float64 too
             against the CPU's float64 step (bar S2_F64_TOL, 10% / 1% / 0.1%
             faults in one coupling's conditional backward as its controls); the
             saved {k}_G.pth in an inference model, get_sr bit-equal
  train_stage1_path  stage-1 HQ pretraining at the full width of
             confs/stage1_HQ_pretrain.yml (VQWeightDehazeNet, codebook
             [64, 1024, 512], UNet-SN on the 512-channel latent, L1 + VGG19
             perceptual + codebook + hinge GAN, Adam, EMA; float32, 256 crop,
             batch 4, seeded weights, synthetic images): a warm-up and three
             timed iterations of VQDehazeModel.optimize_parameters (g step,
             d step, EMA) that launch no kernel and no plain version, with
             finite losses, every trainable tensor moved, each SNConv's u
             stored once (by the d step's real forward), the EMA equal to its
             formula; one iteration's losses and gradients on a 128x128 crop,
             card against CPU; save -> net_g_{k}.pth -> test() bit-equal
  train_stage1_lq_path  its LQ stage (Swin blocks, the residual warp
             decoder; frozen_module_keywords) from the HQ phase's file: each
             iteration exactly 2 f32 DCN forwards and 2 backward passes with
             grad_x (the WarpBlocks' exact DCN under autograd), frozen tensors
             bit-equal; one iteration through the kernels against the same
             through the plain versions
  haze_lq_path  RIDCP's dehazing data path: HazeOnlineDataset (train, 256 crop)
             over eight seeded 400x600 images and depth maps through sr.data's
             loader at batch 4, the same two epochs with prefetch_mode (a
             PrefetchDataLoader) bit-equal to the plain loader's, then two
             iterations of train_stage1_lq_path's model (each exactly 2 f32 DCN
             forwards and 2 backward passes with grad_x); host ms per item beside
             ms per iteration; the loop with the loader inside it, prefetch off
             and on in turns, in ms per iteration
  swinir_path  SwinIR-M (classical SR x4, seeded weights, float32): one
             256x256 image to 1024x1024; a 64x64 crop card against CPU
  degradation_path  DiffJPEG (per-sample quality, differentiable with a
             backward, and hard), USMSharp and per-sample 21x21 filter2D on
             12 crops of 256x256, each card against CPU (decisions at a rounding
             or threshold near-tie counted, their reach excluded)
  legacy_path  RRDBNet (ESRGAN widths, get_steps) and ColorEncoder at 600x400,
             a 64x64 crop card against CPU; GumbelQuantize in eval and
             EMAVectorQuantizer with one update, card against CPU
  tools_path  on main_path's model: tools/offset_histogram over two seeded
             620x420 images (exactly two get_sr calls' launches, no plain
             version; each warp's statistics on each image equal
             audit_dcn_offsets'), tools/flops_audit of one image (its kernel
             rows the formulas of PERF.md section 6) and the MFU of main_path's
             ms per image against the 989 TFLOP/s data-sheet peak
  unpaired_path  cli/infer_unpaired.py's main on the card (confs/LOL.yml, main_path's
             seeded weights, a temporary working directory) over three seeded
             low-light PNGs: 601x399 (608x400 after the CLI's reflect pad: 15200
             latent tokens, whole 8x16 DCN tiles), its portrait 399x601, and
             333x250 (5376 tokens: below the fused attention's 8192); per image the
             shapes each kernel saw, the launches (vq_argmin 1, attention hopper 11
             above 8192 tokens and 0 below, dcn_hopper 2), the DCN impl (the
             conf's: the CLI runs no start-up audit) and ms; each written PNG held
             to the same function through the plain versions by main_path's bar
  dp_path    data parallelism (glare_tpu_torch/parallel) in spawned processes on
             this card, train_path's model and a global batch of 2: (a) NCCL at
             world size 1, a DDP step against the same step unwrapped (loss,
             gradients within 1e-6 of each largest, the update), with the ms per
             step of both in turns; (b) two ranks over gloo (NCCL refuses two
             ranks on one device), one image each, against the single-process
             step (loss 1e-5 relative, gradients 1e-3 of each largest), each
             rank's launches exactly train_path's per step, no plain version;
             (c) the stage-2 ActNorm init over the two ranks (one 160²
             crop each) against one process on both crops: 1e-5 of each
             tensor's largest with the networks in float64, 1e-4 (the float32
             ActNorm bar of train_stage2_path) in float32; (d) one FSDP2
             step (parallelize("fsdp")) at world size 1, held as (a) against
             the unwrapped step on the same contiguous weights (FSDP2 shards
             contiguous parameters only; cuDNN picks other algorithms for them)
Every path is driven with the launch counts (attention and DCN: one per entry,
see counters()) set to 0 just before and read just after; every attention launch
of a bf16 inference path must land on the hopper entry (of f32_attn_path on
hopper_f32), every DCN launch on the
Hopper DCN entries (dcn_hopper, dcn_hopper_cascade with dcn_cascade_select).
Then the contract lines: {"kernels": [...]}, the card line, and last
{"ok": true, "device": {...}}. Any failure raises: non-zero exit, no last line.

Imports torch, numpy, the standard library and glare_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py: torch.cuda.is_available() is False -- this script "
                     "measures on an NVIDIA GPU and does not run on the CPU\n")
    sys.exit(2)

import glare_tpu_torch  # noqa: E402  (sets the TF32 switches)
from glare_tpu_torch.ops import _build  # noqa: E402
from glare_tpu_torch.ops import attn as attn_ops  # noqa: E402
from glare_tpu_torch.ops import dcn as dcn_ops  # noqa: E402
from glare_tpu_torch.ops import vq as vq_ops  # noqa: E402
from glare_tpu_torch.utils import profiling  # noqa: E402

DEV = torch.device("cuda", 0)

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

H_IN, W_IN = 420, 620          # 400x600 protocol image + 20 px reflect pad
N_TOK = (H_IN // 4) * (W_IN // 4)   # 16275 latent tokens
N_PAD = -(-N_TOK // 2048) * 2048    # 16384: AttnBlock pads once to this
H2, W2 = 400, 600                   # stage 2 pads to a multiple of 4 only
N_TOK2 = (H2 // 4) * (W2 // 4)      # 15000 latent tokens

# Stage-wise check of the main path. Each stage is run three ways on the same
# inputs: bf16 through the kernels, bf16 through the plain versions, and in
# float32 through the plain versions (the truth both bf16 runs approximate).
# The kernel run's RMS distance from the float32 run may exceed the plain bf16
# run's by at most this factor, plus STAGE_ABS_SLACK of the reference's RMS for
# stages where both distances are near zero.
STAGE_RATIO = 1.25
STAGE_ABS_SLACK = 1e-3

# float32 attention: the kernel's largest error against a float64 dense oracle
# may be at most this factor times the plain float32 version's own error.
F32_ORACLE_RATIO = 2.0
# f32_attn_path: each stage of the fused (hopper_f32) run against the chunked run
# on the same inputs, relative RMS: float32 rounding of two attention orders
# spread by the network; a wrong kernel is off by the order of the values.
F32_STAGE_TOL = 1e-4
PEAK_TF32 = 495e12  # dense TF32 tensor-core rate (data sheet)


T_START = time.time()


def emit(obj):
    """One JSON line; a phase's line carries ``t_s``, the script's seconds when it
    ended (a phase's time is the difference from the line before)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.time() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound(flops, peak, nbytes):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def dev(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------ phases --

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(),
            f"nvidia-smi failed (exit {smi.returncode}): {smi.stderr.strip()[:200]}")
    card = smi.stdout.strip().splitlines()[0]
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    return card


def phase_build():
    t0 = time.time()
    paths = _build.build_all()
    for name in paths:
        _build.load(name)
    regs = {}
    for name, log in _build.build_log.items():
        regs[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln][:16]
    reports = {"vq_argmin": {"layout": vq_ops.layout(8192, 3)},
               "attn_hopper": {"smem_bytes": attn_ops.hopper_smem_bytes()},
               "attn_hopper_f32": {"smem_bytes": attn_ops.hopper_f32_smem_bytes()},
               "attn_fused": {}, "dcn_fwd": {"f32_smem_bytes": {O: dcn_ops.f32_smem_bytes(O) for O in dcn_ops.F32_O}},
               "dcn_bwd": {},
               "dcn_hopper": {"smem_bytes": {O: dcn_ops.hopper_smem_bytes(O) for O in (128, 256)}}}
    for name, rep in reports.items():
        log = _build.build_log.get(name)
        if log is None:  # not built by this process (an up-to-date library was loaded)
            continue
        # ptxas -v of every kernel in the source: registers, spills; a spill, or
        # warning C7515 (ptxas serialized the wgmma pipeline), fails the run
        regs_ = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [(int(a), int(b)) for a, b in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        require(regs_ and spills, f"no ptxas report for {name}")
        rep.update(registers=regs_, spill_bytes=[a + b for a, b in spills],
                   c7515=[ln.strip() for ln in log.splitlines() if "C7515" in ln])
        require(all(a == 0 and b == 0 for a, b in spills), f"{name} spills registers: {rep}")
        require(not rep["c7515"], f"{name}: ptxas serialized wgmma (C7515): {rep['c7515']}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "nvcc_seconds": round(_build.build_seconds, 2),
          "libraries": sorted(paths), "ptxas": regs, **reports})


def vq_gap(z, e, got, want):
    """For index arrays ``got`` and ``want`` over tokens z[N, D] and codes
    e[K, D]: (largest relative gap, largest absolute gap, number of differing
    indices) of the float64 squared distances to the two chosen codes."""
    z64, e64 = z.astype(np.float64), e.astype(np.float64)
    dg = ((z64 - e64[got.astype(np.int64)]) ** 2).sum(axis=1)
    dw = ((z64 - e64[want.astype(np.int64)]) ** 2).sum(axis=1)
    gap = np.abs(dg - dw)
    rel = gap / np.maximum(dw, 1e-30)
    return float(rel.max()), float(gap.max()), int((got != want).sum())


def _vq_profile(zt, et, calls):
    """torch.profiler over ``calls`` nearest_code_cuda calls -> (the device
    kernels it saw, with their launch counts; mean device ms per call)."""
    from torch.profiler import ProfilerActivity, profile
    vq_ops.nearest_code_cuda(zt, et)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            vq_ops.nearest_code_cuda(zt, et)
        torch.cuda.synchronize()
    kernels, us = {}, 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.self_device_time_total > 0:
            kernels[ev.key[:80]] = ev.count
            us += ev.self_device_time_total
    return kernels, us / calls / 1e3


def check_vq():
    """vq_argmin vs nearest_code_ref. Rule: indices equal wherever the best and
    second-best distances differ by more than 1e-6 relative; for every
    mismatch the two chosen codes' true (float64) distances agree to 1e-6;
    exact ties (duplicated codes, also across the kernel's codebook slices)
    to the lowest index. The error reported for this kernel is measured over
    every token of every case: the largest |d(z, e[kernel's index]) -
    d(z, e[plain index])| in float64, which is 0 exactly when no index
    differs (or only between exact ties). Timed alone and through the
    wrapper at the three token counts of the paths."""
    rng = np.random.default_rng(0)
    out = {}
    worst_abs = [0.0]

    def compare(zt, et, tag):
        got = vq_ops.nearest_code_cuda(zt, et)
        torch.cuda.synchronize()
        want = vq_ops.nearest_code_ref(zt, et)
        require(got.dtype == torch.int32 and got.shape == want.shape, f"vq {tag}: bad output")
        g, w = got.cpu().numpy(), want.cpu().numpy()
        z, e = zt.float().cpu().numpy(), et.float().cpu().numpy()   # the values both saw
        worst_rel, gap_abs, n_mism = vq_gap(z, e, g, w)
        require(worst_rel <= 1e-6,
                f"vq {tag}: a token picked a code {worst_rel:.3e} (relative) farther")
        worst_abs[0] = max(worst_abs[0], gap_abs)
        out[tag] = {"n": int(zt.shape[0]), "dtype": str(zt.dtype).split(".")[-1],
                    "strides": list(zt.stride()), "mismatches": n_mism, "worst_rel_gap": worst_rel,
                    "max_abs_dist_gap": gap_abs}
        return g

    def exact_ties(zt, et, tag):
        """Every token is a copy of a code: the kernel must return the lowest
        index of that code's duplicates."""
        g = compare(zt, et, tag)
        z, e = zt.float().cpu().numpy(), et.float().cpu().numpy()
        lowest = np.array([np.flatnonzero((e == row).all(axis=1))[0] for row in z])
        require((g == lowest).all(), f"vq {tag}: exact ties must go to the lowest index "
                                     f"({int((g != lowest).sum())} tokens did not)")

    K = 8192
    z = (rng.standard_normal((N_TOK, 3)) * 0.5).astype(np.float32)
    e = (rng.standard_normal((K, 3)) * 0.5).astype(np.float32)
    zt, et = dev(z), dev(e)
    compare(zt, et, "main[16275x3 vs 8192]")
    # constructed near-ties: duplicated codes (exact ties -> lowest index) and
    # tokens on the midpoint between two codes
    e2 = e[:1024].copy()
    e2[700:764] = e2[100:164]
    z2 = np.concatenate([e2[700:764], 0.5 * (e2[:200] + e2[200:400]),
                         (rng.standard_normal((37, 3)) * 0.5).astype(np.float32)]).astype(np.float32)
    compare(dev(z2), dev(e2), "near_tie[301x3 vs 1024]")
    exact_ties(dev(z2[:64]), dev(e2), "exact ties[64x3 vs 1024]")
    # duplicates across the kernel's codebook slices at K = 8192: at every slice
    # boundary, a slice's first code copies the previous slice's last and a code
    # of slice 0; the upper half copies some of the lower; the last code the first
    lay = vq_ops.layout(K, 3)
    per = lay["codes_per_slice"]
    ed = e.copy()
    for s_ in range(1, lay["slices"]):
        ed[s_ * per] = ed[s_ * per - 1]
        ed[s_ * per + 3] = ed[3 + s_]
    ed[K // 2 + 200:K // 2 + 216] = ed[200:216]
    ed[40] = ed[20]                                   # two groups of one slice
    ed[K - 1] = ed[0]
    pick = np.concatenate([[s_ * per for s_ in range(1, lay["slices"])],
                           [s_ * per + 3 for s_ in range(1, lay["slices"])],
                           np.arange(K // 2 + 200, K // 2 + 216), [40, K - 1]])
    zd = np.concatenate([ed[pick], z[:3000]]).astype(np.float32)
    compare(dev(zd), dev(ed), "cross-slice duplicates + 3000 random")
    exact_ties(dev(ed[pick]), dev(ed), "cross-slice exact ties")
    # ragged token counts: one token, a CTA's tile and one more / one less
    tile = lay["tokens_per_cta"]
    for n in (1, tile - 1, tile + 1):
        compare(dev(z[:n]), et, f"N={n}[{n}x3 vs 8192]")
    before = vq_ops.launches
    empty = vq_ops.nearest_code_cuda(dev(z[:0]), et)
    require(empty.shape == (0,) and vq_ops.launches == before, "vq: N = 0 must launch nothing")
    # the caller's dtype and strides: bf16 z; z as VectorQuantizer2 makes it from
    # an NCHW latent at B = 1 (a strided view, strides (1, H*W)); a column slice;
    # a transposed-view codebook
    zb = dev(z, torch.bfloat16)
    compare(zb, et, "bf16 z[16275x3 vs 8192]")
    nchw = dev(np.ascontiguousarray(z.reshape(1, H_IN // 4, W_IN // 4, 3).transpose(0, 3, 1, 2)))
    zs = nchw.permute(0, 2, 3, 1).reshape(-1, 3)
    require(not zs.is_contiguous() and zs.stride() == (1, N_TOK), f"vq: {zs.stride()}")
    compare(zs, et, "strided z (B=1 NCHW view)[16275x3 vs 8192]")
    wide = dev(rng.standard_normal((2000, 6)).astype(np.float32))
    compare(wide[:, ::2], et, "column-slice z[2000x3 vs 8192]")
    compare(wide.to(torch.bfloat16)[:, ::2], et, "column-slice bf16 z[2000x3 vs 8192]")
    compare(zt[:4000], dev(np.ascontiguousarray(e.T)).t(), "transposed codebook[4000x3 vs 8192]")
    # generic D and a ragged K
    z3 = rng.standard_normal((77, 7)).astype(np.float32)
    e3 = rng.standard_normal((333, 7)).astype(np.float32)
    compare(dev(z3), dev(e3), "ragged[77x7 vs 333]")
    kernels, _ = _vq_profile(zt, et, 1)
    require(list(kernels.values()) == [1] and "vq_argmin" in next(iter(kernels)),
            f"vq: one nearest_code_cuda call launched {kernels}")

    # times at the paths' token counts: stage 3 B = 1 and B = 2, stage 2
    by_n = {}
    for n in (N_TOK, 2 * N_TOK, N_TOK2):
        zn = dev((rng.standard_normal((n, 3)) * 0.5).astype(np.float32))
        compare(zn, et, f"timed[{n}x3 vs 8192]")
        b_ms, b_by = bound(2.0 * n * K * 4, PEAK_F32, 4.0 * (n * 3 + K * 3 + n))
        kern = _vq_profile(zn, et, 20)[1]
        by_n[n] = {"kernel_ms": kern, "ms": time_ms(lambda: vq_ops.nearest_code_cuda(zn, et), reps=20),
                   "plain_ms": time_ms(lambda: vq_ops.nearest_code_ref(zn, et)),
                   "library_ms": time_ms(lambda: torch.cdist(zn, et).argmin(dim=1)),
                   "bound_ms": b_ms, "bound_by": b_by, "kernel_share_of_bound": b_ms / kern}
    main = by_n[N_TOK]
    return {"name": "vq_argmin", "route": "cuda", "source": "glare_tpu_torch/csrc/vq_argmin.cu",
            "replaces": "glare_tpu/ops/vq.py:42", "max_abs_err": worst_abs[0],
            "mismatches": sum(c["mismatches"] for c in out.values()),
            "tol": "exact indices; near-ties within 1e-6 relative true distance; exact ties to the "
                   "lowest index; max_abs_err is the largest float64 distance gap between the "
                   "kernel's and the plain code",
            "ms": main["ms"], "kernel_ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library_call": "torch.cdist + argmin", "layout": lay, "profiled_kernels_per_call": kernels,
            "note": "ms: the wrapper nearest_code_cuda, CUDA events around one call (host work "
                    "included); kernel_ms: the kernel's device time by torch.profiler, mean of 20 "
                    "calls; by_shape: stage 3 B = 1, B = 2, stage 2",
            "by_shape": {f"N={n}": t for n, t in by_n.items()}, "cases": out}


def _sdpa_by_backend(q, k, v, n_true, want):
    """The yardstick: one F.scaled_dot_product_attention call on the real keys,
    under each backend of torch.nn.attention.sdpa_kernel. -> {backend: ms, or
    the reason it refused}. The port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = q[:, None], k[:, None, :n_true].contiguous(), v[:, None, :n_true].contiguous()
    out = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            out[name.lower()] = {"refused": "not in this PyTorch"}
            continue
        fn = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
        try:
            with sdpa_kernel([backend]):
                got = fn()
                torch.cuda.synchronize()
                err = float((got[:, 0, :n_true].float() - want).abs().max())
                out[name.lower()] = {"ms": time_ms(fn, reps=3, warmup=1), "max_abs_err_vs_plain": err}
        except RuntimeError as ex:  # a backend may refuse head dim 512
            out[name.lower()] = {"refused": str(ex).splitlines()[0][:160]}
        torch.cuda.empty_cache()
    return out


def check_attn():
    """The attention entries against flash_attention_nhc_ref. Tolerance for bf16:
    kernel and plain version cast at the same points, so they differ by
    summation order and exp2 rounding, i.e. by last-bit flips of the bf16
    probabilities and output: 2^-7 of the largest output (one to two bf16 ulps);
    4x that against a float64 dense oracle on 64 queries. float32: 5e-5 (exp2f
    vs torch.exp2 and the order of sums), and against a float64 dense oracle
    (every query row) at most F32_ORACLE_RATIO x the plain version's own error:
    float32 means float32, so 3xTF32 must be as good as float32."""
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the float32 plain version would not be")
    rng = np.random.default_rng(1)
    cases = {}

    def compare(tag, q, k, v, nt, entry, tl=None):
        before = dict(attn_ops.launches_by_entry)
        got = attn_ops.flash_attention_nhc_cuda(q, k, v, n_true=nt, entry=entry)
        torch.cuda.synchronize()
        moved = {e: attn_ops.launches_by_entry[e] - before[e] for e in before}
        want_entry = entry or attn_ops.route(q)
        require(moved == {e: int(e == want_entry) for e in before}, f"attn {tag}: entry counts {moved}")
        want = attn_ops.flash_attention_nhc_ref(q, k, v, n_true=nt)
        g, w = got[:, :nt].float(), want[:, :nt].float()
        require(bool(torch.isfinite(got.float()).all()), f"attn {tag}: non-finite output")
        err = float((g - w).abs().max())
        tol = tl if tl is not None else 2.0 ** -7 * float(w.abs().max())
        cases[tag] = {"entry": want_entry, "max_abs_err": err, "tol": tol}
        require(err <= tol, f"attn {tag}: {err} > {tol}")
        if q.dtype == torch.float32:  # against the float64 oracle, beside the plain version
            oracle = _dense_f64(q[:, :nt], k, v, nt)
            e_kernel, e_plain = (float((o[:, :nt].double() - oracle).abs().max()) for o in (got, want))
            cases[tag].update(oracle_err=e_kernel, plain_oracle_err=e_plain,
                              oracle_ratio=e_kernel / max(e_plain, 1e-30))
            if want_entry == "hopper_f32":
                require(e_kernel <= F32_ORACLE_RATIO * e_plain,
                        f"attn {tag}: {e_kernel:.3e} from the float64 oracle, more than "
                        f"{F32_ORACLE_RATIO} x the plain version's {e_plain:.3e}")
        return got, w, tol

    # main-path shape: one image's 16275 tokens padded to 16384, C = 512, bf16
    q, k, v = [dev(rng.standard_normal((1, N_PAD, 512)).astype(np.float32), torch.bfloat16)
               for _ in range(3)]
    got, w, tol = compare("bf16[1,16384,512] n_true=16275", q, k, v, N_TOK, None)
    err = cases["bf16[1,16384,512] n_true=16275"]["max_abs_err"]
    # dense float64 oracle on a slice of queries (independent of the tiling)
    qs = q[:, 5000:5064].double()
    s = (qs @ k[:, :N_TOK].double().transpose(1, 2)) * 512 ** -0.5
    dense = torch.softmax(s, dim=-1) @ v[:, :N_TOK].double()
    err64 = float((got[:, 5000:5064].double() - dense).abs().max())
    cases["bf16 vs float64 dense, 64 queries"] = {"entry": "hopper", "max_abs_err": err64, "tol": 4 * tol}
    require(err64 <= 4 * tol, f"attn bf16 vs dense oracle: {err64}")
    # the earlier wmma kernel (csrc/attn_fused.cu) at the same shape, for its time
    compare("bf16[1,16384,512] n_true=16275, wmma entry", q, k, v, N_TOK, "wmma")

    # batch 2 at the main shape, and small ragged shapes through whichever entry
    # the wrapper picks (C = 512 -> hopper, other bf16 -> wmma, f32 -> f32)
    plan = [(2, N_PAD, 512, N_TOK, torch.bfloat16, None),
            (1, 2100, 512, 2047, torch.bfloat16, None),   # a query tile partly past n
            (1, 130, 512, 97, torch.bfloat16, None),
            (2, 333, 96, 301, torch.float32, 5e-5),
            (2, 200, 64, 200, torch.float32, 5e-5),
            (1, 2100, 128, 1999, torch.float32, 5e-5),    # ragged: n and n_true not multiples of 64
            (1, 130, 510, 97, torch.float32, 5e-5),       # C % 4 != 0: the scalar edge
            (2, 333, 96, 301, torch.bfloat16, None),
            (1, 130, 128, 97, torch.bfloat16, None),
            (1, 130, 256, 97, torch.bfloat16, None)]
    for (b, n, c, nt, dt, tl) in plan:
        qq, kk, vv = [dev(rng.standard_normal((b, n, c)).astype(np.float32), dt) for _ in range(3)]
        compare(f"{str(dt).split('.')[-1]}[{b},{n},{c}] n_true={nt}", qq, kk, vv, nt, None, tl)
        del qq, kk, vv
    torch.cuda.empty_cache()

    ms = time_ms(lambda: attn_ops.flash_attention_nhc_cuda(q, k, v, n_true=N_TOK), reps=10)
    wmma_ms = time_ms(lambda: attn_ops.flash_attention_nhc_cuda(q, k, v, n_true=N_TOK, entry="wmma"),
                      reps=5)
    plain = time_ms(lambda: attn_ops.flash_attention_nhc_ref(q, k, v, n_true=N_TOK), reps=3, warmup=1)
    sdpa = _sdpa_by_backend(q, k, v, N_TOK, w)
    accepted = {name: r["ms"] for name, r in sdpa.items() if "ms" in r}
    lib = min(accepted.values()) if accepted else None
    flops = 4.0 * N_TOK * N_TOK * 512
    b_ms, b_by = bound(flops, PEAK_BF16, 2.0 * 4 * N_TOK * 512)
    del q, k, v, got, w
    torch.cuda.empty_cache()
    # float32 at the main shape: the 3xTF32 entry and the earlier SIMT kernel, each
    # against the plain version and the float64 oracle, timed in turns
    q, k, v = [dev(rng.standard_normal((1, N_PAD, 512)).astype(np.float32)) for _ in range(3)]
    main32 = "float32[1,16384,512] n_true=16275"
    _, w32, _ = compare(main32, q, k, v, N_TOK, None, 5e-5)
    compare(main32 + ", f32_simt entry", q, k, v, N_TOK, "f32_simt", 5e-5)
    f32_turns = [time_ms(lambda: attn_ops.flash_attention_nhc_cuda(q, k, v, n_true=N_TOK, entry=e),
                         reps=5, warmup=1) for e in ("hopper_f32", "f32_simt", "f32_simt", "hopper_f32")]
    f32_ms, simt_ms = statistics.median(f32_turns[0::3]), statistics.median(f32_turns[1:3])
    f32_plain = time_ms(lambda: attn_ops.flash_attention_nhc_ref(q, k, v, n_true=N_TOK), reps=3, warmup=1)
    sdpa32 = _sdpa_by_backend(q, k, v, N_TOK, w32)
    acc32 = {name: r["ms"] for name, r in sdpa32.items() if "ms" in r}
    # two bounds: the float32 function on the float32 units, and the three TF32
    # products of each multiply-add on the tensor cores (the kernel's operations)
    f32_units_ms, f32_units_by = bound(flops, PEAK_F32, 4.0 * 4 * N_TOK * 512)
    tf32x3_ms, tf32x3_by = bound(3 * flops, PEAK_TF32, 4.0 * 4 * N_TOK * 512)
    del q, k, v, w32
    torch.cuda.empty_cache()
    main = "bf16[1,16384,512] n_true=16275"
    common = {"route": "cuda", "replaces": "glare_tpu/ops/attn_pallas.py:44",
              "tol": f"bf16: 2^-7 * max|ref| = {tol:.4g} (last-bit flips, summation order); f32: 5e-5"}
    hopper = {"name": "attn_hopper", "source": "glare_tpu_torch/csrc/attn_hopper.cu", **common,
              "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": lib,
              "library_call": "F.scaled_dot_product_attention, fastest backend that takes head dim 512",
              "achieved_tflops": flops / ms / 1e9, "smem_bytes": attn_ops.hopper_smem_bytes(),
              "sdpa_by_backend": sdpa, "cases": {t: c for t, c in cases.items() if c.get("entry") == "hopper"}}
    wmma = {"name": "attn_wmma", "source": "glare_tpu_torch/csrc/attn_fused.cu", **common,
            "max_abs_err": cases[main + ", wmma entry"]["max_abs_err"], "ms": wmma_ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "achieved_tflops": flops / wmma_ms / 1e9,
            "note": "the first kernel's bf16 entry, timed at the main shape through entry='wmma'; "
                    "the paths launch it for no call",
            "cases": {t: c for t, c in cases.items() if c.get("entry") == "wmma"}}
    lib32 = min(acc32.values()) if acc32 else None
    f32_common = {"plain_ms": f32_plain, "library_ms": lib32, "sdpa_by_backend": sdpa32,
                  "bound_f32_units_ms": f32_units_ms, "bound_tf32x3_ms": tf32x3_ms,
                  "f32_turns_ms": [list(p) for p in zip(("hopper_f32", "f32_simt", "f32_simt", "hopper_f32"),
                                                         f32_turns)]}
    common32 = {**common, "replaces": "glare_tpu/ops/attn_pallas.py:44",
                "tol": f"5e-5 against the plain version; against a float64 dense oracle at most "
                       f"{F32_ORACLE_RATIO} x the plain version's error"}
    f32 = {"name": "attn_f32", "source": "glare_tpu_torch/csrc/attn_hopper_f32.cu", **common32,
           "max_abs_err": cases[main32]["max_abs_err"], "ms": f32_ms, "f32_simt_ms": simt_ms,
           "bound_ms": tf32x3_ms, "bound_by": tf32x3_by, **f32_common,
           "oracle_err": cases[main32]["oracle_err"], "plain_oracle_err": cases[main32]["plain_oracle_err"],
           "note": "entry hopper_f32 (3xTF32 on wgmma) at the main shape; bound_ms: the three TF32 "
                   "products at 495 TFLOP/s (bound_f32_units_ms: the function on the 67 TFLOP/s "
                   "float32 units); f32_attn_path launches it",
           "achieved_tflops": flops / f32_ms / 1e9,
           "cases": {t: c for t, c in cases.items() if c.get("entry") == "hopper_f32"}}
    simt = {"name": "attn_f32_simt", "source": "glare_tpu_torch/csrc/attn_fused.cu", **common32,
            "max_abs_err": cases[main32 + ", f32_simt entry"]["max_abs_err"], "ms": simt_ms,
            "bound_ms": f32_units_ms, "bound_by": f32_units_by, **f32_common,
            "oracle_err": cases[main32 + ", f32_simt entry"]["oracle_err"],
            "note": "the earlier float32 kernel (float32 units, entry f32_simt), timed in turns with "
                    "hopper_f32; no path launches it", "achieved_tflops": flops / simt_ms / 1e9,
            "cases": {t: c for t, c in cases.items() if c.get("entry") == "f32_simt"}}
    return hopper, wmma, f32, simt


def _dense_f64(q, k, v, nt, rows=2048):
    """softmax(q k^T / sqrt(C)) v over the first nt keys in float64, from the
    unscaled inputs, a block of query rows at a time -> [B, n, C] float64."""
    c = q.shape[-1]
    kt, vv = k[:, :nt].double().transpose(1, 2), v[:, :nt].double()
    out = []
    for r0 in range(0, q.shape[1], rows):
        s = (q[:, r0:r0 + rows].double() @ kt) * c ** -0.5
        out.append(torch.softmax(s, dim=-1) @ vv)
    return torch.cat(out, dim=1)


def _dcn_inputs(rng, B, H, W, C, G, O, dtype, spread, edges=False):
    """Seeded DCN inputs. ``edges``: offsets that point out of the image at every
    border (5-7 px outward on the two outer rows and columns), and the mask
    exactly 0 on every fourth row and exactly 1 on the row after it."""
    x = dev(rng.standard_normal((B, H, W, C)).astype(np.float32), dtype)
    off = (spread * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32)
    mask = rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32)
    if edges:
        out = lambda *shape: (5.0 + 2.0 * rng.uniform(0, 1, shape)).astype(np.float32)  # noqa: E731
        off[:, :2, ..., 0] = -out(B, 2, W, G, 9)
        off[:, -2:, ..., 0] = out(B, 2, W, G, 9)
        off[:, :, :2, ..., 1] = -out(B, H, 2, G, 9)
        off[:, :, -2:, ..., 1] = out(B, H, 2, G, 9)
        mask[:, 0::4] = 0.0
        mask[:, 1::4] = 1.0
    wgt = dev((rng.standard_normal((3, 3, C, O)) / math.sqrt(9 * C)).astype(np.float32))
    bias = dev((0.1 * rng.standard_normal(O)).astype(np.float32))
    return x, dev(off), dev(mask), wgt, bias


def _dcn_bound(B, H, W, C, G, O, es):
    """Least time of one pass: x, offset, mask, weight (in x's type) and bias read
    once, the output written once; 2*P*9*C*O FLOP on the tensor cores (bf16) or
    the float32 units."""
    P = B * H * W
    nbytes = P * C * es + P * G * 9 * 3 * 4 + 9 * C * O * es + O * 4 + P * O * es
    return bound(2.0 * P * 9 * C * O, PEAK_BF16 if es == 2 else PEAK_F32, nbytes)


def _dcn_tol(dt, want):
    """bf16: kernel and plain version round the sampled column and the output to
    bf16 at the same points; a last-bit flip of either costs up to two bf16 ulps
    (2^-7) of the output. f32: only the order of ~9*C float32 sums differs."""
    return 2.0 ** -7 * max(float(want.float().abs().max()), 1.0) if dt == torch.bfloat16 else 2e-4


def _library_dcn(x, off, mask, wgt, bias, max_offset):
    """torchvision.ops.deform_conv2d (exact modulated DCNv2, NCHW), where
    torchvision is installed: the kernels' function once the offsets are
    clamped beforehand. Its layouts (offset [B, G*9*2, H, W] as (g, k, (dy, dx)),
    mask [B, G*9, H, W], weight OIHW) are made outside the timed call; it runs in
    x's dtype, or in float32 where it refuses that. -> dict or None."""
    try:
        from torchvision.ops import deform_conv2d
    except ImportError:
        return None
    B, H, W, _ = x.shape
    G, O = off.shape[3], wgt.shape[-1]
    r = dcn_ops.clamp_table(max_offset, G).to(x.device)[None, None, None, :, :, None]
    o = torch.minimum(torch.maximum(off, -r), r).reshape(B, H, W, G * 18).permute(0, 3, 1, 2).contiguous()
    m = mask.reshape(B, H, W, G * 9).permute(0, 3, 1, 2).contiguous()
    for dt in dict.fromkeys((x.dtype, torch.float32)):
        a = (x.permute(0, 3, 1, 2).contiguous().to(dt), o.to(dt), wgt.permute(3, 2, 0, 1).contiguous().to(dt),
             bias.to(dt), m.to(dt))
        call = lambda a=a: deform_conv2d(a[0], a[1], a[2], a[3], padding=1, mask=a[4])  # noqa: E731
        try:
            out = call()
        except RuntimeError as e:
            refused = str(e).splitlines()[0]
            continue
        got = out.permute(0, 2, 3, 1).float()
        return {"dtype": str(dt).split(".")[-1], "ms": time_ms(call),
                "got": got, "refused": None if dt == x.dtype else refused}
    return {"dtype": None, "ms": None, "got": None, "refused": refused}


DCN_ENTRY_KEY = {"hopper": "dcn_hopper", "wmma": "dcn_fwd", "f32": "dcn_fwd_f32", "f32_flat": "dcn_fwd"}
CASCADE_ENTRY_KEY = {"hopper": "dcn_hopper_cascade", "wmma": "dcn_cascade_fwd", "f32": "dcn_cascade_fwd",
                     "f32_flat": "dcn_cascade_fwd"}


def _want_entry(dt, C, G, O):
    """The entry the routing rule gives (ops.dcn.route, restated here)."""
    if dt == torch.float32:
        return "f32" if C % 16 == 0 and (C // G) % 8 == 0 and O in (64, 128, 256) else "f32_flat"
    return "hopper" if C % 64 == 0 and (C // G) % 32 == 0 and O in (128, 256) else "wmma"


def check_dcn():
    """Every DCN entry against modulated_deform_conv_ref, through the entry
    ops.dcn.route picks: the paths' shapes in bf16 go to the Hopper entry
    (csrc/dcn_hopper.cu), float32 and other widths to the first kernel
    (csrc/dcn_fwd.cu). The Hopper entry's edges: H and W that are not
    multiples of the 8 x 16 tile, B = 2, offsets out of the image at every
    border, corners outside the halo (exact +-6 px, per-tap radii up to 4),
    mask 0 and 1, Cg 128 / 64 / 32. The `pallas` counter (taps beyond the
    clamp) equals the plain version's exactly. -> (Hopper row, first-kernel row,
    the cases of the tiled float32 entry)."""
    rng = np.random.default_rng(2)
    per_tap = tuple(tuple(int(r) for r in row) for row in rng.integers(1, 5, (4, 9)))
    cases, timed = {}, {}
    H0, W0, H1, W1 = H_IN // 2, W_IN // 2, H_IN, W_IN
    # (tag, B, H, W, C, G, O, dtype, offset spread px, max_offset, edges, timed as)
    plan = [
        ("warp_0 bf16 clamp2", 1, H0, W0, 256, 4, 256, torch.bfloat16, 1.5, 2, False, "warp_0"),
        ("warp_1 bf16 clamp2", 1, H1, W1, 128, 4, 128, torch.bfloat16, 1.5, 2, False, "warp_1"),
        ("warp_0 bf16 clamp2 B=2", 2, H0, W0, 256, 4, 256, torch.bfloat16, 1.5, 2, False, "warp_0 B=2"),
        ("warp_1 bf16 clamp2 B=2", 2, H1, W1, 128, 4, 128, torch.bfloat16, 1.5, 2, False, "warp_1 B=2"),
        ("warp_0 bf16 exact +-6px", 1, H0, W0, 256, 4, 256, torch.bfloat16, 3.0, None, False, None),
        ("warp_1 bf16 per-tap", 1, H1, W1, 128, 4, 128, torch.bfloat16, 3.0, per_tap, False, None),
        ("warp_0 f32 exact +-6px", 1, H0, W0, 256, 4, 256, torch.float32, 3.0, None, False, None),
        ("warp_1 f32 clamp2", 1, H1, W1, 128, 4, 128, torch.float32, 3.0, 2, False, None),
        ("ragged f32 exact", 2, 13, 17, 24, 4, 20, torch.float32, 3.0, None, False, None),
        ("ragged f32 per-tap", 2, 13, 17, 24, 4, 20, torch.float32, 3.0, per_tap, False, None),
        ("ragged f32 O=64 Cg 8 clamp2", 2, 13, 17, 32, 4, 64, torch.float32, 3.0, 2, False, None),
        ("small bf16 clamp2", 2, 13, 17, 32, 4, 48, torch.bfloat16, 3.0, 2, False, None),
        ("small bf16 Cg=4 exact", 1, 9, 70, 16, 4, 16, torch.bfloat16, 3.0, None, False, None),
        ("edge 13x17 C=O=256 clamp2", 1, 13, 17, 256, 4, 256, torch.bfloat16, 1.5, 2, True, None),
        ("edge 13x17 C=O=256 B=2 exact +-6px", 2, 13, 17, 256, 4, 256, torch.bfloat16, 3.0, None, True, None),
        ("edge 9x70 C=O=128 B=2 per-tap", 2, 9, 70, 128, 4, 128, torch.bfloat16, 3.0, per_tap, True, None),
        ("edge 9x70 C=O=128 clamp2", 1, 9, 70, 128, 4, 128, torch.bfloat16, 1.5, 2, True, None),
        ("edge 21x33 C=64 G=2 (Cg 32) O=128 exact", 1, 21, 33, 64, 2, 128, torch.bfloat16, 3.0, None, True, None),
        ("edge 13x17 C=256 G=8 (Cg 32) O=128 clamp2", 2, 13, 17, 256, 8, 128, torch.bfloat16, 1.5, 2, True, None),
        ("edge 13x17 C=256 G=2 (Cg 128) O=256 clamp2", 1, 13, 17, 256, 2, 256, torch.bfloat16, 1.5, 2, True, None),
    ]
    for (tag, B, H, W, C, G, O, dt, spread, mo, edges, timed_as) in plan:
        x, off, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, dt, spread, edges)
        entry = dcn_ops.route(x, off, wgt)
        require(entry == _want_entry(dt, C, G, O), f"dcn {tag}: routed to {entry}")
        before = counters()
        got, ov = dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=mo,
                                                     return_overflow=True)
        torch.cuda.synchronize()
        require(moved_since(before) == {**{k: 0 for k in before}, DCN_ENTRY_KEY[entry]: 1},
                f"dcn {tag}: counters {moved_since(before)}")
        want, wov = dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=mo,
                                                      return_overflow=True)
        require(got.shape == want.shape and got.dtype == dt, f"dcn {tag}: bad output")
        require(bool(torch.isfinite(got.float()).all()), f"dcn {tag}: non-finite output")
        require(ov.tolist() == wov.tolist(), f"dcn {tag}: counter {ov.tolist()} != plain {wov.tolist()}")
        err = float((got.float() - want.float()).abs().max())
        tol = _dcn_tol(dt, want)
        frac_out = float(((off.abs() > 2).any(dim=-1)).float().mean())
        cases[tag] = {"entry": entry, "shape": [B, H, W, C, G, O], "max_abs_err": err, "tol": tol,
                      "overflow": ov.tolist(), "taps_beyond_2px": round(frac_out, 4)}
        require(err <= tol, f"dcn {tag}: {err} > {tol}")
        if timed_as:
            # the first kernel (entry wmma) on the same inputs, for its error and time;
            # timed as the model calls them: bf16 weight, the clamp table on the card
            radii = dcn_ops.clamp_table(mo, G).to(DEV)
            w16 = wgt.to(torch.bfloat16)
            old = dcn_ops.modulated_deform_conv_cuda(x, off, mask, w16, bias, max_offset=radii, entry="wmma")
            e_old = float((old.float() - want.float()).abs().max())
            require(e_old <= tol, f"dcn {tag}, wmma entry: {e_old} > {tol}")
            ms = time_ms(lambda: dcn_ops.modulated_deform_conv_cuda(x, off, mask, w16, bias, max_offset=radii,
                                                                    return_overflow=True), reps=10)
            ms_old = time_ms(lambda: dcn_ops.modulated_deform_conv_cuda(x, off, mask, w16, bias, max_offset=radii,
                                                                        entry="wmma"))
            t = {"ms": ms, "wmma_ms": ms_old, "max_abs_err": err, "wmma_max_abs_err": e_old}
            lib = _library_dcn(x, off, mask, wgt, bias, mo)
            t["library_ms"] = None if lib is None else lib["ms"]
            if lib is not None:   # a yardstick only: its distance from the plain version is reported
                got_lib = lib.pop("got")
                lib["max_abs_err"] = None if got_lib is None else float((got_lib - want.float()).abs().max())
                t["library"] = lib
            if B == 1:
                t["plain_ms"] = time_ms(lambda: dcn_ops.modulated_deform_conv_ref(
                    x, off, mask, wgt, bias, max_offset=mo), reps=3, warmup=1)
            t["bound_ms"], t["bound_by"] = _dcn_bound(B, H, W, C, G, O, x.element_size())
            flops = 2.0 * B * H * W * 9 * C * O
            t.update(achieved_tflops=flops / ms / 1e9, wmma_achieved_tflops=flops / ms_old / 1e9,
                     share_of_bound=t["bound_ms"] / ms)
            timed[timed_as] = t
            del old
        del x, off, mask, wgt, bias, got, want
        torch.cuda.empty_cache()
    main = [timed["warp_0"], timed["warp_1"]]   # the two launches of one get_sr
    mean = lambda key: sum(t[key] for t in main) / len(main)  # noqa: E731
    by = max(main, key=lambda t: t["bound_ms"])["bound_by"]
    lib_ms = None if any(t["library_ms"] is None for t in main) else mean("library_ms")
    note = ("ms / plain_ms / bound_ms / library_ms: mean per launch over the two shapes one get_sr gives it; "
            "library: torchvision.ops.deform_conv2d on pre-clamped offsets "
            + ("(torchvision is installed)" if _has_torchvision() else "(torchvision is not installed: null)"))
    lib_call = {} if lib_ms is None else {
        "library_call": f"torchvision.ops.deform_conv2d in {main[0]['library']['dtype']}, offsets clamped first"}
    hopper = {"name": "dcn_hopper", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_hopper.cu",
              "replaces": "glare_tpu/ops/dcn_pallas.py:55",
              "max_abs_err": max(t["max_abs_err"] for t in main),
              "tol": "bf16: 2^-7 * max(1, max|ref|); the pallas counter exact",
              "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"), "bound_by": by,
              "library_ms": lib_ms, **lib_call, "note": note, "smem_bytes": {O: dcn_ops.hopper_smem_bytes(O) for O in (128, 256)},
              "by_shape": timed, "cases": {k: c for k, c in cases.items() if c["entry"] == "hopper"}}
    first = {"name": "dcn_fwd", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_fwd.cu",
             "replaces": "glare_tpu/ops/dcn_pallas.py:55",
             "max_abs_err": max(t["wmma_max_abs_err"] for t in main),
             "tol": "bf16: 2^-7 * max(1, max|ref|); f32: 2e-4",
             "ms": mean("wmma_ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"), "bound_by": by,
             "library_ms": lib_ms, **lib_call,
             "note": note + "; the first kernel (entries wmma and f32_flat), timed at the paths' shapes "
                            "through entry='wmma'; the paths launch it for no call",
             "cases": {k: c for k, c in cases.items() if c["entry"] in ("wmma", "f32_flat")}}
    return hopper, first, {k: c for k, c in cases.items() if c["entry"] == "f32"}


def _has_torchvision():
    import importlib.util
    return importlib.util.find_spec("torchvision") is not None


def _cascade_offsets(rng, field, B, H, W, G):
    """Seeded offset fields for the cascade at R=2, R_tail=8:
    'bands'  in band (|d| <= 2) but for three bands of five rows, which reach
             7.5 px: at most six 8-row blocks, fewer than the 8 slots;
    'wide'   up to 7.5 px everywhere: every block is out of band, most overflow;
    'beyond' as 'bands', and 12 px spread: taps beyond R_tail, everywhere;
    'tail16' as 'bands', but the bands reach 15.5 px (for R_tail 16: corners far
             outside the kernel's staged halo)."""
    base = np.clip(1.0 * rng.standard_normal((B, H, W, G, 9, 2)), -2, 2)
    wide = np.clip(3.0 * rng.standard_normal((B, H, W, G, 9, 2)), -7.5, 7.5)
    if field in ("bands", "tail16"):
        off = base
        if field == "tail16":
            wide = np.clip(6.0 * rng.standard_normal((B, H, W, G, 9, 2)), -15.5, 15.5)
        for r0 in (H // 7, H // 2, H - 9):
            r0 = max(0, r0)
            off[:, r0:r0 + 5] = wide[:, r0:r0 + 5]
    elif field == "wide":
        off = wide
    else:
        off = 12.0 * rng.standard_normal((B, H, W, G, 9, 2))
    return dev(off.astype(np.float32))


def _check_cascade_case(tag, a, kw, field, cases, entry=None):
    """One cascade call through ``entry`` (None: the one route picks) against
    the plain version: output within tolerance, selection kernel equal to its
    plain version (row radii and both counters exact), and the field's own
    check against the same entry's non-cascade kernel. -> (output, row radii)."""
    x = a[0]
    entry = dcn_ops.route(x, a[1], a[3]) if entry is None else entry
    before = counters()
    got, ov = dcn_ops.modulated_deform_conv_cascade_cuda(*a, return_overflow=True, entry=entry, **kw)
    torch.cuda.synchronize()
    require(moved_since(before) == {**{k: 0 for k in before}, CASCADE_ENTRY_KEY[entry]: 1,
                                    "dcn_cascade_select": 1}, f"cascade {tag}: counters")
    want, wov = dcn_ops.modulated_deform_conv_cascade_ref(*a, return_overflow=True, **kw)
    require(got.shape == want.shape and got.dtype == x.dtype, f"cascade {tag}: bad output")
    require(bool(torch.isfinite(got.float()).all()), f"cascade {tag}: non-finite")
    require(ov.tolist() == wov.tolist(), f"cascade {tag}: counters {ov.tolist()} != "
                                         f"plain version's {wov.tolist()}")
    rr, sov = dcn_ops.cascade_select_cuda(a[1], **kw)
    wrr, _ = dcn_ops.cascade_row_radius(a[1], **kw)
    require(bool(torch.equal(rr, wrr)) and sov.tolist() == wov.tolist(),
            f"cascade {tag}: the selection kernel differs from its plain version")
    err = float((got.float() - want.float()).abs().max())
    tol = _dcn_tol(x.dtype, want)
    require(err <= tol, f"cascade {tag}: {err} > {tol}")
    row_sel = rr > float(kw["max_offset"])
    B, H = a[1].shape[:2]
    case = {"entry": entry, "shape": list(x.shape), "max_abs_err": err, "tol": tol, "overflow": ov.tolist(),
            "rows_at_tail_radius": int(row_sel.sum()), "rows": B * H, **kw}
    if field in ("bands", "tail16"):
        # both counters zero <=> exact DCNv2: also equal to the exact kernel
        require(ov.tolist() == [0, 0], f"cascade {tag}: {ov.tolist()} != [0, 0]")
        exact = dcn_ops.modulated_deform_conv_cuda(*a, max_offset=None, entry=entry)
        e2 = float((got.float() - exact.float()).abs().max())
        case["vs_exact_kernel"] = e2
        require(e2 <= tol, f"cascade {tag} vs exact kernel: {e2} > {tol}")
        require(case["rows_at_tail_radius"] > 0, f"cascade {tag}: nothing selected")
        require(field == "tail16" or case["rows_at_tail_radius"] < B * H, f"cascade {tag}: selection")
    elif field == "wide":
        # blocks that found no slot keep the clamp-R kernel's output, bit for bit
        require(ov[0].item() > 0 and ov[1].item() == 0, f"cascade {tag}: {ov.tolist()}")
        clamped = dcn_ops.modulated_deform_conv_cuda(*a, max_offset=kw["max_offset"], entry=entry)
        keep = ~row_sel
        require(bool(torch.equal(got[keep], clamped[keep])),
                f"cascade {tag}: overflowed blocks differ from the clamp-R kernel")
        require(not bool(torch.equal(got[row_sel], clamped[row_sel])),
                f"cascade {tag}: selected blocks were not recomputed")
    else:
        require(ov[1].item() > 0, f"cascade {tag}: no tap beyond R_tail counted")
    cases[tag] = case
    return got, rr


def check_dcn_cascade():
    """The cascade wrapper (selection kernel dcn_cascade_select + one pass of the
    routed entry) vs modulated_deform_conv_cascade_ref on the card, at the two
    shapes the hybrid path gives it, bf16 and float32, R=2, R_tail=8, capacity
    0.125; and on the Hopper entry's edges: R_tail 16 (corners far outside the
    halo), B = 2, H and W off the tile, offsets out of the image at every
    border, mask 0 and 1. The first kernel's cascades (entries wmma and
    f32_flat) are held to the same checks on the same inputs at both shapes;
    float32 routes to the tiled kernel's cascade (entry f32). Outputs within
    check_dcn's tolerance, the selection kernel's row radii and both counters
    exact. -> (Hopper cascade row, selection-kernel row, first-kernel cascade row)."""
    rng = np.random.default_rng(4)
    kw = dict(max_offset=2, tail_offset=8, capacity_frac=0.125)
    cases, timed = {}, {}
    shapes = [("warp_0", 1, H_IN // 2, W_IN // 2, 256, 4, 256), ("warp_1", 1, H_IN, W_IN, 128, 4, 128)]
    for (wname, B, H, W, C, G, O) in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x, _, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, dt, 1.0)
            for field in ("bands", "wide", "beyond"):
                tag = f"{wname} {str(dt).split('.')[-1]} {field}"
                off = _cascade_offsets(rng, field, B, H, W, G)
                a = (x, off, mask, wgt, bias)
                got, rr = _check_cascade_case(tag, a, kw, field, cases)
                if dt == torch.bfloat16:   # the first kernel's cascade on the same inputs
                    _check_cascade_case(f"{tag} [wmma]", a, kw, field, cases, entry="wmma")
                else:
                    _check_cascade_case(f"{tag} [f32_flat]", a, kw, field, cases, entry="f32_flat")
                if dt == torch.bfloat16 and field == "bands":
                    ms = time_ms(lambda: dcn_ops.modulated_deform_conv_cascade_cuda(
                        *a, return_overflow=True, **kw), reps=10)
                    sel_ms = time_ms(lambda: dcn_ops.cascade_select_cuda(off, **kw), reps=10)
                    kern_ms = time_ms(lambda: dcn_ops._launch("hopper", True, *a, rr), reps=10)  # no selection
                    torch_sel_ms = time_ms(lambda: dcn_ops.cascade_row_radius(off, **kw))
                    ms_old = time_ms(lambda: dcn_ops.modulated_deform_conv_cascade_cuda(
                        *a, return_overflow=True, entry="wmma", **kw))
                    plain = time_ms(lambda: dcn_ops.modulated_deform_conv_cascade_ref(
                        *a, return_overflow=True, **kw), reps=3, warmup=1)
                    b_ms, b_by = _dcn_bound(B, H, W, C, G, O, x.element_size())
                    sel_bytes = off.numel() * 4 + B * H * 4
                    timed[wname] = {"ms": ms, "selection_kernel_ms": sel_ms, "pass_alone_ms": kern_ms,
                                    "torch_selection_ms": torch_sel_ms, "wmma_wrapper_ms": ms_old,
                                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                                    "selection_bound_ms": sel_bytes / PEAK_BYTES * 1e3,
                                    "achieved_tflops": 2.0 * B * H * W * 9 * C * O / ms / 1e9,
                                    "max_abs_err": cases[tag]["max_abs_err"],
                                    "wmma_max_abs_err": cases[f"{tag} [wmma]"]["max_abs_err"]}
                del off, got, rr
            del x, mask, wgt, bias
            torch.cuda.empty_cache()
    # the Hopper entry's edges: (tag, B, H, W, C, G, O, field, kw)
    edges = [
        ("warp_1 bf16 R_tail16 tail16", 1, H_IN, W_IN, 128, 4, 128, "tail16",
         dict(max_offset=2, tail_offset=16, capacity_frac=1.0)),
        ("warp_0 bf16 B=2 bands", 2, H_IN // 2, W_IN // 2, 256, 4, 256, "bands",
         dict(max_offset=2, tail_offset=8, capacity_frac=0.25)),   # 12 out-of-band blocks, 16 slots
        ("13x17 C=O=256 B=2 R_tail16 tail16", 2, 13, 17, 256, 4, 256, "tail16",
         dict(max_offset=2, tail_offset=16, capacity_frac=1.0)),
        ("13x17 C=O=256 B=2 wide", 2, 13, 17, 256, 4, 256, "wide", kw),
        ("9x70 C=O=128 B=2 R_tail16 tail16", 2, 9, 70, 128, 4, 128, "tail16",
         dict(max_offset=2, tail_offset=16, capacity_frac=1.0)),
        ("9x70 C=O=128 B=2 beyond", 2, 9, 70, 128, 4, 128, "beyond", kw),
    ]
    for (tag, B, H, W, C, G, O, field, ekw) in edges:
        x, _, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, torch.bfloat16, 1.0, edges=True)
        off = _cascade_offsets(rng, field, B, H, W, G)
        if field == "tail16":   # and out of the image at every border, inside R_tail
            off[:, :2, ..., 0] = -6.0
            off[:, -2:, ..., 0] = 6.0
            off[:, :, :2, ..., 1] = -6.0
            off[:, :, -2:, ..., 1] = 6.0
        _check_cascade_case(tag, (x, off, mask, wgt, bias), ekw, field, cases)
        del x, off, mask, wgt, bias
        torch.cuda.empty_cache()
    main = [timed["warp_0"], timed["warp_1"]]
    mean = lambda key: sum(t[key] for t in main) / len(main)  # noqa: E731
    by = max(main, key=lambda t: t["bound_ms"])["bound_by"]
    cascade = {"name": "dcn_hopper_cascade", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_hopper.cu",
               "replaces": "glare_tpu/ops/dcn_pallas.py:448", "max_abs_err": max(t["max_abs_err"] for t in main),
               "tol": "bf16: 2^-7 * max(1, max|ref|); f32: 2e-4; both overflow counters exact",
               "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"), "bound_by": by,
               "library_ms": None,
               "note": "ms: the whole wrapper (selection kernel + one pass of the Hopper entry), mean per "
                       "call over the two shapes one hybrid get_sr gives it; bound: one pass's work",
               "by_shape": timed, "cases": {k: c for k, c in cases.items() if c["entry"] == "hopper"}}
    select = {"name": "dcn_cascade_select", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_hopper.cu",
              "replaces": "glare_tpu/ops/dcn_pallas.py:448 (the cascade's block selection)",
              "max_abs_err": 0.0, "tol": "row radii and both counters equal to cascade_row_radius's",
              "ms": mean("selection_kernel_ms"), "plain_ms": mean("torch_selection_ms"),
              "bound_ms": mean("selection_bound_ms"), "bound_by": "bytes", "library_ms": None,
              "note": "ms: the selection alone (zeroing of its scratch + one launch); plain: the torch-op "
                      "selection it replaces; bound: offset read once, the row table written once"}
    first = {"name": "dcn_cascade_fwd", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_fwd.cu",
             "replaces": "glare_tpu/ops/dcn_pallas.py:448", "max_abs_err": max(t["wmma_max_abs_err"] for t in main),
             "f32_max_abs_err": max(c["max_abs_err"] for c in cases.values() if c["entry"].startswith("f32")),
             "tol": "bf16: 2^-7 * max(1, max|ref|); f32: 2e-4; both overflow counters exact",
             "ms": mean("wmma_wrapper_ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
             "bound_by": by, "library_ms": None,
             "note": "the cascade entries of csrc/dcn_fwd.cu (wmma for bf16; f32, the tiled float32 "
                     "kernel, and f32_flat, the first one): ms is the wrapper with entry='wmma' at the "
                     "paths' bf16 shapes, max_abs_err its error there (bands); its bf16 cases (bands, "
                     "wide, beyond) and float32 cases are all checked; the paths launch it for no call",
             "cases": {k: c for k, c in cases.items() if c["entry"] != "hopper"}}
    return cascade, select, first


# the training crop (confs/train_stage3_LOL.yml: GT_size 256, batch 2, float32) and
# the two DCNs it gives: warp_0 at quarter resolution, warp_1 at half
TRAIN_GT, TRAIN_BATCH = 256, 2
TRAIN_DCN = [("warp_0", TRAIN_BATCH, TRAIN_GT // 2, TRAIN_GT // 2, 256, 4, 256),
             ("warp_1", TRAIN_BATCH, TRAIN_GT, TRAIN_GT, 128, 4, 128)]
# the backward against autograd of the plain version: per output, max |kernel - plain|
# over max |plain|. Both are float32 (no TF32); they sum in other orders (grad_weight
# over up to B*H*W = 131,072 pixels, grad_offset / grad_mask over a group's channels,
# grad_x by atomics in no fixed order).
BWD_TOL = 1e-4
BWD_OUTPUTS = ("grad_x", "grad_offset", "grad_mask", "grad_weight", "grad_bias")


def _bwd_bound(B, H, W, C, G, O, need_x=False, es=4, round_trips=False):
    """Least time of one backward: the two products (2 x 2*P*9*C*O FLOP) on the
    float32 units (es 4) or the bf16 tensor cores (es 2); x and grad_out (es bytes
    each), offset, mask and the float32 weight read once, grad_offset, grad_mask,
    grad_weight, grad_bias (float32; and grad_x, es) written once. ``round_trips``:
    also the column and grad_col written and read back once each (P*9*C es-byte
    values each way), the traffic of this design."""
    P = B * H * W
    nbytes = (es * (P * C + P * O + (P * C if need_x else 0))
              + 4 * (2 * P * G * 9 * 3 + 2 * 9 * C * O + O))
    if round_trips:
        nbytes += 2 * 2 * P * 9 * C * es
    return bound(2 * 2.0 * P * 9 * C * O, PEAK_F32 if es == 4 else PEAK_BF16, nbytes)


def _old_backward_lib():
    """The first backward design (three kernels: im2col, coord, input), built
    from the source text kept in glare_tpu_torch/tools/dcn_train_designs.py;
    timed beside the shipped design, launched by no path."""
    global _OLD_BWD
    if _OLD_BWD is None:
        from glare_tpu_torch.tools import dcn_train_designs
        _OLD_BWD = (dcn_train_designs, dcn_train_designs.build_old_backward())
    return _OLD_BWD


_OLD_BWD = None


def _bwd_parts_ms(go, x, off, mask, wgt):
    """At the radius-2 table, in x's type: the shipped backward's steps timed alone
    (the grad_col product, the gather pass, the grad_weight product), and the
    whole of the shipped backward and of the first design in turns (new, old,
    old, new), with the first design's steps."""
    B, H, W, C = x.shape
    G, O = off.shape[3], wgt.shape[-1]
    radii = dcn_ops.clamp_table(2, G).to(DEV).contiguous()
    go2, w2 = go.reshape(-1, O), wgt.reshape(9 * C, O).to(x.dtype)
    gcol = go2 @ w2.t()
    col = torch.empty_like(gcol)
    goff, gmask = torch.empty_like(off), torch.empty_like(mask)
    gw = torch.zeros((9 * C, O), device=DEV)
    if x.dtype == torch.float32:
        gw_product = lambda: gw.addmm_(col.t(), go2)  # noqa: E731
    else:
        gw_product = lambda: gw.add_(torch.mm(col.t(), go2, out_dtype=torch.float32))  # noqa: E731
    out = {"grad_col_product_ms": time_ms(lambda: torch.matmul(go2, w2.t(), out=gcol)),
           "pass_ms": time_ms(lambda: dcn_ops.dcn_backward_pass_cuda(x, off, mask, radii, gcol, goff, gmask)),
           "grad_weight_product_ms": time_ms(gw_product)}
    del col, gcol, goff, gmask, gw
    tool, lib = _old_backward_lib()
    steps = {}
    got = [g.clone() for g in tool.old_backward(lib, go, x, off, mask, wgt, radii, parts=steps)]  # steps re-add
    new = lambda: dcn_ops.modulated_deform_conv_backward_cuda(go, x, off, mask, wgt, max_offset=radii)  # noqa: E731
    old = lambda: tool.old_backward(lib, go, x, off, mask, wgt, radii)  # noqa: E731
    turns = [time_ms(f) for f in (new, old, old, new)]
    out.update(ms_turns=[turns[0], turns[3]], old_design_ms_turns=[turns[1], turns[2]],
               old_design_ms=(turns[1] + turns[2]) / 2,
               old_design_parts_ms={k: time_ms(f) for k, f in steps.items()})
    torch.cuda.empty_cache()
    return out, got


def _pass_vs_plain(go, x, off, mask, wgt, need_x):
    """The gather pass alone against its plain version (dcn_backward_pass_ref) on
    the same grad_col, the plain version run in float32 on the same values (in
    bf16 the kernel computes in float32 from bf16 inputs, as it does): every
    output within BWD_TOL of its largest, but the bf16 column, which may differ
    by its one rounding to bf16 (2^-7 of the largest). -> {output: relative error}."""
    B, H, W, C = x.shape
    G, O = off.shape[3], wgt.shape[-1]
    radii = dcn_ops.clamp_table(2, G).to(DEV).contiguous()
    gcol = go.reshape(-1, O) @ wgt.reshape(9 * C, O).to(x.dtype).t()
    goff, gmask = torch.empty_like(off), torch.empty_like(mask)
    gx = torch.zeros(x.shape, device=DEV) if need_x else None
    before = counters()
    col = dcn_ops.dcn_backward_pass_cuda(x, off, mask, radii, gcol, goff, gmask, gx)
    torch.cuda.synchronize()
    require(moved_since(before) == {**{k: 0 for k in before},
                                    "dcn_bwd" if x.dtype == torch.float32 else "dcn_bwd_bf16": 1},
            f"pass: counters {moved_since(before)}")
    want = dcn_ops.dcn_backward_pass_ref(x.float(), off, mask, gcol.float(), radii, need_x=need_x)
    rel = lambda g, w: float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)  # noqa: E731
    errs = {"col": rel(col, want[0]), "grad_offset": rel(goff, want[1]), "grad_mask": rel(gmask, want[2])}
    if need_x:
        errs["grad_x"] = rel(gx, want[3])
    for name, e in errs.items():
        tol = 2.0 ** -7 if name == "col" and x.dtype == torch.bfloat16 else BWD_TOL
        require(e <= tol, f"pass {name}: {e} from its plain version")
    del col, gcol, goff, gmask, gx, want
    torch.cuda.empty_cache()
    return errs


def _ragged_pass_inputs(rng, dt):
    """(grad_out, x, offset, mask, weight) at 13 x 17, C 24, G 4 (Cg 6: no whole
    16-byte vectors, the pass's scalar instantiation), offsets of 3 px spread."""
    x, off, mask, wgt, _ = _dcn_inputs(rng, 2, 13, 17, 24, 4, 20, dt, 3.0)
    return dev(rng.standard_normal((2, 13, 17, 20)).astype(np.float32), dt), x, off, mask, wgt


def _column_is_forwards(x, off, mask, radii):
    """The gather pass's masked column against the forward that ran, bit for bit:
    bf16 against the Hopper forward's A block, float32 against what the tiled
    float32 forward multiplies. A one-hot weight routes O of the 9C column rows
    to the O outputs (one product by 1 in the float32 accumulator, no bias, so
    the output is the column value itself). -> number of differing values (0)."""
    B, H, W, C = x.shape
    G, O = off.shape[3], (256 if C == 256 else 128)
    gcol = torch.zeros((B * H * W, 9 * C), dtype=x.dtype, device=DEV)
    col = dcn_ops.dcn_backward_pass_cuda(x, off, mask, radii, gcol, torch.empty_like(off), torch.empty_like(mask))
    differ, eye = 0, torch.arange(O, device=DEV)
    for r0 in range(0, 9 * C, O):
        w = torch.zeros((9 * C, O), device=DEV)
        w[r0 + eye, eye] = 1.0
        y = dcn_ops.modulated_deform_conv_cuda(x, off, mask, w.reshape(3, 3, C, O), None, max_offset=radii)
        differ += int((y.reshape(-1, O) != col[:, r0:r0 + O]).sum())
    del col, gcol
    return differ


def check_dcn_bwd():
    """The DCN backward (modulated_deform_conv_backward_cuda: the grad_col product,
    the gather pass of csrc/dcn_bwd.cu, the grad_weight product) against autograd
    of modulated_deform_conv_ref on the card, at the two training shapes,
    float32, clamp radius 2: offsets of 1.5 px spread (about 18% of the
    components beyond 2, whose gradient must be exactly 0), offsets exactly 0
    (the zero-initialised step: the floor-based derivative at integer
    positions), once with grad_x, and once at warp_1 in two chunks of one image
    (BWD_CHUNK_BYTES lowered for that call: the row and batch slices and the
    grad_weight sum over chunks), with grad_x. Every output within BWD_TOL;
    exactly one pass launch per chunk. The pass alone against its plain version,
    and its column bit for bit against what the tiled float32 forward
    multiplies. Also the float32 forward (entry f32, csrc/dcn_fwd.cu's tiled
    kernel) at the same shapes, which the training path launches, beside the
    first float32 kernel (entry f32_flat) in the same call; and the first
    backward design (three kernels). -> (backward row, float32 forward row)."""
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for float32 products")
    rng = np.random.default_rng(6)
    cases, timed, fwd = {}, {}, {}
    for (wname, B, H, W, C, G, O) in TRAIN_DCN:
        x, off, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, torch.float32, 1.5)
        go = dev(rng.standard_normal((B, H, W, O)).astype(np.float32))
        fields = ("spread", "zero", "grad_x") if wname == "warp_0" else ("spread", "zero", "chunked")
        for field in fields:
            tag = f"{wname} {field}"
            o = torch.zeros_like(off) if field == "zero" else off
            need_x = field in ("grad_x", "chunked")
            chunks = B if field == "chunked" else 1
            before, by_entry = counters(), dict(dcn_ops.bwd_launches_by_entry)
            chunk_bytes = dcn_ops.BWD_CHUNK_BYTES
            if field == "chunked":
                dcn_ops.BWD_CHUNK_BYTES = H * W * 9 * C * 4   # one image per chunk
            try:
                got = dcn_ops.modulated_deform_conv_backward_cuda(go, x, o, mask, wgt, max_offset=2,
                                                                  need_x=need_x)
            finally:
                dcn_ops.BWD_CHUNK_BYTES = chunk_bytes
            torch.cuda.synchronize()
            require(moved_since(before) == {**{k: 0 for k in before}, "dcn_bwd": chunks},
                    f"dcn_bwd {tag}: counters {moved_since(before)}")
            moved_e = bwd_moved_since(by_entry)
            require(moved_e == {**{k: 0 for k in by_entry}, "pass_x" if need_x else "pass": chunks},
                    f"dcn_bwd {tag}: kernel launches {moved_e}")
            want = dcn_ops.modulated_deform_conv_backward_ref(go, x, o, mask, wgt, bias, max_offset=2,
                                                              need_x=need_x)
            errs = {}
            for name, g, w in zip(BWD_OUTPUTS, got, want):
                if w is None:
                    require(g is None, f"dcn_bwd {tag}: {name} computed unasked")
                    continue
                require(g.shape == w.shape and bool(torch.isfinite(g).all()), f"dcn_bwd {tag}: {name} bad")
                scale = float(w.abs().max())
                errs[name] = {"max_abs_err": float((g - w).abs().max()), "max_abs_plain": scale}
                errs[name]["rel"] = errs[name]["max_abs_err"] / max(scale, 1e-30)
                require(scale > 0 and errs[name]["rel"] <= BWD_TOL,
                        f"dcn_bwd {tag}: {name} {errs[name]} beyond {BWD_TOL}")
            beyond = o.abs() > 2
            require(bool((got[1][beyond] == 0).all()), f"dcn_bwd {tag}: gradient beyond the clamp")
            cases[tag] = {"shape": [B, H, W, C, G, O], "need_x": need_x, "chunks": chunks,
                          "components_beyond_2px": float(beyond.float().mean()), "outputs": errs}
            del got, want
            torch.cuda.empty_cache()
        pass_errs = _pass_vs_plain(go, x, off, mask, wgt, need_x=wname == "warp_0")
        if wname == "warp_0":   # Cg 6: the pass's scalar instantiation
            pass_errs["ragged Cg 6"] = _pass_vs_plain(*_ragged_pass_inputs(rng, torch.float32), need_x=True)
        # times at the 'spread' inputs: the whole backward, its steps, the first design,
        # and autograd of the plain version (its backward alone, the graph built once)
        ms = time_ms(lambda: dcn_ops.modulated_deform_conv_backward_cuda(go, x, off, mask, wgt, max_offset=2))
        parts, old_got = _bwd_parts_ms(go, x, off, mask, wgt)
        want = dcn_ops.modulated_deform_conv_backward_ref(go, x, off, mask, wgt, bias, max_offset=2)
        old_errs = [float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(old_got, want[1:4])]
        require(max(old_errs) <= BWD_TOL, f"dcn_bwd {wname}: the first design's errors {old_errs}")
        del want, old_got
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, off, mask, wgt, bias)]
            out = dcn_ops.modulated_deform_conv_ref(*leaves, max_offset=2)
            plain = time_ms(lambda: torch.autograd.grad(out, leaves[1:], go, retain_graph=True),
                            reps=3, warmup=1)
            del out, leaves
        torch.cuda.empty_cache()
        b_ms, b_by = _bwd_bound(B, H, W, C, G, O)
        timed[wname] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, **parts,
                        "achieved_tflops": 4.0 * B * H * W * 9 * C * O / ms / 1e9,
                        "pass_vs_plain_rel": pass_errs, "old_design_rel_err": old_errs,
                        "max_rel_err": max(e["rel"] for c in cases.values() if c["shape"][2] == W
                                           for e in c["outputs"].values())}
        # the float32 forward entry the training path launches, at the same inputs
        require(dcn_ops.route(x, off, wgt) == "f32", f"forward {wname}: not on the f32 entry")
        radii = dcn_ops.clamp_table(2, G).to(DEV)
        before = counters()
        y = dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=2)
        torch.cuda.synchronize()
        require(moved_since(before) == {**{k: 0 for k in before}, "dcn_fwd_f32": 1},
                f"forward {wname}: counters {moved_since(before)}")
        y_ref = dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=2)
        err = float((y - y_ref).abs().max())
        tol = _dcn_tol(torch.float32, y_ref)
        require(err <= tol, f"forward f32 {wname}: {err}")
        y_flat = dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=radii, entry="f32_flat")
        err_flat = float((y_flat - y_ref).abs().max())
        require(err_flat <= tol, f"forward f32_flat {wname}: {err_flat}")
        differ = _column_is_forwards(x, off, mask, radii)
        require(differ == 0, f"{wname}: {differ} values of the float32 column differ from what the f32 "
                             "forward multiplies")
        fb_ms, fb_by = _dcn_bound(B, H, W, C, G, O, 4)
        new = lambda: dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=radii)  # noqa: E731
        flat = lambda: dcn_ops.modulated_deform_conv_cuda(  # noqa: E731
            x, off, mask, wgt, bias, max_offset=radii, entry="f32_flat")
        turns = [time_ms(f) for f in (new, flat, flat, new)]
        f_ms = (turns[0] + turns[3]) / 2
        fwd[wname] = {"ms": f_ms, "ms_turns": [turns[0], turns[3]], "max_abs_err": err, "tol": tol,
                      "old_design_ms": (turns[1] + turns[2]) / 2, "old_design_ms_turns": [turns[1], turns[2]],
                      "old_design_max_abs_err": err_flat, "column_values_off_the_backward": differ,
                      "plain_ms": time_ms(lambda: dcn_ops.modulated_deform_conv_ref(
                          x, off, mask, wgt, bias, max_offset=2), reps=3, warmup=1),
                      "bound_ms": fb_ms, "bound_by": fb_by,
                      "achieved_tflops": 2.0 * B * H * W * 9 * C * O / f_ms / 1e9,
                      "old_design_achieved_tflops": 2.0 * B * H * W * 9 * C * O / ((turns[1] + turns[2]) / 2) / 1e9}
        del x, off, mask, wgt, bias, go, y, y_ref, y_flat
        torch.cuda.empty_cache()
    mean = lambda t, key: sum(v[key] for v in t.values()) / len(t)  # noqa: E731
    note = ("mean per launch over the two shapes one stage-3 training step gives it (warp_0 x [2,128,128,256] -> "
            "256, warp_1 x [2,256,256,128] -> 128, G 4, R 2); by_shape also holds the stage-1 LQ step's two "
            "('stage1 warp_*': [4,128,128,128] -> 128, [4,256,256,64] -> 64, infinite radii, the backward with "
            "grad_x); library: torchvision is not installed (null)")
    bwd = {"name": "dcn_bwd", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_bwd.cu",
           "replaces": "glare_tpu/ops/dcn.py:185 (XLA autodiff of modulated_deform_conv_chain; "
                       "no Pallas kernel)",
           "max_abs_err": max(e["max_abs_err"] for c in cases.values() for e in c["outputs"].values()),
           "tol": f"per output max|kernel - plain| <= {BWD_TOL} * max|plain|; zero beyond the clamp",
           "ms": mean(timed, "ms"), "plain_ms": mean(timed, "plain_ms"), "bound_ms": mean(timed, "bound_ms"),
           "bound_by": "operations" if all(t["bound_by"] == "operations" for t in timed.values()) else "bytes",
           "library_ms": None, "old_design_ms": mean(timed, "old_design_ms"),
           "note": "ms: the whole backward (the grad_col product, the gather pass dcn_bwd_pass, the grad_weight "
                   "product; no grad_x); old_design_ms: the first design (im2col, two products, coord) in "
                   "turns with it; plain_ms: autograd of modulated_deform_conv_ref, its backward alone; " + note,
           "by_shape": timed, "cases": cases}
    f32 = {"name": "dcn_fwd_f32", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_fwd.cu",
           "replaces": "glare_tpu/ops/dcn_pallas.py:55",
           "max_abs_err": max(t["max_abs_err"] for t in fwd.values()), "tol": "f32: 2e-4",
           "ms": mean(fwd, "ms"), "plain_ms": mean(fwd, "plain_ms"), "bound_ms": mean(fwd, "bound_ms"),
           "bound_by": "operations" if all(t["bound_by"] == "operations" for t in fwd.values()) else "bytes",
           "library_ms": None, "old_design_ms": mean(fwd, "old_design_ms"),
           "note": "the tiled float32 kernel (entry f32), the training path's forward; old_design_ms: the first "
                   "float32 kernel (entry f32_flat) in turns with it; " + note,
           "by_shape": fwd}
    return bwd, f32


# the LQ stage of stage 1 (confs/stage1_HQ_pretrain.yml with LQ_stage, 256 crop, batch 4):
# its two WarpBlock DCNs, exact offsets (impl xla: infinite radii), under autograd with grad_x
S1_DCN = [("warp_0", 4, 128, 128, 128, 4, 128), ("warp_1", 4, 256, 256, 64, 4, 64)]


def check_dcn_stage1():
    """The f32 DCN forward and the backward with grad_x at the LQ stage's two shapes
    (C = O = 64 is new to both kernels), infinite radii, offsets of 1.5 px spread:
    each against its plain version (the forward within _dcn_tol; every output of the
    backward within BWD_TOL of its largest), one launch each (the backward's pass
    with grad_x), and timed there beside the plain versions.
    -> ({shape: backward entry}, {shape: forward entry})."""
    rng = np.random.default_rng(16)
    bwd, fwd = {}, {}
    for (wname, B, H, W, C, G, O) in S1_DCN:
        tag = f"stage1 {wname}"
        x, off, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, torch.float32, 1.5)
        go = dev(rng.standard_normal((B, H, W, O)).astype(np.float32))
        require(dcn_ops.route(x, off, wgt) == "f32", f"{tag}: not on the f32 entry")
        before, by_entry = counters(), dict(dcn_ops.bwd_launches_by_entry)
        got = dcn_ops.modulated_deform_conv_backward_cuda(go, x, off, mask, wgt, max_offset=None, need_x=True)
        torch.cuda.synchronize()
        require(moved_since(before) == {**{k: 0 for k in before}, "dcn_bwd": 1}, f"{tag}: counters")
        require(bwd_moved_since(by_entry) == {**{k: 0 for k in by_entry}, "pass_x": 1}, f"{tag}: pass kernels")
        want = dcn_ops.modulated_deform_conv_backward_ref(go, x, off, mask, wgt, bias, max_offset=None,
                                                          need_x=True)
        errs = {}
        for name, gk, gw in zip(BWD_OUTPUTS, got, want):
            scale = float(gw.abs().max())
            errs[name] = {"max_abs_err": float((gk - gw).abs().max()), "max_abs_plain": scale}
            errs[name]["rel"] = errs[name]["max_abs_err"] / max(scale, 1e-30)
            require(bool(torch.isfinite(gk).all()) and scale > 0 and errs[name]["rel"] <= BWD_TOL,
                    f"dcn_bwd {tag}: {name} {errs[name]}")
        del got, want
        ms = time_ms(lambda: dcn_ops.modulated_deform_conv_backward_cuda(go, x, off, mask, wgt, max_offset=None,
                                                                         need_x=True))
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, off, mask, wgt, bias)]
            out = dcn_ops.modulated_deform_conv_ref(*leaves, max_offset=None)
            plain = time_ms(lambda: torch.autograd.grad(out, leaves, go, retain_graph=True), reps=3, warmup=1)
            del out, leaves
        torch.cuda.empty_cache()
        b_ms, b_by = _bwd_bound(B, H, W, C, G, O, need_x=True)
        bwd[tag] = {"shape": [B, H, W, C, G, O], "need_x": True, "radii": "inf", "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "achieved_tflops": 4.0 * B * H * W * 9 * C * O / ms / 1e9,
                    "outputs": errs, "max_rel_err": max(e["rel"] for e in errs.values())}
        before = counters()
        y = dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=None)
        torch.cuda.synchronize()
        require(moved_since(before) == {**{k: 0 for k in before}, "dcn_fwd_f32": 1}, f"forward {tag}: counters")
        y_ref = dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=None)
        err, tol = float((y - y_ref).abs().max()), _dcn_tol(torch.float32, y_ref)
        require(err <= tol, f"forward f32 {tag}: {err}")
        f_ms = time_ms(lambda: dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=None))
        fb_ms, fb_by = _dcn_bound(B, H, W, C, G, O, 4)
        fwd[tag] = {"shape": [B, H, W, C, G, O], "radii": "inf", "ms": f_ms, "max_abs_err": err, "tol": tol,
                    "plain_ms": time_ms(lambda: dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias,
                                                                                  max_offset=None),
                                        reps=3, warmup=1),
                    "bound_ms": fb_ms, "bound_by": fb_by, "achieved_tflops": 2.0 * B * H * W * 9 * C * O / f_ms / 1e9}
        del x, off, mask, wgt, bias, go, y, y_ref
        torch.cuda.empty_cache()
    return bwd, fwd


def _dcn_library_note():
    """Why a DCN training row's library_ms is null: torch has no DCN call."""
    return ("null: torchvision.ops.deform_conv2d (with its backward) would be the call; torch has none"
            + ("; torchvision is installed here but not timed for the training rows" if _has_torchvision()
               else " and torchvision is not installed on this machine"))


def check_dcn_bwd_bf16():
    """The bf16 gather pass of csrc/dcn_bwd.cu (train.mixed_precision) through
    modulated_deform_conv_backward_cuda at the two training shapes, clamp radius
    2, bf16 x and grad_out, float32 offsets, mask and weight: offsets of 1.5 px
    spread, once with grad_x (warp_0), once in two chunks of one image with
    grad_x (warp_1). Each output three ways on the same bf16-valued inputs: the
    kernels, the plain backward in bf16, the plain backward in float32; the
    kernels' relative RMS distance from the float32 one may be at most
    STAGE_RATIO x the plain bf16 one's + STAGE_ABS_SLACK (the stage-ratio rule of
    PERF.md section 2). Exactly one pass launch per chunk. The pass alone against
    its plain version, its column bit for bit against the Hopper forward's A
    block, and the first backward design timed in turns with it. Also the
    Hopper forward (entry hopper, the Function's bf16 forward) at the same
    shapes against its plain version. -> (backward row, forward row)."""
    rng = np.random.default_rng(7)
    cases, timed, fwd = {}, {}, {}
    for (wname, B, H, W, C, G, O) in TRAIN_DCN:
        x, off, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, torch.bfloat16, 1.5)
        go = dev(rng.standard_normal((B, H, W, O)).astype(np.float32), torch.bfloat16)
        for field in ("spread", "grad_x" if wname == "warp_0" else "chunked"):
            tag = f"{wname} bf16 {field}"
            need_x = field != "spread"
            chunks = B if field == "chunked" else 1
            before, by_entry = counters(), dict(dcn_ops.bwd_launches_by_entry)
            chunk_bytes = dcn_ops.BWD_CHUNK_BYTES
            if field == "chunked":
                dcn_ops.BWD_CHUNK_BYTES = H * W * 9 * C * 2   # one image per chunk
            try:
                got = dcn_ops.modulated_deform_conv_backward_cuda(go, x, off, mask, wgt, max_offset=2,
                                                                  need_x=need_x)
            finally:
                dcn_ops.BWD_CHUNK_BYTES = chunk_bytes
            torch.cuda.synchronize()
            require(moved_since(before) == {**{k: 0 for k in before}, "dcn_bwd_bf16": chunks},
                    f"dcn_bwd {tag}: counters {moved_since(before)}")
            moved_e = bwd_moved_since(by_entry)
            require(moved_e == {**{k: 0 for k in by_entry}, "pass_x_bf16" if need_x else "pass_bf16": chunks},
                    f"dcn_bwd {tag}: kernel launches {moved_e}")
            plain = dcn_ops.modulated_deform_conv_backward_ref(go, x, off, mask, wgt, bias, max_offset=2,
                                                               need_x=need_x)
            f32 = dcn_ops.modulated_deform_conv_backward_ref(go.float(), x.float(), off, mask, wgt, bias,
                                                             max_offset=2, need_x=need_x)
            dists = {}
            for name, g, p_, w in zip(BWD_OUTPUTS, got, plain, f32):
                if w is None:
                    require(g is None, f"dcn_bwd {tag}: {name} computed unasked")
                    continue
                want_dt = torch.bfloat16 if name == "grad_x" else torch.float32
                require(g.shape == w.shape and g.dtype == want_dt and bool(torch.isfinite(g.float()).all()),
                        f"dcn_bwd {tag}: {name} bad ({g.dtype})")
                dk, dp = _rel_rms(g, w), _rel_rms(p_, w)
                dists[name] = {"kernel_vs_f32": dk, "plain_bf16_vs_f32": dp,
                               "kernel_vs_plain_max_abs": float((g.double() - p_.double()).abs().max())}
                require(dk <= STAGE_RATIO * dp + STAGE_ABS_SLACK,
                        f"dcn_bwd {tag}: {name} kernel {dk} from float32, plain bf16 {dp}")
            beyond = off.abs() > 2
            require(bool((got[1][beyond] == 0).all()), f"dcn_bwd {tag}: gradient beyond the clamp")
            cases[tag] = {"shape": [B, H, W, C, G, O], "need_x": need_x, "chunks": chunks,
                          "components_beyond_2px": float(beyond.float().mean()), "outputs": dists}
            del got, plain, f32
            torch.cuda.empty_cache()
        pass_errs = _pass_vs_plain(go, x, off, mask, wgt, need_x=wname == "warp_0")
        if wname == "warp_0":   # Cg 6: the pass's scalar instantiation
            pass_errs["ragged Cg 6"] = _pass_vs_plain(*_ragged_pass_inputs(rng, torch.bfloat16), need_x=True)
        ms = time_ms(lambda: dcn_ops.modulated_deform_conv_backward_cuda(go, x, off, mask, wgt, max_offset=2))
        parts, old_got = _bwd_parts_ms(go, x, off, mask, wgt)
        del old_got
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, off, mask, wgt, bias)]
            out = dcn_ops.modulated_deform_conv_ref(*leaves, max_offset=2)
            plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves[1:], go, retain_graph=True),
                               reps=3, warmup=1)
            del out, leaves
        torch.cuda.empty_cache()
        b_ms, b_by = _bwd_bound(B, H, W, C, G, O, es=2)
        rt_ms, rt_by = _bwd_bound(B, H, W, C, G, O, es=2, round_trips=True)
        timed[wname] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "bound_with_round_trips_ms": rt_ms, "bound_with_round_trips_by": rt_by, **parts,
                        "pass_vs_plain_rel": pass_errs,
                        "achieved_tflops": 4.0 * B * H * W * 9 * C * O / ms / 1e9}
        # the Function's bf16 forward: the Hopper entry at the same inputs
        require(dcn_ops.route(x, off, wgt) == "hopper", f"forward {wname}: not on the hopper entry")
        radii = dcn_ops.clamp_table(2, G).to(DEV)
        before = counters()
        y, ov = dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=radii,
                                                   return_overflow=True)
        torch.cuda.synchronize()
        require(moved_since(before) == {**{k: 0 for k in before}, "dcn_hopper": 1},
                f"forward {wname}: counters {moved_since(before)}")
        y_ref, ov_ref = dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=2,
                                                          return_overflow=True)
        err = float((y.float() - y_ref.float()).abs().max())
        tol = _dcn_tol(torch.bfloat16, y_ref)
        require(err <= tol and ov.tolist() == ov_ref.tolist(), f"forward bf16 {wname}: {err}, {ov.tolist()}")
        fb_ms, fb_by = _dcn_bound(B, H, W, C, G, O, 2)
        f_ms = time_ms(lambda: dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=radii,
                                                                  return_overflow=True), reps=10)
        differ = _column_is_forwards(x, off, mask, radii)
        require(differ == 0, f"{wname}: {differ} values of the bf16 column differ from the forward's A block")
        fwd[wname] = {"ms": f_ms, "max_abs_err": err, "tol": tol, "overflow": ov.tolist(),
                      "column_values_off_the_forward": differ,
                      "plain_ms": time_ms(lambda: dcn_ops.modulated_deform_conv_ref(
                          x, off, mask, wgt, bias, max_offset=2), reps=3, warmup=1),
                      "bound_ms": fb_ms, "bound_by": fb_by,
                      "achieved_tflops": 2.0 * B * H * W * 9 * C * O / f_ms / 1e9}
        del x, off, mask, wgt, bias, go, y, y_ref
        torch.cuda.empty_cache()
    mean = lambda t, key: sum(v[key] for v in t.values()) / len(t)  # noqa: E731
    by = lambda t: "operations" if all(v["bound_by"] == "operations" for v in t.values()) else "bytes"  # noqa: E731
    note = ("mean per launch over the two shapes one bf16 training step gives it (warp_0 x [2,128,128,256] "
            "-> 256, warp_1 x [2,256,256,128] -> 128, G 4, R 2); library: torchvision is not installed (null)")
    bwd = {"name": "dcn_bwd_bf16", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_bwd.cu",
           "replaces": "glare_tpu/ops/dcn.py:185 (XLA autodiff of modulated_deform_conv_chain in bf16; "
                       "no Pallas kernel)",
           "max_abs_err": max(e["kernel_vs_plain_max_abs"] for c in cases.values()
                              for e in c["outputs"].values()),
           "tol": f"per output: relative RMS from the float32 plain backward <= {STAGE_RATIO} x the plain "
                  f"bf16 backward's + {STAGE_ABS_SLACK}; zero beyond the clamp",
           "ms": mean(timed, "ms"), "plain_ms": mean(timed, "plain_ms"), "bound_ms": mean(timed, "bound_ms"),
           "bound_by": by(timed), "library_ms": None, "library_note": _dcn_library_note(),
           "bound_with_round_trips_ms": mean(timed, "bound_with_round_trips_ms"),
           "old_design_ms": mean(timed, "old_design_ms"),
           "note": "ms: the whole bf16 backward (the bf16 grad_col product, the gather pass dcn_bwd_pass_bf16, "
                   "the grad_weight product with float32 accumulation; no grad_x); old_design_ms: the first "
                   "design (im2col, two products, coord) in turns with it; bound_ms: inputs read and outputs "
                   "written once; bound_with_round_trips_ms: also the column and grad_col through device memory "
                   "once each, the traffic of both designs; max_abs_err: kernel against the plain bf16 "
                   "backward; " + note,
           "by_shape": timed, "cases": cases}
    hop = {"name": "dcn_hopper_train", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_hopper.cu",
           "replaces": "glare_tpu/ops/dcn_pallas.py:55",
           "max_abs_err": max(t["max_abs_err"] for t in fwd.values()),
           "tol": "bf16: 2^-7 * max(1, max|ref|); the pallas counter exact",
           "ms": mean(fwd, "ms"), "plain_ms": mean(fwd, "plain_ms"), "bound_ms": mean(fwd, "bound_ms"),
           "bound_by": by(fwd), "library_ms": None, "library_note": _dcn_library_note(),
           "note": "the Hopper entry at the training shapes, the bf16 training path's forward under "
                   "ModulatedDeformConvFunction (its count from the kernel); " + note,
           "by_shape": fwd}
    return bwd, hop


def phase_kernels():
    hopper, first, f32_cases = check_dcn()
    bwd, f32 = check_dcn_bwd()
    f32["cases"] = f32_cases   # the main path's float32 shapes, held in check_dcn
    s1_bwd, s1_fwd = check_dcn_stage1()   # the stage-1 LQ shapes, beside the rows' stage-3 ones
    bwd["by_shape"].update(s1_bwd)
    f32["by_shape"].update(s1_fwd)
    bwd["max_abs_err"] = max([bwd["max_abs_err"]] + [e["max_abs_err"] for t in s1_bwd.values()
                                                     for e in t["outputs"].values()])
    f32["max_abs_err"] = max([f32["max_abs_err"]] + [t["max_abs_err"] for t in s1_fwd.values()])
    ks = [check_vq(), *check_attn(), hopper, first, *check_dcn_cascade(), bwd, f32, *check_dcn_bwd_bf16()]
    emit({"phase": "kernels", "kernels": [
        {"name": k["name"], "max_err": k["max_abs_err"], "tol": k["tol"], "kernel_ms": k["ms"],
         "plain_ms": k["plain_ms"], "library_ms": k["library_ms"],
         **{key: k[key] for key in ("cases", "by_shape", "note") if key in k}} for k in ks]})
    return ks


# --------------------------------------------------------------- main path --

def lol_opt():
    """The values of confs/LOL.yml that the inference path reads (the port's own
    dict: no yaml here), in the configuration whose main path reaches all three
    kernels: bf16 network, clamped DCN at radius 2."""
    return {
        "name": "GLARE_LOL", "model": "VQLLFLOWD", "scale": 1, "is_train": False,
        "heat": 0, "inference_dtype": "bfloat16",
        "datasets": {"train": {"quant": 32, "GT_size": 256, "log_low": True}},
        "network_G": {
            "which_model_G": "VQLLFLOWDeformable", "dcn_impl": "pallas", "dcn_max_offset": 2,
            "flow": {"K": 12, "L": 2, "coupling": "CondAffineSeparatedAndCond",
                     "additionalFlowNoAffine": 2, "split": {"enable": False}},
        },
        "network_VQGAN": {"type": "VQModel", "resolution": 256, "n_embed": 8192, "embed_dim": 3,
                          "z_channels": 3, "in_channels": 3, "out_ch": 3, "ch": 128,
                          "ch_mult": [1, 2, 4], "num_res_blocks": 2, "attn_resolutions": [64]},
        "path": {}, "train": {"manual_seed": 10},
    }


def seeded_image(seed, batch=1, h=H_IN, w=W_IN):
    """Low-light-looking image in the log domain, as the CLI feeds the model."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((batch, h, w, 3), np.float32)
    for b in range(batch):
        base = 0.04 + 0.03 * np.sin(xx / (37.0 + b) + seed) * np.cos(yy / 53.0)
        for c in range(3):
            img[b, ..., c] = base * (1.0 + 0.2 * c) + 0.01 * rng.standard_normal((h, w))
    img = np.clip(img, 0.0, 1.0)
    return np.log(np.clip(img + 1e-3, 1e-3, None)).astype(np.float32)


def counters():
    """Launch counts by kernel row of the contract line: attention one per entry;
    DCN: dcn_hopper, dcn_fwd_f32 (the tiled float32 entry), dcn_fwd (the first
    kernel's entries wmma and f32_flat together), the cascade entries of
    dcn_fwd.cu together; the backward's gather pass by type (with or without
    grad_x)."""
    by_entry = attn_ops.launches_by_entry
    dcn, cas = dcn_ops.launches_by_entry, dcn_ops.cascade_launches_by_entry
    require(attn_ops.launches == sum(by_entry.values()), "attention counts disagree")
    require(dcn_ops.launches == sum(dcn.values()) and dcn_ops.cascade_launches == sum(cas.values()),
            "DCN counts disagree")
    bwd = dcn_ops.bwd_launches_by_entry
    require(sum(bwd.values()) == dcn_ops.bwd_launches,
            f"DCN backward counts disagree: {dcn_ops.bwd_launches} launches, by kernel {bwd}")
    return {"vq_argmin": vq_ops.launches, "attn_hopper": by_entry["hopper"],
            "attn_wmma": by_entry["wmma"], "attn_f32": by_entry["hopper_f32"],
            "attn_f32_simt": by_entry["f32_simt"],
            "dcn_hopper": dcn["hopper"], "dcn_fwd": dcn["wmma"] + dcn["f32_flat"], "dcn_fwd_f32": dcn["f32"],
            "dcn_hopper_cascade": cas["hopper"],
            "dcn_cascade_fwd": cas["wmma"] + cas["f32"] + cas["f32_flat"],
            "dcn_cascade_select": dcn_ops.select_launches, "dcn_bwd": bwd["pass"] + bwd["pass_x"],
            "dcn_bwd_bf16": bwd["pass_bf16"] + bwd["pass_x_bf16"]}


def reset_counters():
    vq_ops.launches = attn_ops.launches = dcn_ops.launches = dcn_ops.cascade_launches = 0
    dcn_ops.select_launches = dcn_ops.bwd_launches = 0
    for table in (attn_ops.launches_by_entry, dcn_ops.launches_by_entry,
                  dcn_ops.cascade_launches_by_entry, dcn_ops.bwd_launches_by_entry):
        for entry in table:
            table[entry] = 0


def dcn_on_hopper_only(moved, what):
    """Every DCN launch in ``moved`` went through the Hopper entries."""
    require(moved["dcn_fwd"] == 0 and moved["dcn_fwd_f32"] == 0 and moved["dcn_cascade_fwd"] == 0
            and moved["dcn_bwd"] == 0 and moved["dcn_bwd_bf16"] == 0,
            f"{what}: DCN launches off the Hopper entry: {moved}")


def moved_since(before):
    now = counters()
    return {k: now[k] - before[k] for k in before}


def bwd_moved_since(by_entry):
    """Launches of each instantiation of the DCN backward's gather pass since
    ``by_entry`` (a copy of dcn_ops.bwd_launches_by_entry)."""
    return {e: dcn_ops.bwd_launches_by_entry[e] - by_entry[e] for e in by_entry}


# (module, a function that reaches a kernel, its plain PyTorch version)
PLAIN_VERSIONS = (
    (vq_ops, "nearest_code", "nearest_code_ref"),
    (attn_ops, "flash_attention_nhc", "flash_attention_nhc_ref"),
    (dcn_ops, "modulated_deform_conv", "modulated_deform_conv_ref"),
    (dcn_ops, "modulated_deform_conv_cascade", "modulated_deform_conv_cascade_ref"),
    (dcn_ops, "modulated_deform_conv_hybrid", "modulated_deform_conv_hybrid_ref"),
    (dcn_ops, "cascade_select_cuda", "cascade_row_radius"),
    (dcn_ops, "modulated_deform_conv_backward_cuda", "modulated_deform_conv_backward_ref"),
)


@contextlib.contextmanager
def _swapped(attrs):
    """Set ``{(module, name): value}`` for the block, then restore."""
    saved = {key: getattr(*key) for key in attrs}
    for (mod, name), value in attrs.items():
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name), value in saved.items():
            setattr(mod, name, value)


def plain_versions():
    """Route the kernel-bearing functions to their plain PyTorch versions
    (for the comparison only; the port itself has no such switch)."""
    return _swapped({(mod, kern): getattr(mod, plain) for mod, kern, plain in PLAIN_VERSIONS})


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stage_cmp(kern, plain, f32):
    """Distances of one stage's output, three ways on the same inputs: bf16 through
    the kernels, bf16 through the plain versions, float32 through the plain
    versions. RMS, as a share of the float32 output's own RMS."""
    kern, plain, f32 = kern.double(), plain.double(), f32.double()
    ref_rms = max(float((f32 ** 2).mean().sqrt()), 1e-30)
    rel = lambda a, b: float(((a - b) ** 2).mean().sqrt()) / ref_rms  # noqa: E731
    return {"ref_rms": ref_rms, "ref_max": float(f32.abs().max()),
            "kernel_vs_f32": rel(kern, f32), "plain_vs_f32": rel(plain, f32),
            "kernel_vs_plain": rel(kern, plain),
            "kernel_vs_plain_max_abs": float((kern - plain).abs().max())}


def require_stages(stages):
    """Tolerance: the two bf16 runs differ only inside the kernels (last-bit
    flips), but attention blocks, group norms and convolutions in bf16 follow
    and spread them, so their distance from each other says little. What a
    right kernel guarantees is that its run is no farther from the float32 run
    than the plain bf16 run is, up to noise; a wrong kernel adds an error of
    the order of the values themselves. Distances are RMS, as a share of the
    float32 stage's own RMS (not of its peak, which one outlier can inflate)."""
    for name, c in stages.items():
        require(math.isfinite(c["kernel_vs_f32"]), f"stage {name}: non-finite")
        limit = STAGE_RATIO * c["plain_vs_f32"] + STAGE_ABS_SLACK
        require(c["kernel_vs_f32"] <= limit,
                f"stage {name}: the kernel run is {c['kernel_vs_f32']:.3e} (relative RMS) from "
                f"the float32 run, the plain bf16 run {c['plain_vs_f32']:.3e}; limit {limit:.3e}")


def index_flips(model, latent_nchw, idx_kernel, idx_plain):
    """Both quantizers got the same latent, so an index may differ only between
    codes whose float64 distances to the token agree to 1e-6 relative (the rule
    of check_vq). -> (number of differing indices, their worst relative gap)."""
    z_np = latent_nchw.float().permute(0, 2, 3, 1).reshape(-1, latent_nchw.shape[1]).cpu().numpy()
    e_np = model.net_hq.quantize.embedding.weight.detach().float().cpu().numpy()
    rel_gap, _, flips = vq_gap(z_np, e_np, idx_kernel.cpu().numpy(), idx_plain.cpu().numpy())
    require(rel_gap <= 1e-6, f"{flips} codebook indices differ between kernel and plain version, "
                             f"one by {rel_gap:.3e} (relative) in true distance")
    return flips, rel_gap


def phase_main_path():
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    t0 = time.time()
    model = create_model(lol_opt(), device="cuda")
    temper_offset_heads(model.netG, seed=7, std=0.02)
    build_s = time.time() - t0
    expected = {**{k: 0 for k in counters()}, "vq_argmin": 1, "attn_hopper": 11, "dcn_hopper": 2}

    # warm-up request (cuDNN autotuning, allocator), not counted
    model.get_sr(dev(seeded_image(99)))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    calls = []
    for seed, batch in [(0, 1), (1, 1), (3, 2)]:
        lq = dev(seeded_image(seed, batch))
        before = counters()
        sr, ms = sync_ms(lambda: model.get_sr(lq))
        moved = moved_since(before)
        require(tuple(sr.shape) == (batch, H_IN, W_IN, 3) and sr.dtype == torch.float32,
                f"get_sr output {tuple(sr.shape)} {sr.dtype}")
        require(bool(torch.isfinite(sr).all()), "get_sr output is not finite")
        require(moved == expected, f"launches per get_sr call {moved} != expected {expected}")
        calls.append({"seed": seed, "batch": batch, "ms": ms, "ms_per_image": ms / batch,
                      "launches": moved, "out_mean": float(sr.mean()), "out_std": float(sr.std()),
                      "dcn_overflow": model.last_dcn_overflow()})
    path_counts = counters()
    peak_mem = torch.cuda.max_memory_allocated()
    for k, n in expected.items():
        require(n == 0 or path_counts[k] > 0, f"kernel {k} was never launched on the main path")

    # per-stage times (one image) and the stage-wise comparison against the same
    # model run with the plain versions, and against a float32 model of the same
    # weights run with the plain versions, each stage fed the SAME inputs
    opt32 = lol_opt()
    opt32["inference_dtype"] = "float32"
    model32 = create_model(opt32, device="cuda")   # same seed: the same weights, unrounded
    temper_offset_heads(model32.netG, seed=7, std=0.02)
    stage_ms, stages, flips, flip_rel_gap = stages_vs_plain(model, model32, dev(seeded_image(0)))
    del model32
    emit({"phase": "main_path", "config": "confs/LOL.yml widths, bf16, dcn_impl=pallas R=2",
          "input": [H_IN, W_IN], "model_build_s": round(build_s, 2), "calls": calls,
          "launches_total": path_counts, "expected_per_call": expected,
          "stage_ms_per_image": stage_ms, "stage_vs_plain": stages,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}",
          "index_flips": flips, "index_flip_worst_rel_gap": flip_rel_gap,
          "dcn_shapes": model.netG.deformable_decoder.last_dcn_shapes(),
          "max_memory_allocated": peak_mem})
    return path_counts, model, calls


def stages_vs_plain(model, model32, lq, aft_model=None, aft_model32=None, out=None):
    """Per-stage times of ``model`` (bf16, kernels) on ``lq`` (second of two passes)
    and each stage held against ``model`` run with the plain versions and against
    the float32 ``model32`` run with them, every stage fed the kernel run's
    inputs (:func:`require_stages`); codebook index flips only at near-ties.
    ``aft_model`` / ``aft_model32``: other models whose ``aft_half`` gives the two
    plain runs of the last stage (default ``model`` / ``model32``); ``out``: a dict
    given the last stage's three outputs (``rec``, ``rec_plain``, ``rec_f32``).
    -> (stage_ms, stages, index flips, their worst relative gap)."""
    aft_model, aft_model32 = aft_model or model, aft_model32 or model32
    with torch.inference_mode():
        x_nchw = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        stage_ms = {}
        for _ in range(2):  # second pass is the timed one
            (x, lr_enc), stage_ms["latent_half"] = sync_ms(lambda: model.netG.latent_half(x_nchw))
            (dec, _, code_out), stage_ms["vq_decode"] = sync_ms(lambda: model.net_hq.decode(x))
            rec, stage_ms["aft_half"] = sync_ms(
                lambda: model.netG.aft_half(x, code_out, lr_enc["mid_feat"]))
        idx_k = model.net_hq.quantize.last_indices.clone()
        with plain_versions():
            before = counters()
            x_p, lr_enc_p = model.netG.latent_half(x_nchw)
            dec_p, _, code_out_p = model.net_hq.decode(x)
            idx_p = model.net_hq.quantize.last_indices.clone()
            rec_p = aft_model.netG.aft_half(x, code_out, lr_enc["mid_feat"])
            x_f, lr_enc_f = model32.netG.latent_half(x_nchw)
            dec_f, _, code_out_f = model32.net_hq.decode(x)
            idx_f = model32.net_hq.quantize.last_indices.clone()
            rec_f = aft_model32.netG.aft_half(x, code_out, lr_enc["mid_feat"])
            torch.cuda.synchronize()
            require(counters() == before, "the plain-version run launched a kernel")
    stages = {
        "latent_half.x": stage_cmp(x, x_p, x_f),
        "latent_half.cond_feat": stage_cmp(lr_enc["cond_feat"], lr_enc_p["cond_feat"], lr_enc_f["cond_feat"]),
        "vq_decode.dec": stage_cmp(dec, dec_p, dec_f),
        "vq_decode.tap0": stage_cmp(code_out[0], code_out_p[0], code_out_f[0]),
        "vq_decode.tap1": stage_cmp(code_out[1], code_out_p[1], code_out_f[1]),
        "aft_half.rec": stage_cmp(rec, rec_p, rec_f),
    }
    require_stages(stages)
    require(bool((idx_f == idx_p).all()), "float32 and bf16 models disagree on codebook indices "
            "for the same latent: their codebooks differ")
    flips, flip_rel_gap = index_flips(model, x, idx_k, idx_p)
    if out is not None:
        out.update(rec=rec, rec_plain=rec_p, rec_f32=rec_f)
    return stage_ms, stages, flips, flip_rel_gap


@contextlib.contextmanager
def counted_get_sr(model):
    """Counts the calls of ``model.get_sr`` made inside the block -> a one-item list."""
    n_calls, plain_get_sr = [0], model.get_sr

    def get_sr(*a, **k):
        n_calls[0] += 1
        return plain_get_sr(*a, **k)

    model.get_sr = get_sr
    try:
        yield n_calls
    finally:
        del model.get_sr


def _stage3_opt(dcn_impl, dtype="bfloat16"):
    opt = lol_opt()
    opt["inference_dtype"] = dtype
    opt["network_G"]["dcn_impl"] = dcn_impl
    return opt


def phase_hybrid_path():
    """dcn_impl hybrid at the full confs/LOL.yml width, 620x420, bf16."""
    from glare_tpu_torch.cli.infer_paired import enhance_exact
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    def build(dcn_impl, dtype="bfloat16"):
        m = create_model(_stage3_opt(dcn_impl, dtype), device="cuda")
        # the same weights in every model; heads a little tamer than the main path's,
        # so that the widest tap stays well inside the 15 px that the dispatch can serve
        temper_offset_heads(m.netG, seed=7, std=0.015)
        return m

    model = build("hybrid")          # conf defaults: R 2, R_tail 8, capacity 0.125
    per_call = {**{k: 0 for k in counters()}, "vq_argmin": 1, "attn_hopper": 11,
                "dcn_hopper_cascade": 2, "dcn_cascade_select": 2}
    model.get_sr(dev(seeded_image(99)))   # warm-up, not counted
    torch.cuda.synchronize()
    reset_counters()

    # request 1 through the CLI's loop: the seeded heads put a tap beyond 2 px into
    # every row block, so capacity 0.125 overflows and the loop has to raise it
    lq0 = dev(seeded_image(20))
    before = counters()
    with counted_get_sr(model) as n_calls:
        model.get_sr(lq0)
        first = model.last_dcn_overflow()
        require(first["overflow_blocks"] > 0,
                f"request 1 was meant to overflow the capacity: {first}")
        (sr0, ov0), loop_ms = sync_ms(lambda: enhance_exact(model, lq0, tag="request 1"))
    moved = moved_since(before)
    require(moved == {k: v * n_calls[0] for k, v in per_call.items()},
            f"launches over {n_calls[0]} get_sr calls: {moved}")
    require(n_calls[0] >= 3, "the loop did not re-dispatch")
    loop = {"first_overflow": first, "get_sr_calls": n_calls[0], "final_overflow": ov0,
            "loop_ms": loop_ms, "capacity_after": model.netG.dcn_hybrid_capacity,
            "tail_after": model.netG.dcn_hybrid_tail_offset}
    require(ov0 == {"overflow_blocks": 0, "taps_beyond_tail": 0},
            f"the loop ended with a warning, not exact: {loop}")

    # requests 2, 3 under the configuration the loop left: exact, 2 cascade launches each
    calls = []
    for seed, batch in [(21, 1), (22, 1)]:
        lq = dev(seeded_image(seed, batch))
        before = counters()
        sr, ms = sync_ms(lambda: model.get_sr(lq))
        moved = moved_since(before)
        require(tuple(sr.shape) == (batch, H_IN, W_IN, 3) and bool(torch.isfinite(sr).all()),
                "hybrid get_sr output")
        require(moved == per_call, f"launches per hybrid get_sr {moved} != {per_call}")
        ov = model.last_dcn_overflow()
        calls.append({"seed": seed, "ms": ms, "launches": moved, "dcn_overflow": ov})
        require(ov == {"overflow_blocks": 0, "taps_beyond_tail": 0}, f"request not exact: {ov}")
    path_counts = counters()
    for k, n in per_call.items():
        require(n == 0 or path_counts[k] > 0, f"kernel {k} was never launched on the hybrid path")

    # the exact request against an exact ('xla') model with the same weights
    model_x, model_x32 = build("xla"), build("xla", "float32")
    lq = dev(seeded_image(22))
    before = counters()
    sr_x = model_x.get_sr(lq)
    moved = moved_since(before)
    require(moved["dcn_hopper"] == 2, f"the exact model's get_sr: {moved}")
    dcn_on_hopper_only(moved, "the exact model's get_sr")
    whole = {"max_abs_diff_vs_xla_kernel_path": float((sr - sr_x).abs().max()),
             "out_max": float(sr_x.abs().max())}
    with torch.inference_mode():
        x_nchw = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x, lr_enc = model.netG.latent_half(x_nchw)
        _, _, code_out = model.net_hq.decode(x)
        rec = model.netG.aft_half(x, code_out, lr_enc["mid_feat"])
        ov_stage = torch.stack(model.netG.deformable_decoder.dcn_overflow()).sum(0).tolist()
        with plain_versions():
            before = counters()
            rec_p = model_x.netG.aft_half(x, code_out, lr_enc["mid_feat"])
            rec_f = model_x32.netG.aft_half(x, code_out, lr_enc["mid_feat"])
            torch.cuda.synchronize()
            require(counters() == before, "the plain-version run launched a kernel")
    require(ov_stage == [0, 0], f"stage check input not exact: {ov_stage}")
    stages = {"aft_half.rec (hybrid kernels vs xla plain)": stage_cmp(rec, rec_p, rec_f)}
    require_stages(stages)
    del model_x, model_x32

    # checkpoint-aware dispatch: audit a two-image batch, serve under what it chose
    before = counters()
    stats = model.auto_configure_dcn(dev(seeded_image(23, 2)))
    dcn_on_hopper_only(moved_since(before), "auto_configure_dcn's audit")
    # another image may still beat the audited radii: it goes through the loop too
    before = counters()
    with counted_get_sr(model) as n_calls:
        (sr, ov), ms = sync_ms(lambda: enhance_exact(model, dev(seeded_image(24)),
                                                     tag="request after the audit"))
    moved = moved_since(before)
    dcn_on_hopper_only(moved, "the request after the audit")
    require(moved["dcn_hopper"] + moved["dcn_hopper_cascade"] == 2 * n_calls[0]
            and moved["attn_hopper"] == 11 * n_calls[0]
            and moved["attn_wmma"] == moved["attn_f32"] == moved["attn_f32_simt"] == 0
            and bool(torch.isfinite(sr).all()),
            f"request under the audited configuration: {moved} over {n_calls[0]} get_sr calls")
    require(ov == {"overflow_blocks": 0, "taps_beyond_tail": 0},
            f"the request after the audit did not end exact: {ov}")
    audit = {"action": stats["action"], "decisions": stats["decisions"],
             "tap_max": stats["tap_max"], "tap_p99": stats["tap_p99"],
             "tap_frac_exceed": stats["tap_frac_exceed"],
             "rowblk_frac_exceed_by_rpb": stats["rowblk_frac_exceed_by_rpb"],
             "warp_tap_max": {k: v["tap_max"] for k, v in stats["warps"].items()},
             "request_after": {"ms": ms, "get_sr_calls": n_calls[0], "launches": moved,
                               "dcn_overflow": ov, "dcn_impl": model.netG.dcn_impl}}
    emit({"phase": "hybrid_path", "config": "confs/LOL.yml widths, bf16, dcn_impl=hybrid R=2 "
          "R_tail=8 capacity=0.125", "input": [H_IN, W_IN], "expected_per_call": per_call,
          "loop": loop, "calls": calls, "launches_total": path_counts, "whole_vs_xla": whole,
          "stage_vs_plain": stages,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}",
          "auto_configure_dcn": audit})
    return path_counts


def phase_f32_attn_path():
    """main_path's network in float32, as cli/test_stages.py serves a training
    conf (no inference_dtype): VQLLFLOWDModel.get_sr at 620x420 with the
    AttnBlocks built under GLARE_ATTN_FUSED=1 (each block over 8192 tokens on
    hopper_f32) and without it (the chunked path), same seeded weights, in turns."""
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    opt = lol_opt()
    opt.pop("inference_dtype")   # the compute dtype falls back to float32
    models, saved = {}, os.environ.get("GLARE_ATTN_FUSED")
    try:
        for name, switch in (("fused", "1"), ("chunked", None)):
            if switch is None:
                os.environ.pop("GLARE_ATTN_FUSED", None)
            else:
                os.environ["GLARE_ATTN_FUSED"] = switch
            m = create_model(opt, device="cuda")
            temper_offset_heads(m.netG, seed=7, std=0.02)
            require(m.dtype == torch.float32, f"the {name} model computes in {m.dtype}")
            models[name] = m
    finally:
        if saved is None:
            os.environ.pop("GLARE_ATTN_FUSED", None)
        else:
            os.environ["GLARE_ATTN_FUSED"] = saved
    attn_rows = ("attn_hopper", "attn_wmma", "attn_f32", "attn_f32_simt")
    lq = dev(seeded_image(0))
    for m in models.values():   # warm-up (cuDNN, allocator), not counted
        m.get_sr(lq)
    torch.cuda.synchronize()

    reset_counters()
    calls = {"fused": [], "chunked": []}
    for turn in ("fused", "chunked", "chunked", "fused"):
        torch.cuda.reset_peak_memory_stats()
        before = counters()
        sr, ms = sync_ms(lambda: models[turn].get_sr(lq))
        moved = moved_since(before)
        want = {k: 0 for k in attn_rows}
        want["attn_f32"] = 11 if turn == "fused" else 0
        require({k: moved[k] for k in attn_rows} == want,
                f"f32_attn_path {turn}: attention launches {moved}, want {want}")
        require(tuple(sr.shape) == (1, H_IN, W_IN, 3) and bool(torch.isfinite(sr).all()),
                f"f32_attn_path {turn}: get_sr output {tuple(sr.shape)}, or not finite")
        calls[turn].append({"ms_per_image": ms, "launches": moved,
                            "max_memory_allocated": torch.cuda.max_memory_allocated()})
    path_counts = counters()

    # each stage of the fused run against the chunked run, both fed the fused
    # run's inputs (so the codebook sees the same latent)
    mf, mc = models["fused"], models["chunked"]

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(((a - b) ** 2).mean().sqrt()) / max(float((b ** 2).mean().sqrt()), 1e-30)

    with torch.inference_mode():
        x_nchw = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x, lr_enc = mf.netG.latent_half(x_nchw)
        x_c, lr_enc_c = mc.netG.latent_half(x_nchw)
        dec, _, code_out = mf.net_hq.decode(x)
        idx_f = mf.net_hq.quantize.last_indices.clone()
        dec_c, _, code_out_c = mc.net_hq.decode(x)
        idx_c = mc.net_hq.quantize.last_indices.clone()
        rec = mf.netG.aft_half(x, code_out, lr_enc["mid_feat"])
        rec_c = mc.netG.aft_half(x, code_out, lr_enc["mid_feat"])
        torch.cuda.synchronize()
    stages = {"latent_half.x": rel(x, x_c),
              "latent_half.cond_feat": rel(lr_enc["cond_feat"], lr_enc_c["cond_feat"]),
              "vq_decode.dec": rel(dec, dec_c), "vq_decode.tap0": rel(code_out[0], code_out_c[0]),
              "vq_decode.tap1": rel(code_out[1], code_out_c[1]), "aft_half.rec": rel(rec, rec_c)}
    require(bool((idx_f == idx_c).all()), "f32_attn_path: the two models quantize one latent differently")
    for name, d in stages.items():
        require(math.isfinite(d) and d <= F32_STAGE_TOL,
                f"f32_attn_path stage {name}: fused run {d:.3e} (relative RMS) from the chunked run, "
                f"bar {F32_STAGE_TOL}")
    ms = {k: [c["ms_per_image"] for c in v] for k, v in calls.items()}
    emit({"phase": "f32_attn_path", "config": "confs/LOL.yml widths, float32 (no inference_dtype), "
          "dcn_impl=pallas R=2", "input": [H_IN, W_IN], "calls": calls, "ms_per_image": ms,
          "fused_minus_chunked_ms": statistics.median(ms["fused"]) - statistics.median(ms["chunked"]),
          "launches_total": path_counts, "stage_fused_vs_chunked": stages,
          "stage_tol": f"relative RMS <= {F32_STAGE_TOL}"})
    del models, mf, mc
    return path_counts


GATHER_BORDER_PX = 6.0   # per tap row of the kernel column: 3 x 6 = 18 px at a border column


def condition_gather_heads(netG, a=GATHER_BORDER_PX):
    """Seeded heads that send every warp beyond the cascade's 16 px menu at its
    border columns only: the tempered heads (std 0.005, offset biases within
    +-1 px: every interior tap well inside the 2 px clamp), then one channel of
    each warp's side map made exactly 1 (the ``offset`` conv's channel 0: weight
    0, bias 1) and every dy channel fed from it by +a on the left kernel column
    and -a on the right. Inside the image the two columns cancel; at the left
    and right border columns, where the padding zeroes one of them, every tap
    moves by 3a = 18 px (2a at the four corners): 2 / W of the pixels and of
    the taps, above the 1e-3 tap share up to which a clamp is kept. -> the
    border offset in px."""
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    temper_offset_heads(netG, seed=7, std=0.005)
    with torch.no_grad():
        for warp in netG.deformable_decoder.warp:
            pack = warp.dcn
            n = 2 * pack.G * pack.K                 # (dy, dx) channels, the reference packing
            pack.conv_offset.bias[:n].clamp_(-1.0, 1.0)
            warp.offset.weight[0] = 0.0
            warp.offset.bias[0] = 1.0
            pack.conv_offset.weight[:, 0] = 0.0
            pack.conv_offset.weight[0:n:2, 0, :, 0] = a   # channel g*2K + 2k: dy of tap k, group g
            pack.conv_offset.weight[0:n:2, 0, :, 2] = -a
    return 3 * a


def gather_rule(ws, impl="pallas", R=2, tap_tol=1e-3, margin=4.0):
    """The decision auto_configure_dcn must make for a warp with stats ``ws`` that
    was configured ``impl`` at radius R (the JAX model's rule, restated): a clamp
    is kept while at most ``tap_tol`` of the taps lie beyond R; a plain wider
    clamp needs ceil(tap max + 1) <= 15, per-tap radii a largest tap <= 14 px,
    the cascade a tap max <= R_tail - 1 for R_tail in (4, 8, 16); with none of
    them it is the gather hybrid at R, capacity min(1, max(1/64, margin x the
    out-of-band pixel share at R)). -> that decision, or None for another."""
    if (impl in ("pallas", "chain") and ws["tap_frac_exceed"][R] <= tap_tol) or ws["tap_max"] <= 15.0 \
            or max(max(r) for r in ws["per_gk_max"]) <= 14.0:
        return None
    return {"impl": "hybrid_gather", "R": R,
            "cap": min(1.0, max(1 / 64, margin * ws["pix_frac_exceed"][R]))}


def phase_gather_path():
    """dcn_impl hybrid_gather at the full confs/LOL.yml width, 620x420, bf16: the
    checkpoint-aware dispatch sends both warps beyond the 16 px menu to the gather
    hybrid, whose base pass is the Hopper DCN entry."""
    from glare_tpu_torch.models import create_model

    def build(dcn_impl, dtype="bfloat16"):
        m = create_model(_stage3_opt(dcn_impl, dtype), device="cuda")
        border_px = condition_gather_heads(m.netG)
        return m, border_px

    model, border_px = build("pallas")       # as confs/LOL.yml: clamp 2; the audit decides
    audit_lq = dev(seeded_image(40, 2))
    before = counters()
    stats = model.auto_configure_dcn(audit_lq)
    dcn_on_hopper_only(moved_since(before), "auto_configure_dcn's audit")
    decisions = {}
    for name, ws in sorted(stats["warps"].items()):
        want = gather_rule(ws)
        d = stats["decisions"][name]
        require(want is not None and {k: d[k] for k in want} == want,
                f"{name}: auto_configure_dcn chose {d}, the rule {want} (tap max {ws['tap_max']})")
        share = ws["pix_frac_exceed"][2]
        require(share < d["cap"], f"{name}: out-of-band pixel share {share} not below the capacity {d}")
        decisions[name] = {"impl": d["impl"], "R": d["R"], "cap": d["cap"], "tap_max": ws["tap_max"],
                           "pix_share_beyond_R": share, "note": d["note"]}
    require(model.netG.dcn_impl == "hybrid_gather", f"dcn_impl after the audit: {model.netG.dcn_impl}")
    per_call = {**{k: 0 for k in counters()}, "vq_argmin": 1, "attn_hopper": 11, "dcn_hopper": 2}

    model.get_sr(dev(seeded_image(99)))   # warm-up, not counted
    torch.cuda.synchronize()
    reset_counters()
    calls = []
    with counted_plain_versions() as plain_calls:
        for seed, batch in [(41, 1), (42, 1), (43, 2)]:
            lq = dev(seeded_image(seed, batch))
            before = counters()
            sr, ms = sync_ms(lambda: model.get_sr(lq))
            moved = moved_since(before)
            require(tuple(sr.shape) == (batch, H_IN, W_IN, 3) and bool(torch.isfinite(sr).all()),
                    "gather get_sr output")
            require(moved == per_call, f"launches per gather get_sr {moved} != {per_call}")
            require(model.last_dcn_overflow() is None, "the gather hybrid keeps no counter")
            calls.append({"seed": seed, "batch": batch, "ms": ms, "ms_per_image": ms / batch,
                          "launches": moved})
    require(plain_calls[0] == 0, f"{plain_calls[0]} calls of a plain version on the gather path")
    path_counts = counters()

    # the tail's slots, its share of them and its time, per warp, on one image
    tail = {}
    with torch.inference_mode():
        lq = dev(seeded_image(41))
        x_nchw = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x, lr_enc = model.netG.latent_half(x_nchw)
        _, _, code_out = model.net_hq.decode(x)
        for p in model.netG.deformable_decoder.dcn_packs():
            p.audit_offsets = True
        model.netG.aft_half(x, code_out, lr_enc["mid_feat"])
        for w, (p, warp) in enumerate(zip(model.netG.deformable_decoder.dcn_packs(),
                                           model.netG.deformable_decoder.warp)):
            off = p.last_offsets
            p.audit_offsets, p.last_offsets = False, None
            B, H, W = off.shape[:3]
            sel, idx = dcn_ops.hybrid_selection(off, 2, p.hybrid_capacity)
            n_oob = int((off.abs().amax(-1) > 2).reshape(B * H * W, -1).any(1).sum())
            require(int(sel.sum()) == n_oob, f"warp_{w}: {n_oob} out-of-band pixels, "
                    f"{int(sel.sum())} in the {idx.numel()} slots: the tail does not fit")
            C = p.last_shapes["x"][3]
            xs = torch.randn((B, H, W, C), device=DEV, dtype=torch.bfloat16)
            mask = torch.rand(off.shape[:-1], device=DEV)
            wgt = torch.randn((3, 3, C, C), device=DEV) / math.sqrt(9 * C)
            tail_ms = time_ms(lambda: dcn_ops.hybrid_gather_tail(xs, off, mask, wgt, idx))
            tail[f"warp_{w}"] = {"pixels": B * H * W, "out_of_band": n_oob,
                                 "share": n_oob / (B * H * W), "slots": idx.numel(),
                                 "tail_ms": tail_ms, "tail_gflop": 2 * idx.numel() * 9 * C * C / 1e9}

    # each stage against the plain versions of the same model (bf16, float32), and the
    # output against the exact ('xla') DCN: the tail fits, so the gather hybrid is exact
    model32, _ = build("pallas", "float32")
    model32.netG.configure_dcn(dcn_impl=model.netG.dcn_impl, dcn_max_offset=model.netG.dcn_max_offset,
                               dcn_hybrid_capacity=model.netG.dcn_hybrid_capacity)
    model_x, _ = build("xla")
    model_x32, _ = build("xla", "float32")
    lq = dev(seeded_image(42))
    stage_ms, stages, flips, gap = stages_vs_plain(model, model32, lq)
    _, exact, _, _ = stages_vs_plain(model, model32, lq, aft_model=model_x, aft_model32=model_x32)
    stages["aft_half.rec vs the exact xla DCN"] = exact["aft_half.rec"]
    require_stages(stages)
    del model32, model_x, model_x32
    emit({"phase": "gather_path", "config": "confs/LOL.yml widths, bf16, dcn_impl pallas R=2 -> "
          "auto_configure_dcn -> hybrid_gather", "input": [H_IN, W_IN],
          "heads": f"every dy moved {border_px} px at the border columns, interior taps within 2 px", "decisions": decisions, "audit_action": stats["action"],
          "expected_per_call": per_call, "calls": calls, "launches_total": path_counts,
          "plain_version_calls": plain_calls[0], "tail": tail, "stage_ms_per_image": stage_ms,
          "stage_vs_plain": stages, "index_flips": flips, "index_flip_worst_rel_gap": gap,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}"})
    return path_counts, tail


def seed_flow_heads(netG, seed=11, std=0.01):
    """Give the zero-initialized ``flow_head``s seeded weights (std ``std``) and
    biases (std 0.5), so that the flow moves pixels by up to ~2 px."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for warp in netG.deformable_decoder.warp:
            fh = warp.flow_head
            fh.weight.copy_((torch.randn(fh.weight.shape, generator=g) * std).to(fh.weight))
            fh.bias.copy_((torch.randn(fh.bias.shape, generator=g) * 0.5).to(fh.bias))


def phase_flow_path():
    """warp_mode flow at the full confs/LOL.yml width, 620x420, bf16: no DCN; the
    flow warp is 25 shifted multiply-adds of eager torch ops a warp."""
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.ops import warp as warp_ops

    def build(dtype="bfloat16"):
        opt = _stage3_opt("pallas", dtype)
        opt["network_G"]["warp_mode"] = "flow"
        m = create_model(opt, device="cuda")
        seed_flow_heads(m.netG)
        return m

    model = build()
    per_call = {**{k: 0 for k in counters()}, "vq_argmin": 1, "attn_hopper": 11}
    model.get_sr(dev(seeded_image(99)))   # warm-up, not counted
    torch.cuda.synchronize()
    reset_counters()
    calls = []
    for seed, batch in [(50, 1), (51, 1), (52, 2)]:
        lq = dev(seeded_image(seed, batch))
        before = counters()
        sr, ms = sync_ms(lambda: model.get_sr(lq))
        moved = moved_since(before)
        require(tuple(sr.shape) == (batch, H_IN, W_IN, 3) and bool(torch.isfinite(sr).all()),
                "flow get_sr output")
        require(moved == per_call, f"launches per flow get_sr {moved} != {per_call}")
        calls.append({"seed": seed, "batch": batch, "ms": ms, "ms_per_image": ms / batch,
                      "launches": moved})
    path_counts = counters()

    # the warp alone at both warps' shapes, and how far its flow moves pixels
    warp_ms, flow_px = {}, {}
    with torch.inference_mode():
        lq = dev(seeded_image(50))
        x_nchw = lq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x, lr_enc = model.netG.latent_half(x_nchw)
        _, _, code_out = model.net_hq.decode(x)
        for w, warp in enumerate(model.netG.deformable_decoder.warp):
            x_vq = code_out[w].to(torch.bfloat16).permute(0, 2, 3, 1)
            B, H, W, C = x_vq.shape
            flow = torch.tanh(torch.randn((B, H, W, warp.groups, 2), device=DEV)) * warp.flow_max_offset
            warp_ms[f"warp_{w} {[B, H, W, C]}"] = time_ms(
                lambda: warp_ops.flow_warp_align(x_vq, flow, max_offset=warp.flow_max_offset))
            warp.flow_head.register_forward_hook(
                lambda mod, inp, out, w=w: flow_px.__setitem__(
                    f"warp_{w}", float(torch.tanh(out.float()).abs().max()) * mod_max(w)))
        mod_max = lambda w: model.netG.deformable_decoder.warp[w].flow_max_offset  # noqa: E731
        model.netG.aft_half(x, code_out, lr_enc["mid_feat"])
        for warp in model.netG.deformable_decoder.warp:
            warp.flow_head._forward_hooks.clear()
    require(min(flow_px.values()) > 0.1, f"the seeded flow heads move no pixel: {flow_px}")
    model32 = build("float32")
    stage_ms, stages, flips, gap = stages_vs_plain(model, model32, dev(seeded_image(51)))
    del model32
    emit({"phase": "flow_path", "config": "confs/LOL.yml widths, bf16, warp_mode flow (R 2)",
          "input": [H_IN, W_IN], "expected_per_call": per_call, "calls": calls,
          "launches_total": path_counts, "flow_warp_ms": warp_ms, "flow_max_px": flow_px,
          "stage_ms_per_image": stage_ms, "stage_vs_plain": stages, "index_flips": flips,
          "index_flip_worst_rel_gap": gap,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}"})
    return path_counts


LPIPS_REL_TOL = 1e-4   # LPIPS on the card against the CPU: float32 both, TF32 off


def _seeded_lpips_npz(path, seed=5):
    """Random LPIPS-AlexNet weights in the layout tools/convert_torch_lpips.py writes."""
    rng = np.random.default_rng(seed)
    data = {}
    for i, (cout, (cin, k)) in enumerate(zip((64, 192, 384, 256, 256),
                                             ((3, 11), (64, 5), (192, 3), (384, 3), (256, 3)))):
        data[f"conv_{i}.weight"] = (rng.standard_normal((cout, cin, k, k)) / math.sqrt(cin * k * k)).astype(np.float32)
        data[f"conv_{i}.bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        data[f"lin_{i}.weight"] = (np.abs(rng.standard_normal(cout)) / cout).astype(np.float32)
    np.savez(path, **data)
    return path


def synthetic_pair(seed, h=H2, w=W2):
    """A smooth seeded target (uint8 RGB) and its dark, noisy low-light version."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hr = np.stack([0.5 + 0.35 * np.sin(xx / (23.0 + 7 * c) + seed) * np.cos(yy / (31.0 + 5 * c))
                   for c in range(3)], axis=-1)
    hr = np.clip(hr + 0.03 * rng.standard_normal(hr.shape), 0, 1)
    lr = np.clip(0.08 * hr + 0.01 * rng.standard_normal(hr.shape), 0, 1)
    return (lr * 255).round().astype(np.uint8), (hr * 255).round().astype(np.uint8)


def phase_eval_path(model=None):
    """The per-image step of cli/infer_paired.py (``prep``: pad and log;
    ``enhance_exact``: get_sr; ``measure_output``: crop, gray-mean adjust, PSNR /
    SSIM / LPIPS) on two synthetic 600x400 pairs through the main-path model,
    with LPIPS on the card and, on the same output, on the CPU; NIQE with
    parameters fitted here. Needs no cv2."""
    import importlib.util
    import tempfile

    from scipy.ndimage import gaussian_filter

    from glare_tpu_torch.cli import infer_paired
    from glare_tpu_torch.cli.infer_paired import enhance_exact, format_measurements, measure_output, prep
    from glare_tpu_torch.data import native
    from glare_tpu_torch.utils.imgproc import preprocess_padded as plain_preprocess
    from glare_tpu_torch.measure import Measure
    from glare_tpu_torch.measure import t as lpips_input
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads
    from glare_tpu_torch.utils import niqe
    from glare_tpu_torch.utils.lpips import load_lpips
    from glare_tpu_torch.utils.metrics import PSNR, calculate_ssim

    require(torch.backends.cudnn.allow_tf32 is False and torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 must stay off")
    if model is None:
        model = create_model(lol_opt(), device="cuda")
        temper_offset_heads(model.netG, seed=7, std=0.02)
    opt = lol_opt()
    require(infer_paired.preprocess_padded is native.preprocess_padded, "the CLI's prep must run data.native")
    t0 = time.perf_counter()
    native.load()   # g++ at first use; a failed build raises here
    native_build_s = time.perf_counter() - t0
    require(opt["datasets"]["train"]["log_low"], "the protocol's prep takes the log")
    pairs = [synthetic_pair(60 + i) for i in range(2)]
    saved = os.environ.get("GLARE_LPIPS_NPZ")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            os.environ.pop("GLARE_LPIPS_NPZ", None)
            none_cols = measure_output(np.zeros((H_IN, W_IN, 3), np.float32) + 0.5, H2, pairs[0][1],
                                       Measure(device="cuda"))[1]
            note = format_measurements(none_cols)
            require(math.isnan(none_cols["LPIPS"]) and "NaN (weights missing; set GLARE_LPIPS_NPZ)" in note,
                    f"without the npz the LPIPS column must be NaN with the note: {note}")
            os.environ["GLARE_LPIPS_NPZ"] = _seeded_lpips_npz(os.path.join(tmp, "lpips.npz"))
            m_card, m_cpu = Measure(device="cuda"), Measure(device="cpu")
            net64 = load_lpips("cpu").double()     # the float64 truth both float32 runs approximate
            images, per_image = [], []
            before = counters()
            for i, (lr, hr) in enumerate(pairs):
                t = {}
                (lr_t, h), t["prep"] = sync_ms(lambda: prep(lr, opt))
                # prep runs the C++ core; the numpy plain version on the same bytes, bit for bit
                plain_t, t["prep_numpy"] = sync_ms(lambda: plain_preprocess(lr, bottom=20, left=20, apply_log=True))
                require(lr_t.dtype == plain_t.dtype == np.float32 and lr_t.shape == plain_t.shape
                        and np.array_equal(lr_t.view(np.int32), plain_t.view(np.int32)),
                        f"pair {i}: native prep is not bit-equal to the numpy version")
                sr, t["get_sr"] = sync_ms(
                    lambda: enhance_exact(model, lr_t[None], tag=f"pair {i}")[0][0].cpu().numpy())
                (out, meas), t["metrics_card"] = sync_ms(lambda: measure_output(sr, h, hr, m_card))
                (out_c, meas_c), t["metrics_cpu"] = sync_ms(lambda: measure_output(sr, h, hr, m_cpu))
                target, gt = hr.astype(np.float64) / 255.0, hr
                _, t["psnr"] = sync_ms(lambda: PSNR(target, out / 255.0))
                _, t["ssim"] = sync_ms(lambda: calculate_ssim(gt, out))
                _, t["lpips_card"] = sync_ms(lambda: m_card.lpips(out, gt))
                _, t["lpips_cpu"] = sync_ms(lambda: m_cpu.lpips(out, gt))
                require(out.shape == (H2, W2, 3) and all(math.isfinite(v) for v in meas.values()),
                        f"pair {i}: {meas}")
                require(np.array_equal(out, out_c) and meas["PSNR"] == meas_c["PSNR"]
                        and meas["SSIM"] == meas_c["SSIM"], f"pair {i}: card {meas}, cpu {meas_c}")
                require(next(m_card._lpips_fn.parameters()).is_cuda
                        and not next(m_cpu._lpips_fn.parameters()).is_cuda, "LPIPS devices")
                with torch.inference_mode():
                    lp64 = float(net64(*(lpips_input(a).double() for a in (out, gt))))
                rel = abs(meas["LPIPS"] - meas_c["LPIPS"]) / abs(meas_c["LPIPS"])
                require(rel <= LPIPS_REL_TOL, f"pair {i}: LPIPS card {meas['LPIPS']} against CPU "
                        f"{meas_c['LPIPS']} ({rel:.2e} relative)")
                images.append(out)
                per_image.append({**meas, "lpips_cpu": meas_c["LPIPS"], "lpips_rel_diff": rel,
                                  "lpips_float64_cpu": lp64,
                                  "lpips_card_rel_to_float64": abs(meas["LPIPS"] - lp64) / abs(lp64),
                                  "lpips_cpu_rel_to_float64": abs(meas_c["LPIPS"] - lp64) / abs(lp64),
                                  "host_ms": t})
            moved = moved_since(before)
            dcn_on_hopper_only(moved, "the eval path")
            require(moved["vq_argmin"] >= 2 and moved["attn_hopper"] >= 22, f"eval path launches {moved}")
        finally:
            os.environ.pop("GLARE_LPIPS_NPZ", None)
            if saved is not None:
                os.environ["GLARE_LPIPS_NPZ"] = saved
    rng = np.random.RandomState(42)
    corpus = []
    for _ in range(4):   # smooth 1/f-like gray fields stand in for a pristine corpus
        f = 0.7 * gaussian_filter(rng.rand(192, 192), 6.0) + 0.3 * gaussian_filter(rng.rand(192, 192), 1.5)
        corpus.append(np.round((f - f.min()) / (f.max() - f.min() + 1e-9) * 255.0))
    pris, fit_ms = sync_ms(lambda: niqe.fit_niqe_params(corpus))
    for rec, out in zip(per_image, images):
        rec["NIQE"], rec["host_ms"]["niqe"] = sync_ms(
            lambda: niqe.calculate_niqe(out[:, :, ::-1], pris_params=pris))
        require(math.isfinite(rec["NIQE"]), f"NIQE {rec['NIQE']}")
    emit({"phase": "eval_path", "pairs": "2 synthetic 600x400 (uint8), the main-path model",
          "cv2_importable": importlib.util.find_spec("cv2") is not None,
          "prep": "data.native (C++, g++ -O3), bit-equal to utils.imgproc.preprocess_padded (numpy)",
          "native_build_s": native_build_s,
          "lpips_tol": f"card vs cpu <= {LPIPS_REL_TOL} relative, TF32 off", "without_npz": note,
          "per_image": per_image, "niqe_fit_ms": fit_ms, "launches": moved})


# (name, width, height) of unpaired_path's synthetic photos: 608x400 after the CLI's
# reflect pad (15200 latent tokens, above the fused attention's 8192; whole 8x16
# DCN tiles at both warps), its portrait, and 336x256 (5376 tokens: no attention
# launch, the chunked path)
UNPAIRED_IMAGES = (("wide", 601, 399), ("portrait", 399, 601), ("small", 333, 250))
ATTN_BLOCKS = 11   # AttnBlocks of the stage-3 network, each fused above 8192 tokens


def _unpaired_photos(folder):
    """Seeded low-light PNGs (uint8) of UNPAIRED_IMAGES under ``folder``."""
    import cv2

    paths = []
    for i, (name, w, h) in enumerate(UNPAIRED_IMAGES):
        img = np.exp(seeded_image(40 + i, 1, h, w)[0]) * 255.0
        path = os.path.join(folder, f"{i}_{name}.png")   # the CLI's natural order is this one
        require(cv2.imwrite(path, np.clip(img, 0, 255).astype(np.uint8)), f"cannot write {path}")
        paths.append(path)
    return paths


@contextlib.contextmanager
def _recorded_enhance(records, shapes):
    """infer_unpaired.enhance_image and the kernel-bearing functions of the path,
    wrapped to record per image: launches, ms (host clock around a synchronize),
    the shapes each kernel saw, the DCN impl of the packs, the output."""
    from glare_tpu_torch.cli import infer_unpaired

    enhance, attn, vq = infer_unpaired.enhance_image, attn_ops.flash_attention_nhc, vq_ops.nearest_code

    def rec_attn(q, k, v, **kw):
        shapes["attention"].append({"qkv": list(q.shape), "n_true": kw.get("n_true"),
                                    "dtype": str(q.dtype).split(".")[-1]})
        return attn(q, k, v, **kw)

    def rec_vq(z, e):
        shapes["vq_argmin"].append({"z": list(z.shape), "codebook": list(e.shape)})
        return vq(z, e)

    def rec_enhance(model, lr, apply_log):
        shapes["attention"], shapes["vq_argmin"] = [], []
        before = counters()
        out, ms = sync_ms(lambda: enhance(model, lr, apply_log))
        dec = model.netG.deformable_decoder
        records.append({"input": list(lr.shape), "ms": ms, "launches": moved_since(before),
                        "attention": shapes["attention"], "vq_argmin": shapes["vq_argmin"],
                        "dcn": dec.last_dcn_shapes(), "dcn_impl": [p.impl for p in dec.dcn_packs()],
                        "out": out})
        return out

    with _swapped({(infer_unpaired, "enhance_image"): rec_enhance, (attn_ops, "flash_attention_nhc"): rec_attn,
                   (vq_ops, "nearest_code"): rec_vq}):
        yield


def _cli_png(rec, pads):
    """cli/infer_unpaired.py's image of ``aft_half``'s output (what ``get_sr``
    returns): cropped to the input, clipped, uint8."""
    from glare_tpu_torch.utils.metrics import img_as_ubyte

    h1, h2, w1, w2 = pads
    sr = rec.float().permute(0, 2, 3, 1)[0].cpu().numpy()
    return img_as_ubyte(np.clip(sr[h1: sr.shape[0] - h2, w1: sr.shape[1] - w2], 0, 1))


def phase_unpaired_path(profile=False):
    """``python -m glare_tpu_torch.cli.infer_unpaired --opt CONF`` on the card: CONF is
    confs/LOL.yml with ``model_path`` at main_path's seeded weights (a .pth of its
    tempered generator) and ``dataroot_unpaired`` at UNPAIRED_IMAGES, run in a
    temporary working directory (results/ lands there). The CLI runs no start-up
    audit (the JAX CLI neither): the DCN packs take the conf's impl, which is
    LOL.yml's inference default 'xla' (exact; on the card the Hopper entry with no
    clamp). The CLI runs twice, the first a warm-up at each shape; the counts are
    set to 0 before the second. Each written PNG equals what the CLI computed, and
    is held by main_path's bar (stages_vs_plain: every stage of get_sr on the CLI's
    input through the plain versions in bf16 and, on a float32 model of the same
    weights, in float32, each fed the kernel run's inputs; codebook flips only at
    near-ties) and, as a PNG, against the PNGs the CLI makes of the two plain runs'
    last stage, by the same ratio rule. ``profile``: then one traced ``get_sr`` of
    the first image's padded input (phase_profile)."""
    import io
    import tempfile

    import yaml

    from glare_tpu_torch.cli import infer_unpaired
    from glare_tpu_torch.cli.infer_paired import load_model
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads
    from glare_tpu_torch.utils.imgproc import auto_padding, imread, log_transform

    repo = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(repo, "confs", "LOL.yml")) as f:
        conf = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as tmp:
        seeded = create_model(lol_opt(), device="cuda")
        temper_offset_heads(seeded.netG, seed=7, std=0.02)
        weights = os.path.join(tmp, "net_G.pth")
        torch.save({k: v.detach().float().cpu() for k, v in seeded.netG.state_dict().items()}, weights)
        del seeded
        os.makedirs(os.path.join(tmp, "photos"))
        photos = _unpaired_photos(os.path.join(tmp, "photos"))
        conf.update({"model_path": weights, "dataroot_unpaired": os.path.join(tmp, "photos")})
        conf_path = os.path.join(tmp, "LOL.yml")
        with open(conf_path, "w") as f:
            yaml.safe_dump(conf, f)
        conf32 = os.path.join(tmp, "LOL_f32.yml")
        with open(conf32, "w") as f:
            yaml.safe_dump({**conf, "inference_dtype": "float32"}, f)

        cwd, argv = os.getcwd(), sys.argv
        runs, shapes, cli_out = [], {}, io.StringIO()
        try:
            os.chdir(tmp)
            sys.argv = ["infer_unpaired", "--opt", conf_path]
            for run in range(2):   # the first: warm-up at each shape
                records = []
                if run == 1:
                    reset_counters()
                with _recorded_enhance(records, shapes), contextlib.redirect_stdout(cli_out):
                    infer_unpaired.main()
                runs.append(records)
            path_counts = counters()
        finally:
            os.chdir(cwd)
            sys.argv = argv
        records = runs[1]
        require(len(records) == len(UNPAIRED_IMAGES), f"the CLI enhanced {len(records)} images")
        require(cli_out.getvalue().count(" -> ") == 2 * len(UNPAIRED_IMAGES), "the CLI's progress lines")

        model, _ = load_model(conf_path, device="cuda")
        model32, _ = load_model(conf32, device="cuda")
        images = []
        for (name, w, h), src, rec, warm in zip(UNPAIRED_IMAGES, photos, records, runs[0]):
            written = imread(os.path.join(tmp, "results", "LOL", "unpaired", os.path.basename(src)))
            require(written.shape == (h, w, 3), f"{name}: written {written.shape}, input {(h, w, 3)}")
            require(np.array_equal(written, rec["out"]), f"{name}: the PNG is not what the CLI computed")
            hp, wp = h + 16 - h % 16, w + 16 - w % 16   # cli's auto_padding (a multiple gets 16 more)
            tokens = (hp // 4) * (wp // 4)
            attn_n = ATTN_BLOCKS if tokens > 8192 else 0
            want = {**{k: 0 for k in counters()}, "vq_argmin": 1, "attn_hopper": attn_n, "dcn_hopper": 2}
            require(rec["launches"] == want, f"{name}: launches {rec['launches']} != {want}")
            require(all(a["n_true"] == tokens and a["qkv"][1] == -(-tokens // 2048) * 2048
                        for a in rec["attention"]), f"{name}: attention shapes {rec['attention']}")
            require(rec["dcn_impl"] == ["xla", "xla"], f"{name}: DCN impl {rec['dcn_impl']}")
            require([v["x"][1:3] for v in rec["dcn"].values()] == [[hp // 2, wp // 2], [hp, wp]],
                    f"{name}: DCN shapes {rec['dcn']}")
            # main_path's bar: each stage of get_sr on the CLI's input (padded, log)
            # through the plain versions in bf16 and in float32, fed the kernel run's
            # inputs; then the PNG the CLI makes of each run's last stage
            padded, pads = auto_padding(imread(src), times=16)
            lq = dev(log_transform(padded.astype(np.float32) / 255.0)[None])
            recs = {}
            stage_ms, stages, flips, flip_gap = stages_vs_plain(model, model32, lq, out=recs)
            pngs = [_cli_png(recs[k], pads) for k in ("rec", "rec_plain", "rec_f32")]
            cmp = stage_cmp(*(torch.from_numpy(a.astype(np.float64)) for a in (written, *pngs[1:])))
            require_stages({f"unpaired.{name}.png": cmp})
            # the whole CLI function through the plain versions, for the record: each
            # run picks its own codebook entries (counted against the kernel run's)
            quant = model.net_hq.quantize
            with torch.inference_mode():
                infer_unpaired.enhance_image(model, imread(src), True)
                idx_k = quant.last_indices.clone()
                with plain_versions():
                    before = counters()
                    whole = [infer_unpaired.enhance_image(model, imread(src), True)]
                    idx_p = quant.last_indices.clone()
                    whole.append(infer_unpaired.enhance_image(model32, imread(src), True))
                    require(counters() == before, "the plain-version run launched a kernel")
            whole_cmp = {**stage_cmp(*(torch.from_numpy(a.astype(np.float64)) for a in (written, *whole))),
                         "codebook_indices_differing": int((idx_k != idx_p).sum())}
            images.append({"image": name, "input_wh": [w, h], "padded_wh": [wp, hp], "latent_tokens": tokens,
                           "ms": rec["ms"], "warmup_ms": warm["ms"], "stage_ms": stage_ms,
                           "launches": rec["launches"],
                           "attention_shapes": [json.loads(a) for a in sorted(
                               {json.dumps(a, sort_keys=True) for a in rec["attention"]})],
                           "attention_calls": len(rec["attention"]),
                           "vq_argmin_shapes": rec["vq_argmin"], "dcn_shapes": rec["dcn"],
                           "dcn_impl": rec["dcn_impl"], "dcn_entry": "hopper" if rec["launches"]["dcn_hopper"] else None,
                           "png_vs_plain": cmp, "stages_vs_plain": stages, "index_flips": flips,
                           "index_flip_worst_rel_gap": flip_gap, "rerun_png_equal": bool(np.array_equal(pngs[0], written)),
                           "whole_cli_vs_plain_not_held": whole_cmp})
        if profile:
            padded, _ = auto_padding(imread(photos[0]), times=16)
            lq = dev(log_transform(padded.astype(np.float32) / 255.0)[None])
            phase_profile(lambda: model.get_sr(lq), f"one get_sr of unpaired_path's {UNPAIRED_IMAGES[0][0]} "
                          f"image, {padded.shape[1]}x{padded.shape[0]} padded, bf16, dcn_impl xla")
        del model, model32
    for k in ("vq_argmin", "attn_hopper", "dcn_hopper"):
        require(path_counts[k] > 0, f"kernel {k} was never launched on unpaired_path")
    emit({"phase": "unpaired_path", "config": "confs/LOL.yml (bf16, dcn_impl default xla), main_path's seeded "
          "weights, cli.infer_unpaired.main", "dcn_route": "no start-up audit in the unpaired CLI (as in JAX): "
          "the conf's impl; ops.dcn.route -> hopper", "images": images, "launches_total": path_counts,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK} (uint8 PNGs)"})
    return path_counts


def stage2_opt(dtype="bfloat16"):
    """The values of confs/train_stage2_LOL.yml that inference reads."""
    opt = lol_opt()
    opt.update({"name": "train_stage2_LOL", "model": "LLFlow", "inference_dtype": dtype})
    opt["datasets"] = {"train": {"quant": 32, "GT_size": 320, "log_low": True}}
    opt["network_G"] = {"which_model_G": "LLFlowVQGAN2", "flow": dict(lol_opt()["network_G"]["flow"])}
    return opt


def phase_stage2_path():
    """Stage-2 inference at full width: get_sr (latent) -> decode_latent, 600x400, bf16."""
    from glare_tpu_torch.models import create_model

    t0 = time.time()
    model = create_model(stage2_opt(), device="cuda")
    build_s = time.time() - t0
    # attention: 3 blocks in ConEncoder1 + 4 in the VQGAN decoder, each above the
    # 8192-token threshold at 15000 tokens; one codebook retrieval
    per_call = {**{k: 0 for k in counters()}, "vq_argmin": 1, "attn_hopper": 7}
    model.decode_latent(model.get_sr(dev(seeded_image(98, 1, H2, W2))))   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    calls = []
    for seed, batch in [(30, 1), (31, 1), (32, 2), (34, 2)]:  # a new batch size pays once
        lq = dev(seeded_image(seed, batch, H2, W2))
        before = counters()
        img, ms = sync_ms(lambda: model.decode_latent(model.get_sr(lq)))
        moved = moved_since(before)
        require(tuple(img.shape) == (batch, H2, W2, 3) and img.dtype == torch.float32,
                f"decode_latent output {tuple(img.shape)} {img.dtype}")
        require(bool(torch.isfinite(img).all()), "stage-2 output is not finite")
        require(moved == per_call, f"launches per stage-2 request {moved} != {per_call}")
        calls.append({"seed": seed, "batch": batch, "ms": ms, "ms_per_image": ms / batch,
                      "launches": moved, "out_mean": float(img.mean()), "out_std": float(img.std())})
    path_counts = counters()
    peak_mem = torch.cuda.max_memory_allocated()
    for k, n in per_call.items():
        require(n == 0 or path_counts[k] > 0, f"kernel {k} was never launched on the stage-2 path")

    model32 = create_model(stage2_opt("float32"), device="cuda")   # same seed: the same weights
    lq = dev(seeded_image(30, 1, H2, W2))
    gt = dev(np.exp(seeded_image(33, 1, H2, W2)))
    stage_ms = {}
    for _ in range(2):  # second pass is the timed one
        lat, stage_ms["get_sr"] = sync_ms(lambda: model.get_sr(lq))
        img, stage_ms["decode_latent"] = sync_ms(lambda: model.decode_latent(lat))
    idx_k = model.net_hq.quantize.last_indices.clone()
    nll, stage_ms["get_encode_nll"] = sync_ms(lambda: model.get_encode_nll(lq, gt))
    with plain_versions():
        before = counters()
        lat_p, img_p = model.get_sr(lq), model.decode_latent(lat)
        idx_p = model.net_hq.quantize.last_indices.clone()
        nll_p = model.get_encode_nll(lq, gt)
        lat_f, img_f = model32.get_sr(lq), model32.decode_latent(lat)
        idx_f = model32.net_hq.quantize.last_indices.clone()
        nll_f = model32.get_encode_nll(lq, gt)
        torch.cuda.synchronize()
        require(counters() == before, "the plain-version run launched a kernel")
    stages = {"get_sr.latent": stage_cmp(lat, lat_p, lat_f),
              "decode_latent.image": stage_cmp(img, img_p, img_f)}
    require_stages(stages)
    require(bool((idx_f == idx_p).all()), "float32 and bf16 models disagree on codebook indices "
            "for the same latent: their codebooks differ")
    flips, flip_rel_gap = index_flips(model, lat.permute(0, 3, 1, 2), idx_k, idx_p)
    require(all(math.isfinite(v) for v in (nll, nll_p, nll_f)), "non-finite NLL")
    require(abs(nll - nll_f) <= STAGE_RATIO * abs(nll_p - nll_f) + STAGE_ABS_SLACK * abs(nll_f),
            f"NLL: kernel path {nll}, plain bf16 {nll_p}, float32 {nll_f}")
    emit({"phase": "stage2_path", "config": "confs/train_stage2_LOL.yml widths, bf16",
          "input": [H2, W2], "latent_tokens": N_TOK2, "model_build_s": round(build_s, 2),
          "calls": calls, "launches_total": path_counts, "expected_per_call": per_call,
          "stage_ms_per_image": stage_ms, "stage_vs_plain": stages,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}",
          "nll_bits_per_latent_pixel": {"kernel": nll, "plain_bf16": nll_p, "float32": nll_f},
          "index_flips": flips, "index_flip_worst_rel_gap": flip_rel_gap,
          "max_memory_allocated": peak_mem})
    return path_counts


def train_opt():
    """The values of confs/train_stage3_LOL.yml that stage-3 training reads (the
    port's own dict: no yaml here): full width, float32 (no mixed_precision), the
    training default dcn_impl chain at radius 2, Adam (0.9, 0.99), lr 5e-5 with
    10 warmup updates and the conf's relative milestones at niter 40000."""
    opt = lol_opt()
    opt.pop("inference_dtype")
    opt.update({"name": "train_stage3_LOL", "is_train": True})
    opt["datasets"] = {"train": {"quant": 32, "GT_size": TRAIN_GT, "batch_size": TRAIN_BATCH,
                                 "log_low": True}}
    opt["network_G"] = {"which_model_G": "VQLLFLOWDeformable",
                        "flow": dict(lol_opt()["network_G"]["flow"])}
    opt["train"] = {"manual_seed": 10, "lr_G": 5e-5, "weight_decay_G": 0, "beta1": 0.9, "beta2": 0.99,
                    "lr_scheme": "MultiStepLR", "warmup_iter": 10, "lr_gamma": 0.5, "niter": 40000,
                    "lr_steps": [int(f * 40000) for f in (0.5, 0.75, 0.9, 0.95)]}
    return opt


def train_batch(seed, batch=TRAIN_BATCH, size=TRAIN_GT):
    """A synthetic pair at the training crop: low-light LQ in the log domain, as the
    dataset's log_low gives it, and a brighter GT in [0, 1]."""
    lq = seeded_image(seed, batch, size, size)
    gt = np.clip(np.exp(lq) * 5.0 + 0.05, 0.0, 1.0).astype(np.float32)
    return {"LQ": dev(lq), "GT": dev(gt)}


@contextlib.contextmanager
def counted_plain_versions():
    """Counts the calls of every plain version in PLAIN_VERSIONS made inside the
    block -> a one-item list."""
    calls = [0]

    def counted(fn):
        def call(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return call

    with _swapped({(mod, plain): counted(getattr(mod, plain)) for mod, _, plain in PLAIN_VERSIONS}):
        yield calls


def condition_offset_heads(model, batch):
    """Seeded heads whose DCN offsets stay off the integer grid: the offset
    derivative jumps at integer sample positions, so two runs whose offsets differ
    by rounding could take different corners there (the kernel run and the
    plain-version run differ by rounding from warp_0 on). Each offset channel gets
    a half-integer bias in [-2.5, 2.5] (the +-2.5 ones beyond the clamp radius 2)
    and the weights are scaled until the input-dependent part stays within 0.25 px
    on ``batch``. The DCN biases are raised by 1: the AFT's x_vq * mean(h) /
    mean(x_vq) amplifies rounding by mean(h) / mean(x_vq)^2 where mean(x_vq) ~ 0.
    -> the largest input-dependent part measured."""
    x_in = batch["LQ"].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return _condition_heads([w.dcn for w in model.netG.deformable_decoder.warp],
                            lambda: model._pipeline(x_in))


def _condition_heads(packs, forward):
    """condition_offset_heads for the DCNv2Packs ``packs``, whose offsets a call of
    ``forward`` computes (under no_grad)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    with torch.no_grad():
        for pack in packs:
            n = 2 * pack.G * pack.K   # the reference packing: the first 2*G*K channels are (dy, dx)
            pack.conv_offset.bias[:n] = (torch.randint(-3, 3, (n,), generator=g) + 0.5).to(pack.bias.device)
            pack.bias += 1.0
        spread = math.inf
        for _ in range(4):
            for pack in packs:
                pack.audit_offsets = True
            forward()
            spread = max(float((p.last_offsets - p.conv_offset.bias[:2 * p.G * p.K].reshape(
                p.G, p.K, 2)).abs().max()) for p in packs)
            for pack in packs:
                pack.audit_offsets, pack.last_offsets = False, None
            if spread <= 0.25:
                break
            for pack in packs:
                pack.conv_offset.weight *= 0.2 / spread
    require(spread <= 0.25, f"offset heads: input-dependent part {spread} px after scaling")
    return spread


def _step_grads(model, batch):
    """One step's loss and trainable gradients, without the update, and the
    offsets' least distance from the integer grid."""
    packs = [w.dcn for w in model.netG.deformable_decoder.warp]
    for pack in packs:
        pack.audit_offsets = True
    model.optimizer.zero_grad(set_to_none=True)
    total, parts = model.train_losses(batch["LQ"], batch["GT"])
    total.backward()
    gap = min(float((p.last_offsets.detach() - p.last_offsets.detach().round()).abs().min()) for p in packs)
    for pack in packs:
        pack.audit_offsets, pack.last_offsets = False, None
    grads = {n: p.grad.detach().clone() for n, p in model.trainable_parameters()}
    model.optimizer.zero_grad(set_to_none=True)
    return float(total.detach()), [float(t.detach()) for t in parts], grads, gap


STEP_LOSS_TOL = 1e-5    # relative
STEP_GRAD_TOL = 1e-3    # of each tensor's largest gradient
STEP_VANISH = 1e-6      # of the step's largest gradient: a tensor that vanishes in exact arithmetic


def _dists(got, want, vanish_top, what, norm=False):
    """For each tensor of ``want``: |got - want| as a share of want's largest (``norm``:
    the 2-norm of got - want over want's 2-norm, which one cancelled element does
    not dominate). A tensor below STEP_VANISH of ``vanish_top`` (the largest of its
    kind) vanishes in exact arithmetic and must vanish on both sides: None."""
    out = {}
    for n, w in want.items():
        g, w = got[n].detach().double().cpu(), w.detach().double().cpu()
        if float(w.abs().max()) <= STEP_VANISH * vanish_top:
            require(float(g.abs().max()) <= STEP_VANISH * vanish_top, f"{what} {n} does not vanish")
            out[n] = None
        elif norm:
            out[n] = float((g - w).norm() / w.norm())
        else:
            out[n] = float((g - w).abs().max() / w.abs().max())
    return out


def _worst(errs):
    """The largest distance of ``errs`` ({tensor: distance, or None where it vanishes})."""
    vanishing = sorted(n for n, e in errs.items() if e is None)
    errs = {k: v for k, v in errs.items() if v is not None}
    name = max(errs, key=errs.get)
    return {"worst": errs[name], "worst_tensor": name, "compared": len(errs),
            "vanishing": len(vanishing), "vanishing_first": vanishing[:3]}


def _train_model(mixed_precision):
    """The training model of train_opt() (bf16 compute with float32 master weights
    when ``mixed_precision``), offset heads tempered. -> (model, build seconds)."""
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    t0 = time.time()
    opt = train_opt()
    if mixed_precision:
        opt["train"]["mixed_precision"] = True
    model = create_model(opt, device="cuda")
    temper_offset_heads(model.netG, seed=7, std=0.02)
    return model, time.time() - t0


def _tensors_moved(model, params0):
    """After a step from ``params0``: (trainable tensors changed, of those the ones
    with a gradient above STEP_VANISH of the step's largest, tensors with such a
    gradient)."""
    top = max(float(p.grad.abs().max()) for _, p in model.trainable_parameters())
    changed = [not torch.equal(p, params0[n]) for n, p in model.trainable_parameters()]
    live = [float(p.grad.abs().max()) > STEP_VANISH * top for _, p in model.trainable_parameters()]
    return sum(changed), sum(c for c, lv in zip(changed, live) if lv), sum(live)


def _require_updates(moved_after):
    """The warm-up update (lr 0) changed nothing; every later one moved every tensor
    with a live gradient (``moved_after``: one _tensors_moved a step)."""
    require(moved_after[0][0] == 0, "the warm-up step (lr 0) changed a parameter")
    require(all(live_changed == live > 0 for _, live_changed, live in moved_after[1:]),
            f"trainable tensors with a gradient that did not move: {moved_after}")


def _train_steps(model, batches, per_step, bwd_per_step):
    """A warm-up step and three timed steps of optimize_parameters, launch
    counters per step (exactly ``per_step`` and ``bwd_per_step``), no plain-version
    call; the warm-up update (lr 0) leaves every parameter bit-equal, every later
    one moves every tensor with a live gradient; the frozen sub-networks and the
    VQGAN bit-equal. -> (steps, counts over the steps, peak memory)."""
    from glare_tpu_torch.models.vqllflowd_model import FROZEN

    frozen0 = {n: p.detach().clone() for n, p in model.netG.named_parameters()
               if n.split(".", 1)[0] in FROZEN}
    vq0 = {n: t.detach().clone() for n, t in model.net_hq.state_dict().items()}
    taps = 2 * sum(TRAIN_BATCH * (TRAIN_GT // s) ** 2 * 4 * 9 for s in (2, 1))
    reset_counters()
    steps, moved_after = [], []
    with counted_plain_versions() as plain_calls:
        for i, batch in enumerate(batches):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            params0 = {n: p.detach().clone() for n, p in model.trainable_parameters()}
            before, by_entry = counters(), dict(dcn_ops.bwd_launches_by_entry)
            losses, ms = sync_ms(lambda: model.optimize_parameters(batch))
            moved, moved_e = moved_since(before), bwd_moved_since(by_entry)
            require(moved == per_step, f"train step {i}: launches {moved} != {per_step}")
            require(moved_e == bwd_per_step,
                    f"train step {i}: DCN backward kernels {moved_e} != {bwd_per_step}")
            require(plain_calls[0] == 0, f"train step {i}: {plain_calls[0]} plain-version calls")
            require(all(math.isfinite(v) for v in losses), f"train step {i}: losses {losses}")
            moved_after.append(_tensors_moved(model, params0))
            ov = model.last_dcn_overflow()
            steps.append({"step": i, "ms": ms, "images_per_s": TRAIN_BATCH / ms * 1e3,
                          "lr": model.schedule(i), "losses": dict(model.get_current_log()),
                          "launches": moved, "dcn_bwd_kernels": moved_e,
                          "trainable_tensors_changed": moved_after[-1][0],
                          "dcn_overflow": ov, "clamp_share": ov["taps_beyond_tail"] / taps})
    path_counts = counters()
    peak_mem = torch.cuda.max_memory_allocated()
    _require_updates(moved_after)
    for n, p in model.netG.named_parameters():
        if n.split(".", 1)[0] in FROZEN:
            require(not p.requires_grad and torch.equal(p, frozen0[n]), f"frozen {n} changed")
    for n, t in model.net_hq.state_dict().items():
        require(torch.equal(t, vq0[n]), f"VQGAN {n} changed")
    return steps, path_counts, peak_mem


def _steps_summary(steps):
    timed = steps[1:]
    ms_mean = sum(t["ms"] for t in timed) / len(timed)
    return {"steps": steps, "ms_per_step": ms_mean, "images_per_s": TRAIN_BATCH / ms_mean * 1e3}


def phase_train_path():
    """Stage-3 training at the full width of confs/train_stage3_LOL.yml, float32, the
    256 crop at batch 2, seeded weights, synthetic pairs: one warm-up step (its
    update is 0: warmup from count 0) and three timed steps through
    VQLLFLOWDModel.optimize_parameters, launch counters per step; then one step's
    loss and gradients through the kernels against the same step through the
    plain versions (autograd of modulated_deform_conv_ref for the DCN)."""
    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 is on: the float32 training path would not be float32")
    model, build_s = _train_model(False)
    batches = [train_batch(60 + i) for i in range(5)]
    spread = condition_offset_heads(model, batches[0])
    per_step = {**{k: 0 for k in counters()}, "vq_argmin": 1, "dcn_fwd_f32": 2, "dcn_bwd": 2}
    # x of both warps is the VQ decoder's tap, under no-grad: the pass without grad_x
    bwd_per_step = {**{k: 0 for k in dcn_ops.bwd_launches_by_entry}, "pass": 2}
    steps, path_counts, peak_mem = _train_steps(model, batches[:4], per_step, bwd_per_step)

    # one step's loss and gradients: kernels against the plain versions, same weights and batch
    loss_k, parts_k, grads_k, gap_k = _step_grads(model, batches[4])
    with plain_versions():
        before = counters()
        loss_p, parts_p, grads_p, gap_p = _step_grads(model, batches[4])
        torch.cuda.synchronize()
        require(counters() == before, "the plain-version step launched a kernel")
    top = max(float(g.abs().max()) for g in grads_p.values())
    grads = _worst(_dists(grads_k, grads_p, top, "gradient"))
    cmp = {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
           "parts_kernel": parts_k, "parts_plain": parts_p, "grads": grads,
           "offset_grid_gap": [gap_k, gap_p],
           "tol": f"loss {STEP_LOSS_TOL} relative; each gradient within {STEP_GRAD_TOL} of its largest "
                  f"(a tensor below {STEP_VANISH} of the step's largest must vanish on both)"}
    emit({"phase": "train_path", "config": "confs/train_stage3_LOL.yml widths, float32, dcn_impl chain R=2",
          "crop": [TRAIN_GT, TRAIN_GT], "batch": TRAIN_BATCH, "model_build_s": round(build_s, 2),
          "offset_heads": {"bias": "half-integers in [-2.5, 2.5]", "input_dependent_px": spread,
                           "dcn_bias": "+1"},
          **_steps_summary(steps), "launches_total": path_counts, "expected_per_step": per_step,
          "max_memory_allocated": peak_mem, "kernel_vs_plain_step": cmp})
    require(min(gap_k, gap_p) > 0.02, f"offsets within {min(gap_k, gap_p)} px of the integer grid")
    require(cmp["loss_rel"] <= STEP_LOSS_TOL, f"step loss: kernels {loss_k}, plain {loss_p}")
    require(grads["worst"] <= STEP_GRAD_TOL, f"gradient {grads['worst_tensor']}: {grads['worst']}")
    _remat_step(batches[4])
    return path_counts, model


REMAT_FLOOR = 1e-6   # relative: the bar of a remat step where two plain steps agree exactly


def _remat_step(batch):
    """network_G.dcn_impl xla in training: JAX's rule (define_Flow) turns remat on,
    so every ResnetBlock, AttnBlock and WarpBlock of the AFT decoder runs under
    torch.utils.checkpoint. One step's loss and gradients (no update) with remat,
    between two of the same step with remat off (the same model, the flag
    cleared): the remat step's distance from the first plain step, per tensor,
    within the two plain steps' own distance or REMAT_FLOOR, whichever is larger.
    Launches per step: the plain step's DCN forwards (dcn_fwd_f32 2, the exact op
    under autograd) and 2 more with remat (the WarpBlocks recomputed in the
    backward). Peak memory and ms of each step."""
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    opt = train_opt()
    opt["network_G"]["dcn_impl"] = "xla"
    model = create_model(opt, device="cuda")
    dec = model.netG.deformable_decoder
    require(dec.remat, "dcn_impl xla in training: define_Flow left remat off")
    temper_offset_heads(model.netG, seed=7, std=0.02)
    condition_offset_heads(model, batch)
    runs = {}
    for name, remat in (("warmup", False), ("plain", False), ("remat", True), ("plain_again", False)):
        dec.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counters()
        (loss, parts, grads, gap), ms = sync_ms(lambda: _step_grads(model, batch))
        runs[name] = {"loss": loss, "parts": parts, "grads": grads, "gap": gap, "ms": ms,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": moved_since(before)}
    dec.remat = True
    per_step = {**{k: 0 for k in counters()}, "vq_argmin": 1, "dcn_fwd_f32": 2, "dcn_bwd": 2}
    for name, r in runs.items():
        want = {**per_step, "dcn_fwd_f32": 4} if name == "remat" else per_step
        require(r["launches"] == want, f"remat check, {name} step: launches {r['launches']} != {want}")
    plain, again, rem = runs["plain"], runs["plain_again"], runs["remat"]
    top = max(float(g.abs().max()) for g in plain["grads"].values())
    spread = _dists(again["grads"], plain["grads"], top, "plain-step gradient")
    dist = _dists(rem["grads"], plain["grads"], top, "remat-step gradient")
    over = {n: (d, spread[n]) for n, d in dist.items() if d is not None and d > max(spread[n], REMAT_FLOOR)}
    loss_spread = abs(again["loss"] - plain["loss"]) / abs(plain["loss"])
    loss_dist = abs(rem["loss"] - plain["loss"]) / abs(plain["loss"])
    emit({"phase": "train_path.remat", "config": "train_path's model with dcn_impl xla (remat on by JAX's rule)",
          "steps": {n: {**{k: r[k] for k in ("loss", "parts", "ms", "max_memory_allocated", "gap")},
                        "launches": {k: v for k, v in r["launches"].items() if v}} for n, r in runs.items()},
          "loss_rel": {"remat_vs_plain": loss_dist, "plain_vs_plain": loss_spread},
          "grads_remat_vs_plain": _worst(dist), "grads_plain_vs_plain": _worst(spread),
          "tensors_over_the_bar": over,
          "tol": f"each gradient and the loss: remat vs plain <= max(plain vs plain, {REMAT_FLOOR}) relative"})
    require(loss_dist <= max(loss_spread, REMAT_FLOOR), f"remat step loss {rem['loss']}, plain {plain['loss']}")
    require(not over, f"remat step gradients beyond the plain steps' spread: {over}")
    del model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _float32_compute(model):
    """The same model's networks computing in float32 for the block (the bf16
    VQGAN's weights widened exactly), then bf16 again."""
    from glare_tpu_torch.nn.layers import cast_convs_

    model.netG.set_compute_dtype(torch.float32, master_weights=True)
    cast_convs_(model.net_hq, torch.float32)
    try:
        yield
    finally:
        model.netG.set_compute_dtype(torch.bfloat16, master_weights=True)
        cast_convs_(model.net_hq, torch.bfloat16)


def _rel_rms(a, ref):
    ref = ref.double()
    return float(((a.double() - ref) ** 2).mean().sqrt()) / max(float((ref ** 2).mean().sqrt()), 1e-30)


def phase_train_path_bf16():
    """train.mixed_precision: the same training at bf16 compute with float32 master
    weights and Adam moments, through the Hopper DCN forward (entry hopper) and
    the bf16 backward entries of csrc/dcn_bwd.cu: a warm-up step and three timed
    steps (as train_path), exactly {vq_argmin 1, dcn_hopper 2, dcn_bwd_bf16 2} a
    step and no plain version. Then one step's loss and gradients three ways on
    the same weights and batch: bf16 through the kernels, bf16 through the plain
    versions, float32 through the plain versions; the kernel step may be at most
    STAGE_RATIO x as far (relative RMS per gradient, relative for the loss) from
    the float32 step as the plain bf16 step is, + STAGE_ABS_SLACK."""
    model, build_s = _train_model(True)
    require(model.dtype == torch.bfloat16, "train.mixed_precision did not set bf16 compute")
    batches = [train_batch(80 + i) for i in range(5)]
    spread = condition_offset_heads(model, batches[0])
    per_step = {**{k: 0 for k in counters()}, "vq_argmin": 1, "dcn_hopper": 2, "dcn_bwd_bf16": 2}
    bwd_per_step = {**{k: 0 for k in dcn_ops.bwd_launches_by_entry}, "pass_bf16": 2}
    steps, path_counts, peak_mem = _train_steps(model, batches[:4], per_step, bwd_per_step)
    for n, p in model.netG.named_parameters():
        require(p.dtype == torch.float32, f"parameter {n} is {p.dtype}")
    for _, p in model.trainable_parameters():
        st = model.optimizer.state[p]
        require(st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32, "Adam moments not float32")

    loss_k, parts_k, grads_k, gap_k = _step_grads(model, batches[4])
    with plain_versions():
        before = counters()
        loss_p, parts_p, grads_p, gap_p = _step_grads(model, batches[4])
        with _float32_compute(model):
            loss_f, parts_f, grads_f, gap_f = _step_grads(model, batches[4])
        torch.cuda.synchronize()
        require(counters() == before, "a plain-version step launched a kernel")
    top = max(float(g.abs().max()) for g in grads_f.values())
    dist = {}
    for n, gf in grads_f.items():
        if float(gf.abs().max()) <= STEP_VANISH * top:   # vanishes in exact arithmetic: the step's scale
            d = lambda g, gf=gf: float((g.double() - gf.double()).abs().max()) / top  # noqa: E731
        else:
            d = lambda g, gf=gf: _rel_rms(g, gf)  # noqa: E731
        dist[n] = (d(grads_k[n]), d(grads_p[n]))
    ratio = {n: dk / (STAGE_RATIO * dp + STAGE_ABS_SLACK) for n, (dk, dp) in dist.items()}
    worst = max(ratio, key=ratio.get)
    loss_d = [abs(a - b) / abs(b) for a, b in zip([loss_k] + parts_k, [loss_f] + parts_f)]
    loss_dp = [abs(a - b) / abs(b) for a, b in zip([loss_p] + parts_p, [loss_f] + parts_f)]
    cmp = {"loss_kernel": loss_k, "loss_plain_bf16": loss_p, "loss_float32": loss_f,
           "parts_kernel": parts_k, "parts_plain_bf16": parts_p, "parts_float32": parts_f,
           "loss_dist_kernel": loss_d, "loss_dist_plain_bf16": loss_dp,
           "grad_worst_tensor": worst, "grad_worst_dist": dist[worst], "grad_worst_ratio_of_limit": ratio[worst],
           "grad_median_dist": [statistics.median(d[0] for d in dist.values()),
                                statistics.median(d[1] for d in dist.values())],
           "offset_grid_gap": [gap_k, gap_p, gap_f],
           "tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_bf16_vs_f32 + {STAGE_ABS_SLACK} (relative RMS "
                  "per gradient; relative for the loss and its parts; a gradient below "
                  f"{STEP_VANISH} of the step's largest in units of that largest)"}
    emit({"phase": "train_path_bf16",
          "config": "confs/train_stage3_LOL.yml widths, train.mixed_precision (bf16 compute, float32 "
                    "master weights), dcn_impl chain R=2",
          "crop": [TRAIN_GT, TRAIN_GT], "batch": TRAIN_BATCH, "model_build_s": round(build_s, 2),
          "offset_heads": {"bias": "half-integers in [-2.5, 2.5]", "input_dependent_px": spread,
                           "dcn_bias": "+1"},
          **_steps_summary(steps), "launches_total": path_counts, "expected_per_step": per_step,
          "max_memory_allocated": peak_mem, "kernel_vs_plain_step": cmp})
    require(min(gap_k, gap_p, gap_f) > 0.02, f"offsets within {min(gap_k, gap_p, gap_f)} px of the grid")
    for i, (dk, dp) in enumerate(zip(loss_d, loss_dp)):
        require(dk <= STAGE_RATIO * dp + STAGE_ABS_SLACK, f"step loss term {i}: {dk} against {dp}")
    require(ratio[worst] <= 1.0, f"gradient {worst}: kernel {dist[worst][0]}, plain bf16 {dist[worst][1]}")
    return path_counts, model


# ------------------------------------------------------- stage-2 training --

S2_GT, S2_BATCH = 320, 4     # confs/train_stage2_LOL.yml: GT_size, batch_size
S2_CROP = 160                # the card-against-CPU checks: one 160x160 crop of one image
S2_VAL = 2                   # validation images, at the eval set's 600x400
ACTNORM_TOL = 1e-4           # ActNorm init, card against CPU: of each tensor's largest
ACTNORM_MEAN_TOL, ACTNORM_STD_TOL = 1e-4, 1e-3   # each ActNorm's output over the init batch
S2_TRAINED_TOL = 3e-3        # the step at the trained weights: each gradient's 2-norm distance, relative
S2_FAULT = 1.1               # its control: a 10% fault in one coupling's conditional backward
S2_FAULT_SMALL = 1.01        # reported: a 1% fault, the bar's resolution
S2_F64_TOL = 1e-10           # the card's float64 step against the CPU's: each gradient's 2-norm distance
                             # (measured 9.8e-15 on an H100; the 0.1% fault reads 2.0e-4: PERF.md section 6)
S2_FAULT_TINY = 1.001        # reported beside the float64 bar: a 0.1% fault
S2_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_stage2")


def train2_opt():
    """The values of confs/train_stage2_LOL.yml that stage-2 training reads (the port's
    own dict: no yaml here): full width and depth (ConEncoder1 ch 128, ch_mult
    [1,2,4]; flow K 12, L 2, hidden 64; VQGAN n_embed 8192), float32, GT_size 320,
    batch 4, Adam (0.9, 0.99), lr 5e-4, warmup 10, the conf's relative milestones at
    niter 80000; checkpoints under build/ (git-ignored)."""
    opt = stage2_opt("float32")
    opt.pop("inference_dtype")
    opt.update({"name": "train_stage2_LOL", "is_train": True,
                "path": {"models": os.path.join(S2_DIR, "models"),
                         "training_state": os.path.join(S2_DIR, "training_state")}})
    opt["datasets"] = {"train": {"quant": 32, "GT_size": S2_GT, "batch_size": S2_BATCH, "log_low": True}}
    opt["train"] = {"manual_seed": 10, "lr_G": 5e-4, "weight_decay_G": 0, "beta1": 0.9, "beta2": 0.99,
                    "lr_scheme": "MultiStepLR", "warmup_iter": 10, "lr_gamma": 0.5, "niter": 80000,
                    "lr_steps": [int(f * 80000) for f in (0.5, 0.75, 0.9, 0.95)],
                    "weight_l1": 0, "weight_fl": 1}
    return opt


def _actnorm_tensors(net):
    return {n: t for n, t in net.state_dict().items() if ".actnorm." in n}


def _actnorm_init_card_vs_cpu(model, cpu_model, crop):
    """The ActNorm data-dependent init (normal_flow with ddinit) on one crop, on the card
    and on the CPU from the same weights: every ActNorm's bias / logs within
    ACTNORM_TOL of the tensor's largest (a bias below STEP_VANISH of the largest bias
    is rounding noise: the second ActNorm of a run of steps sees a zero-mean input),
    and, by forward hooks on the card, each ActNorm's output over the crop of mean 0
    and std 1 per channel. The card's weights are restored afterwards."""
    from glare_tpu_torch.modules.flow_layers import ActNorm2d

    w0 = {n: t.detach().clone() for n, t in model.netG.state_dict().items()}
    cpu_model.netG.load_state_dict(w0)
    stats = []

    def hook(module, args, out):
        y = out[0].detach().double()
        mean = y.mean(dim=(0, 2, 3))
        std = ((y - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3)).sqrt()
        stats.append((float(mean.abs().max()), float((std - module.scale).abs().max())))

    def ddinit(m, batch):
        lq = batch["LQ"].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        latent = m.encode_gt_latent(batch["GT"]).permute(0, 3, 1, 2)
        with torch.no_grad():
            m.netG.normal_flow(latent.contiguous(memory_format=torch.channels_last), lq, ddinit=True)

    handles = [m.register_forward_hook(hook) for m in model.netG.modules() if isinstance(m, ActNorm2d)]
    try:
        ddinit(model, crop)
    finally:
        for h in handles:
            h.remove()
    ddinit(cpu_model, {k: v.cpu() for k, v in crop.items()})
    card, cpu = _actnorm_tensors(model.netG), _actnorm_tensors(cpu_model.netG)
    require(len(stats) == len(card) // 2, f"{len(stats)} ActNorm outputs hooked, {len(card) // 2} ActNorms")
    errs = {}
    for kind in ("bias", "logs"):
        want = {n: t for n, t in cpu.items() if n.endswith(kind)}
        errs.update(_dists(card, want, max(float(t.abs().max()) for t in want.values()), "ActNorm"))
    worst = _worst(errs)
    require(worst["worst"] <= ACTNORM_TOL, f"ActNorm {worst['worst_tensor']}: {worst['worst']:.3e} of "
            f"its largest (tolerance {ACTNORM_TOL})")
    require(all(not torch.equal(cpu[n], w0[n].cpu()) for n in cpu if n.endswith("logs")),
            "the ActNorm init left a logs tensor as it was")
    worst_mean, worst_std = max(s[0] for s in stats), max(s[1] for s in stats)
    require(worst_mean <= ACTNORM_MEAN_TOL, f"an ActNorm output has a channel mean {worst_mean}")
    require(worst_std <= ACTNORM_STD_TOL, f"an ActNorm output has a channel std off by {worst_std}")
    model.netG.load_state_dict(w0)
    return {"actnorms": len(stats), **worst,
            "output_worst_abs_channel_mean": worst_mean, "output_worst_abs_channel_std_minus_1": worst_std,
            "tol": f"bias / logs within {ACTNORM_TOL} of each tensor's largest; outputs: |mean| <= "
                   f"{ACTNORM_MEAN_TOL}, |std - 1| <= {ACTNORM_STD_TOL} per channel"}


def _loss_and_grads(model, batch):
    model.optimizer.zero_grad(set_to_none=True)
    loss = model.train_loss(batch["LQ"], batch["GT"])
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.trainable_parameters()}
    model.optimizer.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _losses_and_grads_card_cpu(model, cpu_model, crop, weights):
    """One step's loss and trainable gradients on the crop at ``weights``, on the card
    and on the CPU; the card's weights are restored. Holds the loss to
    STEP_LOSS_TOL relative. -> (loss card, loss CPU, grads card, grads CPU)."""
    kept = {n: t.detach().clone() for n, t in model.netG.state_dict().items()}
    model.netG.load_state_dict(weights)
    cpu_model.netG.load_state_dict({n: t.cpu() for n, t in weights.items()})
    loss_k, grads_k = _loss_and_grads(model, crop)
    loss_c, grads_c = _loss_and_grads(cpu_model, {k: v.cpu() for k, v in crop.items()})
    model.netG.load_state_dict(kept)
    require(math.isfinite(loss_k) and abs(loss_k - loss_c) <= STEP_LOSS_TOL * abs(loss_c),
            f"stage-2 loss: card {loss_k}, CPU {loss_c}")
    require(set(grads_k) == set(grads_c), "card and CPU train different parameters")
    return loss_k, loss_c, grads_k, grads_c


@contextlib.contextmanager
def _cond_grad_fault(net, scale, coupling=0):
    """The control of the trained-weights bar: inside the block, the gradient that the
    ``coupling``-th coupling of the flow sends into the conditional features is scaled
    by ``scale`` and its values are unchanged: a fault in the conditional branch's
    backward, upstream of RRDB.cond_conv."""
    affine = [m.affine for m in net.flowUpsamplerNet.layers if getattr(m, "affine", None) is not None]

    def hook(module, args, kwargs):
        ft = kwargs["ft"]
        return args, {**kwargs, "ft": ft + (scale - 1.0) * (ft - ft.detach())}

    handle = affine[coupling].register_forward_pre_hook(hook, with_kwargs=True)
    try:
        yield
    finally:
        handle.remove()


def _step_card_vs_cpu(model, cpu_model, crop, init_weights):
    """One step's loss and every trainable gradient on the crop, card against CPU, at
    two points. (1) ``init_weights`` (netG just after the ActNorm init): the loss
    within STEP_LOSS_TOL relative, each gradient within STEP_GRAD_TOL of its largest
    (a tensor below STEP_VANISH of the step's largest vanishes on both); here every
    Conv2dZeros is 0, so the FNets' hidden layers and RRDB.cond_conv get exactly 0.
    (2) The model's trained weights (after the timed steps), where those tensors have
    a gradient: the loss to the same bar, and each gradient within S2_TRAINED_TOL in
    the 2-norm, ||g - g_ref|| / ||g_ref||, both against the CPU's float32 step and
    against the exact one (the CPU model widened to float64). Some FNet gradients
    there are ill-conditioned sums whose float32 rounding, on either device, reaches
    ~1e-3 of the largest element; the 2-norm is not ruled by one element. Reported
    beside them: the CPU's own float32 distance from float64 and the card's step
    run again. The control, which must exceed the bar: the card's step with the fault of
    _cond_grad_fault (S2_FAULT; S2_FAULT_SMALL reported). (3) The same step at the
    trained weights with the card's model widened to float64 too (a stage-2 step
    launches no hand-written kernel), each gradient within S2_F64_TOL in the 2-norm
    of the CPU's float64 step; its controls, the card's float64 step with the faults
    S2_FAULT and S2_FAULT_SMALL, must exceed that bar (S2_FAULT_TINY reported). The
    card's model is float32 again afterwards, at the trained weights; the CPU model
    is float64."""
    cpu_crop = {k: v.cpu() for k, v in crop.items()}
    loss_k, loss_c, grads_k, grads_c = _losses_and_grads_card_cpu(model, cpu_model, crop, init_weights)
    top = max(float(g.abs().max()) for g in grads_c.values())
    first = _worst(_dists(grads_k, grads_c, top, "gradient"))
    trained = {n: t.detach().clone() for n, t in model.netG.state_dict().items()}
    loss_tk, loss_tc, grads_tk, grads_tc = _losses_and_grads_card_cpu(model, cpu_model, crop, trained)
    _, rerun = _loss_and_grads(model, crop)
    faulty = {}
    for fault in (S2_FAULT, S2_FAULT_SMALL):
        with _cond_grad_fault(model.netG, fault):
            faulty[fault] = _loss_and_grads(model, crop)[1]
    cpu_model.netG.double()
    cpu_model.net_hq.double()
    cpu_model.netG.load_state_dict({n: t.cpu() for n, t in trained.items()})
    loss_x, exact = _loss_and_grads(cpu_model, cpu_crop)
    top_t = max(float(g.abs().max()) for g in exact.values())

    def dist(got, want, norm=True):
        return _worst(_dists(got, want, top_t, "gradient", norm=norm))

    model.netG.double()
    model.net_hq.double()
    model.netG.load_state_dict(trained)
    loss_k64, grads_k64 = _loss_and_grads(model, crop)
    faulty64 = {}
    for fault in (S2_FAULT, S2_FAULT_SMALL, S2_FAULT_TINY):
        with _cond_grad_fault(model.netG, fault):
            faulty64[fault] = _loss_and_grads(model, crop)[1]
    model.netG.float()
    model.net_hq.float()
    model.netG.load_state_dict(trained)
    require(all(p.dtype == torch.float32 for p in model.netG.parameters()), "netG is not float32 again")
    float64_cmp = {
        "loss_card": loss_k64, "loss_cpu": loss_x, "loss_rel": abs(loss_k64 - loss_x) / abs(loss_x),
        "grads": dist(grads_k64, exact),
        "largest_element": dist(grads_k64, exact, False)["worst"],
        "controls": {f"x {fault}": dist(g, exact)["worst"] for fault, g in faulty64.items()},
        "tol": f"the loss within {S2_F64_TOL} relative and each gradient within {S2_F64_TOL} in the 2-norm "
               f"of the CPU's float64 step; the controls x {S2_FAULT} and x {S2_FAULT_SMALL} above it "
               f"(x {S2_FAULT_TINY} reported)"}

    trained_cmp = {
        "loss_card": loss_tk, "loss_cpu": loss_tc, "loss_float64": loss_x,
        "loss_rel": abs(loss_tk - loss_tc) / abs(loss_tc),
        "grads": dist(grads_tk, grads_tc), "grads_vs_float64": dist(grads_tk, exact),
        "cpu_float32_vs_float64": dist(grads_tc, exact),
        "largest_element": {"card_vs_cpu": dist(grads_tk, grads_tc, False)["worst"],
                            "card_vs_float64": dist(grads_tk, exact, False)["worst"],
                            "cpu_float32_vs_float64": dist(grads_tc, exact, False)["worst"]},
        "card_rerun": dist(rerun, grads_tk)["worst"],
        "control": {"fault": f"coupling 0's gradient into the conditional features x {S2_FAULT}",
                    **dist(faulty[S2_FAULT], grads_tc)},
        "control_small_fault": {"fault": S2_FAULT_SMALL,
                                "worst": dist(faulty[S2_FAULT_SMALL], grads_tc)["worst"]},
        "tol": f"loss {STEP_LOSS_TOL} relative; each gradient within {S2_TRAINED_TOL} in the 2-norm of "
               f"the CPU's and of the float64 gradient (a tensor below {STEP_VANISH} of the step's "
               "largest must vanish on both); the control above it"}
    return {"loss_card": loss_k, "loss_cpu": loss_c, "loss_rel": abs(loss_k - loss_c) / abs(loss_c),
            "grads": first,
            "tol": f"loss {STEP_LOSS_TOL} relative; each gradient within {STEP_GRAD_TOL} of its largest "
                   f"(a tensor below {STEP_VANISH} of the step's largest must vanish on both)",
            "at_trained_weights": trained_cmp, "float64_at_trained_weights": float64_cmp}


def _nll_at(model, weights, batches):
    """Each batch's NLL at ``weights`` (the model's own are restored)."""
    kept = {n: t.detach().clone() for n, t in model.netG.state_dict().items()}
    model.netG.load_state_dict(weights)
    nll = [model.get_encode_nll(b["LQ"], b["GT"]) for b in batches]
    model.netG.load_state_dict(kept)
    return nll


def phase_train_stage2_path():
    """Stage-2 training at the full width of confs/train_stage2_LOL.yml, float32, 320 crop,
    batch 4, seeded weights, synthetic pairs. First the ActNorm init on one 160x160
    crop, card against CPU. Then the path, with the launch counts set to 0 before it
    and read after it: LLFlowModel.initialize_actnorm on the first batch, a warm-up
    step (its update is 0: warmup from count 0) and three timed steps of
    optimize_parameters (no kernel and no plain version launched: the attention at
    80x80 = 6,400 tokens is dense and the GT is encoded without quantizing), then
    cli.train.validate (stage 2) on 600x400 images, one vq_argmin launch an image
    through decode_latent. Then one step's loss and gradients on the crop, card
    against CPU, at the weights of the ActNorm init and at the trained weights
    (_step_card_vs_cpu); each batch's NLL at the init's weights; and save ->
    {k}_G.pth -> an inference LLFlowModel whose get_sr is bit-equal to the trained
    model's."""
    import logging

    from glare_tpu_torch.cli import train as train_cli
    from glare_tpu_torch.models import create_model

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 is on: the float32 training path would not be float32")
    t0 = time.time()
    model = create_model(train2_opt(), device="cuda")
    build_s = time.time() - t0
    require(all(p.dtype == torch.float32 and p.requires_grad for p in model.netG.parameters()),
            "stage-2 training: netG is not float32 and trainable")
    require(not any(p.requires_grad for p in model.net_hq.parameters()), "the VQGAN is not frozen")
    t0 = time.time()
    cpu_model = create_model(train2_opt(), device="cpu")
    cpu_build_s = time.time() - t0
    batches = [train_batch(90 + i, S2_BATCH, S2_GT) for i in range(4)]
    crop = {k: v[:1, :S2_CROP, :S2_CROP].contiguous() for k, v in batches[0].items()}
    t0 = time.time()
    init_cmp = _actnorm_init_card_vs_cpu(model, cpu_model, crop)
    init_cmp["seconds"] = round(time.time() - t0, 2)

    val_loader = [{"LQ": seeded_image(40 + i, 1, H2, W2), "GT": np.clip(np.exp(seeded_image(40 + i, 1, H2, W2))
                                                                       * 5.0 + 0.05, 0.0, 1.0)}
                  for i in range(S2_VAL)]
    no_launch = {k: 0 for k in counters()}
    actnorm0 = {n: t.clone() for n, t in _actnorm_tensors(model.netG).items()}
    reset_counters()
    steps, moved_after = [], []
    with counted_plain_versions() as plain_calls:
        _, init_ms = sync_ms(lambda: model.initialize_actnorm(batches[0]))
        w_init = {n: t.detach().to("cpu", copy=True) for n, t in model.netG.state_dict().items()}
        require(counters() == no_launch and plain_calls[0] == 0, "initialize_actnorm launched a kernel")
        require(all(not torch.equal(t, actnorm0[n]) for n, t in _actnorm_tensors(model.netG).items()
                    if n.endswith("logs")), "initialize_actnorm left an ActNorm's logs as they were")
        for i, batch in enumerate(batches):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            params0 = {n: p.detach().clone() for n, p in model.trainable_parameters()}
            before = counters()
            loss, ms = sync_ms(lambda: model.optimize_parameters(batch))
            moved = moved_since(before)
            require(moved == no_launch, f"stage-2 train step {i} launched kernels: {moved}")
            require(plain_calls[0] == 0, f"stage-2 train step {i}: {plain_calls[0]} plain-version calls")
            require(math.isfinite(loss), f"stage-2 train step {i}: loss {loss}")
            moved_after.append(_tensors_moved(model, params0))
            steps.append({"step": i, "ms": ms, "images_per_s": S2_BATCH / ms * 1e3, "lr": model.schedule(i),
                          "nll_loss": loss, "trainable_tensors_changed": moved_after[-1][0]})
        peak_mem = torch.cuda.max_memory_allocated()
        before = counters()
        logger = logging.getLogger("chip_smoke")
        psnr, val_ms = sync_ms(lambda: train_cli.validate(model, val_loader, model.opt, 2, len(batches),
                                                          logger))
        moved = moved_since(before)
        want_val = {**no_launch, "vq_argmin": S2_VAL}
        require(moved == want_val, f"stage-2 validation launches {moved} != {want_val}")
        require(plain_calls[0] == 0, f"stage-2 validation: {plain_calls[0]} plain-version calls")
        require(math.isfinite(psnr), f"stage-2 validation PSNR {psnr}")
    path_counts = counters()
    _require_updates(moved_after)

    t0 = time.time()
    step_cmp = _step_card_vs_cpu(model, cpu_model, crop, w_init)
    step_cmp["seconds"] = round(time.time() - t0, 2)
    del cpu_model
    # each batch's NLL at the weights of the ActNorm init, beside the steps' NLL
    for step, nll in zip(steps, _nll_at(model, w_init, batches)):
        step["nll_at_init_weights"] = nll

    # the checkpoint round trip: {k}_G.pth into an inference model, float32
    path = model.save(len(batches))
    infer = create_model(stage2_opt("float32"), device="cuda")
    infer.load_network(path)
    os.remove(path)
    lq = dev(val_loader[0]["LQ"])
    require(torch.equal(infer.get_sr(lq), model.get_sr(lq)),
            "get_sr of the model loaded from the saved _G.pth differs from the trained model's")
    del infer
    timed = steps[1:]
    ms_mean = sum(t["ms"] for t in timed) / len(timed)
    emit({"phase": "train_stage2_path",
          "config": "confs/train_stage2_LOL.yml widths and depth, float32, Adam (0.9, 0.99) lr 5e-4 warmup 10",
          "crop": [S2_GT, S2_GT], "batch": S2_BATCH, "model_build_s": round(build_s, 2),
          "cpu_model_build_s": round(cpu_build_s, 2), "actnorm_init_ms": init_ms,
          "steps": steps, "ms_per_step": ms_mean, "images_per_s": S2_BATCH / ms_mean * 1e3,
          "max_memory_allocated": peak_mem, "launches_total": path_counts,
          "expected_per_step": no_launch, "expected_validation": want_val,
          "validation": {"images": S2_VAL, "input": [H2, W2], "ms": val_ms, "psnr_gray_adjusted": psnr},
          "actnorm_init_card_vs_cpu": {"crop": [1, S2_CROP, S2_CROP], **init_cmp},
          "step_card_vs_cpu": {"crop": [1, S2_CROP, S2_CROP], "weights": "after the ActNorm init",
                               **step_cmp},
          "checkpoint_round_trip": "get_sr bit-equal"})
    first, trained = step_cmp["grads"], step_cmp["at_trained_weights"]
    require(first["worst"] <= STEP_GRAD_TOL,
            f"first step, gradient {first['worst_tensor']}: {first['worst']:.3e} of its largest")
    for key in ("grads", "grads_vs_float64"):
        require(trained[key]["worst"] <= S2_TRAINED_TOL,
                f"trained weights, {key} {trained[key]['worst_tensor']}: {trained[key]['worst']:.3e}")
    require(trained["control"]["worst"] > S2_TRAINED_TOL,
            f"the control's fault reads {trained['control']['worst']:.3e}, within the bar")
    f64 = step_cmp["float64_at_trained_weights"]
    require(f64["grads"]["worst"] <= S2_F64_TOL,
            f"float64 card against CPU, gradient {f64['grads']['worst_tensor']}: {f64['grads']['worst']:.3e}")
    require(f64["loss_rel"] <= S2_F64_TOL, f"float64 loss: card {f64['loss_card']}, CPU {f64['loss_cpu']}")
    for fault in (S2_FAULT, S2_FAULT_SMALL):
        require(f64["controls"][f"x {fault}"] > S2_F64_TOL,
                f"float64: the x {fault} fault reads {f64['controls'][f'x {fault}']:.3e}, within the bar")
    return path_counts, model


# ------------------------------------------------------- stage-1 training --

S1_GT, S1_BATCH = 256, 4     # confs/stage1_HQ_pretrain.yml: gt_size, batch_size_per_gpu
S1_CROP = 128                # the card-against-CPU iteration: one 128x128 crop of one image
S1_LOSS_TOL = 1e-4           # card against CPU, kernels against plain versions: each loss term, relative
S1_FAULT = 1.02              # the card-against-CPU bar's control: a 2% fault in the encoder's gradient
# the LQ stage's frozen_module_keywords: the codebook and the code decoder (PERF.md section 4)
S1_FROZEN = ["quantize", "after_quant_group", "decoder_group", "out_conv"]
S1_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_stage1")


def stage1_opt(lq=False, hq_path=None):
    """The values of confs/stage1_HQ_pretrain.yml that stage-1 training reads (the
    port's own dict: no yaml here), at full width, nothing cut; ``lq``: the same
    conf's LQ stage (LQ_stage, use_weight, S1_FROZEN, pretrain_network_hq)."""
    net_g = {"type": "VQWeightDehazeNet", "gt_resolution": S1_GT, "norm_type": "gn", "act_type": "silu",
             "use_quantize": True, "codebook_params": [[64, 1024, 512]]}
    if lq:
        net_g.update(LQ_stage=True, use_weight=True, frozen_module_keywords=list(S1_FROZEN))
    return {
        "name": "stage1_LQ" if lq else "stage1_HQ_pretrain", "model_type": "VQDehazeModel", "scale": 1,
        "is_train": True, "manual_seed": 0, "network_g": net_g,
        "network_d": {"type": "UNetDiscriminatorSN", "num_in_ch": 512},
        "datasets": {"train": {"gt_size": S1_GT, "batch_size_per_gpu": S1_BATCH}},
        "path": {"models": os.path.join(S1_DIR, "lq" if lq else "hq", "models"),
                 "training_states": os.path.join(S1_DIR, "lq" if lq else "hq", "training_states"),
                 "pretrain_network_hq": hq_path, "pretrain_network_g": None, "strict_load": False},
        "train": {
            "optim_g": {"type": "Adam", "lr": 1e-4}, "optim_d": {"type": "Adam", "lr": 1e-4},
            "total_iter": 350000, "ema_decay": 0.999, "net_d_iters": 1, "net_d_init_iters": 0,
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0, "reduction": "mean"},
            "perceptual_opt": {"type": "PerceptualLoss", "perceptual_weight": 1.0, "style_weight": 0,
                               "layer_weights": {"relu1_2": 1.0, "relu2_2": 1.0, "relu3_3": 1.0}},
            "codebook_opt": {"loss_weight": 1.0},
            "gan_opt": {"type": "GANLoss", "gan_type": "hinge", "real_label_val": 1.0,
                        "fake_label_val": 0.0, "loss_weight": 0.1}},
        "val": {"metrics": {"psnr": {"type": "psnr", "better": "higher"}}},
    }


def s1_batch(seed, lq=False, batch=S1_BATCH, size=S1_GT):
    """Synthetic images in [0, 1] (smooth colour fields + noise), NHWC; HQ: lq == gt
    (SingleImageDataset), LQ: a darker noisier lq beside gt (PairedImageDataset's
    keys)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    low = torch.rand((batch, 3, size // 16, size // 16), generator=g)
    gt = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    gt = (gt + 0.05 * torch.randn(gt.shape, generator=g)).clamp(0, 1).permute(0, 2, 3, 1).contiguous()
    out = {"gt": gt, "lq": gt, "gt_path": [f"{seed}_{i}.png" for i in range(batch)]}
    if lq:
        out["lq"] = (0.25 * gt + 0.02 * torch.randn(gt.shape, generator=g)).clamp(0, 1)
    out["lq_path"] = out["gt_path"]
    return {k: v.to(DEV) if torch.is_tensor(v) else v for k, v in out.items()}


def condition_codebook(model, batch, seed=9):
    """Seeded codebook at the scale of the tokens it quantizes: N(0, s^2) with s the
    std of the quantizer's input on ``batch``. The seeded init, U(-1/1024, 1/1024),
    puts each token's 1024 distances |z|^2 + |e|^2 - 2 z.e within ~1e-6 relative of
    each other: every token a near-tie, which any two float32 runs flip. -> s."""
    net = model.net_g
    with torch.no_grad():
        feat = net.encode_and_decode(model._nchw(batch["gt"]), quantize_only=True)[3]
        s = float(feat.float().std())
        emb = net.quantize_group[0].embedding.weight
        g = torch.Generator(device="cpu").manual_seed(seed)
        emb.copy_((torch.randn(emb.shape, generator=g) * s).to(emb))
    return s


def _sn_counts(net_d):
    """Counts each SNConv's forwards with update_stats set (the only ones that store
    u) -> (counts dict, hook handles)."""
    from glare_tpu_torch.sr.archs.discriminator_arch import SNConv

    counts, handles = {}, []
    for name, m in net_d.named_modules():
        if isinstance(m, SNConv):
            def hook(mod, args, kwargs, name=name):
                if (args[1] if len(args) > 1 else kwargs.get("update_stats", True)):
                    counts[name] = counts.get(name, 0) + 1
            handles.append(m.register_forward_pre_hook(hook, with_kwargs=True))
    return counts, handles


def _u_state(net_d):
    return {n: t.clone() for n, t in net_d.state_dict().items() if n.endswith(".u")}


def _s1_iterations(model, batches, per_step, bwd_per_step, first_iter=1):
    """A warm-up iteration and the timed ones of optimize_parameters (batches[1:]),
    each with the launch counts exactly ``per_step`` / ``bwd_per_step`` and no
    plain-version call, and after each: the six losses finite, every trainable
    tensor of both nets moved but one whose gradient is exactly 0 (listed), each
    SNConv's u stored exactly once (by the d step's
    real forward) and changed (a 1-vector stays at +-1 once set), the EMA equal to
    ``ema * 0.999 + params * 0.001``; frozen generator tensors bit-equal.
    -> (iterations, counts over them, peak memory)."""
    frozen0 = {n: p.detach().clone() for n, p in model.net_g.named_parameters() if not p.requires_grad}
    counts, handles = _sn_counts(model.net_d)
    iters = []
    reset_counters()
    try:
        with counted_plain_versions() as plain_calls:
            for i, batch in enumerate(batches):
                if i == 1:
                    torch.cuda.reset_peak_memory_stats()
                g0 = {n: p.detach().clone() for n, p in model.net_g.named_parameters() if p.requires_grad}
                d0 = {n: p.detach().clone() for n, p in model.net_d.named_parameters()}
                u0, ema0 = _u_state(model.net_d), model.ema_flat.clone()
                counts.clear()
                before, by_entry = counters(), dict(dcn_ops.bwd_launches_by_entry)
                logs, ms = sync_ms(lambda: model.optimize_parameters(first_iter + i, batch))
                moved, moved_e = moved_since(before), bwd_moved_since(by_entry)
                logs = dict(logs)
                require(moved == per_step, f"stage-1 iteration {i}: launches {moved} != {per_step}")
                require(moved_e == bwd_per_step, f"stage-1 iteration {i}: DCN backward {moved_e}")
                require(plain_calls[0] == 0, f"stage-1 iteration {i}: {plain_calls[0]} plain-version calls")
                for k in ("l_codebook", "l_pix", "l_percep", "l_g_gan", "l_d_real", "l_d_fake"):
                    require(k in logs and math.isfinite(logs[k]), f"stage-1 iteration {i}: {k} {logs.get(k)}")
                still, dead = [], []
                for net, p0 in ((model.net_g, g0), (model.net_d, d0)):
                    for n, p in net.named_parameters():
                        if n not in p0:
                            continue
                        if p.grad is None or not bool(p.grad.any()):
                            dead.append(n)   # e.g. conv9.bias: hinge gives -1 + 1 = 0 while |D| < 1
                        elif torch.equal(p, p0[n]):
                            still.append(n)
                require(not still, f"stage-1 iteration {i}: tensors with a gradient that did not move: "
                                   f"{still[:5]}")
                u1 = _u_state(model.net_d)
                require(set(counts) == {n[:-2] for n in u1} and set(counts.values()) == {1},
                        f"stage-1 iteration {i}: u stored {counts}")
                same_u = [n for n in u1 if torch.equal(u1[n], u0[n])
                          and not (u1[n].numel() == 1 and bool((u0[n].abs() == 1).all()))]
                require(not same_u, f"stage-1 iteration {i}: u unchanged {same_u}")
                ema_want = ema0 * model.ema_decay + model._flat_params() * (1 - model.ema_decay)
                ema_err = float((model.ema_flat - ema_want).abs().max() / ema_want.abs().max())
                require(ema_err <= 1e-6, f"stage-1 iteration {i}: EMA {ema_err} from its formula")
                iters.append({"iteration": first_iter + i, "ms": ms, "images_per_s": len(batch["gt"]) / ms * 1e3,
                              "losses": logs, "launches": moved, "dcn_bwd_kernels": moved_e,
                              "ema_rel_err": ema_err, "tensors_without_gradient": dead})
    finally:
        for h in handles:
            h.remove()
    for n, p in model.net_g.named_parameters():
        if n in frozen0:
            require(torch.equal(p, frozen0[n]), f"frozen {n} changed")
    timed = iters[1:]
    ms_mean = sum(t["ms"] for t in timed) / len(timed)
    return ({"iterations": iters, "ms_per_iteration": ms_mean,
             "images_per_s": len(batches[0]["gt"]) / ms_mean * 1e3, "frozen_tensors": len(frozen0)},
            counters(), torch.cuda.max_memory_allocated())


def _s1_grads(model, batch):
    """One iteration's losses and gradients without the updates: the g step's
    generator gradients, then the d step's discriminator gradients (real = the
    GT's quantized latent by the same generator, or net_hq; its u updated as in
    the iteration), the real and the fake term apart ("l_d_real:<tensor>",
    "l_d_fake:<tensor>"; the step's gradient is their sum). In the HQ stage real
    and fake are the same latent, so the sum is a remainder well below either
    term (_d_sum_report prints both), and one activation within rounding of a
    kink moves it by far more than its terms' rounding in any float32 run, the
    CPU's as the card's; each term alone is well conditioned.
    -> (losses, generator grads, discriminator grads, u after)."""
    lq, gt = model._nchw(batch["lq"]), model._nchw(batch["gt"])
    model.optimizer_g.zero_grad(set_to_none=True)
    model.optimizer_d.zero_grad(set_to_none=True)
    total, losses, z_q, z_hq = model.g_losses(lq, gt, True)
    total.backward()
    z_gt = z_hq if model.LQ_stage else model.quantized_latent(model.net_g, gt)
    _, d_losses = model.d_losses(z_gt, z_q.detach())
    out = {k: float(v.detach()) for k, v in {**losses, **d_losses, "l_g_total": total}.items()}
    g = {n: p.grad.detach().clone() for n, p in model.net_g.named_parameters() if p.grad is not None}
    names, params = zip(*model.net_d.named_parameters())
    d = {}
    for term, retain in (("l_d_real", True), ("l_d_fake", False)):
        grads = torch.autograd.grad(d_losses[term], params, retain_graph=retain, allow_unused=True)
        d.update({f"{term}:{n}": torch.zeros_like(p) if t is None else t.detach().clone()
                  for n, p, t in zip(names, params, grads)})
    model.optimizer_g.zero_grad(set_to_none=True)
    model.optimizer_d.zero_grad(set_to_none=True)
    return out, g, d, _u_state(model.net_d)


def _d_sum_report(d_got, d_want):
    """The d step's gradient as the step applies it (real + fake term), ``d_got``
    against ``d_want`` over all of net_d: the 2-norm distance as a share of the
    reference's, and the reference's real term over its sum (the cancellation).
    Printed, not held: _s1_grads says why."""
    names = [n.split(":", 1)[1] for n in d_want if n.startswith("l_d_real:")]

    def cat(d, real_only=False):
        return torch.cat([(d["l_d_real:" + n] + (0 if real_only else d["l_d_fake:" + n]))
                          .detach().double().cpu().reshape(-1) for n in names])

    s_got, s_want = cat(d_got), cat(d_want)
    return {"rel_2norm": float((s_got - s_want).norm() / s_want.norm()),
            "real_term_over_sum": float(cat(d_want, real_only=True).norm() / s_want.norm())}


def _s1_compare(got, want, what, exact=None):
    """Losses within S1_LOSS_TOL relative each; u within 1e-5; every gradient (the
    discriminator's real and fake terms apart, _s1_grads) within STEP_GRAD_TOL in
    the 2-norm (|got - want| over |want|, which one activation on the other side
    of a kink does not dominate; a tensor below STEP_VANISH of its net's largest
    vanishing on both) or, only where float32 rounding dominates, by the
    stage-ratio rule against float64: ``exact`` is the same iteration in float64
    (the value both float32 runs approximate); rounding dominates where ``want``'s
    own 2-norm distance from it is at least a third of ``got``'s from ``want``;
    then ``got``'s distance from ``exact`` may be at most STAGE_RATIO x ``want``'s
    + STAGE_ABS_SLACK. The largest-element distances are printed too; the
    distances are printed before they are held to the bars. -> (distances,
    failures)."""
    (l_k, g_k, d_k, u_k), (l_w, g_w, d_w, u_w) = got, want
    out = {"loss_rel": {k: abs(l_k[k] - l_w[k]) / max(abs(l_w[k]), 1e-30) for k in l_w},
           "u_max_abs_err": max(float((u_k[n].cpu() - u_w[n].cpu()).abs().max()) for n in u_w),
           "net_d_sum_not_held": _d_sum_report(d_k, d_w)}
    if exact is not None:
        out["net_d_sum_not_held"]["reference_vs_float64"] = _d_sum_report(d_w, exact[2])["rel_2norm"]
    failures = [f"loss {k}: {l_k[k]} against {l_w[k]}" for k, e in out["loss_rel"].items() if e > S1_LOSS_TOL]
    if out["u_max_abs_err"] > 1e-5:
        failures.append(f"spectral u {out['u_max_abs_err']}")
    for i, (net, gk, gw) in enumerate((("net_g", g_k, g_w), ("net_d", d_k, d_w))):
        require(set(gk) == set(gw), f"{what}: {net} gradients of different tensors")
        top = max(float(t.abs().max()) for t in gw.values())
        out[net] = _worst(_dists(gk, gw, top, f"{what} {net} gradient"))
        d2 = _dists(gk, gw, top, f"{what} {net} gradient", norm=True)
        out[net + "_2norm"] = _worst(d2)
        beyond = {n: e for n, e in d2.items() if e is not None and e > STEP_GRAD_TOL}
        rule = out[net + "_beyond_bar"] = {}
        for n, e in sorted(beyond.items(), key=lambda kv: -kv[1]):
            if exact is None:
                failures.append(f"{net} gradient {n}: {e:.3e} in the 2-norm")
                continue
            ex = {n: exact[1 + i][n]}
            r = rule[n] = {"2norm": e, "2norm_vs_float64": _dists({n: gk[n]}, ex, top, what, norm=True)[n],
                           "reference_2norm_vs_float64": _dists({n: gw[n]}, ex, top, what, norm=True)[n]}
            if not (r["reference_2norm_vs_float64"] >= e / 3
                    and r["2norm_vs_float64"] <= STAGE_RATIO * r["reference_2norm_vs_float64"] + STAGE_ABS_SLACK):
                failures.append(f"{net} gradient {n}: {r}")
    return out, failures


def _s1_hold(got, want, what, exact=None):
    """_s1_compare, printed, then held: any failure fails the run."""
    out, failures = _s1_compare(got, want, what, exact)
    emit({"compare": what, **out})
    require(not failures, f"{what}: {failures[:4]}")
    return out


@contextlib.contextmanager
def _encoder_grad_fault(net_g, scale):
    """The control of the card-against-CPU bar: inside the block the gradient that
    leaves the encoder's output is scaled by ``scale`` (its values unchanged): a
    fault upstream of every encoder gradient."""
    handle = net_g.multiscale_encoder.register_forward_hook(
        lambda mod, args, out: out + (scale - 1.0) * (out - out.detach()))
    try:
        yield
    finally:
        handle.remove()


def _index_flips(card_model, cpu_model, gt_cpu):
    """The crop's codebook indices on the card and on the CPU: a flip only where the
    two codes' float64 distances (from the CPU's tokens) agree to 1e-6 relative.
    -> (flips, worst relative gap of a flip)."""
    with torch.no_grad():
        out_c = cpu_model.net_g.encode_and_decode(cpu_model._nchw(gt_cpu), quantize_only=True)
        out_k = card_model.net_g.encode_and_decode(card_model._nchw(gt_cpu.to(DEV)), quantize_only=True)
    feat, idx_c, idx_k = out_c[3], out_c[5][0].reshape(-1), out_k[5][0].reshape(-1).cpu()
    z = feat.permute(0, 2, 3, 1).reshape(-1, feat.shape[1]).double()
    emb = cpu_model.net_g.quantize_group[0].embedding.weight.detach().double()
    d = (z ** 2).sum(1, keepdim=True) + (emb ** 2).sum(1)[None] - 2 * z @ emb.t()
    flips = (idx_c != idx_k).nonzero().flatten().tolist()
    gaps = [float((d[t, idx_c[t]] - d[t, idx_k[t]]).abs() / d[t, idx_c[t]].abs()) for t in flips]
    emit({"index_flips": len(flips), "tokens": len(idx_c), "flip_gaps": gaps[:8]})
    require(all(gp <= 1e-6 for gp in gaps), f"codebook index flips beyond the near-tie rule: {gaps[:5]}")
    return len(flips), max(gaps, default=0.0)


@contextlib.contextmanager
def _recorded_codes(net):
    """Inside the block every quantizer call of ``net`` appends (quantizer, its
    indices flat on the CPU) to the list it yields, in call order."""
    codes = []
    handles = [q.register_forward_hook(lambda mod, args, out, i=i: codes.append((i, out[2].reshape(-1).cpu())))
               for i, q in enumerate(net.quantize_group)]
    try:
        yield codes
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _forced_codes(net, codes):
    """Inside the block quantizer call k of ``net`` takes the k-th indices of
    ``codes`` (the card's iteration, by _recorded_codes) where its own argmin
    differs, but only where the two codes' float64 distances (from this call's
    tokens) agree to 1e-6 relative, the near-tie rule of _index_flips: a flip
    beyond it fails. A near-tie flip is a discrete choice that both float32 runs
    may make either way and that moves a token by a whole code, so the CPU's
    iteration follows the card's choices and the gradients then differ by
    rounding alone. Yields [(flips taken, worst relative gap)] per call."""
    import functools

    taken = []

    def forced(i, own_distances, q, z_flat, weight_alpha=None):
        d = own_distances(z_flat, weight_alpha)
        require(len(taken) < len(codes), "more quantizer calls than the card's iteration made")
        qi, want = codes[len(taken)]
        require(qi == i and want.numel() == d.shape[0], f"quantizer call {len(taken)} is not the card's")
        want = want.to(d.device)
        own = d.argmin(dim=1)
        rows = (own != want).nonzero().flatten()
        gaps = []
        if rows.numel():
            z, emb = z_flat.detach()[rows].double(), q.embedding.weight.detach().double()
            d64 = (z ** 2).sum(1, keepdim=True) + (emb ** 2).sum(1)[None] - 2 * z @ emb.t()
            r = torch.arange(rows.numel(), device=d64.device)
            a, b = d64[r, own[rows]], d64[r, want[rows]]
            gaps = ((a - b).abs() / a.abs()).tolist()
            require(all(gp <= 1e-6 for gp in gaps), f"the card's codes flip beyond the near-tie rule: {gaps[:5]}")
            d = d.clone()
            d[rows, want[rows]] = float("-inf")
        taken.append((rows.numel(), max(gaps, default=0.0)))
        return d

    qs = list(net.quantize_group)
    require(not any(q.use_weight and q.LQ_stage for q in qs), "weighted distances: the near-tie rule is unweighted")
    for i, q in enumerate(qs):
        q.distances = functools.partial(forced, i, q.distances, q)
    try:
        yield taken
        require(len(taken) == len(codes), f"{len(taken)} quantizer calls against the card's {len(codes)}")
    finally:
        for q in qs:
            del q.distances


@contextlib.contextmanager
def _recorded_hinge(model):
    """Inside the block every discriminator-side call of ``model``'s hinge GAN
    loss appends (target_is_real, its prediction detached on the CPU) to the list
    it yields, in call order."""
    own, preds = model.cri_gan, []
    require(own.gan_type == "hinge", f"the GAN loss is {own.gan_type}, not hinge")

    def recorded(pred, target_is_real, is_disc=False):
        if is_disc:
            preds.append((target_is_real, pred.detach().cpu()))
        return own(pred, target_is_real, is_disc)

    model.cri_gan = recorded
    try:
        yield preds
    finally:
        model.cri_gan = own


@contextlib.contextmanager
def _forced_hinge(model, preds):
    """Inside the block the discriminator-side hinge call k of ``model``
    (relu(1 -+ pred).mean()) takes the active pixels of the k-th prediction of
    ``preds`` (the card's iteration, by _recorded_hinge) where that prediction
    lies on the other side of the kink, but only where the two predictions agree
    to S1_LOSS_TOL of the map's largest: a flip beyond it fails. A pixel within
    rounding of the kink adds or drops its whole gradient, one pixel of the
    map's, so the CPU's iteration follows the card's side and the gradients then
    differ by rounding alone. Yields [(flips taken, worst distance of a flip as a
    share of the map's largest)] per call."""
    from glare_tpu_torch.nn.layers import at_least_float32

    own, taken = model.cri_gan, []

    def forced(pred, target_is_real, is_disc=False):
        if not is_disc:
            return own(pred, target_is_real, is_disc)
        require(len(taken) < len(preds), "more hinge calls than the card's iteration made")
        real_k, p_k = preds[len(taken)]
        require(real_k == target_is_real and p_k.shape == pred.shape, f"hinge call {len(taken)} is not the card's")
        sign = -1.0 if target_is_real else 1.0
        x = 1 + sign * at_least_float32(pred)
        p_k = p_k.to(x)
        active = (1 + sign * p_k) > 0
        flips = active != (x > 0)
        dist = ((p_k - pred.detach()).abs() / pred.detach().abs().max())[flips]
        worst = float(dist.max()) if dist.numel() else 0.0
        require(worst <= S1_LOSS_TOL, f"a hinge pixel flips {worst:.3e} of the map's largest from the card's")
        taken.append((int(flips.sum()), worst))
        return (x * active.to(x.dtype)).mean()

    model.cri_gan = forced
    try:
        yield taken
        require(len(taken) == len(preds), f"{len(taken)} hinge calls against the card's {len(preds)}")
    finally:
        model.cri_gan = own


class _PoolShim:
    """torch.nn.functional with ``max_pool2d`` replaced: what the perceptual VGG
    (glare_tpu_torch/sr/archs/vgg_arch.py) calls as ``F`` inside _recorded_pools
    and _forced_pools."""

    def __init__(self, max_pool2d):
        self.max_pool2d = max_pool2d

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)


@contextlib.contextmanager
def _pool_shim(max_pool2d):
    from glare_tpu_torch.sr.archs import vgg_arch

    own = vgg_arch.F
    vgg_arch.F = _PoolShim(max_pool2d)
    try:
        yield
    finally:
        vgg_arch.F = own


@contextlib.contextmanager
def _recorded_pools():
    """Inside the block every max pool of the perceptual VGG appends its argmax
    (flat indices on the CPU) to the list it yields, in call order."""
    picks = []

    def recorded(x, *args, **kwargs):
        out, idx = torch.nn.functional.max_pool2d(x, *args, return_indices=True, **kwargs)
        picks.append(idx.cpu())
        return out

    with _pool_shim(recorded):
        yield picks


@contextlib.contextmanager
def _forced_pools(picks):
    """Inside the block the perceptual VGG's max pool call k takes the k-th
    argmax of ``picks`` (the card's iteration, by _recorded_pools) where its own
    differs, but only where this run's value there is within S1_LOSS_TOL of the
    input's largest of its own window maximum: a flip beyond it fails. Where the
    generator's output is flat (the synthetic image clamped at 0 or 1), windows of
    its VGG features tie exactly, each implementation sends the gradient to another
    element of the tie (float64 too: glare_tpu_torch/tools/stage1_ties.py), and
    the perceptual gradient differs by far more than rounding; so the CPU's
    iteration follows the card's choice. Yields [(flips taken, worst gap as a
    share of the input's largest)] per call."""
    taken = []

    def forced(x, *args, **kwargs):
        out, idx = torch.nn.functional.max_pool2d(x, *args, return_indices=True, **kwargs)
        require(len(taken) < len(picks), "more max pools than the card's iteration made")
        want = picks[len(taken)].to(x.device)
        require(want.shape == idx.shape, f"max pool {len(taken)} is not the card's")
        flat = x.flatten(2)
        got = flat.gather(2, want.flatten(2)).view_as(out)
        flips = want != idx
        gap = ((out.detach() - got.detach()).abs() / x.detach().abs().max())[flips]
        worst = float(gap.max()) if gap.numel() else 0.0
        require(worst <= S1_LOSS_TOL, f"a max pool picks {worst:.3e} of its input's largest below its maximum")
        taken.append((int(flips.sum()), worst))
        return got

    with _pool_shim(forced):
        yield taken
        require(len(taken) == len(picks), f"{len(taken)} max pools against the card's {len(picks)}")


def phase_train_stage1_path():
    """Stage-1 HQ pretraining at the full width of confs/stage1_HQ_pretrain.yml,
    float32, 256 crop, batch 4, seeded weights, synthetic images: the codebook
    conditioned (condition_codebook); the g step's forward checked to leave u alone;
    then the path, with the launch counts set to 0 before it and read after it: a
    warm-up iteration and three timed iterations of VQDehazeModel.optimize_parameters
    (_s1_iterations: no kernel and no plain version launched: the quantizer is a
    dense float32 argmin, as in JAX). Then one iteration's losses and gradients of
    both nets on a 128x128 crop, card against the same model on the CPU (whose
    iterations take the card's codes, hinge sides and max-pool picks where they
    flip at a near-tie), with the
    codebook indices; and save -> net_g_{k}.pth -> a fresh model whose test() is
    bit-equal. -> (counts, model, the saved net_g file)."""
    import shutil

    from glare_tpu_torch.sr.models import build_model

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
            "TF32 is on: the float32 training path would not be float32")
    shutil.rmtree(S1_DIR, ignore_errors=True)
    t0 = time.time()
    model = build_model(stage1_opt(), device="cuda")
    build_s = time.time() - t0
    batches = [s1_batch(100 + i) for i in range(5)]
    code_std = condition_codebook(model, batches[0])
    model.init_ema(model.net_g)
    u0 = _u_state(model.net_d)
    with torch.no_grad():
        model.g_losses(model._nchw(batches[0]["lq"]), model._nchw(batches[0]["gt"]), True)
    require(all(torch.equal(t, u0[n]) for n, t in _u_state(model.net_d).items()), "the g step moved u")
    per_step = {k: 0 for k in counters()}
    bwd_per_step = {k: 0 for k in dcn_ops.bwd_launches_by_entry}
    summary, path_counts, peak_mem = _s1_iterations(model, batches[:4], per_step, bwd_per_step)

    # one iteration on a crop, card against CPU, at the trained weights
    cpu = build_model(stage1_opt(), device="cpu")
    for net in ("net_g", "net_d"):
        getattr(cpu, net).load_state_dict({k: v.cpu() for k, v in getattr(model, net).state_dict().items()})
    cpu.cri_perceptual.load_state_dict({k: v.cpu() for k, v in model.cri_perceptual.state_dict().items()})
    crop = {k: batches[4][k][:1, :S1_CROP, :S1_CROP] for k in ("lq", "gt")}
    d_state = {k: v.clone() for k, v in model.net_d.state_dict().items()}
    flips = _index_flips(model, cpu, crop["gt"].cpu())
    with _recorded_codes(model.net_g) as codes, _recorded_hinge(model) as preds, _recorded_pools() as picks:
        got = _s1_grads(model, crop)
    model.net_d.load_state_dict(d_state)
    taken, refs = {}, {}
    for key, dtype in (("float32", torch.float32), ("float64", torch.float64)):   # the CPU's, then in float64
        for m in (cpu.net_g, cpu.net_d, cpu.cri_perceptual):
            m.to(dtype)
        cpu.net_d.load_state_dict({k: v.cpu() for k, v in d_state.items()})
        with _forced_codes(cpu.net_g, codes) as taken["codes_" + key], \
                _forced_hinge(cpu, preds) as taken["hinge_" + key], _forced_pools(picks) as taken["pools_" + key]:
            refs[key] = _s1_grads(cpu, {k: v.cpu().to(dtype) for k, v in crop.items()})
    want, exact = refs["float32"], refs["float64"]
    emit({"cards_choices_taken_by_cpu": taken, "tokens_per_call": [len(c) for _, c in codes],
          "hinge_pixels_per_call": [p.numel() for _, p in preds]})
    with _encoder_grad_fault(model.net_g, S1_FAULT):
        faulty = _s1_grads(model, crop)
    model.net_d.load_state_dict(d_state)
    control = _s1_compare(faulty, want, "control", exact)[1]
    cmp = {**_s1_hold(got, want, "card against CPU", exact), "index_flips": flips[0],
           "index_flip_worst_gap": flips[1], "cards_choices_taken": taken,
           "loss_rel_vs_float64": {k: abs(got[0][k] - v) / max(abs(v), 1e-30) for k, v in exact[0].items()},
           "cpu_float32_vs_float64": {net: _worst(_dists(want[1 + i], exact[1 + i], max(
               float(t.abs().max()) for t in exact[1 + i].values()), "float64 witness", norm=True))
               for i, net in enumerate(("net_g", "net_d"))},
           "control": {"fault": f"the gradient out of the encoder x {S1_FAULT}", "failures": len(control),
                       "first": control[:2]},
           "tol": f"each loss term {S1_LOSS_TOL} relative; each gradient (net_d's real and fake terms apart) "
                  f"within {STEP_GRAD_TOL} in the 2-norm (below {STEP_VANISH} of its net's largest: vanishing "
                  "on both), or where float32 rounding dominates (the CPU's own float32 gradient at least a third "
                  "as far from a float64 iteration's) by the stage-ratio rule: its 2-norm distance from the "
                  f"float64 one at most {STAGE_RATIO} x the CPU's + {STAGE_ABS_SLACK}; u 1e-5; an index may flip "
                  "only where the "
                  "float64 distances agree to 1e-6 relative, and there the CPU's iterations take "
                  "the card's code (_forced_codes); a hinge pixel may change sides only where the two predictions "
                  f"agree to {S1_LOSS_TOL} of the map's largest, and there the CPU's iterations take the card's side "
                  "(_forced_hinge); a max pool of the perceptual VGG may pick another element only where it ties "
                  f"to {S1_LOSS_TOL} of its input's largest, and there the CPU's iterations take the card's "
                  "(_forced_pools); the control must fail that bar"}
    require(control, "the control's fault passes the card-against-CPU bar")

    # save -> a fresh model -> test() bit-equal
    n_iter = summary["iterations"][-1]["iteration"]
    model.save(0, n_iter)
    path = os.path.join(stage1_opt()["path"]["models"], f"net_g_{n_iter}.pth")
    fresh = build_model({**stage1_opt(), "is_train": False}, device="cuda")
    fresh.load_network(fresh.net_g, path, strict=True)
    probe = s1_batch(200, batch=1, size=200)["gt"][:, :, :180]
    require(torch.equal(fresh.test(probe), model.test(probe)), "test() after the round trip differs")
    del fresh, cpu
    emit({"phase": "train_stage1_path",
          "config": "confs/stage1_HQ_pretrain.yml at full width (codebook [64, 1024, 512], gn / silu, "
                    "UNet-SN num_in_ch 512; L1 + VGG19 relu1_2/2_2/3_3 + codebook + hinge GAN 0.1; Adam 1e-4; "
                    "EMA 0.999), float32",
          "crop": [S1_GT, S1_GT], "batch": S1_BATCH, "model_build_s": round(build_s, 2),
          "codebook": {"init": "N(0, s^2)", "s": code_std},
          **summary, "launches_total": path_counts, "expected_per_step": per_step,
          "max_memory_allocated": peak_mem, "card_vs_cpu": {"crop": [1, S1_CROP, S1_CROP], **cmp},
          "checkpoint_round_trip": f"{os.path.basename(path)}: test() bit-equal at 200x180"})
    return path_counts, model, path


def _s1_lq_model(hq_path=None):
    """The LQ-stage model of train_stage1_lq_path: net_hq and the starting generator
    from ``hq_path`` (without it, a seeded HQ model's file), the usage weight
    seeded, the warp heads tempered and set off the integer grid on one synthetic
    batch, the EMA started. -> (model, the warp DCN packs, the heads' input-
    dependent spread, build seconds, the HQ file)."""
    from glare_tpu_torch.sr.models import build_model

    if hq_path is None:
        hq = build_model(stage1_opt(), device="cuda")
        condition_codebook(hq, s1_batch(100))
        hq_path = hq.save_network([hq.net_g.state_dict()], "g", "seeded")
        del hq
    t0 = time.time()
    model = build_model(stage1_opt(lq=True, hq_path=hq_path), device="cuda")
    build_s = time.time() - t0
    net = model.net_g
    require(net.LQ_stage and torch.equal(net.quantize_group[0].embedding.weight,
                                         model.net_hq.quantize_group[0].embedding.weight),
            "the LQ generator did not start from the HQ file")
    g = torch.Generator(device="cpu").manual_seed(12)
    with torch.no_grad():
        w = net.quantize_group[0].weight
        w.copy_((0.05 * torch.randn(w.shape, generator=g)).to(w))
    packs = [wb.dcn for wb in net.multiscale_decoder.warp]
    with torch.no_grad():  # the zero-initialized heads get small seeded weights (temper_offset_heads' rule)
        for pack in packs:
            co = pack.conv_offset
            co.weight.copy_((0.02 * torch.randn(co.weight.shape, generator=g)).to(co.weight))
            co.bias.copy_((0.5 * torch.randn(co.bias.shape, generator=g)).to(co.bias))
    spread = _condition_heads(packs, lambda: net.encode_and_decode(model._nchw(s1_batch(300, lq=True)["lq"])))
    model.init_ema(net)
    for pack in packs:
        require(pack.impl == "xla", "the LQ warp is not the exact DCN")
    return model, packs, spread, build_s, hq_path


def phase_train_stage1_lq_path(hq_path=None):
    """The LQ stage of the same conf (LQ_stage, use_weight, frozen_module_keywords
    S1_FROZEN), net_hq and the starting generator from the HQ phase's net_g file
    (pretrain_network_hq, strict=False; without the HQ phase, a seeded HQ model's),
    the codebook usage weight seeded (N(0, 0.05^2)) so the weighted distance moves
    the argmin, the zero-initialized warp heads given small seeded weights and set
    off the integer grid (condition_offset_heads' rule), synthetic pairs. The path: a warm-up and three timed iterations, each
    launching exactly 2 f32 DCN forwards and 2 backward passes with grad_x and no
    plain version, frozen tensors bit-equal. Then one iteration's losses and
    gradients through the kernels against the same iteration through the plain
    versions (the DCN: autograd of modulated_deform_conv_ref)."""
    model, packs, spread, build_s, hq_path = _s1_lq_model(hq_path)
    batches = [s1_batch(300 + i, lq=True) for i in range(5)]
    per_step = {**{k: 0 for k in counters()}, "dcn_fwd_f32": 2, "dcn_bwd": 2}
    bwd_per_step = {**{k: 0 for k in dcn_ops.bwd_launches_by_entry}, "pass_x": 2}
    summary, path_counts, peak_mem = _s1_iterations(model, batches[:4], per_step, bwd_per_step)
    shapes = [p.last_shapes for p in packs]

    # one iteration: the kernels against the plain versions, same weights and batch
    d_state = {k: v.clone() for k, v in model.net_d.state_dict().items()}
    for pack in packs:
        pack.audit_offsets = True
    got = _s1_grads(model, batches[4])
    gap_k = min(float((p.last_offsets - p.last_offsets.round()).abs().min()) for p in packs)
    model.net_d.load_state_dict(d_state)
    with plain_versions():
        before = counters()
        want = _s1_grads(model, batches[4])
        torch.cuda.synchronize()
        require(counters() == before, "the plain-version iteration launched a kernel")
    gap_p = min(float((p.last_offsets - p.last_offsets.round()).abs().min()) for p in packs)
    for pack in packs:
        pack.audit_offsets, pack.last_offsets = False, None
    require(min(gap_k, gap_p) > 0.02, f"offsets within {min(gap_k, gap_p)} px of the integer grid")
    cmp = {**_s1_hold(got, want, "kernels against plain versions"), "offset_grid_gap": [gap_k, gap_p],
           "tol": f"each loss term {S1_LOSS_TOL} relative; each gradient (net_d's real and fake terms apart) "
                  f"within {STEP_GRAD_TOL} in the 2-norm (below {STEP_VANISH} of its net's largest: vanishing "
                  "on both); u 1e-5"}
    emit({"phase": "train_stage1_lq_path",
          "config": "confs/stage1_HQ_pretrain.yml with LQ_stage, use_weight (usage weight N(0, 0.05^2)), "
                    f"frozen_module_keywords {S1_FROZEN}, net_hq and net_g from the HQ phase's file; the "
                    "warp DCNs exact (impl xla) under autograd: f32 forward + dcn_bwd_pass with grad_x",
          "crop": [S1_GT, S1_GT], "batch": S1_BATCH, "model_build_s": round(build_s, 2),
          "hq_file": os.path.basename(hq_path), "dcn_shapes": shapes,
          "offset_heads": {"bias": "half-integers in [-2.5, 2.5]", "input_dependent_px": spread, "dcn_bias": "+1"},
          **summary, "launches_total": path_counts, "expected_per_step": per_step,
          "expected_bwd_per_step": bwd_per_step, "max_memory_allocated": peak_mem,
          "kernel_vs_plain_iteration": cmp})
    return path_counts, model


# ------------------------------------------------- the rest of sr/ and legacy --

SWINIR_M = {"type": "SwinIR", "upscale": 4, "in_chans": 3, "img_size": 64, "window_size": 8, "img_range": 1.0,
            "depths": [6] * 6, "embed_dim": 180, "num_heads": [6] * 6, "mlp_ratio": 2,
            "upsampler": "pixelshuffle", "resi_connection": "1conv"}
HELD_REL_TOL = 1e-4        # a network's output on the card against the CPU: of the output's largest
DEGRADE_ABS_TOL = 1e-5     # DiffJPEG / USMSharp / filter2D on the card against the CPU, absolute on [0, 1]
TIE_BAND = 1e-4            # a rounding (DCT) or threshold (USM) input this close may decide apart
EMA_TOL = 1e-5             # the EMA codebook buffers, card against CPU: of each buffer's largest


def _no_kernel_moved(before, what):
    """No kernel launched since ``before``. -> the counts moved (all 0)."""
    moved = moved_since(before)
    require(not any(moved.values()), f"{what} launched a kernel: {moved}")
    return moved


def _timed(fn, reps=3):
    """A warm-up call, then ``reps`` calls on the host clock around synchronize
    -> (the last output, [ms])."""
    out, _ = sync_ms(fn)
    ms = []
    for _ in range(reps):
        out, t = sync_ms(fn)
        ms.append(t)
    return out, ms


def _held(card, cpu, what):
    """Max |card - cpu| over the CPU output's largest, required <= HELD_REL_TOL."""
    card = card.detach().double().cpu()
    cpu = cpu.detach().double()
    err = float((card - cpu).abs().max() / cpu.abs().max().clamp_min(1e-30))
    require(bool(torch.isfinite(card).all()) and err <= HELD_REL_TOL, f"{what}: card against CPU {err}")
    return err


def _smooth_images(seed, batch, h, w):
    """Seeded smooth colour fields plus noise in [0, 1], NCHW float32 (CPU)."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand((batch, 3, max(h // 16, 2), max(w // 16, 2)), generator=g)
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return (img + 0.03 * torch.randn(img.shape, generator=g)).clamp(0, 1)


def phase_swinir_path():
    """SwinIR-M, the SwinIR authors' classical-SR x4 configuration (main_test_swinir.py,
    classical_sr: window 8, depths and heads [6] * 6, embed_dim 180, mlp_ratio 2,
    pixelshuffle, 1conv), seeded weights, float32: one 3x256x256 image to
    1024x1024, batch 1, a warm-up and three timed calls (no kernel: window
    attention is plain torch, as JAX computes it outside Pallas). Then the same
    network on a 1x3x64x64 crop, card against CPU (TF32 off)."""
    import copy

    from glare_tpu_torch.nn.layers import seed_init_
    from glare_tpu_torch.sr.archs import build_network

    require(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    cpu_net = seed_init_(build_network(dict(SWINIR_M)), torch.Generator().manual_seed(21)).eval()
    net = copy.deepcopy(cpu_net).to(DEV)
    x = _smooth_images(22, 1, 256, 256).to(DEV)
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    with torch.no_grad():
        out, ms = _timed(lambda: net(x))
    moved = _no_kernel_moved(before, "swinir_path")
    require(tuple(out.shape) == (1, 3, 1024, 1024) and bool(torch.isfinite(out).all()), f"SwinIR {out.shape}")
    peak = torch.cuda.max_memory_allocated()
    crop = x[:, :, :64, :64]
    with torch.no_grad():
        err = _held(net(crop), cpu_net(crop.cpu()), "SwinIR 64x64")
    emit({"phase": "swinir_path", "config": {k: v for k, v in SWINIR_M.items() if k != "type"},
          "parameters": sum(p.numel() for p in net.parameters()), "input": [1, 3, 256, 256],
          "output": list(out.shape), "ms_per_image": statistics.median(ms), "ms_calls": ms,
          "max_memory_allocated": peak,
          "held_64x64": {"max_abs_err_of_largest": err, "tol": HELD_REL_TOL}})
    return moved


def _jpeg_flips(x_card, x_cpu, q_card, q_cpu):
    """DCT coefficients whose rounding differs between card and CPU: each must lie
    within TIE_BAND of a rounding boundary. -> (a [B, H, W] mask of the image
    pixels those coefficients reach, flips, near-ties on the CPU)."""
    from glare_tpu_torch.sr.utils.diffjpeg import quantized_coefficients

    qk, _, (hp, wp) = quantized_coefficients(x_card, q_card)
    qc, _, _ = quantized_coefficients(x_cpu, q_cpu)
    b, _, h, w = x_cpu.shape
    reach = torch.zeros((b, hp, wp), dtype=torch.bool)
    flips = ties = 0
    for name in qc:
        a, c = qk[name].cpu(), qc[name]
        frac_gap = ((c - torch.floor(c)) - 0.5).abs()
        ties += int((frac_gap < TIE_BAND).sum())
        differ = torch.round(a) != torch.round(c)
        require(bool((frac_gap[differ] < TIE_BAND).all()), f"DiffJPEG {name}: a rounding flip off a near-tie")
        flips += int(differ.sum())
        px = 8 if name == "y" else 16
        blocks = differ.any(dim=(2, 3)).reshape(b, hp // px, wp // px)
        reach |= blocks.repeat_interleave(px, 1).repeat_interleave(px, 2)
    return reach[:, :h, :w], flips, ties


def _abs_outside(card, cpu, reach, what):
    """Max |card - cpu| outside ``reach`` ([B, H, W]), required <= DEGRADE_ABS_TOL."""
    d = (card.detach().cpu() - cpu.detach()).abs().amax(dim=1)
    err = float(d[~reach].max()) if bool((~reach).any()) else 0.0
    require(err <= DEGRADE_ABS_TOL, f"{what}: card against CPU {err}")
    return err


def phase_degradation_path():
    """The Real-ESRGAN-style device degradations on a batch of 12 crops at 256x256:
    DiffJPEG with per-sample quality in [30, 95], differentiable (with one backward)
    and hard; USMSharp() (radius 50 -> 51); filter2D with per-sample 21x21
    kernels. Each against the same call on the CPU in float32 within
    DEGRADE_ABS_TOL, except the image blocks of DCT coefficients that round apart
    (each within TIE_BAND of a boundary) and the reach of USM mask pixels that
    decide apart (each residual within TIE_BAND of the threshold): counted.
    Timed: ms per batch."""
    from glare_tpu_torch.sr.utils.diffjpeg import DiffJPEG
    from glare_tpu_torch.sr.utils.img_process_util import USMSharp, filter2D

    g = torch.Generator().manual_seed(31)
    x_cpu = _smooth_images(32, 12, 256, 256)
    q_cpu = 30.0 + 65.0 * torch.rand(12, generator=g)
    w_cpu = torch.randn(x_cpu.shape, generator=g)
    ks = torch.arange(21, dtype=torch.float32) - 10
    sig = 0.5 + 3.5 * torch.rand((12, 2), generator=g)
    k_cpu = torch.exp(-(ks[None, :, None] ** 2) / (2 * sig[:, :1, None] ** 2)
                      - (ks[None, None, :] ** 2) / (2 * sig[:, 1:, None] ** 2))
    k_cpu = k_cpu / k_cpu.sum(dim=(1, 2), keepdim=True)
    x, q, w, k = x_cpu.to(DEV), q_cpu.to(DEV), w_cpu.to(DEV), k_cpu.to(DEV)
    usm, usm_cpu = USMSharp().to(DEV), USMSharp()
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    out, ms, held = {}, {}, {}
    with torch.no_grad():
        for mode, diff in (("diffjpeg_differentiable", True), ("diffjpeg_hard", False)):
            out[mode], ms[mode] = _timed(lambda: DiffJPEG(diff)(x, q))
        out["usm_sharp"], ms["usm_sharp"] = _timed(lambda: usm(x))
        out["filter2d"], ms["filter2d"] = _timed(lambda: filter2D(x, k))

    def jpeg_backward(xx, qq, ww):
        xx = xx.detach().requires_grad_(True)
        (DiffJPEG(True)(xx, qq) * ww).sum().backward()
        return xx.grad

    out["diffjpeg_backward"], ms["diffjpeg_backward"] = _timed(lambda: jpeg_backward(x, q, w))
    moved = _no_kernel_moved(before, "degradation_path")
    peak = torch.cuda.max_memory_allocated()

    reach, flips, ties = _jpeg_flips(x, x_cpu, q, q_cpu)
    for mode, diff in (("diffjpeg_differentiable", True), ("diffjpeg_hard", False)):
        with torch.no_grad():
            err = _abs_outside(out[mode], DiffJPEG(diff)(x_cpu, q_cpu), reach, mode)
        held[mode] = {"max_abs_err": err, "coefficients_rounded_apart": flips, "coefficients_near_tie_cpu": ties,
                      "pixels_excluded": int(reach.sum())}
    err = _abs_outside(out["diffjpeg_backward"], jpeg_backward(x_cpu, q_cpu, w_cpu), reach, "DiffJPEG backward")
    held["diffjpeg_backward"] = {"max_abs_err": err, "pixels_excluded": int(reach.sum())}
    with torch.no_grad():
        res_k, mask_k = usm.mask(x)
        res_c, mask_c = usm_cpu.mask(x_cpu)
        gap = (res_c.abs() - 10 / 255).abs()
        apart = mask_k.cpu() != mask_c
        require(bool((gap[apart] < TIE_BAND).all()), "USMSharp: a mask pixel decided apart off the threshold")
        reach_usm = filter2D(apart.float(), usm_cpu.kernel).amax(dim=1) > 0
        err = _abs_outside(out["usm_sharp"], usm_cpu(x_cpu), reach_usm, "USMSharp")
        held["usm_sharp"] = {"max_abs_err": err, "mask_pixels_apart": int(apart.sum()),
                             "residuals_near_threshold_cpu": int((gap < TIE_BAND).sum()),
                             "pixels_excluded": int(reach_usm.sum())}
        err = _abs_outside(out["filter2d"], filter2D(x_cpu, k_cpu), torch.zeros_like(reach), "filter2D")
        held["filter2d"] = {"max_abs_err": err}
    emit({"phase": "degradation_path", "batch": list(x.shape), "quality": [round(float(v), 2) for v in q_cpu],
          "usm_radius": usm.radius, "filter2d_kernel": [21, 21],
          "ms_per_batch": {key: statistics.median(v) for key, v in ms.items()}, "ms_calls": ms,
          "max_memory_allocated": peak, "held": held,
          "tol": f"{DEGRADE_ABS_TOL} absolute; decisions within {TIE_BAND} of a rounding boundary or of the "
                 "USM threshold may go apart (their reach excluded, counted)"})
    return moved


HAZE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_haze")


def _haze_folder(n=8, h=400, w=600):
    """Seeded GT PNGs (smooth colour fields + noise) and their depth .npy (a
    smooth field), the layout HazeOnlineDataset reads."""
    import shutil

    import cv2

    shutil.rmtree(HAZE_DIR, ignore_errors=True)
    gt_dir, depth_dir = os.path.join(HAZE_DIR, "gt"), os.path.join(HAZE_DIR, "depth")
    os.makedirs(gt_dir)
    os.makedirs(depth_dir)
    imgs = _smooth_images(41, n, h, w)
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        rgb = (imgs[i].permute(1, 2, 0).numpy() * 255).round().astype(np.uint8)
        cv2.imwrite(os.path.join(gt_dir, f"{i:03d}.png"), rgb[:, :, ::-1])
        a, b = rng.uniform(0.5, 2.0, 2)
        depth = 5.0 + yy / h * 10 * a + 2 * np.sin(xx / (40 * b)) + rng.normal(0, 0.1, (h, w))
        np.save(os.path.join(depth_dir, f"{i:03d}.npy"), depth.astype(np.float32))
    return gt_dir, depth_dir


HAZE_TURNS = (False, True, True, False)   # prefetch off / on, in turns: one epoch each
HAZE_RATIO = 2                            # the timed epochs: the 8 images twice, 4 iterations an epoch


def _haze_epochs(dataset, opt, epochs=2):
    """``epochs`` epochs of sr.data's build_dataloader(dataset, opt, seed=0), Python's
    random and np.random seeded 0 first -> the host batches, epoch after epoch, and
    the host ms per item of each (time the asking and the copy to the card)."""
    import random

    from glare_tpu_torch.sr.data import build_dataloader

    random.seed(0)
    np.random.seed(0)
    loader = build_dataloader(dataset, opt, seed=0)
    batches, item_ms = [], []
    for _ in range(epochs):
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            batches.append(batch)
            _ = {k: torch.from_numpy(v).to(DEV) for k, v in batch.items() if isinstance(v, np.ndarray)}
            torch.cuda.synchronize()   # the item's time includes its copy to the card
            item_ms.append((time.perf_counter() - t0) * 1e3 / S1_BATCH)
    return loader, batches, item_ms


def _same_batches(got, want):
    return len(got) == len(want) and all(
        g.keys() == w.keys() and all(np.array_equal(g[k], w[k]) if isinstance(w[k], np.ndarray) else g[k] == w[k]
                                     for k in w) for g, w in zip(got, want))


def _loop_epoch(model, loader, first_iter):
    """One epoch of the training loop as sr.train runs it: ask the loader, move the
    batch to the card, optimize_parameters; the card synchronized at the end. ->
    (ms per iteration, host ms per iteration spent waiting on the loader and the
    copy, host ms per iteration inside optimize_parameters until it returns,
    iterations)."""
    torch.cuda.synchronize()
    t0, wait, step, n = time.perf_counter(), 0.0, 0.0, 0
    it = iter(loader)
    while True:
        w0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        batch = {k: (torch.from_numpy(v).to(DEV) if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
        s0 = time.perf_counter()
        model.optimize_parameters(first_iter + n, batch)
        wait += s0 - w0
        step += time.perf_counter() - s0
        n += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, wait * 1e3 / n, step * 1e3 / n, n


def phase_haze_lq_path(model=None, card="unknown"):
    """RIDCP's dehazing data path into the LQ stage: HazeOnlineDataset (phase train,
    gt_size 256, the JAX defaults for beta_range, A_range, color_p, color_range)
    over eight seeded 400x600 GT images and their depth maps, through sr.data's
    build_dataloader at batch 4 (Python's random and np.random seeded; two epochs,
    the second's host time reported), the same two epochs with ``prefetch_mode:
    cpu`` (the batches built by the PrefetchDataLoader's thread) bit-equal to them,
    then two LQ iterations, on the second epoch's batches, of the model of
    train_stage1_lq_path (``model``; without it the same model built here): each
    exactly 2 f32 DCN forwards and 2 backward passes with grad_x, finite losses
    (_s1_iterations' checks). Timed: host ms per dataset item beside ms per
    iteration; then epochs of the loop with the loader inside it (an
    EnlargedSampler of ratio HAZE_RATIO: 4 iterations an epoch), prefetch off and
    on in turns (HAZE_TURNS), in ms per iteration, host ms per iteration waiting on
    the loader and host ms per iteration inside optimize_parameters."""
    import shutil

    from glare_tpu_torch.data.loader import PrefetchDataLoader
    from glare_tpu_torch.parallel.mesh import EnlargedSampler
    from glare_tpu_torch.sr.data import build_dataloader, build_dataset

    gt_dir, depth_dir = _haze_folder()
    opt = {"type": "HazeOnlineDataset", "phase": "train", "gt_size": S1_GT, "dataroot_gt": gt_dir,
           "dataroot_depth": depth_dir, "batch_size_per_gpu": S1_BATCH}
    dataset = build_dataset(opt)
    require(len(dataset) == 8, f"HazeOnlineDataset found {len(dataset)} images")
    # the first epoch pays one-time imports (scipy.linalg for the correlated noise)
    _, host, item_ms = _haze_epochs(dataset, opt)
    prefetcher, host_pre, _ = _haze_epochs(dataset, {**opt, "prefetch_mode": "cpu"})
    require(isinstance(prefetcher, PrefetchDataLoader), "prefetch_mode did not give a PrefetchDataLoader")
    require(len(host) == 4 and _same_batches(host_pre, host),
            "the batches with prefetch_mode differ from the plain loader's")
    batches = [{k: (torch.from_numpy(v).to(DEV) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
               for b in host[2:]]
    require(all(b["lq"].shape == (S1_BATCH, S1_GT, S1_GT, 3) for b in batches),
            f"haze batches {[tuple(b['lq'].shape) for b in batches]}")
    value_range = {}  # the bicubic resize may ring a little past [0, 1], as in the reference
    for k in ("lq", "gt"):
        require(all(bool(torch.isfinite(b[k]).all()) for b in batches), f"haze batch {k} not finite")
        value_range[k] = [min(float(b[k].min()) for b in batches), max(float(b[k].max()) for b in batches)]
    built = model is None
    if built:
        model = _s1_lq_model()[0]
    per_step = {**{k: 0 for k in counters()}, "dcn_fwd_f32": 2, "dcn_bwd": 2}
    bwd_per_step = {**{k: 0 for k in dcn_ops.bwd_launches_by_entry}, "pass_x": 2}
    summary, path_counts, peak_mem = _s1_iterations(model, batches, per_step, bwd_per_step, first_iter=2001)

    turns, first_iter = [], 3001
    for prefetch in HAZE_TURNS:
        sampler = EnlargedSampler(len(dataset), 1, 0, ratio=HAZE_RATIO)   # the same order in every turn
        loader = build_dataloader(dataset, {**opt, "prefetch_mode": "cpu" if prefetch else None}, seed=0,
                                  sampler=sampler)
        ms, wait_ms, step_ms, n = _loop_epoch(model, loader, first_iter)
        first_iter += n
        turns.append({"prefetch": prefetch, "ms_per_iteration": ms, "host_wait_ms_per_iteration": wait_ms,
                      "host_step_ms_per_iteration": step_ms, "iterations": n})
    require(all(t["iterations"] == len(dataset) * HAZE_RATIO // S1_BATCH for t in turns),
            f"loop epochs of {[t['iterations'] for t in turns]} iterations")
    shutil.rmtree(HAZE_DIR, ignore_errors=True)
    emit({"phase": "haze_lq_path", "dataset": {k: v for k, v in opt.items() if not k.startswith("dataroot")},
          "images": [8, 400, 600], "lq_model": "built here" if built else "train_stage1_lq_path's",
          "host_ms_per_item": statistics.mean(item_ms[len(item_ms) // 2:]), "host_ms_per_item_by_batch": item_ms,
          "prefetch_batches_equal": True,
          "value_range": value_range,
          **summary, "launches_total": path_counts, "expected_per_step": per_step,
          "expected_bwd_per_step": bwd_per_step, "max_memory_allocated": peak_mem,
          "loop_with_loader": {"card": card, "turns": turns}})
    return path_counts


def _near_tie_rows(scores, got, want, pick_max):
    """Indices that differ between card and CPU, each only where the two choices'
    float64 scores agree to 1e-6 relative. -> the number that differ."""
    differ = (got.cpu() != want).reshape(-1)
    s = scores.reshape(differ.shape[0], -1)
    g, w = got.cpu().reshape(-1)[differ], want.reshape(-1)[differ]
    rows = s[differ]
    a = rows.gather(1, g[:, None].long())[:, 0]
    b = rows.gather(1, w[:, None].long())[:, 0]
    require(bool(((a - b).abs() <= 1e-6 * b.abs().clamp_min(1e-30)).all()),
            f"{int(differ.sum())} indices apart off a near-tie ({'argmax' if pick_max else 'argmin'})")
    return int(differ.sum())


def phase_legacy_path():
    """The legacy networks at 600x400, float32, seeded weights: RRDBNet at ESRGAN's
    widths (nf 64, nb 23, gc 32, get_steps=True) and ColorEncoder(nf 64), a warm-up
    and three timed calls each; both on a 64x64 crop card against CPU. The two
    quantizer variants: GumbelQuantize in eval (taming's f8 widths: 256 hidden,
    8192 codes of 256) and EMAVectorQuantizer (1024 codes of 256) with one
    update=True, on tokens near the codebook, card against CPU: indices apart
    only at a near-tie (1e-6 relative, float64 scores), the EMA buffers within
    EMA_TOL."""
    import copy

    from glare_tpu_torch.modules import legacy_archs, quantize
    from glare_tpu_torch.nn.layers import seed_init_

    g = torch.Generator().manual_seed(51)
    x = _smooth_images(52, 1, 400, 600).to(DEV)
    report = {}
    torch.cuda.reset_peak_memory_stats()
    before = counters()
    for name, cpu_net, call in (
            ("RRDBNet", legacy_archs.RRDBNet(nf=64, nb=23, gc=32), lambda n, t: n(t, get_steps=True)),
            ("ColorEncoder", legacy_archs.ColorEncoder(nf=64), lambda n, t: n(t))):
        cpu_net = seed_init_(cpu_net, g).eval()
        net = copy.deepcopy(cpu_net).to(DEV)
        with torch.no_grad():
            out, ms = _timed(lambda: call(net, x))
            outs = out if isinstance(out, dict) else {"out": out}
            crop = x[:, :, :64, :64]
            card, cpu = call(net, crop), call(cpu_net, crop.cpu())
        card, cpu = (card, cpu) if isinstance(card, dict) else ({"out": card}, {"out": cpu})
        errs = {k: _held(card[k], cpu[k], f"{name} {k}") for k in cpu if cpu[k] is not None}
        report[name] = {"ms": statistics.median(ms), "ms_calls": ms,
                        "outputs": {k: list(v.shape) for k, v in outs.items() if v is not None},
                        "held_64x64": errs}
        del net
    peak = torch.cuda.max_memory_allocated()

    z_cpu = torch.randn((4, 256, 32, 32), generator=g)
    gq_cpu = seed_init_(quantize.GumbelQuantize(256, 256, 8192), g).eval()
    gq = copy.deepcopy(gq_cpu).to(DEV)
    z = z_cpu.to(DEV)
    with torch.no_grad():
        (zq, kl, (_, _, ind)), ms = _timed(lambda: gq(z))
        zq_c, kl_c, (_, _, ind_c) = gq_cpu(z_cpu)
        p = gq_cpu.proj
        scores = torch.nn.functional.conv2d(z_cpu.double(), p.weight.double(), p.bias.double())
    apart = _near_tie_rows(scores.permute(0, 2, 3, 1), ind, ind_c, True)
    same = (ind.cpu() == ind_c)[:, None].expand_as(zq_c)
    zq_err = float((zq.cpu() - zq_c).abs()[same].max())
    kl_err = abs(float(kl) - float(kl_c)) / abs(float(kl_c))
    require(zq_err <= 1e-5 and kl_err <= 1e-5, f"GumbelQuantize z_q {zq_err}, kl {kl_err}")
    report["GumbelQuantize_eval"] = {"ms": statistics.median(ms), "ms_calls": ms, "z": list(z_cpu.shape),
                                     "n_embed": gq.n_embed, "indices_apart_at_near_tie": apart,
                                     "z_q_max_abs_err": zq_err, "kl_rel_err": kl_err}

    ema_cpu = seed_init_(quantize.EMAVectorQuantizer(1024, 256), g)
    book0 = ema_cpu.embedding.weight.clone().double()
    codes = torch.randint(0, 1024, (4 * 32 * 32,), generator=g)
    tokens = book0.float()[codes] + 0.3 * torch.randn((4 * 32 * 32, 256), generator=g)
    z_cpu = tokens.reshape(4, 32, 32, 256).permute(0, 3, 1, 2).contiguous()
    ema = copy.deepcopy(ema_cpu).to(DEV)
    z = z_cpu.to(DEV)
    (zq, loss, (perp, _, idx)), ms = sync_ms(lambda: ema(z, update=True))
    zq_c, loss_c, (perp_c, _, idx_c) = ema_cpu(z_cpu, update=True)
    zf = tokens.double()
    dist = (zf ** 2).sum(1, keepdim=True) + (book0 ** 2).sum(1)[None] - 2 * zf @ book0.t()
    apart = _near_tie_rows(dist, idx, idx_c, False)
    rows = torch.ones(1024, dtype=torch.bool)  # codes a token moved between are left out of the buffers' check
    differ = idx.cpu().reshape(-1) != idx_c.reshape(-1)
    rows[idx.cpu().reshape(-1)[differ]] = False
    rows[idx_c.reshape(-1)[differ]] = False
    errs = {}
    for key in ("weight", "cluster_size", "embed_avg"):
        a, b = getattr(ema.embedding, key).cpu()[rows].double(), getattr(ema_cpu.embedding, key)[rows].double()
        errs[key] = float((a - b).abs().max() / b.abs().max())
        require(errs[key] <= EMA_TOL, f"EMAVectorQuantizer {key}: card against CPU {errs[key]}")
    loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    perp_err = abs(float(perp) - float(perp_c)) / abs(float(perp_c))
    require(loss_err <= 1e-5 and perp_err <= 1e-5, f"EMAVectorQuantizer loss {loss_err}, perplexity {perp_err}")
    report["EMAVectorQuantizer_update"] = {"ms_first_call": ms, "z": list(z_cpu.shape), "n_embed": ema.n_embed,
                                           "tokens": "codebook rows + N(0, 0.3^2) noise",
                                           "indices_apart_at_near_tie": apart, "buffers_rel_err": errs,
                                           "loss_rel_err": loss_err, "perplexity_rel_err": perp_err,
                                           "codes_used": int(torch.unique(idx_c).numel())}
    moved = _no_kernel_moved(before, "legacy_path")
    emit({"phase": "legacy_path", "input": list(x.shape), "max_memory_allocated": peak, **report})
    return moved


# ------------------------------------------------------------------ dp_path --
# Stage-3 training at train_path's configuration in spawned processes on this card:
# (a) NCCL at world size 1, a DDP-wrapped step against the same step unwrapped;
# (b) two ranks over gloo (NCCL refuses two ranks on one device; gloo's DDP takes
#     CUDA tensors), one image each, against the single-process step on the whole batch;
# (c) the stage-2 ActNorm init over the two ranks against one process on both crops;
# (d) one FSDP2 step (parallelize("fsdp")) at world size 1 against the unwrapped one.

DP_SAME_TOL = 1e-6      # (a), (d): of each tensor's largest ("expected bit-equal")
DP_ACTNORM_TOL = 1e-5   # (c), float64: of each tensor's largest (float32: ACTNORM_TOL)
DP_TIMED = 3            # (a): steps timed each way, in turns
DP_UPDATES = 10         # the schedule's count at each compared step: past the warm-up, lr 5e-5


def _flat(named):
    """{name: tensor} -> (names, shapes, one flat float32 numpy array): one transfer
    between processes, by value (a rank exits after sending)."""
    names = list(named)
    return names, [tuple(named[n].shape) for n in names], \
        torch.cat([named[n].detach().float().reshape(-1).cpu() for n in names]).numpy()


def _unflat(packed):
    names, shapes, flat = packed
    flat = torch.from_numpy(flat)
    out, off = {}, 0
    for n, s in zip(names, shapes):
        k = math.prod(s)
        out[n] = flat[off:off + k].reshape(s)
        off += k
    return out


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _dp_state(model):
    """(loss log, gradients, parameters) of the trainable tensors after a step, on the CPU."""
    named = model.trainable_parameters()
    return (dict(model.get_current_log()), _flat({n: _full(p.grad) for n, p in named}),
            _flat({n: _full(p) for n, p in named}))


def _dp_restore(model, params0):
    """The trainable weights back to ``params0``, a fresh optimizer at DP_UPDATES
    updates, no wrapper."""
    model.dp = None
    with torch.no_grad():
        for n, p in model.trainable_parameters():
            p.copy_(params0[n].to(p.device))
    model._build_optimizer(model.opt.get("train") or {})
    model.updates = DP_UPDATES


def _dp_params(got_p, want_p, want_g, what):
    """The parameters after the step, against the reference step's. Adam's first
    update moves an element by lr * g / (|g| + eps), about lr either way, so where
    the reference gradient is rounding noise a sign may differ (2 lr apart); where
    it is at least 1e-2 of its tensor's largest (and the tensor's gradient does not
    vanish: above STEP_VANISH of the step's largest), the two updates must agree
    within 1e-3 lr. -> the largest distances."""
    lr = train_opt()["train"]["lr_G"]
    top = max(float(g.abs().max()) for g in want_g.values())
    worst_live, worst_all = 0.0, 0.0
    for n, w in want_p.items():
        d, g = (got_p[n] - w).abs(), want_g[n].abs()
        live = (g >= 1e-2 * g.max()) & (g.max() > STEP_VANISH * top)
        worst_all = max(worst_all, float(d.max()))
        if bool(live.any()):
            worst_live = max(worst_live, float(d[live].max()))
    require(worst_all <= 2.001 * lr and worst_live <= 1e-3 * lr,
            f"{what}: parameters {worst_all} (all), {worst_live} (live gradient) at lr {lr}")
    return {"max_abs_diff": worst_all, "max_abs_diff_live": worst_live, "lr": lr}


def _dp_same(got, want, what):
    """(a), (d): the loss and every gradient within DP_SAME_TOL of each tensor's
    largest of the reference step's (a tensor below STEP_VANISH of the step's
    largest gradient, such as an attention key bias's, vanishes in exact arithmetic
    and must vanish on both), the parameters by _dp_params."""
    g_log, g_grads, g_params = got
    w_log, w_grads, w_params = want
    g, w = _unflat(g_grads), _unflat(w_grads)
    top = max(float(t.abs().max()) for t in w.values())
    grads = _worst(_dists(g, w, top, f"{what}: gradient"))
    require(grads["worst"] <= DP_SAME_TOL, f"{what}: gradient {grads['worst_tensor']} {grads['worst']}")
    loss = max(abs(g_log[k] - v) / max(abs(v), 1e-30) for k, v in w_log.items())
    require(loss <= DP_SAME_TOL, f"{what}: losses {g_log} against {w_log}")
    gp, wp = _unflat(g_params), _unflat(w_params)
    return {"loss_rel": loss, "grads": grads,
            "grads_bit_equal": all(torch.equal(g[n], w[n]) for n in w),
            "params": _dp_params(gp, wp, w, what), "params_bit_equal": all(torch.equal(gp[n], wp[n]) for n in wp)}


def _dp_group_a():
    """World size 1, NCCL: the reference steps, (a), (d), and the single-process
    ActNorm init of (c)."""
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.parallel.mesh import contiguous_parameters_

    model, build_s = _train_model(False)
    batch = train_batch(310)
    spread = condition_offset_heads(model, batch)
    params0 = {n: p.detach().clone() for n, p in model.trainable_parameters()}
    model.updates = DP_UPDATES
    model.optimize_parameters(batch)
    ref = _dp_state(model)
    _dp_restore(model, params0)
    model.parallelize("ddp")
    model.optimize_parameters(batch)
    a = _dp_same(_dp_state(model), ref, "(a) DDP(1) against the unwrapped step")
    ddp = model.dp
    times = {"unwrapped": [], "ddp1": []}
    for _ in range(DP_TIMED):
        for key, wrapper in (("unwrapped", None), ("ddp1", ddp)):
            model.dp = wrapper
            times[key].append(sync_ms(lambda: model.optimize_parameters(batch))[1])
    # (d): FSDP2 takes contiguous parameters, and cuDNN picks other algorithms for
    # them than for channels_last ones: the unwrapped step on contiguous weights is
    # its reference; the channels_last one is reported beside it
    _dp_restore(model, params0)
    contiguous_parameters_(model.netG)
    model.optimize_parameters(batch)
    ref_d = _dp_state(model)
    _dp_restore(model, params0)
    model.parallelize("fsdp")
    model.updates = DP_UPDATES
    model.optimize_parameters(batch)
    got_d = _dp_state(model)
    d = _dp_same(got_d, ref_d, "(d) FSDP2 at world size 1 against the unwrapped step (contiguous weights)")
    g_d, g_ref = _unflat(got_d[1]), _unflat(ref[1])
    top = max(float(t.abs().max()) for t in g_ref.values())
    d["grads_vs_channels_last_step"] = max(float((g_d[n] - w).abs().max() / w.abs().max())
                                           for n, w in g_ref.items() if float(w.abs().max()) > STEP_VANISH * top)
    d["specs_sharded"] = sum(1 for s in model.fsdp_specs.values() if any(s))
    del model
    torch.cuda.empty_cache()
    actnorm = _dp_actnorm_inits(create_model(train2_opt(), device="cuda"))
    return {"ref": ref, "params0": _flat(params0), "build_s": build_s, "spread": spread, "a": a, "d": d,
            "ms": times, "actnorm": actnorm, "peak": torch.cuda.max_memory_allocated()}


def _dp_group_b(params0):
    """Two ranks over gloo on this card: (b) one step of the model's own DP switch
    (DDP over gloo with CUDA tensors) on the global batch, each rank its image,
    launch counts, no plain version, then a second step timed; (c) the stage-2
    ActNorm init on one crop a rank."""
    from glare_tpu_torch.models import create_model

    model, _ = _train_model(False)
    require(model.dp is not None, "(b): a group of two ranks did not switch the model to DDP")
    with torch.no_grad():
        own = dict(model.trainable_parameters())
        for n, p in _unflat(params0).items():
            own[n].copy_(p.to(DEV))
    model.updates = DP_UPDATES
    batch = train_batch(310)
    per_step = {**{k: 0 for k in counters()}, "vq_argmin": 1, "dcn_fwd_f32": 2, "dcn_bwd": 2}
    bwd_per_step = {**{k: 0 for k in dcn_ops.bwd_launches_by_entry}, "pass": 2}
    with counted_plain_versions() as plain_calls:
        before, by_entry = counters(), dict(dcn_ops.bwd_launches_by_entry)
        _, ms = sync_ms(lambda: model.optimize_parameters(batch))
        moved, moved_e = moved_since(before), bwd_moved_since(by_entry)
        plain = plain_calls[0]
    state = _dp_state(model)
    _, ms_next = sync_ms(lambda: model.optimize_parameters(batch))   # the first step paid the warm-up
    del model
    torch.cuda.empty_cache()
    m2 = create_model(train2_opt(), device="cuda")
    ddp_stage2 = m2.dp is not None
    actnorm = _dp_actnorm_inits(m2)
    return {"state": state, "route": "ddp (gloo, CUDA tensors)", "ms": ms, "ms_second_step": ms_next,
            "launches": moved, "expected": per_step, "bwd": moved_e, "bwd_expected": bwd_per_step,
            "plain_calls": plain, "actnorm": actnorm, "ddp_stage2": ddp_stage2,
            "peak": torch.cuda.max_memory_allocated()}


def _dp_actnorm_inits(m2):
    """(c): the stage-2 ActNorm init on the two crops (under two ranks each takes
    its own), in float32 and again with the networks widened to float64 (where the
    batch layout's rounding, one crop a call against two, is out of the way and
    only the statistics' arithmetic is left). -> {dtype: flattened bias / logs}."""
    crops = train_batch(410, 2, S2_CROP)
    out = {}
    for dtype in ("float32", "float64"):
        if dtype == "float64":
            m2.netG.double()
            m2.net_hq.double()
            m2._actnorm_inited = False
        m2.initialize_actnorm(crops)
        out[dtype] = _flat({n: t for n, t in m2.netG.state_dict().items() if ".actnorm." in n})
    return out


DP_JOBS = {"a": _dp_group_a, "b": _dp_group_b}


def _dp_rank_main(rank, world, port, backend, job, args, queue):
    """One spawned rank: join the group, run ``DP_JOBS[job](*args)``, send the result."""
    import traceback

    import torch.distributed as dist

    from glare_tpu_torch.parallel import init_distributed

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    out = {}
    try:
        init_distributed("cuda", backend=backend, timeout_s=300)
        out = DP_JOBS[job](*args)
    except Exception:
        out = {"error": traceback.format_exc()}
    queue.put((rank, out))
    if dist.is_initialized():
        dist.destroy_process_group()


def _dp_spawn(world, backend, job, args=()):
    """``DP_JOBS[job]`` in ``world`` spawned ranks on this card -> the per-rank results."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = mp.start_processes(_dp_rank_main, args=(world, port, backend, job, args, q), nprocs=world,
                               join=False, start_method="spawn")
    out, deadline = [None] * world, time.time() + 600
    while any(r is None for r in out):
        try:
            r, res = q.get(timeout=5)
            out[r] = res
        except queue_mod.Empty:
            require(time.time() < deadline, f"dp_path {job}: ranks did not answer in 600 s")
            require(all(p.is_alive() or p.exitcode == 0 for p in procs.processes),
                    f"dp_path {job}: a rank died: {[p.exitcode for p in procs.processes]}")
    procs.join()
    for r, res in enumerate(out):
        require("error" not in res, f"dp_path {job} rank {r}:\n{res.get('error')}")
    return out


def phase_dp_path(card):
    """Data parallelism on the card (parallel/, the models' DP switch): see the
    comment above DP_SAME_TOL."""
    from glare_tpu_torch.parallel import EnlargedSampler  # noqa: F401  (the package imports on the card)

    t0 = time.time()
    (a,) = _dp_spawn(1, "nccl", "a")
    t_a = time.time() - t0
    b = _dp_spawn(2, "gloo", "b", (a["params0"],))
    t_b = time.time() - t0 - t_a
    # (b): each rank against the single-process step on the whole batch, train_path's bars
    ref_log, ref_grads, ref_params = a["ref"]
    want_g, want_p = _unflat(ref_grads), _unflat(ref_params)
    top = max(float(g.abs().max()) for g in want_g.values())
    ranks = []
    for r, res in enumerate(b):
        log, grads, params = res["state"]
        loss_rel = abs(log["total_loss"] - ref_log["total_loss"]) / abs(ref_log["total_loss"])
        g = _worst(_dists(_unflat(grads), want_g, top, f"(b) rank {r} gradient"))
        p_err = _dp_params(_unflat(params), want_p, want_g, f"(b) rank {r}")
        require(loss_rel <= STEP_LOSS_TOL, f"(b) rank {r}: loss {log['total_loss']} against {ref_log['total_loss']}")
        require(g["worst"] <= STEP_GRAD_TOL, f"(b) rank {r}: gradient {g['worst_tensor']} {g['worst']}")
        require(res["launches"] == res["expected"], f"(b) rank {r}: launches {res['launches']} != {res['expected']}")
        require(res["bwd"] == res["bwd_expected"], f"(b) rank {r}: backward kernels {res['bwd']}")
        require(res["plain_calls"] == 0, f"(b) rank {r}: {res['plain_calls']} plain-version calls")
        ranks.append({"rank": r, "route": res["route"], "ms_step": res["ms"], "ms_second_step": res["ms_second_step"],
                      "loss": log["total_loss"],
                      "loss_rel": loss_rel, "grads": g, "params": p_err,
                      "launches": res["launches"], "dcn_bwd_kernels": res["bwd"], "plain_calls": res["plain_calls"],
                      "max_memory_allocated": res["peak"]})
    p0, p1 = _unflat(b[0]["state"][2]), _unflat(b[1]["state"][2])
    require(all(torch.equal(p0[n], p1[n]) for n in p0), "(b) the two ranks hold different weights")
    # (c): the ActNorm init over the ranks against one process on both crops: in
    # float64 within DP_ACTNORM_TOL (the statistics over the ranks are the whole
    # batch's); in float32 within ACTNORM_TOL, train_stage2_path's card bar for
    # float32 rounding through this flow (the two layouts round differently)
    worst_c = {}
    for dtype, tol in (("float64", DP_ACTNORM_TOL), ("float32", ACTNORM_TOL)):
        want = _unflat(a["actnorm"][dtype])
        for r, res in enumerate(b):
            got = _unflat(res["actnorm"][dtype])
            for kind in ("bias", "logs"):
                names = [n for n in want if n.endswith(kind)]
                w = _worst(_dists(got, {n: want[n] for n in names}, max(float(want[n].abs().max()) for n in names),
                                  f"(c) rank {r} {dtype} ActNorm"))
                worst_c[f"{dtype}_{kind}"] = w
                require(w["worst"] <= tol, f"(c) rank {r} {dtype}: {w['worst_tensor']} {w['worst']} > {tol}")
    ms_u, ms_d = statistics.median(a["ms"]["unwrapped"]), statistics.median(a["ms"]["ddp1"])
    emit({"phase": "dp_path", "config": "confs/train_stage3_LOL.yml widths, float32, chain R=2, 256 crop, "
                                        "global batch 2, seeded weights (train_path's)",
          "card": card, "a_ddp_world1_nccl": a["a"], "d_fsdp_world1_nccl": a["d"],
          "ms_per_step": {"unwrapped": a["ms"]["unwrapped"], "ddp1": a["ms"]["ddp1"], "median_unwrapped": ms_u,
                          "median_ddp1": ms_d, "ddp1_overhead_ms": ms_d - ms_u},
          "b_two_ranks_gloo": ranks, "c_actnorm_two_ranks": {"worst": worst_c, "stage2_ddp": b[0]["ddp_stage2"],
                                                             "tol": {"float64": DP_ACTNORM_TOL,
                                                                     "float32": ACTNORM_TOL}},
          "seconds": {"group_a_world1": t_a, "group_b_world2": t_b},
          "launches_b_rank0_step": b[0]["launches"],
          "max_memory_allocated_a": a["peak"], "model_build_s": a["build_s"], "offset_spread": a["spread"],
          "tol": f"(a), (d) {DP_SAME_TOL} of each tensor's largest; (b) loss {STEP_LOSS_TOL} relative, each gradient "
                 f"{STEP_GRAD_TOL} of its largest; (c) {DP_ACTNORM_TOL} of each tensor's largest in float64, "
                 f"{ACTNORM_TOL} in float32"})
    return b[0]["launches"]   # one rank's step (this process launches nothing here)


# ------------------------------------------------------------------ tools_path --

def phase_tools_path(model, main_calls, card):
    """The model-driving tools on main_path's model (bf16, pallas, 620x420):
    offset_histogram over two seeded images (exactly two get_sr calls' launches; its
    per-warp statistics equal audit_dcn_offsets' on each image), flops_audit of one
    image with the MFU of main_path's measured ms per image."""
    from glare_tpu_torch.tools import flops_audit, offset_histogram

    expected = {**{k: 0 for k in counters()}, "vq_argmin": 2, "attn_hopper": 22, "dcn_hopper": 4}
    imgs = [dev(seeded_image(s)) for s in (200, 201)]
    reset_counters()
    with counted_plain_versions() as plain_calls:
        t0 = time.perf_counter()
        collected = [offset_histogram.collect_offsets(model, lq) for lq in imgs]
        torch.cuda.synchronize()
        hist_ms = (time.perf_counter() - t0) * 1e3
    launches = counters()
    require(launches == expected, f"offset_histogram launched {launches} != two get_sr calls' {expected}")
    require(plain_calls[0] == 0, f"offset_histogram ran {plain_calls[0]} plain versions")
    lines = offset_histogram.summarize(collected)
    names = sorted(collected[0], key=lambda n: [m for m, _ in model.netG.named_modules()].index(n))
    checked = 0
    for k, lq in enumerate(imgs):
        audit = model.audit_dcn_offsets(lq, radii=(1, 2, 4, 8))
        for w, name in enumerate(names):
            st, au = offset_histogram.offset_stats([collected[k][name]]), audit["warps"][f"warp_{w}"]
            pairs = [(st["max"], round(au["tap_max"], 4)), (st["p99"], round(au["tap_p99"], 4)),
                     (st["per_gk_max"], [[round(v, 4) for v in row] for row in au["per_gk_max"]])]
            for r in (1, 2, 4, 8):
                pairs += [(st["frac_exceed"][str(r)], round(au["tap_frac_exceed"][r], 6)),
                          (st["pix_frac_exceed"][str(r)], round(au["pix_frac_exceed"][r], 6))]
                pairs += [(st["rowblk_frac_exceed_by_rpb"][str(rpb)][str(r)],
                           round(au["rowblk_frac_exceed_by_rpb"][rpb][r], 6)) for rpb in (8, 16)]
            for got, want in pairs:
                require(got == want, f"offset_histogram {name} image {k}: {got} != audit {want}")
            checked += len(pairs)
    t0 = time.perf_counter()
    fl = flops_audit.stage3_flops(model, dev(seeded_image(5)))
    audit_s = time.perf_counter() - t0
    kern = {}
    for part in ("latent_half", "vq_decode", "aft_half"):
        for kind, v in fl[part]["kernels"].items():
            kern[kind] = kern.get(kind, 0) + v
    want_kern = {"attention": 11 * 4 * N_TOK ** 2 * 512, "vq_argmin": 2 * N_TOK * 8192 * 4,
                 "dcn": 2 * (H_IN * W_IN * 9 * 128 * 128 + (H_IN // 2) * (W_IN // 2) * 9 * 256 * 256)}
    require(kern == want_kern, f"flops_audit kernel rows {kern} != the formulas {want_kern}")
    ms_img = min(c["ms_per_image"] for c in main_calls if c["batch"] == 1)
    ceil = flops_audit.ceiling(fl["total"], flops_audit.PEAK_BF16)
    emit({"phase": "tools_path", "card": card,
          "offset_histogram": {"lines": lines, "launches": launches, "host_ms_two_images": hist_ms,
                               "fields_equal_to_audit_dcn_offsets": checked},
          "flops_audit": {"tflop_per_img": fl["total"] / 1e12,
                          "parts_tflop": {p: fl[p]["total"] / 1e12 for p in ("latent_half", "vq_decode", "aft_half")},
                          "kernel_tflop": {k: v / 1e12 for k, v in kern.items()},
                          "peak_tflops_datasheet": flops_audit.PEAK_BF16 / 1e12,
                          "ceiling_img_s_100mfu": ceil, "main_path_ms_per_image": ms_img,
                          "mfu": (1e3 / ms_img) / ceil, "host_s": audit_s}})
    return launches


@contextlib.contextmanager
def _cudnn_benchmark():
    """cuDNN picks each convolution's algorithm by timing them (the port leaves the
    heuristic choice on): for the --profile comparison only."""
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = False


def phase_profile(fn, what):
    """One traced call of ``fn``: device time by kernel category, busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    _, untraced_ms = sync_ms(fn)
    agg = profiling.aggregate(prof)
    busy = agg["device_busy_ms"]
    require(busy > 0, "torch.profiler recorded no device time")
    emit({"phase": "profile", "what": what, "traced_wall_ms": wall_ms,
          "untraced_wall_ms": untraced_ms, "device_busy_ms": busy,
          "device_idle_share_of_untraced": max(0.0, 1.0 - busy / untraced_ms),
          "kernel_launches": agg["kernel_launches"],
          "device_ms_by_category": agg["device_ms_by_category"],
          "top_kernels_ms": agg["top_kernels_ms"]})


# the path whose count a kernel's "launches" reports (and on which it must have
# run); None: an entry that no path launches, reported with the main path's 0
PATHS = {"vq_argmin": "main_path", "attn_hopper": "main_path", "attn_wmma": None,
         "attn_f32": "f32_attn_path", "attn_f32_simt": None,
         "dcn_hopper": "main_path", "dcn_fwd": None, "dcn_fwd_f32": "train_path", "dcn_bwd": "train_path",
         "dcn_hopper_cascade": "hybrid_path",
         "dcn_cascade_select": "hybrid_path", "dcn_cascade_fwd": None,
         "dcn_bwd_bf16": "train_path_bf16", "dcn_hopper_train": "train_path_bf16"}
# a row whose launches are another row's counter (the same entry on another path)
COUNTER_OF = {"dcn_hopper_train": "dcn_hopper"}
ALL_PHASES = ("device,build,kernels,main_path,eval_path,hybrid_path,gather_path,flow_path,f32_attn_path,"
              "stage2_path,"
              "train_path,train_path_bf16,train_stage2_path,train_stage1_path,train_stage1_lq_path,"
              "haze_lq_path,swinir_path,degradation_path,legacy_path,tools_path,dp_path,unpaired_path")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="comma list; the last line is printed only when all of them ran")
    ap.add_argument("--profile", action="store_true",
                    help="after main_path and in unpaired_path, trace one get_sr (after train_path, train_path_bf16, "
                         "train_stage2_path and the two stage-1 paths, one training step; the stage-1 "
                         "iterations also with cudnn.benchmark) with torch.profiler and print device "
                         "time by kernel category")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t_start = time.time()
    card = phase_device() if "device" in phases else "unknown"
    if "build" in phases:
        phase_build()
    kernels = phase_kernels() if "kernels" in phases else None
    counts, model, gather_tail = {}, None, None
    if "main_path" in phases:
        counts["main_path"], model, main_calls = phase_main_path()
        if args.profile:
            lq = dev(seeded_image(5))
            phase_profile(lambda: model.get_sr(lq), "one get_sr, batch 1, 620x420, bf16")
    if "eval_path" in phases:
        phase_eval_path(model)
    if "tools_path" in phases:
        require(model is not None, "tools_path runs on main_path's model: add main_path to --phases")
        counts["tools_path"] = phase_tools_path(model, main_calls, card)
    del model
    torch.cuda.empty_cache()
    if "unpaired_path" in phases:
        counts["unpaired_path"] = phase_unpaired_path(args.profile)
        torch.cuda.empty_cache()
    if "hybrid_path" in phases:
        counts["hybrid_path"] = phase_hybrid_path()
        torch.cuda.empty_cache()
    if "gather_path" in phases:
        counts["gather_path"], gather_tail = phase_gather_path()
        torch.cuda.empty_cache()
    if "flow_path" in phases:
        counts["flow_path"] = phase_flow_path()
        torch.cuda.empty_cache()
    if "f32_attn_path" in phases:
        counts["f32_attn_path"] = phase_f32_attn_path()
        torch.cuda.empty_cache()
    if "stage2_path" in phases:
        counts["stage2_path"] = phase_stage2_path()
        torch.cuda.empty_cache()
    if "train_path" in phases:
        counts["train_path"], model = phase_train_path()
        if args.profile:
            batch = train_batch(70)
            phase_profile(lambda: model.optimize_parameters(batch),
                          "one stage-3 training step, batch 2, 256x256, float32")
        del model
        torch.cuda.empty_cache()
    if "train_path_bf16" in phases:
        counts["train_path_bf16"], model = phase_train_path_bf16()
        if args.profile:
            batch = train_batch(71)
            phase_profile(lambda: model.optimize_parameters(batch),
                          "one stage-3 training step, batch 2, 256x256, train.mixed_precision (bf16)")
        del model
        torch.cuda.empty_cache()
    if "train_stage2_path" in phases:
        counts["train_stage2_path"], model = phase_train_stage2_path()
        if args.profile:
            batch = train_batch(95, S2_BATCH, S2_GT)
            phase_profile(lambda: model.optimize_parameters(batch),
                          "one stage-2 training step, batch 4, 320x320, float32")
        del model
        torch.cuda.empty_cache()
    hq_path = None
    if "train_stage1_path" in phases:
        counts["train_stage1_path"], model, hq_path = phase_train_stage1_path()
        if args.profile:
            batch = s1_batch(150)
            phase_profile(lambda: model.optimize_parameters(1000, batch),
                          "one stage-1 HQ iteration, batch 4, 256x256, float32")
            with _cudnn_benchmark():
                phase_profile(lambda: model.optimize_parameters(1001, batch),
                              "the same with torch.backends.cudnn.benchmark (convolution algorithms timed)")
        del model
        torch.cuda.empty_cache()
    model = None
    if "train_stage1_lq_path" in phases:
        counts["train_stage1_lq_path"], model = phase_train_stage1_lq_path(hq_path)
        if args.profile:
            batch = s1_batch(350, lq=True)
            phase_profile(lambda: model.optimize_parameters(1000, batch),
                          "one stage-1 LQ iteration, batch 4, 256x256, float32")
            with _cudnn_benchmark():
                phase_profile(lambda: model.optimize_parameters(1001, batch),
                              "the same with torch.backends.cudnn.benchmark (convolution algorithms timed)")
    if "haze_lq_path" in phases:
        counts["haze_lq_path"] = phase_haze_lq_path(model, card)
    del model
    torch.cuda.empty_cache()
    if "swinir_path" in phases:
        counts["swinir_path"] = phase_swinir_path()
        torch.cuda.empty_cache()
    if "degradation_path" in phases:
        counts["degradation_path"] = phase_degradation_path()
        torch.cuda.empty_cache()
    if "legacy_path" in phases:
        counts["legacy_path"] = phase_legacy_path()
        torch.cuda.empty_cache()
    if "dp_path" in phases:
        counts["dp_path"] = phase_dp_path(card)
    if any(ph not in phases for ph in ALL_PHASES.split(",")):
        emit({"partial": True, "phases": phases, "seconds": round(time.time() - t_start, 1)})
        return
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path")
    for k in kernels:
        k["launches_by_path"] = {path: c[COUNTER_OF.get(k["name"], k["name"])] for path, c in counts.items()}
        path = PATHS[k["name"]]
        k["launches"] = k["launches_by_path"][path or "main_path"]
        require(path is None or k["launches"] > 0, f"kernel {k['name']} was never launched on {path}")
        if k["name"] == "dcn_hopper" and gather_tail is not None:
            k["gather_path_tail"] = gather_tail   # the torch-op tail beside its base pass (this row)
    extras = ("library_call", "library_note", "kernel_ms", "smem_bytes", "sdpa_by_backend",
              "bound_with_round_trips_ms", "old_design_ms", "gather_path_tail", "f32_simt_ms",
              "bound_f32_units_ms", "bound_tf32x3_ms", "oracle_err", "plain_oracle_err", "f32_turns_ms")
    emit({"kernels": [{**{key: k[key] for key in keys}, **{key: k[key] for key in extras if key in k}}
                      for k in kernels]})
    emit({"seconds": round(time.time() - t_start, 1)})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
