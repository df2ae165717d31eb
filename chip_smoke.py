#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device; exits non-zero without

Phases, each printing one JSON line:
  device     the card (nvidia-smi name + power limit), torch / CUDA versions
  build      compiles csrc/*.cu with nvcc (one process per source) and loads them
  kernels    every hand-written kernel against its plain PyTorch version on the
             card, at the shapes the main path gives it and at small ragged
             shapes; times by CUDA events (median after a warm-up)
  main_path  stage-3 paired inference at the full width of confs/LOL.yml
             (bf16, 620x420, dcn_impl pallas / clamp 2, seeded random weights):
             three single-image requests and one batch of two through
             VQLLFLOWDModel.get_sr; launch counters per call; a stage-wise
             comparison of the kernel path against the plain-version path
Then the contract lines: {"kernels": [...]}, the card line, and last
{"ok": true, "device": {...}}. Any failure raises: non-zero exit, no last line.

Imports torch, numpy, the standard library and glare_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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

DEV = torch.device("cuda", 0)

# Published dense peaks of one H100 SXM (NVIDIA data sheet), for the bounds.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

H_IN, W_IN = 420, 620          # 400x600 protocol image + 20 px reflect pad
N_TOK = (H_IN // 4) * (W_IN // 4)   # 16275 latent tokens
N_PAD = -(-N_TOK // 2048) * 2048    # 16384: AttnBlock pads once to this

# Stage-wise check of the main path. Each stage is run three ways on the same
# inputs: bf16 through the kernels, bf16 through the plain versions, and in
# float32 through the plain versions (the truth both bf16 runs approximate).
# The kernel run's RMS distance from the float32 run may exceed the plain bf16
# run's by at most this factor, plus STAGE_ABS_SLACK of the reference's RMS for
# stages where both distances are near zero.
STAGE_RATIO = 1.25
STAGE_ABS_SLACK = 1e-3


def emit(obj):
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
        regs[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln][:12]
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "nvcc_seconds": round(_build.build_seconds, 2),
          "libraries": sorted(paths), "ptxas": regs})


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


def check_vq():
    """vq_argmin vs nearest_code_ref. Rule: indices equal wherever the best and
    second-best distances differ by more than 1e-6 relative; for every
    mismatch the two chosen codes' true (float64) distances agree to 1e-6.
    The error reported for this kernel is measured over every token of every
    case: the largest |d(z, e[kernel's index]) - d(z, e[plain index])| in
    float64, which is 0 exactly when no index differs (or only between exact
    ties)."""
    rng = np.random.default_rng(0)
    out = {}
    worst_abs = [0.0]

    def compare(z, e, tag):
        zt, et = dev(z), dev(e)
        got = vq_ops.nearest_code_cuda(zt, et)
        torch.cuda.synchronize()
        want = vq_ops.nearest_code_ref(zt, et)
        require(got.dtype == torch.int32 and got.shape == want.shape, f"vq {tag}: bad output")
        g, w = got.cpu().numpy(), want.cpu().numpy()
        worst_rel, gap_abs, n_mism = vq_gap(z, e, g, w)
        require(worst_rel <= 1e-6,
                f"vq {tag}: a token picked a code {worst_rel:.3e} (relative) farther")
        worst_abs[0] = max(worst_abs[0], gap_abs)
        out[tag] = {"n": int(z.shape[0]), "mismatches": n_mism, "worst_rel_gap": worst_rel,
                    "max_abs_dist_gap": gap_abs}
        return zt, et

    z = (rng.standard_normal((N_TOK, 3)) * 0.5).astype(np.float32)
    e = (rng.standard_normal((8192, 3)) * 0.5).astype(np.float32)
    zt, et = compare(z, e, "main[16275x3 vs 8192]")
    # constructed near-ties: duplicated codes (exact ties -> lowest index) and
    # tokens on the midpoint between two codes
    e2 = e[:1024].copy()
    e2[700:764] = e2[100:164]
    z2 = np.concatenate([e2[700:764], 0.5 * (e2[:200] + e2[200:400]),
                         (rng.standard_normal((37, 3)) * 0.5).astype(np.float32)]).astype(np.float32)
    compare(z2, e2, "near_tie[301x3 vs 1024]")
    got = vq_ops.nearest_code_cuda(dev(z2[:64]), dev(e2)).cpu().numpy()
    require((got == np.arange(100, 164)).all(), "vq: exact ties must go to the lowest index")
    # generic D and a ragged K
    z3 = rng.standard_normal((77, 7)).astype(np.float32)
    e3 = rng.standard_normal((333, 7)).astype(np.float32)
    compare(z3, e3, "ragged[77x7 vs 333]")

    ms = time_ms(lambda: vq_ops.nearest_code_cuda(zt, et))
    plain = time_ms(lambda: vq_ops.nearest_code_ref(zt, et))
    lib = time_ms(lambda: torch.cdist(zt, et).argmin(dim=1))
    n, k, d = N_TOK, 8192, 3
    b_ms, b_by = bound(2.0 * n * k * (d + 1), PEAK_F32, 4.0 * (n * d + k * d + n))
    return {"name": "vq_argmin", "route": "cuda", "source": "glare_tpu_torch/csrc/vq_argmin.cu",
            "replaces": "glare_tpu/ops/vq.py:42", "max_abs_err": worst_abs[0],
            "mismatches": sum(c["mismatches"] for c in out.values()),
            "tol": "exact indices; near-ties within 1e-6 relative true distance; max_abs_err is "
                   "the largest float64 distance gap between the kernel's and the plain code",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "cases": out}


def check_attn():
    rng = np.random.default_rng(1)
    cases = {}
    # main-path shape: one image's 16275 tokens padded to 16384, C = 512, bf16.
    # Tolerance: kernel and plain version cast at the same points, so they differ
    # by summation order and exp2 rounding, i.e. by last-bit flips of the bf16
    # probabilities and output: two bf16 ulps (2^-7) of the largest output.
    q, k, v = [dev(rng.standard_normal((1, N_PAD, 512)).astype(np.float32), torch.bfloat16)
               for _ in range(3)]
    got = attn_ops.flash_attention_nhc_cuda(q, k, v, n_true=N_TOK)
    torch.cuda.synchronize()
    want = attn_ops.flash_attention_nhc_ref(q, k, v, n_true=N_TOK)
    g, w = got[:, :N_TOK].float(), want[:, :N_TOK].float()
    require(bool(torch.isfinite(g).all()), "attn bf16: non-finite output")
    err = float((g - w).abs().max())
    ref_max = float(w.abs().max())
    tol = 2.0 ** -7 * ref_max
    cases["bf16[1,16384,512] n_true=16275"] = {"max_abs_err": err, "tol": tol, "ref_max": ref_max}
    require(err <= tol, f"attn bf16 main shape: {err} > {tol}")
    # dense float64 oracle on a slice of queries (independent of the tiling)
    qs = q[:, 5000:5064].double()
    s = (qs @ k[:, :N_TOK].double().transpose(1, 2)) * 512 ** -0.5
    dense = torch.softmax(s, dim=-1) @ v[:, :N_TOK].double()
    err64 = float((got[:, 5000:5064].double() - dense).abs().max())
    cases["bf16 vs float64 dense, 64 queries"] = {"max_abs_err": err64, "tol": 4 * tol}
    require(err64 <= 4 * tol, f"attn bf16 vs dense oracle: {err64}")

    # small ragged shapes; f32 tolerance 5e-5: exp2f vs torch.exp2 and order of sums
    for (b, n, c, nt, dt, tl) in [(2, 333, 96, 301, torch.float32, 5e-5),
                                  (2, 200, 64, 200, torch.float32, 5e-5),
                                  (2, 333, 96, 301, torch.bfloat16, None),
                                  (1, 130, 256, 97, torch.bfloat16, None)]:
        qq, kk, vv = [dev(rng.standard_normal((b, n, c)).astype(np.float32), dt) for _ in range(3)]
        o = attn_ops.flash_attention_nhc_cuda(qq, kk, vv, n_true=nt)
        torch.cuda.synchronize()
        r = attn_ops.flash_attention_nhc_ref(qq, kk, vv, n_true=nt)
        e_ = float((o[:, :nt].float() - r[:, :nt].float()).abs().max())
        t_ = tl if tl is not None else 2.0 ** -7 * float(r[:, :nt].float().abs().max())
        cases[f"{str(dt).split('.')[-1]}[{b},{n},{c}] n_true={nt}"] = {"max_abs_err": e_, "tol": t_}
        require(e_ <= t_, f"attn small case {(b, n, c, nt, dt)}: {e_} > {t_}")

    ms = time_ms(lambda: attn_ops.flash_attention_nhc_cuda(q, k, v, n_true=N_TOK), reps=5)
    plain = time_ms(lambda: attn_ops.flash_attention_nhc_ref(q, k, v, n_true=N_TOK), reps=3, warmup=1)
    lib = None
    try:
        q4, k4, v4 = q[:, None], k[:, None, :N_TOK].contiguous(), v[:, None, :N_TOK].contiguous()
        fn = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
        ref_lib = fn()
        torch.cuda.synchronize()
        lib_err = float((ref_lib[:, 0, :N_TOK].float() - w).abs().max())
        cases["library sdpa vs plain"] = {"max_abs_err": lib_err}
        lib = time_ms(fn, reps=3, warmup=1)
    except Exception as ex:  # the yardstick only: head dim 512 may be refused
        cases["library sdpa"] = {"refused": str(ex)[:200]}
    flops = 4.0 * N_TOK * N_TOK * 512
    b_ms, b_by = bound(flops, PEAK_BF16, 2.0 * 4 * N_TOK * 512)
    return {"name": "attn_fused", "route": "cuda", "source": "glare_tpu_torch/csrc/attn_fused.cu",
            "replaces": "glare_tpu/ops/attn_pallas.py:44", "max_abs_err": err,
            "tol": f"2^-7 * max|ref| = {tol:.4g} (bf16 last-bit flips, summation order)",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "achieved_tflops": flops / ms / 1e9, "cases": cases}


def _dcn_inputs(rng, B, H, W, C, G, O, dtype, spread):
    x = dev(rng.standard_normal((B, H, W, C)).astype(np.float32), dtype)
    off = dev((spread * rng.standard_normal((B, H, W, G, 9, 2))).astype(np.float32))
    mask = dev(rng.uniform(0, 1, (B, H, W, G, 9)).astype(np.float32))
    wgt = dev((rng.standard_normal((3, 3, C, O)) / math.sqrt(9 * C)).astype(np.float32))
    bias = dev((0.1 * rng.standard_normal(O)).astype(np.float32))
    return x, off, mask, wgt, bias


def check_dcn():
    rng = np.random.default_rng(2)
    per_tap = tuple(tuple(int(r) for r in row) for row in rng.integers(1, 5, (4, 9)))
    cases = {}
    timed = {}
    # (tag, B, H, W, C, G, O, dtype, offset spread px, max_offset, timed?)
    plan = [
        ("warp_0 bf16 clamp2", 1, H_IN // 2, W_IN // 2, 256, 4, 256, torch.bfloat16, 1.5, 2, True),
        ("warp_1 bf16 clamp2", 1, H_IN, W_IN, 128, 4, 128, torch.bfloat16, 1.5, 2, True),
        ("warp_0 bf16 exact +-6px", 1, H_IN // 2, W_IN // 2, 256, 4, 256, torch.bfloat16, 3.0, None, False),
        ("warp_1 bf16 per-tap", 1, H_IN, W_IN, 128, 4, 128, torch.bfloat16, 3.0, per_tap, False),
        ("warp_0 f32 exact +-6px", 1, H_IN // 2, W_IN // 2, 256, 4, 256, torch.float32, 3.0, None, False),
        ("warp_1 f32 clamp2", 1, H_IN, W_IN, 128, 4, 128, torch.float32, 3.0, 2, False),
        ("ragged f32 exact", 2, 13, 17, 24, 4, 20, torch.float32, 3.0, None, False),
        ("ragged f32 per-tap", 2, 13, 17, 24, 4, 20, torch.float32, 3.0, per_tap, False),
        ("small bf16 clamp2", 2, 13, 17, 32, 4, 48, torch.bfloat16, 3.0, 2, False),
        ("small bf16 Cg=4 exact", 1, 9, 70, 16, 4, 16, torch.bfloat16, 3.0, None, False),
    ]
    worst_main = 0.0
    for (tag, B, H, W, C, G, O, dt, spread, mo, timed_case) in plan:
        x, off, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, dt, spread)
        got = dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=mo)
        torch.cuda.synchronize()
        want = dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=mo)
        require(got.shape == want.shape and got.dtype == dt, f"dcn {tag}: bad output")
        require(bool(torch.isfinite(got.float()).all()), f"dcn {tag}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        ref_max = float(want.float().abs().max())
        # bf16: both round the sampled column and the output to bf16 at the same
        # points; a last-bit flip of either costs up to two bf16 ulps (2^-7) of the
        # output. f32: only the order of ~9*C float32 sums differs: 2e-4.
        tol = 2.0 ** -7 * max(ref_max, 1.0) if dt == torch.bfloat16 else 2e-4
        frac_out = float(((off.abs() > 2).any(dim=-1)).float().mean())
        cases[tag] = {"shape": [B, H, W, C, O], "max_abs_err": err, "tol": tol,
                      "taps_beyond_2px": round(frac_out, 4)}
        require(err <= tol, f"dcn {tag}: {err} > {tol}")
        if timed_case:
            worst_main = max(worst_main, err)
            ms = time_ms(lambda: dcn_ops.modulated_deform_conv_cuda(x, off, mask, wgt, bias, max_offset=mo))
            plain = time_ms(lambda: dcn_ops.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=mo),
                            reps=3, warmup=1)
            es = x.element_size()
            P = B * H * W
            nbytes = P * C * es + P * G * 9 * 3 * 4 + 9 * C * O * 4 + O * 4 + P * O * es
            b_ms, b_by = bound(2.0 * P * 9 * C * O, PEAK_BF16, nbytes)
            timed[tag] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                          "achieved_tflops": 2.0 * P * 9 * C * O / ms / 1e9}
        del x, off, mask, wgt, bias, got, want
        torch.cuda.empty_cache()
    mean = lambda key: sum(t[key] for t in timed.values()) / len(timed)  # noqa: E731
    by = max(timed.values(), key=lambda t: t["bound_ms"])["bound_by"]
    return {"name": "dcn_fwd", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_fwd.cu",
            "replaces": "glare_tpu/ops/dcn_pallas.py:55", "max_abs_err": worst_main,
            "tol": "bf16: 2^-7 * max(1, max|ref|); f32: 2e-4",
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": by, "library_ms": None,
            "note": "ms / plain_ms / bound_ms: mean per launch over the two shapes one get_sr gives it",
            "by_shape": timed, "cases": cases}


def phase_kernels():
    ks = [check_vq(), check_attn(), check_dcn()]
    emit({"phase": "kernels", "kernels": [
        {"name": k["name"], "max_err": k["max_abs_err"], "tol": k["tol"], "kernel_ms": k["ms"],
         "plain_ms": k["plain_ms"], "library_ms": k["library_ms"], "cases": k["cases"],
         **({"by_shape": k["by_shape"]} if "by_shape" in k else {})} for k in ks]})
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


def seeded_image(seed, batch=1):
    """Low-light-looking image in the log domain, as the CLI feeds the model."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H_IN, 0:W_IN].astype(np.float32)
    img = np.empty((batch, H_IN, W_IN, 3), np.float32)
    for b in range(batch):
        base = 0.04 + 0.03 * np.sin(xx / (37.0 + b) + seed) * np.cos(yy / 53.0)
        for c in range(3):
            img[b, ..., c] = base * (1.0 + 0.2 * c) + 0.01 * rng.standard_normal((H_IN, W_IN))
    img = np.clip(img, 0.0, 1.0)
    return np.log(np.clip(img + 1e-3, 1e-3, None)).astype(np.float32)


def counters():
    return {"vq_argmin": vq_ops.launches, "attn_fused": attn_ops.launches, "dcn_fwd": dcn_ops.launches}


def reset_counters():
    vq_ops.launches = attn_ops.launches = dcn_ops.launches = 0


@contextlib.contextmanager
def plain_versions():
    """Route the three kernel-bearing functions to their plain PyTorch versions
    (for the comparison only; the port itself has no such switch)."""
    saved = (vq_ops.nearest_code, attn_ops.flash_attention_nhc, dcn_ops.modulated_deform_conv)
    vq_ops.nearest_code = vq_ops.nearest_code_ref
    attn_ops.flash_attention_nhc = lambda q, k, v, n_true=None, pipeline=False: \
        attn_ops.flash_attention_nhc_ref(q, k, v, n_true=n_true)
    dcn_ops.modulated_deform_conv = dcn_ops.modulated_deform_conv_ref
    try:
        yield
    finally:
        vq_ops.nearest_code, attn_ops.flash_attention_nhc, dcn_ops.modulated_deform_conv = saved


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_main_path():
    from glare_tpu_torch.models import create_model
    from glare_tpu_torch.models.vqllflowd_model import temper_offset_heads

    t0 = time.time()
    model = create_model(lol_opt(), device="cuda")
    temper_offset_heads(model.netG, seed=7, std=0.02)
    build_s = time.time() - t0
    expected = {"vq_argmin": 1, "attn_fused": 11, "dcn_fwd": 2}

    # warm-up request (cuDNN autotuning, allocator), not counted
    model.get_sr(dev(seeded_image(99)))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    path_counts = counters()
    calls = []
    last = None
    for seed, batch in [(0, 1), (1, 1), (2, 1), (3, 2)]:
        lq = dev(seeded_image(seed, batch))
        before = counters()
        sr, ms = sync_ms(lambda: model.get_sr(lq))
        moved = {k: counters()[k] - before[k] for k in before}
        require(tuple(sr.shape) == (batch, H_IN, W_IN, 3) and sr.dtype == torch.float32,
                f"get_sr output {tuple(sr.shape)} {sr.dtype}")
        require(bool(torch.isfinite(sr).all()), "get_sr output is not finite")
        require(moved == expected, f"launches per get_sr call {moved} != expected {expected}")
        calls.append({"seed": seed, "batch": batch, "ms": ms, "ms_per_image": ms / batch,
                      "launches": moved, "out_mean": float(sr.mean()), "out_std": float(sr.std()),
                      "dcn_overflow": model.last_dcn_overflow()})
        last = (lq, sr)
    path_counts = {k: counters()[k] - path_counts[k] for k in path_counts}
    peak_mem = torch.cuda.max_memory_allocated()
    for k, n in path_counts.items():
        require(n > 0, f"kernel {k} was never launched on the main path")

    # per-stage times (one image) and the stage-wise comparison against the same
    # model run with the plain versions, and against a float32 model of the same
    # weights run with the plain versions, each stage fed the SAME inputs
    opt32 = lol_opt()
    opt32["inference_dtype"] = "float32"
    model32 = create_model(opt32, device="cuda")   # same seed: the same weights, unrounded
    temper_offset_heads(model32.netG, seed=7, std=0.02)
    lq = dev(seeded_image(0))
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
            rec_p = model.netG.aft_half(x, code_out, lr_enc["mid_feat"])
            x_f, lr_enc_f = model32.netG.latent_half(x_nchw)
            dec_f, _, code_out_f = model32.net_hq.decode(x)
            idx_f = model32.net_hq.quantize.last_indices.clone()
            rec_f = model32.netG.aft_half(x, code_out, lr_enc["mid_feat"])
            torch.cuda.synchronize()
            require(counters() == before, "the plain-version run launched a kernel")

    def cmp(kern, plain, f32):
        kern, plain, f32 = kern.double(), plain.double(), f32.double()
        ref_rms = max(float((f32 ** 2).mean().sqrt()), 1e-30)
        rel = lambda a, b: float(((a - b) ** 2).mean().sqrt()) / ref_rms  # noqa: E731
        return {"ref_rms": ref_rms, "ref_max": float(f32.abs().max()),
                "kernel_vs_f32": rel(kern, f32), "plain_vs_f32": rel(plain, f32),
                "kernel_vs_plain": rel(kern, plain),
                "kernel_vs_plain_max_abs": float((kern - plain).abs().max())}

    stages = {
        "latent_half.x": cmp(x, x_p, x_f),
        "latent_half.cond_feat": cmp(lr_enc["cond_feat"], lr_enc_p["cond_feat"], lr_enc_f["cond_feat"]),
        "vq_decode.dec": cmp(dec, dec_p, dec_f),
        "vq_decode.tap0": cmp(code_out[0], code_out_p[0], code_out_f[0]),
        "vq_decode.tap1": cmp(code_out[1], code_out_p[1], code_out_f[1]),
        "aft_half.rec": cmp(rec, rec_p, rec_f),
    }
    # Tolerance: the two bf16 runs differ only inside the kernels (last-bit
    # flips), but 3-4 attention blocks, group norms and convolutions in bf16
    # follow and spread them, so their distance from each other says little.
    # What a right kernel guarantees is that its run is no farther from the
    # float32 run than the plain bf16 run is, up to noise; a wrong kernel adds
    # an error of the order of the values themselves. Distances are RMS, as a
    # share of the float32 stage's own RMS (not of its peak, which one outlier
    # can inflate).
    for name, c in stages.items():
        require(math.isfinite(c["kernel_vs_f32"]), f"stage {name}: non-finite")
        limit = STAGE_RATIO * c["plain_vs_f32"] + STAGE_ABS_SLACK
        require(c["kernel_vs_f32"] <= limit,
                f"stage {name}: the kernel run is {c['kernel_vs_f32']:.3e} (relative RMS) from "
                f"the float32 run, the plain bf16 run {c['plain_vs_f32']:.3e}; limit {limit:.3e}")
    require(bool((idx_f == idx_p).all()), "float32 and bf16 models disagree on codebook indices "
            "for the same latent: their codebooks differ")
    # Both quantizers get the same latent, so an index may differ only between
    # codes whose float64 distances to the token agree to 1e-6 relative (the
    # rule of check_vq).
    z_np = x.float().permute(0, 2, 3, 1).reshape(-1, x.shape[1]).cpu().numpy()
    e_np = model.net_hq.quantize.embedding.weight.detach().float().cpu().numpy()
    flip_rel_gap, _, flips = vq_gap(z_np, e_np, idx_k.cpu().numpy(), idx_p.cpu().numpy())
    require(flip_rel_gap <= 1e-6,
            f"{flips} codebook indices differ between kernel and plain version, one by "
            f"{flip_rel_gap:.3e} (relative) in true distance")
    emit({"phase": "main_path", "config": "confs/LOL.yml widths, bf16, dcn_impl=pallas R=2",
          "input": [H_IN, W_IN], "model_build_s": round(build_s, 2), "calls": calls,
          "launches_total": path_counts, "expected_per_call": expected,
          "stage_ms_per_image": stage_ms, "stage_vs_plain": stages,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}",
          "index_flips": flips, "index_flip_worst_rel_gap": flip_rel_gap,
          "dcn_shapes": model.netG.deformable_decoder.last_dcn_shapes(),
          "max_memory_allocated": peak_mem})
    return path_counts, model


def _category(name):
    n = name.lower()
    for key, cat in (("attn_bf16_kernel", "attn_fused (this repo)"), ("attn_f32_kernel", "attn_fused (this repo)"),
                     ("dcn_bf16_kernel", "dcn_fwd (this repo)"), ("dcn_f32_kernel", "dcn_fwd (this repo)"),
                     ("vq_argmin", "vq_argmin (this repo)"),
                     ("groupnorm", "group norm"), ("group_norm", "group norm"), ("rowwisemoments", "group norm"),
                     ("cudnn", "conv / gemm (library)"), ("conv", "conv / gemm (library)"),
                     ("gemm", "conv / gemm (library)"), ("cutlass", "conv / gemm (library)"),
                     ("xmma", "conv / gemm (library)"), ("nchw", "layout copies"), ("nhwc", "layout copies"),
                     ("elementwise", "elementwise / casts"), ("copy", "elementwise / casts"),
                     ("reduce", "reductions"), ("gather", "gather / index"), ("index", "gather / index")):
        if key in n:
            return cat
    return "other"


def phase_profile(model):
    """One traced get_sr (batch 1): device time by kernel category, busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

    lq = dev(seeded_image(5))
    model.get_sr(lq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.get_sr(lq)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    _, untraced_ms = sync_ms(lambda: model.get_sr(lq))
    cats, names, n_kernels = {}, {}, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") or getattr(ev, "is_device", False):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us <= 0:
                continue
            n_kernels += ev.count
            c = _category(ev.key)
            cats[c] = cats.get(c, 0.0) + us / 1e3
            names[ev.key[:90]] = names.get(ev.key[:90], 0.0) + us / 1e3
    busy = sum(cats.values())
    require(busy > 0, "torch.profiler recorded no device time")
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "profile", "what": "one get_sr, batch 1, 620x420, bf16", "traced_wall_ms": wall_ms,
          "untraced_wall_ms": untraced_ms, "device_busy_ms": busy,
          "device_idle_share_of_untraced": max(0.0, 1.0 - busy / untraced_ms),
          "kernel_launches": n_kernels,
          "device_ms_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
          "top_kernels_ms": top})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="device,build,kernels,main_path",
                    help="comma list; the last line is printed only when all four ran")
    ap.add_argument("--profile", action="store_true",
                    help="after main_path, trace one get_sr with torch.profiler and print "
                         "device time by kernel category")
    args = ap.parse_args()
    phases = args.phases.split(",")
    t_start = time.time()
    card = phase_device() if "device" in phases else "unknown"
    if "build" in phases:
        phase_build()
    kernels = phase_kernels() if "kernels" in phases else None
    counts, model = phase_main_path() if "main_path" in phases else (None, None)
    if args.profile and model is not None:
        phase_profile(model)
    if kernels is None or counts is None or "device" not in phases or "build" not in phases:
        emit({"partial": True, "phases": phases, "seconds": round(time.time() - t_start, 1)})
        return
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    emit({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    emit({"seconds": round(time.time() - t_start, 1)})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
