#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one CUDA device; exits non-zero without

Phases, each printing one JSON line:
  device     the card (nvidia-smi name + power limit), torch / CUDA versions
  build      compiles the four csrc/*.cu with nvcc (one process per source, all
             started together) and loads them; ptxas registers, spills and shared
             memory of the Hopper attention kernel (spills fail the run)
  kernels    every hand-written kernel against its plain PyTorch version on the
             card, at the shapes the main path gives it and at small ragged
             shapes; times by CUDA events (median after a warm-up). Attention:
             the entry the wrapper picks for each case (hopper for bf16 C = 512,
             wmma for other bf16 widths, f32), the earlier wmma entry timed beside
             the hopper one at the main shape, and SDPA under each backend as
             the yardstick
  main_path  stage-3 paired inference at the full width of confs/LOL.yml
             (bf16, 620x420, dcn_impl pallas / clamp 2, seeded random weights):
             two single-image requests and one batch of two through
             VQLLFLOWDModel.get_sr; launch counters per call; a stage-wise
             comparison of the kernel path against the plain-version path
  hybrid_path  the same model with dcn_impl hybrid (the DCN cascade): a request
             that overflows the cascade's capacity goes through the CLI's
             re-dispatch loop, exact requests are held against an exact ('xla')
             model with the same weights, then auto_configure_dcn audits a
             two-image batch and one request runs under what it chose
  stage2_path  stage-2 inference at the full width of confs/train_stage2_LOL.yml
             (bf16, 600x400): LLFlowModel.get_sr -> decode_latent, the same
             stage-wise comparison
Every path is driven with the launch counts (attention: one per entry) set to 0
just before and read just after; every attention launch of a path must land on
the hopper entry.
Then the contract lines: {"kernels": [...]}, the card line, and last
{"ok": true, "device": {...}}. Any failure raises: non-zero exit, no last line.

Imports torch, numpy, the standard library and glare_tpu_torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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
        regs[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln][:16]
    hopper = {"smem_bytes": attn_ops.hopper_smem_bytes()}
    log = _build.build_log.get("attn_hopper")
    if log is not None:  # built by this process: read ptxas -v for the Hopper kernel
        m_regs = re.search(r"Used (\d+) registers", log)
        m_spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        require(m_regs is not None and m_spill is not None, "no ptxas report for attn_hopper")
        hopper.update(registers=int(m_regs.group(1)), spill_store_bytes=int(m_spill.group(1)),
                      spill_load_bytes=int(m_spill.group(2)))
        require(hopper["spill_store_bytes"] == 0 and hopper["spill_load_bytes"] == 0,
                f"attn_hopper spills registers: {hopper}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "nvcc_seconds": round(_build.build_seconds, 2),
          "libraries": sorted(paths), "ptxas": regs, "attn_hopper": hopper})


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
    vs torch.exp2 and the order of sums)."""
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
    cases["bf16 vs float64 dense, 64 queries"] = {"max_abs_err": err64, "tol": 4 * tol}
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
    return {"name": "attn_hopper", "route": "cuda", "source": "glare_tpu_torch/csrc/attn_hopper.cu",
            "replaces": "glare_tpu/ops/attn_pallas.py:44", "max_abs_err": err,
            "tol": f"2^-7 * max|ref| = {tol:.4g} (bf16 last-bit flips, summation order)",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "library_call": "F.scaled_dot_product_attention, fastest backend that takes head dim 512",
            "achieved_tflops": flops / ms / 1e9, "smem_bytes": attn_ops.hopper_smem_bytes(),
            "earlier": {"name": "attn_fused (wmma entry)", "source": "glare_tpu_torch/csrc/attn_fused.cu",
                        "ms": wmma_ms, "achieved_tflops": flops / wmma_ms / 1e9},
            "sdpa_by_backend": sdpa, "cases": cases}


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


def _cascade_offsets(rng, field, B, H, W, G):
    """Seeded offset fields for the cascade at R=2, R_tail=8:
    'bands'  in band (|d| <= 2) but for three bands of five rows, which reach
             7.5 px: at most six 8-row blocks, fewer than the 8 slots;
    'wide'   up to 7.5 px everywhere: every block is out of band, most overflow;
    'beyond' as 'bands', and 12 px spread: taps beyond R_tail, everywhere."""
    base = np.clip(1.0 * rng.standard_normal((B, H, W, G, 9, 2)), -2, 2)
    wide = np.clip(3.0 * rng.standard_normal((B, H, W, G, 9, 2)), -7.5, 7.5)
    if field == "bands":
        off = base
        for r0 in (H // 7, H // 2, H - 9):
            off[:, r0:r0 + 5] = wide[:, r0:r0 + 5]
    elif field == "wide":
        off = wide
    else:
        off = 12.0 * rng.standard_normal((B, H, W, G, 9, 2))
    return dev(off.astype(np.float32))


def check_dcn_cascade():
    """dcn_cascade_fwd vs modulated_deform_conv_cascade_ref on the card, at the
    two shapes the hybrid path gives it, bf16 and float32, R=2, R_tail=8,
    capacity 0.125. Outputs within check_dcn's tolerance, both counters exact."""
    rng = np.random.default_rng(4)
    kw = dict(max_offset=2, tail_offset=8, capacity_frac=0.125)
    cases, timed = {}, {}
    worst_main = 0.0
    shapes = [("warp_0", 1, H_IN // 2, W_IN // 2, 256, 4, 256), ("warp_1", 1, H_IN, W_IN, 128, 4, 128)]
    for (wname, B, H, W, C, G, O) in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x, _, mask, wgt, bias = _dcn_inputs(rng, B, H, W, C, G, O, dt, 1.0)
            for field in ("bands", "wide", "beyond"):
                tag = f"{wname} {str(dt).split('.')[-1]} {field}"
                off = _cascade_offsets(rng, field, B, H, W, G)
                a = (x, off, mask, wgt, bias)
                before = counters()
                got, ov = dcn_ops.modulated_deform_conv_cascade_cuda(*a, return_overflow=True, **kw)
                torch.cuda.synchronize()
                require(moved_since(before) == {**{k: 0 for k in before}, "dcn_cascade": 1},
                        f"cascade {tag}: counters")
                want, wov = dcn_ops.modulated_deform_conv_cascade_ref(*a, return_overflow=True, **kw)
                require(got.shape == want.shape and got.dtype == dt, f"cascade {tag}: bad output")
                require(bool(torch.isfinite(got.float()).all()), f"cascade {tag}: non-finite")
                require(ov.tolist() == wov.tolist(), f"cascade {tag}: counters {ov.tolist()} != "
                                                     f"plain version's {wov.tolist()}")
                err = float((got.float() - want.float()).abs().max())
                ref_max = float(want.float().abs().max())
                tol = 2.0 ** -7 * max(ref_max, 1.0) if dt == torch.bfloat16 else 2e-4
                require(err <= tol, f"cascade {tag}: {err} > {tol}")
                row_sel, _ = dcn_ops.cascade_selection(off, **kw)
                case = {"max_abs_err": err, "tol": tol, "overflow": ov.tolist(),
                        "rows_at_tail_radius": int(row_sel.sum()), "rows": B * H}
                if field == "bands":
                    # both counters zero <=> exact DCNv2: also equal to the exact kernel
                    require(ov.tolist() == [0, 0], f"cascade {tag}: {ov.tolist()} != [0, 0]")
                    exact = dcn_ops.modulated_deform_conv_cuda(*a, max_offset=None)
                    e2 = float((got.float() - exact.float()).abs().max())
                    case["vs_exact_kernel"] = e2
                    require(e2 <= tol, f"cascade {tag} vs exact kernel: {e2} > {tol}")
                    require(0 < case["rows_at_tail_radius"] < B * H, f"cascade {tag}: selection")
                elif field == "wide":
                    # blocks that found no slot keep the clamp-R kernel's output, bit for bit
                    require(ov[0].item() > 0 and ov[1].item() == 0, f"cascade {tag}: {ov.tolist()}")
                    clamped = dcn_ops.modulated_deform_conv_cuda(*a, max_offset=2)
                    keep = ~row_sel
                    require(bool(torch.equal(got[keep], clamped[keep])),
                            f"cascade {tag}: overflowed blocks differ from the clamp-R kernel")
                    require(not bool(torch.equal(got[row_sel], clamped[row_sel])),
                            f"cascade {tag}: selected blocks were not recomputed")
                else:
                    require(ov[1].item() > 0, f"cascade {tag}: no tap beyond R_tail counted")
                cases[tag] = case
                if dt == torch.bfloat16 and field == "bands":
                    worst_main = max(worst_main, err)
                    ms = time_ms(lambda: dcn_ops.modulated_deform_conv_cascade_cuda(
                        *a, return_overflow=True, **kw))
                    sel_ms = time_ms(lambda: dcn_ops.cascade_selection(off, **kw))
                    plain = time_ms(lambda: dcn_ops.modulated_deform_conv_cascade_ref(
                        *a, return_overflow=True, **kw), reps=3, warmup=1)
                    es = x.element_size()
                    P = B * H * W
                    nbytes = P * C * es + P * G * 9 * 3 * 4 + 9 * C * O * 4 + O * 4 + P * O * es
                    b_ms, b_by = bound(2.0 * P * 9 * C * O, PEAK_BF16, nbytes)
                    timed[wname] = {"ms": ms, "selection_ms": sel_ms, "plain_ms": plain,
                                    "bound_ms": b_ms, "bound_by": b_by,
                                    "achieved_tflops": 2.0 * P * 9 * C * O / ms / 1e9}
                del off, got, want
            del x, mask, wgt, bias
            torch.cuda.empty_cache()
    mean = lambda key: sum(t[key] for t in timed.values()) / len(timed)  # noqa: E731
    by = max(timed.values(), key=lambda t: t["bound_ms"])["bound_by"]
    return {"name": "dcn_cascade", "route": "cuda", "source": "glare_tpu_torch/csrc/dcn_fwd.cu",
            "replaces": "glare_tpu/ops/dcn_pallas.py:448", "max_abs_err": worst_main,
            "tol": "bf16: 2^-7 * max(1, max|ref|); f32: 2e-4; both overflow counters exact",
            "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": by, "library_ms": None,
            "note": "ms: the whole wrapper (block selection in torch ops + one launch of "
                    "dcn_cascade_fwd), mean per call over the two shapes one hybrid get_sr gives "
                    "it; bound: one pass's work (input, offsets, mask, weight read once, output "
                    "written once; 2*P*9*C*O FLOP)",
            "by_shape": timed, "cases": cases}


def phase_kernels():
    ks = [check_vq(), check_attn(), check_dcn(), check_dcn_cascade()]
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
    by_entry = attn_ops.launches_by_entry
    require(attn_ops.launches == sum(by_entry.values()), "attention counts disagree")
    return {"vq_argmin": vq_ops.launches, "attn_hopper": by_entry["hopper"],
            "attn_wmma": by_entry["wmma"], "attn_f32": by_entry["f32"],
            "dcn_fwd": dcn_ops.launches, "dcn_cascade": dcn_ops.cascade_launches}


def reset_counters():
    vq_ops.launches = attn_ops.launches = dcn_ops.launches = dcn_ops.cascade_launches = 0
    for entry in attn_ops.launches_by_entry:
        attn_ops.launches_by_entry[entry] = 0


def moved_since(before):
    now = counters()
    return {k: now[k] - before[k] for k in before}


@contextlib.contextmanager
def plain_versions():
    """Route the kernel-bearing functions to their plain PyTorch versions
    (for the comparison only; the port itself has no such switch)."""
    saved = (vq_ops.nearest_code, attn_ops.flash_attention_nhc, dcn_ops.modulated_deform_conv,
             dcn_ops.modulated_deform_conv_cascade)
    vq_ops.nearest_code = vq_ops.nearest_code_ref
    attn_ops.flash_attention_nhc = lambda q, k, v, n_true=None, pipeline=False: \
        attn_ops.flash_attention_nhc_ref(q, k, v, n_true=n_true)
    dcn_ops.modulated_deform_conv = dcn_ops.modulated_deform_conv_ref
    dcn_ops.modulated_deform_conv_cascade = dcn_ops.modulated_deform_conv_cascade_ref
    try:
        yield
    finally:
        (vq_ops.nearest_code, attn_ops.flash_attention_nhc, dcn_ops.modulated_deform_conv,
         dcn_ops.modulated_deform_conv_cascade) = saved


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
    expected = {"vq_argmin": 1, "attn_hopper": 11, "attn_wmma": 0, "attn_f32": 0,
                "dcn_fwd": 2, "dcn_cascade": 0}

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
    emit({"phase": "main_path", "config": "confs/LOL.yml widths, bf16, dcn_impl=pallas R=2",
          "input": [H_IN, W_IN], "model_build_s": round(build_s, 2), "calls": calls,
          "launches_total": path_counts, "expected_per_call": expected,
          "stage_ms_per_image": stage_ms, "stage_vs_plain": stages,
          "stage_tol": f"kernel_vs_f32 <= {STAGE_RATIO} * plain_vs_f32 + {STAGE_ABS_SLACK}",
          "index_flips": flips, "index_flip_worst_rel_gap": flip_rel_gap,
          "dcn_shapes": model.netG.deformable_decoder.last_dcn_shapes(),
          "max_memory_allocated": peak_mem})
    return path_counts, model


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
    per_call = {"vq_argmin": 1, "attn_hopper": 11, "attn_wmma": 0, "attn_f32": 0,
                "dcn_fwd": 0, "dcn_cascade": 2}
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
    sr_x = model_x.get_sr(lq)
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
    stats = model.auto_configure_dcn(dev(seeded_image(23, 2)))
    # another image may still beat the audited radii: it goes through the loop too
    before = counters()
    with counted_get_sr(model) as n_calls:
        (sr, ov), ms = sync_ms(lambda: enhance_exact(model, dev(seeded_image(24)),
                                                     tag="request after the audit"))
    moved = moved_since(before)
    require(moved["dcn_fwd"] + moved["dcn_cascade"] == 2 * n_calls[0]
            and moved["attn_hopper"] == 11 * n_calls[0] and moved["attn_wmma"] == moved["attn_f32"] == 0
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


H2, W2 = 400, 600                       # the stage-2 evaluation pads to a multiple of 4 only
N_TOK2 = (H2 // 4) * (W2 // 4)          # 15000 latent tokens


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
    per_call = {"vq_argmin": 1, "attn_hopper": 7, "attn_wmma": 0, "attn_f32": 0,
                "dcn_fwd": 0, "dcn_cascade": 0}
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


def _category(name):
    n = name.lower()
    for key, cat in (("attn_hopper_kernel", "attention (this repo)"),
                     ("attn_bf16_kernel", "attention (this repo)"), ("attn_f32_kernel", "attention (this repo)"),
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


PATHS = {"vq_argmin": "main_path", "attn_hopper": "main_path", "dcn_fwd": "main_path",
         "dcn_cascade": "hybrid_path"}   # the path whose count a kernel's "launches" reports
ALL_PHASES = "device,build,kernels,main_path,hybrid_path,stage2_path"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=ALL_PHASES,
                    help="comma list; the last line is printed only when all of them ran")
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
    counts = {}
    if "main_path" in phases:
        counts["main_path"], model = phase_main_path()
        if args.profile:
            phase_profile(model)
        del model
        torch.cuda.empty_cache()
    if "hybrid_path" in phases:
        counts["hybrid_path"] = phase_hybrid_path()
        torch.cuda.empty_cache()
    if "stage2_path" in phases:
        counts["stage2_path"] = phase_stage2_path()
    if any(ph not in phases for ph in ALL_PHASES.split(",")):
        emit({"partial": True, "phases": phases, "seconds": round(time.time() - t_start, 1)})
        return
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "launches_by_path")
    for k in kernels:
        k["launches_by_path"] = {path: c[k["name"]] for path, c in counts.items()}
        k["launches"] = k["launches_by_path"][PATHS[k["name"]]]
        require(k["launches"] > 0, f"kernel {k['name']} was never launched on {PATHS[k['name']]}")
    extras = ("library_call", "smem_bytes", "earlier", "sdpa_by_backend")
    emit({"kernels": [{**{key: k[key] for key in keys}, **{key: k[key] for key in extras if key in k}}
                      for k in kernels]})
    emit({"seconds": round(time.time() - t_start, 1)})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
