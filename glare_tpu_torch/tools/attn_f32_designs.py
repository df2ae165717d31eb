"""Times designs of the float32 attention entry against each other on one card.

    python3 glare_tpu_torch/tools/attn_f32_designs.py      # needs the GPU and nvcc

Each design is ``csrc/attn_fused.cu`` with a few lines replaced (the float32
entry ``attn_fused_f32``; the bf16 kernel in the same file is untouched):
  shipped         the source as it is: 256 threads, K chunks of 128 channels, V
                  chunks of 16 keys, a 2-stage ring of cp.async.cg copies (10
                  block barriers a key tile)
  cp_async_ca     the copies kept in L1 (cp.async.ca)
  v_chunk_8       V chunks of 8 keys (14 barriers a key tile)
  k64_v8_s3       K chunks of 64 channels, V chunks of 8 keys, 3 stages (18
                  barriers a key tile; the first design's chunking)
  threads_512     512 threads (16 warps at 128 registers: O split over two
                  warps a row block, S in 4 x 2 blocks)
  queries_32      32 queries a CTA, two CTAs an SM (128 registers), K chunks
                  of 64 channels, V chunks of 8 keys: twice the K/V traffic
  key_tile_128    128-key tiles (S in 4 x 8 blocks), K chunks of 32 channels,
                  V chunks of 8 keys
and probes, whose output is wrong on purpose and not checked:
  probe_no_loads  no chunk copies (the products read stale shared memory)
  probe_no_s      no S products (scores 0): what the PV half and the rest cost
  probe_no_pv     no PV products: what the S half and the rest cost
A design whose shared memory does not fit (a static_assert) or whose build
fails is reported and not timed.
All are built with the flags of ``ops/_build.py`` (one nvcc each, in parallel),
checked (probes excepted) against ``flash_attention_nhc_ref`` at
[1, 16384, 512] float32, n_true 16275, within 5e-5, and timed by CUDA events in
turns (A, B, ..., B, A). Prints one JSON line and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
import glare_tpu_torch  # noqa: E402,F401  (sets the TF32 switches: float32 means float32)
from glare_tpu_torch.ops import _build, attn  # noqa: E402

_S_FMA = """            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);"""
_PV_FMA = """            acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);"""
_K64 = ("constexpr int FCC = 128;", "constexpr int FCC = 64;")
_V8 = ("constexpr int FVK = 16;", "constexpr int FVK = 8;")
_S3 = ("constexpr int FSTAGES = 2;", "constexpr int FSTAGES = 3;")
_T512 = ("constexpr int FT = 256;", "constexpr int FT = 512;")
_CA = ('asm volatile("cp.async.cg.shared.global', 'asm volatile("cp.async.ca.shared.global')

DESIGNS = {
    "shipped": [],
    "cp_async_ca": [_CA],
    "v_chunk_8": [_V8],
    "k64_v8_s3": [_K64, _V8, _S3],
    "threads_512": [_T512],
    "queries_32": [("constexpr int FQ = 64;", "constexpr int FQ = 32;"),
                   ("constexpr int FCTAS = 1;", "constexpr int FCTAS = 2;"), _K64, _V8],
    "key_tile_128": [("constexpr int FKT = 64;", "constexpr int FKT = 128;"),
                     ("constexpr int FCC = 128;", "constexpr int FCC = 32;"), _V8],
    "probe_no_loads": [("    if (t < total) {\n      const int kt", "    if (t < 0) {\n      const int kt")],
    "probe_no_s": [(_S_FMA, "            (void)qv, (void)kv;")],
    "probe_no_pv": [(_PV_FMA, "            (void)pr, (void)vv;")],
}


def build_all(out_dir):
    src = open(os.path.join(_build.CSRC_DIR, "attn_fused.cu")).read()
    procs = {}
    for name, edits in DESIGNS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"design {name}: the text to replace is not in the source once")
            text = text.replace(old, new)
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:   # e.g. a layout beyond the shared memory: reported, not timed
            print(json.dumps({"design": name, "nvcc_failed": log[-600:]}), flush=True)
            continue
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln or "registers" in ln]
        print(json.dumps({"design": name, "ptxas": spills}), flush=True)
        fn = ctypes.CDLL(so).attn_fused_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("attn_f32_designs.py measures on an NVIDIA GPU")
    out_dir = os.path.join(_build.build_dir(), "attn_f32_designs")
    os.makedirs(out_dir, exist_ok=True)
    fns = build_all(out_dir)
    b, n, n_true = 1, 16384, 16275
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = [torch.randn(b, n, 512, device="cuda", generator=g) for _ in range(3)]
    qs = attn._scale_q(q).contiguous()
    want = attn.flash_attention_nhc_ref(q, k, v, n_true=n_true)[:, :n_true]
    tol = 5e-5
    res = {}
    for name in list(fns) + list(fns)[::-1]:
        out = torch.empty_like(qs)

        def call():
            err = fns[name](qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n_true,
                            512, torch.cuda.current_stream().cuda_stream)
            _build.check(err, name)

        call()
        torch.cuda.synchronize()
        err = float((out[:, :n_true] - want).abs().max())
        if err > tol and not name.startswith("probe_"):
            raise AssertionError(f"design {name}: {err} > {tol}")
        call()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            call()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 5
        res.setdefault(name, []).append({"ms": ms, "tflops": 4.0 * b * n_true ** 2 * 512 / ms / 1e9,
                                         "max_abs_err": err})
    print(json.dumps({"shape": [b, n, 512], "n_true": n_true, "tol": tol, "designs": res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)


if __name__ == "__main__":
    main()
