"""Times designs of the Hopper attention kernel against each other on one card.

    python3 glare_tpu_torch/tools/attn_designs.py      # needs the GPU and nvcc

Each design is ``csrc/attn_hopper.cu`` with a few lines replaced:
  shipped         the source as it is
  always_scale    every warp rescales the accumulator at every key step, also
                  when every correction is exactly 1
  full_s          each consumer computes S over all 512 channels (1.5x the
                  tensor work of S, no exchange and no barrier between the two)
  s_before_scale  S_{j+1} is issued before the accumulator is rescaled, so the
                  tensor cores work during the rescale
  fa3_order       FlashAttention-3's order: issue S_j, rescale by step j-1's
                  correction, issue PV_{j-1}
  vec_exchange    the S halves are exchanged with 16-byte stores and loads
and probes, whose output is wrong on purpose and not checked:
  probe_half_loads  K and V loaded on half the key steps only: what the K/V
                  stream from L2 costs
All are built with the flags of ``ops/_build.py`` (one nvcc each, in parallel),
checked (probes excepted) against ``flash_attention_nhc_ref`` at
[B, 16384, 512], n_true 16275, within 2^-7 of the largest output, and timed by
CUDA events in turns (A, B, ..., B, A) at B = 1 and 2. Prints one JSON line per batch size and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from glare_tpu_torch.ops import _build, attn  # noqa: E402

_LOOP_HEAD = """    pack_p();

    for (int j = 1; j < n_kt; ++j) {
      mbar_wait(k_full(j & 1), (j >> 1) & 1);
      mbar_wait(v_full((j - 1) & 1), ((j - 1) >> 1) & 1);
      wg_fence();
      issue_s(j);
      issue_pv(j - 1);"""
_RESCALE = """      if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      }"""
_LOOP_TAIL = """      release(v_empty((j - 1) & 1));
      // where the running max moved in none of the warp's rows, every
      // correction is exactly 1: the rescale would change no bit
""" + _RESCALE + """
      pack_p();
    }
    const int jl = n_kt - 1;"""
_EXCHANGE = """      for (int i = 0; i < 16; ++i) mine[i * 128 + ltid] = s[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += theirs[i * 128 + ltid];"""

DESIGNS = {
    "shipped": [],
    "always_scale": [(_RESCALE, """#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;""")],
    "full_s": [
        ("for (int kk = 0; kk < 16; ++kk) {", "for (int kk = 0; kk < 32; ++kk) {"),
        ("const int chunk = cw * 4 + (kk >> 2);", "const int chunk = kk >> 2;"),
        (_EXCHANGE, "      (void)mine, (void)theirs;"),
    ],
    "s_before_scale": [
        (_LOOP_HEAD, """    pack_p();
    if (n_kt > 1) {
      mbar_wait(k_full(1), 0);
      wg_fence();
      issue_s(1);
    }

    for (int j = 1; j < n_kt; ++j) {
      mbar_wait(v_full((j - 1) & 1), ((j - 1) >> 1) & 1);
      wg_fence();
      issue_pv(j - 1);"""),
        (_LOOP_TAIL, """      release(v_empty((j - 1) & 1));
      pack_p();
      if (j + 1 < n_kt) {
        mbar_wait(k_full((j + 1) & 1), ((j + 1) >> 1) & 1);
        wg_fence();
        issue_s(j + 1);
      }
""" + _RESCALE + """
    }
    const int jl = n_kt - 1;"""),
    ],
    "fa3_order": [
        (_LOOP_HEAD, """    pack_p();
    corr0 = corr1 = 1.f;

    for (int j = 1; j < n_kt; ++j) {
      mbar_wait(k_full(j & 1), (j >> 1) & 1);
      wg_fence();
      issue_s(j);
""" + _RESCALE + """
      mbar_wait(v_full((j - 1) & 1), ((j - 1) >> 1) & 1);
      wg_fence();
      issue_pv(j - 1);"""),
        (_LOOP_TAIL, """      release(v_empty((j - 1) & 1));
      pack_p();
    }
    const int jl = n_kt - 1;
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;"""),
    ],
    # a probe, not a design: K and V are loaded on half the steps only (the other
    # half reuse what the stage holds), so the output is wrong on purpose; its
    # time says what the K/V stream from L2 costs
    "probe_half_loads": [
        ("""        mbar_expect_tx(k_full(s), KV_BYTES);
        for (int c = 0; c < NCHUNK; ++c)
          tma_load(sK + s * KV_BYTES + c * KV_CHUNK, &tk, k_full(s), c * CH, j * BK, b);""",
         """        if (j & 2) {
          mbar_arrive(k_full(s));
        } else {
          mbar_expect_tx(k_full(s), KV_BYTES);
          for (int c = 0; c < NCHUNK; ++c)
            tma_load(sK + s * KV_BYTES + c * KV_CHUNK, &tk, k_full(s), c * CH, j * BK, b);
        }"""),
        ("""        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int c = 0; c < NCHUNK; ++c)
          tma_load(sV + s * KV_BYTES + c * KV_CHUNK, &tv, v_full(s), c * CH, j * BK, b);""",
         """        if (j & 2) {
          mbar_arrive(v_full(s));
        } else {
          mbar_expect_tx(v_full(s), KV_BYTES);
          for (int c = 0; c < NCHUNK; ++c)
            tma_load(sV + s * KV_BYTES + c * KV_CHUNK, &tv, v_full(s), c * CH, j * BK, b);
        }"""),
    ],
    "vec_exchange": [
        (_EXCHANGE, """      for (int i = 0; i < 4; ++i)
        reinterpret_cast<float4*>(mine)[i * 128 + ltid] =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = reinterpret_cast<const float4*>(theirs)[i * 128 + ltid];
        s[4 * i] += t.x;
        s[4 * i + 1] += t.y;
        s[4 * i + 2] += t.z;
        s[4 * i + 3] += t.w;
      }"""),
    ],
}


def build_all(out_dir):
    src = open(os.path.join(_build.CSRC_DIR, "attn_hopper.cu")).read()
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
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln or "registers" in ln]
        print(json.dumps({"design": name, "ptxas": spills}), flush=True)
        fn = ctypes.CDLL(so).attn_hopper_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("attn_designs.py measures on an NVIDIA GPU")
    out_dir = os.path.join(_build.build_dir(), "attn_designs")
    os.makedirs(out_dir, exist_ok=True)
    fns = build_all(out_dir)
    n, n_true = 16384, 16275
    for b in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(b)
        q, k, v = [torch.randn(b, n, 512, device="cuda", generator=g).to(torch.bfloat16) for _ in range(3)]
        qs = attn._scale_q(q).contiguous()
        want = attn.flash_attention_nhc_ref(q, k, v, n_true=n_true)[:, :n_true].float()
        tol = 2.0 ** -7 * float(want.abs().max())
        res = {}
        for name in list(fns) + list(fns)[::-1]:
            out = torch.empty_like(qs)

            def call():
                err = fns[name](qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n_true,
                                512, torch.cuda.current_stream().cuda_stream)
                _build.check(err, name)

            call()
            torch.cuda.synchronize()
            err = float((out[:, :n_true].float() - want).abs().max())
            if err > tol and not name.startswith("probe_"):
                raise AssertionError(f"design {name}, B={b}: {err} > {tol}")
            for _ in range(3):
                call()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                call()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / 20
            res.setdefault(name, []).append({"ms": ms, "tflops": 4.0 * b * n_true ** 2 * 512 / ms / 1e9,
                                             "max_abs_err": err, "tol": tol})
        print(json.dumps({"batch": b, "shape": [b, n, 512], "n_true": n_true, "designs": res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)


if __name__ == "__main__":
    main()
