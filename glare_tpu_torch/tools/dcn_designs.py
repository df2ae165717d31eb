"""Times designs of the Hopper DCN kernel against each other on one card.

    python3 glare_tpu_torch/tools/dcn_designs.py      # needs the GPU and nvcc

Each design is ``csrc/dcn_hopper.cu`` with some of its text replaced (the
replaced text must occur in the source exactly once):
  shipped          the source as it is
  per_item_sampler every row of a chunk takes the per-corner path (a branch per
                   row and per corner; the first version of the sampler)
  per_lane_geometry every lane loads the offsets of, and computes the sampling
                   geometry for, all four of its rows (the shipped kernel has
                   one lane of each 4-lane cluster do one row, and shuffles)
  no_halo          no staged halo: every corner is gathered from global memory
  tile_4x32        output tiles of 4 x 32 pixels
  tile_16x8        output tiles of 16 x 8 pixels
  nws_3            three weight stages instead of two
  cluster_2        CTA pairs: each loads half of every weight chunk and
                   multicasts it to both (TMA multicast in a 2-CTA cluster)
and probes, whose output is wrong on purpose and not checked:
  probe_no_gather  no corner is loaded or summed and no A row is written: what
                   the rest of the kernel costs
  probe_no_mma     no wgmma is issued: what the sampling costs alone
The first kernel (``csrc/dcn_fwd.cu``, entry ``wmma``) is timed beside them.
All are built with the flags of ``ops/_build.py`` (one nvcc each, in
parallel), checked (probes excepted) against ``modulated_deform_conv_ref``
within 2^-7 of the largest output, the `pallas` counter exact, and timed by
CUDA events in turns (A, B, ..., B, A) at the two shapes one request gives the
kernel (warp_0 [B,210,310,256] -> 256, warp_1 [B,420,620,128] -> 128, G 4,
clamp 2), B = 1 and 2. Prints one JSON line per shape and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from glare_tpu_torch.ops import _build, dcn  # noqa: E402

_FAST = "        if (fast) {"
_WGMMA = "            wgmma_m64n128(acc[nh], "

# no_halo: no halo is staged or waited for; every corner takes the global path
NO_HALO = [
    ("constexpr int HALO_BYTES = HALO_H * HALO_W * CB * 2;", "constexpr int HALO_BYTES = 0;"),
    ("    } else if (ltid == 32) {", "    } else if (false) {"),
    ("        if (k == 0) mbar_wait(h_full(hc & 1), (hc >> 1) & 1);\n", ""),
    ("          const bool staged = iy >= 0", "          const bool staged = false && iy >= 0"),
    (_FAST, "        if (false) {"),
    ("              if (sy >= 0 && sy < HALO_H", "              if (false && sy >= 0 && sy < HALO_H"),
]

# per_lane_geometry: every lane loads and computes all four rows
_SHARED_GEOMETRY = r"""        {
          float w4[4];
          int gy, gx, ho;
          // one lane per (pixel, group) counts: the first cluster of the group's channels
          const bool counts = count != nullptr && (cb * CB + (sub & 4) * 8) % d.Cg == 0;
          geometry(cur, sub & 3, w4, gy, gx, ho, counts);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int src = (lane & ~3) | i;
#pragma unroll
            for (int e = 0; e < 4; ++e) cw[i][e] = __shfl_sync(0xffffffffu, w4[e], src);
            cy[i] = __shfl_sync(0xffffffffu, gy, src);
            cx[i] = __shfl_sync(0xffffffffu, gx, src);
            hoff[i] = __shfl_sync(0xffffffffu, ho, src);
            mk[i] = __shfl_sync(0xffffffffu, cur.z, src);
          }
        }
"""
PER_LANE_GEOMETRY = [
    ("      float4 nxt = load_param(sub & 3, 0);", r"""      float4 nxt[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) nxt[n] = load_param(n, 0);"""),
    ("""        const float4 cur = nxt;
        if (j + 1 < nq) nxt = load_param(sub & 3, j + 1);""", r"""        float4 cur[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) cur[n] = nxt[n];
        if (j + 1 < nq) {
#pragma unroll
          for (int n = 0; n < 4; ++n) nxt[n] = load_param(n, j + 1);
        }"""),
    (_SHARED_GEOMETRY, r"""        {
          const bool counts = count != nullptr && c % d.Cg == 0;  // one lane per (pixel, group)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            geometry(cur[i], i, cw[i], cy[i], cx[i], hoff[i], counts);
            mk[i] = cur[i].z;
          }
        }
"""),
]

# cluster_2: CTA pairs (rank 0, 1) walk neighbouring tiles; each loads the
# even or the odd 64-output boxes of a weight chunk and multicasts them to
# both; a stage is free when the worker warps of both CTAs released it. A CTA
# whose tile lies past the end runs its pair's tile moved below the image, so
# both take the same chunks and nothing of the dead tile is stored or counted.
_CLUSTER_PRIMITIVES = r"""// arrive on the barrier at the same shared offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_rank(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                      int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

"""
_NAMED_BAR = "__device__ __forceinline__ void named_bar_sync(int id, int count) {"
CLUSTER_2 = [
    (_NAMED_BAR, _CLUSTER_PRIMITIVES + _NAMED_BAR),
    ("      mbar_init(w_empty(s), 8);", "      mbar_init(w_empty(s), 16);  // the worker warps of both CTAs"),
    ("""  __syncthreads();

  if (wg == 2) {""", """  __syncthreads();
  cluster_sync();  // the other CTA's barriers exist before any multicast
  const int rank = (int)cluster_rank();

  if (wg == 2) {"""),
    ("""      for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
        for (int j = 0; j < nq; ++j, ++wc) {""",
     """      for (int tile = blockIdx.x; tile - rank < d.n_tiles; tile += gridDim.x) {
        for (int j = 0; j < nq; ++j, ++wc) {"""),
    ("""          for (int nb = 0; nb < 2 * NH; ++nb)
            tma_load_2d(sW + s * WB + nb * 8192, &tmw, w_full(s), nb * 64, row);
        }
      }
""", """          for (int nb = 0; nb < 2 * NH; ++nb)
            if ((nb & 1) == rank)
              tma_load_2d_multicast(sW + s * WB + nb * 8192, &tmw, w_full(s), nb * 64, row, 3);
        }
      }
      // every stage released by both CTAs: no remote arrive lands after exit
      for (int i = 0; i < NWS; ++i, ++wc) mbar_wait(w_empty(wc % NWS), ((wc / NWS) & 1) ^ 1);
"""),
    ("""      for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
        const int b""", """      for (int t2 = blockIdx.x; t2 - rank < d.n_tiles; t2 += gridDim.x) {
        const int tile = t2 < d.n_tiles ? t2 : t2 - rank;
        const int b"""),
    ("      if (lane == 0) mbar_arrive(w_empty(s));", """      if (lane == 0) {
        mbar_arrive_rank(w_empty(s), 0);
        mbar_arrive_rank(w_empty(s), 1);
      }"""),
    ("""    for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
      const int b = tile / d.tiles_per_img, rem = tile - b * d.tiles_per_img;
      const int ty0 = (rem / d.tiles_x) * TH, tx0""",
     """    for (int t2 = blockIdx.x; t2 - rank < d.n_tiles; t2 += gridDim.x) {
      const int tile = t2 < d.n_tiles ? t2 : t2 - rank;
      const int b = tile / d.tiles_per_img, rem = tile - b * d.tiles_per_img;
      const int ty0 = (rem / d.tiles_x) * TH + (t2 < d.n_tiles ? 0 : d.H), tx0"""),
    ("""  const int grid = d.n_tiles < n_sm ? d.n_tiles : n_sm;
  kernel<<<grid, NT, smem, s>>>(tmx, tmw, xb, of, mf, bf, rf, ob, cp, d);
""", """  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(n_sm / 2 * 2);
  int n_pairs = 0;
  e = cudaOccupancyMaxActiveClusters(&n_pairs, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n_pairs < 1) return (int)cudaErrorInvalidConfiguration;
  const int pairs = (d.n_tiles + 1) / 2 < n_pairs ? (d.n_tiles + 1) / 2 : n_pairs;
  cfg.gridDim = dim3(2 * pairs);
  e = cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, xb, of, mf, bf, rf, ob, cp, d);
  if (e != cudaSuccess) return (int)e;
"""),
]

DESIGNS = {
    "shipped": [],
    "per_item_sampler": [(_FAST, "        if (false) {")],
    "per_lane_geometry": PER_LANE_GEOMETRY,
    "no_halo": NO_HALO,
    "tile_4x32": [("constexpr int TH = 8; ", "constexpr int TH = 4; "),
                  ("constexpr int TW = 16; ", "constexpr int TW = 32; ")],
    "tile_16x8": [("constexpr int TH = 8; ", "constexpr int TH = 16; "),
                  ("constexpr int TW = 16; ", "constexpr int TW = 8; ")],
    "nws_3": [("constexpr int NWS = 2; ", "constexpr int NWS = 3; ")],
    "cluster_2": CLUSTER_2,
    "probe_no_gather": [(_FAST, "        if (true) {\n        } else if (fast) {")],
    "probe_no_mma": [(_WGMMA, "            if (false) wgmma_m64n128(acc[nh], ")],
}

SHAPES = [("warp_0", 210, 310, 256, 256), ("warp_1", 420, 620, 128, 128)]


def build_all(out_dir):
    src = open(os.path.join(_build.CSRC_DIR, "dcn_hopper.cu")).read()
    procs = {}
    for name, edits in DESIGNS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"design {name}: the text to replace is not in the source once: {old!r}")
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
            raise RuntimeError(f"nvcc failed for design {name}:\n{log[-4000:]}")
        report = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln or "registers" in ln or "C7515" in ln]
        print(json.dumps({"design": name, "ptxas": report}), flush=True)
        fn = ctypes.CDLL(so).dcn_hopper_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        sys.exit("dcn_designs.py measures on an NVIDIA GPU")
    out_dir = os.path.join(_build.build_dir(), "dcn_designs")
    os.makedirs(out_dir, exist_ok=True)
    fns = build_all(out_dir)
    G = 4
    for (wname, H, W, C, O) in SHAPES:
        for B in (1, 2):
            g = torch.Generator(device="cuda").manual_seed(B * 7 + C)
            x = torch.randn(B, H, W, C, device="cuda", generator=g).to(torch.bfloat16)
            off = 1.5 * torch.randn(B, H, W, G, 9, 2, device="cuda", generator=g)
            mask = torch.rand(B, H, W, G, 9, device="cuda", generator=g)
            wgt = torch.randn(3, 3, C, O, device="cuda", generator=g) / math.sqrt(9 * C)
            bias = 0.1 * torch.randn(O, device="cuda", generator=g)
            want, wov = dcn.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=2,
                                                      return_overflow=True)
            want = want.float()
            tol = 2.0 ** -7 * max(1.0, float(want.abs().max()))
            w2 = wgt.reshape(9 * C, O).to(torch.bfloat16).contiguous()
            radii = dcn.clamp_table(2, G).cuda()
            flops = 2.0 * B * H * W * 9 * C * O
            calls = {}
            for name, fn in fns.items():
                out = torch.empty(B, H, W, O, device="cuda", dtype=torch.bfloat16)
                count = torch.zeros(2, dtype=torch.int64, device="cuda")

                def call(fn=fn, out=out, count=count, name=name):
                    err = fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(), w2.data_ptr(), bias.data_ptr(),
                             radii.data_ptr(), out.data_ptr(), count[1:].data_ptr(), B, H, W, C, O, G,
                             torch.cuda.current_stream().cuda_stream)
                    _build.check(err, name)

                calls[name] = (call, out, count)
            calls["first_kernel_wmma"] = (lambda: dcn.modulated_deform_conv_cuda(
                x, off, mask, wgt, bias, max_offset=2, entry="wmma"), None, None)
            res = {}
            order = list(calls) + list(calls)[::-1]
            for name in order:
                call, out, count = calls[name]
                if count is not None:
                    count.zero_()
                    call()
                    torch.cuda.synchronize()
                    err = float((out.float() - want).abs().max())
                    if not name.startswith("probe_") and (err > tol or count.tolist() != wov.tolist()):
                        raise AssertionError(f"design {name}, {wname} B={B}: error {err} (tol {tol}), "
                                             f"counter {count.tolist()} (plain {wov.tolist()})")
                for _ in range(3):
                    call()
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(20):
                    call()
                t1.record()
                torch.cuda.synchronize()
                ms = t0.elapsed_time(t1) / 20
                res.setdefault(name, []).append({"ms": ms, "tflops": flops / ms / 1e9})
            print(json.dumps({"shape": wname, "batch": B, "x": [B, H, W, C], "O": O, "tol": tol,
                              "designs": res}), flush=True)
            del x, off, mask, wgt, bias, want, calls
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)


if __name__ == "__main__":
    main()
