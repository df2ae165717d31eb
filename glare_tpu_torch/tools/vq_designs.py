"""Times designs of the codebook-argmin kernel against each other on one card.

    python3 glare_tpu_torch/tools/vq_designs.py      # needs the GPU and nvcc

Each design is ``csrc/vq_argmin.cu`` with some of its text replaced (the
replaced text must occur in the source exactly once):
  shipped          the source as it is: 16 codebook slices a CTA (one per
                   warp), R = 4 tokens a lane, "min, then locate" over groups
                   of 8 codes (the group loop unrolled 4 times), in-block merge
  no_split         one warp a CTA walks the whole codebook (no slices)
  r1 / r8          R = 1 / 8 tokens a lane (r8: 256-token tiles, 64 CTAs at B = 1)
  warps_32         32 warps a CTA (32 slices of 256 codes, at most 64 registers:
                   ptxas spills)
  g4 / g16 / g32   groups of 4 / 16 / 32 codes for "min, then locate"
  no_unroll / unroll_8  the loop over groups not unrolled / unrolled 8 times
  compare_select   a compare and two selects per pair, no locate pass
  fold_e2          |e|^2 starts the FMA chain (3 FFMA a pair instead of FMUL,
                   2 FFMA and FADD): one instruction a pair less, but the
                   distances round apart from the plain version's GEMM
  cluster_2        2-CTA clusters of 8 warps (the same 16 slices): the CTAs of a
                   cluster split the codebook for one token tile and merge
                   through distributed shared memory
and probes, whose output is wrong on purpose and not checked:
  probe_no_compare the running minimum becomes a chain of FMAs: what the
                   distance arithmetic and the loop cost without the FMNMX
  probe_no_fma     one add instead of the three FMAs: what the FMNMX and the
                   loop cost
  probe_fixed      no group of codes is walked: what the launch, the staging,
                   the token loads and the merge cost
The first kernel (one token a thread, the augmented codebook
(-2e, |e|^2) made by torch ops beforehand, whole-codebook staging) is kept
below as source text and timed beside them, alone and with its glue (the
augmentation and the float32 copy of z its wrapper made). All are built with
the flags of ``ops/_build.py`` (one nvcc each, in parallel), checked (probes
excepted) against ``nearest_code_ref`` by the rule of ``chip_smoke.py``
(indices equal, or the two codes' float64 distances within 1e-6 relative) and
on exact ties across slices (the lowest index), and timed in turns (A, B, ...,
B, A) by their device time (``torch.profiler``, the mean of 20 launches) at
N = 16275 (stage 3, B = 1), 32550 (B = 2) and 15000 (stage 2) against K = 8192
codes of width 3. Beside
them, in the same call: the wrapper ``nearest_code_cuda`` and the plain
version (``chip_smoke.py`` times the library yardstick). Prints one JSON line
per N and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from glare_tpu_torch.ops import _build, vq  # noqa: E402

K, D = 8192, 3

_GROUP_LOOP = """      for (int r = 0; r < kR; ++r) {
        if (m[r] < best[r]) grp[r] = g;
        best[r] = m[r];
      }"""
_MIN = "for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], dist3(zr[r], w));"
_GROUPS = "    for (int g = 0; g < n_groups; ++g) {"
_UNROLL = "#pragma unroll 4   // lets ptxas run the next groups' shared-memory reads early\n"
_MERGE = """  __syncthreads();
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    if (t0 + t >= a.N) break;
    float v = part_v[t];
    int i = part_i[t];
    for (int w = 1; w < kWarps; ++w) {
      const float vw = part_v[w * kTile + t];
      if (vw < v) {
        v = vw;
        i = part_i[w * kTile + t];
      }
    }
    a.idx[t0 + t] = i;
  }"""
_LAUNCH = """  const int blocks = (a.N + kTile - 1) / kTile;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();"""

DESIGNS = {
    "shipped": [],
    "no_split": [("constexpr int kWarps = 16;", "constexpr int kWarps = 1;")],
    "r1": [("constexpr int kR = 4;", "constexpr int kR = 1;")],
    "r8": [("constexpr int kR = 4;", "constexpr int kR = 8;")],
    "warps_32": [("constexpr int kWarps = 16;", "constexpr int kWarps = 32;"),
                 ("constexpr int kChunk = 512;", "constexpr int kChunk = 256;")],
    "g4": [("constexpr int kG = 8;", "constexpr int kG = 4;")],
    "g16": [("constexpr int kG = 8;", "constexpr int kG = 16;")],
    "g32": [("constexpr int kG = 8;", "constexpr int kG = 32;")],
    "no_unroll": [(_UNROLL, "")],
    "unroll_8": [(_UNROLL, "#pragma unroll 8   // lets ptxas run the next groups' shared-memory reads early\n")],
    "compare_select": [
        ("""#pragma unroll
          for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], dist3(zr[r], w));""",
         """#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float d = dist3(zr[r], w);
            if (d < m[r]) {
              m[r] = d;
              arg[r] = c0 + g * kG + c;
            }
          }"""),
        (_GROUP_LOOP, """      for (int r = 0; r < kR; ++r) best[r] = m[r];"""),
    ],
    "fold_e2": [("""  float d = __fmul_rn(z[0], w.x);
  d = __fmaf_rn(z[1], w.y, d);
  d = __fmaf_rn(z[2], w.z, d);
  return __fadd_rn(d, w.w);""", """  float d = __fmaf_rn(z[0], w.x, w.w);
  d = __fmaf_rn(z[1], w.y, d);
  return __fmaf_rn(z[2], w.z, d);""")],
    "cluster_2": [
        ("#include <math.h>\n", "#include <math.h>\n#include <cooperative_groups.h>\nnamespace cg = cooperative_groups;\n"),
        ("constexpr int kWarps = 16;", "constexpr int kWarps = 8;\nconstexpr int kCluster = 2;"),
        ("  const int t0 = blockIdx.x * kTile;",
         "  cg::cluster_group cluster = cg::this_cluster();\n"
         "  const int rank = (int)cluster.block_rank();\n"
         "  const int t0 = (blockIdx.x / kCluster) * kTile;"),
        ("  const int k0 = warp * a.per,", "  const int k0 = (rank * kWarps + warp) * a.per,"),
        (_MERGE, """  cluster.sync();
  // CTA `rank` merges its share of the tile over the slices of both CTAs
  for (int t = rank * (kTile / kCluster) + threadIdx.x; t < (rank + 1) * (kTile / kCluster);
       t += kThreads) {
    if (t0 + t >= a.N) break;
    float v = INFINITY;
    int i = 0;
    for (int q = 0; q < kCluster; ++q) {
      const float* pv = cluster.map_shared_rank(part_v, q);
      const int* pi = cluster.map_shared_rank(part_i, q);
      for (int w = 0; w < kWarps; ++w) {
        const float vw = pv[w * kTile + t];
        if ((q == 0 && w == 0) || vw < v) {
          v = vw;
          i = pi[w * kTile + t];
        }
      }
    }
    a.idx[t0 + t] = i;
  }
  cluster.sync();   // the partner reads this CTA's partials until here"""),
        ("int per_slice(int K) { return ((K + kWarps - 1) / kWarps + kG - 1) / kG * kG; }",
         "int per_slice(int K) {\n  const int s = kWarps * kCluster;\n"
         "  return ((K + s - 1) / s + kG - 1) / kG * kG;\n}"),
        (_LAUNCH, """  const int blocks = (a.N + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();"""),
    ],
    # probes, not designs: the output is wrong on purpose
    "probe_no_compare": [(_MIN, "for (int r = 0; r < kR; ++r) m[r] = __fmaf_rn(zr[r][2], w.z, "
                                "__fmaf_rn(zr[r][1], w.y, __fmaf_rn(zr[r][0], w.x, m[r])));")],
    "probe_no_fma": [(_MIN, "for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], __fadd_rn(w.w, zr[r][0]));")],
    "probe_fixed": [(_GROUPS, "    for (int g = 0; g < 0; ++g) {")],
}

# The first kernel as it was shipped (entry vq_argmin_f32: float32 z, the augmented codebook).
FIRST_SOURCE = r"""#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmemBytes = 200 * 1024;

// DT > 0: D known at compile time (token kept in registers).
// DT == 0: generic D, token re-read from global memory (L1-resident).
template <int DT>
__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ w,
                 int* __restrict__ idx, int N, int D, int K, int tile_k) {
  extern __shared__ float sw[];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;
  const int d1 = D + 1;
  float zr[DT > 0 ? DT : 1];
  if (DT > 0) {
#pragma unroll
    for (int j = 0; j < DT; ++j) zr[j] = live ? z[(size_t)n * DT + j] : 0.f;
  }
  const float* zrow = z + (size_t)(live ? n : 0) * D;
  float best = INFINITY;
  int arg = 0;
  for (int k0 = 0; k0 < K; k0 += tile_k) {
    const int tk = min(tile_k, K - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < tk * d1; i += blockDim.x)
      sw[i] = w[(size_t)k0 * d1 + i];
    __syncthreads();
    for (int k = 0; k < tk; ++k) {
      const float* wk = sw + k * d1;
      float dist = wk[D];
      if (DT > 0) {
#pragma unroll
        for (int j = 0; j < DT; ++j) dist = fmaf(zr[j], wk[j], dist);
      } else {
        for (int j = 0; j < D; ++j) dist = fmaf(zrow[j], wk[j], dist);
      }
      if (dist < best) {
        best = dist;
        arg = k0 + k;
      }
    }
  }
  if (live) idx[n] = arg;
}

template <int DT>
cudaError_t launch(const float* z, const float* w, int* idx, int N, int D, int K,
                   cudaStream_t stream) {
  const int d1 = D + 1;
  int tile_k = kMaxSmemBytes / (d1 * (int)sizeof(float));
  if (tile_k > K) tile_k = K;
  if (tile_k < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_k * d1 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(vq_argmin_kernel<DT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + kThreads - 1) / kThreads;
  vq_argmin_kernel<DT><<<blocks, kThreads, smem, stream>>>(z, w, idx, N, D, K, tile_k);
  return cudaGetLastError();
}

}  // namespace

// z [N, D] f32, w [K, D+1] f32 = (-2 e, |e|^2), idx [N] int32.
extern "C" int vq_argmin_f32(const void* z, const void* w, void* idx, int N, int D, int K,
                             void* stream) {
  if (N <= 0) return 0;
  const float* zf = static_cast<const float*>(z);
  const float* wf = static_cast<const float*>(w);
  int* out = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 3: return (int)launch<3>(zf, wf, out, N, D, K, s);
    case 4: return (int)launch<4>(zf, wf, out, N, D, K, s);
    default: return (int)launch<0>(zf, wf, out, N, D, K, s);
  }
}
"""


def patched(name):
    text = open(os.path.join(_build.CSRC_DIR, "vq_argmin.cu")).read()
    for old, new in DESIGNS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"design {name}: the text to replace is not in the source once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_all(out_dir):
    sources = {name: patched(name) for name in DESIGNS}
    sources["first"] = FIRST_SOURCE
    procs = {}
    for name, text in sources.items():
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines() if "spill" in ln or "registers" in ln]
        print(json.dumps({"design": name, "ptxas": ptxas[:4]}), flush=True)
        lib = ctypes.CDLL(so)
        if name == "first":
            lib.vq_argmin_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.vq_argmin_f32.restype = ctypes.c_int
        else:
            ll, i = ctypes.c_longlong, ctypes.c_int
            lib.vq_argmin.argtypes = [ctypes.c_void_p, i, ll, ll, ctypes.c_void_p, ll, ll,
                                      ctypes.c_void_p, i, i, i, ctypes.c_void_p]
            lib.vq_argmin.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(name, lib, z, e, idx):
    """-> a function that launches design ``name`` once on (z, e) into idx."""
    stream = torch.cuda.current_stream().cuda_stream
    if name == "first":
        w = vq._augment(e)   # made once, outside the timed launches
        args = (z.data_ptr(), w.data_ptr(), idx.data_ptr(), z.shape[0], D, K, stream)
        return lambda w=w: lib.vq_argmin_f32(*args)
    args = (z.data_ptr(), 0, *z.stride(), e.data_ptr(), *e.stride(), idx.data_ptr(), z.shape[0], D, K,
            stream)
    return lambda: lib.vq_argmin(*args)


def device_ms(fn, reps=20):
    """Mean device time of the kernels ``fn`` launches, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
             if str(getattr(ev, "device_type", "")).endswith("CUDA"))
    return us / reps / 1e3


def one_call_ms(fn, reps=20):
    """Median of CUDA-event times around single calls (host work included)."""
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ts.append(t0.elapsed_time(t1))
    return sorted(ts)[len(ts) // 2]


def check(name, z, e, got, want):
    """Indices equal, or the two codes' float64 distances within 1e-6 relative:
    -> (differing indices, worst relative gap). Raises for the shipped source
    only; a design that breaks the rule is timed and reported as such."""
    z64, e64 = z.double(), e.double()
    dg = ((z64 - e64[got.long()]) ** 2).sum(1)
    dw = ((z64 - e64[want.long()]) ** 2).sum(1)
    rel = float(((dg - dw).abs() / dw.clamp_min(1e-30)).max())
    if rel > 1e-6 and name == "shipped":
        raise AssertionError(f"design {name}: a token picked a code {rel:.3e} (relative) farther")
    return int((got != want).sum()), rel


def main():
    if not torch.cuda.is_available():
        sys.exit("vq_designs.py measures on an NVIDIA GPU")
    out_dir = os.path.join(_build.build_dir(), "vq_designs")
    os.makedirs(out_dir, exist_ok=True)
    libs = build_all(out_dir)
    g = torch.Generator(device="cuda").manual_seed(0)
    e = (0.5 * torch.randn(K, D, device="cuda", generator=g)).contiguous()
    # exact ties across slices: every 256th code copies the one before it
    ed = e.clone()
    ed[256::256] = ed[255:-1:256]
    zd = ed[256::256].clone()
    for name, lib in libs.items():
        if name.startswith("probe_") or name == "first":
            continue
        idx = torch.empty(zd.shape[0], dtype=torch.int32, device="cuda")
        _build.check(launcher(name, lib, zd, ed, idx)(), name)
        torch.cuda.synchronize()
        want = torch.arange(255, K - 1, 256, device="cuda", dtype=torch.int32)
        if not torch.equal(idx, want):
            raise AssertionError(f"design {name}: exact ties across slices did not go to the lowest index")
        print(json.dumps({"design": name, "exact_ties_across_slices": "lowest index"}), flush=True)
    for n in (16275, 32550, 15000):
        z = (0.5 * torch.randn(n, D, device="cuda", generator=g)).contiguous()
        want = vq.nearest_code_ref(z, e)
        res = {}
        for name in list(libs) + list(libs)[::-1]:
            idx = torch.empty(n, dtype=torch.int32, device="cuda")
            fn = launcher(name, libs[name], z, e, idx)
            _build.check(fn(), name)
            torch.cuda.synchronize()
            mism, rel = (None, None) if name.startswith("probe_") else check(name, z, e, idx, want)
            res.setdefault(name, []).append({"ms": device_ms(fn), "mismatches": mism, "worst_rel_gap": rel})

        def first_wrapper():   # what the first kernel's wrapper did around it
            zz, w, out = z.float().contiguous(), vq._augment(e), torch.empty(n, dtype=torch.int32, device="cuda")
            _build.check(libs["first"].vq_argmin_f32(zz.data_ptr(), w.data_ptr(), out.data_ptr(), n, D, K,
                                                   torch.cuda.current_stream().cuda_stream), "first")
            return out

        others = {"wrapper_ms": one_call_ms(lambda: vq.nearest_code_cuda(z, e)),
                  "first_wrapper_ms": one_call_ms(first_wrapper),
                  "plain_ms": one_call_ms(lambda: vq.nearest_code_ref(z, e), reps=5),
                  "bound_ms": 2.0 * n * K * (D + 1) / 67e12 * 1e3}
        print(json.dumps({"n": n, "k": K, "d": D, "designs": res, **others}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)


if __name__ == "__main__":
    main()
