// Codebook retrieval for Hopper: per token, argmin over the codebook of
// |e|^2 - 2 z.e, ties to the lowest code index.
//
// Replaces the Pallas kernel `_vq_kernel` (glare_tpu/ops/vq.py, entry
// `nearest_code_pallas`). Like it, the [N, K] distance matrix never reaches
// device memory and the |z|^2 term (constant per token) is dropped.
//
// What bounds it on an H100: operations. A (token, code) pair costs D + 1
// float32 multiply-adds, and at the GLARE shape (D = 3, K = 8192, 16,275
// tokens a request) that is 133 M pairs against a few hundred KB of traffic.
// The floor is the rate at which the schedulers dispatch instructions: FMUL,
// 2 FFMA, FADD and FMNMX a pair (below), 5 warp instructions per 32 pairs,
// 132 SMs x 4 schedulers.
//
// The distances are those of the plain version bit for bit: [z, 1] .
// [-2e, |e|^2] summed as the float32 GEMM does (products first, |e|^2 last),
// with |e|^2 summed as its (e * e).sum(dim=1) does on the card, which
// chip_smoke.py holds it to (another order in a later torch would show there
// as indices that differ on near-ties). Folding |e|^2 into the first
// FMA would save one instruction a pair (`fold_e2` in tools/vq_designs.py),
// but near-ties would then round apart from the plain version and flip
// indices by more than the 1e-6 relative the kernel is held to.
//
// Why no tensor cores: the product has depth D + 1 = 4, one k-step of an MMA
// that produces 8192 distances a token only to reduce them to one index, and
// float32 operands would enter the tensor cores as TF32 (10-bit mantissa).
// The plain version and the JAX package compute in float32 (HIGHEST); TF32
// would move indices wherever two codes lie within ~1e-3 relative, far
// outside the near-tie rule the kernel is held to. So the kernel runs on the
// FMA units, and its design is about keeping them issuing:
//   * Fill the card. A CTA owns a tile of kTile = 32 * kR tokens and all K
//     codes; its kWarps warps split the codebook into kWarps slices of
//     `per` codes (warp w walks slice w for the CTA's whole token tile), so
//     the 16,275 tokens of one request give 128 CTAs of 16 warps: 16 warps
//     on each of 128 SMs.
//   * Reuse every shared-memory read. Each lane holds kR = 4 tokens in
//     registers; one broadcast 16-byte read of a staged code (-2e, |e|^2)
//     feeds four tokens, and the four chains are independent.
//   * Min, then locate. The inner loop keeps only a running minimum per
//     token (fminf: no index work, one FMNMX a pair). After each
//     group of kG codes, a token whose minimum went strictly down records
//     the group. At the end of a staged chunk, each such token recomputes
//     its one group with the same __f*_rn calls in the same order and
//     takes the first code whose distance equals the minimum: bit-exact,
//     and the lowest index, since a later group must be strictly smaller
//     to replace an earlier one.
//   * No host glue. Each warp stages its own slice from the raw [K, D]
//     float32 codebook (any strides), computing -2e (exact) and
//     |e|^2 on the way; a lane starts all its loads of a chunk before it
//     uses one. Tokens are read in the caller's dtype and strides. Only
//     warp-level barriers guard the staging, so one warp's staging overlaps
//     the others' work.
//   * An exact merge in one launch. Each warp leaves (minimum, index) per
//     token in shared memory; after one CTA barrier, a thread per token
//     merges the kWarps slices in ascending order with a strict `<`:
//     smaller value first, then the lower slice, i.e. the lower index.
//     An exact tie between codes of two slices goes to the lowest index.
//     (Two CTAs of a cluster splitting the codebook and merging through
//     distributed shared memory measured no faster: `cluster_2` in
//     tools/vq_designs.py.)
//
// NaN: fminf skips a NaN distance, so a NaN never wins while any distance is
// a number; a token with no distance below +inf (a NaN or infinite token, or
// an overflowing code) gets index 0. torch.argmin instead returns the index
// of the first NaN.
//
// D = 3 (the GLARE codebook) keeps the token in registers and reads staged
// codes as float4; any other D reads the token and the raw codebook from
// global memory (L1-resident) in the same order of operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 16;           // codebook slices per CTA, one per warp
constexpr int kR = 4;                // tokens per lane
constexpr int kG = 8;                // codes per group of "min, then locate"
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32 * kR;       // tokens per CTA
constexpr int kChunk = 512;          // codes a warp stages at a time (8 KB at D = 3)
constexpr int kSmemBytes = kWarps * kChunk * 16 + kWarps * kTile * 8;

struct Args {
  const void* z;
  long long zs_n, zs_d;   // token strides, in elements
  const float* e;
  long long es_k, es_d;   // codebook strides, in elements
  int* idx;
  int N, D, K;
  int per;                // codes per slice, a multiple of kG
};

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// |e|^2 of a 3-wide code, summed as the plain version's (e * e).sum(dim=1) on
// the card: squares rounded, (e0^2 + e2^2) + e1^2
__device__ __forceinline__ float norm3(const float (&e)[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(e[0], e[0]), __fmul_rn(e[2], e[2])), __fmul_rn(e[1], e[1]));
}

// [z, 1] . [-2e, |e|^2] in the plain version's order (the FFMA chain of a
// float32 GEMM over k = 0..D): the products first, |e|^2 last
__device__ __forceinline__ float dist3(const float (&z)[3], const float4 w) {
  float d = __fmul_rn(z[0], w.x);
  d = __fmaf_rn(z[1], w.y, d);
  d = __fmaf_rn(z[2], w.z, d);
  return __fadd_rn(d, w.w);
}

// any D: token and code read from global memory; the products in dist3's
// order, |e|^2 in index order
template <typename ZT>
__device__ __forceinline__ float dist_any(const ZT* z, long long zs_d, const float* e, long long es_d,
                                          int D) {
  float s = 0.f, d = 0.f;   // |e|^2 in index order
  for (int j = 0; j < D; ++j) {
    const float ej = ldf(e + j * es_d);
    s = __fadd_rn(s, __fmul_rn(ej, ej));
    d = __fmaf_rn(ldf(z + j * zs_d), -2.f * ej, d);
  }
  return __fadd_rn(d, s);
}

template <typename ZT, bool D3>
__global__ void __launch_bounds__(kThreads, 1) vq_argmin_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* sw = reinterpret_cast<float4*>(smem) + warp * kChunk;
  float* part_v = reinterpret_cast<float*>(smem + (D3 ? kWarps * kChunk * 16 : 0));
  int* part_i = reinterpret_cast<int*>(part_v + kWarps * kTile);
  const ZT* z = static_cast<const ZT*>(a.z);
  const float* e = a.e;

  const int t0 = blockIdx.x * kTile;
  const ZT* zp[kR];   // a lane past N walks token N - 1 and stores nothing
  float zr[kR][3];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    zp[r] = z + (long long)min(t0 + r * 32 + lane, a.N - 1) * a.zs_n;
    if constexpr (D3) {
#pragma unroll
      for (int j = 0; j < 3; ++j) zr[r][j] = ldf(zp[r] + j * a.zs_d);
    }
  }

  const int k0 = warp * a.per, k1 = min(k0 + a.per, a.K);
  float best[kR];
  int arg[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    best[r] = INFINITY;
    arg[r] = 0;
  }
  for (int c0 = k0; c0 < k1; c0 += kChunk) {
    const int n_codes = min(kChunk, k1 - c0);
    const int n_groups = (n_codes + kG - 1) / kG;
    if constexpr (D3) {   // stage (-2e, |e|^2); every load of the lane starts first
      constexpr int kPerLane = kChunk / 32;
      float ev[kPerLane][3];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const float* p = e + (long long)(c0 + min(lane + 32 * i, n_codes - 1)) * a.es_k;
#pragma unroll
        for (int j = 0; j < 3; ++j) ev[i][j] = ldf(p + j * a.es_d);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < n_codes)
          sw[c] = make_float4(-2.f * ev[i][0], -2.f * ev[i][1], -2.f * ev[i][2], norm3(ev[i]));
        else if (c < n_groups * kG)
          sw[c] = make_float4(0.f, 0.f, 0.f, INFINITY);   // padding: never below a distance
      }
      __syncwarp();
    }
    auto dist = [&](int r, int c) -> float {   // token r, code c of this chunk
      if constexpr (D3) {
        return dist3(zr[r], sw[c]);
      } else {
        if (c >= n_codes) return INFINITY;
        return dist_any(zp[r], a.zs_d, e + (long long)(c0 + c) * a.es_k, a.es_d, a.D);
      }
    };
    int grp[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) grp[r] = -1;
#pragma unroll 4   // lets ptxas run the next groups' shared-memory reads early
    for (int g = 0; g < n_groups; ++g) {
      float m[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) m[r] = best[r];
#pragma unroll
      for (int c = 0; c < kG; ++c) {
        if constexpr (D3) {   // one broadcast read feeds the kR tokens
          const float4 w = sw[g * kG + c];
#pragma unroll
          for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], dist3(zr[r], w));
        } else {
#pragma unroll
          for (int r = 0; r < kR; ++r) m[r] = fminf(m[r], dist(r, g * kG + c));
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (m[r] < best[r]) grp[r] = g;
        best[r] = m[r];
      }
    }
    // locate, the kR tokens side by side: the first code of each recorded
    // group whose distance equals the minimum
    bool found[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) found[r] = grp[r] < 0;
    for (int c = 0; c < kG; ++c) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (!found[r] && dist(r, grp[r] * kG + c) == best[r]) {
          arg[r] = c0 + grp[r] * kG + c;
          found[r] = true;
        }
      }
    }
  }

  // merge the slices: ascending slice order, strict `<` -> the lowest index wins ties
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    part_v[warp * kTile + r * 32 + lane] = best[r];
    part_i[warp * kTile + r * 32 + lane] = arg[r];
  }
  __syncthreads();
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
  }
}

int per_slice(int K) { return ((K + kWarps - 1) / kWarps + kG - 1) / kG * kG; }

template <typename ZT, bool D3>
cudaError_t launch(Args a, cudaStream_t stream) {
  auto kernel = vq_argmin_kernel<ZT, D3>;
  const int smem = D3 ? kSmemBytes : kWarps * kTile * 8;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.N + kTile - 1) / kTile;
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// z [N, D] float32 (z_bf16 = 0) or bf16 (1) with element strides (zs_n, zs_d);
// codebook e [K, D] float32 with element strides (es_k, es_d); idx [N] int32
// (contiguous). One launch.
extern "C" int vq_argmin(const void* z, int z_bf16, long long zs_n, long long zs_d, const void* e,
                         long long es_k, long long es_d, void* idx, int N, int D, int K, void* stream) {
  if (N <= 0) return 0;
  if (D < 1 || K < 1) return (int)cudaErrorInvalidValue;
  Args a{z, zs_n, zs_d, static_cast<const float*>(e), es_k, es_d, static_cast<int*>(idx), N, D, K,
         per_slice(K)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool d3 = D == 3;
  if (z_bf16) return (int)(d3 ? launch<__nv_bfloat16, true>(a, s) : launch<__nv_bfloat16, false>(a, s));
  return (int)(d3 ? launch<float, true>(a, s) : launch<float, false>(a, s));
}

// The kernel's layout for a codebook of K codes of width D: out = {slices,
// codes per slice (slice s starts at code s * this), codes staged per chunk,
// tokens per CTA, threads per CTA, dynamic shared memory in bytes}.
extern "C" void vq_argmin_layout(int K, int D, int* out) {
  out[0] = kWarps;
  out[1] = per_slice(K);
  out[2] = kChunk;
  out[3] = kTile;
  out[4] = kThreads;
  out[5] = D == 3 ? kSmemBytes : kWarps * kTile * 8;
}
