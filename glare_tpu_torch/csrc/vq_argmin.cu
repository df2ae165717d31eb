// Codebook retrieval: per token, argmin over the codebook of |e|^2 - 2 z.e.
//
// Replaces the Pallas kernel `_vq_kernel` (glare_tpu/ops/vq.py, entry
// `nearest_code_pallas`). Like it, the [N, K] distance matrix never reaches
// device memory, the |z|^2 term (constant per token) is dropped, and ties go
// to the lowest code index (strict `<` over ascending index).
//
// What bounds it on an H100: operations. N*K*(D+1) fused multiply-adds in
// float32 against a few hundred KB of traffic (tokens in, indices out, the
// codebook re-read by every block out of L2). Design: the augmented codebook
// w[k] = (-2 e_k, |e_k|^2) is staged in dynamic shared memory (all 8192 x 4
// floats = 128 KB at the GLARE shape, else tile by tile), one thread owns one
// token and walks the tile with broadcast shared-memory reads, so the inner
// loop is D FMAs, one compare and two selects per code.
#include <cuda_runtime.h>
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
