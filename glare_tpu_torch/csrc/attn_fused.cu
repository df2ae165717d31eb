// Fused single-head attention, forward only: softmax(q k^T) v for [B, N, C]
// inputs whose q already carries the 1/sqrt(C) * log2(e) scale.
//
// Replaces the Pallas kernels `_kernel` and `_kernel_pipe`
// (glare_tpu/ops/attn_pallas.py, entry `flash_attention_nhc`; the pipelined
// variant is the same function on another schedule, so one kernel serves
// both). Same arithmetic: scores and the running max / sum / output
// accumulator in float32, exp2 online softmax, probabilities cast to the
// value type before the PV product, keys >= n_true masked to -1e30, output
// divided by the sum at the end. The [N, N] scores never leave the SM.
//
// What bounds it on an H100: operations, 4*B*N*N*C FLOP on the tensor cores
// (K and V, 2*N*C values, are re-read by every query tile but stay in L2).
// Design: the TPU kernel's sequential key-block grid axis with scratch
// carried between steps becomes a loop inside one thread block per
// (batch, 64-query tile). The head dimension is up to 512, so a 64 x 512
// float32 accumulator (128 KB) fits neither one warp nor shared memory
// beside the K/V tiles: it is split by output channel across the block's 8
// warps as wmma accumulator fragments (at C=512: 64 rows x 64 channels per
// warp, 128 registers a thread). The 64 x 64 score tile is shared through
// shared memory: QK^T by all warps (2 fragments each), softmax by 4 threads
// a row, then every warp multiplies the probability tile into its own
// channels. K and V tiles arrive by cp.async so that V_j loads under QK^T and
// K_{j+1} under the softmax and PV. Tensor cores are driven through
// nvcuda::wmma (mma.sync 16x16x16 bf16 -> f32); wgmma/TMA are left for later.
//
// A float32 variant (scalar FMA, 16-query tiles) serves f32 inputs.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- bf16 ----
constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per inner step
constexpr int NT = 256;         // threads (8 warps)
constexpr int S_LD = BK + 4;    // score tile row stride (floats)
constexpr int P_LD = BK + 8;    // probability tile row stride (bf16)

// Copy 64 rows [row0, row0+64) of a [n, C] matrix into shared memory with row
// stride ld; rows >= n are zero-filled.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int row0, int n,
                                                int C, int ld) {
  const int vpr = C >> 3;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * vpr; i += NT) {
    const int r = i / vpr, v8 = i - r * vpr;
    bf16* d = dst + r * ld + v8 * 8;
    const int gr = row0 + r;
    if (gr < n) {
      __pipeline_memcpy_async(d, src + (size_t)gr * C + v8 * 8, 16);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// NCF: output-channel fragments (16 wide) per warp; warp w owns fragments
// w, w+8, w+16, ... below C/16.
template <int NCF>
__global__ void __launch_bounds__(NT, 1)
attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int n, int n_true, int C) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = C + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * ld;
  bf16* Vs = Ks + BK * ld;
  float* Ss = reinterpret_cast<float*>(Vs + BK * ld);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * S_LD);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * n * C;
  const int ncf_total = C >> 4;
  const int n_kt = (n_true + BK - 1) / BK;

  load_tile_async(Qs, q + base, q0, n, C, ld);
  load_tile_async(Ks, k + base, 0, n, C, ld);
  __pipeline_commit();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NCF][4];
#pragma unroll
  for (int c = 0; c < NCF; ++c)
#pragma unroll
    for (int rf = 0; rf < 4; ++rf) wmma::fill_fragment(acc[c][rf], 0.f);

  // softmax ownership: 4 threads a row, 16 keys each
  const int srow = tid >> 2, spart = tid & 3;
  float m_run = kNegInf, l_run = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    load_tile_async(Vs, v + base, j * BK, n, C, ld);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // Q and K_j have landed (V_j may be in flight)
    __syncthreads();

    {  // S = Q K^T: warp -> row fragment warp/2, column fragments (warp&1)*2 + {0,1}
      const int rf = warp >> 1, cf0 = (warp & 1) * 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s0, s1;
      wmma::fill_fragment(s0, 0.f);
      wmma::fill_fragment(s1, 0.f);
      const bf16* qa = Qs + rf * 16 * ld;
      const bf16* kb0 = Ks + cf0 * 16 * ld;
      const bf16* kb1 = kb0 + 16 * ld;
      for (int kk = 0; kk < C; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0, b1;
        wmma::load_matrix_sync(a, qa + kk, ld);
        wmma::load_matrix_sync(b0, kb0 + kk, ld);
        wmma::load_matrix_sync(b1, kb1 + kk, ld);
        wmma::mma_sync(s0, a, b0, s0);
        wmma::mma_sync(s1, a, b1, s1);
      }
      float* sd = Ss + rf * 16 * S_LD + cf0 * 16;
      wmma::store_matrix_sync(sd, s0, S_LD, wmma::mem_row_major);
      wmma::store_matrix_sync(sd + 16, s1, S_LD, wmma::mem_row_major);
    }
    __syncthreads();

    // the K buffer is free: prefetch K_{j+1} under the softmax and PV
    if (j + 1 < n_kt) load_tile_async(Ks, k + base, (j + 1) * BK, n, C, ld);
    __pipeline_commit();  // committed even when empty: keeps the group count uniform

    {  // online softmax on this thread's 16 scores of row srow
      float sv[16];
      const float* srcp = Ss + srow * S_LD + spart * 16;
      const int key0 = j * BK + spart * 16;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float s = srcp[i];
        if (key0 + i >= n_true) s = kNegInf;
        sv[i] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float corr = exp2f(m_run - m_new);
      float sum = 0.f;
      bf16* pd = Ps + srow * P_LD + spart * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p = exp2f(sv[i] - m_new);
        sum += p;
        pd[i] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run = l_run * corr + sum;
      m_run = m_new;
      // broadcast this row's correction over columns 0..15 of the score tile,
      // so it can be read back in the accumulator fragments' own layout
      float* cd = Ss + srow * S_LD + spart * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) cd[i] = corr;
    }
    __pipeline_wait_prior(1);  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int rf = 0; rf < 4; ++rf) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cfrag;
      wmma::load_matrix_sync(cfrag, Ss + rf * 16 * S_LD, S_LD, wmma::mem_row_major);
#pragma unroll
      for (int c = 0; c < NCF; ++c)
#pragma unroll
        for (int i = 0; i < cfrag.num_elements; ++i) acc[c][rf].x[i] *= cfrag.x[i];
    }
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int rf = 0; rf < 4; ++rf) wmma::load_matrix_sync(a[rf], Ps + rf * 16 * P_LD + kk, P_LD);
#pragma unroll
      for (int c = 0; c < NCF; ++c) {
        const int cf = warp + 8 * c;
        if (cf < ncf_total) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, Vs + kk * ld + cf * 16, ld);
#pragma unroll
          for (int rf = 0; rf < 4; ++rf) wmma::mma_sync(acc[c][rf], a[rf], bv, acc[c][rf]);
        }
      }
    }
    __syncthreads();  // V, S and P are free again
  }
  __pipeline_wait_prior(0);

  // out = acc / l, staged through shared memory (over the K/V tiles)
  {
    float* cd = Ss + srow * S_LD + spart * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) cd[i] = l_run;
  }
  __syncthreads();
  float* Os = reinterpret_cast<float*>(Ks);  // [BQ][C]
#pragma unroll
  for (int rf = 0; rf < 4; ++rf) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> lfrag;
    wmma::load_matrix_sync(lfrag, Ss + rf * 16 * S_LD, S_LD, wmma::mem_row_major);
#pragma unroll
    for (int c = 0; c < NCF; ++c) {
      const int cf = warp + 8 * c;
      if (cf < ncf_total) {
#pragma unroll
        for (int i = 0; i < lfrag.num_elements; ++i) acc[c][rf].x[i] /= lfrag.x[i];
        wmma::store_matrix_sync(Os + rf * 16 * C + cf * 16, acc[c][rf], C, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  const int vpr = C >> 3;
  for (int i = tid; i < BQ * vpr; i += NT) {
    const int r = i / vpr, v8 = i - r * vpr;
    const int gr = q0 + r;
    if (gr < n) {
      const float* o = Os + r * C + v8 * 8;
      __nv_bfloat162 h0 = __floats2bfloat162_rn(o[0], o[1]);
      __nv_bfloat162 h1 = __floats2bfloat162_rn(o[2], o[3]);
      __nv_bfloat162 h2 = __floats2bfloat162_rn(o[4], o[5]);
      __nv_bfloat162 h3 = __floats2bfloat162_rn(o[6], o[7]);
      uint4 pk;
      pk.x = *reinterpret_cast<unsigned int*>(&h0);
      pk.y = *reinterpret_cast<unsigned int*>(&h1);
      pk.z = *reinterpret_cast<unsigned int*>(&h2);
      pk.w = *reinterpret_cast<unsigned int*>(&h3);
      *reinterpret_cast<uint4*>(out + base + (size_t)gr * C + v8 * 8) = pk;
    }
  }
}

template <int NCF>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int n,
                        int n_true, int C, cudaStream_t stream) {
  const size_t smem = (size_t)3 * 64 * (C + 8) * sizeof(bf16) + (size_t)BQ * S_LD * sizeof(float) +
                      (size_t)BQ * P_LD * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(attn_bf16_kernel<NCF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n + BQ - 1) / BQ, B);
  attn_bf16_kernel<NCF><<<grid, NT, smem, stream>>>(q, k, v, out, n, n_true, C);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 ----
constexpr int FQ = 16;   // queries per block
constexpr int FK = 32;   // keys per inner step (one per lane)
constexpr int FT = 128;  // threads; thread t owns output channels t, t+128, t+256, t+384

__global__ void __launch_bounds__(FT)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int n, int n_true, int C) {
  extern __shared__ float fs[];
  const int ldk = C + 1;
  float* Qs = fs;                 // [FQ][C]
  float* KVs = Qs + FQ * C;       // [FK][C+1], K then V
  float* Ss = KVs + FK * ldk;     // [FQ][FK]
  float* ms = Ss + FQ * FK;       // running max
  float* ls = ms + FQ;            // running sum
  float* cs = ls + FQ;            // this step's correction

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FQ;
  const size_t base = (size_t)blockIdx.y * n * C;
  const int n_kt = (n_true + FK - 1) / FK;

  for (int i = tid; i < FQ * C; i += FT) {
    const int r = i / C, c = i - r * C;
    const int gr = q0 + r;
    Qs[i] = gr < n ? q[base + (size_t)gr * C + c] : 0.f;
  }
  if (tid < FQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[FQ][4];
#pragma unroll
  for (int r = 0; r < FQ; ++r)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[r][jj] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    __syncthreads();
    for (int i = tid; i < FK * C; i += FT) {
      const int r = i / C, c = i - r * C;
      const int gr = j * FK + r;
      KVs[r * ldk + c] = gr < n ? k[base + (size_t)gr * C + c] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < FQ * FK; e += FT) {
      const int r = e / FK, kk = e - r * FK;
      const float* qr = Qs + r * C;
      const float* kr = KVs + kk * ldk;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s = fmaf(qr[c], kr[c], s);
      if (j * FK + kk >= n_true) s = kNegInf;
      Ss[e] = s;
    }
    __syncthreads();
    for (int i = tid; i < FK * C; i += FT) {
      const int r = i / C, c = i - r * C;
      const int gr = j * FK + r;
      KVs[r * ldk + c] = gr < n ? v[base + (size_t)gr * C + c] : 0.f;
    }
#pragma unroll
    for (int rr = 0; rr < FQ / 4; ++rr) {  // 4 warps x 4 rows, one key per lane
      const int r = warp * (FQ / 4) + rr;
      const float s = Ss[r * FK + lane];
      const float m_prev = ms[r];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      const float p = exp2f(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ss[r * FK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = exp2f(m_prev - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FQ; ++r) {
      const float corr = cs[r];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[r][jj] *= corr;
    }
    for (int kk = 0; kk < FK; ++kk) {
      float vv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = tid + jj * FT;
        vv[jj] = col < C ? KVs[kk * ldk + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < FQ; ++r) {
        const float p = Ss[r * FK + kk];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[r][jj] = fmaf(p, vv[jj], acc[r][jj]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < FQ; ++r) {
    const int gr = q0 + r;
    if (gr < n) {
      const float l = ls[r];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = tid + jj * FT;
        if (col < C) out[base + (size_t)gr * C + col] = acc[r][jj] / l;
      }
    }
  }
}

}  // namespace

// q, k, v, out: [B, n, C] contiguous bf16; q pre-scaled. C % 16 == 0, C <= 512.
extern "C" int attn_fused_bf16(const void* q, const void* k, const void* v, void* out, int B, int n,
                               int n_true, int C, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (C % 16 != 0 || C < 16 || C > 512 || n_true < 1 || n_true > n)
    return (int)cudaErrorInvalidValue;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ncf = (C / 16 + 7) / 8;
  switch (ncf) {
    case 1: return (int)launch_bf16<1>(qq, kk, vv, oo, B, n, n_true, C, s);
    case 2: return (int)launch_bf16<2>(qq, kk, vv, oo, B, n, n_true, C, s);
    case 3: return (int)launch_bf16<3>(qq, kk, vv, oo, B, n, n_true, C, s);
    default: return (int)launch_bf16<4>(qq, kk, vv, oo, B, n, n_true, C, s);
  }
}

// q, k, v, out: [B, n, C] contiguous f32; q pre-scaled. C <= 512.
extern "C" int attn_fused_f32(const void* q, const void* k, const void* v, void* out, int B, int n,
                              int n_true, int C, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (C < 1 || C > 512 || n_true < 1 || n_true > n) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)FQ * C + (size_t)FK * (C + 1) + FQ * FK + 3 * FQ) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + FQ - 1) / FQ, B);
  attn_f32_kernel<<<grid, FT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), n, n_true, C);
  return (int)cudaGetLastError();
}
