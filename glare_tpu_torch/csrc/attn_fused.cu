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
// The float32 entry, with a design of its own, is described at its kernel below.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
// The float32 entry (no tensor cores: the package keeps TF32 off, so float32
// means float32). Bound by operations, 4*B*n_true^2*C FLOP on the float32
// units (67 TFLOP/s), so the design is a register-tiled SGEMM twice per key
// tile, with the online softmax between:
//  * one CTA of 256 threads per (image, 64-query tile); Q [64, C] sits in
//    shared memory for the whole key loop;
//  * a key tile is 64 keys. S = Q K^T is an outer product: each thread owns a
//    4 x 4 block of S (queries rg + 16 i, keys kg + 16 j); per channel float4
//    step it reads its 4 Q float4s, then one K float4 a key, from shared
//    memory for 64 FMAs (a quarter-warp shares its Q rows: broadcast reads);
//  * the scores go through shared memory once: 4 threads a row take the
//    masked row max and sum by shuffles (exp2, m and l in float32) and write
//    the probabilities transposed, [key][query], over the scores;
//  * O's [64, C] float32 accumulator lives in registers: warp w owns queries
//    8w .. 8w + 7, lane l the channels 4l + 128 c, so a thread holds 8 x
//    4 * NC4 sums (128 at C = 512) and reads per key two broadcast float4s of
//    P and NC4 float4s of V for 32 * NC4 FMAs;
//  * K arrives in chunks of [64 keys, 128 channels], V in chunks of [16 keys,
//    C], one stream of chunks through a 2-stage ring of cp.async.cg copies
//    (not kept in L1: keeping them cost 1 ms at the main shape): the next
//    chunk loads under the current one's products, and a key tile takes 10
//    block barriers (one CTA an SM, so every barrier drains the SM).
// At C = 512 shared memory holds Q 132 KB, the ring 68 KB and the score tile
// 17 KB (218 KB); 8 warps at 255 registers. It reaches about half the float32
// peak: by probes (glare_tpu_torch/tools/attn_f32_designs.py, which also
// times the alternatives measured) the S half runs at ~60% of the units' rate,
// PV at ~90%, and the chunk copies and barriers take the rest. The first
// design of this entry (one thread per score dot product, 2 shared loads an
// FMA, 16-query tiles) ran 15x slower than the plain version.
constexpr int FQ = 64;          // queries a CTA
constexpr int FKT = 64;         // keys a tile
constexpr int FT = 256;         // threads
constexpr int FNW = FT / 32;    // warps
// S = Q K^T ownership: a thread holds FSQ queries x FSK keys of the 64 x 64 tile
constexpr int FSQ = 4;
constexpr int FSK = FQ * FKT / FT / FSQ;
constexpr int FRG = FQ / FSQ;   // query groups (rg + FRG i)
constexpr int FKG = FKT / FSK;  // key groups (kg + FKG j); a warp holds 4 query x 8 key groups
constexpr int FTPR = FT / FQ;   // softmax threads a query row
constexpr int FWPR = FNW * 8 / FQ;  // PV: warps sharing 8 query rows, splitting the channel groups
constexpr int FCTAS = 1;        // CTAs an SM (__launch_bounds__ caps the registers to match)
static_assert(FRG * FKG == FT && FKG % 8 == 0 && FWPR >= 1, "thread layouts of the f32 entry");
constexpr int FCC = 128;        // channels of one K chunk
constexpr int FKLD = FCC + 4;   // K chunk row stride (floats)
constexpr int FVK = 16;         // keys of one V chunk
constexpr int FSLD = FKT + 4;   // score tile [query][key] row stride
constexpr int FPLD = FQ + 4;    // probability tile [key][query] row stride
constexpr int FSP = FQ * FSLD > FKT * FPLD ? FQ * FSLD : FKT * FPLD;  // their shared buffer
constexpr int FSTAGES = 2;      // cp.async ring stages

__host__ __device__ constexpr int f32_cp(int nc4) { return 128 * nc4; }   // channels covered
__host__ __device__ constexpr int f32_ld(int nc4) { return f32_cp(nc4) + 4; }
__host__ __device__ constexpr int f32_stage(int nc4) {
  return FKT * FKLD > FVK * f32_ld(nc4) ? FKT * FKLD : FVK * f32_ld(nc4);
}
// floats: Q, the ring, S / P^T, correction and sum [FQ] each
__host__ __device__ constexpr int f32_smem_floats(int nc4) {
  return FQ * f32_ld(nc4) + FSTAGES * f32_stage(nc4) + FSP + 2 * FQ;
}
static_assert(f32_smem_floats(4) * 4 <= 232448, "the f32 entry's shared memory at C = 512");

// 16 bytes global -> shared, asynchronously, not kept in L1 (each value is read once)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// rows [row0, row0 + NROWS) x channels [col0, col0 + 4 * NCOL4) of a [n, C]
// matrix into shared memory (row stride ld); rows >= n and channels >= C are zeros
template <int NROWS, int NCOL4>
__device__ __forceinline__ void f32_load_rows(float* dst, int ld, const float* src, int row0, int n,
                                              int col0, int C, bool vec) {
  constexpr int N = NROWS * NCOL4;
  if (vec && row0 + NROWS <= n && col0 + 4 * NCOL4 <= C) {  // the common case: no edge
    const float* s0 = src + (size_t)row0 * C + col0;
#pragma unroll
    for (int u = 0; u < (N + FT - 1) / FT; ++u) {
      const int i = threadIdx.x + u * FT;
      if (N % FT != 0 && i >= N) break;
      const int r = i / NCOL4, v4 = i % NCOL4;
      cp_async16(dst + r * ld + 4 * v4, s0 + r * C + 4 * v4);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < (N + FT - 1) / FT; ++u) {
    const int i = threadIdx.x + u * FT;
    if (N % FT != 0 && i >= N) break;
    const int r = i / NCOL4, v4 = i % NCOL4;
    const int gr = row0 + r, c = col0 + 4 * v4;
    float* d = dst + r * ld + 4 * v4;
    if (gr < n && c < C) {
      const float* s = src + (size_t)gr * C + c;
      if (vec) {
        cp_async16(d, s);
      } else {
        float4 t;
        t.x = s[0];
        t.y = c + 1 < C ? s[1] : 0.f;
        t.z = c + 2 < C ? s[2] : 0.f;
        t.w = c + 3 < C ? s[3] : 0.f;
        *reinterpret_cast<float4*>(d) = t;
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// NC4: float4 channel groups a thread owns in O (C <= 128 * NC4). vec: C % 4 == 0
// and 16-byte aligned bases (cp.async and float4 stores), else scalar edges.
template <int NC4>
__global__ void __launch_bounds__(FT, FCTAS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int n, int n_true, int C,
                bool vec) {
  constexpr int LD = f32_ld(NC4);
  constexpr int STAGE = f32_stage(NC4);
  extern __shared__ __align__(16) float fs[];
  float* Qs = fs;                          // [FQ][LD]
  float* ring = Qs + FQ * LD;              // FSTAGES x STAGE
  float* SP = ring + FSTAGES * STAGE;      // scores [query][key], then P^T [key][query]
  float* corr_s = SP + FSP;                // [FQ] this tile's correction
  float* l_s = corr_s + FQ;                // [FQ] the final sums

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FQ;
  const size_t base = (size_t)blockIdx.y * n * C;
  const float* kb = k + base;
  const float* vb = v + base;
  const int nkc = (C + FCC - 1) / FCC;     // K chunks a key tile
  const int cpt = nkc + FKT / FVK;         // chunks a key tile
  const int n_kt = (n_true + FKT - 1) / FKT;
  const int total = n_kt * cpt;

  // chunk t of the stream: K chunk (tile t / cpt, channels FCC p) or V chunk (FVK keys)
  auto issue = [&](int t) {
    if (t < total) {
      const int kt = t / cpt, p = t - kt * cpt;
      float* dst = ring + (t % FSTAGES) * STAGE;
      if (p < nkc)
        f32_load_rows<FKT, FCC / 4>(dst, FKLD, kb, kt * FKT, n, p * FCC, C, vec);
      else
        f32_load_rows<FVK, f32_cp(NC4) / 4>(dst, LD, vb, kt * FKT + (p - nkc) * FVK, n, 0, C, vec);
    }
    __pipeline_commit();       // committed even when empty: keeps the group count uniform
  };
  // the next chunk to land: at most FSTAGES - 2 later groups may still be in flight
  auto next_chunk = [&](int t) {
    __pipeline_wait_prior(FSTAGES - 2);
    __syncthreads();           // chunk t visible to all; the stage of chunk t - 1 free
    issue(t + FSTAGES - 1);
    return ring + (t % FSTAGES) * STAGE;
  };
  f32_load_rows<FQ, f32_cp(NC4) / 4>(Qs, LD, q + base, q0, n, 0, C, vec);
#pragma unroll
  for (int t = 0; t < FSTAGES - 1; ++t) issue(t);  // the Q copies join chunk 0's group

  // S ownership: queries rg + FRG i, keys kg + FKG j
  const int rg = (warp / (FKG / 8)) * 4 + (lane >> 3), kg = (warp % (FKG / 8)) * 8 + (lane & 7);
  // softmax ownership: FTPR threads a query row, keys part + FTPR e
  const int srow = tid / FTPR, spart = tid % FTPR;
  float m_run = kNegInf, l_run = 0.f;
  // O ownership: queries 8 (warp / FWPR) + i, channels 4 lane + 128 c for the
  // channel groups c = warp % FWPR + FWPR cc below NC4
  constexpr int NCT = (NC4 + FWPR - 1) / FWPR;
  const int orow = 8 * (warp / FWPR), cg0 = warp % FWPR;
  float acc[8][4 * NCT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NCT; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    float s[FSQ][FSK];
#pragma unroll
    for (int i = 0; i < FSQ; ++i)
#pragma unroll
      for (int j = 0; j < FSK; ++j) s[i][j] = 0.f;
    for (int p = 0; p < nkc; ++p) {
      const float* Ks = next_chunk(kt * cpt + p);
      const float* Qc = Qs + p * FCC;
#pragma unroll 8
      for (int c4 = 0; c4 < FCC / 4; ++c4) {
        float4 qv[FSQ];
#pragma unroll
        for (int i = 0; i < FSQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qc + (rg + FRG * i) * LD + 4 * c4);
#pragma unroll
        for (int j = 0; j < FSK; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (kg + FKG * j) * FKLD + 4 * c4);
#pragma unroll
          for (int i = 0; i < FSQ; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
    }
    // scores out, keys >= n_true masked
#pragma unroll
    for (int i = 0; i < FSQ; ++i)
#pragma unroll
      for (int j = 0; j < FSK; ++j) {
        const int key = kg + FKG * j;
        SP[(rg + FRG * i) * FSLD + key] = kt * FKT + key < n_true ? s[i][j] : kNegInf;
      }
    __syncthreads();
    {  // online softmax of row srow; P^T overwrites the scores once all are read
      float sv[FKT / FTPR];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < FKT / FTPR; ++e) {
        sv[e] = SP[srow * FSLD + spart + FTPR * e];
        mx = fmaxf(mx, sv[e]);
      }
      __syncthreads();
#pragma unroll
      for (int o = 1; o < FTPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);
      const float corr = exp2f(m_run - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < FKT / FTPR; ++e) {
        const float pr = exp2f(sv[e] - m_new);
        sum += pr;
        SP[(spart + FTPR * e) * FPLD + srow] = pr;
      }
#pragma unroll
      for (int o = 1; o < FTPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (spart == 0) corr_s[srow] = corr;
    }
    for (int p = 0; p < FKT / FVK; ++p) {
      const float* Vs = next_chunk(kt * cpt + nkc + p);   // its barrier: P and corrections written
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float cr = corr_s[orow + i];
#pragma unroll
          for (int c = 0; c < 4 * NCT; ++c) acc[i][c] *= cr;
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < FVK; ++kk) {
        const float* prow = SP + (p * FVK + kk) * FPLD + orow;
        const float4 pa = *reinterpret_cast<const float4*>(prow);
        const float4 pb = *reinterpret_cast<const float4*>(prow + 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int c = 0; c < NCT; ++c) {
          if (NC4 % FWPR != 0 && cg0 + FWPR * c >= NC4) break;
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + kk * LD + 4 * lane + 128 * (cg0 + FWPR * c));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = q0 + orow + i;
    if (gr >= n) continue;
    const float l = l_s[orow + i];
    float* dst = out + base + (size_t)gr * C;
#pragma unroll
    for (int c = 0; c < NCT; ++c) {
      const int col = 4 * lane + 128 * (cg0 + FWPR * c);
      if (col >= C) continue;
      const float4 o = make_float4(acc[i][4 * c] / l, acc[i][4 * c + 1] / l, acc[i][4 * c + 2] / l,
                                   acc[i][4 * c + 3] / l);
      if (vec) {
        *reinterpret_cast<float4*>(dst + col) = o;
      } else {
        dst[col] = o.x;
        if (col + 1 < C) dst[col + 1] = o.y;
        if (col + 2 < C) dst[col + 2] = o.z;
        if (col + 3 < C) dst[col + 3] = o.w;
      }
    }
  }
}

template <int NC4>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* out, int B, int n,
                       int n_true, int C, bool vec, cudaStream_t stream) {
  const int smem = f32_smem_floats(NC4) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel<NC4>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((n + FQ - 1) / FQ, B);
  attn_f32_kernel<NC4><<<grid, FT, smem, stream>>>(q, k, v, out, n, n_true, C, vec);
  return cudaGetLastError();
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
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(out);
  const bool vec = C % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) &
                                  15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 127) / 128) {
    case 1: return (int)launch_f32<1>(qq, kk, vv, oo, B, n, n_true, C, vec, s);
    case 2: return (int)launch_f32<2>(qq, kk, vv, oo, B, n, n_true, C, vec, s);
    case 3: return (int)launch_f32<3>(qq, kk, vv, oo, B, n, n_true, C, vec, s);
    default: return (int)launch_f32<4>(qq, kk, vv, oo, B, n, n_true, C, vec, s);
  }
}
