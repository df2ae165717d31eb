// Modulated deformable convolution (DCNv2) forward: 3x3, stride 1, pad 1,
// G deformable groups, channels-last; float32 (every float32 call) and bf16
// (the bf16 widths outside csrc/dcn_hopper.cu's envelope).
//
// Replaces the Pallas kernel `_kernel_core` (glare_tpu/ops/dcn_pallas.py:55, entry
// `modulated_deform_conv_pallas`). Same function: offsets clamped per (g, k)
// to +-R[g][k] (R = inf means no clamp, which is then the exact op of
// glare_tpu/ops/dcn.py), bilinear sampling with the zero-border semantics of
// the reference CUDA extension (a sample outside (-1,H)x(-1,W) is zero, each
// corner outside the image is zero), times the modulation mask, contracted
// with the [9*C, O] weight in float32 accumulation inside the same kernel,
// plus bias, written in the input's dtype. The sampled [pixels, 9*C] columns
// never reach device memory.
//
// What differs from the TPU kernel, and why: there the sampling is a static
// select-chain over a DMA'd row band, because gathers are very slow on that
// machine. That is the TPU's shape, not the function's. On Hopper a gather of
// contiguous Cg-channel rows (64 to 128 bytes) is what the memory system is
// good at, so the kernel gathers, and any offset is as cheap as a small one.
//
// What bounds it on an H100: the contraction, 2*B*H*W*9*C*O FLOP (tensor cores
// for bf16), close to the bytes of x, offset, mask and the output.
//
// Three kernels, chosen by dcn_fwd's `kind` (ops/dcn.py:route, by dtype and
// widths):
//  * kind 0, dcn_f32_tiled_kernel: the float32 forward of the paths (the
//    float32 training step; a float32 network's serving). Bound: operations,
//    2*P*9*C*O FLOP on the float32 units (67 TFLOP/s, no tensor cores: TF32
//    would not keep the float32 tolerance, and 3xTF32 would break the
//    backward's bit-equal column below). What held the first float32 kernel
//    (kind 2) at 10-19% of that bound (2.997 / 5.462 ms at the training
//    shapes): at O = 128 half its FMAs multiplied by zero (a thread owned 8
//    outputs strided by 32 whatever O); eight L2 loads of the weight and eight
//    shared loads per 64 FMAs (the tap's [C, O] slice read from global memory
//    every channel, never staged); sampling and products separated by block
//    barriers with one tile buffer; flat 64-pixel tiles. The design here:
//    - 2-D output tiles of 8 x 16 pixels, all O outputs, O in {64, 128, 256}:
//      every FMA is useful; thread (ty, tx) owns 8 pixels by O/16 outputs
//      (an 8 x 16 register micro-tile at O = 256), reading per k two 16-byte
//      A vectors and O/64 16-byte weight vectors (6 shared loads per 128 FMAs).
//    - K in chunks of 16 channels of one tap, channel block major, so the 9
//      taps of a block reuse x's lines from L1; the chunk's [16, O] weight
//      rows copied by cp.async into the other of two stages while the current
//      one multiplies; the [16, 128] A block (k-major) sampled into the other
//      of two A stages. At O = 256 the corner loads for chunk j + 1 are issued
//      before chunk j's FMAs and consumed after them; at O <= 128 they follow
//      the FMAs (each measured faster at its width).
//    - The sampler is csrc/dcn_tap.cuh, shared with the backward's gather
//      pass (csrc/dcn_bwd.cu): the column it multiplies is bit for bit the
//      column the backward multiplies grad_out by for grad_weight.
//    Measured against the designs it beat (tools/dcn_train_designs.py, H100
//    80GB HBM3 at 700 W; warp_0 x [2,128,128,256] -> 256 / warp_1 x
//    [2,256,256,128] -> 128): shipped 1.15 / 1.54-1.56 ms (50% / 37% of the
//    bound); the first kernel 2.94 / 5.21-5.53; at O = 256 the gathers issued
//    after the FMAs 1.21; at O = 128 issued before them 1.67-1.68; two CTAs an
//    SM at O = 128 1.54-1.57 (no faster, not kept). A halo staged in shared
//    memory (dcn_hopper.cu) is not used: the gathers hit L1, and without any
//    corner load the kernel keeps 75% / 62% of its time (the FMAs, at 60-66%
//    of the float32 rate, set the pace).
//  * kind 1, dcn_bf16_kernel (wmma): bf16 widths outside the Hopper entry's
//    envelope. One block owns 64 output pixels and all O outputs. Per tap k it
//    samples the [64, C] tile into shared memory (threads spread over (pixel,
//    group, 16-byte channel chunk), so reads are contiguous), then multiplies
//    it by the tap's [C, O] weight slice, read from L2: wmma 16x16x16
//    fragments, each warp owns O/16 column fragments interleaved by 8, all 4
//    row fragments.
//  * kind 2, dcn_f32_kernel: the first float32 kernel, for float32 widths
//    outside kind 0's envelope; the same structure with scalar FMA, each thread
//    8 pixels x up to 8 outputs.
//
// Second entry, `dcn_cascade_fwd`: replaces the Pallas cascade
// `modulated_deform_conv_pallas_cascade` (base `_kernel` + compacted tail
// `_kernel_selected`, glare_tpu/ops/dcn_pallas.py). Same function: every row
// block that the caller selected is computed whole at the wide clamp R_tail,
// every other block at the narrow clamp R. On the TPU that is two launches (a
// clamp-R pass over the image, then a pass over a compacted list of block ids
// that writes into the first pass's buffer), because there the cost of a pass
// grows with (2R+1)^2 and the wide radius must touch few rows. Here a gather
// costs the same at any radius, so the design taken is ONE pass with a radius
// per image row: the caller hands a float [B*H] table (R_tail on the rows of
// selected blocks, R elsewhere) and each pixel's taps are clamped at its own
// row's radius (a block of 64 flat pixels may straddle rows, so the lookup is
// per pixel). The work and the bound are those of one plain pass; the second
// design (base launch + in-place launch over a device list of block ids) would
// do (1 + selected share) times the work for the same result.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "dcn_tap.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TP = 64;    // pixels per block
constexpr int NT = 256;   // threads
constexpr int KK = 9;     // taps
constexpr int KIND_F32 = 0, KIND_BF16 = 1, KIND_F32_FLAT = 2;  // dcn_fwd's `kind`

// The tiled float32 kernel's widths: 16-channel K chunks, 8 channels of one
// group a sampling thread, O a multiple of 64 up to 256.
bool f32_tiled_envelope(int C, int O, int G) {
  return G >= 1 && C % G == 0 && C % 16 == 0 && (C / G) % 8 == 0 &&
         (O == 64 || O == 128 || O == 256);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* o);

template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float* o) { o[0] = p[0]; }
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
template <>
__device__ __forceinline__ void load_vec<bf16, 1>(const bf16* p, float* o) {
  o[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<bf16, 8>(const bf16* p, float* o) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned int w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* o);

template <>
__device__ __forceinline__ void store_vec<float, 1>(float* p, const float* o) { p[0] = o[0]; }
template <>
__device__ __forceinline__ void store_vec<float, 4>(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ void store_vec<bf16, 1>(bf16* p, const float* o) {
  p[0] = __float2bfloat16(o[0]);
}
template <>
__device__ __forceinline__ void store_vec<bf16, 8>(bf16* p, const float* o) {
  uint4 t;
  unsigned int* w = reinterpret_cast<unsigned int*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    w[i] = *reinterpret_cast<unsigned int*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = t;
}

struct Dims {
  int B, H, W, C, O, G;
};

// Sample tap k of pixels [p0, p0+TP) into tile[TP][ldt] (channel order g*Cg+cg).
// ROWS: clampR is a per-image-row table [B*H] (the cascade); else per (g, k).
template <typename T, int VEC, bool ROWS>
__device__ __forceinline__ void sample_tap(T* tile, int ldt, const T* __restrict__ x,
                                           const float* __restrict__ offset,
                                           const float* __restrict__ mask,
                                           const float* __restrict__ clampR, Dims d, int k,
                                           long long p0, long long P) {
  const int Cg = d.C / d.G;
  const int lp = Cg / VEC;  // lanes per (pixel, group)
  const int items = TP * d.G * lp;
  const int ky = k / 3 - 1, kx = k % 3 - 1;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int sub = it % lp;
    const int pg = it / lp;
    const int g = pg % d.G;
    const int pl = pg / d.G;
    const long long p = p0 + pl;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    if (p < P) {
      const int w_ = (int)(p % d.W);
      const long long t = p / d.W;
      const int h_ = (int)(t % d.H);
      const int b_ = (int)(t / d.H);
      const size_t gk = ((size_t)p * d.G + g) * KK + k;
      const float r = ROWS ? clampR[(size_t)b_ * d.H + h_] : clampR[g * KK + k];
      const float dy = fminf(fmaxf(offset[gk * 2], -r), r);
      const float dx = fminf(fmaxf(offset[gk * 2 + 1], -r), r);
      const float py = (float)(h_ + ky) + dy;
      const float px = (float)(w_ + kx) + dx;
      if (py > -1.f && py < (float)d.H && px > -1.f && px < (float)d.W) {
        const float y0f = floorf(py), x0f = floorf(px);
        const float ly = py - y0f, lx = px - x0f;
        const float hy = 1.f - ly, hx = 1.f - lx;
        const int y0 = (int)y0f, x0 = (int)x0f;
        const T* xb = x + (size_t)b_ * d.H * d.W * d.C + g * Cg + sub * VEC;
        const float cw[4] = {hy * hx, hy * lx, ly * hx, ly * lx};
#pragma unroll
        for (int cnr = 0; cnr < 4; ++cnr) {
          const int yy = y0 + (cnr >> 1), xx = x0 + (cnr & 1);
          if (yy >= 0 && yy < d.H && xx >= 0 && xx < d.W) {
            float val[VEC];
            load_vec<T, VEC>(xb + ((size_t)yy * d.W + xx) * d.C, val);
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fmaf(val[i], cw[cnr], acc[i]);
          }
        }
        const float m = mask[gk];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] *= m;
      }
    }
    store_vec<T, VEC>(tile + pl * ldt + g * Cg + sub * VEC, acc);
  }
}

// ---------------------------------------------------------------- bf16 ----
// weight [9*C, O] bf16 (row k*C + c), C % 16 == 0, O % 16 == 0, O <= 256.
template <int VEC, bool ROWS>
__global__ void __launch_bounds__(NT)
dcn_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ offset,
                const float* __restrict__ mask, const bf16* __restrict__ weight,
                const float* __restrict__ bias, const float* __restrict__ clampR,
                bf16* __restrict__ out, Dims d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldt = d.C + 8;
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);
  const long long P = (long long)d.B * d.H * d.W;
  const long long p0 = (long long)blockIdx.x * TP;
  const int warp = threadIdx.x >> 5;
  const int nof = d.O >> 4;  // output column fragments

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int rf = 0; rf < 4; ++rf) wmma::fill_fragment(acc[c][rf], 0.f);

  for (int k = 0; k < KK; ++k) {
    __syncthreads();  // the previous tap's tile has been consumed
    sample_tap<bf16, VEC, ROWS>(tile, ldt, x, offset, mask, clampR, d, k, p0, P);
    __syncthreads();
    const bf16* wk = weight + (size_t)k * d.C * d.O;
    for (int kk = 0; kk < d.C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
#pragma unroll
      for (int rf = 0; rf < 4; ++rf) wmma::load_matrix_sync(a[rf], tile + rf * 16 * ldt + kk, ldt);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int cf = warp + 8 * c;
        if (cf < nof) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
          wmma::load_matrix_sync(bw, wk + (size_t)kk * d.O + cf * 16, d.O);
#pragma unroll
          for (int rf = 0; rf < 4; ++rf) wmma::mma_sync(acc[c][rf], a[rf], bw, acc[c][rf]);
        }
      }
    }
  }
  __syncthreads();
  float* Os = reinterpret_cast<float*>(smem_raw);  // [TP][O], over the sample tile
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int cf = warp + 8 * c;
    if (cf < nof) {
#pragma unroll
      for (int rf = 0; rf < 4; ++rf)
        wmma::store_matrix_sync(Os + rf * 16 * d.O + cf * 16, acc[c][rf], d.O, wmma::mem_row_major);
    }
  }
  __syncthreads();
  const int vpr = d.O >> 3;
  for (int i = threadIdx.x; i < TP * vpr; i += NT) {
    const int r = i / vpr, v8 = i - r * vpr;
    const long long p = p0 + r;
    if (p < P) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = v8 * 8 + e;
        o[e] = Os[r * d.O + col] + (bias ? bias[col] : 0.f);
      }
      store_vec<bf16, 8>(out + (size_t)p * d.O + v8 * 8, o);
    }
  }
}

// ----------------------------------------------------------------- f32 ----
// weight [9*C, O] f32, O <= 256. Thread (warp w, lane l): pixels w*8..w*8+7,
// outputs l, l+32, ..., l+224.
template <int VEC, bool ROWS>
__global__ void __launch_bounds__(NT)
dcn_f32_kernel(const float* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const float* __restrict__ weight,
               const float* __restrict__ bias, const float* __restrict__ clampR,
               float* __restrict__ out, Dims d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldt = d.C + 4;
  float* tile = reinterpret_cast<float*>(smem_raw);
  const long long P = (long long)d.B * d.H * d.W;
  const long long p0 = (long long)blockIdx.x * TP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < KK; ++k) {
    __syncthreads();
    sample_tap<float, VEC, ROWS>(tile, ldt, x, offset, mask, clampR, d, k, p0, P);
    __syncthreads();
    const float* wk = weight + (size_t)k * d.C * d.O;
    const float* trow = tile + warp * 8 * ldt;
    for (int c = 0; c < d.C; ++c) {
      float wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = lane + 32 * j;
        wv[j] = o < d.O ? wk[(size_t)c * d.O + o] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = trow[i * ldt + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(s, wv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = p0 + warp * 8 + i;
    if (p < P) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = lane + 32 * j;
        if (o < d.O) out[(size_t)p * d.O + o] = acc[i][j] + (bias ? bias[o] : 0.f);
      }
    }
  }
}


// ------------------------------------------------------ f32, tiled ----
// The float32 forward the paths launch (entry kind 0). weight [9*C, O] f32,
// O in {64, 128, 256}, C % 16 == 0, (C / G) % 8 == 0, x and weight 16-byte
// aligned. One CTA of 256 threads per 8 x 16 output tile, all O outputs.
// K chunks of 16 channels of one tap, channel block major (the 9 taps of one
// block reuse the same x lines from L1); per chunk the A block [16][128]
// (k-major) is sampled into shared memory and the weight rows [16][O] are
// copied in by cp.async, both double-buffered (when the sampler's corner
// loads for chunk j + 1 issue: see PREFETCH_MIN_NQ below).
// Thread (ty, tx) = (tid / 16, tid % 16) owns pixels ty*4 + {0..3} and
// 64 + ty*4 + {0..3} by outputs tx*4 + 64 q + {0..3}, q < O / 64: per k two
// 16-byte A loads and O / 64 16-byte weight loads feed 8 x O / 16 FMAs.
namespace f32t {
constexpr int TH = 8, TW = 16, TM = TH * TW;  // output tile
constexpr int KC = 16;                         // channels of one tap a K chunk
constexpr int LDA = TM + 4;                    // A chunk row (one channel) in floats
static_assert(TM == 128 && NT == 256, "thread layout: 16 x 16, 8 pixels x O/16 outputs");

// By the output width (tools/dcn_train_designs.py): O = 256 (NQ 4, 128
// accumulators, 244 registers) issues chunk j + 1's corner loads before chunk
// j's FMAs and consumes them after (1.05x faster than after the FMAs); O <= 128
// issues them after the FMAs (1.08x faster than before). One CTA an SM: two
// at O <= 128 (126 registers) were no faster.
constexpr int PREFETCH_MIN_NQ = 4;
__host__ __device__ constexpr int smem_bytes(int O) { return 2 * KC * (LDA + O) * 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
}  // namespace f32t

// NQ = O / 64; ROWS: clampR is a per-image-row table [B*H] (the cascade).
template <int NQ, bool ROWS>
__global__ void __launch_bounds__(NT, 1)
dcn_f32_tiled_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                     const float* __restrict__ mask, const float* __restrict__ weight,
                     const float* __restrict__ bias, const float* __restrict__ clampR,
                     float* __restrict__ out, Dims d, int tiles_x, int tiles_per_img) {
  using namespace f32t;
  constexpr int O = 64 * NQ;
  constexpr bool PREFETCH = NQ >= PREFETCH_MIN_NQ;
  extern __shared__ __align__(16) float smem_f[];
  float* const As = smem_f;                 // [2][KC][LDA]
  float* const Bs = smem_f + 2 * KC * LDA;  // [2][KC][O]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / tiles_per_img, rem = blockIdx.x - b * tiles_per_img;
  const int ty0 = (rem / tiles_x) * TH, tx0 = (rem % tiles_x) * TW;
  const int Cg = d.C / d.G;
  const int nq = (d.C / KC) * KK;
  const float* xb = x + (size_t)b * d.H * d.W * d.C;

  // sampler: pixel sm of the tile, channels sh*8 .. sh*8+7 of each chunk
  const int sm = tid & (TM - 1), sh = tid >> 7;
  const int sy = ty0 + sm / TW, sx = tx0 + sm % TW;
  const bool svalid = sy < d.H && sx < d.W;
  const size_t sp = svalid ? ((size_t)b * d.H + sy) * d.W + sx : 0;
  float4 q[4][2];
  float cw[4], mk;
  auto issue = [&](int j) {  // geometry and corner loads of chunk j
    const int cb = j / KK, k = j - cb * KK;
    const int c = cb * KC + sh * 8, g = c / Cg;
#pragma unroll
    for (int cn = 0; cn < 4; ++cn) {
      q[cn][0] = q[cn][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      cw[cn] = 0.f;
    }
    mk = 0.f;
    if (svalid) {
      const size_t gk = (sp * d.G + g) * KK + k;
      const float2 o = __ldg(reinterpret_cast<const float2*>(offset) + gk);
      const float r = ROWS ? __ldg(clampR + (size_t)b * d.H + sy) : __ldg(clampR + g * KK + k);
      const DcnTap t = dcn_tap(sy, sx, k, o.x, o.y, r, d.H, d.W);
      mk = __ldg(mask + gk);
#pragma unroll
      for (int cn = 0; cn < 4; ++cn) {
        cw[cn] = t.cw[cn];
        const int pix = dcn_corner(t, cn, d.H, d.W);
        if (pix >= 0) {
          const float4* src = reinterpret_cast<const float4*>(xb + (size_t)pix * d.C + c);
          q[cn][0] = __ldg(src);
          q[cn][1] = __ldg(src + 1);
        }
      }
    }
  };
  auto finish = [&](float* a) {  // the sampled values into an A stage
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
    for (int cn = 0; cn < 4; ++cn) {
      const float u[8] = {q[cn][0].x, q[cn][0].y, q[cn][0].z, q[cn][0].w,
                          q[cn][1].x, q[cn][1].y, q[cn][1].z, q[cn][1].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaf(u[e], cw[cn], v[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) a[(sh * 8 + e) * LDA + sm] = v[e] * mk;
  };
  auto load_w = [&](int j, float* bs) {  // weight rows of chunk j into a B stage
    const int cb = j / KK, k = j - cb * KK;
    const float* src = weight + ((size_t)k * d.C + cb * KC) * O;
    for (int i = tid; i < KC * O / 4; i += NT) cp_async16(bs + 4 * i, src + 4 * i);
    cp_async_commit();
  };

  float acc[8][4 * NQ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 4 * NQ; ++jj) acc[i][jj] = 0.f;

  load_w(0, Bs);
  issue(0);
  finish(As);
  cp_async_wait_all();
  __syncthreads();
  for (int j = 0; j < nq; ++j) {
    const int s = j & 1;
    if (j + 1 < nq) {
      load_w(j + 1, Bs + (s ^ 1) * KC * O);
      if constexpr (PREFETCH) issue(j + 1);
    }
    const float* a = As + s * KC * LDA;
    const float* bw = Bs + s * KC * O;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + kk * LDA + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + kk * LDA + 64 + ty * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[4 * NQ];
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq) {
        const float4 t = *reinterpret_cast<const float4*>(bw + kk * O + qq * 64 + tx * 4);
        bv[4 * qq] = t.x;
        bv[4 * qq + 1] = t.y;
        bv[4 * qq + 2] = t.z;
        bv[4 * qq + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4 * NQ; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    if (j + 1 < nq) {  // chunk j + 1's samples into the other A stage
      if constexpr (!PREFETCH) issue(j + 1);
      finish(As + (s ^ 1) * KC * LDA);
    }
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const int h = ty0 + m / TW, w = tx0 + m % TW;
    if (h < d.H && w < d.W) {
      float* o = out + (((size_t)b * d.H + h) * d.W + w) * O + tx * 4;
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq) {
        float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
        if (bias) bb = __ldg(reinterpret_cast<const float4*>(bias + qq * 64 + tx * 4));
        *reinterpret_cast<float4*>(o + qq * 64) =
            make_float4(acc[i][4 * qq] + bb.x, acc[i][4 * qq + 1] + bb.y, acc[i][4 * qq + 2] + bb.z,
                        acc[i][4 * qq + 3] + bb.w);
      }
    }
  }
}

template <typename T, typename K>
int launch_t(K kernel, unsigned int blocks, size_t smem, cudaStream_t s, const void* x,
             const float* offset, const float* mask, const void* weight, const float* bias,
             const float* clampR, void* out, Dims d) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, NT, smem, s>>>(static_cast<const T*>(x), offset, mask,
                                  static_cast<const T*>(weight), bias, clampR,
                                  static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

template <bool ROWS>
int f32_tiled_launch(const void* x, const float* offset, const float* mask, const void* weight,
                     const float* bias, const float* clampR, void* out, Dims d, cudaStream_t s) {
  if (!f32_tiled_envelope(d.C, d.O, d.G) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(weight) % 16 != 0 ||
      (bias != nullptr && reinterpret_cast<uintptr_t>(bias) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (d.W + f32t::TW - 1) / f32t::TW;
  const int tiles_per_img = tiles_x * ((d.H + f32t::TH - 1) / f32t::TH);
  const long long blocks = (long long)d.B * tiles_per_img;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = f32t::smem_bytes(d.O);
  auto run = [&](auto kernel) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned int)blocks, NT, smem, s>>>(
        static_cast<const float*>(x), offset, mask, static_cast<const float*>(weight), bias, clampR,
        static_cast<float*>(out), d, tiles_x, tiles_per_img);
    return (int)cudaGetLastError();
  };
  if (d.O == 256) return run(dcn_f32_tiled_kernel<4, ROWS>);
  if (d.O == 128) return run(dcn_f32_tiled_kernel<2, ROWS>);
  return run(dcn_f32_tiled_kernel<1, ROWS>);
}

// kind: KIND_F32 (the tiled float32 kernel, inside its envelope only), KIND_BF16
// (wmma), KIND_F32_FLAT (the flat float32 kernel, any widths up to O = 256).
// ROWS = false: clampR is [G*9]; ROWS = true: clampR is [B*H].
template <bool ROWS>
int dcn_launch(const void* x, const void* offset, const void* mask, const void* weight,
               const void* bias, const void* clampR, void* out, int B, int H, int W, int C, int O,
               int G, int kind, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (G < 1 || C % G != 0 || O < 1 || O > 256) return (int)cudaErrorInvalidValue;
  const Dims d = {B, H, W, C, O, G};
  const int Cg = C / G;
  const long long P = (long long)B * H * W;
  const unsigned int blocks = (unsigned int)((P + TP - 1) / TP);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* of = static_cast<const float*>(offset);
  const float* mf = static_cast<const float*>(mask);
  const float* bf = static_cast<const float*>(bias);
  const float* cr = static_cast<const float*>(clampR);
  if (kind == KIND_F32) return f32_tiled_launch<ROWS>(x, of, mf, weight, bf, cr, out, d, s);
  if (kind == KIND_BF16) {
    if (C % 16 != 0 || O % 16 != 0) return (int)cudaErrorInvalidValue;
    const size_t tile_b = (size_t)TP * (C + 8) * sizeof(bf16);
    const size_t stage_b = (size_t)TP * O * sizeof(float);
    const size_t smem = tile_b > stage_b ? tile_b : stage_b;
    if (Cg % 8 == 0)
      return launch_t<bf16>(dcn_bf16_kernel<8, ROWS>, blocks, smem, s, x, of, mf, weight, bf, cr,
                            out, d);
    return launch_t<bf16>(dcn_bf16_kernel<1, ROWS>, blocks, smem, s, x, of, mf, weight, bf, cr,
                          out, d);
  }
  if (kind != KIND_F32_FLAT) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TP * (C + 4) * sizeof(float);
  if (Cg % 4 == 0)
    return launch_t<float>(dcn_f32_kernel<4, ROWS>, blocks, smem, s, x, of, mf, weight, bf, cr,
                           out, d);
  return launch_t<float>(dcn_f32_kernel<1, ROWS>, blocks, smem, s, x, of, mf, weight, bf, cr, out,
                         d);
}

}  // namespace

// x [B,H,W,C], offset [B,H,W,G,9,2] f32 (dy,dx), mask [B,H,W,G,9] f32,
// weight [9*C, O] (row k*C + c) in x's dtype, bias [O] f32 or null,
// clampR [G*9] f32 (inf = no clamp), out [B,H,W,O] in x's dtype. kind: 0 the
// tiled float32 kernel (C % 16 == 0, (C/G) % 8 == 0, O in {64, 128, 256}, x,
// weight and bias 16-byte aligned; anything else is refused), 1 bf16 (wmma),
// 2 the flat float32 kernel (any C, G, O <= 256).
extern "C" int dcn_fwd(const void* x, const void* offset, const void* mask, const void* weight,
                       const void* bias, const void* clampR, void* out, int B, int H, int W, int C,
                       int O, int G, int kind, void* stream) {
  return dcn_launch<false>(x, offset, mask, weight, bias, clampR, out, B, H, W, C, O, G, kind,
                           stream);
}

// Dynamic shared memory a CTA of the tiled float32 kernel asks for at O outputs.
extern "C" int dcn_f32_smem_bytes(int O) { return f32t::smem_bytes(O); }

// The cascade: as dcn_fwd, but rowR [B*H] f32 holds the clamp radius of every
// image row (R_tail on the rows of the selected row blocks, R elsewhere).
extern "C" int dcn_cascade_fwd(const void* x, const void* offset, const void* mask,
                               const void* weight, const void* bias, const void* rowR, void* out,
                               int B, int H, int W, int C, int O, int G, int kind,
                               void* stream) {
  return dcn_launch<true>(x, offset, mask, weight, bias, rowR, out, B, H, W, C, O, G, kind,
                          stream);
}
