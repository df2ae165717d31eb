// Modulated deformable convolution (DCNv2) forward: 3x3, stride 1, pad 1,
// G deformable groups, channels-last.
//
// Replaces the Pallas kernel `_kernel_core` (glare_tpu/ops/dcn_pallas.py, entry
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
// for bf16), close to the bytes of x, offset, mask and the output. Design: one
// block owns 64 output pixels and all O outputs. Per tap k it samples the
// [64, C] tile into shared memory (threads spread over (pixel, group,
// 16-byte channel chunk), so reads are contiguous), then multiplies it by the
// tap's [C, O] weight slice, read from L2. bf16: wmma 16x16x16 fragments, each
// warp owns O/16 column fragments interleaved by 8, all 4 row fragments.
// f32: scalar FMA, each thread 8 pixels x up to 8 outputs.
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

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TP = 64;    // pixels per block
constexpr int NT = 256;   // threads
constexpr int KK = 9;     // taps

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

// ROWS = false: clampR is [G*9]; ROWS = true: clampR is [B*H].
template <bool ROWS>
int dcn_launch(const void* x, const void* offset, const void* mask, const void* weight,
               const void* bias, const void* clampR, void* out, int B, int H, int W, int C, int O,
               int G, int is_bf16, void* stream) {
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
  if (is_bf16) {
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
// clampR [G*9] f32 (inf = no clamp), out [B,H,W,O] in x's dtype.
extern "C" int dcn_fwd(const void* x, const void* offset, const void* mask, const void* weight,
                       const void* bias, const void* clampR, void* out, int B, int H, int W, int C,
                       int O, int G, int is_bf16, void* stream) {
  return dcn_launch<false>(x, offset, mask, weight, bias, clampR, out, B, H, W, C, O, G, is_bf16,
                           stream);
}

// The cascade: as dcn_fwd, but rowR [B*H] f32 holds the clamp radius of every
// image row (R_tail on the rows of the selected row blocks, R elsewhere).
extern "C" int dcn_cascade_fwd(const void* x, const void* offset, const void* mask,
                               const void* weight, const void* bias, const void* rowR, void* out,
                               int B, int H, int W, int C, int O, int G, int is_bf16,
                               void* stream) {
  return dcn_launch<true>(x, offset, mask, weight, bias, rowR, out, B, H, W, C, O, G, is_bf16,
                          stream);
}
