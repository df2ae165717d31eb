// Modulated deformable convolution (DCNv2) backward, float32 and bf16: 3x3,
// stride 1, pad 1, G deformable groups, channels-last.
//
// No Pallas kernel to replace: the JAX package gets this gradient from XLA
// autodiff of glare_tpu/ops/dcn.py `modulated_deform_conv_chain` (the training
// default) and `modulated_deform_conv`. The function is the reference CUDA
// extension's backward (`modulated_deformable_im2col`, `col2im_coord`,
// `col2im`), with offsets clamped per (g, k) to +-R[g][k] as in the forward
// (R = inf: no clamp). The offset derivative is the floor-based one of
// `col2im_coord`: at an offset that is exactly an integer the sample's lower
// corner is floor(p) and its weight slope is -1, the upper corner's +1. (The
// chain op's autodiff splits such ties through |.| and max(0, .) and gets
// another, wrong, value there; the port does not copy it.) Beyond the clamp the
// offset gradient is 0, on it 1/2 (the slope torch and XLA give min/max ties).
//
// Three kernels, each templated on the type of x and of the column (float or
// bf16: one sampler for both), each with a float32 and a bf16 entry
// (dcn_bwd_<kernel> and dcn_bwd_<kernel>_bf16) that the wrapper
// (glare_tpu_torch/ops/dcn.py, modulated_deform_conv_backward_cuda) launches
// per chunk of images:
//   dcn_bwd_im2col  col[p, k*C + g*Cg + c] = mask * bilinear sample: the forward's
//                   masked column, by the forward's sampler (csrc/dcn_fwd.cu
//                   sample_tap, same arithmetic). The wrapper then takes
//                   grad_weight = col^T grad_out and grad_col = grad_out W^T as
//                   two matrix products (plain products outside any kernel,
//                   as XLA emits them in the JAX package). In bf16 the
//                   column is rounded once, from the same float32 value by
//                   the same sequence of operations as the A block of
//                   csrc/dcn_hopper.cu (the corners fma'd in order into 0,
//                   times the mask, round to nearest), so grad_weight is the
//                   gradient of the forward that ran.
//   dcn_bwd_coord   one warp per (pixel, group, tap), lanes over the group's Cg
//                   channels of grad_col: grad_mask = sum sample * grad_col,
//                   grad_offset = mask * sum d(bilinear)/d(y, x) * grad_col;
//                   sums in float32, both outputs float32 in either entry.
//   dcn_bwd_input   grad_x: the same warps scatter mask * corner weight *
//                   grad_col into the four corners with float32 atomics (the
//                   reference's col2im) into a float32 grad_x in either entry
//                   (the wrapper casts it). Launched only when x needs a
//                   gradient.
//
// What bounds it on an H100: the two products, 2 x 2*P*9*C*O FLOP on the
// float32 units (no TF32), or on the bf16 tensor cores (bf16 entries; there
// the column's and grad_col's round trips through device memory weigh more). The kernels move col and grad_col (P*9*C floats
// each) once and gather x's corners from L2; that is a fraction of the
// products' time. This first design keeps every step simple and exact: the
// column and grad_col pass through device memory, and the gathers are scalar.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KK = 9;   // taps
constexpr int NT = 256; // threads a block

struct Dims {
  int B, H, W, C, G;
};

// Slope of min(max(o, -r), r) at o: 1 inside, 1/2 on the radius, 0 beyond.
__device__ __forceinline__ float clamp_slope(float o, float r) {
  const float a = fabsf(o);
  return a < r ? 1.f : (a == r ? 0.5f : 0.f);
}

// Where tap k of pixel p samples for group g: the forward's rule.
struct Tap {
  bool in;  // inside (-1, H) x (-1, W)
  int b, y0, x0;
  float ly, lx, hy, hx, m, sy, sx;
};

__device__ __forceinline__ Tap tap_at(const float* __restrict__ offset,
                                      const float* __restrict__ mask,
                                      const float* __restrict__ radii, const Dims& d,
                                      long long p, int g, int k) {
  Tap t;
  const int w_ = (int)(p % d.W);
  const long long q = p / d.W;
  const int h_ = (int)(q % d.H);
  t.b = (int)(q / d.H);
  const size_t gk = ((size_t)p * d.G + g) * KK + k;
  const float r = radii[g * KK + k];
  const float oy = offset[gk * 2], ox = offset[gk * 2 + 1];
  const float py = (float)(h_ + k / 3 - 1) + fminf(fmaxf(oy, -r), r);
  const float px = (float)(w_ + k % 3 - 1) + fminf(fmaxf(ox, -r), r);
  t.in = py > -1.f && py < (float)d.H && px > -1.f && px < (float)d.W;
  const float y0f = floorf(py), x0f = floorf(px);
  t.y0 = t.in ? (int)y0f : 0;
  t.x0 = t.in ? (int)x0f : 0;
  t.ly = py - y0f;
  t.lx = px - x0f;
  t.hy = 1.f - t.ly;
  t.hx = 1.f - t.lx;
  t.m = mask[gk];
  t.sy = clamp_slope(oy, r);
  t.sx = clamp_slope(ox, r);
  return t;
}

// Offsets of the four corners (y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1) in an
// image's [H, W, C] block; -1 for a corner outside the image.
__device__ __forceinline__ void corners(const Tap& t, const Dims& d, long long o[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = t.y0 + (c >> 1), xx = t.x0 + (c & 1);
    o[c] = (t.in && yy >= 0 && yy < d.H && xx >= 0 && xx < d.W)
               ? ((long long)yy * d.W + xx) * d.C
               : -1;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

unsigned int grid_for(long long work, int per_block) {
  const long long need = (work + per_block - 1) / per_block;
  const long long cap = 132LL * 64;  // grid-stride beyond: 64 blocks an SM of an H100
  return (unsigned int)(need < cap ? (need > 0 ? need : 1) : cap);
}

// col [P, 9*C]: thread per (pixel, tap, group, VEC channels), in col's order.
// Each value: the corners fma'd in order into 0, times the mask, one rounding
// to T (the A block of csrc/dcn_hopper.cu, for T = bf16).
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
              const float* __restrict__ mask, const float* __restrict__ radii,
              T* __restrict__ col, Dims d) {
  const int Cg = d.C / d.G;
  const int lp = Cg / VEC;
  const long long P = (long long)d.B * d.H * d.W;
  const long long items = P * KK * d.G * lp;
  for (long long it = (long long)blockIdx.x * NT + threadIdx.x; it < items;
       it += (long long)gridDim.x * NT) {
    const int sub = (int)(it % lp);
    long long q = it / lp;
    const int g = (int)(q % d.G);
    q /= d.G;
    const int k = (int)(q % KK);
    const long long p = q / KK;
    const Tap t = tap_at(offset, mask, radii, d, p, g, k);
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    if (t.in) {
      long long o[4];
      corners(t, d, o);
      const T* xb = x + (size_t)t.b * d.H * d.W * d.C + g * Cg + sub * VEC;
      const float cw[4] = {t.hy * t.hx, t.hy * t.lx, t.ly * t.hx, t.ly * t.lx};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (o[c] < 0) continue;
        float v[VEC];
        if constexpr (VEC == 4 && sizeof(T) == 4) {
          const float4 f = *reinterpret_cast<const float4*>(xb + o[c]);
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = to_f(xb[o[c] + i]);
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v[i], cw[c], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] *= t.m;
    }
    T* dst = col + (size_t)p * KK * d.C + (size_t)k * d.C + g * Cg + sub * VEC;
    if constexpr (VEC == 4 && sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = from_f<T>(acc[i]);
    }
  }
}

// grad_mask [P, G, 9], grad_offset [P, G, 9, 2]: a warp per (pixel, group, tap),
// warp index = (p * G + g) * 9 + k, the outputs' own order. Sums in float32.
template <typename T>
__global__ void __launch_bounds__(NT)
coord_kernel(const T* __restrict__ x, const float* __restrict__ offset,
             const float* __restrict__ mask, const float* __restrict__ radii,
             const T* __restrict__ gcol, float* __restrict__ goff,
             float* __restrict__ gmask, Dims d) {
  const int lane = threadIdx.x & 31;
  const int Cg = d.C / d.G;
  const long long nw = (long long)d.B * d.H * d.W * d.G * KK;
  const long long wpb = NT / 32;
  for (long long wi = (long long)blockIdx.x * wpb + (threadIdx.x >> 5); wi < nw;
       wi += (long long)gridDim.x * wpb) {
    const int k = (int)(wi % KK);
    const long long q = wi / KK;
    const int g = (int)(q % d.G);
    const long long p = q / d.G;
    const Tap t = tap_at(offset, mask, radii, d, p, g, k);
    float s = 0.f, gy = 0.f, gx = 0.f;
    if (t.in) {
      long long o[4];
      corners(t, d, o);
      const T* xb = x + (size_t)t.b * d.H * d.W * d.C + g * Cg;
      const T* gc = gcol + (size_t)p * KK * d.C + (size_t)k * d.C + g * Cg;
      for (int c = lane; c < Cg; c += 32) {
        const float v00 = o[0] >= 0 ? to_f(xb[o[0] + c]) : 0.f;
        const float v01 = o[1] >= 0 ? to_f(xb[o[1] + c]) : 0.f;
        const float v10 = o[2] >= 0 ? to_f(xb[o[2] + c]) : 0.f;
        const float v11 = o[3] >= 0 ? to_f(xb[o[3] + c]) : 0.f;
        const float gv = to_f(gc[c]);
        s = fmaf(gv, t.hy * (t.hx * v00 + t.lx * v01) + t.ly * (t.hx * v10 + t.lx * v11), s);
        gy = fmaf(gv, t.hx * (v10 - v00) + t.lx * (v11 - v01), gy);
        gx = fmaf(gv, t.hy * (v01 - v00) + t.ly * (v11 - v10), gx);
      }
    }
    s = warp_sum(s);
    gy = warp_sum(gy);
    gx = warp_sum(gx);
    if (lane == 0) {
      gmask[wi] = s;
      goff[wi * 2] = t.m * gy * t.sy;
      goff[wi * 2 + 1] = t.m * gx * t.sx;
    }
  }
}

// grad_x [B, H, W, C] float32 (zeroed by the caller): the same warps scatter
// into the corners.
template <typename T>
__global__ void __launch_bounds__(NT)
input_kernel(const float* __restrict__ offset, const float* __restrict__ mask,
             const float* __restrict__ radii, const T* __restrict__ gcol,
             float* __restrict__ gx, Dims d) {
  const int lane = threadIdx.x & 31;
  const int Cg = d.C / d.G;
  const long long nw = (long long)d.B * d.H * d.W * d.G * KK;
  const long long wpb = NT / 32;
  for (long long wi = (long long)blockIdx.x * wpb + (threadIdx.x >> 5); wi < nw;
       wi += (long long)gridDim.x * wpb) {
    const int k = (int)(wi % KK);
    const long long q = wi / KK;
    const int g = (int)(q % d.G);
    const long long p = q / d.G;
    const Tap t = tap_at(offset, mask, radii, d, p, g, k);
    if (!t.in) continue;
    long long o[4];
    corners(t, d, o);
    const float cw[4] = {t.hy * t.hx, t.hy * t.lx, t.ly * t.hx, t.ly * t.lx};
    float* xb = gx + (size_t)t.b * d.H * d.W * d.C + g * Cg;
    const T* gc = gcol + (size_t)p * KK * d.C + (size_t)k * d.C + g * Cg;
    for (int c = lane; c < Cg; c += 32) {
      const float gv = t.m * to_f(gc[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (o[j] >= 0) atomicAdd(xb + o[j] + c, cw[j] * gv);
    }
  }
}

bool bad_dims(int B, int H, int W, int C, int G) {
  return B < 0 || H < 0 || W < 0 || G < 1 || C < 1 || C % G != 0;
}

template <typename T>
int im2col(const void* x, const void* offset, const void* mask, const void* radii, void* col,
           int B, int H, int W, int C, int G, void* stream) {
  if (bad_dims(B, H, W, C, G)) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  const Dims d = {B, H, W, C, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* of = static_cast<const float*>(offset);
  const float* mf = static_cast<const float*>(mask);
  const float* rf = static_cast<const float*>(radii);
  T* ct = static_cast<T*>(col);
  const long long P = (long long)B * H * W;
  if ((C / G) % 4 == 0) {
    im2col_kernel<T, 4><<<grid_for(P * KK * C / 4, NT), NT, 0, s>>>(xt, of, mf, rf, ct, d);
  } else {
    im2col_kernel<T, 1><<<grid_for(P * KK * C, NT), NT, 0, s>>>(xt, of, mf, rf, ct, d);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int coord(const void* x, const void* offset, const void* mask, const void* radii, const void* gcol,
          void* grad_offset, void* grad_mask, int B, int H, int W, int C, int G, void* stream) {
  if (bad_dims(B, H, W, C, G)) return (int)cudaErrorInvalidValue;
  const long long nw = (long long)B * H * W * G * KK;
  if (nw == 0) return 0;
  const Dims d = {B, H, W, C, G};
  coord_kernel<T><<<grid_for(nw, NT / 32), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<const float*>(radii), static_cast<const T*>(gcol),
      static_cast<float*>(grad_offset), static_cast<float*>(grad_mask), d);
  return (int)cudaGetLastError();
}

template <typename T>
int input(const void* offset, const void* mask, const void* radii, const void* gcol, void* grad_x,
          int B, int H, int W, int C, int G, void* stream) {
  if (bad_dims(B, H, W, C, G)) return (int)cudaErrorInvalidValue;
  const long long nw = (long long)B * H * W * G * KK;
  if (nw == 0) return 0;
  const Dims d = {B, H, W, C, G};
  input_kernel<T><<<grid_for(nw, NT / 32), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<const float*>(radii), static_cast<const T*>(gcol), static_cast<float*>(grad_x),
      d);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B,H,W,C] f32, offset [B,H,W,G,9,2] f32 (dy,dx), mask [B,H,W,G,9] f32,
// radii [G*9] f32 (inf = no clamp) -> col [B*H*W, 9*C] f32 (row k*C + g*Cg + c).
extern "C" int dcn_bwd_im2col(const void* x, const void* offset, const void* mask,
                              const void* radii, void* col, int B, int H, int W, int C, int G,
                              void* stream) {
  return im2col<float>(x, offset, mask, radii, col, B, H, W, C, G, stream);
}

// gcol [B*H*W, 9*C] f32 (grad_out W^T) -> grad_offset [B,H,W,G,9,2], grad_mask [B,H,W,G,9].
extern "C" int dcn_bwd_coord(const void* x, const void* offset, const void* mask,
                             const void* radii, const void* gcol, void* grad_offset,
                             void* grad_mask, int B, int H, int W, int C, int G, void* stream) {
  return coord<float>(x, offset, mask, radii, gcol, grad_offset, grad_mask, B, H, W, C, G, stream);
}

// gcol as above -> grad_x [B,H,W,C] f32, accumulated (the caller zeroes it).
extern "C" int dcn_bwd_input(const void* offset, const void* mask, const void* radii,
                             const void* gcol, void* grad_x, int B, int H, int W, int C, int G,
                             void* stream) {
  return input<float>(offset, mask, radii, gcol, grad_x, B, H, W, C, G, stream);
}

// The bf16 entries: x and col (and gcol) bf16, offset, mask, radii, grad_offset,
// grad_mask and grad_x float32, as above.
extern "C" int dcn_bwd_im2col_bf16(const void* x, const void* offset, const void* mask,
                                   const void* radii, void* col, int B, int H, int W, int C, int G,
                                   void* stream) {
  return im2col<bf16>(x, offset, mask, radii, col, B, H, W, C, G, stream);
}

extern "C" int dcn_bwd_coord_bf16(const void* x, const void* offset, const void* mask,
                                  const void* radii, const void* gcol, void* grad_offset,
                                  void* grad_mask, int B, int H, int W, int C, int G, void* stream) {
  return coord<bf16>(x, offset, mask, radii, gcol, grad_offset, grad_mask, B, H, W, C, G, stream);
}

extern "C" int dcn_bwd_input_bf16(const void* offset, const void* mask, const void* radii,
                                  const void* gcol, void* grad_x, int B, int H, int W, int C, int G,
                                  void* stream) {
  return input<bf16>(offset, mask, radii, gcol, grad_x, B, H, W, C, G, stream);
}
