// Modulated deformable convolution (DCNv2) backward, float32 and bf16: 3x3,
// stride 1, pad 1, G deformable groups, channels-last.
//
// What it replaces: no Pallas kernel. The JAX package gets this gradient from
// XLA autodiff of glare_tpu/ops/dcn.py:185 `modulated_deform_conv_chain` (the
// training default) and `modulated_deform_conv`. The function is the reference
// CUDA extension's backward (`modulated_deformable_im2col`, `col2im_coord`,
// `col2im`), with offsets clamped per (g, k) to +-R[g][k] as in the forward
// (R = inf: no clamp). The offset derivative is the floor-based one of
// `col2im_coord`: at an offset that is exactly an integer the sample's lower
// corner is floor(p) and its weight slope is -1, the upper corner's +1. (The
// chain op's autodiff splits such ties through |.| and max(0, .) and gets
// another, wrong, value there; the port does not copy it.) Beyond the clamp the
// offset gradient is 0, on it 1/2 (the slope torch and XLA give min/max ties).
//
// The wrapper (glare_tpu_torch/ops/dcn.py, modulated_deform_conv_backward_cuda)
// works per chunk of images: grad_col = grad_out W^T (a plain product), then
// ONE launch of the gather pass here, then grad_weight += col^T grad_out (a
// plain product; both products as XLA emits them in the JAX package). The
// pass, per (pixel, group, tap), computes the tap's geometry once
// (csrc/dcn_tap.cuh, the forward's own sampler arithmetic), gathers the four
// corners once and emits from the same registers:
//   col[p, k*C + g*Cg + c] = mask * bilinear sample: the forward's masked
//       column, bit for bit what csrc/dcn_fwd.cu's float32 kernel multiplies
//       and, in bf16 (one rounding of the same float32 value), the A block of
//       csrc/dcn_hopper.cu; so grad_weight is the gradient of the forward
//       that ran;
//   grad_mask = sum_c sample * grad_col, grad_offset = mask * sum_c
//       d(bilinear)/d(y, x) * grad_col, float32 sums, float32 outputs;
//   grad_x (instantiation NEED_X, when the caller asks): mask * corner weight
//       * grad_col scattered into the four corners with float32 atomics (the
//       reference's col2im) into a float32 grad_x that the caller zeroed.
//       The atomics add in no fixed order: grad_x varies by float32 rounding
//       between runs, far inside the 1e-4 (of its largest) the card's check
//       allows.
// Work mapping: L lanes (8, or 4 when a group has only 4 vectors) per
// (pixel, group, tap), each on 16-byte vectors of channels (4 float32 or 8
// bf16), so a corner read, the grad_col read and the column write are L x 16
// contiguous bytes; three log2(L)-step shuffle sums; 32-bit index arithmetic
// inside the item. A scalar instantiation serves widths that are not whole
// vectors.
//
// What bounds it on an H100: the two products, 2 x 2*P*9*C*O FLOP, on the
// float32 units (67 TFLOP/s, no TF32) or the bf16 tensor cores. The pass
// itself is bound by bytes: grad_col read and the column written once each
// (P*9*C values each way) and x's corners gathered through L1/L2.
// What held the first design back (three kernels: im2col, coord, input):
// the corners gathered and the tap geometry computed twice (im2col and
// coord), and coord gave one warp to each (pixel, group, tap) -- at Cg = 32
// one channel a lane, three 5-step warp sums and 64-bit divisions per item:
// issue-bound, 2.1 ms of warp_1's 4.9 ms (float32) and as slow in bf16.
// Measured (tools/dcn_train_designs.py, H100 80GB HBM3 at 700 W; warp_0 x
// [2,128,128,256] -> 256 / warp_1 x [2,256,256,128] -> 128, G 4): float32
// 2.11-2.12 / 3.01-3.09 ms against the first design's 2.56-2.64 / 4.76-4.84,
// of it the pass 0.34 / 0.80 and the two products 1.64-1.69 / 2.05-2.07;
// bf16 0.51-0.53 / 1.13 against 1.12-1.13 / 3.08-3.09, the pass 0.24 / 0.60.
// Without corner loads the pass keeps 0.24 / 0.57 ms (float32): grad_col in
// and the column out, not the gathers, bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dcn_tap.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KK = 9;    // taps
constexpr int NT = 256;  // threads a block

struct Dims {
  int B, H, W, C, G;
};

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&o)[V]);
template <>
__device__ __forceinline__ void load_v<float, 4>(const float* p, float (&o)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
template <>
__device__ __forceinline__ void load_v<float, 1>(const float* p, float (&o)[1]) { o[0] = __ldg(p); }
template <>
__device__ __forceinline__ void load_v<bf16, 8>(const bf16* p, float (&o)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] << 16);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}
template <>
__device__ __forceinline__ void load_v<bf16, 1>(const bf16* p, float (&o)[1]) {
  o[0] = __bfloat162float(p[0]);
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&o)[V]);
template <>
__device__ __forceinline__ void store_v<float, 4>(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ void store_v<float, 1>(float* p, const float (&o)[1]) { p[0] = o[0]; }
template <>
__device__ __forceinline__ void store_v<bf16, 8>(bf16* p, const float (&o)[8]) {
  uint4 t;
  uint32_t* w = reinterpret_cast<uint32_t*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = t;
}
template <>
__device__ __forceinline__ void store_v<bf16, 1>(bf16* p, const float (&o)[1]) {
  p[0] = __float2bfloat16_rn(o[0]);
}

// The gather pass. Item it = (p * G + g) * 9 + k, the order of grad_mask and
// grad_offset; L lanes an item, V channels a lane and step.
template <typename T, int V, int L, bool NEED_X>
__global__ void __launch_bounds__(NT)
pass_kernel(const T* __restrict__ x, const float* __restrict__ offset,
            const float* __restrict__ mask, const float* __restrict__ radii,
            const T* __restrict__ gcol, T* __restrict__ col, float* __restrict__ goff,
            float* __restrict__ gmask, float* __restrict__ gx, Dims d) {
  constexpr int PER_WARP = 32 / L;
  const int lane = threadIdx.x & 31, sub = lane & (L - 1);
  const int Cg = d.C / d.G;
  const int HW = d.H * d.W;
  const long long items = (long long)d.B * HW * d.G * KK;
  const long long warps = (long long)gridDim.x * (NT / 32);
  for (long long base = ((long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5)) * PER_WARP;
       base < items; base += warps * PER_WARP) {
    const long long it = base + lane / L;
    const bool ok = it < items;
    float s = 0.f, sgy = 0.f, sgx = 0.f, m = 0.f, slope_y = 0.f, slope_x = 0.f;
    if (ok) {
      const int i32 = (int)it, q = i32 / KK, k = i32 - q * KK;  // items < 2^31
      const int p = q / d.G, g = q - p * d.G;
      const int b = p / HW, hw = p - b * HW;
      const int h = hw / d.W, w = hw - h * d.W;
      const float2 o = __ldg(reinterpret_cast<const float2*>(offset) + it);
      const float r = __ldg(radii + g * KK + k);
      m = __ldg(mask + it);
      slope_y = dcn_clamp_slope(o.x, r);
      slope_x = dcn_clamp_slope(o.y, r);
      const DcnTap t = dcn_tap(h, w, k, o.x, o.y, r, d.H, d.W);
      int pix[4];
#pragma unroll
      for (int cn = 0; cn < 4; ++cn) pix[cn] = dcn_corner(t, cn, d.H, d.W);
      const size_t img = (size_t)b * HW * d.C + g * Cg;
      const size_t row = (size_t)p * KK * d.C + k * d.C + g * Cg;
      for (int c = sub * V; c < Cg; c += L * V) {
        float v[4][V];
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
          if (pix[cn] >= 0) {
            load_v<T, V>(x + img + (size_t)pix[cn] * d.C + c, v[cn]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[cn][e] = 0.f;
          }
        }
        float gv[V], cv[V];
        load_v<T, V>(gcol + row + c, gv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float a = 0.f;  // the forward's sample: corners fma'd in order into 0
#pragma unroll
          for (int cn = 0; cn < 4; ++cn) a = fmaf(v[cn][e], t.cw[cn], a);
          cv[e] = a * m;
          s = fmaf(gv[e], a, s);
          sgy = fmaf(gv[e], t.hx * (v[2][e] - v[0][e]) + t.lx * (v[3][e] - v[1][e]), sgy);
          sgx = fmaf(gv[e], t.hy * (v[1][e] - v[0][e]) + t.ly * (v[3][e] - v[2][e]), sgx);
        }
        store_v<T, V>(col + row + c, cv);
        if constexpr (NEED_X) {
#pragma unroll
          for (int cn = 0; cn < 4; ++cn) {
            if (pix[cn] < 0) continue;
            float* dst = gx + img + (size_t)pix[cn] * d.C + c;
            const float wm = t.cw[cn] * m;
#pragma unroll
            for (int e = 0; e < V; ++e) atomicAdd(dst + e, wm * gv[e]);
          }
        }
      }
    }
#pragma unroll
    for (int sh = L / 2; sh > 0; sh >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, sh);
      sgy += __shfl_xor_sync(0xffffffffu, sgy, sh);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, sh);
    }
    if (ok && sub == 0) {
      gmask[it] = s;
      reinterpret_cast<float2*>(goff)[it] = make_float2(m * sgy * slope_y, m * sgx * slope_x);
    }
  }
}

unsigned int grid_for(long long items, int per_block) {
  const long long need = (items + per_block - 1) / per_block;
  const long long cap = 132LL * 32;  // grid-stride beyond: 32 blocks an SM of an H100
  return (unsigned int)(need < cap ? (need > 0 ? need : 1) : cap);
}

template <typename T, int V, int L>
int launch_pass(const void* x, const void* offset, const void* mask, const void* radii,
                const void* gcol, void* col, void* grad_offset, void* grad_mask, void* grad_x,
                const Dims& d, cudaStream_t s) {
  const long long items = (long long)d.B * d.H * d.W * d.G * KK;
  const unsigned int grid = grid_for(items, NT / L);
  auto run = [&](auto kernel) {
    kernel<<<grid, NT, 0, s>>>(static_cast<const T*>(x), static_cast<const float*>(offset),
                               static_cast<const float*>(mask), static_cast<const float*>(radii),
                               static_cast<const T*>(gcol), static_cast<T*>(col),
                               static_cast<float*>(grad_offset), static_cast<float*>(grad_mask),
                               static_cast<float*>(grad_x), d);
    return (int)cudaGetLastError();
  };
  return grad_x != nullptr ? run(pass_kernel<T, V, L, true>) : run(pass_kernel<T, V, L, false>);
}

template <typename T>
int pass(const void* x, const void* offset, const void* mask, const void* radii, const void* gcol,
         void* col, void* grad_offset, void* grad_mask, void* grad_x, int B, int H, int W, int C,
         int G, void* stream) {
  if (B < 0 || H < 0 || W < 0 || G < 1 || C < 1 || C % G != 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  if ((long long)B * H * W * G * KK >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // 32-bit index arithmetic inside an item
  const Dims d = {B, H, W, C, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(T);
  const int Cg = C / G;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(gcol) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(col) % 16 == 0;
  // lanes an item (tools/dcn_train_designs.py): float32 8 (one or two vectors a
  // lane; 4 lanes 1.15-1.35x slower), bf16 4 (8 lanes 1.2x slower at Cg 64)
  constexpr int LANES = sizeof(T) == 4 ? 8 : 4;
  if (aligned && Cg % (LANES * V) == 0)
    return launch_pass<T, V, LANES>(x, offset, mask, radii, gcol, col, grad_offset, grad_mask, grad_x, d, s);
  if (aligned && Cg % (4 * V) == 0)
    return launch_pass<T, V, 4>(x, offset, mask, radii, gcol, col, grad_offset, grad_mask, grad_x, d, s);
  return launch_pass<T, 1, 8>(x, offset, mask, radii, gcol, col, grad_offset, grad_mask, grad_x, d, s);
}

}  // namespace

// x [B,H,W,C] f32, offset [B,H,W,G,9,2] f32 (dy,dx), mask [B,H,W,G,9] f32,
// radii [G*9] f32 (inf = no clamp), gcol [B*H*W, 9*C] f32 (grad_out W^T, row
// k*C + g*Cg + c) -> col [B*H*W, 9*C] f32, grad_offset [B,H,W,G,9,2] f32,
// grad_mask [B,H,W,G,9] f32, and, when grad_x is not null, grad_x [B,H,W,C] f32
// accumulated (the caller zeroes it).
extern "C" int dcn_bwd_pass(const void* x, const void* offset, const void* mask, const void* radii,
                            const void* gcol, void* col, void* grad_offset, void* grad_mask,
                            void* grad_x, int B, int H, int W, int C, int G, void* stream) {
  return pass<float>(x, offset, mask, radii, gcol, col, grad_offset, grad_mask, grad_x, B, H, W, C,
                     G, stream);
}

// The bf16 entry: x, gcol and col bf16; offset, mask, radii, grad_offset,
// grad_mask and grad_x float32, as above.
extern "C" int dcn_bwd_pass_bf16(const void* x, const void* offset, const void* mask,
                                 const void* radii, const void* gcol, void* col, void* grad_offset,
                                 void* grad_mask, void* grad_x, int B, int H, int W, int C, int G,
                                 void* stream) {
  return pass<bf16>(x, offset, mask, radii, gcol, col, grad_offset, grad_mask, grad_x, B, H, W, C,
                    G, stream);
}
