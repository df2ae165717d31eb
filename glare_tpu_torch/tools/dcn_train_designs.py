"""Times the DCN training kernels against the designs they replace, on one card.

    python3 glare_tpu_torch/tools/dcn_train_designs.py    # needs the GPU and nvcc

At the two shapes one stage-3 training step gives the DCN (warp_0 x
[2,128,128,256] -> 256, warp_1 x [2,256,256,128] -> 128, G 4, clamp 2; offsets
of 1.5 px spread), in turns (A, B, ..., B, A), CUDA events, median of 5:

the float32 forward (``csrc/dcn_fwd.cu``)
  shipped          the tiled kernel (entry ``f32``)
  flat             the first float32 kernel (entry ``f32_flat``: 64 flat pixels a
                   block, the weight read from L2, sampling then products)
  (shipped: at O = 256 chunk j + 1's corner loads are issued before chunk j's
  products and consumed after them; at O <= 128 they are issued after the
  products; one CTA an SM)
  prefetch_all     loads issued before the products at every O
  prefetch_none    loads issued after the products at every O
  two_ctas_an_sm   launch bounds of two CTAs an SM where O <= 128 (126 registers)
  probe_no_fma     no products: what sampling, copies and barriers cost
  probe_no_gather  no corner loads: what the products and copies cost
the backward, float32 and bf16 (``csrc/dcn_bwd.cu``)
  shipped          grad_col product, the gather pass, grad_weight product
  three_kernel     the first design, kept below as source text (OLD_BWD_SRC):
                   im2col, the grad_weight product, the grad_col product, coord
  pass alone, by design of the pass: shipped (8 lanes an item in float32, 4 in
                   bf16, where the group allows), lanes_8 and lanes_4 (that many
                   in both types), probe_no_gather (no corner loads), and the
                   first design's im2col and coord for comparison
  products alone   the two products of one backward
Each design is its source with some text replaced (the replaced text must occur
in the source exactly once), built with the flags of ``ops/_build.py`` (one nvcc
each, in parallel). Designs (probes excepted) are checked against the plain
versions first: the forward within 2e-4 of ``modulated_deform_conv_ref``, the
backward's outputs within 1e-4 of each one's largest (float32) against
autograd of it. Prints one JSON line per shape and type, then the card's name
and power limit.

chip_smoke.py uses :func:`build_old_backward` and :func:`old_backward` to time
the first design beside the shipped one in its own call. Nothing on the
package's paths imports this module.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from glare_tpu_torch.ops import _build, dcn  # noqa: E402

# The first design of csrc/dcn_bwd.cu (three kernels: im2col, coord, input),
# as it shipped before the gather pass replaced it.
OLD_BWD_SRC = r"""// Modulated deformable convolution (DCNv2) backward, float32 and bf16: 3x3,
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
"""

FWD_DESIGNS = {
    "prefetch_all": [("constexpr int PREFETCH_MIN_NQ = 4;", "constexpr int PREFETCH_MIN_NQ = 1;")],
    "prefetch_none": [("constexpr int PREFETCH_MIN_NQ = 4;", "constexpr int PREFETCH_MIN_NQ = 8;")],
    "two_ctas_an_sm": [("__global__ void __launch_bounds__(NT, 1)\ndcn_f32_tiled_kernel(",
                        "__global__ void __launch_bounds__(NT, NQ <= 2 ? 2 : 1)\ndcn_f32_tiled_kernel(")],
    "probe_no_fma": [("    for (int kk = 0; kk < KC; ++kk) {\n      const float4 a0",
                      "    for (int kk = 0; kk < 0; ++kk) {\n      const float4 a0")],
    "probe_no_gather": [("        if (pix >= 0) {\n          const float4* src",
                         "        if (false) {\n          const float4* src")],
}
PASS_DESIGNS = {
    "lanes_8": [("  constexpr int LANES = sizeof(T) == 4 ? 8 : 4;", "  constexpr int LANES = 8;")],
    "lanes_4": [("  constexpr int LANES = sizeof(T) == 4 ? 8 : 4;", "  constexpr int LANES = 4;")],
    "probe_no_gather": [("          if (pix[cn] >= 0) {\n            load_v", "          if (false) {\n            load_v")],
}
SHAPES = [("warp_0", 2, 128, 128, 256, 4, 256), ("warp_1", 2, 256, 256, 128, 4, 128)]


def _edited(src, edits, name):
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"design {name}: the text to replace is not in the source once: {old!r}")
        src = src.replace(old, new)
    return src


def _build_texts(texts, out_dir):
    """{name: source text} -> {name: ctypes library}, one nvcc each, in parallel;
    prints each one's ptxas register and spill lines."""
    procs = {}
    for name, text in texts.items():
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(_build.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for design {name}:\n{log[-4000:]}")
            continue
        print(json.dumps({"design": name, "ptxas": [ln.strip() for ln in log.splitlines()
                                                    if "spill" in ln or "registers" in ln]}), flush=True)
        libs[name] = ctypes.CDLL(so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def _out_dir():
    d = os.path.join(_build.build_dir(), "dcn_train_designs")
    os.makedirs(d, exist_ok=True)
    return d


def _bind_old(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    for sfx in ("", "_bf16"):
        getattr(lib, "dcn_bwd_im2col" + sfx).argtypes = [p] * 5 + [i] * 5 + [p]
        getattr(lib, "dcn_bwd_coord" + sfx).argtypes = [p] * 7 + [i] * 5 + [p]
        for k in ("im2col", "coord"):
            getattr(lib, f"dcn_bwd_{k}{sfx}").restype = ctypes.c_int
    return lib


def build_old_backward():
    """The first backward design (OLD_BWD_SRC) as a ctypes library."""
    return _bind_old(_build_texts({"three_kernel": OLD_BWD_SRC}, _out_dir())["three_kernel"])


def old_backward(lib, grad_out, x, offset, mask, weight, radii, parts=None):
    """The first design's backward without grad_x, in x's type: im2col, grad_weight
    = col^T grad_out, grad_col = grad_out W^T, coord. ``parts``: a dict that
    receives each step's own callable (for timing). -> (grad_offset, grad_mask,
    grad_weight [3, 3, C, O] float32)."""
    B, H, W, C = x.shape
    G, O = offset.shape[3], weight.shape[-1]
    sfx = "" if x.dtype == torch.float32 else "_bf16"
    im2col, coord = getattr(lib, "dcn_bwd_im2col" + sfx), getattr(lib, "dcn_bwd_coord" + sfx)
    w2 = weight.reshape(9 * C, O).to(x.dtype).contiguous()
    go = grad_out.to(x.dtype).contiguous().reshape(-1, O)
    col = torch.empty((B * H * W, 9 * C), dtype=x.dtype, device=x.device)
    gcol = torch.empty_like(col)
    goff, gmask = torch.empty_like(offset), torch.empty_like(mask)
    gw = torch.zeros((9 * C, O), dtype=torch.float32, device=x.device)
    a = (B, H, W, C, G)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    steps = {
        "im2col": lambda: _build.check(im2col(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), radii.data_ptr(),
                                              col.data_ptr(), *a, stream()), "dcn_bwd_im2col"),
        "grad_weight_product": (lambda: gw.addmm_(col.t(), go)) if x.dtype == torch.float32 else
        (lambda: gw.add_(torch.mm(col.t(), go, out_dtype=torch.float32))),
        "grad_col_product": lambda: torch.matmul(go, w2.t(), out=gcol),
        "coord": lambda: _build.check(coord(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), radii.data_ptr(),
                                            gcol.data_ptr(), goff.data_ptr(), gmask.data_ptr(), *a, stream()),
                                      "dcn_bwd_coord"),
    }
    for step in steps.values():
        step()
    if parts is not None:
        parts.update(steps)
    return goff, gmask, gw.reshape(3, 3, C, O)


def time_ms(fn, reps=5, warmup=2):
    """Median of ``reps`` CUDA-event timings of one call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _in_turns(calls):
    """{name: callable} timed in turns A, B, ..., B, A -> {name: [ms, ms]}."""
    res = {}
    for name in list(calls) + list(calls)[::-1]:
        res.setdefault(name, []).append(time_ms(calls[name]))
    return res


def _inputs(B, H, W, C, G, O, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    off = 1.5 * torch.randn(B, H, W, G, 9, 2, device="cuda", generator=g)
    mask = torch.rand(B, H, W, G, 9, device="cuda", generator=g)
    wgt = torch.randn(3, 3, C, O, device="cuda", generator=g) / math.sqrt(9 * C)
    bias = 0.1 * torch.randn(O, device="cuda", generator=g)
    go = torch.randn(B, H, W, O, device="cuda", generator=g).to(dtype)
    return x, off, mask, wgt, bias, go


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


def main():
    if not torch.cuda.is_available():
        sys.exit("dcn_train_designs.py measures on an NVIDIA GPU")
    fwd_src = open(os.path.join(_build.CSRC_DIR, "dcn_fwd.cu")).read()
    bwd_src = open(os.path.join(_build.CSRC_DIR, "dcn_bwd.cu")).read()
    texts = {f"fwd_{n}": _edited(fwd_src, e, n) for n, e in FWD_DESIGNS.items()}
    texts.update({f"pass_{n}": _edited(bwd_src, e, n) for n, e in PASS_DESIGNS.items()})
    texts["three_kernel"] = OLD_BWD_SRC
    libs = _build_texts(texts, _out_dir())
    old = _bind_old(libs.pop("three_kernel"))
    for name, lib in libs.items():
        fns = (lib.dcn_fwd,) if name.startswith("fwd_") else (lib.dcn_bwd_pass, lib.dcn_bwd_pass_bf16)
        for fn in fns:
            fn.argtypes = [ctypes.c_void_p] * (7 if name.startswith("fwd_") else 9) + [ctypes.c_int] * (
                7 if name.startswith("fwd_") else 5) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    torch.backends.cuda.matmul.allow_tf32 = False
    for (wname, B, H, W, C, G, O) in SHAPES:
        P = B * H * W
        # ---- the float32 forward
        x, off, mask, wgt, bias, go = _inputs(B, H, W, C, G, O, torch.float32, C + 1)
        radii = dcn.clamp_table(2, G).cuda()
        w2 = wgt.reshape(9 * C, O).contiguous()
        want = dcn.modulated_deform_conv_ref(x, off, mask, wgt, bias, max_offset=2)
        # every variant through its C entry (kind 0, the tiled kernel; kind 2, the flat
        # one), on the same prepared tensors: no wrapper's host work in the times
        shipped_fwd = dcn._kernels()[0].dcn_fwd
        variants = {"shipped": (shipped_fwd, 0), "flat": (shipped_fwd, 2),
                    **{name: (libs[f"fwd_{name}"].dcn_fwd, 0) for name in FWD_DESIGNS}}
        calls = {}
        for name, (fn, kind) in variants.items():
            out = torch.empty(B, H, W, O, device="cuda")

            def call(fn=fn, kind=kind, out=out, name=name):
                _build.check(fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(), w2.data_ptr(), bias.data_ptr(),
                                radii.data_ptr(), out.data_ptr(), B, H, W, C, O, G, kind, stream()), name)
                return out

            calls[name] = call
        errs = {}
        for name, call in calls.items():
            errs[name] = float((call().float() - want).abs().max())
            if not name.startswith("probe_") and errs[name] > 2e-4:
                raise AssertionError(f"forward design {name}, {wname}: error {errs[name]}")
        flops = 2.0 * P * 9 * C * O
        res = _in_turns(calls)
        print(json.dumps({"kernel": "dcn_fwd f32", "shape": wname, "x": [B, H, W, C], "O": O,
                          "bound_ms": flops / 67e12 * 1e3, "max_abs_err": errs,
                          "ms": res, "tflops": {n: flops / min(v) / 1e9 for n, v in res.items()}}), flush=True)
        del want, calls
        # ---- the backward, float32 and bf16
        for dt in (torch.float32, torch.bfloat16):
            xd, god = x.to(dt), go.to(dt)
            want = dcn.modulated_deform_conv_backward_ref(god, xd, off, mask, wgt, None, max_offset=2, need_x=False)
            got_new = dcn.modulated_deform_conv_backward_cuda(god, xd, off, mask, wgt, max_offset=radii)
            got_old = old_backward(old, god, xd, off, mask, wgt, radii)
            errs = {"shipped": [_rel(got_new[i], want[i]) for i in (1, 2, 3)],
                    "three_kernel": [_rel(g, want[i]) for g, i in zip(got_old, (1, 2, 3))]}
            if dt == torch.float32:
                for name, e in errs.items():
                    if max(e) > 1e-4:
                        raise AssertionError(f"backward design {name}, {wname}: errors {e}")
            sfx = "" if dt == torch.float32 else "_bf16"
            w2d = wgt.reshape(9 * C, O).to(dt).contiguous()
            go2 = god.reshape(P, O)
            gcol = go2 @ w2d.t()
            col = torch.empty_like(gcol)
            goff, gmask = torch.empty_like(off), torch.empty_like(mask)
            gw = torch.zeros(9 * C, O, device="cuda")
            old_parts = {}
            old_backward(old, god, xd, off, mask, wgt, radii, parts=old_parts)

            def pass_call(fn):
                return lambda: _build.check(fn(xd.data_ptr(), off.data_ptr(), mask.data_ptr(), radii.data_ptr(),
                                               gcol.data_ptr(), col.data_ptr(), goff.data_ptr(), gmask.data_ptr(),
                                               None, B, H, W, C, G, stream()), "pass")

            calls = {
                "shipped": lambda: dcn.modulated_deform_conv_backward_cuda(god, xd, off, mask, wgt, max_offset=radii),
                "three_kernel": lambda: old_backward(old, god, xd, off, mask, wgt, radii),
                "pass_shipped": pass_call(getattr(dcn._bwd_kernels(), "dcn_bwd_pass" + sfx)),
                **{f"pass_{n}": pass_call(getattr(libs[f"pass_{n}"], "dcn_bwd_pass" + sfx)) for n in PASS_DESIGNS},
                "three_kernel_im2col": old_parts["im2col"], "three_kernel_coord": old_parts["coord"],
                "grad_col_product": lambda: torch.matmul(go2, w2d.t(), out=gcol),
                "grad_weight_product": (lambda: gw.addmm_(col.t(), go2)) if dt == torch.float32 else
                (lambda: gw.add_(torch.mm(col.t(), go2, out_dtype=torch.float32))),
            }
            res = _in_turns(calls)
            peak = 67e12 if dt == torch.float32 else 989e12
            print(json.dumps({"kernel": "dcn_bwd " + str(dt).split(".")[-1], "shape": wname, "x": [B, H, W, C],
                              "O": O, "bound_ms": 2 * flops / peak * 1e3,
                              "rel_err_offset_mask_weight": errs, "ms": res}), flush=True)
            del want, got_new, got_old, calls, gcol, col, old_parts
            torch.cuda.empty_cache()
        del x, off, mask, wgt, bias, go
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)


if __name__ == "__main__":
    main()
