// Where one DCNv2 tap samples: shared by the float32 forward of dcn_fwd.cu
// (dcn_f32_tiled_kernel) and the backward's gather pass of dcn_bwd.cu, so that
// the column the backward emits is, bit for bit, the A operand the forward
// multiplied. The arithmetic is also that of the Hopper forward's sampler
// (dcn_hopper.cu), whose A block the bf16 column equals:
//   p = (h + k/3 - 1, w + k%3 - 1) + clamp(offset, -r, r)
//   a sample outside (-1, H) x (-1, W) is zero; each corner off the image is
//   zero; value = mask * (corners fma'd in order (y0,x0), (y0,x0+1),
//   (y0+1,x0), (y0+1,x0+1) into 0, each times its bilinear weight).
// Leaving out a corner and adding it as 0 give the same bits (the running sum
// starts at +0 and never becomes -0), so callers may do either.
#pragma once

#include <math.h>

struct DcnTap {
  bool in;                 // the sample lies inside (-1, H) x (-1, W)
  int y0, x0;              // top-left corner (0, 0 when !in)
  float ly, lx, hy, hx;    // bilinear fractions (all 0 when !in)
  float cw[4];             // corner weights hy*hx, hy*lx, ly*hx, ly*lx (0 when !in)
};

__device__ __forceinline__ DcnTap dcn_tap(int h, int w, int k, float dy, float dx, float r, int H,
                                          int W) {
  DcnTap t;
  const float py = (float)(h + k / 3 - 1) + fminf(fmaxf(dy, -r), r);
  const float px = (float)(w + k % 3 - 1) + fminf(fmaxf(dx, -r), r);
  t.in = py > -1.f && py < (float)H && px > -1.f && px < (float)W;
  const float y0f = floorf(py), x0f = floorf(px);
  t.y0 = t.in ? (int)y0f : 0;
  t.x0 = t.in ? (int)x0f : 0;
  t.ly = t.in ? py - y0f : 0.f;
  t.lx = t.in ? px - x0f : 0.f;
  t.hy = t.in ? 1.f - t.ly : 0.f;
  t.hx = t.in ? 1.f - t.lx : 0.f;
  t.cw[0] = t.hy * t.hx;
  t.cw[1] = t.hy * t.lx;
  t.cw[2] = t.ly * t.hx;
  t.cw[3] = t.ly * t.lx;
  return t;
}

// Pixel index yy * W + xx of corner c in its image; -1 off the image (or !in).
__device__ __forceinline__ int dcn_corner(const DcnTap& t, int c, int H, int W) {
  const int yy = t.y0 + (c >> 1), xx = t.x0 + (c & 1);
  return (t.in && yy >= 0 && yy < H && xx >= 0 && xx < W) ? yy * W + xx : -1;
}

// Slope of min(max(o, -r), r) at o: 1 inside, 1/2 on the radius (the slope torch
// and XLA give min/max ties), 0 beyond.
__device__ __forceinline__ float dcn_clamp_slope(float o, float r) {
  const float a = fabsf(o);
  return a < r ? 1.f : (a == r ? 0.5f : 0.f);
}
