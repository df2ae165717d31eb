"""Times designs of the two float32 attention entries against each other on one card.

    python3 glare_tpu_torch/tools/attn_f32_designs.py [--family hopper|simt|both]
                                                      # needs the GPU and nvcc

Family ``hopper``: ``csrc/attn_hopper_f32.cu`` (entry ``hopper_f32``, every
product 3xTF32 on wgmma), or its previous design kept here as text
(``CHANNEL_SPLIT_CU``), with some text replaced:
  shipped         the source as it is: a split pass writes q, k, v's big and small
                  parts as the images of the ring's stages, each loaded by a few
                  bulk copies; consumer w computes S for keys [64 w, 64 w + 64)
                  over all channels, a 16-channel sub-chunk (6 products) at a
                  time, and PV for its 256 output channels, a quarter of a V
                  chunk (3 products) at a time, one in flight while the last is
                  added, each summed on the tensor cores from 0 and added in
                  float32
  staggered       the same, each CTA starting its key loop at its own key step
  pv_halves       the same with PV as two 128-channel products a V chunk, each
                  waited for before it is added
  channel_split   the previous design: S split by channels, each consumer's
                  partial over its 256 channels summed in shared memory after
                  every sub-chunk, then the two partials added
  tensor_maps     channel_split with the first loads: TMA tensor copies over q,
                  k in 16-channel slabs and v^T in 8-key groups (64- and
                  32-byte box rows), swizzled by the copy
  cluster_2       channel_split in clusters of two CTAs (neighbouring query
                  tiles) that share every K and V load (bulk-copy multicast;
                  each stage is released by the consumers of both CTAs)
  one_chain       channel_split with the first consumers: S over a consumer's
                  256 channels and the output over the whole key loop
                  accumulated on the tensor cores (one wgmma accumulator each,
                  PV as m64n256 products), two chunks' products in flight. The
                  tensor cores' float32 sums truncate, so long chains drift: it
                  is held to the tolerance against the plain version only
and probes of the shipped source, whose output is wrong on purpose and not
checked:
  probe_no_loads  no copy (the barriers still complete): the products on stale
                  shared memory, what the loads cost
  probe_loads_only  consumers that only wait for each chunk and release it
  probe_no_mma    no wgmma: the loads, barriers, softmax and the float32 sums
The shipped SIMT entry (``csrc/attn_fused.cu`` ``attn_fused_f32``) is timed in
the same turns as ``simt``.

Family ``simt``: ``csrc/attn_fused.cu`` with a few lines replaced (the earlier
float32 entry ``attn_fused_f32``, now entry ``f32_simt``; the bf16 kernel in
the same file is untouched):
  simt            the source as it is: 256 threads, K chunks of 128 channels, V
                  chunks of 16 keys, a 2-stage ring of cp.async.cg copies (10
                  block barriers a key tile)
  cp_async_ca     the copies kept in L1 (cp.async.ca)
  v_chunk_8       V chunks of 8 keys (14 barriers a key tile)
  k64_v8_s3       K chunks of 64 channels, V chunks of 8 keys, 3 stages (18
                  barriers a key tile; the first design's chunking)
  threads_512     512 threads (16 warps at 128 registers: O split over two
                  warps a row block, S in 4 x 2 blocks)
  queries_32      32 queries a CTA, two CTAs an SM (128 registers), K chunks
                  of 64 channels, V chunks of 8 keys: twice the K/V traffic
  key_tile_128    128-key tiles (S in 4 x 8 blocks), K chunks of 32 channels,
                  V chunks of 8 keys
  simt_probe_no_loads  no chunk copies (the products read stale shared memory)
  simt_probe_no_s      no S products (scores 0): what the PV half and the rest cost
  simt_probe_no_pv     no PV products: what the S half and the rest cost
A design whose shared memory does not fit (a static_assert) or whose build
fails is reported and not timed.
All are built with the flags of ``ops/_build.py`` (one nvcc each, in parallel),
checked (probes excepted) against ``flash_attention_nhc_ref`` at
[1, 16384, 512] float32, n_true 16275, within 5e-5, and timed by CUDA events in
turns (A, B, ..., B, A). Each design's largest error against a float64 dense
oracle on 64 queries is printed beside the plain version's. Prints one JSON
line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
import glare_tpu_torch  # noqa: E402,F401  (sets the TF32 switches: float32 means float32)
from glare_tpu_torch.ops import _build, attn  # noqa: E402

_S_FMA = """            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);"""
_PV_FMA = """            acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);"""
_K64 = ("constexpr int FCC = 128;", "constexpr int FCC = 64;")
_V8 = ("constexpr int FVK = 16;", "constexpr int FVK = 8;")
_S3 = ("constexpr int FSTAGES = 2;", "constexpr int FSTAGES = 3;")
_T512 = ("constexpr int FT = 256;", "constexpr int FT = 512;")
_CA = ('asm volatile("cp.async.cg.shared.global', 'asm volatile("cp.async.ca.shared.global')

SIMT_DESIGNS = {
    "simt": [],
    "cp_async_ca": [_CA],
    "v_chunk_8": [_V8],
    "k64_v8_s3": [_K64, _V8, _S3],
    "threads_512": [_T512],
    "queries_32": [("constexpr int FQ = 64;", "constexpr int FQ = 32;"),
                   ("constexpr int FCTAS = 1;", "constexpr int FCTAS = 2;"), _K64, _V8],
    "key_tile_128": [("constexpr int FKT = 64;", "constexpr int FKT = 128;"),
                     ("constexpr int FCC = 128;", "constexpr int FCC = 32;"), _V8],
    "simt_probe_no_loads": [("    if (t < total) {\n      const int kt", "    if (t < 0) {\n      const int kt")],
    "simt_probe_no_s": [(_S_FMA, "            (void)qv, (void)kv;")],
    "simt_probe_no_pv": [(_PV_FMA, "            (void)pr, (void)vv;")],
}

# the previous design of csrc/attn_hopper_f32.cu (the bulk copies of the shipped
# one, but S split by channels: each consumer's partial S over its 256 channels
# summed into shared memory after every sub-chunk, then added to the other's),
# the base of the designs below marked channel_split
CHANNEL_SPLIT_CU = r"""#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 512;                  // channels the kernel computes (inputs padded to it)
constexpr int BQ = 64;                  // queries per CTA
constexpr int BK = 128;                 // keys per step
constexpr int SCH = 16;                 // channels of an S chunk (64-byte rows)
constexpr int VK = 8;                   // keys of a V chunk (32-byte rows)
constexpr int NS_CHUNK = 256 / SCH;     // S chunks a step (16)
constexpr int NV_CHUNK = BK / VK;       // V chunks a step (16)
constexpr int NSTAGE = 3;
constexpr int NT = 384;                 // 3 warpgroups
constexpr float kNegInf = -1e30f;

constexpr int QP = BQ * SCH * 4;        // 4096 B: big or small of a consumer's Q chunk
constexpr int KP = BK * SCH * 4;        // 8192 B: big or small of a consumer's K chunk
constexpr int S_HALF = 2 * QP + 2 * KP; // 24576 B: a consumer's S chunk
constexpr int VP = 256 * VK * 4;        // 8192 B: big or small of a consumer's V^T chunk
constexpr int V_HALF = 2 * VP;          // 16384 B
constexpr int S_BYTES = 2 * S_HALF;     // 49152 B: the bytes an S chunk brings
constexpr int V_BYTES = 2 * V_HALF;     // 32768 B: the bytes a V chunk brings
constexpr int STAGE = S_BYTES;          // a ring stage holds either
constexpr int XBUF = BQ * BK * 4;       // 32768 B: one partial S, or one part of P
constexpr int PBLK = BQ * 32 * 4;       // 8192 B: 32 keys of P (128-byte rows)

constexpr int OFF_X = NSTAGE * STAGE;
constexpr int OFF_BAR = OFF_X + 2 * XBUF;
constexpr int SMEM_BYTES = OFF_BAR + 64 + 1024;  // barriers + alignment slack
static_assert(SMEM_BYTES <= 232448, "shared memory of the f32 Hopper kernel");

// ------------------------------------------------------------ primitives --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 35)) __trap();  // a stuck pipeline: fail, do not hang
  }
}

// `bytes` contiguous bytes global -> shared (one bulk copy), completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile: swizzle mode MODE (1: 128 B,
// 2: 64 B, 3: 32 B), sbo = bytes between 8-row groups.
template <int MODE>
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(MODE) << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d[64] (+)= A[64x8] B[8x128], tf32, both from shared memory, K-major: every
// product of the kernel (accumulate 0 starts a new sum).
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
// ------------------------------------------------------------ split pass --
// Writes big and small of q, k and v as the images of the ring's stages: each
// block below is what one bulk copy brings into shared memory, already in the
// swizzled layout the wgmma descriptors read (the 16-byte chunk c of row r at
// c ^ ((r >> 1) & 3) in 64-byte rows, c ^ ((r >> 2) & 1) in 32-byte rows).
//   q: per (image, 64-query tile, 16-channel chunk, consumer half) 8 KB: big,
//      small, each [64 rows][16 channels];
//   k: per (image, 128-key step, chunk, half) 16 KB: big, small, [128][16];
//   v: per (image, step, 8-key group) 32 KB: for each half big, small, each
//      [256 channels][8 keys] (v transposed: TF32 wgmma takes K-major
//      operands only, and the PV product's K dimension is the key).
// Channels >= cin and tokens >= n are zeros. One block per 32 tokens x 32
// channels of one image, 32 x 8 threads; tokens up to nkt * 128.
__global__ void attn_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, float* __restrict__ qi,
                                  float* __restrict__ ki, float* __restrict__ vi, int n, int nqt,
                                  int nkt, int cin) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, r0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = c0 + tx, w = ch >> 8, cc = (ch & 255) >> 4, k16 = (ch & 15) >> 2, e = ch & 3;
  for (int rr = ty; rr < 32; rr += 8) {
    const int r = r0 + rr;
    const size_t src = ((size_t)b * n + r) * cin + ch;
    const bool in = r < n && ch < cin;
    const float xq = in ? q[src] : 0.f, xk = in ? k[src] : 0.f;
    tile[rr][tx] = in ? v[src] : 0.f;
    const float hq = tf32_rna(xq), hk = tf32_rna(xk);
    if (r < nqt * BQ) {
      const int qr = r & (BQ - 1);
      const size_t blk = ((((size_t)b * nqt + r / BQ) * NS_CHUNK + cc) * 2 + w) * 2;
      const size_t off = (size_t)qr * SCH + ((k16 ^ ((qr >> 1) & 3)) << 2) + e;
      qi[blk * (BQ * SCH) + off] = hq;
      qi[(blk + 1) * (BQ * SCH) + off] = tf32_rna(xq - hq);
    }
    const int kr = r & (BK - 1);
    const size_t blk = ((((size_t)b * nkt + r / BK) * NS_CHUNK + cc) * 2 + w) * 2;
    const size_t off = (size_t)kr * SCH + ((k16 ^ ((kr >> 1) & 3)) << 2) + e;
    ki[blk * (BK * SCH) + off] = hk;
    ki[(blk + 1) * (BK * SCH) + off] = tf32_rna(xk - hk);
  }
  __syncthreads();
  for (int rr = ty; rr < 32; rr += 8) {   // v: a thread a key, a row a channel
    const int c = c0 + rr, r = r0 + tx;
    const float xv = tile[tx][rr];
    const float h = tf32_rna(xv);
    const int row = c & 255, kk = r & (VK - 1);
    const size_t blk = ((((size_t)b * nkt + r / BK) * NV_CHUNK + (r & (BK - 1)) / VK) * 2 + (c >> 8)) * 2;
    const size_t off = (size_t)row * VK + (((kk >> 2) ^ ((row >> 2) & 1)) << 2) + (kk & 3);
    vi[blk * (256 * VK) + off] = h;
    vi[(blk + 1) * (256 * VK) + off] = tf32_rna(xv - h);
  }
}

// ---------------------------------------------------------------- kernel --
__global__ void __launch_bounds__(NT, 1)
attn_hopper_f32_kernel(const float* __restrict__ qi, const float* __restrict__ ki,
                       const float* __restrict__ vi, float* __restrict__ out, int n, int n_true,
                       int cout, int vec2, int nqt, int nkt) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t xbase = sbase + OFF_X;
  const uint32_t bar = sbase + OFF_BAR;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (NSTAGE + s); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7, ltid = tid & 127;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const int n_kt = (n_true + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread issues every bulk copy --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (ltid == 0) {
      int s = 0;
      uint32_t par = 1;  // the first pass through the ring does not wait
      auto next = [&]() {
        if (++s == NSTAGE) {
          s = 0;
          par ^= 1;
        }
      };
      for (int j = 0; j < n_kt; ++j) {
        for (int c = 0; c < NS_CHUNK; ++c) {
          mbar_wait(empty(s), par);
          mbar_expect_tx(full(s), S_BYTES);
          const uint32_t dst = sbase + s * STAGE;
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const size_t qb = (((size_t)b * nqt + blockIdx.x) * NS_CHUNK + c) * 2 + w;
            const size_t kb = (((size_t)b * nkt + j) * NS_CHUNK + c) * 2 + w;
            bulk_load(dst + w * S_HALF, qi + qb * (2 * QP / 4), 2 * QP, full(s));
            bulk_load(dst + w * S_HALF + 2 * QP, ki + kb * (2 * KP / 4), 2 * KP, full(s));
          }
          next();
        }
        for (int v = 0; v < NV_CHUNK; ++v) {
          mbar_wait(empty(s), par);
          mbar_expect_tx(full(s), V_BYTES);
          const size_t vb = ((size_t)b * nkt + j) * NV_CHUNK + v;
          bulk_load(sbase + s * STAGE, vi + vb * (V_BYTES / 4), V_BYTES, full(s));
          next();
        }
      }
    }
  } else {
    // ---------------- consumers: channels [256 w, 256 w + 256) -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg;
    const int warp = ltid >> 5, lane = ltid & 31;
    const int g = lane >> 2, col0 = (lane & 3) * 2;  // fragment row and first column

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float s[64];  // a short product: one S chunk, or half a V chunk's channels
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8 of this warp's 16
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
    // the running partial S of each consumer: 16 bytes a thread in turn
    const uint32_t xown = xbase + w * XBUF + 16 * ltid, xoth = xbase + (1 - w) * XBUF + 16 * ltid;
    // consumer 0 writes big(P) over X_1, consumer 1 small(P) over X_0
    const uint32_t p_big = xbase + XBUF, p_small = xbase;

    int st = 0;
    uint32_t par = 0;
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      if (++st == NSTAGE) {
        st = 0;
        par ^= 1;
      }
    };

    for (int j = 0; j < n_kt; ++j) {
      // -------- S_j = Q K_j^T over this consumer's 256 channels, a chunk of 16
      // channels a product, each folded into the running partial in float32
      for (int c = 0; c < NS_CHUNK; ++c) {
        mbar_wait(full(st), par);
        const uint32_t base = sbase + st * STAGE + w * S_HALF;
        wg_fence();
        // the four small products first, then the two big ones
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t qb = desc<2>(base + kk * 32, 512), qs = desc<2>(base + QP + kk * 32, 512);
          const uint64_t kb = desc<2>(base + 2 * QP + kk * 32, 512);
          const uint64_t ks = desc<2>(base + 2 * QP + KP + kk * 32, 512);
          wgmma_m64n128(s, qs, kb, kk);
          wgmma_m64n128(s, qb, ks, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_m64n128(s, desc<2>(base + kk * 32, 512), desc<2>(base + 2 * QP + kk * 32, 512), 1);
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(s[i]);
        release();
        // the exchange buffers held P of step j - 1: both consumers' PV
        // products have retired before the first chunk is written
        if (c == 0) named_bar_sync(1, 256);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float4 t = c == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : lds4(xown + 2048 * i);
          t.x += s[4 * i];
          t.y += s[4 * i + 1];
          t.z += s[4 * i + 2];
          t.w += s[4 * i + 3];
          sts4(xown + 2048 * i, t);
        }
      }

      // -------- S = the two partials (the same sum in both consumers)
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 a = lds4((w == 0 ? xown : xoth) + 2048 * i);
        const float4 b2 = lds4((w == 0 ? xoth : xown) + 2048 * i);
        s[4 * i] = a.x + b2.x;
        s[4 * i + 1] = a.y + b2.y;
        s[4 * i + 2] = a.z + b2.z;
        s[4 * i + 3] = a.w + b2.w;
      }

      // -------- online softmax (s becomes P)
      // keys >= n_true (in the last step only): no branch, one compare each
      const int lim = n_true - j * BK - col0;
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = (i >> 2) * 8 + (i & 1) >= lim ? kNegInf : s[i];
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) {
          s[i] = exp2f(s[i] - mx1);
          sum1 += s[i];
        } else {
          s[i] = exp2f(s[i] - mx0);
          sum0 += s[i];
        }
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      m0 = mx0;
      m1 = mx1;

      // -------- this consumer's part of P, over the other's partial (both read)
      named_bar_sync(1, 256);
      {
        const uint32_t dstp = xbase + (1 - w) * XBUF;
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int row = warp * 16 + g + 8 * ((i >> 1) & 1);
          const int col = 8 * (i >> 2) + col0;
          float a = tf32_rna(s[i]), c2 = tf32_rna(s[i + 1]);
          if (w == 1) {
            a = tf32_rna(s[i] - a);
            c2 = tf32_rna(s[i + 1] - c2);
          }
          const int cb = col & 31;
          const int off = (col >> 5) * PBLK + row * 128 + ((((cb >> 2) ^ (row & 7)) << 4) | ((cb & 3) << 2));
          sts2(dstp + off, a, c2);
        }
      }
      fence_proxy_async();
      // where the running max moved in none of the warp's rows, every
      // correction is exactly 1: the rescale would change no bit
      if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      }
      named_bar_sync(1, 256);  // both parts of P written

      // -------- acc += P V_j: each V chunk (8 keys) a product per 128 channels,
      // added to the accumulator in float32
      for (int v = 0; v < NV_CHUNK; ++v) {
        mbar_wait(full(st), par);
        const uint32_t vbig = sbase + st * STAGE + w * V_HALF, vsmall = vbig + VP;
        const uint32_t poff = (v >> 2) * PBLK + (v & 3) * 32;
        const uint64_t pb = desc<1>(p_big + poff, 1024), ps = desc<1>(p_small + poff, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wg_fence();
          wgmma_m64n128(s, ps, desc<3>(vbig + h * 4096, 256), 0);
          wgmma_m64n128(s, pb, desc<3>(vsmall + h * 4096, 256), 1);
          wgmma_m64n128(s, pb, desc<3>(vbig + h * 4096, 256), 1);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            pin(s[i]);
            acc[64 * h + i] += s[i];
          }
        }
        release();
      }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const size_t base0 = (size_t)b * n * cout;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 256 * w + 8 * i + col0;
      if (col >= cout) continue;
      const float a0 = acc[4 * i] / l0, a1 = acc[4 * i + 1] / l0;
      const float b0 = acc[4 * i + 2] / l1, b1 = acc[4 * i + 3] / l1;
      float* o0 = out + base0 + (size_t)r0 * cout + col;
      float* o1 = out + base0 + (size_t)r1 * cout + col;
      if (vec2) {
        if (r0 < n) *reinterpret_cast<float2*>(o0) = make_float2(a0, a1);
        if (r1 < n) *reinterpret_cast<float2*>(o1) = make_float2(b0, b1);
      } else {
        if (r0 < n) {
          o0[0] = a0;
          if (col + 1 < cout) o0[1] = a1;
        }
        if (r1 < n) {
          o1[0] = b0;
          if (col + 1 < cout) o1[1] = b1;
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host --
// 64-query tiles and 128-key steps of an image
int query_tiles(int n) { return (n + BQ - 1) / BQ; }
int key_steps(int n) { return (n + BK - 1) / BK; }

}  // namespace

// Dynamic shared memory the kernel asks for, in bytes.
extern "C" int attn_hopper_f32_smem_bytes() { return SMEM_BYTES; }

// Bytes of the scratch the entry needs for B images of n tokens: the split
// pass's images of q (per 64-query tile), k and v (per 128-key step).
extern "C" long long attn_hopper_f32_scratch_bytes(int B, int n) {
  const long long per_tile = (long long)NS_CHUNK * 2 * 2 * QP, per_step = (long long)NS_CHUNK * 2 * 2 * KP;
  return B * (query_tiles(n) * per_tile + key_steps(n) * (per_step + (long long)NV_CHUNK * V_BYTES));
}

// q, k, v, out: [B, n, c] contiguous float32, c <= 512; q pre-scaled. scratch:
// attn_hopper_f32_scratch_bytes(B, n) bytes, 16-byte aligned. Launches the
// split pass, then the attention kernel, on `stream`.
extern "C" int attn_hopper_f32(const void* q, const void* k, const void* v, void* out, int B, int n,
                               int n_true, int c, void* scratch, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (c < 1 || c > C || n_true < 1 || n_true > n || (reinterpret_cast<uintptr_t>(scratch) & 15))
    return (int)cudaErrorInvalidValue;
  const int nqt = query_tiles(n), nkt = key_steps(n);
  float* qi = static_cast<float*>(scratch);
  float* ki = qi + (size_t)B * nqt * NS_CHUNK * 2 * 2 * QP / 4;
  float* vi = ki + (size_t)B * nkt * NS_CHUNK * 2 * 2 * KP / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  attn_split_kernel<<<dim3(nkt * BK / 32, C / 32, B), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), qi, ki,
      vi, n, nqt, nkt, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_hopper_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int vec2 = c % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  attn_hopper_f32_kernel<<<dim3(nqt, B), NT, SMEM_BYTES, st>>>(qi, ki, vi, static_cast<float*>(out), n,
                                                               n_true, c, vec2, nqt, nkt);
  return (int)cudaGetLastError();
}
"""

# the consumer warpgroups of the first Hopper design (one_chain), in place of the
# channel-split ones: from their first line to the host code; its m64n256
# product goes in before the split pass
_CONSUMERS = "    // ---------------- consumers: channels [256 w, 256 w + 256) -----------\n"
_HOST = "// ------------------------------------------------------------------ host --\n"
_ONE_CHAIN = r"""    // ---------------- consumers: channels [256 w, 256 w + 256) -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg;
    const int warp = ltid >> 5, lane = ltid & 31;
    const int g = lane >> 2, col0 = (lane & 3) * 2;  // fragment row and first column

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8 of this warp's 16
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
    float* xch = reinterpret_cast<float*>(smem + OFF_X);
    float* xown = xch + w * (XBUF / 4);
    float* xoth = xch + (1 - w) * (XBUF / 4);
    // consumer 0 writes big(P) over X_1, consumer 1 small(P) over X_0
    const uint32_t p_big = xbase + XBUF, p_small = xbase;

    int st = 0;
    uint32_t par = 0;
    int pend = -1;  // the stage whose products may still be in flight
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage));
    };
    auto advance = [&]() {
      if (++st == NSTAGE) {
        st = 0;
        par ^= 1;
      }
    };

    for (int j = 0; j < n_kt; ++j) {
      // -------- S_j = Q K_j^T over this consumer's 256 channels
      for (int c = 0; c < NS_CHUNK; ++c) {
        mbar_wait(full(st), par);
        const uint32_t base = sbase + st * STAGE + w * S_HALF;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint64_t qb = desc<2>(base + kk * 32, 512), qs = desc<2>(base + QP + kk * 32, 512);
          const uint64_t kb = desc<2>(base + 2 * QP + kk * 32, 512);
          const uint64_t ks = desc<2>(base + 2 * QP + KP + kk * 32, 512);
          wgmma_m64n128(s, qs, kb, c > 0 || kk > 0);
          wgmma_m64n128(s, qb, ks, 1);
          wgmma_m64n128(s, qb, kb, 1);
        }
        wg_commit();
        wg_wait<1>();
        if (pend >= 0) release(pend);
        pend = st;
        advance();
      }
      wg_wait<0>();
      release(pend);
      pend = -1;
#pragma unroll
      for (int i = 0; i < 64; ++i) pin(s[i]);
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(acc[i]);

      // -------- exchange the partials; both consumers' PV_{j-1} have retired
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 64; ++i) xown[i * 128 + ltid] = s[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] += xoth[i * 128 + ltid];

      // -------- online softmax (s becomes P)
      const int key0 = j * BK;
      if (key0 + BK > n_true) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (key0 + (i >> 2) * 8 + col0 + (i & 1) >= n_true) s[i] = kNegInf;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2) {
          s[i] = exp2f(s[i] - mx1);
          sum1 += s[i];
        } else {
          s[i] = exp2f(s[i] - mx0);
          sum0 += s[i];
        }
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      m0 = mx0;
      m1 = mx1;

      // -------- this consumer's part of P over the buffer it has read
      named_bar_sync(2 + w, 128);
      {
        char* dstp = reinterpret_cast<char*>(xoth);
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int row = warp * 16 + g + 8 * ((i >> 1) & 1);
          const int col = 8 * (i >> 2) + col0;
          float a = tf32_rna(s[i]), c2 = tf32_rna(s[i + 1]);
          if (w == 1) {
            a = tf32_rna(s[i] - a);
            c2 = tf32_rna(s[i + 1] - c2);
          }
          const int cb = col & 31;
          const int off = (col >> 5) * PBLK + row * 128 + ((((cb >> 2) ^ (row & 7)) << 4) | ((cb & 3) << 2));
          *reinterpret_cast<float2*>(dstp + off) = make_float2(a, c2);
        }
      }
      fence_proxy_async();
      // where the running max moved in none of the warp's rows, every
      // correction is exactly 1: the rescale would change no bit
      if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      }
      named_bar_sync(1, 256);  // both parts of P written

      // -------- acc += P V_j over this consumer's 256 channels
      for (int v = 0; v < NV_CHUNK; ++v) {
        mbar_wait(full(st), par);
        const uint32_t vbig = sbase + st * STAGE + w * V_HALF, vsmall = vbig + VP;
        const uint32_t poff = (v >> 2) * PBLK + (v & 3) * 32;
        wg_fence();
        wgmma_m64n256(acc, desc<1>(p_small + poff, 1024), desc<3>(vbig, 256));
        wgmma_m64n256(acc, desc<1>(p_big + poff, 1024), desc<3>(vsmall, 256));
        wgmma_m64n256(acc, desc<1>(p_big + poff, 1024), desc<3>(vbig, 256));
        wg_commit();
        wg_wait<1>();
        if (pend >= 0) release(pend);
        pend = st;
        advance();
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) pin(acc[i]);
    if (pend >= 0) release(pend);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const size_t base0 = (size_t)b * n * cout;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 256 * w + 8 * i + col0;
      if (col >= cout) continue;
      const float a0 = acc[4 * i] / l0, a1 = acc[4 * i + 1] / l0;
      const float b0 = acc[4 * i + 2] / l1, b1 = acc[4 * i + 3] / l1;
      float* o0 = out + base0 + (size_t)r0 * cout + col;
      float* o1 = out + base0 + (size_t)r1 * cout + col;
      if (vec2) {
        if (r0 < n) *reinterpret_cast<float2*>(o0) = make_float2(a0, a1);
        if (r1 < n) *reinterpret_cast<float2*>(o1) = make_float2(b0, b1);
      } else {
        if (r0 < n) {
          o0[0] = a0;
          if (col + 1 < cout) o0[1] = a1;
        }
        if (r1 < n) {
          o1[0] = b0;
          if (col + 1 < cout) o1[1] = b1;
        }
      }
    }
  }
}

"""
_M64N256 = r"""// d[128] += A[64x8] B[8x256], tf32, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db, int = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

"""
_SPLIT = "// ------------------------------------------------------------ split pass --\n"
_NO_COPY = ("uint32_t bytes, uint32_t bar) {\n", "uint32_t bytes, uint32_t bar) {\n  return;\n")

# clusters of two CTAs (neighbouring query tiles): CTA 0 loads big of K and the V of
# the first consumer half, CTA 1 the rest, each into both CTAs (bulk-copy multicast);
# a stage is released by the consumer warps of both CTAs (remote arrives), and the
# producer stays until all are in
_CLUSTER = [
    ('__device__ __forceinline__ void named_bar_sync(int id, int count) {\n',
     '// the same, written into every CTA of the cluster in `mask` (same offsets, each CTA\'s own barrier)\n__device__ __forceinline__ void bulk_load_mc(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar,\n                                             uint16_t mask) {\n  asm volatile(\n      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"\n      " [%0], [%1], %2, [%3], %4;\\n" ::"r"(dst),\n      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "h"(mask)\n      : "memory");\n}\n\n// arrive on the barrier at this CTA\'s offset `bar` in CTA `rank` of the cluster\n__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {\n  uint32_t remote;\n  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\\n" : "=r"(remote) : "r"(bar), "r"(rank));\n  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\\n" ::"r"(remote) : "memory");\n}\n\n__device__ __forceinline__ void named_bar_sync(int id, int count) {\n'),
    ('constexpr int NSTAGE = 3;\n',
     'constexpr int NSTAGE = 3;\nconstexpr int CL = 2;\n'),
    ('  if (tid == 0) {\n    for (int s = 0; s < NSTAGE; ++s) {\n      mbar_init(full(s), 1);\n      mbar_init(empty(s), 8);  // one arrive per consumer warp\n    }\n    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n  }\n  __syncthreads();\n',
     '  uint32_t rank = 0;\n  if (CL > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;\\n" : "=r"(rank));\n  if (tid == 0) {\n    for (int s = 0; s < NSTAGE; ++s) {\n      mbar_init(full(s), 1);\n      mbar_init(empty(s), 8 * CL);  // one arrive per consumer warp of each CTA of the cluster\n    }\n    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n  }\n  if (CL > 1)  // every barrier of the cluster initialised before any CTA arrives on another\'s\n    asm volatile("barrier.cluster.arrive.release.aligned;\\nbarrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n  else\n    __syncthreads();\n'),
    ('            const size_t qb = (((size_t)b * nqt + blockIdx.x) * NS_CHUNK + c) * 2 + w;\n',
     '            // a tile past the last (grid rounded to the cluster) reads the last one\n            const int qt = blockIdx.x < nqt ? (int)blockIdx.x : nqt - 1;\n            const size_t qb = (((size_t)b * nqt + qt) * NS_CHUNK + c) * 2 + w;\n'),
    ('            bulk_load(dst + w * S_HALF + 2 * QP, ki + kb * (2 * KP / 4), 2 * KP, full(s));\n',
     '            // big of K from CTA 0, small from CTA 1, each into both\n            bulk_load_mc(dst + w * S_HALF + 2 * QP + rank * KP, ki + kb * (2 * KP / 4) + rank * (KP / 4), KP,\n                         full(s), 3);\n'),
    ('          bulk_load(sbase + s * STAGE, vi + vb * (V_BYTES / 4), V_BYTES, full(s));\n',
     '          bulk_load_mc(sbase + s * STAGE + rank * V_HALF, vi + vb * (V_BYTES / 4) + rank * (V_HALF / 4),\n                       V_HALF, full(s), 3);\n'),
    ('          next();\n        }\n      }\n',
     "          next();\n        }\n      }\n      // the consumers of both CTAs arrive on this CTA's barriers until their last\n      // stage: stay until every stage is released, so that no arrive targets a CTA\n      // that has exited\n      for (int i = 0; i < NSTAGE; ++i) {\n        mbar_wait(empty(s), par);\n        next();\n      }\n"),
    ('      if (lane == 0) mbar_arrive(empty(st));\n',
     '      if (lane == 0) {\n        if (CL == 1) mbar_arrive(empty(st));\n        else\n          for (uint32_t r = 0; r < CL; ++r) mbar_arrive_cluster(empty(st), r);\n      }\n'),
    ('  attn_hopper_f32_kernel<<<dim3(nqt, B), NT, SMEM_BYTES, st>>>(qi, ki, vi, static_cast<float*>(out), n,\n                                                               n_true, c, vec2, nqt, nkt);\n  return (int)cudaGetLastError();',
     '  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3((nqt + CL - 1) / CL * CL, B);  // a tile past n computes and writes nothing\n  cfg.blockDim = dim3(NT);\n  cfg.dynamicSmemBytes = SMEM_BYTES;\n  cfg.stream = st;\n  cudaLaunchAttribute attr[1];\n  attr[0].id = cudaLaunchAttributeClusterDimension;\n  attr[0].val.clusterDim.x = CL;\n  attr[0].val.clusterDim.y = 1;\n  attr[0].val.clusterDim.z = 1;\n  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n  e = cudaLaunchKernelEx(&cfg, attn_hopper_f32_kernel, static_cast<const float*>(qi),\n                         static_cast<const float*>(ki), static_cast<const float*>(vi),\n                         static_cast<float*>(out), n, n_true, c, vec2, nqt, nkt);\n  if (e != cudaSuccess) return (int)e;\n  return (int)cudaGetLastError();'),
]

# the first loads of this source: tensor maps (TMA tensor copies) over q, k in [B, 32,
# n, 16] slabs and v^T in [B, G, 512, 8] groups, swizzled by the copy; 64- and 32-byte
# box rows
_TENSOR_MAPS = [
    ('#include <cuda_runtime.h>\n',
     '#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)\n#include <cuda_runtime.h>\n'),
    ('// `bytes` contiguous bytes global -> shared (one bulk copy), completing on `bar`\n__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar) {\n  asm volatile(\n      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\\n" ::"r"(dst),\n      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)\n      : "memory");\n}\n\n',
     '__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,\n                                         int c1, int c2) {\n  asm volatile(\n      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"\n      " [%0], [%1, {%3, %4, %5}], [%2];\\n" ::"r"(dst),\n      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)\n      : "memory");\n}\n\n'),
    ("// ------------------------------------------------------------ split pass --\n// Writes big and small of q, k and v as the images of the ring's stages: each\n// block below is what one bulk copy brings into shared memory, already in the\n// swizzled layout the wgmma descriptors read (the 16-byte chunk c of row r at\n// c ^ ((r >> 1) & 3) in 64-byte rows, c ^ ((r >> 2) & 1) in 32-byte rows).\n//   q: per (image, 64-query tile, 16-channel chunk, consumer half) 8 KB: big,\n//      small, each [64 rows][16 channels];\n//   k: per (image, 128-key step, chunk, half) 16 KB: big, small, [128][16];\n//   v: per (image, step, 8-key group) 32 KB: for each half big, small, each\n//      [256 channels][8 keys] (v transposed: TF32 wgmma takes K-major\n//      operands only, and the PV product's K dimension is the key).\n// Channels >= cin and tokens >= n are zeros. One block per 32 tokens x 32\n// channels of one image, 32 x 8 threads; tokens up to nkt * 128.\n__global__ void attn_split_kernel(const float* __restrict__ q, const float* __restrict__ k,\n                                  const float* __restrict__ v, float* __restrict__ qi,\n                                  float* __restrict__ ki, float* __restrict__ vi, int n, int nqt,\n                                  int nkt, int cin) {\n  __shared__ float tile[32][33];\n  const int b = blockIdx.z, c0 = blockIdx.y * 32, r0 = blockIdx.x * 32;\n  const int tx = threadIdx.x, ty = threadIdx.y;\n  const int ch = c0 + tx, w = ch >> 8, cc = (ch & 255) >> 4, k16 = (ch & 15) >> 2, e = ch & 3;\n  for (int rr = ty; rr < 32; rr += 8) {\n    const int r = r0 + rr;\n    const size_t src = ((size_t)b * n + r) * cin + ch;\n    const bool in = r < n && ch < cin;\n    const float xq = in ? q[src] : 0.f, xk = in ? k[src] : 0.f;\n    tile[rr][tx] = in ? v[src] : 0.f;\n    const float hq = tf32_rna(xq), hk = tf32_rna(xk);\n    if (r < nqt * BQ) {\n      const int qr = r & (BQ - 1);\n      const size_t blk = ((((size_t)b * nqt + r / BQ) * NS_CHUNK + cc) * 2 + w) * 2;\n      const size_t off = (size_t)qr * SCH + ((k16 ^ ((qr >> 1) & 3)) << 2) + e;\n      qi[blk * (BQ * SCH) + off] = hq;\n      qi[(blk + 1) * (BQ * SCH) + off] = tf32_rna(xq - hq);\n    }\n    const int kr = r & (BK - 1);\n    const size_t blk = ((((size_t)b * nkt + r / BK) * NS_CHUNK + cc) * 2 + w) * 2;\n    const size_t off = (size_t)kr * SCH + ((k16 ^ ((kr >> 1) & 3)) << 2) + e;\n    ki[blk * (BK * SCH) + off] = hk;\n    ki[(blk + 1) * (BK * SCH) + off] = tf32_rna(xk - hk);\n  }\n  __syncthreads();\n  for (int rr = ty; rr < 32; rr += 8) {   // v: a thread a key, a row a channel\n    const int c = c0 + rr, r = r0 + tx;\n    const float xv = tile[tx][rr];\n    const float h = tf32_rna(xv);\n    const int row = c & 255, kk = r & (VK - 1);\n    const size_t blk = ((((size_t)b * nkt + r / BK) * NV_CHUNK + (r & (BK - 1)) / VK) * 2 + (c >> 8)) * 2;\n    const size_t off = (size_t)row * VK + (((kk >> 2) ^ ((row >> 2) & 1)) << 2) + (kk & 3);\n    vi[blk * (256 * VK) + off] = h;\n    vi[(blk + 1) * (256 * VK) + off] = tf32_rna(xv - h);\n  }\n}\n\n",
     '// ------------------------------------------------------------ split pass --\n// Writes big and small of q and k as [B, 32, n, 16] (16-channel slabs: a TMA\n// box of 16 channels x rows is one contiguous block) and of v transposed as\n// [B, G, 512, 8] (8-key groups: keys contiguous, a box of 8 keys x 256\n// channels is one contiguous 8 KB block); G = 16 * ceil(n / 128), so every\n// key step of the kernel stays inside its image. Channels >= cin and keys >= n\n// are zeros. One block per 32 tokens x 32 channels of one image, 32 x 8 threads.\n__global__ void attn_split_kernel(const float* __restrict__ q, const float* __restrict__ k,\n                                  const float* __restrict__ v, float* __restrict__ qb,\n                                  float* __restrict__ qs, float* __restrict__ kb,\n                                  float* __restrict__ ks, float* __restrict__ vb,\n                                  float* __restrict__ vs, int n, int groups, int cin) {\n  __shared__ float tile[32][33];\n  const int b = blockIdx.z, c0 = blockIdx.y * 32, r0 = blockIdx.x * 32;\n  const int tx = threadIdx.x, ty = threadIdx.y;\n  for (int rr = ty; rr < 32; rr += 8) {\n    const int r = r0 + rr, c = c0 + tx;\n    float xv = 0.f;\n    if (r < n) {\n      const size_t src = ((size_t)b * n + r) * cin + c;\n      const size_t dst = (((size_t)b * (C / SCH) + c / SCH) * n + r) * SCH + c % SCH;\n      const float xq = c < cin ? q[src] : 0.f, xk = c < cin ? k[src] : 0.f;\n      xv = c < cin ? v[src] : 0.f;\n      const float hq = tf32_rna(xq), hk = tf32_rna(xk);\n      qb[dst] = hq;\n      qs[dst] = tf32_rna(xq - hq);\n      kb[dst] = hk;\n      ks[dst] = tf32_rna(xk - hk);\n    }\n    tile[rr][tx] = xv;\n  }\n  __syncthreads();\n  for (int rr = ty; rr < 32; rr += 8) {\n    const int c = c0 + rr, r = r0 + tx;\n    const float xv = tile[tx][rr];\n    const float h = tf32_rna(xv);\n    const size_t dst = (((size_t)b * groups + r / VK) * C + c) * VK + r % VK;\n    vb[dst] = h;\n    vs[dst] = tf32_rna(xv - h);\n  }\n}\n\n'),
    ('attn_hopper_f32_kernel(const float* __restrict__ qi, const float* __restrict__ ki,\n                       const float* __restrict__ vi, float* __restrict__ out, int n, int n_true,\n                       int cout, int vec2, int nqt, int nkt) {\n',
     'attn_hopper_f32_kernel(const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tqs,\n                       const __grid_constant__ CUtensorMap tkb, const __grid_constant__ CUtensorMap tks,\n                       const __grid_constant__ CUtensorMap tvb, const __grid_constant__ CUtensorMap tvs,\n                       float* __restrict__ out, int n, int n_true, int cout, int vec2, int groups) {\n'),
    ('#pragma unroll\n          for (int w = 0; w < 2; ++w) {\n            const size_t qb = (((size_t)b * nqt + blockIdx.x) * NS_CHUNK + c) * 2 + w;\n            const size_t kb = (((size_t)b * nkt + j) * NS_CHUNK + c) * 2 + w;\n            bulk_load(dst + w * S_HALF, qi + qb * (2 * QP / 4), 2 * QP, full(s));\n            bulk_load(dst + w * S_HALF + 2 * QP, ki + kb * (2 * KP / 4), 2 * KP, full(s));\n          }\n',
     '#pragma unroll\n          for (int w = 0; w < 2; ++w) {\n            const int ch = 256 * w + SCH * c;\n            const uint32_t d = dst + w * S_HALF;\n            const int slab = b * (C / SCH) + ch / SCH;\n            tma_load(d, &tqb, full(s), 0, q0, slab);\n            tma_load(d + QP, &tqs, full(s), 0, q0, slab);\n            tma_load(d + 2 * QP, &tkb, full(s), 0, j * BK, slab);\n            tma_load(d + 2 * QP + KP, &tks, full(s), 0, j * BK, slab);\n          }\n'),
    ('          const size_t vb = ((size_t)b * nkt + j) * NV_CHUNK + v;\n          bulk_load(sbase + s * STAGE, vi + vb * (V_BYTES / 4), V_BYTES, full(s));\n',
     '          const uint32_t dst = sbase + s * STAGE;\n          const int grp = b * groups + j * (BK / VK) + v;\n#pragma unroll\n          for (int w = 0; w < 2; ++w) {\n            tma_load(dst + w * V_HALF, &tvb, full(s), 0, 256 * w, grp);\n            tma_load(dst + w * V_HALF + VP, &tvs, full(s), 0, 256 * w, grp);\n          }\n'),
    ('// 64-query tiles and 128-key steps of an image\nint query_tiles(int n) { return (n + BQ - 1) / BQ; }\nint key_steps(int n) { return (n + BK - 1) / BK; }\n\n}  // namespace\n\n// Dynamic shared memory the kernel asks for, in bytes.\nextern "C" int attn_hopper_f32_smem_bytes() { return SMEM_BYTES; }\n\n// Bytes of the scratch the entry needs for B images of n tokens: the split\n// pass\'s images of q (per 64-query tile), k and v (per 128-key step).\nextern "C" long long attn_hopper_f32_scratch_bytes(int B, int n) {\n  const long long per_tile = (long long)NS_CHUNK * 2 * 2 * QP, per_step = (long long)NS_CHUNK * 2 * 2 * KP;\n  return B * (query_tiles(n) * per_tile + key_steps(n) * (per_step + (long long)NV_CHUNK * V_BYTES));\n}\n\n// q, k, v, out: [B, n, c] contiguous float32, c <= 512; q pre-scaled. scratch:\n// attn_hopper_f32_scratch_bytes(B, n) bytes, 16-byte aligned. Launches the\n// split pass, then the attention kernel, on `stream`.\nextern "C" int attn_hopper_f32(const void* q, const void* k, const void* v, void* out, int B, int n,\n                               int n_true, int c, void* scratch, void* stream) {\n  if (B <= 0 || n <= 0) return 0;\n  if (c < 1 || c > C || n_true < 1 || n_true > n || (reinterpret_cast<uintptr_t>(scratch) & 15))\n    return (int)cudaErrorInvalidValue;\n  const int nqt = query_tiles(n), nkt = key_steps(n);\n  float* qi = static_cast<float*>(scratch);\n  float* ki = qi + (size_t)B * nqt * NS_CHUNK * 2 * 2 * QP / 4;\n  float* vi = ki + (size_t)B * nkt * NS_CHUNK * 2 * 2 * KP / 4;\n  cudaStream_t st = static_cast<cudaStream_t>(stream);\n  attn_split_kernel<<<dim3(nkt * BK / 32, C / 32, B), dim3(32, 8), 0, st>>>(\n      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), qi, ki,\n      vi, n, nqt, nkt, c);\n  cudaError_t e = cudaGetLastError();\n  if (e != cudaSuccess) return (int)e;\n  e = cudaFuncSetAttribute(attn_hopper_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n                           SMEM_BYTES);\n  if (e != cudaSuccess) return (int)e;\n  const int vec2 = c % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;\n  attn_hopper_f32_kernel<<<dim3(nqt, B), NT, SMEM_BYTES, st>>>(qi, ki, vi, static_cast<float*>(out), n,\n                                                               n_true, c, vec2, nqt, nkt);\n  return (int)cudaGetLastError();\n}\n',
     'typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,\n                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,\n                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,\n                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);\n\nEncodeTiledFn encode_fn() {\n  static EncodeTiledFn fn = nullptr;\n  if (fn == nullptr) {\n    void* p = nullptr;\n    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;\n#if CUDART_VERSION >= 12050\n    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);\n#else\n    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);\n#endif\n    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);\n  }\n  return fn;\n}\n\n// a float32 [outer, rows, inner] array -> a 3-D map whose box is box_inner x box_rows of one outer index\nbool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int inner, int box_inner,\n              int box_rows, CUtensorMapSwizzle swz) {\n  EncodeTiledFn enc = encode_fn();\n  if (enc == nullptr) return false;\n  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)B};\n  cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)rows * inner * 4};\n  cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};\n  cuuint32_t estr[3] = {1, 1, 1};\n  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box, estr,\n             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,\n             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;\n}\n\n// 8-key groups of v^T an image: whole key steps\nint key_groups(int n) { return (n + BK - 1) / BK * (BK / VK); }\n\n}  // namespace\n\n// Dynamic shared memory the kernel asks for, in bytes.\nextern "C" int attn_hopper_f32_smem_bytes() { return SMEM_BYTES; }\n\n// Bytes of the scratch the entry needs for B images of n tokens: the big and\n// small parts of q, k ([B, 32, n, 16] each) and of v^T ([B, G, 512, 8] each).\nextern "C" long long attn_hopper_f32_scratch_bytes(int B, int n) {\n  return 4ll * 4 * B * (long long)n * C + 4ll * 2 * B * (long long)key_groups(n) * VK * C;\n}\n\n// q, k, v, out: [B, n, c] contiguous float32, c <= 512; q pre-scaled. scratch:\n// attn_hopper_f32_scratch_bytes(B, n) bytes, 16-byte aligned. Launches the\n// split pass, then the attention kernel, on `stream`.\nextern "C" int attn_hopper_f32(const void* q, const void* k, const void* v, void* out, int B, int n,\n                               int n_true, int c, void* scratch, void* stream) {\n  if (B <= 0 || n <= 0) return 0;\n  if (c < 1 || c > C || n_true < 1 || n_true > n || (reinterpret_cast<uintptr_t>(scratch) & 15))\n    return (int)cudaErrorInvalidValue;\n  const int groups = key_groups(n);\n  const size_t rows = (size_t)B * n * C, cols = (size_t)B * groups * VK * C;\n  float* qb = static_cast<float*>(scratch);\n  float* qs = qb + rows;\n  float* kb = qs + rows;\n  float* ks = kb + rows;\n  float* vb = ks + rows;\n  float* vs = vb + cols;\n  cudaStream_t st = static_cast<cudaStream_t>(stream);\n  attn_split_kernel<<<dim3(groups * VK / 32, C / 32, B), dim3(32, 8), 0, st>>>(\n      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), qb, qs,\n      kb, ks, vb, vs, n, groups, c);\n  cudaError_t e = cudaGetLastError();\n  if (e != cudaSuccess) return (int)e;\n  CUtensorMap mqb, mqs, mkb, mks, mvb, mvs;\n  const int slabs = B * (C / SCH), vgroups = B * groups;\n  if (!make_map(&mqb, qb, slabs, n, SCH, SCH, BQ, CU_TENSOR_MAP_SWIZZLE_64B) ||\n      !make_map(&mqs, qs, slabs, n, SCH, SCH, BQ, CU_TENSOR_MAP_SWIZZLE_64B) ||\n      !make_map(&mkb, kb, slabs, n, SCH, SCH, BK, CU_TENSOR_MAP_SWIZZLE_64B) ||\n      !make_map(&mks, ks, slabs, n, SCH, SCH, BK, CU_TENSOR_MAP_SWIZZLE_64B) ||\n      !make_map(&mvb, vb, vgroups, C, VK, VK, 256, CU_TENSOR_MAP_SWIZZLE_32B) ||\n      !make_map(&mvs, vs, vgroups, C, VK, VK, 256, CU_TENSOR_MAP_SWIZZLE_32B))\n    return (int)cudaErrorInvalidValue;\n  e = cudaFuncSetAttribute(attn_hopper_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n                           SMEM_BYTES);\n  if (e != cudaSuccess) return (int)e;\n  const int vec2 = c % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;\n  attn_hopper_f32_kernel<<<dim3((n + BQ - 1) / BQ, B), NT, SMEM_BYTES, st>>>(\n      mqb, mqs, mkb, mks, mvb, mvs, static_cast<float*>(out), n, n_true, c, vec2, groups);\n  return (int)cudaGetLastError();\n}\n'),
]

# every CTA starts its key loop at another key step (its query tile's index),
# wrapping around: the CTAs of an image no longer read the same K and V at once
_STAGGER = [("      for (int j = 0; j < n_kt; ++j) {\n        for (int c = 0; c < NS_CHUNK; ++c) {",
             "      for (int j0 = 0; j0 < n_kt; ++j0) {\n        const int j = (j0 + blockIdx.x) % n_kt;\n"
             "        for (int c = 0; c < NS_CHUNK; ++c) {"),
            ("    for (int j = 0; j < n_kt; ++j) {\n      // -------- S_j",
             "    for (int j0 = 0; j0 < n_kt; ++j0) {\n      const int j = (j0 + blockIdx.x) % n_kt;\n"
             "      // -------- S_j")]

# consumers that only wait for each chunk and release it: the loads alone
_LOADS_ONLY = r"""    // ---------------- consumers: every chunk waited for and released --------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = ltid & 31;
    int st = 0;
    uint32_t par = 0;
    for (int t = 0; t < n_kt * (NS_CHUNK + NV_CHUNK); ++t) {
      mbar_wait(full(st), par);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      if (++st == NSTAGE) {
        st = 0;
        par ^= 1;
      }
    }
    if (ltid == 0 && q0 == 0 && b < 0) out[0] = 0.f;
  }
}

"""

# the first PV of the shipped design: two 128-channel products per V chunk into a
# 64-register temporary, each waited for before it is added
_PV_HALVES = [
    (_SPLIT, r"""// d[64] (+)= A[64x8] B[8x128], the same shape for the PV product over 128 channels.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


""" + _SPLIT),
    ("    float t[32];   // one short S product (a sub-chunk's 16 channels), then PV products with s\n",
     "    float t[32];   // one short S product (a sub-chunk's 16 channels)\n"
     "    float pv[64];  // one short PV product (a V chunk's 8 keys, 128 channels)\n"),
    (("      // -------- acc += P V_j: per 8-key V chunk four products",
      "    // the row sums over both consumers' keys\n"), r"""      // -------- acc += P V_j: each V chunk (8 keys) a product per 128 channels,
      // added to the accumulator in float32
#pragma unroll
      for (int i = 0; i < 64; ++i) pv[i] = 0.f;
      for (int v = 0; v < NV_CHUNK; ++v) {
        mbar_wait(full(st), par);
        const uint32_t vbig = sbase + st * STAGE + w * V_HALF, vsmall = vbig + VP;
        const uint32_t poff = (v >> 2) * PBLK + (v & 3) * 32;
        const uint64_t pb = desc<1>(p_big + poff, 1024), ps = desc<1>(p_small + poff, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wg_fence();
          wgmma_m64n128(pv, ps, desc<3>(vbig + h * 4096, 256), 0);
          wgmma_m64n128(pv, pb, desc<3>(vsmall + h * 4096, 256), 1);
          wgmma_m64n128(pv, pb, desc<3>(vbig + h * 4096, 256), 1);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            pin(pv[i]);
            acc[64 * h + i] += pv[i];
          }
        }
        release();
      }
    }

"""),
]

# probe_no_mma: the products of the shipped source return at once
_NO_MMA = [("wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {\n",
            "wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {\n  return;\n")]

# name -> (base, edits): base None is the shipped source, "channel_split" CHANNEL_SPLIT_CU
HOPPER_DESIGNS = {
    "shipped": (None, []),
    "staggered": (None, _STAGGER),
    "pv_halves": (None, _PV_HALVES),
    "channel_split": ("channel_split", []),
    "tensor_maps": ("channel_split", _TENSOR_MAPS),
    "cluster_2": ("channel_split", _CLUSTER),
    "one_chain": ("channel_split", [((_CONSUMERS, _HOST), _ONE_CHAIN), (_SPLIT, _M64N256 + "\n" + _SPLIT)]),
    "probe_no_loads": (None, [_NO_COPY, ("mbar_expect_tx(full(s), S_BYTES);", "mbar_expect_tx(full(s), 0);"),
                              ("mbar_expect_tx(full(s), V_BYTES);", "mbar_expect_tx(full(s), 0);")]),
    "probe_loads_only": (None, [((_CONSUMERS, _HOST), _LOADS_ONLY)]),
    "probe_no_mma": (None, _NO_MMA),
}


def _edit(text, name, old, new):
    if isinstance(old, tuple):   # a block: from its first line to (not including) the second
        a, b = text.find(old[0]), text.find(old[1])
        if a < 0 or b < a or text.count(old[0]) != 1:
            raise RuntimeError(f"design {name}: the block to replace is not in the source once")
        return text[:a] + new + text[b:]
    if text.count(old) != 1:
        raise RuntimeError(f"design {name}: the text to replace is not in the source once")
    return text.replace(old, new)


def build_all(out_dir, family):
    """-> {design: (ctypes function, takes a scratch pointer)}"""
    plan = {}
    if family in ("hopper", "both"):
        plan.update({n: ("attn_hopper_f32.cu", base, e) for n, (base, e) in HOPPER_DESIGNS.items()})
    if family in ("simt", "both"):
        plan.update({n: ("attn_fused.cu", None, e) for n, e in SIMT_DESIGNS.items()})
    else:
        plan["simt"] = ("attn_fused.cu", None, [])
    procs = {}
    for name, (source, base, edits) in plan.items():
        text = CHANNEL_SPLIT_CU if base == "channel_split" else \
            open(os.path.join(_build.CSRC_DIR, source)).read()
        for old, new in edits:
            text = _edit(text, name, old, new)
        cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (source, so, subprocess.Popen(_build.nvcc_command(cu, so),
                                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                    text=True))
    fns = {}
    for name, (source, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:   # e.g. a layout beyond the shared memory: reported, not timed
            print(json.dumps({"design": name, "nvcc_failed": log[-600:]}), flush=True)
            continue
        notes = [ln.strip() for ln in log.splitlines() if "spill" in ln or "registers" in ln or "C7515" in ln]
        print(json.dumps({"design": name, "ptxas": notes}), flush=True)
        lib = ctypes.CDLL(so)
        hopper = source == "attn_hopper_f32.cu"
        fn = lib.attn_hopper_f32 if hopper else lib.attn_fused_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * (2 if hopper else 1)
        fn.restype = ctypes.c_int
        if hopper:
            lib.attn_hopper_f32_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.attn_hopper_f32_scratch_bytes.restype = ctypes.c_longlong
        fns[name] = (fn, lib.attn_hopper_f32_scratch_bytes if hopper else None)
    return fns


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=("hopper", "simt", "both"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attn_f32_designs.py measures on an NVIDIA GPU")
    out_dir = os.path.join(_build.build_dir(), "attn_f32_designs")
    os.makedirs(out_dir, exist_ok=True)
    fns = build_all(out_dir, args.family)
    b, n, n_true = 1, 16384, 16275
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = [torch.randn(b, n, 512, device="cuda", generator=g) for _ in range(3)]
    qs = attn._scale_q(q).contiguous()
    want = attn.flash_attention_nhc_ref(q, k, v, n_true=n_true)[:, :n_true]
    rows = slice(5000, 5064)
    s64 = (q[:, rows].double() @ k[:, :n_true].double().transpose(1, 2)) * 512 ** -0.5
    dense = torch.softmax(s64, -1) @ v[:, :n_true].double()
    plain_oracle = float((want[:, rows].double() - dense).abs().max())
    tol = 5e-5
    res = {}
    for name in list(fns) + list(fns)[::-1]:
        fn, scratch_bytes = fns[name]
        out = torch.empty_like(qs)
        extra = []
        if scratch_bytes is not None:
            buf = torch.empty(int(scratch_bytes(b, n)) // 4, device="cuda")
            extra = [buf.data_ptr()]

        def call():
            err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n_true,
                     512, *extra, torch.cuda.current_stream().cuda_stream)
            _build.check(err, name)

        call()
        torch.cuda.synchronize()
        err = float((out[:, :n_true] - want).abs().max())
        probe = "probe_" in name
        if err > tol and not probe:
            raise AssertionError(f"design {name}: {err} > {tol}")
        call()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(5):
            call()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 5
        res.setdefault(name, []).append({
            "ms": ms, "tflops": 4.0 * b * n_true ** 2 * 512 / ms / 1e9, "max_abs_err": err,
            "oracle_err": float((out[:, rows].double() - dense).abs().max())})
        del extra
    print(json.dumps({"shape": [b, n, 512], "n_true": n_true, "tol": tol,
                      "plain_oracle_err": plain_oracle, "designs": res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)


if __name__ == "__main__":
    main()
