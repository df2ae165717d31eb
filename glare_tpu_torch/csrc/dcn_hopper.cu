// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a): 3x3,
// stride 1, pad 1, G deformable groups, channels-last, bf16.
//
// Replaces the Pallas kernel `_kernel_core` (glare_tpu/ops/dcn_pallas.py:55,
// entry `modulated_deform_conv_pallas`, call :397) and, with a clamp radius
// per image row, the Pallas cascade `modulated_deform_conv_pallas_cascade`
// (:448; base `_kernel` + compacted tail `_kernel_selected`). Same function as
// they, the exact op of glare_tpu/ops/dcn.py:98 and the plain versions in
// ops/dcn.py: each offset clamped to +-R (R per (group, tap), or per image row
// for the cascade; inf = no clamp = the exact op); bilinear sampling with the
// zero-border semantics of the reference CUDA extension (a sample outside
// (-1,H)x(-1,W) is zero, each corner outside the image is zero); times the
// modulation mask; the sampled column rounded once to bf16; the [9C -> O]
// contraction with float32 accumulation; plus bias; the result in bf16.
//
// Envelope (ops/dcn.py:route sends everything else to csrc/dcn_fwd.cu):
// bf16 x and weight, C a multiple of 64, Cg = C / G a multiple of 32 (the
// paths have Cg 64 and 32), O 128 or 256, x and weight 16-byte aligned.
//
// What bounds it on an H100: operations, 2 * B*H*W * 9*C * O FLOP on the bf16
// tensor cores (989 TFLOP/s); the bytes of x, offset, mask and out take less
// time. What held the earlier kernel (dcn_fwd.cu) at 4-6% of that bound was
// traffic from L2 (every tap's weight slice read by every 64-pixel block, four
// corners x C x 9 taps gathered from L2 per pixel), block-wide barriers
// between sampling and the products, and mma.sync. The design here:
//  * 2-D output tiles of TH x TW = 128 pixels (8 x 16) x all O outputs, in a
//    persistent loop (one CTA per SM walks the tiles). The K loop runs over
//    chunks (64-channel block cb, tap k): 64 rows k*C + cb*64 of the [9C, O]
//    weight. A block of 64 channels holds one group (Cg 64), two (Cg 32), ...
//  * A halo in shared memory, loaded by TMA: per channel block, the tile's
//    footprint [TH + 2RH + 3, TW + 2RH + 3, 64] of x through a 4-D tensor map
//    over [B, H, W, C]; the hardware fills out-of-image elements with zeros,
//    which is the zero-corner rule. RH = 2 covers the paths' clamp radius.
//    A corner that falls outside the staged box (exact mode, per-tap radii or
//    cascade rows above RH) is read from global memory with the image test,
//    so every radius stays exact and the fast case is the common one. Two
//    halo buffers: the next block's halo loads while this one is sampled.
//  * Weights streamed by TMA as [64, O] chunks (boxes of 64 x 64, 128-byte
//    swizzle) into a ring of NWS stages with full/empty mbarriers.
//  * Warp specialisation. Warpgroup 2 (40 registers): one thread issues the
//    weight loads, another the halo loads. Warpgroups 0 and 1 (232
//    registers) own 64 pixels each: for every chunk they sample their
//    [64, 64] bf16 A block into shared memory in the K-major 128-byte
//    swizzled layout wgmma reads, then issue wgmma.m64n128k16 (A and B from
//    shared memory, B MN-major) into a 64 x O float32 accumulator, and
//    sample the next chunk while those run (two A stages per warpgroup,
//    wgmma.wait_group 1).
//  * The sampler. A thread fills 16 bytes (8 channels) of four A rows per
//    chunk; the 8 lanes of a pixel slot cover its 64 channels, so each halo
//    corner read is 128 contiguous bytes a pixel. The lanes of a 4-lane
//    cluster share a row set and a group: each loads the offsets, mask and
//    radius of one row one chunk ahead (their latency hides behind a chunk's
//    work) and computes that row's geometry (clamp, bilinear weights, halo
//    address), which the cluster exchanges by shuffles. Then, without a
//    branch, the sixteen halo loads and the sums; a row whose corners leave
//    the staged box takes the per-corner path.
//  * Epilogue: bias, bf16, 4-byte stores from the accumulator fragments.
//  * The `pallas` counter: the samplers read every raw offset anyway; a tap
//    with max(|dy|, |dx|) above its radius adds one, summed per CTA and added
//    once to a device int64 (the caller's overflow[1]).
//  * Measured alternatives (tools/dcn_designs.py builds each from this source
//    with some of its text replaced), all slower or level: no halo (2x), a
//    branch per row (1.4-1.6x), every lane computing all four rows' geometry
//    (1.12x, and it spills), 4x32 / 16x8 tiles, three weight stages, 2-CTA
//    clusters (each CTA loads half of a weight chunk and multicasts it to
//    both: 1.5x, the pair waits on each other's ring).
//
// Second kernel, `cascade_select_kernel` (entry dcn_cascade_select): the
// cascade's block selection in one device pass, replacing ~20 small torch
// ops (ops/dcn.py:cascade_selection, which stays its plain version). One CTA
// per image row reads the row's offsets once, flags the row block if a tap
// exceeds R and counts the taps beyond R_tail; the last CTA to finish (an
// atomic ticket) scans the B * n_rblk block flags in flat (image, block)
// order, takes the first n_sel, writes the [B*H] row-radius table (R_tail on
// the rows of selected blocks, R elsewhere) and the two counters.
//
// Where trouble hides:
//  * The A blocks are written by ordinary stores and read by wgmma (the
//    async proxy): fence.proxy.async, then a warpgroup barrier, before the
//    issue. A block is rewritten only after the wgmma that read it retired.
//  * wgmma descriptors: A K-major, 128-byte swizzle (8-row groups 1024 B
//    apart, 16-channel step +32 B); B MN-major with the transpose bit (64-
//    output boxes 8192 B apart, 8-row groups 1024 B apart, 16-row step
//    +2048 B). The 128-byte swizzle of A is written by hand: 16-byte chunk
//    index XOR (row % 8).
//  * Registers: launch with 384 threads and __launch_bounds__(384, 1), then
//    setmaxnreg (40 / 232); the accumulator (128 floats at O = 256) is
//    pinned after each wait. Read ptxas -v for spills and warning C7515.
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// Design constants (tools/dcn_designs.py also times other tile shapes and stages).
constexpr int TH = 8;            // output tile rows
constexpr int TW = 16;           // output tile columns
constexpr int RH = 2;            // halo radius: offsets up to RH px sample from the halo
constexpr int NWS = 2;           // weight ring stages

constexpr int TM = TH * TW;
static_assert(TM == 128, "two consumer warpgroups of 64 pixels each");
constexpr int CB = 64;           // K chunk: 64 channels of one tap, 128 bytes a pixel
constexpr int KK = 9;            // taps
constexpr int NT = 384;          // 3 warpgroups
constexpr int HALO_H = TH + 2 * RH + 3;
constexpr int HALO_W = TW + 2 * RH + 3;
constexpr int HALO_BYTES = HALO_H * HALO_W * CB * 2;
constexpr int A_BYTES = TM * CB * 2;  // one A stage: 128 pixels x 64 channels

__host__ __device__ constexpr int w_bytes(int nh) { return nh * 128 * CB * 2; }
__host__ __device__ constexpr int off_w() { return 2 * A_BYTES; }
__host__ __device__ constexpr int off_halo(int nh) { return off_w() + NWS * w_bytes(nh); }
__host__ __device__ constexpr int off_bar(int nh) { return off_halo(nh) + 2 * HALO_BYTES; }
// barriers (4 + 2 NWS) x 8 B and the CTA's counter, then the 1024-byte alignment slack
__host__ __device__ constexpr int smem_bytes(int nh) { return off_bar(nh) + 256 + 1024; }
static_assert(4 + 2 * NWS <= 30, "barriers fit their 256 bytes");

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
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
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

// d[64] (+)= A[64x16] (shared, K-major) B[16x128] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// v[8] += w * (8 bf16 values)
__device__ __forceinline__ void fma8(float (&v)[8], const uint4 q, float w) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = fmaf(__uint_as_float(u[i] << 16), w, v[2 * i]);
    v[2 * i + 1] = fmaf(__uint_as_float(u[i] & 0xFFFF0000u), w, v[2 * i + 1]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct Dims {
  int B, H, W, C, O, G, Cg;
  int tiles_x, tiles_per_img, n_tiles;
};

// ---------------------------------------------------------------- kernel --
// NH = O / 128; ROWS: radius is a per-image-row table [B*H] (the cascade),
// else per (group, tap) [G*9].
template <int NH, bool ROWS>
__global__ void __launch_bounds__(NT, 1)
dcn_hopper_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                  const bf16* __restrict__ x, const float* __restrict__ offset,
                  const float* __restrict__ mask, const float* __restrict__ bias,
                  const float* __restrict__ radius, bf16* __restrict__ out,
                  unsigned long long* __restrict__ count, Dims d) {
  constexpr int WB = w_bytes(NH);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sA = smem_u32(smem), sW = sA + off_w(), sH = sA + off_halo(NH);
  const uint32_t bar = sA + off_bar(NH);
  auto h_full = [&](int s) { return bar + 8 * s; };
  auto h_empty = [&](int s) { return bar + 16 + 8 * s; };
  auto w_full = [&](int s) { return bar + 32 + 8 * s; };
  auto w_empty = [&](int s) { return bar + 32 + 8 * NWS + 8 * s; };
  unsigned int* cta_count = reinterpret_cast<unsigned int*>(smem + off_bar(NH) + 32 + 16 * NWS);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, ltid = tid & 127;
  const int ncb = d.C / CB;
  const int nq = ncb * KK;  // K chunks of a tile

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(h_full(s), 1);
      mbar_init(h_empty(s), 8);  // one arrive per worker warp
    }
    for (int s = 0; s < NWS; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 8);
    }
    *cta_count = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread for weights, one for halos ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (ltid == 0) {
      int wc = 0;
      for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
        for (int j = 0; j < nq; ++j, ++wc) {
          const int cb = j / KK, k = j - cb * KK;
          const int s = wc % NWS;
          mbar_wait(w_empty(s), ((wc / NWS) & 1) ^ 1);  // the first pass does not wait
          mbar_expect_tx(w_full(s), WB);
          const int row = k * d.C + cb * CB;
#pragma unroll
          for (int nb = 0; nb < 2 * NH; ++nb)
            tma_load_2d(sW + s * WB + nb * 8192, &tmw, w_full(s), nb * 64, row);
        }
      }
    } else if (ltid == 32) {
      int hc = 0;
      for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
        const int b = tile / d.tiles_per_img, rem = tile - b * d.tiles_per_img;
        const int ty0 = (rem / d.tiles_x) * TH, tx0 = (rem % d.tiles_x) * TW;
        for (int cb = 0; cb < ncb; ++cb, ++hc) {
          const int s = hc & 1;
          mbar_wait(h_empty(s), ((hc >> 1) & 1) ^ 1);
          mbar_expect_tx(h_full(s), HALO_BYTES);
          tma_load_4d(sH + s * HALO_BYTES, &tmx, h_full(s), cb * CB, tx0 - 1 - RH, ty0 - 1 - RH, b);
        }
      }
    }
  } else {
    // ---------------- workers: pixels [64 wg, 64 wg + 64) of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = ltid >> 5, lane = ltid & 31;
    const int sub = ltid & 7;                  // 8-channel slice of the 64-channel chunk
    const int row0 = wg * 64 + (ltid >> 3);    // sampled rows: row0 + 16 i, i < 4
    const unsigned char* halo_base = smem + off_halo(NH);
    float acc[NH][64];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[nh][i] = 0.f;
    unsigned int cnt = 0;
    int jc = 0, hc = 0;

    auto release_w = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(w_empty(s));
    };

    for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
      const int b = tile / d.tiles_per_img, rem = tile - b * d.tiles_per_img;
      const int ty0 = (rem / d.tiles_x) * TH, tx0 = (rem % d.tiles_x) * TW;
      const int hy0 = ty0 - 1 - RH, hx0 = tx0 - 1 - RH;  // halo origin
      // flat pixel index of sampled row i (rows row0 + 16 i), -1 outside the image
      auto row_pixel = [&](int i) {
        const int m = row0 + 16 * i;
        const int h = ty0 + m / TW, w = tx0 + m % TW;
        return (h < d.H && w < d.W) ? (b * d.H + h) * d.W + w : -1;
      };
      // (dy, dx, mask, radius) of chunk j for row i
      auto load_param = [&](int i, int j) {
        const int cb = j / KK, k = j - cb * KK;
        const int g = (cb * CB + (sub & 4) * 8) / d.Cg;
        const int p = row_pixel(i);
        if (p < 0) return make_float4(0.f, 0.f, 0.f, 0.f);
        const size_t gk = ((size_t)p * d.G + g) * KK + k;
        const float2 o = __ldg(reinterpret_cast<const float2*>(offset) + gk);
        return make_float4(o.x, o.y, __ldg(mask + gk),
                           ROWS ? __ldg(radius + p / d.W) : __ldg(radius + g * KK + k));
      };
      // lane (sub & 3) of each 4-lane cluster (one pixel slot, one 32-channel
      // half, hence one group) loads and computes row (sub & 3) only
      float4 nxt = load_param(sub & 3, 0);

      for (int j = 0; j < nq; ++j, ++jc) {
        const int cb = j / KK, k = j - cb * KK;
        const int c = cb * CB + sub * 8;
        if (k == 0) mbar_wait(h_full(hc & 1), (hc >> 1) & 1);
        const float4 cur = nxt;
        if (j + 1 < nq) nxt = load_param(sub & 3, j + 1);

        // ---- sample chunk j into A stage (jc & 1): rows row0 + 16 i, channels c..c+7.
        // First the geometry of the four rows without branches (an invalid row or a
        // sample outside (-1,H)x(-1,W) gets weights 0 and a harmless halo address),
        // so the sixteen halo loads of the common case issue back to back; a row
        // with a corner outside the staged box takes the per-corner path.
        const int ky = k / 3 - 1, kx = k - (k / 3) * 3 - 1;
        unsigned char* a_stage = smem + (jc & 1) * A_BYTES;
        const unsigned char* halo = halo_base + (hc & 1) * HALO_BYTES + sub * 16;
        // row i's corner weights, top-left corner, offset in the halo (-1: a corner
        // lies outside the staged box), and the `pallas` count
        auto geometry = [&](const float4 p, int i, float (&w4)[4], int& gy, int& gx, int& ho,
                            bool counted) {
          const int m = row0 + 16 * i;
          const int h = ty0 + m / TW, w = tx0 + m % TW;
          const bool valid = h < d.H && w < d.W;
          const float r = p.w;
          if (counted && valid && fmaxf(fabsf(p.x), fabsf(p.y)) > r) ++cnt;
          const float py = (float)(h + ky) + fminf(fmaxf(p.x, -r), r);
          const float px = (float)(w + kx) + fminf(fmaxf(p.y, -r), r);
          const bool in = valid && py > -1.f && py < (float)d.H && px > -1.f && px < (float)d.W;
          const float y0f = floorf(py), x0f = floorf(px);
          const float ly = py - y0f, lx = px - x0f;
          const float hy = 1.f - ly, hx = 1.f - lx;
          w4[0] = in ? hy * hx : 0.f;
          w4[1] = in ? hy * lx : 0.f;
          w4[2] = in ? ly * hx : 0.f;
          w4[3] = in ? ly * lx : 0.f;
          gy = in ? (int)y0f : 0;
          gx = in ? (int)x0f : 0;
          const int iy = gy - hy0, ix = gx - hx0;
          const bool staged = iy >= 0 && iy < HALO_H - 1 && ix >= 0 && ix < HALO_W - 1;
          ho = staged ? (iy * HALO_W + ix) * (CB * 2) : (in ? -1 : 0);
        };
        float cw[4][4], mk[4];
        int cy[4], cx[4], hoff[4];
        {
          float w4[4];
          int gy, gx, ho;
          // one lane per (pixel, group) counts: the first cluster of the group's channels
          const bool counts = count != nullptr && (cb * CB + (sub & 4) * 8) % d.Cg == 0;
          geometry(cur, sub & 3, w4, gy, gx, ho, counts);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int src = (lane & ~3) | i;
#pragma unroll
            for (int e = 0; e < 4; ++e) cw[i][e] = __shfl_sync(0xffffffffu, w4[e], src);
            cy[i] = __shfl_sync(0xffffffffu, gy, src);
            cx[i] = __shfl_sync(0xffffffffu, gx, src);
            hoff[i] = __shfl_sync(0xffffffffu, ho, src);
            mk[i] = __shfl_sync(0xffffffffu, cur.z, src);
          }
        }
        const bool fast = hoff[0] >= 0 && hoff[1] >= 0 && hoff[2] >= 0 && hoff[3] >= 0;
        // mask, bf16, and the row into the A block at its swizzled place
        auto store_row = [&](int i, const float (&v)[8]) {
          const int m = row0 + 16 * i;
          uint4 st;
          st.x = pack_bf16(v[0] * mk[i], v[1] * mk[i]);
          st.y = pack_bf16(v[2] * mk[i], v[3] * mk[i]);
          st.z = pack_bf16(v[4] * mk[i], v[5] * mk[i]);
          st.w = pack_bf16(v[6] * mk[i], v[7] * mk[i]);
          *reinterpret_cast<uint4*>(a_stage + m * (CB * 2) + ((sub ^ (m & 7)) << 4)) = st;
        };
        if (fast) {
#pragma unroll
          for (int i2 = 0; i2 < 4; i2 += 2) {  // two rows' eight loads in flight at a time
            uint4 q[2][4];
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const unsigned char* hp = halo + hoff[i2 + ii];
              q[ii][0] = *reinterpret_cast<const uint4*>(hp);
              q[ii][1] = *reinterpret_cast<const uint4*>(hp + CB * 2);
              q[ii][2] = *reinterpret_cast<const uint4*>(hp + HALO_W * CB * 2);
              q[ii][3] = *reinterpret_cast<const uint4*>(hp + (HALO_W + 1) * CB * 2);
            }
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              float v[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
              for (int cnr = 0; cnr < 4; ++cnr) fma8(v, q[ii][cnr], cw[i2 + ii][cnr]);
              store_row(i2 + ii, v);
            }
          }
        } else {
          const bf16* xb = x + (size_t)b * d.H * d.W * d.C + c;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int iy = cy[i] - hy0, ix = cx[i] - hx0;
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
            for (int cnr = 0; cnr < 4; ++cnr) {
              const int yy = cy[i] + (cnr >> 1), xx = cx[i] + (cnr & 1);
              const int sy = iy + (cnr >> 1), sx = ix + (cnr & 1);
              if (sy >= 0 && sy < HALO_H && sx >= 0 && sx < HALO_W) {  // staged (zeros off the image)
                fma8(v, *reinterpret_cast<const uint4*>(halo + (sy * HALO_W + sx) * (CB * 2)), cw[i][cnr]);
              } else if (yy >= 0 && yy < d.H && xx >= 0 && xx < d.W) {
                fma8(v, __ldg(reinterpret_cast<const uint4*>(xb + ((size_t)yy * d.W + xx) * d.C)),
                     cw[i][cnr]);
              }
            }
            store_row(i, v);
          }
        }
        fence_proxy_async();      // the stores above, visible to wgmma
        named_bar_sync(1 + wg, 128);
        if (k == KK - 1) {  // this warpgroup is done with the halo of block cb
          if ((ltid & 31) == 0) mbar_arrive(h_empty(hc & 1));
          ++hc;
        }

        // ---- products of chunk j: acc[64 x O] += A[64 x 64] W[64 x O]
        const int ws = jc % NWS;
        mbar_wait(w_full(ws), (jc / NWS) & 1);
        wg_fence();
        const uint32_t a_desc = sA + (jc & 1) * A_BYTES + wg * (A_BYTES / 2);
        const uint32_t w_desc = sW + ws * WB;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int nh = 0; nh < NH; ++nh)
            wgmma_m64n128(acc[nh], desc_sw128(a_desc + kk * 32, 16, 1024),
                          desc_sw128(w_desc + nh * 16384 + kk * 2048, 8192, 1024), (j | kk) != 0);
        wg_commit();
        wg_wait<1>();  // chunk j-1 has retired: its weight stage is free
        if (j > 0) release_w((jc - 1) % NWS);
      }
      wg_wait<0>();
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int i = 0; i < 64; ++i) pin(acc[nh][i]);
      release_w((jc - 1) % NWS);

      // ---- epilogue: + bias, bf16, the fragment rows r and r + 8 of this warp
      const int col0 = (lane & 3) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wg * 64 + warp * 16 + (lane >> 2) + 8 * half;
        const int h = ty0 + m / TW, w = tx0 + m % TW;
        if (h < d.H && w < d.W) {
          bf16* o = out + ((size_t)(b * d.H + h) * d.W + w) * d.O + col0;
#pragma unroll
          for (int nh = 0; nh < NH; ++nh)
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int col = nh * 128 + 8 * i;
              float b0 = 0.f, b1 = 0.f;
              if (bias != nullptr) {
                const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col + col0));
                b0 = bb.x;
                b1 = bb.y;
              }
              *reinterpret_cast<uint32_t*>(o + col) =
                  pack_bf16(acc[nh][4 * i + 2 * half] + b0, acc[nh][4 * i + 2 * half + 1] + b1);
            }
        }
      }
    }

    if (count != nullptr) {
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0 && cnt != 0) atomicAdd(cta_count, cnt);
      named_bar_sync(3, 256);
      if (tid == 0 && *cta_count != 0) atomicAdd(count, (unsigned long long)*cta_count);
    }
  }
}

// ------------------------------------------------- the cascade's selection --
// scratch (int64, zeroed by the caller): [0] out-of-band blocks that found no
// slot, [1] taps beyond R_tail (these two are the caller's counters), [2] the
// running tail count, [3] the CTA ticket, [4 + i] the flag of block i.
constexpr int SEL_NT = 256;
constexpr int SEL_MAX_BLOCKS = 8192;

__global__ void __launch_bounds__(SEL_NT)
cascade_select_kernel(const float2* __restrict__ off, float* __restrict__ row_radius,
                      unsigned long long* __restrict__ scratch, int H, int row_taps, float R,
                      float Rt, int rpb, int n_rblk, int n_sel, int n_rows) {
  __shared__ unsigned char sel[SEL_MAX_BLOCKS];
  __shared__ int last;
  const int row = blockIdx.x;  // b * H + h
  const float2* p = off + (size_t)row * row_taps;
  int oob = 0;
  unsigned int tail = 0;
  for (int i = threadIdx.x; i < row_taps; i += SEL_NT) {
    const float2 v = __ldg(p + i);
    const float m = fmaxf(fabsf(v.x), fabsf(v.y));
    oob |= m > R;
    tail += m > Rt;
  }
  tail = __reduce_add_sync(0xffffffffu, tail);
  if ((threadIdx.x & 31) == 0 && tail != 0) atomicAdd(&scratch[2], (unsigned long long)tail);
  __threadfence();
  const int any = __syncthreads_or(oob);
  if (threadIdx.x == 0) {
    if (any) atomicOr(&scratch[4 + (row / H) * n_rblk + (row % H) / rpb], 1ull);
    __threadfence();
    last = atomicAdd(&scratch[3], 1ull) == (unsigned long long)(gridDim.x - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_blocks = (n_rows / H) * n_rblk;
  if (threadIdx.x == 0) {
    volatile unsigned long long* vs = scratch;
    unsigned long long n_oob = 0, n_taken = 0;
    for (int i = 0; i < n_blocks; ++i) {  // flat (image, block) order: the first n_sel take a slot
      const bool f = vs[4 + i] != 0;
      const bool s = f && n_taken < (unsigned long long)n_sel;
      n_oob += f;
      n_taken += s;
      sel[i] = s;
    }
    scratch[0] = n_oob - n_taken;
    scratch[1] = vs[2];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += SEL_NT)
    row_radius[r] = sel[(r / H) * n_rblk + (r % H) / rpb] ? Rt : R;
}

// ------------------------------------------------------------------ host --
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// x [B, H, W, C] -> boxes of 64 channels x the halo's columns x rows of one image
bool make_x_map(CUtensorMap* map, const void* x, int B, int H, int W, int C) {
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  cuuint32_t box[4] = {(cuuint32_t)CB, (cuuint32_t)HALO_W, (cuuint32_t)HALO_H, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// weight [9C, O] -> boxes of 64 rows x 64 outputs, 128-byte swizzle
bool make_w_map(CUtensorMap* map, const void* w, int C, int O) {
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)O, (cuuint64_t)9 * C};
  cuuint64_t strides[1] = {(cuuint64_t)O * 2};
  cuuint32_t box[2] = {64, 64};
  cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool in_envelope(const void* x, const void* weight, int C, int O, int G) {
  if (G < 1 || C % G != 0 || C % CB != 0 || (O != 128 && O != 256)) return false;
  if ((C / G) % 32 != 0) return false;  // a 4-lane cluster's 32 channels lie in one group
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0;
}

template <int NH, bool ROWS>
int launch(const void* x, const void* offset, const void* mask, const void* weight, const void* bias,
           const void* radius, void* out, void* count, int B, int H, int W, int C, int O, int G,
           void* stream) {
  Dims d;
  d.B = B; d.H = H; d.W = W; d.C = C; d.O = O; d.G = G; d.Cg = C / G;
  d.tiles_x = (W + TW - 1) / TW;
  d.tiles_per_img = d.tiles_x * ((H + TH - 1) / TH);
  d.n_tiles = B * d.tiles_per_img;
  CUtensorMap tmx, tmw;
  if (!make_x_map(&tmx, x, B, H, W, C) || !make_w_map(&tmw, weight, C, O))
    return (int)cudaErrorInvalidValue;
  auto kernel = dcn_hopper_kernel<NH, ROWS>;
  const int smem = smem_bytes(NH);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* of = static_cast<const float*>(offset);
  const float* mf = static_cast<const float*>(mask);
  const float* bf = static_cast<const float*>(bias);
  const float* rf = static_cast<const float*>(radius);
  bf16* ob = static_cast<bf16*>(out);
  unsigned long long* cp = static_cast<unsigned long long*>(count);
  const int grid = d.n_tiles < n_sm ? d.n_tiles : n_sm;
  kernel<<<grid, NT, smem, s>>>(tmx, tmw, xb, of, mf, bf, rf, ob, cp, d);
  return (int)cudaGetLastError();
}

template <bool ROWS>
int dispatch(const void* x, const void* offset, const void* mask, const void* weight,
             const void* bias, const void* radius, void* out, void* count, int B, int H, int W,
             int C, int O, int G, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (!in_envelope(x, weight, C, O, G)) return (int)cudaErrorInvalidValue;
  if (O == 256)
    return launch<2, ROWS>(x, offset, mask, weight, bias, radius, out, count, B, H, W, C, O, G, stream);
  return launch<1, ROWS>(x, offset, mask, weight, bias, radius, out, count, B, H, W, C, O, G, stream);
}

}  // namespace

// Dynamic shared memory a CTA asks for at O outputs, in bytes.
extern "C" int dcn_hopper_smem_bytes(int O) { return smem_bytes(O > 128 ? 2 : 1); }

// x [B,H,W,C] bf16, offset [B,H,W,G,9,2] f32 (dy,dx), mask [B,H,W,G,9] f32,
// weight [9*C, O] bf16 (row k*C + c), bias [O] f32 or null, radius [G*9] f32
// (inf = no clamp), out [B,H,W,O] bf16; count: an int64 to which the taps with
// max(|dy|,|dx|) above their radius are added, or null.
extern "C" int dcn_hopper_fwd(const void* x, const void* offset, const void* mask,
                              const void* weight, const void* bias, const void* radius, void* out,
                              void* count, int B, int H, int W, int C, int O, int G, void* stream) {
  return dispatch<false>(x, offset, mask, weight, bias, radius, out, count, B, H, W, C, O, G, stream);
}

// The cascade: as dcn_hopper_fwd, but row_radius [B*H] f32 holds the clamp
// radius of every image row (from dcn_cascade_select).
extern "C" int dcn_hopper_cascade_fwd(const void* x, const void* offset, const void* mask,
                                      const void* weight, const void* bias, const void* row_radius,
                                      void* out, void* count, int B, int H, int W, int C, int O,
                                      int G, void* stream) {
  return dispatch<true>(x, offset, mask, weight, bias, row_radius, out, count, B, H, W, C, O, G,
                        stream);
}

// The cascade's selection: offset [B,H,W,G,9,2] f32 -> row_radius [B*H] f32 and
// scratch[0:2] = [blocks that found no slot, taps beyond R_tail]; scratch is an
// int64 [4 + B*n_rblk] buffer of zeros. row_taps = W*G*9.
extern "C" int dcn_cascade_select(const void* offset, void* row_radius, void* scratch, int B, int H,
                                  int row_taps, float R, float Rt, int rpb, int n_rblk, int n_sel,
                                  void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (rpb < 1 || n_rblk < 1 || B * n_rblk > SEL_MAX_BLOCKS || row_taps < 0)
    return (int)cudaErrorInvalidValue;
  cascade_select_kernel<<<B * H, SEL_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(offset), static_cast<float*>(row_radius),
      static_cast<unsigned long long*>(scratch), H, row_taps, R, Rt, rpb, n_rblk, n_sel, B * H);
  return (int)cudaGetLastError();
}
