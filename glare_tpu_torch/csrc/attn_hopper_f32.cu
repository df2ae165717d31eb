// Fused single-head attention for Hopper (sm_90a), forward only, float32:
// softmax(q k^T) v for [B, n, C] float32 inputs (C <= 512) whose q already
// carries the 1/sqrt(C) * log2(e) scale.
//
// Replaces the Pallas kernels `_kernel` (glare_tpu/ops/attn_pallas.py:44) and
// `_kernel_pipe` (:96), entry `flash_attention_nhc`, for float32 inputs: a
// float32 network with GLARE_ATTN_FUSED=1 (the checkpoint sweeps and training
// validation serve in float32) sends its large attention blocks here. Same
// function as the plain version `flash_attention_nhc_ref` (ops/attn.py) in
// float32: scores, running max m, running sum l and the output accumulator in
// float32; exp2 online softmax; keys in [n_true, n) masked to -1e30; output =
// acc / l; rows >= n never written.
//
// Float32 means float32: every product is 3xTF32. Each operand x is split
// into big = tf32(x) and small = tf32(x - big) (round to nearest, ties away:
// cvt.rna), and x.y is taken as small.big + big.small + big.big, each product
// on the TF32 tensor cores (wgmma ... .tf32). What is dropped, small.small and
// small's own rounding, is ~2^-22 of each product. The tensor cores' float32
// sums truncate (round toward zero), so a long chain of products into one
// accumulator drifts: one accumulator over the whole key loop ended ~140x
// farther from a float64 oracle than the plain float32 version (design
// one_chain of glare_tpu_torch/tools/attn_f32_designs.py). Here every chain is
// short and starts from 0 -- one S sub-chunk (16 channels, 6 products), a
// quarter of a V chunk (8 keys, 64 channels, 3 products) -- and is added to its
// running sum with a float32 FADD (round to nearest): within 2x of the plain
// version's error.
//
// What bounds it on an H100: operations, 3 x 4 * B * n_true^2 * C FLOP at
// the 495 TFLOP/s TF32 rate (4 * B * n_true^2 * C at the 67 TFLOP/s of the
// float32 units would be the bound without the tensor cores). In practice
// shared memory's bandwidth: the products read both operands from it (a
// 64-column product re-reads its 64-row A for every 64 columns), the loads
// write it, and big and small of K and V (8 KB a key at C = 512) and of Q are
// brought in for every 64-query tile (~40 GB at [1, 16384, 512], from L2: the
// CTAs of an image walk the keys in step, so each chunk is read by all of
// them at about the same time; staggering the walks is slower, design
// staggered).
//
// Design.
//  * A split pass (attn_split_kernel) writes big and small of q, k and v as
//    the images of the ring's stages, already in the swizzled layouts the
//    wgmma descriptors read, so that each stage arrives by a few bulk copies
//    of contiguous blocks (TMA tensor copies of the same tiles, 64- and
//    32-byte box rows, were 1.3x slower: design tensor_maps). v is written
//    transposed: TF32 wgmma takes K-major operands only, and the PV product's
//    K dimension is the key. Channels >= C and tokens >= n are zeros.
//  * One CTA per (image, 64-query tile), three warpgroups. Warpgroup 2, the
//    producer, drops to 24 registers (setmaxnreg.dec); one thread issues the
//    copies into a 3-stage ring of 48 KB stages guarded by full / empty
//    mbarriers. Warpgroups 0 and 1, the consumers, rise to 240 registers.
//  * The ring carries, per step of 128 keys, 16 S stages (big and small of Q
//    and K over 32 channels, 64-byte rows) and 16 V chunks (big and small of
//    V^T for 8 keys, 32-byte rows). Q (256 KB in both parts) cannot stay
//    resident beside the ring, so it streams with K, once a step.
//  * S = Q K^T: consumer w computes S for keys [64 w, 64 w + 64) over all 512
//    channels, a 16-channel sub-chunk at a time (6 wgmma.m64n64k8, the four
//    small products first), and adds each to its 32 registers of S. The two
//    consumers exchange only their row maxima (and, at the end, their row
//    sums), so both run the same online softmax (m and the corrections agree
//    bit for bit). Splitting S by channels instead needs the partial S
//    summed in shared memory after every sub-chunk (design channel_split).
//  * P leaves registers once: each consumer writes big and small of P for
//    its keys as the 128-byte-swizzled K-major A operand of the PV product.
//    Consumer w owns output channels [256 w, 256 w + 256), a 64 x 256 float32
//    accumulator (128 registers a thread): per V chunk and quarter of its
//    channels 3 x wgmma.m64n64k8, both operands from shared memory, into s
//    and t in turns (both dead once P is written), each added to the
//    accumulator while the next runs (two products a V chunk, one waited for
//    before its sum, were 1.1x slower: design pv_halves). Keeping P in
//    registers as the A fragment would need big and small of P for 128 keys
//    beside the accumulator.
//  * Each S product is waited for before its sum (a second S temporary does
//    not fit the registers beside the accumulator), so the other consumer's
//    products fill the tensor cores meanwhile. A stage is released as soon as
//    its products have retired; the copies run up to two stages ahead.
// Shared memory: ring 3 x 48 KB, P 2 x 32 KB, the row maxima, barriers and
// the 1024-byte alignment of the swizzled tiles (attn_hopper_f32_smem_bytes()).
// Other designs (clusters of two CTAs sharing K and V by multicast) and
// probes: glare_tpu_torch/tools/attn_f32_designs.py.
//
// Where trouble hides, and what the code does about it:
//  * wgmma descriptors: the swizzle mode in each descriptor (64 B for the S
//    tiles, 32 B for V^T, 128 B for P) matches the XOR pattern the split pass
//    (or the consumers, for P) wrote; the stride between 8-row groups is 8
//    rows of the tile; the k8 step inside a row is +32 B on the start address.
//  * Ordering: wgmma.fence before every issue that follows register writes;
//    fence.proxy.async after P is written with generic stores and before the
//    barrier that lets the wgmma (async proxy) read it; each product is pinned
//    with empty asm operands after its wait.
//  * P of step j is read by both consumers' PV products: the consumers meet
//    at a named barrier (the one that exchanges step j + 1's row maxima)
//    before either writes P again, and once P is written.
//  * Registers: the key mask of the last step is one select per score, with
//    no branch (a branch there made ptxas spill). setmaxnreg needs the launch
//    with 384 threads and __launch_bounds__(384, 1). Read ptxas -v for spills.
//  * A stuck pipeline (a barrier that never completes) traps after ~2^35
//    cycles of polling instead of hanging the card.
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int C = 512;                  // channels the kernel computes (inputs padded to it)
constexpr int BQ = 64;                  // queries per CTA
constexpr int BK = 128;                 // keys per step; consumer w computes S for keys [64 w, 64 w + 64)
constexpr int SCH = 16;                 // channels of an S sub-chunk (64-byte rows)
constexpr int VK = 8;                   // keys of a V chunk (32-byte rows)
constexpr int NSUB = C / SCH;           // S sub-chunks a step (32), two a stage
constexpr int NS_CHUNK = NSUB / 2;      // S stages a step (16)
constexpr int NV_CHUNK = BK / VK;       // V chunks a step (16)
constexpr int NSTAGE = 3;
constexpr int NT = 384;                 // 3 warpgroups
constexpr float kNegInf = -1e30f;

constexpr int QP = BQ * SCH * 4;        // 4096 B: big or small of a Q sub-chunk
constexpr int KP = BK * SCH * 4;        // 8192 B: big or small of a K sub-chunk
constexpr int SUB = 2 * QP + 2 * KP;    // 24576 B: one S sub-chunk
constexpr int VP = 256 * VK * 4;        // 8192 B: big or small of a consumer's V^T chunk
constexpr int V_HALF = 2 * VP;          // 16384 B
constexpr int S_BYTES = 2 * SUB;        // 49152 B: the bytes an S stage brings
constexpr int V_BYTES = 2 * V_HALF;     // 32768 B: the bytes a V chunk brings
constexpr int STAGE = S_BYTES;          // a ring stage holds either
constexpr int XBUF = BQ * BK * 4;       // 32768 B: one part of P
constexpr int PBLK = BQ * 32 * 4;       // 8192 B: 32 keys of P (128-byte rows)

constexpr int OFF_X = NSTAGE * STAGE;
constexpr int OFF_M = OFF_X + 2 * XBUF;          // the consumers' row maxima / sums
constexpr int OFF_BAR = OFF_M + 2 * BQ * 4;
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

// d[32] (+)= A[64x8] B[8x64], tf32, both from shared memory, K-major: every
// product of the kernel (accumulate 0 starts a new sum).
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}


// ------------------------------------------------------------ split pass --
// Writes big and small of q, k and v as the images of the ring's stages: each
// block below is what one bulk copy brings into shared memory, already in the
// swizzled layout the wgmma descriptors read (the 16-byte chunk c of row r at
// c ^ ((r >> 1) & 3) in 64-byte rows, c ^ ((r >> 2) & 1) in 32-byte rows).
//   q: per (image, 64-query tile, 16-channel sub-chunk) 8 KB: big, small,
//      each [64 rows][16 channels];
//   k: per (image, 128-key step, sub-chunk) 16 KB: big, small, [128][16];
//   v: per (image, step, 8-key group) 32 KB: for each consumer's 256
//      channels big, small, each [256 channels][8 keys] (v transposed).
// Channels >= cin and tokens >= n are zeros. One block per 32 tokens x 32
// channels of one image, 32 x 8 threads; tokens up to nkt * 128.
__global__ void attn_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, float* __restrict__ qi,
                                  float* __restrict__ ki, float* __restrict__ vi, int n, int nqt,
                                  int nkt, int cin) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, r0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = c0 + tx, cc = ch >> 4, k16 = (ch & 15) >> 2, e = ch & 3;
  for (int rr = ty; rr < 32; rr += 8) {
    const int r = r0 + rr;
    const size_t src = ((size_t)b * n + r) * cin + ch;
    const bool in = r < n && ch < cin;
    const float xq = in ? q[src] : 0.f, xk = in ? k[src] : 0.f;
    tile[rr][tx] = in ? v[src] : 0.f;
    const float hq = tf32_rna(xq), hk = tf32_rna(xk);
    if (r < nqt * BQ) {
      const int qr = r & (BQ - 1);
      const size_t blk = (((size_t)b * nqt + r / BQ) * NSUB + cc) * 2;
      const size_t off = (size_t)qr * SCH + ((k16 ^ ((qr >> 1) & 3)) << 2) + e;
      qi[blk * (BQ * SCH) + off] = hq;
      qi[(blk + 1) * (BQ * SCH) + off] = tf32_rna(xq - hq);
    }
    const int kr = r & (BK - 1);
    const size_t blk = (((size_t)b * nkt + r / BK) * NSUB + cc) * 2;
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
          for (int u = 0; u < 2; ++u) {
            const size_t qb = ((size_t)b * nqt + blockIdx.x) * NSUB + 2 * c + u;
            const size_t kb = ((size_t)b * nkt + j) * NSUB + 2 * c + u;
            bulk_load(dst + u * SUB, qi + qb * (2 * QP / 4), 2 * QP, full(s));
            bulk_load(dst + u * SUB + 2 * QP, ki + kb * (2 * KP / 4), 2 * KP, full(s));
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
    float s[32];   // S, then P, of this consumer's 64 keys of the step
    float t[32];   // one short S product (a sub-chunk's 16 channels), then PV products with s
    float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8 of this warp's 16
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums over its keys
    const uint32_t p_big = xbase, p_small = xbase + XBUF;
    float* mx_own = reinterpret_cast<float*>(smem + OFF_M) + w * BQ;
    const float* mx_oth = reinterpret_cast<const float*>(smem + OFF_M) + (1 - w) * BQ;
    const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8

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
      // -------- S_j for keys [64 w, 64 w + 64) over all 512 channels: per
      // 16-channel sub-chunk one product (the four small products first, then
      // the two big ones) summed on the tensor cores from 0, then added to s
      // in float32
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = t[i] = 0.f;
      for (int c = 0; c < NS_CHUNK; ++c) {
        mbar_wait(full(st), par);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t base = sbase + st * STAGE + u * SUB;
          const uint32_t kbase = base + 2 * QP + w * (64 * SCH * 4);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            wgmma_m64n64(t, desc<2>(base + QP + kk * 32, 512), desc<2>(kbase + kk * 32, 512), kk);
            wgmma_m64n64(t, desc<2>(base + kk * 32, 512), desc<2>(kbase + KP + kk * 32, 512), 1);
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_m64n64(t, desc<2>(base + kk * 32, 512), desc<2>(kbase + kk * 32, 512), 1);
          wg_commit();
          wg_wait<0>();
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            pin(t[i]);
            s[i] += t[i];
          }
        }
        release();
      }

      // -------- online softmax: row maxima over both consumers' keys
      // keys >= n_true (in the last step only): no branch, one compare each
      const int lim = n_true - j * BK - 64 * w - col0;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = (i >> 2) * 8 + (i & 1) >= lim ? kNegInf : s[i];
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if ((lane & 3) == 0) {
        mx_own[row0] = mx0;
        mx_own[row0 + 8] = mx1;
      }
      // both consumers' maxima written, and both consumers' PV_{j-1} retired (P free)
      named_bar_sync(1, 256);
      mx0 = fmaxf(m0, fmaxf(mx0, mx_oth[row0]));
      mx1 = fmaxf(m1, fmaxf(mx1, mx_oth[row0 + 8]));
      const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
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

      // -------- big and small of P for this consumer's keys, as the 128-byte-
      // swizzled K-major A operand of the PV product
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        const int col = 64 * w + 8 * (i >> 2) + col0;
        const float a = tf32_rna(s[i]), c2 = tf32_rna(s[i + 1]);
        const int cb = col & 31;
        const int off = (col >> 5) * PBLK + row * 128 + ((((cb >> 2) ^ (row & 7)) << 4) | ((cb & 3) << 2));
        sts2(p_big + off, a, c2);
        sts2(p_small + off, tf32_rna(s[i] - a), tf32_rna(s[i + 1] - c2));
      }
      fence_proxy_async();
      // where the running max moved in none of the warp's rows, every
      // correction is exactly 1: the rescale would change no bit
      if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      }
      named_bar_sync(1, 256);  // P of all 128 keys written

      // -------- acc += P V_j: per 8-key V chunk four products (64 channels
      // each, into s and t in turns: both are dead once P is written), each added
      // to the accumulator in float32 while the next is on the tensor cores
      auto issue_q = [&](float (&d)[32], int stage, int v, int q) {
        const uint32_t vbig = sbase + stage * STAGE + w * V_HALF + q * (64 * VK * 4);
        const uint32_t poff = (v >> 2) * PBLK + (v & 3) * 32;
        wg_fence();
        wgmma_m64n64(d, desc<1>(p_small + poff, 1024), desc<3>(vbig, 256), 0);
        wgmma_m64n64(d, desc<1>(p_big + poff, 1024), desc<3>(vbig + VP, 256), 1);
        wgmma_m64n64(d, desc<1>(p_big + poff, 1024), desc<3>(vbig, 256), 1);
        wg_commit();
      };
      auto add_q = [&](float (&d)[32], auto quarter) {
        constexpr int Q = decltype(quarter)::value;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          pin(d[i]);
          acc[32 * Q + i] += d[i];
        }
      };
      auto pv_chunk = [&](int v, auto last) {
        wg_wait<1>();
        add_q(s, std::integral_constant<int, 0>());
        issue_q(s, st, v, 2);
        wg_wait<1>();
        add_q(t, std::integral_constant<int, 1>());
        issue_q(t, st, v, 3);
        wg_wait<1>();
        add_q(s, std::integral_constant<int, 2>());
        if constexpr (!decltype(last)::value) {
          const int nst = st + 1 == NSTAGE ? 0 : st + 1;
          mbar_wait(full(nst), nst == 0 ? par ^ 1 : par);
          issue_q(s, nst, v + 1, 0);
          wg_wait<1>();
        } else {
          wg_wait<0>();
        }
        add_q(t, std::integral_constant<int, 3>());
        release();
        if constexpr (!decltype(last)::value) issue_q(t, st, v + 1, 1);
      };
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = t[i] = 0.f;
      mbar_wait(full(st), par);
      issue_q(s, st, 0, 0);
      issue_q(t, st, 0, 1);
      for (int v = 0; v < NV_CHUNK - 1; ++v) pv_chunk(v, std::false_type());
      pv_chunk(NV_CHUNK - 1, std::true_type());
    }

    // the row sums over both consumers' keys
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if ((lane & 3) == 0) {  // the last maxima were read before the last PV
      mx_own[row0] = l0;
      mx_own[row0 + 8] = l1;
    }
    named_bar_sync(1, 256);
    l0 = w == 0 ? l0 + mx_oth[row0] : mx_oth[row0] + l0;
    l1 = w == 0 ? l1 + mx_oth[row0 + 8] : mx_oth[row0 + 8] + l1;
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
  const long long per_tile = (long long)NSUB * 2 * QP, per_step = (long long)NSUB * 2 * KP;
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
  float* ki = qi + (size_t)B * nqt * NSUB * 2 * QP / 4;
  float* vi = ki + (size_t)B * nkt * NSUB * 2 * KP / 4;
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
