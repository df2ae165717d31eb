// Fused single-head attention for Hopper (sm_90a), forward only, bf16, head
// dimension C = 512: softmax(q k^T) v for [B, N, 512] inputs whose q already
// carries the 1/sqrt(C) * log2(e) scale.
//
// Replaces the Pallas kernels `_kernel` (glare_tpu/ops/attn_pallas.py:44) and
// `_kernel_pipe` (:96), entry `flash_attention_nhc`, at the width every
// attention block of the model has. Same arithmetic as they and the plain
// version `flash_attention_nhc_ref` (ops/attn.py): scores, running max m,
// running sum l and the output accumulator in float32; exp2 online softmax;
// probabilities cast to bf16 before the PV product; keys in [n_true, n)
// masked to -1e30; output = acc / l cast to bf16. Padded query rows compute
// finite values; rows >= n are never written.
//
// What bounds it on an H100: operations, 4 * B * n_true^2 * C FLOP on the
// bf16 tensor cores (989 TFLOP/s). K and V (2 * n * C values a image) are
// re-read by every 64-query tile, from L2.
//
// Design. One CTA per (image, 64-query tile), three warpgroups:
//  * warpgroup 2, the producer, drops to 40 registers (setmaxnreg.dec); one
//    thread issues TMA loads: Q once (64 x 512), then K_j and V_j (32 keys x
//    512 each) into a two-stage ring guarded by full/empty mbarriers. Every
//    tile is loaded as 8 boxes of 64 channels (128 bytes, the widest box the
//    128-byte swizzle takes) through a 3-D tensor map [B, n, 512], so rows
//    >= n of an image are zero-filled by the hardware, not read from the
//    next image.
//  * warpgroups 0 and 1, the consumers, rise to 232 registers
//    (setmaxnreg.inc). Consumer c owns output channels [256c, 256c + 256):
//    its 64 x 256 f32 accumulator is 128 registers a thread.
//  * S = Q K^T: each consumer computes the partial product over its own 256
//    channels (16 x wgmma.m64n32k16, A = Q and B = K_j from shared memory,
//    both K-major, 128-byte swizzle), writes it to an exchange buffer, meets
//    the other consumer at a named barrier (bar.sync 1, 256) and adds the
//    other's partial. Float addition commutes exactly, so both hold the
//    same S and run the same online-softmax update: m, l and the correction
//    agree bit for bit. The exchange buffer is double-buffered by key step,
//    so one barrier a step suffices.
//  * PV: P stays in registers. The m64n32 f32 accumulator fragment of S,
//    packed in pairs to bf16, is the register-A fragment of a 16-bit wgmma;
//    acc += P V_j is 2 x wgmma.m64n256k16 with V_j's tile as B, MN-major
//    (transpose bit set).
//  * Schedule (the intra-warpgroup overlap of FlashAttention-3): step j
//    issues S_j and then PV_{j-1}; waits for S_j only (wait_group 1),
//    exchanges and runs the softmax of S_j while PV_{j-1} is on the tensor
//    cores; then waits for PV_{j-1}, releases V_{j-1} and rescales the
//    accumulator by step j's correction before PV_j is issued. A warp skips
//    the rescale when the running max moved in none of its rows (every
//    correction is then exactly 1), which after the first few hundred keys
//    is most steps. Other schedules measured against this one:
//    tools/attn_designs.py.
// Shared memory: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) + exchange
// 2 x 2 x 64 x 32 x 4 B = 16 KB a buffer, 224 KB with barriers and the
// 1024-byte alignment of the swizzled tiles (attn_hopper_smem_bytes()).
//
// How this answers the limits of the earlier kernel (csrc/attn_fused.cu, wmma):
//  * mma.sync cannot reach Hopper's tensor-core rate: every product here is
//    an asynchronous wgmma fed from shared memory (and registers for P).
//  * phases ran in strict sequence between __syncthreads: here the loads
//    run in their own warpgroup, ahead by one stage, and the softmax of step
//    j overlaps the PV product of step j-1.
//  * scores round-tripped through shared memory and the correction was
//    broadcast through it: here S reaches shared memory only once, for the
//    exchange of the two halves (16 floats a thread, conflict-free), the
//    correction is applied in registers, and P never leaves registers.
//  * Q was re-read from shared memory by every warp at every step: here
//    wgmma reads the Q tile through its descriptor; nothing is reloaded into
//    registers.
//
// Where trouble hides, and what the code does about it:
//  * TMA descriptors: cuTensorMapEncodeTiled lives in libcuda, which the
//    build does not link; the runtime hands out its address
//    (cudaGetDriverEntryPoint[ByVersion]). The maps go to the kernel as
//    __grid_constant__ parameters.
//  * Ragged edges: TMA zero-fills rows >= n; keys in [n_true, n) are masked
//    to -1e30 in the last key tile; the epilogue stores rows < n only.
//  * wgmma descriptors: the layout type in the descriptor (128-byte swizzle)
//    matches the tensor maps' swizzle. K-major tiles (Q, K): stride between
//    8-row groups 1024 B, the 16-channel step inside a 128-byte row is +32 B
//    on the start address. MN-major V: 64-channel blocks 4096 B apart
//    (leading offset), 8-key groups 1024 B apart (stride offset).
//  * Ordering: wgmma.fence before every issue that follows register writes;
//    commit/wait groups as above; the accumulator, S and P registers are
//    pinned with empty asm operands after each wait so that the compiler
//    neither reads them early nor reuses them while a wgmma is in flight.
//    A ring stage is released (one arrive per consumer warp, 8 a stage)
//    only after the wgmma that read it has retired.
//  * Registers: setmaxnreg needs the launch with 384 threads and
//    __launch_bounds__(384, 1) (168 registers a thread at entry:
//    128 x 40 + 256 x 232 = 64 512). Read ptxas -v for spills.
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 512;
constexpr int BQ = 64;                 // queries per CTA
constexpr int BK = 32;                 // keys per step
constexpr int NSTAGE = 2;
constexpr int CH = 64;                 // channels per TMA box (128 bytes, the swizzle span)
constexpr int NCHUNK = C / CH;         // 8
constexpr int NT = 384;                // 3 warpgroups
constexpr float kNegInf = -1e30f;

constexpr int Q_CHUNK = BQ * CH * 2;   // 8192 B
constexpr int KV_CHUNK = BK * CH * 2;  // 4096 B
constexpr int Q_BYTES = Q_CHUNK * NCHUNK;    // 65536
constexpr int KV_BYTES = KV_CHUNK * NCHUNK;  // 32768
constexpr int XCH_FLOATS = 16 * 128;         // one consumer's partial S (16 a thread)

constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + NSTAGE * KV_BYTES;
constexpr int OFF_XCH = OFF_V + NSTAGE * KV_BYTES;
constexpr int OFF_BAR = OFF_XCH + 2 * 2 * XCH_FLOATS * 4;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;  // barriers + alignment slack

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d[16] (+)= A[64x16] B[16x32]^T, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[128] += A[64x16] (registers, bf16 pairs) B[16x256] (shared memory, MN-major).
__device__ __forceinline__ void wgmma_m64n256_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------- kernel --
__global__ void __launch_bounds__(NT, 1)
attn_hopper_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int n, int n_true) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + OFF_K, sV = sQ + OFF_V;
  float* xch = reinterpret_cast<float*>(smem + OFF_XCH);
  const uint32_t bar = sQ + OFF_BAR;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 + 8 * s; };
  auto v_full = [&](int s) { return bar + 24 + 8 * s; };
  auto k_empty = [&](int s) { return bar + 40 + 8 * s; };
  auto v_empty = [&](int s) { return bar + 56 + 8 * s; };

  const int tid = threadIdx.x;
  const int wg = tid >> 7, ltid = tid & 127;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const int n_kt = (n_true + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);  // one arrive per consumer warp
      mbar_init(v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (ltid == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < NCHUNK; ++c) tma_load(sQ + c * Q_CHUNK, &tq, q_full, c * CH, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j & 1;
        const uint32_t par = ((j >> 1) & 1) ^ 1;  // the first pass through the ring does not wait
        mbar_wait(k_empty(s), par);
        mbar_expect_tx(k_full(s), KV_BYTES);
        for (int c = 0; c < NCHUNK; ++c)
          tma_load(sK + s * KV_BYTES + c * KV_CHUNK, &tk, k_full(s), c * CH, j * BK, b);
        mbar_wait(v_empty(s), par);
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int c = 0; c < NCHUNK; ++c)
          tma_load(sV + s * KV_BYTES + c * KV_CHUNK, &tv, v_full(s), c * CH, j * BK, b);
      }
    }
  } else {
    // ---------------- consumers: channels [256 wg, 256 wg + 256) ----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg;
    const int warp = ltid >> 5, lane = ltid & 31;
    const int col0 = (lane & 3) * 2;  // fragment column of s[0] within each 8-column block

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    uint32_t p[2][4];
    float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8 of this warp's 16
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

    auto issue_s = [&](int j) {
      const uint32_t kb = sK + (j & 1) * KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const int chunk = cw * 4 + (kk >> 2);  // 64-channel box of this 16-channel step
        const uint32_t off = (kk & 3) * 32;    // its place inside the 128-byte row
        wgmma_m64n32(s, desc_sw128(sQ + chunk * Q_CHUNK + off, 16, 1024),
                     desc_sw128(kb + chunk * KV_CHUNK + off, 16, 1024), kk > 0);
      }
      wg_commit();
    };
    auto issue_pv = [&](int j) {
      const uint32_t vb = sV + (j & 1) * KV_BYTES + cw * 4 * KV_CHUNK;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_m64n256_rs(acc, p[kk], desc_sw128(vb + kk * 2048, KV_CHUNK, 1024));
      wg_commit();
    };
    auto release = [&](uint32_t b_) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_);
    };
    // S of step j (in s) -> the other half added, masked, softmax; s becomes P
    // (float), m and l advance; returns the corrections of the two rows.
    auto softmax = [&](int j, float& corr0, float& corr1) {
      float* mine = xch + ((j & 1) * 2 + cw) * XCH_FLOATS;
      const float* theirs = xch + ((j & 1) * 2 + (cw ^ 1)) * XCH_FLOATS;
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[i * 128 + ltid] = s[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += theirs[i * 128 + ltid];
      const int key0 = j * BK;
      if (key0 + BK > n_true) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (key0 + (i >> 2) * 8 + col0 + (i & 1) >= n_true) s[i] = kNegInf;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      corr0 = exp2f(m0 - mx0);
      corr1 = exp2f(m1 - mx1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
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
    };
    // P (float, in s) -> bf16 register-A fragments of the two k16 blocks
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wg_fence();
    issue_s(0);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(s[i]);
    release(k_empty(0));
    float corr0, corr1;
    softmax(0, corr0, corr1);
    pack_p();

    for (int j = 1; j < n_kt; ++j) {
      mbar_wait(k_full(j & 1), (j >> 1) & 1);
      mbar_wait(v_full((j - 1) & 1), ((j - 1) >> 1) & 1);
      wg_fence();
      issue_s(j);
      issue_pv(j - 1);
      wg_wait<1>();  // S_j has retired; PV_{j-1} may still run
#pragma unroll
      for (int i = 0; i < 16; ++i) pin(s[i]);
      release(k_empty(j & 1));
      softmax(j, corr0, corr1);
      wg_wait<0>();  // PV_{j-1} has retired
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(acc[i]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pin(p[kk][r]);
      release(v_empty((j - 1) & 1));
      // where the running max moved in none of the warp's rows, every
      // correction is exactly 1: the rescale would change no bit
      if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      }
      pack_p();
    }
    const int jl = n_kt - 1;
    mbar_wait(v_full(jl & 1), (jl >> 1) & 1);
    wg_fence();
    issue_pv(jl);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) pin(acc[i]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    bf16* o0 = out + ((size_t)b * n + r0) * C + cw * 256 + col0;
    bf16* o1 = o0 + (size_t)8 * C;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(o0 + 8 * i) = pack_bf16(acc[4 * i] / l0, acc[4 * i + 1] / l0);
      if (r1 < n)
        *reinterpret_cast<uint32_t*>(o1 + 8 * i) = pack_bf16(acc[4 * i + 2] / l1, acc[4 * i + 3] / l1);
    }
  }
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

// [B, n, 512] bf16 -> a 3-D map whose box is 64 channels x `rows` rows of one image
bool make_map(CUtensorMap* map, const void* ptr, int B, int n, int rows) {
  EncodeTiledFn enc = encode_fn();
  if (enc == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)n, (cuuint64_t)B};
  cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)n * C * 2};
  cuuint32_t box[3] = {(cuuint32_t)CH, (cuuint32_t)rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Dynamic shared memory the kernel asks for, in bytes.
extern "C" int attn_hopper_smem_bytes() { return SMEM_BYTES; }

// q, k, v, out: [B, n, 512] contiguous bf16, 16-byte aligned; q pre-scaled.
extern "C" int attn_hopper_bf16(const void* q, const void* k, const void* v, void* out, int B, int n,
                                int n_true, int c, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (c != C || n_true < 1 || n_true > n) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, n, BQ) || !make_map(&tk, k, B, n, BK) || !make_map(&tv, v, B, n, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_hopper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + BQ - 1) / BQ, B);
  attn_hopper_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), n, n_true);
  return (int)cudaGetLastError();
}
