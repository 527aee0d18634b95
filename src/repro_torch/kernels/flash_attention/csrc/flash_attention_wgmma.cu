// Flash attention forward for Hopper (sm_90a) on the tensor cores, bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bkg, body _flash_kernel) for bf16 inputs at the head
// dims instantiated at the bottom (16, 32, 64, 80, 128, 256); f32 and other
// head dims take the CUDA-core kernel in flash_attention.cu (the rule is
// ops.py::variant).  It computes
// the same function: q (BK, Sq, G, hd), k and v (BK, Skv, hd), output
// (BK, Sq, G, hd) bf16; s = scale * q k^T, optionally
// softcap * tanh(s / softcap); a causal mask aligned top-left
// (col <= row / G) with an optional window (col > row / G - window); masked
// scores -1e30, columns past Skv weigh exactly 0; online softmax with f32
// m, l and acc; l clamped at 1e-30.  Both products run on the tensor cores
// with f32 accumulation: q k^T is exact products of bf16 values summed in
// f32, and the probabilities P are rounded to bf16 before P v (the Pallas
// body keeps P in f32; the model's plain path casts P to v's dtype).  The
// plain version of these numerics is ../ref.py::flash_attention_wgmma_ref.
//
// What bounds it on the H100.  At prefill lengths attention is bound by
// operations: gemma3-1b's global layer (BK=4, S=1024, G=4, hd=256) needs
// about 8.6 GFLOP for its causal pairs against about 21 MB of q/k/v/o, so
// the bf16 tensor-core rate (989 TFLOP/s) sets the bound.
//
// Design.
//   * One block per (BK row, tile of BM = 128 q rows): two warpgroups of 64
//     rows each and no producer warpgroup, 256 threads, so each thread may
//     hold 255 registers: the hd = 256 instance keeps 128 of O, 32 of S and
//     16 of P.  With a third, producer warpgroup and setmaxnreg (24 / 240)
//     ptxas still held that instance to 168 registers, spilled and
//     serialised its wgmma.  The GQA group is folded into the rows
//     (row = position * G + group), so each K/V tile in shared memory serves
//     all G query heads of its KV head.
//   * Loads are TMA copies: the block's Q tile once, then K/V tiles of
//     BN = 64 positions into a ring of STAGES buffers, each guarded by an
//     mbarrier (bytes arrived) and a counter of the warps done with it.
//     Thread 0 starts Q and the first STAGES tiles; after that the last warp
//     to finish a tile loads the tile STAGES further on into its buffer, so
//     no warpgroup waits for the other and a whole tile's products cover
//     each load.  q is described as the 3-D tensor (BK, Sq*G, hd) and k, v as
//     (BK, Skv, hd), so a box past the end of one BK row reads zeros, not
//     the next row.  Q and K are K-major boxes of 64 columns in the 128-byte
//     swizzle (a head dim that is not a multiple of 64 is zero-filled to
//     one); V is read N-major by the second product, so it is kept in atoms
//     that its width fills exactly: 64 columns in the 128-byte swizzle, or
//     16 columns in the 32-byte swizzle where hd % 64 != 0.
//   * S = Q K^T: wgmma m64n64k16, both operands from shared memory, f32
//     accumulators in registers (32 per thread).
//   * The online softmax works on the accumulator fragment, in log2 units
//     (ex2.approx): scale, then softcap, then the mask, which is computed
//     only on tiles that cross the diagonal, the window edge or Skv; the
//     branches on softcap and mask are taken once per tile, outside the
//     element loops.  Row max and sum over a quad's four threads by shuffles.
//   * O += P V: P converted to bf16 in registers is wgmma's register A
//     operand (its fragment is the accumulator's), V from shared memory with
//     the transpose bit (N-major B); O (hd / 2 f32 registers per thread)
//     stays in registers and is rescaled by exp2(m_old - m_new) per tile.
//   * KV tiles outside a block's causal/window range are never loaded (the
//     Pallas pl.when skip, as loop bounds); a warpgroup skips the products
//     of a tile that is fully masked for all its rows.
//   * Blocks are ordered longest first: block i takes row tile
//     T - 1 - i / BK of BK row i % BK, so the long causal tiles start first
//     and the short ones fill the tail.
//   * Rows past Sq * G load zeros and are never stored.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPGROUPS = 2;             // per block
constexpr int WG_ROWS = 64;               // q rows per warpgroup
constexpr int BM = WARPGROUPS * WG_ROWS;  // q rows per block
constexpr int BN = 64;                    // kv positions per tile
constexpr int STAGES = 2;                 // K/V ring depth
constexpr int THREADS = WARPGROUPS * 128;
constexpr int QK_ATOM = 64;               // bf16 columns of a Q/K box
constexpr int QK_BOX = 64 * QK_ATOM * 2;  // bytes of a 64-row Q/K box
constexpr float NEG_INF = -1e30f;         // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory plan of one instantiation (byte offsets from a 1024-aligned
// base; every box starts on a multiple of its swizzle's 1024-byte period).
template <int HD>
struct Plan {
  static constexpr int QK_ATOMS = (HD + QK_ATOM - 1) / QK_ATOM;
  static constexpr int V_ATOM = HD % 64 == 0 ? 64 : 16;   // V box columns
  static constexpr int V_ATOMS = HD / V_ATOM;
  static constexpr int V_ROW = V_ATOM * 2;                 // bytes per V row
  static constexpr int V_BOX = BN * V_ROW;
  static constexpr int Q_BYTES = WARPGROUPS * QK_ATOMS * QK_BOX;
  static constexpr int K_STAGE = QK_ATOMS * QK_BOX;
  static constexpr int V_STAGE = V_ATOMS * V_BOX;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_STAGE;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);
  static_assert(HD % 16 == 0 && HD <= 256, "head dim");
  static_assert(SMEM <= 232448, "shared memory");
};

// ---- PTX wrappers -----------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

// Returns the old value of the 32-bit shared-memory counter at addr.
__device__ __forceinline__ uint32_t smem_add(uint32_t addr, uint32_t x) {
  uint32_t old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;"
               : "=r"(old) : "r"(addr), "r"(x) : "memory");
  return old;
}

// Waits for the phase of the given parity to complete.  A wait of more than
// about 2^33 cycles (seconds) can only be a lost phase: it traps, so that
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout 1 = 128-byte swizzle, 3 = 32-byte.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accesses of an accumulator across wgmma.
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d[0:32] (+)= A B: m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] += A B: m64n64k16, A (4 registers of bf16 pairs) from registers,
// B N-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:8] += A B: m64n16k16, as wgmma_rs_n64.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x, flushing results below 2^-126 to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the kernel -------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int BK, int Sq, int Skv,
                   int G, float scale, float softcap, int window, int causal) {
  using P = Plan<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + P::K_OFF, sV = base + P::V_OFF;
  const uint32_t bars = base + P::BAR_OFF;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  // done(s) counts, over the kernel, the warps that are done with stage s.
  auto done_ctr = [&](int s) { return bars + 8u * (STAGES + s); };
  const uint32_t q_bar = bars + 8u * (2 * STAGES);

  const int rows_total = Sq * G;
  const int row_tiles = (rows_total + BM - 1) / BM;
  const int tile = row_tiles - 1 - blockIdx.x / BK;   // longest first
  const int bk = blockIdx.x % BK;
  const int r0 = tile * BM;
  const int r_last = min(r0 + BM, rows_total) - 1;

  // The KV positions any row of this block may attend to, in whole tiles.
  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, r_last / G + 1);
    if (window > 0) kv_begin = max(0, r0 / G - window + 1);
  }
  const int t_first = kv_begin / BN;
  const int n_tiles = (kv_end + BN - 1) / BN - t_first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      asm volatile("st.shared.u32 [%0], 0;" ::"r"(done_ctr(s)) : "memory");
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp_id = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  // Load tile `it` into its stage, whose previous tile every warp is done
  // with.
  auto load_tile = [&](int it) {
    const int s = it % STAGES;
    const int kv0 = (t_first + it) * BN;
    mbar_expect_tx(full_bar(s), P::K_STAGE + P::V_STAGE);
    for (int a = 0; a < P::QK_ATOMS; ++a)
      tma_load(sK + s * P::K_STAGE + a * QK_BOX, &tk, full_bar(s),
               a * QK_ATOM, kv0, bk);
    for (int a = 0; a < P::V_ATOMS; ++a)
      tma_load(sV + s * P::V_STAGE + a * P::V_BOX, &tv, full_bar(s),
               a * P::V_ATOM, kv0, bk);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, P::Q_BYTES);
    for (int w = 0; w < WARPGROUPS; ++w)
      for (int a = 0; a < P::QK_ATOMS; ++a)
        tma_load(sQ + (w * P::QK_ATOMS + a) * QK_BOX, &tq, q_bar,
                 a * QK_ATOM, r0 + w * WG_ROWS, bk);
    for (int it = 0; it < min(STAGES, n_tiles); ++it) load_tile(it);
  }

  const int wg = warp_id / 4;
  const int warp = warp_id & 3;
  const int g = lane >> 2, c = lane & 3;
  const int wr0 = r0 + wg * WG_ROWS;            // first row of this warpgroup
  const bool has_rows = wr0 < rows_total;
  const int pmin = wr0 / G;
  const int pmax = min(wr0 + WG_ROWS - 1, rows_total - 1) / G;
  const int row0 = wr0 + warp * 16 + g;         // rows row0 and row0 + 8
  const int pos[2] = {row0 / G, (row0 + 8) / G};
  const float scale_log2 = scale * LOG2E;
  // softcap * tanh(scale * s / softcap), in log2 units
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_log2 = softcap * LOG2E;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_base = sQ + wg * P::QK_ATOMS * QK_BOX;

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int kv0 = (t_first + it) * BN;
    mbar_wait(full_bar(s), (it / STAGES) & 1);
    const bool skip =
        !has_rows ||
        (causal && (kv0 > pmax || (window > 0 && kv0 + BN - 1 <= pmin - window)));
    if (!skip) {
      // ---- S = Q K^T ----
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(sc[i]);
      wgmma_fence();
      const uint32_t k_base = sK + s * P::K_STAGE;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks / 4) * QK_BOX + (ks % 4) * 32;
        wgmma_ss_n64(sc, desc(q_base + off, 16, 1024, 1),
                     desc(k_base + off, 16, 1024, 1), ks > 0);
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(sc[i]);

      // ---- online softmax on the fragment: sc[4j + 2i + e] is row
      // row0 + 8i, column kv0 + 8j + 2c + e ----
      const bool need_mask =
          kv0 + BN > Skv ||
          (causal && (kv0 + BN - 1 > pmin ||
                      (window > 0 && kv0 <= pmax - window)));
      // Scores in log2 units; branches that are the same for the whole
      // warpgroup stay outside the element loops.
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = cap_log2 * tanhf(sc[i] * cap_in);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
      }
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = kv0 + 8 * (i / 4) + 2 * c + (i & 1);
          const int p = pos[(i >> 1) & 1];
          const bool out =
              causal && (col > p || (window > 0 && col <= p - window));
          sc[i] = col >= Skv ? -INFINITY : (out ? NEG_INF : sc[i]);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        alpha[i] = ex2(m[i] - mx[i]);
        m[i] = mx[i];
      }
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[4 * j + e] - m[e >> 1]);
          sc[4 * j + e] = p;
          rsum[e >> 1] += p;
        }
      }
      // l is this thread's partial row sum: alpha is the same across the
      // quad, so the quad's sum is taken once, at the end.
      l[0] = l[0] * alpha[0] + rsum[0];
      l[1] = l[1] * alpha[1] + rsum[1];
#pragma unroll
      for (int J = 0; J < HD / 8; ++J) {
        acc[4 * J + 0] *= alpha[0];
        acc[4 * J + 1] *= alpha[0];
        acc[4 * J + 2] *= alpha[1];
        acc[4 * J + 3] *= alpha[1];
      }

      // ---- O += P V: P's fragment for kv columns 16kk..16kk+15 ----
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) reg_fence(pa[kk][r]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) reg_fence(acc[i]);
      wgmma_fence();
      const uint32_t v_base = sV + s * P::V_STAGE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int a = 0; a < P::V_ATOMS; ++a) {
          const uint32_t addr = v_base + a * P::V_BOX + kk * 16 * P::V_ROW;
          if constexpr (P::V_ATOM == 64)
            wgmma_rs_n64(acc + 32 * a, pa[kk],
                         desc(addr, P::V_BOX, 8 * P::V_ROW, 1));
          else
            wgmma_rs_n16(acc + 8 * a, pa[kk],
                         desc(addr, P::V_BOX, 8 * P::V_ROW, 3));
        }
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) reg_fence(acc[i]);
    }
    // This warp is done with stage s; the last warp done with it loads
    // tile it + STAGES there.
    __syncwarp();
    if (lane == 0 && smem_add(done_ctr(s), 1) ==
                         (it / STAGES + 1) * (WARPGROUPS * 4) - 1 &&
        it + STAGES < n_tiles)
      load_tile(it + STAGES);
    __syncwarp();
  }

  // ---- normalise and store: acc[4J + 2i + e] is row row0 + 8i, column
  // 8J + 2c + e ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
  }
  const size_t row_base = (size_t)bk * rows_total;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < rows_total) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* out = o + (row_base + row) * HD + 2 * c;
#pragma unroll
      for (int J = 0; J < HD / 8; ++J)
        *reinterpret_cast<uint32_t*>(out + 8 * J) =
            pack_bf16(acc[4 * J + 2 * i] * inv, acc[4 * J + 2 * i + 1] * inv);
    }
  }
}

// ---- host side ----------------------------------------------------------------
// cuTensorMapEncodeTiled lives in libcuda.so.1, which the CUDA runtime has
// already loaded into the process; it is looked up there with dlsym, so
// nothing links against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor (batch, rows, hd), contiguous, read in boxes of
// (1, 64 rows, box_cols) with the given swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int rows,
                int hd, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BK, int Sq, int Skv, int G, float scale, float softcap,
                   int window, int causal, cudaStream_t stream) {
  using P = Plan<HD>;
  // The shared-memory limit is raised once per instantiation and device.
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::SMEM);
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }
  if (!encode_tiled()) return cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle v_swizzle =
      P::V_ATOM == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!tensor_map(&tq, q, BK, Sq * G, HD, QK_ATOM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tk, k, BK, Skv, HD, QK_ATOM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tv, v, BK, Skv, HD, P::V_ATOM, v_swizzle))
    return cudaErrorInvalidValue;
  const int row_tiles = (Sq * G + BM - 1) / BM;
  flash_wgmma_kernel<HD><<<row_tiles * BK, THREADS, P::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), BK, Sq, Skv, G, scale,
      softcap, window, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q, k, v, o are device pointers
// of contiguous, 16-byte aligned bf16 tensors; stream is a cudaStream_t.
// hd must be one of 16, 32, 64, 80, 128, 256.  Returns a cudaError_t.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int BK,
                                         int Sq, int Skv, int G, int hd,
                                         float scale, float softcap,
                                         int window, int causal,
                                         void* stream) {
  if (BK <= 0 || Sq <= 0 || Skv <= 0 || G <= 0 ||
      (long long)Sq * G > (1ll << 30) ||
      ((long long)Sq * G + BM - 1) / BM * BK > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_WGMMA_CASE(D)                                                   \
  case D:                                                                     \
    return (int)launch<D>(q, k, v, o, BK, Sq, Skv, G, scale, softcap, window, \
                          causal, st);
  switch (hd) {
    FLASH_WGMMA_CASE(16)
    FLASH_WGMMA_CASE(32)
    FLASH_WGMMA_CASE(64)
    FLASH_WGMMA_CASE(80)
    FLASH_WGMMA_CASE(128)
    FLASH_WGMMA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_WGMMA_CASE
}
