// RWKV-6 wkv recurrence for Hopper (sm_90a), f32, in the chunked form on the
// tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_chunk/kernel.py
// (wkv6_chunked, body _wkv_kernel), and computes what csrc/wkv6.cu (the
// earlier, sequential design) computes, per (batch, head) row bh of r, k, v,
// logw (BH, S, hd) and u (BH, hd):
//   y_t = r_t^T (S_{t-1} + diag(u * k_t) v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,    S_{-1} = 0,
// and writes the state after the last step (BH, hd, hd), [i][j] = key dim i,
// value dim j.  Any S; hd in {16, 32, 64}.  Its numerics' plain version is
// ref.py::wkv6_chunk_ref.
//
// What bounds it on the H100.  Bytes: r, k, v, logw read and y written once,
// 5 * BH * S * hd * 4 bytes, about 336 MB at rwkv6-7b's prefill (BH = 256,
// S = 1024, hd = 64): 0.10 ms at 3.35 TB/s.  The chunked form needs about
// 2 hd^2 + 2 c hd multiply-adds per token and head on the tensor cores (3x
// that in split precision, below), 16 GFLOP there, about 0.03 ms at the
// TF32 rate of wgmma (mma.sync issues at a fraction of it); its CUDA-core
// work (c/4 exps per token and key channel for the in-chunk decays) is
// smaller still.  So the function is bytes-bound, and the earlier
// sequential kernel (csrc/wkv6.cu, issue- and latency-bound at 21% of the
// bound) is what this design replaces.
//
// Form (the reference's chunked one, kernel.py:21-67).  Per chunk of C = 16
// tokens, lp = in-chunk cumulative sum of logw, lpp_t = lp_{t-1} (0 at t=0):
//   A[t,s] = sum_i r[t,i] k[s,i] exp(lpp[t,i] - lp[s,i]),  s < t
//   y      = (r * exp(lpp)) S_in + A v + (r . (u * k)) v             (tensor cores)
//   S_out  = diag(exp(lp_end)) S_in + (k * exp(lp_end - lp))^T v     (tensor cores)
// A is the reference's tile-factored form at a tile of H = 8: inside the two
// diagonal 8 x 8 sub-tiles it is summed pairwise on the CUDA cores; the
// block below them (t >= 8 > s) is r2 k2^T on the tensor cores, with r2 =
// r exp(lpp - lp[7]) and k2 = k exp(lp[7] - lp).  Every exponent is <= 0
// for any logw <= 0, so every operand is at most its input and no factor
// overflows (a small one underflows to 0 where its true term is below f32's
// range anyway).  A chunk of 16 is one row tile of mma.sync; the tensor work
// per token, 2 hd^2 + 2 c hd, grows with the chunk.
//
// Precision.  mma.sync.m16n8k8 TF32 keeps 10 mantissa bits.  Rounding each
// operand once misses the reference's atol = rtol = 1e-3 (on the CPU, with
// cvt.rna's rounding emulated bit for bit: tests/test_torch_rwkv.py::
// test_chunk_plan_plain_tf32_misses_tolerance).  So every product runs in
// 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and lo.hi +
// hi.lo + hi.hi summed in f32, which holds 1e-3 over the reference's sweep
// and the edges (test_chunk_plan_holds_tolerance).  The rounding is
// done with integer operations: cvt.rna.tf32.f32 issues at a fraction of
// the ALU rate, and the split by cvt.rna was slower on the card.  The
// tensor cores' f32 sums do not round to nearest, so nothing long-lived
// accumulates in them: each k step of y and each chunk's kout^T v go to
// fresh accumulators and are added in f32.  With the state summed inside
// the mma across the chunks, the card missed 1e-3 against the f64 plain
// version at logw = -1e-4, (4, 1024, 64); y's rd S_in summed inside the
// mma was a little faster but came too near 1e-3 there to keep.
//
// Design.  One CTA per bh, hd/8 warps (256 threads at hd 64, about 102 KB
// of shared memory, two CTAs an SM, so the 256 CTAs of the prefill shape
// are one wave on 132 SMs).
//   * Loads: a ring of NSTAGE chunks of r, k, logw, v in shared memory, fed
//     by 16-byte cp.async (zero-filled past S: a zero logw decays by 1 and a
//     zero k adds nothing, so padded steps leave the state alone; their y
//     rows are not written).
//   * (1) Four threads a key channel, one per four rows, with lanes on
//     neighbouring channels (no bank conflicts): the cumulative sum (each
//     quarter's sum through shared memory), then r * exp(lpp),
//     k * exp(lp_end - lp), r2, k2, exp(lp_end) and the u-bonus partial sums.
//   * (2)+(3) The warps split in two.  The first hd/16 "y warps" own 16
//     value columns each: the first of them computes A's r2 k2^T block,
//     each computes rd S_in on its columns, waits on a named barrier for A,
//     adds A v and the u-bonus and stores y.  The other hd/16 "state warps"
//     compute A's diagonal sub-tiles pairwise, arrive on that barrier, then
//     update the state's columns they own, which live in their registers,
//     in f32, for the whole chunk loop (written to memory once, at
//     the end) and go to a double-buffered, bank-swizzled copy in shared
//     memory from which the y warps read S_in.  So the MUFU-heavy pairwise
//     sums overlap the y warps' products, and each shared operand (rd, k
//     decayed to the chunk's end) is read by hd/16 warps, not hd/8.
//   * What sets its time: neither the bytes nor the tensor cores (copies
//     of the kernel with the products, or all but the loads, taken out were
//     timed on the card, and clock64 spans taken per phase): the phases'
//     latencies, serialised by barriers, with 16 warps an SM.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int C = 16;        // tokens per chunk
constexpr int H = 8;         // rows of a diagonal sub-tile of A
constexpr int NSTAGE = 3;    // chunks in the cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Plan {
  static constexpr int NW = HD / 8;            // warps
  static constexpr int THREADS = NW * 32;      // four per key channel
  static constexpr int NY = NW / 2;            // y warps, then as many state
  static constexpr int NPART = (HD + 31) / 32; // u-bonus partial sums a row
  static constexpr int LDR = HD + 4;           // rows read as mma A [t][i]
  static constexpr int LDV = HD + 8;           // rows read as [k][n]
  static constexpr int LDA = C + 4;
  // one stage: r, k, logw [C][LDR], v [C][LDV]
  static constexpr int STAGE = C * (3 * LDR + LDV);
  // then: rd [C][LDR]; kout [C][LDV]; r2, k2 [H][LDR]; A [C][LDA]; quarter
  // sums of logw [4][HD]; u-bonus partials [NPART][C]; tot [HD]; the state,
  // twice [2][HD][HD]
  static constexpr int FLOATS = NSTAGE * STAGE + C * LDR + C * LDV +
                                2 * H * LDR + C * LDA + 4 * HD + NPART * C +
                                HD + 2 * HD * HD;
  static constexpr size_t SMEM = (size_t)FLOATS * 4;
  static constexpr int MIN_BLOCKS = HD == 64 ? 2 : 4;
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// x = hi + lo, each rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest,
// ties away from zero; bit-exact for finite x), in integer operations: the
// conversion instruction issues at a fraction of the ALU rate.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float exp2_approx(float x) {   // x <= 0 here
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment (b0, b1) of an m16n8k8 product, split into hi and lo.
struct BFrag {
  uint32_t hi[2], lo[2];
  BFrag() = default;
  __device__ __forceinline__ BFrag(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

// c += a b in 3xTF32, a given split (the m16n8k8 A fragment a0..a3)
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const BFrag& b) {
  mma(c, al, b.hi);
  mma(c, ah, b.lo);
  mma(c, ah, b.hi);
}

// ... or given in f32
__device__ __forceinline__ void mma3(float* c, const float* a, const BFrag& b) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
  mma3(c, ah, al, b);
}

// The state as the y warps read it: row i of [HD][HD], its columns XORed
// with a multiple of 8 set by i % 4, so that a B fragment's 32 reads (rows
// 8k + q, columns 8n + g) hit 32 banks.
template <int HD>
__device__ __forceinline__ int sidx(int i, int j) {
  return i * HD + (j ^ (((i & 3) << 3) & (HD - 1)));
}

template <int HD>
__global__ void __launch_bounds__(Plan<HD>::THREADS, Plan<HD>::MIN_BLOCKS)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ s_out, int S) {
  using P = Plan<HD>;
  constexpr int LDR = P::LDR, LDV = P::LDV, LDA = P::LDA, NY = P::NY;
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;
  float* const srd = ring + NSTAGE * P::STAGE;
  float* const sko = srd + C * LDR;
  float* const sr2 = sko + C * LDV;
  float* const sk2 = sr2 + H * LDR;
  float* const sA = sk2 + H * LDR;
  float* const sqt = sA + C * LDA;
  float* const sbp = sqt + 4 * HD;
  float* const stot = sbp + P::NPART * C;
  float* const sS = stot + HD;               // [2][HD][HD], swizzled

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;      // mma fragment row / column
  // phase (1): key channel ic, rows 4 p .. 4 p + 3
  const int ic = tid % HD, p = tid / HD;
  const float uc = __ldg(u + (size_t)blockIdx.x * HD + ic);
  // phase (3): y warps c < NY and state warps c >= NY, each owning value
  // columns [16 (c % NY), 16 (c % NY) + 16)
  const bool ywarp = warp < NY;
  const int j0 = 16 * (warp % NY);
  const size_t row = (size_t)blockIdx.x * S * HD;
  const int nchunks = (S + C - 1) / C;

  auto stage = [&](int n) { return ring + (n % NSTAGE) * P::STAGE; };
  auto load = [&](int n) {
    float* const st = stage(n);
    constexpr int PER_ROW = HD / 4;           // 16-byte pieces in a row
#pragma unroll
    for (int which = 0; which < 4; ++which) {   // r, k, logw, v
      const float* const src = which == 0 ? r : which == 1 ? k
                               : which == 2 ? logw : v;
      float* const dst = st + which * C * LDR;
      const int ld = which == 3 ? LDV : LDR;
      for (int e = tid; e < C * PER_ROW; e += P::THREADS) {
        const int t = e / PER_ROW, i = 4 * (e % PER_ROW), gt = n * C + t;
        const bool valid = gt < S;
        cp16(dst + t * ld + i, src + row + (size_t)(valid ? gt : 0) * HD + i,
             valid);
      }
    }
  };

  // A's strictly upper part and the diagonal stay 0; the state enters at 0
  for (int e = tid; e < C * LDA; e += P::THREADS) sA[e] = 0.f;
  for (int e = tid; e < HD * HD; e += P::THREADS) sS[e] = 0.f;
  float sc[HD / 16][2][4];                   // a state warp's columns, f32
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[mt][e >> 2][e & 3] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nchunks) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int n = 0; n < nchunks; ++n) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NSTAGE - 2) : "memory");
    __syncthreads();     // chunk n is in; chunk n-1's stage and buffers are free
    if (n + NSTAGE - 1 < nchunks) load(n + NSTAGE - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    float* const cr = stage(n);
    float* const ck = cr + C * LDR;
    float* const cw = ck + C * LDR;           // logw, then lp * log2(e)
    float* const cv = cw + C * LDR;
    const float* const s_in = sS + (n & 1) * HD * HD;
    float* const s_next = sS + ((n + 1) & 1) * HD * HD;

    // (1) per key channel: the cumulative sum of logw (four threads of four
    // rows, joined through shared memory), then every decayed operand of
    // the chunk and the u-bonus partial sums
    float l[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      l[x] = cw[(4 * p + x) * LDR + ic] * LOG2E;
      if (x) l[x] += l[x - 1];
    }
    sqt[p * HD + ic] = l[3];
    __syncthreads();
    {
      const float q0 = sqt[ic], q1 = sqt[HD + ic], q2 = sqt[2 * HD + ic];
      const float mid = q0 + q1;              // lp[H - 1]
      const float excl = p == 0 ? 0.f : p == 1 ? q0 : p == 2 ? mid : mid + q2;
      const float end = (mid + q2) + sqt[3 * HD + ic];
      if (p == 0) stot[ic] = exp2_approx(end);
      float bonus[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = 4 * p + x;
        const float lp = excl + l[x], lpp = x ? excl + l[x - 1] : excl;
        const float rv = cr[t * LDR + ic], kv = ck[t * LDR + ic];
        cw[t * LDR + ic] = lp;
        srd[t * LDR + ic] = rv * exp2_approx(lpp);
        sko[t * LDV + ic] = kv * exp2_approx(end - lp);
        if (t >= H) sr2[(t - H) * LDR + ic] = rv * exp2_approx(lpp - mid);
        else sk2[t * LDR + ic] = kv * exp2_approx(mid - lp);
        bonus[x] = rv * uc * kv;
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int o = 1; o < (HD < 32 ? HD : 32); o <<= 1)
          bonus[x] += __shfl_xor_sync(0xffffffffu, bonus[x], o);
        if (ic % 32 == 0) sbp[(ic >> 5) * C + 4 * p + x] = bonus[x];
      }
    }
    __syncthreads();

    if (!ywarp) {
      // (2) the diagonal 8 x 8 sub-tiles of A, pairwise on the CUDA cores,
      // four threads to an entry (every fourth float4 of the key channels
      // each); then the state
      const int stid = tid - NY * 32;
      for (int it = stid; it < 224; it += (P::NW - NY) * 32) {
        const int pair = it >> 2, part = it & 3;
        const int sub = pair / 28, pr = pair % 28;
        const int tl = (int)((1.f + sqrtf(1.f + 8.f * pr)) * 0.5f);
        const int t = H * sub + tl, s = H * sub + pr - tl * (tl - 1) / 2;
        const float4* rt = reinterpret_cast<const float4*>(cr + t * LDR);
        const float4* lpt = reinterpret_cast<const float4*>(cw + (t - 1) * LDR);
        const float4* ks = reinterpret_cast<const float4*>(ck + s * LDR);
        const float4* lps = reinterpret_cast<const float4*>(cw + s * LDR);
        float acc = 0.f;
#pragma unroll
        for (int m = part; m < HD / 4; m += 4) {
          const float4 a = rt[m], b = ks[m], la = lpt[m], lb = lps[m];
          acc = fmaf(a.x * b.x, exp2_approx(la.x - lb.x), acc);
          acc = fmaf(a.y * b.y, exp2_approx(la.y - lb.y), acc);
          acc = fmaf(a.z * b.z, exp2_approx(la.z - lb.z), acc);
          acc = fmaf(a.w * b.w, exp2_approx(la.w - lb.w), acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (part == 0) sA[t * LDA + s] = acc;
      }
      asm volatile("bar.arrive 1, %0;" :: "n"(P::THREADS) : "memory");

      // (3s) S_out = diag(tot) S_in + kout^T v on this warp's columns
      BFrag vb[2][2] = {};                    // [k step][n tile]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int t = 8 * ks + q, j = j0 + 8 * nt + g;
          vb[ks][nt] = BFrag(cv[t * LDV + j], cv[(t + 4) * LDV + j]);
        }
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt) {
        // the chunk's kout^T v in fresh accumulators, added to the state
        // in f32 (rounded to nearest): the state never accumulates inside
        // the tensor cores, whose f32 sums do not round to nearest
        float gk[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int t = 8 * ks + q, i = 16 * mt + g;
          const float a[4] = {sko[t * LDV + i], sko[t * LDV + i + 8],
                              sko[(t + 4) * LDV + i], sko[(t + 4) * LDV + i + 8]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma3(gk[nt], ah, al, vb[ks][nt]);
        }
        const float d0 = stot[16 * mt + g], d1 = stot[16 * mt + g + 8];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          sc[mt][nt][0] = fmaf(d0, sc[mt][nt][0], gk[nt][0]);
          sc[mt][nt][1] = fmaf(d0, sc[mt][nt][1], gk[nt][1]);
          sc[mt][nt][2] = fmaf(d1, sc[mt][nt][2], gk[nt][2]);
          sc[mt][nt][3] = fmaf(d1, sc[mt][nt][3], gk[nt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int i = 16 * mt + g, j = j0 + 8 * nt + 2 * q;
          *reinterpret_cast<float2*>(s_next + sidx<HD>(i, j)) =
              make_float2(sc[mt][nt][0], sc[mt][nt][1]);
          *reinterpret_cast<float2*>(s_next + sidx<HD>(i + 8, j)) =
              make_float2(sc[mt][nt][2], sc[mt][nt][3]);
        }
      }
    } else {
      // (2) the block of A below the diagonal sub-tiles, rows H.. and
      // columns ..H-1: r2 k2^T on the tensor cores, in the first y warp
      if (warp == 0) {
        float ac[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {   // rows 0..H-1 of the tile are 0
          const int i = 8 * ks + q;
          const float a[4] = {0.f, sr2[g * LDR + i], 0.f, sr2[g * LDR + i + 4]};
          mma3(ac[ks & 1], a, BFrag(sk2[g * LDR + i], sk2[g * LDR + i + 4]));
        }
        sA[(H + g) * LDA + 2 * q] = ac[0][2] + ac[1][2];
        sA[(H + g) * LDA + 2 * q + 1] = ac[0][3] + ac[1][3];
      }
      // (3y) y = rd S_in + A v + bonus v on this warp's columns.  Each k
      // step's products go to fresh accumulators, summed in f32 (rounded
      // to nearest): |y| is a sum of terms up to |r| |S| that may cancel
      float yc[2][4] = {};                    // [n tile]
      auto add = [&](float* acc, const float* part) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += part[e];
      };
#pragma unroll
      for (int ks = 0; ks < HD / 8; ++ks) {
        const int i = 8 * ks + q;
        const float a[4] = {srd[g * LDR + i], srd[(g + 8) * LDR + i],
                            srd[g * LDR + i + 4], srd[(g + 8) * LDR + i + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = j0 + 8 * nt + g;
          float part[4] = {};
          mma3(part, ah, al,
               BFrag(s_in[sidx<HD>(i, j)], s_in[sidx<HD>(i + 4, j)]));
          add(yc[nt], part);
        }
      }
      // A is complete once the state warps have arrived
      asm volatile("bar.sync 1, %0;" :: "n"(P::THREADS) : "memory");
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int s = 8 * ks + q;
        const float a[4] = {sA[g * LDA + s], sA[(g + 8) * LDA + s],
                            sA[g * LDA + s + 4], sA[(g + 8) * LDA + s + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = j0 + 8 * nt + g;
          float part[4] = {};
          mma3(part, ah, al, BFrag(cv[s * LDV + j], cv[(s + 4) * LDV + j]));
          add(yc[nt], part);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = g + 8 * h, gt = n * C + t;
        if (gt < S) {
          float bo = 0.f;
#pragma unroll
          for (int pp = 0; pp < P::NPART; ++pp) bo += sbp[pp * C + t];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int j = j0 + 8 * nt + 2 * q;
            float2 out;
            out.x = fmaf(bo, cv[t * LDV + j], yc[nt][2 * h]);
            out.y = fmaf(bo, cv[t * LDV + j + 1], yc[nt][2 * h + 1]);
            *reinterpret_cast<float2*>(y + row + (size_t)gt * HD + j) = out;
          }
        }
      }
    }
  }

  if (!ywarp) {
    float* const so = s_out + (size_t)blockIdx.x * HD * HD;
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int i = 16 * mt + g, j = j0 + 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(so + (size_t)i * HD + j) =
            make_float2(sc[mt][nt][0], sc[mt][nt][1]);
        *reinterpret_cast<float2*>(so + (size_t)(i + 8) * HD + j) =
            make_float2(sc[mt][nt][2], sc[mt][nt][3]);
      }
  }
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* y, void* s_out, int BH, int S,
           cudaStream_t stream) {
  using P = Plan<HD>;
  static const cudaError_t set = cudaFuncSetAttribute(
      wkv6_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P::SMEM);
  if (set != cudaSuccess) return (int)set;
  wkv6_chunk_kernel<HD><<<BH, P::THREADS, P::SMEM, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw,
      (const float*)u, (float*)y, (float*)s_out, S);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, logw, y: (BH, S, hd) f32; u: (BH, hd) f32; s_out: (BH, hd, hd)
// f32; all contiguous and 16-byte aligned; hd in {16, 32, 64}.  Returns the
// cudaError_t of the launch.
extern "C" int wkv6_chunk_fwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, void* y,
                              void* s_out, int BH, int S, int hd, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(r, k, v, logw, u, y, s_out, BH, S, s);
    case 32: return launch<32>(r, k, v, logw, u, y, s_out, BH, S, s);
    case 64: return launch<64>(r, k, v, logw, u, y, s_out, BH, S, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
