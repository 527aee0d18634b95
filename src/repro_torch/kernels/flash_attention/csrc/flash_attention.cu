// Flash attention forward for Hopper (sm_90a) on the CUDA cores, f32 and bf16
// inputs.  It takes every call that the tensor-core kernel
// (flash_attention_wgmma.cu) does not: f32, whose reference tolerance of 3e-5
// TF32 would break, and bf16 at a head dim that kernel has no instance for
// (the rule is ops.py::variant).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bkg, body _flash_kernel).  It computes the same function:
//   q (BK, Sq, G, hd), k and v (BK, Skv, hd), output (BK, Sq, G, hd) in q's
//   dtype; s = scale * q k^T, optionally softcap * tanh(s / softcap); a causal
//   mask with row i of q at position q0 + i (col <= q0 + i; q0 = 0 aligns it
//   top-left) and an optional sliding window (col > q0 + i - window); masked
//   scores set to -1e30; online softmax with f32
//   m, l and acc; l clamped at 1e-30 before the final division.  The PV
//   product is taken in f32, as in the Pallas body, so the plain version in
//   ../ref.py is the same function.
//
// What bounds it on the H100.  Attention at prefill lengths is bound by
// operations: at gemma3-1b's global layer (BK=4, S=1024, G=4, hd=256, bf16)
// the causal pairs need about 8.6 GFLOP against about 21 MB of q/k/v/o, so
// the tensor cores (989 TFLOP/s in bf16) would set the bound, not HBM.
// This kernel does not reach the tensor cores: it does its products with
// f32 FMAs on the CUDA cores (67 TFLOP/s peak) out of shared memory, so its
// ceiling is the FMA pipe and the shared-memory reads feeding it.
//
// Design.
//   * One thread block per (BK row, tile of BM = 64 q rows).  The GQA group
//     is folded into the rows (row = position * G + group), so each K/V tile
//     in shared memory serves all G query heads of its KV head.
//   * A loop inside the block walks the KV tiles of BN = 32 positions that
//     the tile's causal/window range reaches; tiles outside it are never
//     loaded (the Pallas kernel's pl.when skip, done as a loop bound).
//   * Four threads own one q row: each computes 8 of the tile's 32 scores,
//     the row max and sum are reduced with warp shuffles, so m and l live in
//     registers.  The four threads also own a quarter of the row's output
//     columns each (float4 chunks), so acc (up to 64 x 256 f32 per block)
//     lives in registers, not in shared memory.
//   * Q and the K/V tiles are staged in shared memory as f32, rows padded by
//     4 floats so the float4 reads of a quarter-warp hit distinct banks.  At
//     hd = 256 that is 130 KB, above the 48 KB default, so the first launch
//     of each instantiation raises the dynamic shared-memory limit with
//     cudaFuncSetAttribute.
//   * q tiles are launched latest first: causal work grows with position, so
//     the long tiles start early and the short ones fill the tail.
//   * Ragged edges (rows past Sq * G, KV positions past Skv) are handled in
//     the kernel: such rows load zeros and are not stored, such positions
//     score -inf and so weigh exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // q rows per block
constexpr int BN = 32;                 // kv positions per tile
constexpr int THREADS = 4 * BM;        // four threads per q row
constexpr int MAX_HD = 256;
constexpr int CHUNKS = MAX_HD / 16;    // float4 output chunks per thread
constexpr int PAD = 4;                 // shared-memory row padding (floats)
constexpr float NEG_INF = -1e30f;      // the reference's mask value
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int G, int hd, float scale, float softcap, int window,
                 int causal, int q0) {
  extern __shared__ float4 smem4[];
  const int ld = hd + PAD;
  float* Qs = reinterpret_cast<float*>(smem4);   // [BM][ld]
  float* Ks = Qs + BM * ld;                       // [BN][ld]
  float* Vs = Ks + BN * ld;                       // [BN][ld]

  const int tid = threadIdx.x;
  const int row = tid >> 2;          // q row of the tile this thread owns
  const int sub = tid & 3;           // its quarter of the row's columns
  const int base_lane = (tid & 31) & ~3;
  const int rows_total = Sq * G;
  const int tile = gridDim.x - 1 - blockIdx.x;   // latest tiles first
  const int r0 = tile * BM;
  const int r_last = min(r0 + BM, rows_total) - 1;
  const int vec_per_row = hd >> 2;

  const size_t bk = blockIdx.y;
  const T* qb = q + bk * rows_total * hd;
  const T* kb = k + bk * Skv * hd;
  const T* vb = v + bk * Skv * hd;
  T* ob = o + bk * rows_total * hd;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < BM * vec_per_row; e += THREADS) {
    const int r = e / vec_per_row;
    const int c = (e - r * vec_per_row) * 4;
    store4(Qs + r * ld + c,
           r0 + r < rows_total ? load4(qb + (size_t)(r0 + r) * hd + c) : zero);
  }

  // The KV positions any row of this tile may attend to.
  int kv_begin = 0, kv_end = Skv;
  if (causal) {
    kv_end = min(Skv, q0 + r_last / G + 1);
    if (window > 0) kv_begin = max(0, q0 + r0 / G - window + 1);
  }

  const int my_row = r0 + row;
  const int my_pos = q0 + my_row / G;
  float m = NEG_INF, l = 0.f;
  float4 acc[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) acc[i] = zero;

  for (int kv0 = (kv_begin / BN) * BN; kv0 < kv_end; kv0 += BN) {
    __syncthreads();   // Q is stored; the previous K/V tile is used up
    for (int e = tid; e < BN * vec_per_row; e += THREADS) {
      const int r = e / vec_per_row;
      const int c = (e - r * vec_per_row) * 4;
      const bool in = kv0 + r < Skv;
      const size_t off = (size_t)(kv0 + r) * hd + c;
      store4(Ks + r * ld + c, in ? load4(kb + off) : zero);
      store4(Vs + r * ld + c, in ? load4(vb + off) : zero);
    }
    __syncthreads();

    // Scores of this thread's columns sub, sub + 4, ..., sub + 28.
    float s[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) s[j] = 0.f;
    const float* qrow = Qs + row * ld;
    for (int d = 0; d < hd; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (sub + 4 * j) * ld + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      const int col = kv0 + sub + 4 * j;
      float x = s[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (col >= Skv) {
        x = -INFINITY;                 // past the end: weighs exactly 0
      } else if (causal && (col > my_pos ||
                            (window > 0 && col <= my_pos - window))) {
        x = NEG_INF;
      }
      s[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(FULL, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 4; ++j) {
      s[j] = expf(s[j] - m_new);
      row_sum += s[j];
    }
    row_sum += __shfl_xor_sync(FULL, row_sum, 1);
    row_sum += __shfl_xor_sync(FULL, row_sum, 2);
    l = l * alpha + row_sum;
    m = m_new;

    // Gather the row's BN probabilities from the four threads holding them.
    float p[BN];
#pragma unroll
    for (int c = 0; c < BN; ++c)
      p[c] = __shfl_sync(FULL, s[c >> 2], base_lane + (c & 3));

#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int d = 16 * i + 4 * sub;
      if (d < hd) {
        float4 a = acc[i];
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
#pragma unroll
        for (int c = 0; c < BN; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c * ld + d);
          a.x = fmaf(p[c], vv.x, a.x);
          a.y = fmaf(p[c], vv.y, a.y);
          a.z = fmaf(p[c], vv.z, a.z);
          a.w = fmaf(p[c], vv.w, a.w);
        }
        acc[i] = a;
      }
    }
  }

  if (my_row < rows_total) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int d = 16 * i + 4 * sub;
      if (d < hd) {
        const float4 a = acc[i];
        store4(ob + (size_t)my_row * hd + d,
               make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
      }
    }
  }
}

constexpr size_t smem_bytes(int hd) {
  return (size_t)(BM + 2 * BN) * (hd + PAD) * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BK, int Sq, int Skv, int G, int hd, float scale,
                   float softcap, int window, int causal, int q0,
                   cudaStream_t stream) {
  // The shared-memory limit is raised once per instantiation and device, to
  // what the largest head dim needs.
  static unsigned raised = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(raised >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_HD));
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }
  const dim3 grid((Sq * G + BM - 1) / BM, BK);
  flash_fwd_kernel<T><<<grid, THREADS, smem_bytes(hd), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, G, hd, scale,
      softcap, window, causal, q0);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors; stream is a cudaStream_t.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BK, int Sq,
                                   int Skv, int G, int hd, float scale,
                                   float softcap, int window, int causal,
                                   int q0, int is_bf16, void* stream) {
  if (BK <= 0 || BK > 65535 || Sq <= 0 || Skv <= 0 || G <= 0 || hd <= 0 ||
      hd > MAX_HD || hd % 4 != 0 || q0 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, o, BK, Sq, Skv, G, hd, scale,
                                      softcap, window, causal, q0, st);
  return (int)launch<float>(q, k, v, o, BK, Sq, Skv, G, hd, scale, softcap,
                            window, causal, q0, st);
}
