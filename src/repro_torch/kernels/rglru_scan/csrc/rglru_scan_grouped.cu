// RG-LRU linear recurrence for Hopper (sm_90a), f32: channel groups in one
// wave, each fed by a multi-stage TMA ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_scan_blocked, body _rglru_kernel), and computes what
// csrc/rglru_scan.cu (the earlier design) computes:
//   a, b (B, S, C) f32 -> h (B, S, C) f32, h_t = a_t * h_{t-1} + b_t per
//   channel, h_{-1} = 0 (the caller folds an initial state into b_0),
// for any B, S and C.
//
// What bounds it on the H100.  Bytes: a and b read once, h written once,
// 12 bytes per element for one multiply-add: about 126 MB at
// recurrentgemma-2b's prefill shape (4, 1024, 2560), 38 us at 3.35 TB/s.
// The earlier kernel ran one thread per (batch, channel), 10,240 threads
// there, about two warps an SM, each with 16 steps of loads in flight: far
// too few bytes in flight to sustain the rate (38% of the bound).  By
// Little's law about 3.4 MB must be in flight across the card (3.35 TB/s
// times a microsecond).
//
// Design.  Each CTA owns one batch row and a group of G channels (the
// wrapper's ``plan`` picks G so that B * ceil(C / G) fills the SMs once: G =
// 80 and 128 CTAs at the prefill shape).  It streams its time tiles of T
// steps x G channels of a and b through a ring of STAGES tiles in shared
// memory (3 stages of 20 KB there: two tiles, 40 KB, in flight per SM, about
// 5 MB across the card), and thread c walks channel c through each staged
// tile, storing h straight to memory: a warp's store of one step is 32
// neighbouring channels, one 128-byte line.
//   * Where C % 4 == 0 (rows 16-byte aligned, as TMA needs), a tile is two
//     TMA copies, a's and b's (T x G) boxes of a 3-D tensor map, issued by
//     one thread; their bytes complete the stage's mbarrier, and TMA fills
//     what lies past S or C with zeros.
//   * Otherwise each warp copies rows of G floats, 4 bytes a lane, with
//     cp.async (zero-filled past S and C).
// Why not decoupled look-back over time blocks: one wave of channel groups
// already reads a and b once and needs no inter-block protocol.
//
// Precision.  The carry h is an f64 register: each step is one f64 FMA, and
// h is rounded to f32 once, where it is stored.  An f32 carry rounds every
// step, and where a is near 1 nothing decays those roundings: over 1024
// steps they pass the reference's 2e-5 against the recurrence in f64
// (tests/test_torch_rglru.py::test_f32_carry_misses_at_slow_decay), where
// the f64 carry stays within one f32 rounding of it.  The f64 work (three
// conversions and one FMA an element) is a small fraction of the time the
// bytes take, and the chain it adds to each step overlaps the ring's loads.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int T = 32;            // time steps in a tile
constexpr int MAX_THREADS = 128; // G <= 128 (the wrapper's plan)
constexpr int STAGES = 3;        // tiles in the ring
static_assert(STAGES * 2 * T * MAX_THREADS * 4 <= 227 * 1024,
              "the ring fits in a CTA's shared memory at the largest G");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// ring: [STAGES][a, b][T][G] f32; TMA: whether the tiles come by tensor map
template <bool TMA>
__global__ void __launch_bounds__(MAX_THREADS)
rglru_scan_grouped_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb,
                          const float* __restrict__ a,
                          const float* __restrict__ b, float* __restrict__ h,
                          int S, int C, int G) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = blockIdx.x * G, nc = min(G, C - c0);
  const size_t base = (size_t)blockIdx.y * S * C + c0;
  const int ntiles = (S + T - 1) / T;
  const size_t tile = (size_t)2 * T * G;
  const uint32_t tile_bytes = 2u * T * G * 4u;

  if (TMA && tid == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile n into stage st
  auto load = [&](int n, int st) {
    float* const dst = ring + st * tile;
    if (TMA) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&full[st]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(bar), "r"(tile_bytes) : "memory");
        tma_load(smem_u32(dst), &ta, bar, c0, n * T, blockIdx.y);
        tma_load(smem_u32(dst + T * G), &tb, bar, c0, n * T, blockIdx.y);
      }
    } else {
      for (int rw = warp; rw < 2 * T; rw += nwarps) {   // rows of a, then b
        const int t = rw % T, gt = n * T + t;
        const float* src = (rw < T ? a : b) + base + (size_t)gt * C;
        for (int c = lane; c < G; c += 32) {
          const bool valid = gt < S && c < nc;
          cp_async4(dst + rw * G + c, valid ? src + c : a, valid);
        }
      }
    }
  };

  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < ntiles) load(p, p);
    if (!TMA) asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  double carry = 0.0;
  int cur = 0;                       // the stage of tile n
  uint32_t phase = 0;                // of the stages' barriers, bit per stage
  for (int n = 0; n < ntiles; ++n) {
    if (TMA) {
      mbar_wait(smem_u32(&full[cur]), phase >> cur & 1u);
      phase ^= 1u << cur;
    } else {
      // at most STAGES - 2 younger groups pending: the oldest tile has landed
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    }
    __syncthreads();     // tile n is in for every thread; tile n-1 is free
    if (n + STAGES - 1 < ntiles)     // into tile n-1's stage
      load(n + STAGES - 1, cur ? cur - 1 : STAGES - 1);
    if (!TMA) asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid < nc) {
      const float* sa = ring + cur * tile + tid;
      const float* sb = sa + T * G;
      float* hp = h + base + (size_t)n * T * C + tid;
      const int nt = min(T, S - n * T);
      if (nt == T) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          carry = fma((double)sa[t * G], carry, (double)sb[t * G]);
          hp[(size_t)t * C] = (float)carry;
        }
      } else {
        for (int t = 0; t < nt; ++t) {
          carry = fma((double)sa[t * G], carry, (double)sb[t * G]);
          hp[(size_t)t * C] = (float)carry;
        }
      }
    }
    cur = cur + 1 == STAGES ? 0 : cur + 1;
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

// An f32 tensor (B, S, C), contiguous, read in boxes of (1, T, G).
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int C,
                int G) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)C * 4 * S};
  const cuuint32_t box[3] = {(cuuint32_t)G, (cuuint32_t)T, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TMA>
int launch(const float* a, const float* b, float* h, int B, int S, int C,
           int G, cudaStream_t stream) {
  const int smem = STAGES * 2 * T * G * (int)sizeof(float);
  static int allowed = 48 * 1024;    // dynamic shared memory opted in so far
  if (smem > allowed) {
    const cudaError_t set = cudaFuncSetAttribute(
        rglru_scan_grouped_kernel<TMA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return (int)set;
    allowed = smem;
  }
  CUtensorMap ta = {}, tb = {};
  if (TMA) {
    if (!encode_tiled()) return (int)cudaErrorSharedObjectSymbolNotFound;
    if (!tensor_map(&ta, a, B, S, C, G) || !tensor_map(&tb, b, B, S, C, G))
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((C + G - 1) / G, B);
  const int threads = (G + 31) / 32 * 32;
  rglru_scan_grouped_kernel<TMA><<<grid, threads, smem, stream>>>(
      ta, tb, a, b, h, S, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, h: (B, S, C) f32, contiguous.  G: channels per CTA, a multiple of 4
// up to 128 (from the wrapper's plan).  Returns the cudaError_t of the launch.
extern "C" int rglru_scan_grouped_fwd(const void* a, const void* b, void* h,
                                      int B, int S, int C, int G,
                                      void* stream) {
  if (G < 4 || G > MAX_THREADS || G % 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // TMA needs 16-byte aligned rows and tensors: C % 4 == 0 (G % 4 == 0 keeps
  // every box's start aligned)
  const bool tma = C % 4 == 0 && ((size_t)a | (size_t)b) % 16 == 0;
  return tma ? launch<true>((const float*)a, (const float*)b, (float*)h, B, S,
                            C, G, s)
             : launch<false>((const float*)a, (const float*)b, (float*)h, B, S,
                             C, G, s);
}
