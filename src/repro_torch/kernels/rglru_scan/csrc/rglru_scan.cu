// RG-LRU linear recurrence for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_scan_blocked, body _rglru_kernel).  It computes the same function:
//   a, b (B, S, C) f32 -> h (B, S, C) f32, h_t = a_t * h_{t-1} + b_t per
//   channel, with h_{-1} = 0 (the caller folds an initial state into b_0).
// The Pallas kernel's divisibility asserts are TPU block sizes; this kernel
// takes any S and C.
//
// What bounds it on the H100.  Memory: each element is read twice (a, b)
// and written once (h), 12 bytes for one FMA.  At recurrentgemma-2b's
// prefill shape (4, 1024, 2560) that is about 126 MB, so the bound is about
// 38 us at 3.35 TB/s; the 10.5 MFLOP are nothing.
//
// Design.  One thread per (batch, channel) walks t = 0..S-1 with h in a
// register, carried in f64 (one f64 FMA a step) and rounded to f32 only where
// it is stored: an f32 carry rounds every step, and where a is near 1 nothing
// decays those roundings (1.05e-4 from the recurrence in f64 at (4, 1024,
// 2560), over the 2e-5 tolerance), as rglru_scan_grouped.cu does.  Neighbouring threads take neighbouring channels, so each time
// step's loads and stores of a warp are one coalesced 128-byte line.  The
// loads of UNROLL time steps are issued together before the FMAs that
// consume them, so each thread keeps 2 * UNROLL loads in flight instead of
// waiting a full memory latency per step.
//
// Occupancy.  There are only B * C threads (10,240 at the prefill shape:
// 160 blocks of 64, about two warps per SM), so the card's memory system is
// far from saturated and the time is set by S / UNROLL memory round trips
// per thread.  Splitting time into blocks (a scan of per-block (A, B)
// pairs, then a fix-up pass) would multiply the threads by the number of
// time blocks; that is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 64;    // channels per block
constexpr int UNROLL = 16;     // time steps whose loads are in flight together

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= C) return;
  const size_t base = (size_t)blockIdx.y * S * C + c;
  double carry = 0.0;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t i = base + (size_t)(t + u) * C;
      av[u] = a[i];
      bv[u] = b[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = fma((double)av[u], carry, (double)bv[u]);
      h[base + (size_t)(t + u) * C] = (float)carry;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + (size_t)t * C;
    carry = fma((double)a[i], carry, (double)b[i]);
    h[i] = (float)carry;
  }
}

}  // namespace

// a, b, h: (B, S, C) f32, contiguous.  Returns the cudaError_t of the launch.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int S, int C, void* stream) {
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, S, C);
  return (int)cudaGetLastError();
}
