// RWKV-6 wkv recurrence for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_chunk/kernel.py
// (wkv6_chunked, body _wkv_kernel).  It computes the same function, per
// (batch, head) row bh of r, k, v, logw (BH, S, hd) and u (BH, hd):
//   y_t = r_t^T (S_{t-1} + diag(u * k_t) v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,    S_{-1} = 0,
// and also writes the state after the last step, S_{S-1} (BH, hd, hd) with
// [i][j] = key dim i, value dim j: the model's prefill keeps it for decode,
// where the Pallas kernel kept it in VMEM scratch only.  Any S is taken;
// the Pallas kernel needs S % chunk == 0.
//
// What bounds it on the H100.  Bytes: r, k, v, logw read and y written once,
// 5 * BH * S * hd * 4 bytes (about 336 MB at rwkv6-7b's prefill, BH = 256,
// S = 1024, hd = 64), plus the 4 MB state: about 0.10 ms at 3.35 TB/s.
// The sequential form's 4 * BH * S * hd^2 f32 operations (4.3 GFLOP there)
// take about 0.065 ms at the 67 TFLOP/s CUDA-core rate, so the function is
// bytes-bound.  This kernel is bound by neither: its state update is an
// instruction stream of about four FP32 instructions per (t, i, j) issued by
// only 512 warps, two blocks per SM, so it is issue- and latency-bound.
//
// Design (the classic RWKV CUDA form, not the chunked TPU one).
//   * One block per bh with hd threads; thread j keeps column j of the
//     hd x hd state in hd registers, so the state never leaves the SM.
//   * Time is staged T steps at a time: the block loads the T x hd tiles of
//     r, k, v and logw (contiguous rows) with coalesced float4 loads into
//     shared memory, turning logw into exp(logw) and k into u * k on the
//     way, then walks the T steps.  Every thread reads the same r_t[i],
//     k_t[i], w_t[i], (u k_t)[i] (a shared-memory broadcast, as float4s)
//     and its own v_t[j].
//   * The y sum runs in four partial sums so its FMAs do not form one
//     dependent chain of hd; the state columns update independently.
//   * The chunked, tensor-core form (intra-chunk products as matmuls) is
//     the step that moves it towards the bound; that is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T = 16;   // time steps staged in shared memory per round

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, float* __restrict__ y,
            float* __restrict__ s_out, int S) {
  static_assert(HD % 4 == 0, "hd must be a multiple of 4");
  __shared__ __align__(16) float sr[T * HD];
  __shared__ __align__(16) float sk[T * HD];
  __shared__ __align__(16) float suk[T * HD];
  __shared__ __align__(16) float sw[T * HD];
  __shared__ __align__(16) float sv[T * HD];
  __shared__ __align__(16) float su[HD];

  const int j = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * S * HD;
  su[j] = u[(size_t)blockIdx.x * HD + j];

  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();   // the previous round's reads are done (and su is set)
    const size_t off = row + (size_t)t0 * HD;
    const float4* r4 = reinterpret_cast<const float4*>(r + off);
    const float4* k4 = reinterpret_cast<const float4*>(k + off);
    const float4* v4 = reinterpret_cast<const float4*>(v + off);
    const float4* w4 = reinterpret_cast<const float4*>(logw + off);
    for (int e = j; e < n * HD / 4; e += HD) {
      const float4 kk = k4[e];
      const float4 ww = w4[e];
      const float4 uu = reinterpret_cast<const float4*>(su)[e % (HD / 4)];
      reinterpret_cast<float4*>(sr)[e] = r4[e];
      reinterpret_cast<float4*>(sv)[e] = v4[e];
      reinterpret_cast<float4*>(sk)[e] = kk;
      reinterpret_cast<float4*>(suk)[e] =
          make_float4(uu.x * kk.x, uu.y * kk.y, uu.z * kk.z, uu.w * kk.w);
      reinterpret_cast<float4*>(sw)[e] =
          make_float4(expf(ww.x), expf(ww.y), expf(ww.z), expf(ww.w));
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt * HD + j];
      const float4* rr4 = reinterpret_cast<const float4*>(sr + tt * HD);
      const float4* kk4 = reinterpret_cast<const float4*>(sk + tt * HD);
      const float4* uk4 = reinterpret_cast<const float4*>(suk + tt * HD);
      const float4* ww4 = reinterpret_cast<const float4*>(sw + tt * HD);
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rr = rr4[q], kk = kk4[q], uk = uk4[q], ww = ww4[q];
        const int i = 4 * q;
        y0 = fmaf(rr.x, fmaf(uk.x, vj, st[i + 0]), y0);
        y1 = fmaf(rr.y, fmaf(uk.y, vj, st[i + 1]), y1);
        y2 = fmaf(rr.z, fmaf(uk.z, vj, st[i + 2]), y2);
        y3 = fmaf(rr.w, fmaf(uk.w, vj, st[i + 3]), y3);
        st[i + 0] = fmaf(ww.x, st[i + 0], kk.x * vj);
        st[i + 1] = fmaf(ww.y, st[i + 1], kk.y * vj);
        st[i + 2] = fmaf(ww.z, st[i + 2], kk.z * vj);
        st[i + 3] = fmaf(ww.w, st[i + 3], kk.w * vj);
      }
      y[row + (size_t)(t0 + tt) * HD + j] = (y0 + y1) + (y2 + y3);
    }
  }
  float* so = s_out + (size_t)blockIdx.x * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) so[i * HD + j] = st[i];
}

template <int HD>
void launch(const void* r, const void* k, const void* v, const void* logw,
            const void* u, void* y, void* s_out, int BH, int S,
            cudaStream_t stream) {
  wkv6_kernel<HD><<<BH, HD, 0, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw,
      (const float*)u, (float*)y, (float*)s_out, S);
}

}  // namespace

// r, k, v, logw, y: (BH, S, hd) f32; u: (BH, hd) f32; s_out: (BH, hd, hd)
// f32; all contiguous and 16-byte aligned; hd in {16, 32, 64}.  Returns the
// cudaError_t of the launch.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, void* y, void* s_out,
                        int BH, int S, int hd, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: launch<16>(r, k, v, logw, u, y, s_out, BH, S, s); break;
    case 32: launch<32>(r, k, v, logw, u, y, s_out, BH, S, s); break;
    case 64: launch<64>(r, k, v, logw, u, y, s_out, BH, S, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
