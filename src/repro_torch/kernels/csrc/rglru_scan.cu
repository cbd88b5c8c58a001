// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::_kernel (launched by
// rglru_scan).  Per batch row b and channel w:
//     h_t = a_t · h_{t−1} + gx_t,   h_{−1} = h0,
// with h carried in float32 whatever the input type, every h_t written to
// hs in the input type, and the last one to hT.  The plain PyTorch version
// is repro_torch/kernels/rglru_scan.py::rglru_scan_ref; with --fmad=false
// the product and the sum round separately, as they do there, so the two
// agree bit for bit.
//
// Layout: a, gx, hs (B, S, W) and h0, hT (B, W), all contiguous, in float32
// or bfloat16.  Any S >= 0 (S = 1 is a decode step) and any W.
//
// Design.  One thread per (b, channel), neighbouring threads on
// neighbouring channels, so each time step's loads and stores are
// coalesced across a warp.  The loads of a_t and gx_t do not depend on h,
// so the time loop is unrolled by U: a thread issues the 2·U loads of U
// steps before it walks the U dependent updates, keeping U steps of loads
// in flight.  Blocks of 64 threads spread the channels over as many SMs as
// possible.
//
// What bounds it.  Bytes: 2 elements read and 1 written per step and
// channel, no reuse (at B = 1, S = 4,096, W = 4,096 in bf16, ~101 MB, ~0.03
// ms at 3.35 TB/s), and 3 flops per 6 bytes.  At B = 1 there are only W =
// 4,096 threads, 64 blocks: too few loads in flight to reach the memory
// rate, so this version is latency-bound at small batch.  A chunked
// two-pass scan (local scans of time chunks in parallel, then a pass that
// carries each chunk's start state) is the later step that fills the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 8;  // time steps whose loads are issued together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ gx,
                  const T* __restrict__ h0, T* __restrict__ hs,
                  T* __restrict__ hT, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)b * S * W + w;
  float h = to_f(h0[(size_t)b * W + w]);
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        av[u] = to_f(a[base + (size_t)(t0 + u) * W]);
        gv[u] = to_f(gx[base + (size_t)(t0 + u) * W]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        h = av[u] * h + gv[u];
        hs[base + (size_t)(t0 + u) * W] = from_f<T>(h);
      }
    }
  }
  hT[(size_t)b * W + w] = from_f<T>(h);
}

template <typename T>
int launch(const void* a, const void* gx, const void* h0, void* hs, void* hT,
           int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gx),
      static_cast<const T*>(h0), static_cast<T*>(hs), static_cast<T*>(hT), S,
      W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the scan of B rows on `stream`.  dtype: 0 float32, 1 bfloat16.
// Pointers are device pointers.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int rglru_scan_launch(const void* a, const void* gx,
                                 const void* h0, void* hs, void* hT, int B,
                                 int S, int W, int dtype, void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, gx, h0, hs, hT, B, S, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, gx, h0, hs, hT, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
