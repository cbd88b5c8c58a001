// Helpers shared by the event-step kernels (csrc/event_step.cu, the
// float64 frozen-priority kernel of csrc/event_step_freeze64.cuh and its
// hedged instantiations in csrc/event_step_hedge.cu and
// csrc/event_step_dup.cu): warp-wide order keys and reductions, lane-owned
// arrays, staged rows and the launch shape.

#pragma once

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxCellsPerBlock = 16;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// dst[i] = src[i] for i < count, as 8 bits, eight loads in flight a lane.
__device__ __forceinline__ void stage8(uint8_t* dst, const int* src,
                                       int count, int lane) {
  constexpr int U = 8;
  for (int i0 = lane; i0 < count; i0 += 32 * U) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      v[u] = i < count ? __ldg(src + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u;
      if (i < count) dst[i] = static_cast<uint8_t>(v[u]);
    }
  }
}

// Cells a block and blocks of a launch of `kernel` over B cells of `cell`
// shared-memory bytes each: as many cells a block as fit (at most
// kMaxCellsPerBlock), then as few as keep the same number of waves, so that
// every SM gets cells.  Sets the kernel's dynamic shared-memory limit.
template <typename K>
int block_shape(K kernel, int B, int cell, int* cpb, int* blocks) {
  int dev = 0, n_sm = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cell > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = cell > 0 ? std::min(kMaxCellsPerBlock, smem_max / cell)
                           : kMaxCellsPerBlock;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           cap * cell);
  int blocks_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_sm, kernel,
                                                      32 * cap, cap * cell);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long per_wave = static_cast<long>(n_sm) * std::max(1, blocks_sm) * cap;
  const long waves = (B + per_wave - 1) / per_wave;
  const long spread = static_cast<long>(n_sm) * waves;
  *cpb = static_cast<int>(std::min<long>(cap, (B + spread - 1) / spread));
  *blocks = (B + *cpb - 1) / *cpb;
  return static_cast<int>(cudaSuccess);
}

constexpr unsigned long long NO_KEY64 = ~0ull;
// a cold start's prewarm charge (repro_torch/core/simulator.py
// OURS_PREWARM_EXTRA)
constexpr double kPrewarmExtra = 0.35;

// An order-preserving 64-bit key of a double (-0.0 taken as +0.0).
__device__ __forceinline__ unsigned long long order_key64(double x) {
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(__dadd_rn(x, 0.0)));
  return (u >> 63) ? ~u : (u | 0x8000000000000000ull);
}

__device__ __forceinline__ double key_double(unsigned long long k) {
  return __longlong_as_double(static_cast<long long>(
      (k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
}

// The least 64-bit key across the warp.
__device__ __forceinline__ unsigned long long warp_min64(
    unsigned long long k) {
  const unsigned hi = __reduce_min_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k)
                                                 : 0xffffffffu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The least (key, index) across the warp: the key, and the least index of
// the lanes that hold it (INT_MAX if none does).
__device__ __forceinline__ unsigned long long warp_argmin64(
    unsigned long long k, int idx, int* at) {
  const unsigned long long m = warp_min64(k);
  *at = __reduce_min_sync(FULL, k == m ? idx : INT_MAX);
  return m;
}

// Entries a lane owns: N in registers, or (N == 0) in the scratch, entry q
// at p[32 q] (p already at the lane's first word).
template <typename T, int N>
struct Lane {
  T v[N];
  __device__ __forceinline__ explicit Lane(T*) {}
  __device__ __forceinline__ T& operator[](int q) { return v[q]; }
};

template <typename T>
struct Lane<T, 0> {
  T* p;
  __device__ __forceinline__ explicit Lane(T* base) : p(base) {}
  __device__ __forceinline__ T& operator[](int q) const { return p[q * 32]; }
};

// Entry e of a lane-owned array of `pl` entries a lane, on every lane.
template <typename T, int N>
__device__ __forceinline__ T lane_get(Lane<T, N>& arr, int pl, int e) {
  const int src = e / pl, qe = e % pl;
  T v;
  if constexpr (N == 0) {
    v = arr[qe];
  } else {
    v = arr[0];
#pragma unroll
    for (int q = 1; q < N; ++q)
      if (q == qe) v = arr[q];
  }
  return __shfl_sync(FULL, v, src);
}

// Rows of a float64 cell: in shared memory (fnid as 8 bits) or in place.
template <bool S>
struct DRows {
  using Fn = std::conditional_t<S, uint8_t, int>;
  const double* t_;
  const double* p_;
  const double* c_;
  const Fn* fn_;
  __device__ __forceinline__ double t(int i) const {
    if constexpr (S) return t_[i]; else return __ldg(t_ + i);
  }
  __device__ __forceinline__ double p(int i) const {
    if constexpr (S) return p_[i]; else return __ldg(p_ + i);
  }
  __device__ __forceinline__ double cost(int i) const {
    if constexpr (S) return c_[i]; else return __ldg(c_ + i);
  }
  __device__ __forceinline__ int fn(int i) const {
    if constexpr (S) return fn_[i]; else return __ldg(fn_ + i);
  }
};

}  // namespace
