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
// What bounds it.  Bytes: 2 elements read and 1 written per step and
// channel, no reuse (at B = 1, S = 4,096, W = 4,096 in bf16, ~101 MB, ~0.03
// ms at 3.35 TB/s), and 3 flops per 6 bytes.  The dependent chain is one
// product and one sum a step (~8 cycles, ~20 µs over 4,096 steps), below
// the byte time, so the scan stays sequential and exact; what it needs is
// enough bytes in flight to keep the memory busy: at ~600 ns latency,
// 3.35 TB/s needs ~2 MB in flight across the card, ~16 KB an SM.
//
// Design, two kernels chosen by the launcher (rglru_scan.DIRECT_MAX_S):
// - Staged (prefill).  A block owns 32 channels of one row, so B = 1,
//   W = 4,096 gives 128 blocks, about one an SM.  Three producer warps
//   copy time tiles of a and gx (8 KB each: 128 steps in bf16, 64 in
//   float32) into a ring of 4 shared-memory stages with cp.async (16-byte
//   copies where rows and pointers allow, else 8 or 4; element by element
//   only for bf16 rows of odd width), so 3 tiles, 48 KB, are in flight an
//   SM while one warp, a lane a channel, walks the current tile: h = a·h +
//   gx, each h_t to a double-buffered shared tile, which the producers
//   write out coalesced (same vector width) while the consumer walks the
//   next.  One barrier a tile.
// - Direct (a decode step, a short prompt).  One thread per (b, channel),
//   the loads of U steps issued before the U dependent updates; one round
//   trip to memory and no barrier, the least latency for S <= U.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// ---- direct ---------------------------------------------------------------

constexpr int DIRECT_THREADS = 64;
constexpr int U = 8;  // time steps whose loads are issued together

template <typename T>
__global__ void __launch_bounds__(DIRECT_THREADS)
rglru_direct(const T* __restrict__ a, const T* __restrict__ gx,
             const T* __restrict__ h0, T* __restrict__ hs,
             T* __restrict__ hT, int S, int W) {
  const int w = blockIdx.x * DIRECT_THREADS + threadIdx.x;
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

// ---- staged ---------------------------------------------------------------

constexpr int CW = 32;                 // channels a block: one consumer warp
constexpr int PRODUCERS = 96;          // three producer warps
constexpr int STAGED_THREADS = CW + PRODUCERS;
constexpr int STAGES = 4;              // ring of a / gx tiles
constexpr int TILE_BYTES = 8192;       // one tile of one array
// a and gx in STAGES stages, hs in two
constexpr int STAGED_SMEM = (2 * STAGES + 2) * TILE_BYTES;

template <int N> struct Vec;
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(gmem), "n"(N));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [row0, row0 + rows) x channels [w0, w0 + nw) of a and gx into
// the (rows, CW) tiles sa and sg: VB bytes a copy by cp.async, or (VB = 0)
// element by element, 8 loads in flight a thread.  tid counts the
// `nthreads` threads that share the work.
template <typename T, int VB>
__device__ __forceinline__ void load_tile(T* sa, T* sg, const T* a,
                                          const T* gx, size_t row0, int rows,
                                          int W, int w0, int nw, int tid,
                                          int nthreads) {
  if constexpr (VB > 0) {
    constexpr int EPC = VB / (int)sizeof(T);  // elements a copy
    constexpr int CPR = CW / EPC;             // copies a row
    const int n = rows * CPR;
    for (int q = tid; q < n; q += nthreads) {
      const int r = q / CPR, c = (q % CPR) * EPC;
      if (c < nw) {
        const size_t g = (row0 + r) * (size_t)W + w0 + c;
        cp_async<VB>(sa + r * CW + c, a + g);
        cp_async<VB>(sg + r * CW + c, gx + g);
      }
    }
  } else {
    constexpr int BATCH = 8;
    const int n = rows * CW;
    for (int q0 = tid; q0 < n; q0 += BATCH * nthreads) {
      T va[BATCH], vg[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int q = q0 + u * nthreads, r = q / CW, c = q % CW;
        if (q < n && c < nw) {
          const size_t g = (row0 + r) * (size_t)W + w0 + c;
          va[u] = a[g];
          vg[u] = gx[g];
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int q = q0 + u * nthreads, c = q % CW;
        if (q < n && c < nw) {
          sa[q] = va[u];
          sg[q] = vg[u];
        }
      }
    }
  }
}

// Writes the (rows, CW) tile sh to hs rows [row0, row0 + rows), channels
// [w0, w0 + nw): VB bytes a store, or element by element (VB = 0).
template <typename T, int VB>
__device__ __forceinline__ void store_tile(T* hs, const T* sh, size_t row0,
                                           int rows, int W, int w0, int nw,
                                           int tid, int nthreads) {
  if constexpr (VB > 0) {
    using V = typename Vec<VB>::type;
    constexpr int EPC = VB / (int)sizeof(T);
    constexpr int CPR = CW / EPC;
    const int n = rows * CPR;
    for (int q = tid; q < n; q += nthreads) {
      const int r = q / CPR, c = (q % CPR) * EPC;
      if (c < nw)
        *reinterpret_cast<V*>(hs + (row0 + r) * (size_t)W + w0 + c) =
            *reinterpret_cast<const V*>(sh + r * CW + c);
    }
  } else {
    const int n = rows * CW;
    for (int q = tid; q < n; q += nthreads) {
      const int r = q / CW, c = q % CW;
      if (c < nw) hs[(row0 + r) * (size_t)W + w0 + c] = sh[q];
    }
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(STAGED_THREADS)
rglru_staged(const T* __restrict__ a, const T* __restrict__ gx,
             const T* __restrict__ h0, T* __restrict__ hs,
             T* __restrict__ hT, int S, int W) {
  constexpr int TT = TILE_BYTES / (CW * (int)sizeof(T));  // steps a tile
  constexpr int TILE = TT * CW;  // elements of one tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);   // [STAGES][TT][CW]
  T* sg = sa + STAGES * TILE;               // [STAGES][TT][CW]
  T* sh = sg + STAGES * TILE;               // [2][TT][CW]

  const int w0 = blockIdx.x * CW;
  const int b = blockIdx.y;
  const int nw = min(CW, W - w0);
  const int tid = threadIdx.x;
  const bool consumer = tid < CW;           // warp 0
  const int ptid = tid - CW;                // producer index
  const size_t row_b = (size_t)b * S;
  const int nt = (S + TT - 1) / TT;
  auto rows_of = [&](int i) { return min(TT, S - i * TT); };

  if (!consumer) {
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nt)
        load_tile<T, VB>(sa + i * TILE, sg + i * TILE, a, gx,
                         row_b + (size_t)i * TT, rows_of(i), W, w0, nw, ptid,
                         PRODUCERS);
      cp_async_commit();
    }
  }
  float h = 0.f;
  if (consumer && tid < nw) h = to_f(h0[(size_t)b * W + w0 + tid]);

  for (int i = 0; i < nt; ++i) {
    if (!consumer) cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed; tile i - 1 and hs tile i - 2 done
    if (!consumer) {
      const int nxt = i + STAGES - 1;
      if (nxt < nt)
        load_tile<T, VB>(sa + (nxt % STAGES) * TILE,
                         sg + (nxt % STAGES) * TILE, a, gx,
                         row_b + (size_t)nxt * TT, rows_of(nxt), W, w0, nw,
                         ptid, PRODUCERS);
      cp_async_commit();
      if (i > 0)
        store_tile<T, VB>(hs, sh + ((i - 1) & 1) * TILE,
                          row_b + (size_t)(i - 1) * TT, rows_of(i - 1), W,
                          w0, nw, ptid, PRODUCERS);
    } else {
      const T* ta = sa + (i % STAGES) * TILE + tid;
      const T* tg = sg + (i % STAGES) * TILE + tid;
      T* th = sh + (i & 1) * TILE + tid;
      const int n = rows_of(i);
      int r = 0;
      for (; r + 8 <= n; r += 8) {
        float av[8], gv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          av[u] = to_f(ta[(r + u) * CW]);
          gv[u] = to_f(tg[(r + u) * CW]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          h = av[u] * h + gv[u];
          th[(r + u) * CW] = from_f<T>(h);
        }
      }
      for (; r < n; ++r) {
        h = to_f(ta[r * CW]) * h + to_f(tg[r * CW]);
        th[r * CW] = from_f<T>(h);
      }
    }
  }
  __syncthreads();
  if (nt > 0)
    store_tile<T, VB>(hs, sh + ((nt - 1) & 1) * TILE,
                      row_b + (size_t)(nt - 1) * TT, rows_of(nt - 1), W, w0,
                      nw, tid, STAGED_THREADS);
  if (consumer && tid < nw) hT[(size_t)b * W + w0 + tid] = from_f<T>(h);
}

template <typename T, int VB>
int launch_staged(const T* a, const T* gx, const T* h0, T* hs, T* hT, int B,
                  int S, int W, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_staged<T, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        STAGED_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((W + CW - 1) / CW, B);
  rglru_staged<T, VB><<<grid, STAGED_THREADS, STAGED_SMEM, stream>>>(
      a, gx, h0, hs, hT, S, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a_, const void* gx_, const void* h0_, void* hs_,
           void* hT_, int B, int S, int W, int direct, cudaStream_t stream) {
  const T* a = static_cast<const T*>(a_);
  const T* gx = static_cast<const T*>(gx_);
  const T* h0 = static_cast<const T*>(h0_);
  T* hs = static_cast<T*>(hs_);
  T* hT = static_cast<T*>(hT_);
  if (direct) {
    const dim3 grid((W + DIRECT_THREADS - 1) / DIRECT_THREADS, B);
    rglru_direct<T><<<grid, DIRECT_THREADS, 0, stream>>>(a, gx, h0, hs, hT,
                                                         S, W);
    return (int)cudaGetLastError();
  }
  // the widest copy that every row start and every pointer allows
  const uintptr_t at = reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(gx) |
                       reinterpret_cast<uintptr_t>(hs) |
                       (uintptr_t)((size_t)W * sizeof(T));
  if (at % 16 == 0)
    return launch_staged<T, 16>(a, gx, h0, hs, hT, B, S, W, stream);
  if (at % 8 == 0)
    return launch_staged<T, 8>(a, gx, h0, hs, hT, B, S, W, stream);
  if (at % 4 == 0)
    return launch_staged<T, 4>(a, gx, h0, hs, hT, B, S, W, stream);
  return launch_staged<T, 0>(a, gx, h0, hs, hT, B, S, W, stream);
}

}  // namespace

// Launches the scan of B rows on `stream`: the direct kernel if `direct`,
// else the staged one.  dtype: 0 float32, 1 bfloat16.  Pointers are device
// pointers.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int rglru_scan_launch(const void* a, const void* gx,
                                 const void* h0, void* hs, void* hT, int B,
                                 int S, int W, int dtype, int direct,
                                 void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, gx, h0, hs, hT, B, S, W, direct, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, gx, h0, hs, hT, B, S, W, direct, s);
  return (int)cudaErrorInvalidValue;
}
