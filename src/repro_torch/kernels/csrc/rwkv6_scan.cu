// RWKV-6 time-mix recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::_kernel (launched by
// rwkv6_scan).  Per batch row b and head h, with a dh × dh float32 state S
// (rows k, columns v):
//     out_t = r_t · (S + diag(u) · k_t v_tᵀ)
//     S    ← diag(w_t) · S + k_t v_tᵀ
// The Pallas kernel starts from S = 0 and returns out only; this one starts
// from s0 and also returns the last state sT, as the jnp oracle
// ref.rwkv6_ref does, because the port's model carries the state from a
// prefill into every decode step.  With s0 = 0, out is the Pallas function.
// Every product is taken in float32 (the Pallas kernel casts r, k, v to
// float32 first).  The plain PyTorch version is
// repro_torch/kernels/rwkv6_scan.py::rwkv6_scan_ref.
//
// Layout: r, k, v, out (B, S, H, dh) in float32 or bfloat16; w (B, S, H,
// dh), u (H, dh), s0 and sT (B, H, dh, dh) in float32; all contiguous.
// dh is 16, 32, 64 or 128; any S >= 0 (S = 1 is a decode step).
//
// Design.  One block of dh threads per (b, head).  Thread j owns column j
// of S (dh floats in registers), so out_t[j] = Σ_i r[i] (S[i][j] + u[i]
// k[i] v[j]) and the update of column j need no reduction across threads.
// The block stages CH = 16 time steps of r, k, v and w in shared memory at
// a time (each load coalesced: thread j reads element j of a head's row);
// within a step every thread reads the same r[i], k[i], w[i], u[i], a
// broadcast.  Two barriers per 16 steps.  The sum over i runs in order
// i = 0 … dh − 1, the plain version's einsum in another order.
//
// What bounds it.  Operations: the function needs 5 dh² + 5 dh float32
// flops per head and step.  The update diag(w) S + k vᵀ is 3 per state
// element (k v, w S, their sum); r · S is 2 per element; the bonus is
// r · diag(u) k vᵀ = (Σ_i r_i u_i k_i) v, one dot product of length dh
// (3 dh) scaled by v and added to out (2 dh).  At B = 1, S = 4,096,
// H = 40, dh = 64 that is 3.4 GFLOP, ~0.05 ms at 67 TFLOP/s, against
// ~126 MB of r, k, v, w and out (~0.038 ms).  This kernel does more than
// that: it forms u k v per element as the Pallas kernel does, 7 dh² a
// step, so its own arithmetic alone would take ~0.07 ms.  One block
// per (b, head) gives only 40 blocks of 64 threads at B = 1 on 132 SMs,
// and each thread walks a serial chain of dh dependent sums per step, so
// this version is latency-bound at small batch.  Splitting the time axis
// into chunks (the chunked form of the linear recurrence, with products of
// decays across a chunk on the tensor cores) is the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CH = 16;  // time steps staged in shared memory at a time

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

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ out, float* __restrict__ sT, int S, int H) {
  __shared__ float sr[CH][DH], sk[CH][DH], sv[CH][DH], sw[CH][DH];
  __shared__ float su[DH];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j = threadIdx.x;

  const size_t sbase = ((size_t)b * H + h) * DH * DH + j;
  float st[DH];  // st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < DH; ++i) st[i] = s0[sbase + (size_t)i * DH];
  su[j] = u[h * DH + j];

  const size_t row = (size_t)H * DH;  // stride between time steps
  const size_t base = ((size_t)b * S * H + h) * DH + j;
  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (c >= n) break;
      const size_t at = base + (size_t)(t0 + c) * row;
      sr[c][j] = to_f(r[at]);
      sk[c][j] = to_f(k[at]);
      sv[c][j] = to_f(v[at]);
      sw[c][j] = w[at];
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float o = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float kv = sk[c][i] * vj;
        o = o + sr[c][i] * (st[i] + su[i] * kv);
        st[i] = sw[c][i] * st[i] + kv;
      }
      out[base + (size_t)(t0 + c) * row] = from_f<T>(o);
    }
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) sT[sbase + (size_t)i * DH] = st[i];
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* out, float* sT, int B,
           int S, int H, cudaStream_t stream) {
  rwkv6_scan_kernel<T, DH><<<B * H, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(out), sT, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, void* out, float* sT, int B,
              int S, int H, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, sT, B, S, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, sT, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, sT, B, S, H, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, out, sT, B, S, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the recurrence of B rows on `stream`.  dtype (of r, k, v, out):
// 0 float32, 1 bfloat16.  Pointers are device pointers.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* w, const float* u,
                                 const float* s0, void* out, float* sT, int B,
                                 int S, int H, int dh, int dtype,
                                 void* stream) {
  if (B < 0 || S < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(r, k, v, w, u, s0, out, sT, B, S, H, dh, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, B, S, H, dh,
                                    s);
  return (int)cudaErrorInvalidValue;
}
