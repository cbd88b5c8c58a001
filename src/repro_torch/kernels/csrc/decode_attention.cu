// One-token decode attention over a ragged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_kernel
// (launched by decode_attention).  For each batch row b and query head h it
// computes softmax(q·Kᵀ · scale) · V over the first lengths[b] cache
// entries, with GQA (query head h reads KV head h / G).  A row with length
// 0 gives 0, as the Pallas kernel does.  The plain PyTorch version is
// repro_torch/kernels/decode_attention.py::decode_attention_ref.
//
// Layout, as the JAX package passes it: q (B, Hq, dh), k / v (B, Sk, Hkv,
// dh), lengths (B,) int32, out (B, Hq, dh) in q's type.  Types: float32 or
// bfloat16 in, float32 accumulation.  dh is 32, 64, 128 or 256; G = Hq / Hkv
// is at most 16.
//
// Design.  One block of 8 warps per (batch row, KV head, part of the
// group); it computes up to GB query heads of the group, so each K / V row
// is read from device memory once for GB heads.  GB is 8, and 4 at dh =
// 256, where 8 heads would need 128 floats of q and accumulator a lane and
// 64 KB of shared memory for the merge (the 48 KB static limit); a group
// of 16 (recurrentgemma's MQA) takes 2 blocks at dh <= 128 and 4 at 256.  Lane l of a warp holds dims [l·E, l·E + E) of q, of
// the K / V rows and of the output accumulators (E = dh / 32), so a warp
// reads a whole row in one coalesced load.  Warp w takes the keys
// [4w, 4w + 4), [4w + 32, 4w + 36), ...: it loads four K and four V rows,
// reduces the four dot products across its lanes with shuffles, and keeps
// its own online softmax (running max m, sum l, accumulator acc) in f32.
// In bf16, p is rounded to bf16 before the P·V product, as the Pallas
// kernel does (p.astype(v.dtype)).  At the end the eight warps' states are
// merged through shared memory: out = Σ acc_w e^(m_w − M) / Σ l_w e^(m_w − M).
//
// What bounds it.  Bytes: each of the Σ lengths · Hkv K and V rows is read
// once (G query heads share it), about 4 dh bytes per key and head in bf16
// against 4 G dh flops, far below the card's ~295 flops a byte.  One block
// per (row, KV head) gives only B · Hkv blocks, fewer than the 132 SMs at
// small batch, and each block walks its row alone; splitting one long row
// over several blocks with a second merging pass (flash-decoding) is the
// next step for speed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int U = 4;  // keys a warp takes per step

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

// x rounded to T and back: what the P·V product of the Pallas kernel sees
template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

// E consecutive elements of T at p as floats; p is aligned to the load
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[E]) {
  constexpr int BYTES = E * (int)sizeof(T);
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_f(t[i]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_f(t[i]);
  } else if constexpr (BYTES == 4) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_f(t[i]);
  } else {
    static_assert(BYTES == 2, "unsupported load width");
    const unsigned short w = __ldg(reinterpret_cast<const unsigned short*>(p));
    out[0] = to_f(*reinterpret_cast<const T*>(&w));
  }
}

template <typename T, int E, int MAXG>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int Sk, int Hq, int Hkv, int Gfull, int parts,
                        float scale) {
  constexpr int DH = 32 * E;
  __shared__ float sm_m[WARPS][MAXG];
  __shared__ float sm_l[WARPS][MAXG];
  __shared__ float sm_acc[WARPS][MAXG][DH];

  const int part = blockIdx.x % parts;
  const int b = blockIdx.x / parts / Hkv;
  const int h = blockIdx.x / parts % Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = max(0, min(lengths[b], Sk));
  // this block's query heads: h · Gfull + g0 + [0, G)
  const int g0 = part * MAXG;
  const int G = min(MAXG, Gfull - g0);
  const size_t qh0 = (size_t)b * Hq + (size_t)h * Gfull + g0;

  float qr[MAXG][E];
  float m[MAXG], l[MAXG], acc[MAXG][E];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] = 0.f;
      acc[g][e] = 0.f;
    }
    if (g < G)
      load_vec<T, E>(q + (qh0 + g) * DH + lane * E, qr[g]);
  }

  const size_t row = (size_t)Hkv * DH;  // stride between keys
  const size_t base = ((size_t)b * Sk * Hkv + h) * DH + lane * E;
  for (int j0 = warp * U; j0 < len; j0 += WARPS * U) {
    float kf[U][E], vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < len) {
        load_vec<T, E>(k + base + (size_t)(j0 + u) * row, kf[u]);
        load_vec<T, E>(v + base + (size_t)(j0 + u) * row, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], kf[u][e], d);
        s[u] = d;
      }
      // butterfly: every lane ends with the same sums
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(FULL, s[u], off);
      }
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = (j0 + u < len) ? s[u] * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = (m[g] <= NEG_INF / 2) ? 0.f : expf(m[g] - m_new);
      float psum = 0.f;
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = (m_new <= NEG_INF / 2) ? 0.f : expf(s[u] - m_new);
        psum += p[u];
        p[u] = round_as<T>(p[u]);
      }
      l[g] = alpha * l[g] + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float pv = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) pv = fmaf(p[u], vf[u][e], pv);
        acc[g][e] = fmaf(acc[g][e], alpha, pv);
      }
      m[g] = m_new;
    }
  }

  // merge the warps' online-softmax states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int g = idx / DH, d = idx % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = sm_m[w][g];
      const float c = (mw <= NEG_INF / 2) ? 0.f : expf(mw - M);
      L += c * sm_l[w][g];
      O += c * sm_acc[w][g][d];
    }
    out[(qh0 + g) * DH + d] = from_f<T>(O / (L == 0.f ? 1.f : L));
  }
}

template <typename T, int E, int MAXG>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int Hq, int Hkv, int Sk, float scale,
           cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int parts = (G + MAXG - 1) / MAXG;
  decode_attention_kernel<T, E, MAXG>
      <<<B * Hkv * parts, WARPS * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lengths, static_cast<T*>(out), Sk, Hq,
          Hkv, G, parts, scale);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_g(const void* q, const void* k, const void* v, const int* lengths,
             void* out, int B, int Hq, int Hkv, int Sk, float scale,
             cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G <= 1) return launch<T, E, 1>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
  if (G <= 2) return launch<T, E, 2>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
  if (G <= 4) return launch<T, E, 4>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
  // at dh = 256 a block takes at most 4 heads (8 would need 64 KB of
  // shared memory for the merge)
  if constexpr (E > 4)
    return launch<T, E, 4>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
  else
    return launch<T, E, 8>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
}

template <typename T>
int launch_e(const void* q, const void* k, const void* v, const int* lengths,
             void* out, int B, int Hq, int Hkv, int Sk, int dh, float scale,
             cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_g<T, 1>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
    case 64: return launch_g<T, 2>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
    case 128: return launch_g<T, 4>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
    case 256: return launch_g<T, 8>(q, k, v, lengths, out, B, Hq, Hkv, Sk, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the decode attention of B rows on `stream`.  dtype: 0 float32,
// 1 bfloat16.  Pointers are device pointers aligned to 16 bytes.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* out, int B, int Hq, int Hkv,
                                       int Sk, int dh, float scale, int dtype,
                                       void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || Sk < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_e<float>(q, k, v, lengths, out, B, Hq, Hkv, Sk, dh, scale, s);
  if (dtype == 1)
    return launch_e<__nv_bfloat16>(q, k, v, lengths, out, B, Hq, Hkv, Sk, dh,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
