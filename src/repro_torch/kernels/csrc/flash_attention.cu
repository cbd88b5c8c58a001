// Flash-attention forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention).  out = softmax(q·Kᵀ · scale + mask) · V
// with an online softmax over KV tiles.  Masks come from absolute
// positions, suffix-aligned as in the Pallas kernel: query i sits at
// position Sk − Sq + i, key j at j; causal keeps j <= q_pos, a window w > 0
// keeps q_pos − j < w, and both may be off (bidirectional).  GQA: query
// head h reads KV head h / G.  A query row with no key to attend to gives
// 0.  The plain PyTorch version is
// repro_torch/kernels/flash_attention.py::flash_attention_ref.
//
// Layout, as the JAX package passes it: q (B, Sq, Hq, dh), k / v (B, Sk,
// Hkv, dh), out (B, Sq, Hq, dh) in q's type.  float32 or bfloat16 in,
// float32 accumulation; dh is 32, 64, 128 or 256; any Sq and Sk.
//
// Design.  One block of 256 threads per (tile of 64 queries, query head,
// batch row).  Four threads share a query: thread `sub` holds dims
// 16 i + 4 sub + [0, 4) of q and of the output accumulator in registers, so
// each reads K / V rows from shared memory as float4, and the four lanes
// reading one row hit sixteen consecutive words (no bank conflict; the 8
// queries of a warp read the same words, a broadcast).  The block walks
// only the KV tiles its queries can see (causal and window bounds), BK keys
// a tile, staged in shared memory as float32 with 16-byte loads: BK = 32,
// and 16 at dh = 256, where two 32 × 256 float tiles (64 KB) would pass the
// 48 KB of static shared memory a block may have.  At dh = 256 a thread
// holds 64 floats of q and 64 of the accumulator in registers (the
// -Xptxas=-v report of the build shows whether they spill).  Scores of
// 8 keys at a time are reduced over the four lanes with two shuffles, then
// one online-softmax update (running max, sum, rescale of the accumulator)
// covers the 8 keys.  In bf16, p is rounded to bf16 before the P·V product
// (p.astype(v.dtype) in the Pallas kernel).  Masked scores are NEG_INF =
// -1e30 and a row whose running max is still NEG_INF adds nothing.
//
// What bounds it.  Operations: a causal prefill of S tokens does
// 4 · dh · Hq · S (S + 1) / 2 flops on (S + Sk) · dh bytes per head, far
// above the card's ~295 flops a byte, so the tensor cores' rate is the
// bound.  This version runs on the CUDA cores (float32 FMAs); wgmma tiles
// fed by TMA are the step that makes it fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;       // queries a block
constexpr int TPQ = 4;       // threads a query
constexpr int THREADS = BQ * TPQ;
constexpr int KC = 8;        // keys an online-softmax update

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

template <typename T> __device__ __forceinline__ float round_as(float x) {
  return to_f(from_f<T>(x));
}

// Rows [t0, t0 + BK) of one KV head into a float tile; rows past Sk are 0.
template <typename T, int DH, int BK>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      float (*dst)[DH], int t0, int Sk,
                                      size_t row) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements a 16-byte load
  constexpr int PER_ROW = DH / VEC;
  for (int idx = threadIdx.x; idx < BK * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    float vals[VEC];
    if (t0 + r < Sk) {
      const uint4 w =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)(t0 + r) * row + c));
      const T* t = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = to_f(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(&dst[r][c + i]) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, float scale, int causal,
                       int window) {
  constexpr int NI = DH / 16;       // float4 groups a thread holds
  // keys a shared-memory tile: K and V tiles in float32 stay within 32 KB
  constexpr int BK = DH <= 128 ? 32 : 16;
  __shared__ __align__(16) float Ks[BK][DH];
  __shared__ __align__(16) float Vs[BK][DH];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int sub = threadIdx.x % TPQ;
  const int qi = q0 + threadIdx.x / TPQ;
  const int q_offset = Sk - Sq;
  const int q_pos = q_offset + qi;

  float qr[NI][4], acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[i][c] = 0.f;
      qr[i][c] = qi < Sq
          ? to_f(q[(((size_t)b * Sq + qi) * Hq + h) * DH + 16 * i + 4 * sub + c])
          : 0.f;
    }
  float m = NEG_INF, l = 0.f;

  // the keys this block's queries can see
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Sq) - 1;
  int kv_begin = 0, kv_end = Sk;
  if (window > 0) kv_begin = max(0, q_lo - window + 1);
  if (causal) kv_end = min(Sk, q_hi + 1);

  const size_t row = (size_t)Hkv * DH;
  const T* kb = k + ((size_t)b * Sk * Hkv + kvh) * DH;
  const T* vb = v + ((size_t)b * Sk * Hkv + kvh) * DH;
  for (int t0 = (kv_begin / BK) * BK; t0 < kv_end; t0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    stage<T, DH, BK>(kb, Ks, t0, Sk, row);
    stage<T, DH, BK>(vb, Vs, t0, Sk, row);
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += KC) {
      float s[KC];
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float4 kk =
              *reinterpret_cast<const float4*>(&Ks[c0 + u][16 * i + 4 * sub]);
          d = fmaf(qr[i][0], kk.x, d);
          d = fmaf(qr[i][1], kk.y, d);
          d = fmaf(qr[i][2], kk.z, d);
          d = fmaf(qr[i][3], kk.w, d);
        }
        s[u] = d;
      }
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        s[u] += __shfl_xor_sync(FULL, s[u], 1);
        s[u] += __shfl_xor_sync(FULL, s[u], 2);
      }
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int kp = t0 + c0 + u;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= q_pos;
        if (window > 0) ok = ok && (q_pos - kp) < window;
        s[u] = ok ? s[u] * scale : NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = (m <= NEG_INF / 2) ? 0.f : expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const float p = (m_new <= NEG_INF / 2) ? 0.f : expf(s[u] - m_new);
        psum += p;
        s[u] = round_as<T>(p);
      }
      l = alpha * l + psum;
      m = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[c0 + u][16 * i + 4 * sub]);
          pv[0] = fmaf(s[u], vv.x, pv[0]);
          pv[1] = fmaf(s[u], vv.y, pv[1]);
          pv[2] = fmaf(s[u], vv.z, pv[2]);
          pv[3] = fmaf(s[u], vv.w, pv[3]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(acc[i][c], alpha, pv[c]);
      }
    }
  }

  if (qi < Sq) {
    const float denom = (l == 0.f) ? 1.f : l;
    T* o = out + (((size_t)b * Sq + qi) * Hq + h) * DH;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[16 * i + 4 * sub + c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int Hq, int Hkv, int dh, float scale,
              int causal, int window, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the attention of B rows on `stream`.  dtype: 0 float32,
// 1 bfloat16.  Pointers are device pointers aligned to 16 bytes; window <= 0
// means no window.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int Hq, int Hkv, int dh,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 || Sk < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Hq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, dh, scale,
                            causal, window, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, dh,
                                    scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
