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
// What bounds it.  Bytes: each of the Σ lengths · Hkv K and V rows is read
// once (G query heads share it), about 4 dh bytes per key and head in bf16
// against 4 G dh flops, far below the card's ~295 flops a byte.  To stream
// those bytes at the card's rate, enough loads must be in flight on every
// SM: one block per (row, KV head) gives only B · Hkv blocks (64 at a
// batch of 8 rows over 8 KV heads, 4 for one row of recurrentgemma's MQA),
// most of the 132 SMs idle.
//
// Design.  Flash-decoding: a row's keys are split into n_split chunks of C
// keys, and block (split s, batch row, KV head, part of the group) walks
// keys [s C, min((s + 1) C, lengths[b])).  It computes up to GB query heads
// of the group, so each K / V row is read from device memory once for GB
// heads.  GB is 8, and 4 at dh = 256, where 8 heads would need 128 floats
// of q and accumulator a lane and 64 KB of shared memory for the merge
// (the 48 KB static limit); a group of 16 (recurrentgemma's MQA) takes 2
// blocks at dh <= 128 and 4 at 256.  Lane l of a warp holds dims
// [l·E, l·E + E) of q, of the K / V rows and of the output accumulators
// (E = dh / 32), so a warp reads a whole row in one coalesced load.  Warp w
// takes the keys [4w, 4w + 4), [4w + 32, 4w + 36), ... of the chunk: it
// loads four K and four V rows and reduces the four dot products across its
// lanes so that each group of 8 lanes ends with one key's score (9
// shuffles, where a butterfly for each key took 20); the softmax step then
// takes one exp a lane, and 4 shuffles hand every lane the four p.  Each
// warp keeps its own online softmax (running max m, sum l, accumulator acc)
// in f32.  In bf16, p is rounded to bf16 before the P·V
// product, as the Pallas kernel does (p.astype(v.dtype)).  The eight warps'
// states are merged through shared memory: M = max m_w, L = Σ l_w e^(m_w −
// M), O = Σ acc_w e^(m_w − M).  With one split the block writes O / L to
// out.  With several it writes (O, M, L) in float32 to a scratch the
// wrapper allocates, a split that starts at or past its row's length exits
// at once, and a second kernel merges a row's splits the same way (a row of
// length 0 gives 0).  The wrapper picks n_split and C on the host from Sk
// and the grid alone, never from lengths (reading them would synchronise
// every decode step): enough splits to fill the card, C a multiple of the
// warps' key stride, and one split, one launch and no scratch for a short
// cache, as in the serving caches.
//
// Build report (-Xptxas=-v, sm_90a, nvcc 12.9): the blocks the served
// models launch, bf16 with 2 heads of 128 (qwen3_1_7b) and 4 of 256
// (recurrentgemma_9b), use 76 and 171 registers, no spills; with 8 heads a
// block (groups above 4) at dh 128 and 64 ptxas keeps 128 / 80 registers
// and spills 4 bytes (16 in float32); the merge kernel 40 registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int U = 4;  // keys a warp takes per step
constexpr int KL = 32 / U;  // lanes that end a step holding one key's score
// the merge keeps 2 floats a split in shared memory, within 48 KB
constexpr int MAX_SPLIT = 6144;

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

// The U keys' dot products, each a sum over the warp's lanes of their
// partial sums s[u], reduced so that every lane ends with one whole score:
// that of key lane / KL.  At offsets 16, 8, ... each lane keeps half of its
// keys and adds its partner's partial sums of them (3 shuffles for U = 4),
// then the KL lanes that share a key sum within their group (3 more), in
// place of a full butterfly for each key (20).
__device__ __forceinline__ float reduce_keys(float (&s)[U], int lane) {
#pragma unroll
  for (int n = U, off = 16; n > 1; n /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = upper ? s[i + n / 2] : s[i];
      const float send = upper ? s[i] : s[i + n / 2];
      s[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  float v = s[0];
#pragma unroll
  for (int off = KL / 2; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  return v;
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

// The keys [split · chunk, min((split + 1) · chunk, len)) of one row; the
// split is blockIdx.y of gridDim.y.  With one split, out = O / L; with
// several, (O, M, L) of each head go to scratch (B, n_split, Hq, dh + 2).
template <typename T, int E, int MAXG>
__global__ void __launch_bounds__(WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ scratch, int Sk, int Hq, int Hkv,
                        int Gfull, int parts, int chunk, float scale) {
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
  const int split = blockIdx.y, n_split = gridDim.y;
  const int j_begin = split * chunk;
  if (n_split > 1 && j_begin >= len) return;  // the merge skips this split
  const int j_end = min(len, j_begin + chunk);
  // this block's query heads: h · Gfull + g0 + [0, G)
  const int g0 = part * MAXG;
  const int G = min(MAXG, Gfull - g0);
  const int qh_in_row0 = h * Gfull + g0;
  const size_t qh0 = (size_t)b * Hq + qh_in_row0;

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
  for (int j0 = j_begin + warp * U; j0 < j_end; j0 += WARPS * U) {
    float kf[U][E], vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u < j_end) {
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
      // lane l ends with the score of key j0 + l / KL
      const float dot = reduce_keys(s, lane);
      const float x = j0 + lane / KL < j_end ? dot * scale : NEG_INF;
      float mx = x;
#pragma unroll
      for (int off = KL; off < 32; off *= 2)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = (m[g] <= NEG_INF / 2) ? 0.f : expf(m[g] - m_new);
      const float pe = (m_new <= NEG_INF / 2) ? 0.f : expf(x - m_new);
      float psum = pe;
#pragma unroll
      for (int off = KL; off < 32; off *= 2)
        psum += __shfl_xor_sync(FULL, psum, off);
      l[g] = alpha * l[g] + psum;
      // every lane needs each key's p, rounded as the P·V product sees it
      const float pr = round_as<T>(pe);
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] = __shfl_sync(FULL, pr, u * KL);
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
    if (n_split == 1) {
      out[(qh0 + g) * DH + d] = from_f<T>(O / (L == 0.f ? 1.f : L));
    } else {
      float* dst = scratch + ((size_t)(b * n_split + split) * Hq + qh_in_row0 + g) * (DH + 2);
      dst[d] = O;
      if (d == 0) {
        dst[DH] = M;
        dst[DH + 1] = L;
      }
    }
  }
}

// out[b, h] from the splits of row b that hold keys: M = max M_s,
// out = Σ O_s e^(M_s − M) / Σ L_s e^(M_s − M), 0 for a row of length 0.
// One block of dh threads per (row, query head): the splits' M_s and L_s
// are read in parallel into shared memory (2 n_split floats), their
// weights formed there, and each thread sums its dim over the splits with
// several loads in flight.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ scratch,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int Sk, int Hq,
                                    int n_split, int chunk) {
  extern __shared__ float sm[];
  float* weight = sm;             // M_s, then e^(M_s − M)
  float* lw = sm + n_split;       // L_s e^(M_s − M)
  __shared__ float sm_max, sm_sum;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, d = threadIdx.x;
  const int dh = blockDim.x;
  const int len = max(0, min(lengths[b], Sk));
  const int live = min(n_split, (len + chunk - 1) / chunk);
  const float* src = scratch + ((size_t)b * n_split * Hq + h) * (dh + 2);
  const size_t step = (size_t)Hq * (dh + 2);  // from split s to s + 1
  for (int s = d; s < live; s += dh) {
    weight[s] = src[s * step + dh];
    lw[s] = src[s * step + dh + 1];
  }
  __syncthreads();
  if (d == 0) {
    float M = NEG_INF;
    for (int s = 0; s < live; ++s) M = fmaxf(M, weight[s]);
    sm_max = M;
  }
  __syncthreads();
  for (int s = d; s < live; s += dh) {
    const float ms = weight[s];
    weight[s] = (ms <= NEG_INF / 2) ? 0.f : expf(ms - sm_max);
    lw[s] *= weight[s];
  }
  __syncthreads();
  if (d == 0) {
    float L = 0.f;
    for (int s = 0; s < live; ++s) L += lw[s];
    sm_sum = L;
  }
  float O = 0.f;
#pragma unroll 8
  for (int s = 0; s < live; ++s) O += weight[s] * src[s * step + d];
  __syncthreads();
  const float L = sm_sum;
  out[((size_t)b * Hq + h) * dh + d] = from_f<T>(O / (L == 0.f ? 1.f : L));
}

template <typename T, int E, int MAXG>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* scratch, int B, int Hq, int Hkv, int Sk,
           int n_split, int chunk, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int parts = (G + MAXG - 1) / MAXG;
  const dim3 grid(B * Hkv * parts, n_split);
  decode_attention_kernel<T, E, MAXG><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), scratch, Sk, Hq,
      Hkv, G, parts, chunk, scale);
  if (n_split > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_merge_kernel<T><<<B * Hq, 32 * E, 2 * n_split * sizeof(float),
                             stream>>>(
        scratch, lengths, static_cast<T*>(out), Sk, Hq, n_split, chunk);
  }
  return (int)cudaGetLastError();
}

// the heads a block takes (MAXG), by group size and dh
template <typename T, int E>
int launch_g(const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* scratch, int B, int Hq, int Hkv, int Sk,
             int n_split, int chunk, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G <= 1) return launch<T, E, 1>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
  if (G <= 2) return launch<T, E, 2>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
  if (G <= 4) return launch<T, E, 4>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
  // at dh = 256 a block takes at most 4 heads (8 would need 64 KB of
  // shared memory for the merge)
  if constexpr (E > 4)
    return launch<T, E, 4>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
  else
    return launch<T, E, 8>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
}

template <typename T>
int launch_e(const void* q, const void* k, const void* v, const int* lengths,
             void* out, float* scratch, int B, int Hq, int Hkv, int Sk, int dh,
             int n_split, int chunk, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_g<T, 1>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
    case 64: return launch_g<T, 2>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
    case 128: return launch_g<T, 4>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
    case 256: return launch_g<T, 8>(q, k, v, lengths, out, scratch, B, Hq, Hkv, Sk, n_split, chunk, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the decode attention of B rows on `stream`.  dtype: 0 float32,
// 1 bfloat16.  Pointers are device pointers aligned to 16 bytes.  n_split
// (at most MAX_SPLIT) chunks of `chunk` keys: with n_split = 1 one kernel
// writes out (scratch may be null, chunk >= Sk); with more, scratch points
// to B · n_split · Hq · (dh + 2) floats and a second kernel merges the
// splits into out.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* out, void* scratch, int B, int Hq,
                                       int Hkv, int Sk, int dh, int n_split,
                                       int chunk, float scale, int dtype,
                                       void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || Sk < 0 || n_split < 1 ||
      n_split > MAX_SPLIT || chunk < 1 || (long long)n_split * chunk < Sk ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_e<float>(q, k, v, lengths, out, part, B, Hq, Hkv, Sk, dh,
                           n_split, chunk, scale, s);
  if (dtype == 1)
    return launch_e<__nv_bfloat16>(q, k, v, lengths, out, part, B, Hq,
                                   Hkv, Sk, dh, n_split, chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}
