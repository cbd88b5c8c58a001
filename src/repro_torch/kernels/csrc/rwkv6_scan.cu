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
// float32 first), on the CUDA cores: TF32 or bf16 tensor cores would not
// hold the float32 tolerance.  Sums use fused multiply-adds (fmaf), in
// another order than the plain PyTorch version,
// repro_torch/kernels/rwkv6_scan.py::rwkv6_scan_ref.
//
// Layout: r, k, v, out (B, S, H, dh) in float32 or bfloat16; w (B, S, H,
// dh), s0 and sT (B, H, dh, dh) in float32; u (H, dh) in float32 or r's
// type; all contiguous.  dh is 16, 32, 64 or 128; any S >= 0 (S = 1 is a
// decode step).
//
// What bounds it.  Operations: the function needs 5 dh² + 5 dh float32
// flops per head and step: 3 dh² for the update diag(w) S + k vᵀ, 2 dh² for
// r · S, and the bonus r · diag(u) k vᵀ = (Σ_i r_i u_i k_i) v, one dot
// product (3 dh) scaled by v and added (2 dh).  At B = 1, S = 4,096,
// H = 40, dh = 64 that is 3.4 GFLOP, ~0.05 ms at 67 TFLOP/s, against ~126
// MB of r, k, v, w and out (~0.038 ms).  A step-by-step scan has only B · H
// independent chains (40 at B = 1), each a dependent sum of dh terms a
// step; the design below cuts time into chunks so that the card has
// B · H · S / C blocks of dense work.
//
// Design, two paths chosen by the launcher (rwkv6_scan.DIRECT_MAX_S):
// - Direct (a decode step, a short prompt).  A block owns 16 columns of one
//   (b, head)'s state, so 40 heads give 160 blocks (dh = 64); 4 lanes share
//   a column, each holding dh / 4 of its rows in registers, and reduce
//   r · S by two shuffles.  The bonus is the dot product Σ_i r_i u_i k_i
//   (r_i u_i k_i formed once a step as the step is staged), not dh² work.
//   Every load a step needs, u included, is issued before its first use,
//   so a decode step waits for one round trip to memory.
// - Chunked (prefill), C = 64 steps a chunk, three kernels:
//   A, one block per (b, chunk, head): D_c = Π_{τ∈c} w_τ and
//     K_c = Σ_{s∈c} (k_s ⊙ Π_{τ∈c, τ>s} w_τ) v_sᵀ (dh × dh), the decays by
//     a running product backwards over the chunk;
//   B, one thread per (b, head, i) and 4 columns j, sequential over the
//     chunks: S_{c+1} = D_c[i] S_c + K_c, each chunk's start state S_c
//     written over K_c in the scratch buffer, and sT;
//   C, one block per (b, chunk, head):
//     out_t = (r_t ⊙ P_t) · S_c + Σ_{s<t} A[t, s] v_s + (Σ_i r_t u k_t) v_t,
//     P_t = Π_{τ∈c, τ<t} w_τ (a running product forwards) and
//     A[t, s] = Σ_i r_t[i] k_s[i] Π_{s<τ<t} w_τ[i], reached for each s by a
//     running product over t (lanes of a group share one s, and each
//     group takes s and C − 1 − s so the triangle is shared evenly); the
//     bonus is A's diagonal; then one (C × dh)(dh × dh) and one
//     (C × C)(C × dh) product, 4 × 4 outputs a thread, from shared memory.
//   A block keeps r, k, v, w, S_c and Aᵀ in shared memory (108 KB at
//   dh = 64: two blocks an SM).  Decays are only ever multiplied, never
//   divided: w may be 0, denormal or 1, and a ratio of prefix products
//   gives 0/0 or ∞.  Pass C takes most of the time: its triangle reads
//   r_t and w_t from shared memory once per (s, t) pair.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// u[idx] as float: u is float32 (u_f32) or of the type T of r, k, v
template <typename T>
__device__ __forceinline__ float load_u(const void* u, bool u_f32, int idx) {
  return u_f32 ? static_cast<const float*>(u)[idx]
               : to_f(static_cast<const T*>(u)[idx]);
}

// ---- direct ---------------------------------------------------------------

constexpr int DJ = 16;       // columns of the state a block
constexpr int DP = 4;        // lanes sharing a column
constexpr int DT = DJ * DP;  // threads a block
constexpr int DCH = 16;      // time steps staged at a time

template <typename T, int DH>
__global__ void __launch_bounds__(DT)
rwkv6_direct(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const void* __restrict__ u, bool u_f32,
             const float* __restrict__ s0, T* __restrict__ out,
             float* __restrict__ sT, int S, int H) {
  constexpr int NJ = DH / DJ;   // blocks a head
  constexpr int RPT = DH / DP;  // rows of the column a lane holds
  __shared__ float sr[DCH][DH], sk[DCH][DH], sw[DCH][DH], sb[DCH][DH];
  __shared__ float sv[DCH][DJ];

  const int jg = blockIdx.x % NJ;
  const int bh = blockIdx.x / NJ;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int p = tid % DP, jl = tid / DP, j = jg * DJ + jl;

  // st[ii] = S[ii * DP + p][j]: the 4 lanes of a column read 4 neighbouring
  // rows of shared memory at once, no bank conflict
  const size_t sbase = (size_t)bh * DH * DH + j;
  float st[RPT];
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii)
    st[ii] = s0[sbase + (size_t)(ii * DP + p) * DH];

  const size_t row = (size_t)H * DH;  // stride between time steps
  const size_t base = ((size_t)b * S * H + h) * DH;
  for (int t0 = 0; t0 < S; t0 += DCH) {
    const int n = min(DCH, S - t0);
    __syncthreads();  // the previous steps are no longer read
    // u is read here, with r, k and w, so that a decode step waits for
    // one round trip to memory before it computes
    for (int q = tid; q < n * DH; q += DT) {
      const int c = q / DH, i = q % DH;
      const size_t at = base + (size_t)(t0 + c) * row + i;
      const float rv = to_f(r[at]), kv = to_f(k[at]);
      sr[c][i] = rv;
      sk[c][i] = kv;
      sw[c][i] = w[at];
      sb[c][i] = rv * load_u<T>(u, u_f32, h * DH + i) * kv;
    }
    for (int q = tid; q < n * DJ; q += DT) {
      const int c = q / DJ, jj = q % DJ;
      sv[c][jj] = to_f(v[base + (size_t)(t0 + c) * row + jg * DJ + jj]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][jl];
      float acc = 0.f, dd = 0.f;
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii) {
        const int i = ii * DP + p;
        acc = fmaf(sr[c][i], st[ii], acc);
        dd += sb[c][i];
        st[ii] = fmaf(sw[c][i], st[ii], sk[c][i] * vj);
      }
#pragma unroll
      for (int o = 1; o < DP; o *= 2) {
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
        dd += __shfl_xor_sync(0xffffffffu, dd, o);
      }
      if (p == 0)
        out[base + (size_t)(t0 + c) * row + j] = from_f<T>(fmaf(dd, vj, acc));
    }
  }
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii)
    sT[sbase + (size_t)(ii * DP + p) * DH] = st[ii];
}

// ---- chunked --------------------------------------------------------------

constexpr int NT = 256;     // threads of a chunk block (passes A and C)
constexpr int CHUNK = 64;   // time steps a chunk (rwkv6_scan.CHUNK)

template <int DH, int C> struct Chunk {
  static constexpr int IP = NT / (C / 2);  // lanes sharing one s of A
  static constexpr int LD = DH + IP;       // row of a staged (C, dh) array
  static constexpr int LDT = C + 4;        // row of (dh, C) rP^T and (C, C) A^T
  // floats of shared memory: pass A k, v, w; pass C r, k, v, w, S_c, A^T, u
  static constexpr int SMEM_A = 3 * C * LD;
  static constexpr int SMEM_C = 4 * C * LD + DH * DH + C * LDT + DH;
  static_assert(DH * LDT <= C * LD, "rP^T must fit where k was");
  static_assert(IP >= 1 && IP <= 32 && (IP & (IP - 1)) == 0, "lane groups");
};

// Rows t in [0, C) of one chunk of x into xs (row stride LD), rows past the
// sequence (t >= n) as `fill`.  Every load of a thread is issued before its
// first store (C · dh / NT of them), 4 elements a load where the pointers
// allow (`vec`).
template <typename T, int DH, int LD, int C>
__device__ __forceinline__ void stage(float* xs, const T* x, size_t base,
                                      size_t row, int n, float fill,
                                      bool vec) {
  constexpr int PER = C * DH / NT;
  static_assert(PER * NT == C * DH, "whole rows a block");
  float val[PER];
  if (PER % 4 == 0 && vec) {
    using V = typename std::conditional<sizeof(T) == 4, float4, uint2>::type;
#pragma unroll
    for (int e = 0; e < PER / 4; ++e) {
      const int q = (threadIdx.x + e * NT) * 4, t = q / DH, i = q % DH;
      if (t < n) {
        const V raw =
            *reinterpret_cast<const V*>(x + base + (size_t)t * row + i);
        const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int z = 0; z < 4; ++z) val[4 * e + z] = to_f(el[z]);
      } else {
#pragma unroll
        for (int z = 0; z < 4; ++z) val[4 * e + z] = fill;
      }
    }
#pragma unroll
    for (int e = 0; e < PER / 4; ++e) {
      const int q = (threadIdx.x + e * NT) * 4, t = q / DH, i = q % DH;
      *reinterpret_cast<float4*>(xs + t * LD + i) = make_float4(
          val[4 * e], val[4 * e + 1], val[4 * e + 2], val[4 * e + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int q = threadIdx.x + e * NT, t = q / DH, i = q % DH;
      val[e] = t < n ? to_f(x[base + (size_t)t * row + i]) : fill;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int q = threadIdx.x + e * NT, t = q / DH, i = q % DH;
      xs[t * LD + i] = val[e];
    }
  }
}

// Pass A: D_c and K_c of one (b, chunk, head); block x = (b * nC + c) * H
// + h, the index of (b, c, h) in the scratch buffers.
template <typename T, int DH, int C>
__global__ void __launch_bounds__(NT)
rwkv6_chunk_a(const T* __restrict__ k, const T* __restrict__ v,
              const float* __restrict__ w, float* __restrict__ kstate,
              float* __restrict__ decay, int S, int H, int nC, bool vec) {
  using Sh = Chunk<DH, C>;
  constexpr int LD = Sh::LD;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;          // [C][LD], then k ⊙ suffix decay
  float* sv = sk + C * LD;   // [C][LD]
  float* sw = sv + C * LD;   // [C][LD]

  const int x = blockIdx.x;
  const int h = x % H, c = (x / H) % nC, b = x / (H * nC);
  const int n = min(C, S - c * C);
  const size_t row = (size_t)H * DH;
  const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * DH;
  stage<T, DH, LD, C>(sk, k, base, row, n, 0.f, vec);
  stage<T, DH, LD, C>(sv, v, base, row, n, 0.f, vec);
  stage<float, DH, LD, C>(sw, w, base, row, n, 1.f, vec);
  __syncthreads();
  if (threadIdx.x < DH) {
    const int i = threadIdx.x;
    float g = 1.f;  // Π_{τ>s} w_τ[i]
#pragma unroll 8
    for (int s = n - 1; s >= 0; --s) {
      sk[s * LD + i] *= g;
      g *= sw[s * LD + i];
    }
    decay[(size_t)x * DH + i] = g;
  }
  __syncthreads();
  constexpr int Q = DH / 4;
  float* kx = kstate + (size_t)x * DH * DH;
  for (int tile = threadIdx.x; tile < Q * Q; tile += NT) {
    const int i0 = (tile / Q) * 4, j0 = (tile % Q) * 4;
    float acc[4][4] = {};
    for (int s = 0; s < n; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(sk + s * LD + i0);
      const float4 bv = *reinterpret_cast<const float4*>(sv + s * LD + j0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[y][z] = fmaf(av[y], bb[z], acc[y][z]);
    }
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<float4*>(kx + (i0 + y) * DH + j0) =
          make_float4(acc[y][0], acc[y][1], acc[y][2], acc[y][3]);
  }
}

// Pass B: the chunks' start states, in place of K_c, and sT.  One thread
// per (b, head, i) and V neighbouring j (V = 4 where s0 and sT allow 16-byte
// access); the loads of U chunks issued before their updates.
template <int V>
__global__ void __launch_bounds__(256)
rwkv6_chunk_b(const float* __restrict__ s0, float* __restrict__ kstate,
              const float* __restrict__ decay, float* __restrict__ sT, int B,
              int H, int dh, int nC) {
  using F = typename std::conditional<V == 4, float4, float>::type;
  constexpr int U = 16;
  const size_t hdd = (size_t)H * dh * dh / V;  // F's of one row's states
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)B * hdd) return;
  const size_t b = e / hdd, rem = e % hdd;
  const size_t hi = rem * V / dh;  // h * dh + i
  const F* kin = reinterpret_cast<const F*>(kstate);
  F* kout = reinterpret_cast<F*>(kstate);
  F st = reinterpret_cast<const F*>(s0)[e];
  for (int c0 = 0; c0 < nC; c0 += U) {
    F kv[U];
    float dv[U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (c0 + q < nC) {
        const size_t bc = b * nC + c0 + q;
        kv[q] = kin[bc * hdd + rem];
        dv[q] = decay[bc * H * dh + hi];
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (c0 + q < nC) {
        kout[(b * nC + c0 + q) * hdd + rem] = st;
        if constexpr (V == 4) {
          st.x = fmaf(dv[q], st.x, kv[q].x);
          st.y = fmaf(dv[q], st.y, kv[q].y);
          st.z = fmaf(dv[q], st.z, kv[q].z);
          st.w = fmaf(dv[q], st.w, kv[q].w);
        } else {
          st = fmaf(dv[q], st, kv[q]);
        }
      }
    }
  }
  reinterpret_cast<F*>(sT)[e] = st;
}

// Pass C: the outputs of one (b, chunk, head) from its start state.
template <typename T, int DH, int C>
__global__ void __launch_bounds__(NT)
rwkv6_chunk_c(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const void* __restrict__ u, bool u_f32,
              const float* __restrict__ kstate, T* __restrict__ out, int S,
              int H, int nC, bool vec) {
  using Sh = Chunk<DH, C>;
  constexpr int LD = Sh::LD, LDT = Sh::LDT, IP = Sh::IP;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;             // [C][LD]
  float* sk = sr + C * LD;      // [C][LD]; then rP^T [DH][LDT]
  float* sv = sk + C * LD;      // [C][LD]
  float* sw = sv + C * LD;      // [C][LD]
  float* ss = sw + C * LD;      // [DH][DH] S_c
  float* sat = ss + DH * DH;    // [C][LDT] A^T: sat[s][t] = A[t][s]
  float* su = sat + C * LDT;    // [DH]
  float* rpt = sk;

  const int x = blockIdx.x;
  const int h = x % H, c = (x / H) % nC, b = x / (H * nC);
  const int n = min(C, S - c * C);
  const size_t row = (size_t)H * DH;
  const size_t base = (((size_t)b * S + (size_t)c * C) * H + h) * DH;
  const int tid = threadIdx.x;
  stage<T, DH, LD, C>(sr, r, base, row, n, 0.f, vec);
  stage<T, DH, LD, C>(sk, k, base, row, n, 0.f, vec);
  stage<T, DH, LD, C>(sv, v, base, row, n, 0.f, vec);
  stage<float, DH, LD, C>(sw, w, base, row, n, 1.f, vec);
  const float4* sc = reinterpret_cast<const float4*>(kstate +
                                                     (size_t)x * DH * DH);
  for (int q = tid; q < DH * DH / 4; q += NT)
    reinterpret_cast<float4*>(ss)[q] = sc[q];
  for (int q = tid; q < C * LDT; q += NT) sat[q] = 0.f;
  for (int i = tid; i < DH; i += NT) su[i] = load_u<T>(u, u_f32, h * DH + i);
  __syncthreads();

  // A^T, lower triangle and diagonal.  A group of IP lanes shares one s
  // and splits i (lane `part` owns i = ii * IP + part; the row pad LD =
  // DH + IP puts the 32 / IP groups of a warp on distinct banks); each
  // group takes s and then C − 1 − s.
  {
    constexpr int RPT = DH / IP;
    const int part = tid % IP, pair = tid / IP;
    const int lane = tid % 32;
    const unsigned gmask = (IP == 32) ? 0xffffffffu
        : (((1u << IP) - 1u) << (lane & ~(IP - 1)));
    for (int half = 0; half < 2; ++half) {
      const int s = half == 0 ? pair : C - 1 - pair;
      if (s >= n) continue;  // the whole group skips together
      float q[RPT];
      float bonus = 0.f;
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii) {
        const int i = ii * IP + part;
        q[ii] = sk[s * LD + i];
        bonus = fmaf(sr[s * LD + i] * su[i], q[ii], bonus);
      }
#pragma unroll
      for (int o = IP / 2; o >= 1; o /= 2)
        bonus += __shfl_xor_sync(gmask, bonus, o);
      if (part == 0) sat[s * LDT + s] = bonus;
      // four t at a time, so that their reductions overlap
      for (int t = s + 1; t < n; t += 4) {
        float a[4] = {};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (t + x < n) {
            // q = k_s ⊙ Π_{s<τ<t+x} w_τ
#pragma unroll
            for (int ii = 0; ii < RPT; ++ii) {
              const int i = ii * IP + part;
              a[x] = fmaf(sr[(t + x) * LD + i], q[ii], a[x]);
              q[ii] *= sw[(t + x) * LD + i];
            }
          }
        }
#pragma unroll
        for (int o = IP / 2; o >= 1; o /= 2)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[x] += __shfl_xor_sync(gmask, a[x], o);
        if (part == 0)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (t + x < n) sat[s * LDT + t + x] = a[x];
      }
    }
  }
  __syncthreads();  // k no longer read: rP^T goes where it was

  if (tid < DH) {
    const int i = tid;
    float pr = 1.f;  // P_t[i] = Π_{τ<t} w_τ[i]
#pragma unroll 8
    for (int t = 0; t < C; ++t) {
      rpt[i * LDT + t] = sr[t * LD + i] * pr;
      pr *= sw[t * LD + i];
    }
  }
  __syncthreads();

  constexpr int QJ = DH / 4, QT = C / 4;
  for (int tile = tid; tile < QT * QJ; tile += NT) {
    const int t0 = (tile / QJ) * 4, j0 = (tile % QJ) * 4;
    if (t0 >= n) continue;
    float acc[4][4] = {};
    for (int i = 0; i < DH; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(rpt + i * LDT + t0);
      const float4 bv = *reinterpret_cast<const float4*>(ss + i * DH + j0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[y][z] = fmaf(av[y], bb[z], acc[y][z]);
    }
    const int s_end = min(t0 + 4, n);
    for (int s = 0; s < s_end; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(sat + s * LDT + t0);
      const float4 bv = *reinterpret_cast<const float4*>(sv + s * LD + j0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[y][z] = fmaf(av[y], bb[z], acc[y][z]);
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (t0 + y >= n) break;
      T* o = out + base + (size_t)(t0 + y) * row + j0;
#pragma unroll
      for (int z = 0; z < 4; ++z) o[z] = from_f<T>(acc[y][z]);
    }
  }
}

// What the launch functions pass on: device pointers and sizes.
struct Args {
  const void *r, *k, *v;
  const float* w;
  const void* u;
  bool u_f32;  // u is float32, else of r's type
  const float* s0;
  void* out;
  float *sT, *kstate, *decay;
  int B, S, H;
};

template <typename T, int DH>
int launch_direct(const Args& a, cudaStream_t stream) {
  const long long blocks = (long long)a.B * a.H * (DH / DJ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rwkv6_direct<T, DH><<<(unsigned)blocks, DT, 0, stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.w, a.u, a.u_f32, a.s0,
      static_cast<T*>(a.out), a.sT, a.S, a.H);
  return (int)cudaGetLastError();
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DH, int C>
int launch_chunked(const Args& a, cudaStream_t stream) {
  using Sh = Chunk<DH, C>;
  const int smem_a = Sh::SMEM_A * (int)sizeof(float);
  const int smem_c = Sh::SMEM_C * (int)sizeof(float);
  static bool attr = false;
  if (!attr) {
    int e = allow_smem(rwkv6_chunk_a<T, DH, C>, smem_a);
    if (e == 0) e = allow_smem(rwkv6_chunk_c<T, DH, C>, smem_c);
    if (e != 0) return e;
    attr = true;
  }
  const int nC = (a.S + C - 1) / C;
  const long long blocks = (long long)a.B * nC * a.H;
  // pass B: 4 columns a thread where s0 and sT allow 16-byte access
  const bool vec_b = ((reinterpret_cast<uintptr_t>(a.s0) |
                       reinterpret_cast<uintptr_t>(a.sT)) % 16) == 0;
  const long long threads_b =
      (long long)a.B * a.H * DH * DH / (vec_b ? 4 : 1);
  if (blocks > 0x7fffffffLL || (threads_b + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  // 4-element loads need every pointer aligned to 4 elements
  const bool vec = ((reinterpret_cast<uintptr_t>(r) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % (4 * sizeof(T)) |
                    reinterpret_cast<uintptr_t>(a.w) % 16) == 0;
  rwkv6_chunk_a<T, DH, C><<<(unsigned)blocks, NT, smem_a, stream>>>(
      k, v, a.w, a.kstate, a.decay, a.S, a.H, nC, vec);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const unsigned grid_b = (unsigned)((threads_b + 255) / 256);
  if (vec_b)
    rwkv6_chunk_b<4><<<grid_b, 256, 0, stream>>>(a.s0, a.kstate, a.decay,
                                                  a.sT, a.B, a.H, DH, nC);
  else
    rwkv6_chunk_b<1><<<grid_b, 256, 0, stream>>>(a.s0, a.kstate, a.decay,
                                                  a.sT, a.B, a.H, DH, nC);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  rwkv6_chunk_c<T, DH, C><<<(unsigned)blocks, NT, smem_c, stream>>>(
      r, k, v, a.w, a.u, a.u_f32, a.kstate, static_cast<T*>(a.out), a.S,
      a.H, nC, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int dh, int chunk, cudaStream_t stream) {
  if (chunk == 0) {
    switch (dh) {
      case 16: return launch_direct<T, 16>(a, stream);
      case 32: return launch_direct<T, 32>(a, stream);
      case 64: return launch_direct<T, 64>(a, stream);
      case 128: return launch_direct<T, 128>(a, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (chunk != CHUNK || a.S == 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_chunked<T, 16, CHUNK>(a, stream);
    case 32: return launch_chunked<T, 32, CHUNK>(a, stream);
    case 64: return launch_chunked<T, 64, CHUNK>(a, stream);
    case 128: return launch_chunked<T, 128, CHUNK>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the recurrence of B rows on `stream`.  chunk = 0 runs the
// direct kernel (kstate and decay unused); chunk = CHUNK (64) the three
// chunked passes, S > 0, with the scratch kstate (B, ⌈S / 64⌉, H, dh, dh)
// and decay (B, ⌈S / 64⌉, H, dh), float32, both overwritten.  dtype (of r,
// k, v, out) and u_dtype (of u: dtype or 0): 0 float32, 1 bfloat16.
// Pointers are device pointers.  Returns the first cudaGetLastError()
// after a launch that is not cudaSuccess, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* w, const void* u,
                                 const float* s0, void* out, float* sT,
                                 float* kstate, float* decay, int B, int S,
                                 int H, int dh, int chunk, int dtype,
                                 int u_dtype, void* stream) {
  if (B < 0 || S < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (u_dtype != 0 && u_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  const Args a{r, k, v, w, u, u_dtype == 0, s0, out, sT, kstate, decay,
               B, S, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, dh, chunk, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, dh, chunk, s);
  return (int)cudaErrorInvalidValue;
}
