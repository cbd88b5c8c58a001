// Batched base-pull cluster event scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/event_step.py::_event_kernel
// (launched by event_step_pallas).  It computes what that kernel and its
// oracle, repro/core/fastpath.py::_scan_cell_kernel, compute for the base
// pull configuration with or without FC counts: rows [:n] of start / finish
// / prio (float32) and node (int32), bit for bit.  The plain PyTorch version
// is repro_torch/kernels/event_step.py::event_step_ref.
//
// Design.  One block of one warp per cell.  The cell's carry -- the packed
// (clk, ctr) planes at the offsets of repro_torch/core/planes.py -- is
// copied into shared memory once and stays there for the whole scan.  A
// loop inside the block runs over the events (n_steps = 2 n): each step
// picks the next arrival or the earliest completion, updates the slots, the
// controller's runtime ring and the per-function arrival state, and lets
// the most-free invoker pull the best queue head.  The warp reduces over
// slots, nodes and queue heads with (value, index) shuffles that keep the
// first index on ties; lane 0 makes the scalar updates.  The loop ends as
// soon as no event is left, since the carry is then fixed.
//
// The TPU kernel's workarounds are gone: its one-hot gathers become indexed
// loads, and its O(n) count of t <= now - horizon becomes a binary search
// over the sorted arrival row (whose tail is +inf).
//
// What bounds it.  Not bytes and not operations: each cell is a serial
// chain of up to 2 n dependent steps, each a few dependent global loads and
// warp reductions long, so the kernel is bound by latency.  It needs
// thousands of cells in flight to fill the card's 132 SMs; the bucket
// runner sizes its chunks for that.
//
// Bit-identity: built with --fmad=false and without fast math, and every
// product and sum below uses the _rn intrinsics in the oracle's order.

#include <cuda_runtime.h>
#include <climits>
#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kLayout = 14;   // carry entries, see struct Layout
constexpr int kDims = 13;     // integer launch dimensions, see struct Dims

// Offsets of the carry entries: the first six in the clk plane, the rest
// in the ctr plane (the order of EVENT_STEP_LAYOUT in ops.py).
struct Layout {
  int chan, fin_s, last_t, prev_t, ring, rsum;
  int ai, busy, head, idx_s, narr, qn, rlen, rpos;
};

struct Dims {
  int B, n, n_nodes, n_slots, window, n_fns, kq, nc, ncoef, f_len, i_len,
      use_fc, n_steps;
};

// (value, index) minimum keeping the first index on ties, across the warp.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

// (value, index) maximum keeping the first index on ties, across the warp.
__device__ __forceinline__ void warp_argmax(int& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__global__ void __launch_bounds__(32) event_step_kernel(
    const float* __restrict__ clk, const int* __restrict__ ctr,
    const float* __restrict__ t, const int* __restrict__ fnid,
    const float* __restrict__ p, const float* __restrict__ cost,
    const float* __restrict__ coef, const int* __restrict__ cores_v,
    const int* __restrict__ nodes_v, const float* __restrict__ cumf,
    const int* __restrict__ fn_ev, float* __restrict__ start,
    float* __restrict__ finish, float* __restrict__ prio,
    int* __restrict__ node, const Layout L, const Dims D,
    const float horizon) {
  extern __shared__ float smem[];
  float* fpl = smem;                                  // clk plane
  int* ipl = reinterpret_cast<int*>(smem + D.f_len);  // ctr plane

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = D.n, n1 = D.n + 1;
  const int NN = D.n_nodes, NS = D.n_slots, NSL = D.n_nodes * D.n_slots;
  const int F = D.n_fns, W = D.window, kq = D.kq;

  for (int k = lane; k < D.f_len; k += 32)
    fpl[k] = clk[(size_t)b * D.f_len + k];
  for (int k = lane; k < D.i_len; k += 32)
    ipl[k] = ctr[(size_t)b * D.i_len + k];
  __syncwarp();

  float* chan = fpl + L.chan;
  float* fin_s = fpl + L.fin_s;
  float* last_t = fpl + L.last_t;
  float* prev_t = fpl + L.prev_t;
  float* ring = fpl + L.ring;
  float* rsum = fpl + L.rsum;
  int* ai_p = ipl + L.ai;
  int* busy = ipl + L.busy;
  int* head = ipl + L.head;
  int* idx_s = ipl + L.idx_s;
  int* narr = ipl + L.narr;
  int* qn = ipl + L.qn;
  int* rlen = ipl + L.rlen;
  int* rpos = ipl + L.rpos;

  const size_t row = (size_t)b * n1;
  const float* tb = t + row;
  const int* fb = fnid + row;
  const float* pb = p + row;
  const float* cb = cost + row;
  const float* cumf_b = cumf + (size_t)b * D.nc * F;
  const int* fnev_b = fn_ev + (size_t)b * F * kq;
  const float c0 = coef[b * D.ncoef + 0], c1 = coef[b * D.ncoef + 1];
  const float c2 = coef[b * D.ncoef + 2], c3 = coef[b * D.ncoef + 3];
  const int cores = cores_v[b], nodes = nodes_v[b];
  const float inf = __int_as_float(0x7f800000);

  for (int step = 0; step < D.n_steps; ++step) {
    // -- event selection: arrival vs earliest completion (an arrival wins
    // an exact tie; the earliest completion is the first minimum)
    const int ai = *ai_p;
    const float t_a = tb[ai];
    float t_c = inf;
    int kflat = INT_MAX;
    for (int k = lane; k < NSL; k += 32) {
      const float x = fin_s[k];
      if (x < t_c || (x == t_c && k < kflat)) { t_c = x; kflat = k; }
    }
    warp_argmin(t_c, kflat);
    const bool do_arr = t_a <= t_c;
    const float now = do_arr ? t_a : t_c;
    if (now == inf) break;      // no event left: the carry is fixed
    __syncwarp();

    if (lane == 0) {
      if (!do_arr) {
        // -- completion: free the slot, feed the controller ring
        const int kn = kflat / NS;
        const int j_done = idx_s[kflat];
        const int f_done = fb[j_done];
        const float v = pb[j_done];
        const int pos = rpos[f_done];
        const bool full = rlen[f_done] == W;
        const float old = full ? ring[f_done * W + pos] : 0.0f;
        rsum[f_done] = __fsub_rn(__fadd_rn(rsum[f_done], v), old);
        ring[f_done * W + pos] = v;
        if (!full) rlen[f_done] += 1;
        rpos[f_done] = (pos + 1) % W;
        busy[kn] -= 1;
        fin_s[kflat] = inf;
      } else {
        // -- arrival: enqueue, observe on the controller estimator
        const int f_i = fb[ai < n ? ai : n];
        prev_t[f_i] = narr[f_i] == 0 ? now : last_t[f_i];
        last_t[f_i] = now;
        narr[f_i] += 1;
        qn[0] += 1;
        *ai_p = ai + 1;
      }
    }
    __syncwarp();

    // -- dispatch: the invoker with the most free slots ...
    int fv = INT_MIN, k_d = INT_MAX;
    for (int k = lane; k < NN; k += 32) {
      const int x = k < nodes ? cores - busy[k] : -1;
      if (x > fv || (x == fv && k < k_d)) { fv = x; k_d = k; }
    }
    warp_argmax(fv, k_d);

    // ... pulls the best queue head: least priority, then least event index
    const int ai2 = *ai_p;
    int k0 = 0;
    if (D.use_fc) {
      // FC window: k0 = #{i : t[i] <= now - horizon} on the sorted row
      const float lim = __fsub_rn(now, horizon);
      int lo = 0, hi = n1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tb[mid] <= lim) lo = mid + 1; else hi = mid;
      }
      k0 = lo;
    }
    float best = inf;
    int j = n;
    for (int f = lane; f < F; f += 32) {
      const int h = head[f];
      if (h >= narr[f]) continue;              // no queued call of f
      const int idx = fnev_b[f * kq + (h < kq - 1 ? h : kq - 1)];
      const int rl = rlen[f];
      const float est = rl > 0 ? __fdiv_rn(rsum[f], (float)rl) : 0.0f;
      float w = c2;
      if (D.use_fc) {
        const float cnt = __fsub_rn(cumf_b[(size_t)ai2 * F + f],
                                    cumf_b[(size_t)k0 * F + f]);
        w = __fadd_rn(c2, __fmul_rn(c3, cnt));
      }
      const float base = __fadd_rn(__fmul_rn(c1, prev_t[f]),
                                   __fmul_rn(w, est));
      const float pr = __fadd_rn(__fmul_rn(c0, tb[idx]), base);
      if (pr < best || (pr == best && idx < j)) { best = pr; j = idx; }
    }
    warp_argmin(best, j);
    const bool can = j < n && busy[k_d] < cores;
    __syncwarp();

    if (lane == 0) {
      const float exec_start = __fadd_rn(fmaxf(now, chan[k_d]), cb[j]);
      const float fin_j = __fadd_rn(exec_start, pb[j]);
      int jn = n;
      if (can) {
        chan[k_d] = exec_start;
        int s = 0;                 // first free slot below cores
        for (int q = 0; q < NS && q < cores; ++q)
          if (fin_s[k_d * NS + q] == inf) { s = q; break; }
        fin_s[k_d * NS + s] = fin_j;
        idx_s[k_d * NS + s] = j;
        busy[k_d] += 1;
        qn[k_d] -= 1;
        head[fb[j]] += 1;
        jn = j;
      }
      start[row + jn] = exec_start;
      finish[row + jn] = fin_j;
      prio[row + jn] = best;
      node[row + jn] = k_d;
    }
    __syncwarp();
  }
}

}  // namespace

// Launches the scan of D.B cells on `stream`.  `layout` holds the kLayout
// carry offsets and `dims` the kDims launch dimensions, both in host
// memory.  Returns cudaGetLastError() after the launch.
extern "C" int event_step_launch(
    const float* clk, const int* ctr, const float* t, const int* fnid,
    const float* p, const float* cost, const float* coef, const int* cores,
    const int* nodes, const float* cumf, const int* fn_ev, float* start,
    float* finish, float* prio, int* node, const int* layout,
    const int* dims, float horizon, void* stream) {
  Layout L;
  Dims D;
  static_assert(sizeof(Layout) == kLayout * sizeof(int), "layout size");
  static_assert(sizeof(Dims) == kDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  if (D.B == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(D.f_len + D.i_len) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        event_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  event_step_kernel<<<D.B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      clk, ctr, t, fnid, p, cost, coef, cores, nodes, cumf, fn_ev, start,
      finish, prio, node, L, D, horizon);
  return (int)cudaGetLastError();
}
