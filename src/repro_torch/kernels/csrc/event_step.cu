// Batched cluster event scans for Hopper (sm_90a): the base-pull kernel
// (event_step_kernel), and below it the frozen-priority kernel
// (freeze_kernel) for single-node and push cells, the float64 pull
// kernel (dyn_kernel) for pull cells with capacity dynamics, node speeds
// or cold starts, and the float64 frozen-priority kernel
// (freeze64_kernel, its body in event_step_freeze64.cuh) for single-node
// and push cells with them; its hedged sets are built from
// event_step_hedge.cu and event_step_dup.cu, its resilience set from
// event_step_res.cu.
//
// The pull kernel replaces the TPU kernel
// repro/kernels/event_step.py::_event_kernel (launched by
// event_step_pallas).  It computes what that kernel and its
// oracle, repro/core/fastpath.py::_scan_cell_kernel, compute for the base
// pull configuration with or without FC counts: rows [:n] of start / finish
// / prio (float32) and node (int32), bit for bit.  The plain PyTorch version
// is repro_torch/kernels/event_step.py::event_step_ref.
//
// What bounds it.  Not bytes and not operations: each cell is a serial
// chain of up to 2 n steps (one event each), and every step waits on the
// one before it.  A chunk's time is its longest cell's chain, so what counts
// is the latency of one step -- its chain of dependent loads, cross-lane
// reductions and arithmetic -- and, once an SM holds many cells (a
// 4,096-cell chunk puts 16 on each), the instructions a step issues.
//
// Design.
// - One warp per cell, several cells (warps) per block; the launcher sizes
//   the block from the chunk so that every SM gets cells and the chunk
//   takes as few waves as shared memory allows (~14 KB a cell at n_b =
//   1,024: 16 cells an SM).
// - Staged rows: before the loop each warp copies its cell's rows t / p /
//   cost (cp.async) and fnid (as 8 bits) into shared memory, so the
//   dependent loads of a step are shared-memory loads.  The queue sequences
//   fn_ev stay in device memory: a function's head moves one entry a
//   dispatch, and its lane loads the entry after the next as it moves.  A
//   bucket whose rows do not fit reads them from device memory (STAGED =
//   false); the wrapper picks the path from the shape alone
//   (ops.event_step_plan).
// - Lane-owned state in registers: lane l owns slots, nodes and functions
//   l*PL .. l*PL+PL-1 (PL = 1 up to 32 of each; up to 8, 256 of each).  A
//   slot keeps its completion time and its call's function and runtime; a
//   node its busy count and channel clock; a function its queue head (event
//   index and time, and the next index), arrivals, last and previous
//   arrival, the estimator's sum, length, position, estimate and the entry
//   the next push evicts, and its FC count.  Only the runtime ring (F x
//   window) is in shared memory.  The lane that owns an entry updates it;
//   a step has no single-lane section and no __syncwarp.  (The carry's
//   per-node queue length qn decides nothing and is not kept; the carry is
//   not written back.)
// - Wider cells (more than 256 slots, nodes or functions) and runtime
//   rings too large for shared memory take the wide path (PL = 0): the
//   entries a lane owns, pl = ceil(widest / 32), are a launch argument, and
//   they and the ring live in a device-memory scratch the wrapper allocates
//   (kWideArrays arrays of pl x 32 words a cell, laid out [q][lane] so that
//   a warp's accesses to one q are coalesced, then the ring); rows are read
//   from device memory.  Same steps, same order of operations; slower, and
//   with no cap on the width.
// - Reductions over order-preserving 32-bit keys of the floats (-0.0 taken
//   as +0.0, as the comparisons take it; an empty queue above +inf) with
//   redux.sync: the most-free invoker is one redux over (free slots,
//   index), the best queue head one over the key and one over the event
//   index among equal keys.
// - The earliest completion is carried from step to step as its key and
//   time.  When it completes, its slot is the first holding that key (a
//   ballot), its owner hands over the call's function and runtime, and one
//   redux over the remaining slots gives the next, overlapping the ring
//   update; a dispatch only compares its own call with it.  (A completion
//   time of -0.0, which non-negative times cannot produce, would come back
//   as +0.0.)
// - A step that can dispatch nothing -- no call queued, or no free slot
//   below cores on an active invoker -- skips the dispatch.  With one slot
//   a lane the free slots are a mask and the queued calls a count, so the
//   test costs no reduction; that needs the carry's busy counts to be its
//   occupied slots (checked once, kept by every step).
// - The FC window as a running count.  k0 = #{i : t[i] <= now - horizon}
//   is kept in place and each lane keeps cnt_f = cumf[ai, f] - cumf[k0, f]
//   as an integer: +1 for fnid[ai] when an arrival is taken, -1 for
//   fnid[k0] when k0 passes row k0.  cumf is the prefix count of fnid over
//   the real rows (those with t < +inf), exact in float32 below 2^24, so
//   (float) cnt has the bits of the subtraction; the kernel does not read
//   cumf.  Why k0 only moves forward: events are taken in time order --
//   now = min(t[ai], min fin_s), t is sorted, and a dispatch at now sets
//   fin = (max(now, chan) + cost) + p >= now, a round-to-nearest sum of
//   non-negative terms -- so now never decreases and neither does lim =
//   now - horizon nor k0.  k0 stops at row n, the plain version's
//   clamp(max = cumf rows - 1): t[n] = +inf is never <= a finite lim, and
//   neither k0 nor ai ever passes a padded row (t = +inf), whose fnid is
//   not counted in cumf.  The pointer also steps back if lim ever falls
//   (negative costs), so the count stays exact on any sorted row; with the
//   rows the bucket runner fills that branch never runs.  k0 is moved only
//   in a step that dispatches, where the counts are read; since it depends
//   on lim alone, the moves come to the same.
//
// Outputs are zero-filled by the wrapper; the kernel writes the row of each
// dispatched call and never the sentinel row n.  A zero priority that is
// the least of a -0.0 and a +0.0 is written with the winning call's own
// sign (the two compare equal).
//
// Bit-identity: built with --fmad=false and without fast math, and every
// product and sum below uses the _rn intrinsics in the oracle's order.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "event_step_common.cuh"
#include "event_step_freeze64.cuh"

namespace {

constexpr unsigned NO_KEY = 0xffffffffu;   // above every non-NaN key
constexpr int kLayout = 14;   // carry entries, see struct Layout
constexpr int kDims = 13;     // integer launch dimensions, see struct Dims
constexpr int kPlan = 4;      // per_lane, staged, cell_bytes, scratch_words
// lane-owned arrays of the wide path: 5 a slot, 2 a node, 13 a function
constexpr int kWideArrays = 20;

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

struct Args {
  const float* clk;
  const int* ctr;
  const float* t;
  const int* fnid;
  const float* p;
  const float* cost;
  const float* coef;
  const int* cores;
  const int* nodes;
  const int* fn_ev;
  float* start;
  float* finish;
  float* prio;
  int* node;
  uint32_t* scratch;    // the wide path's state (PL = 0), else null
};

// Shared-memory bytes of one cell: the ring, and with STAGED its rows.
// ops.event_step_cell_bytes computes the same.
__host__ __device__ constexpr int cell_bytes(bool staged, int n1, int F,
                                             int W) {
  return 4 * round_up(F * W, 4) +
         (staged ? 12 * round_up(n1, 4) + round_up(n1, 16) : 0);
}

// Scratch words of one cell on the wide path: the lane-owned arrays, then
// the ring.  ops.event_step_plan computes the same.
__host__ __device__ constexpr int scratch_words(int pl, int F, int W) {
  return kWideArrays * 32 * pl + F * W;
}

// The entries one lane owns of one kind: registers (PL > 0; indexed by
// constants once the loops over q are unrolled) or, on the wide path (PL =
// 0), entry q at p[32 q] of the k-th array of the cell's scratch, whose
// lane's first word is `lw` (wide path only).
template <typename T, int PL>
struct Own {
  T v[PL];
  __device__ __forceinline__ Own(uint32_t*, int, int) {}
  __device__ __forceinline__ T& operator[](int q) { return v[q]; }
  __device__ __forceinline__ const T& operator[](int q) const { return v[q]; }
};

template <typename T>
struct Own<T, 0> {
  T* p;
  __device__ __forceinline__ Own(uint32_t* lw, int k, int pl)
      : p(reinterpret_cast<T*>(lw + k * 32 * pl)) {}
  __device__ __forceinline__ T& operator[](int q) const { return p[q * 32]; }
};

// An order-preserving 32-bit key of a float: -0.0 is first made +0.0 (the
// comparisons take them as equal), then a non-negative float gets its sign
// bit set and a negative one all its bits flipped.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The least key of the slots' completion times across the warp.
template <int PL>
__device__ __forceinline__ unsigned least_key(const Own<float, PL>& fin,
                                              int pl) {
  unsigned ck = NO_KEY;
#pragma unroll
  for (int q = 0; q < pl; ++q) ck = min(ck, order_key(fin[q]));
  return __reduce_min_sync(FULL, ck);
}

// The first slot whose completion time has key k.
template <int PL>
__device__ __forceinline__ int first_slot(const Own<float, PL>& fin, int pl,
                                          int lane, unsigned k) {
  if constexpr (PL == 1) {
    return __ffs(__ballot_sync(FULL, order_key(fin[0]) == k)) - 1;
  } else {
    int ce = INT_MAX;
#pragma unroll
    for (int q = pl - 1; q >= 0; --q)
      if (order_key(fin[q]) == k) ce = lane * pl + q;
    return __reduce_min_sync(FULL, ce);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// A cell's rows t / p / cost / fnid: in shared memory (fnid as 8 bits) or
// in device memory.
template <bool S>
struct Rows {
  using Fn = std::conditional_t<S, uint8_t, int>;
  const float* t_;
  const float* p_;
  const float* c_;
  const Fn* fn_;
  __device__ __forceinline__ float t(int i) const {
    if constexpr (S) return t_[i]; else return __ldg(t_ + i);
  }
  __device__ __forceinline__ float p(int i) const {
    if constexpr (S) return p_[i]; else return __ldg(p_ + i);
  }
  __device__ __forceinline__ float cost(int i) const {
    if constexpr (S) return c_[i]; else return __ldg(c_ + i);
  }
  __device__ __forceinline__ int fn(int i) const {
    if constexpr (S) return fn_[i]; else return __ldg(fn_ + i);
  }
};

template <int PL, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxCellsPerBlock)
    event_step_kernel(const Args a, const Layout L, const Dims D,
                      const int cells_per_block, const int bytes_per_cell,
                      const float horizon, const int pl_wide,
                      const int wide_words) {
  static_assert(PL > 0 || !STAGED, "the wide path reads rows in place");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * cells_per_block + warp;
  if (b >= D.B) return;

  const int n = D.n, n1 = D.n + 1;
  const int NN = D.n_nodes, NS = D.n_slots, NSL = D.n_nodes * D.n_slots;
  const int F = D.n_fns, W = D.window, kq = D.kq;
  const float inf = __int_as_float(0x7f800000);
  const size_t row = static_cast<size_t>(b) * n1;
  const size_t ev_row = static_cast<size_t>(b) * F * kq;
  const float* clk = a.clk + static_cast<size_t>(b) * D.f_len;
  const int* ctr = a.ctr + static_cast<size_t>(b) * D.i_len;
  const int pl = PL > 0 ? PL : pl_wide;    // entries a lane owns

  // -- this warp's cell: the ring, then the staged rows, in shared memory
  // (the ring in the scratch on the wide path)
  uint32_t* lw = nullptr;
  float* ring;
  if constexpr (PL == 0) {
    uint32_t* cw = a.scratch + static_cast<size_t>(b) * wide_words;
    lw = cw + lane;
    ring = reinterpret_cast<float*>(cw + kWideArrays * 32 * pl);
  } else {
    ring = reinterpret_cast<float*>(smem + static_cast<size_t>(warp) *
                                               bytes_per_cell);
  }
  Rows<STAGED> R;
  if constexpr (STAGED) {
    float* st = ring + round_up(F * W, 4);
    float* sp = st + round_up(n1, 4);
    float* sc = sp + round_up(n1, 4);
    uint8_t* sfn = reinterpret_cast<uint8_t*>(sc + round_up(n1, 4));
    for (int i = lane; i < n1; i += 32) {
      cp_async4(st + i, a.t + row + i);
      cp_async4(sp + i, a.p + row + i);
      cp_async4(sc + i, a.cost + row + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    stage8(sfn, a.fnid + row, n1, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    R = Rows<STAGED>{st, sp, sc, sfn};
  } else {
    R = Rows<STAGED>{a.t + row, a.p + row, a.cost + row, a.fnid + row};
  }
  for (int i = lane; i < F * W; i += 32) ring[i] = __ldg(clk + L.ring + i);
  __syncwarp();

  const float* cf = a.coef + static_cast<size_t>(b) * D.ncoef;
  const float c0 = __ldg(cf), c1 = __ldg(cf + 1), c2 = __ldg(cf + 2),
              c3 = __ldg(cf + 3);
  const int cores = __ldg(a.cores + b), nodes = __ldg(a.nodes + b);

  // -- the carry, from the planes into the owning lanes' registers.  A
  // lane's entries past the last slot hold +inf and no node, so they never
  // win a completion tie against a real slot (a lower index).
  Own<float, PL> s_fin(lw, 0, pl);
  Own<float, PL> s_p(lw, 1, pl);
  Own<int, PL> s_fn(lw, 2, pl);
  Own<int, PL> s_node(lw, 3, pl);
  Own<int, PL> s_slot(lw, 4, pl);
  Own<int, PL> n_busy(lw, 5, pl);
  Own<float, PL> n_chan(lw, 6, pl);
  Own<int, PL> f_head(lw, 7, pl);
  Own<int, PL> f_narr(lw, 8, pl);
  Own<int, PL> f_rlen(lw, 9, pl);
  Own<int, PL> f_rpos(lw, 10, pl);
  Own<int, PL> f_cnt(lw, 11, pl);
  Own<int, PL> f_idx(lw, 12, pl);
  Own<int, PL> f_nidx(lw, 13, pl);
  Own<float, PL> f_rsum(lw, 14, pl);
  Own<float, PL> f_last(lw, 15, pl);
  Own<float, PL> f_prev(lw, 16, pl);
  Own<float, PL> f_est(lw, 17, pl);
  Own<float, PL> f_th(lw, 18, pl);
  Own<float, PL> f_old(lw, 19, pl);
  // function e's queue sequence (device memory)
  const int* const fn_ev = a.fn_ev + ev_row;
  int ai = __ldg(ctr + L.ai);
#pragma unroll
  for (int q = 0; q < pl; ++q) {
    const int e = lane * pl + q;
    s_fin[q] = inf;
    s_p[q] = 0.0f;
    s_fn[q] = 0;
    s_node[q] = -1;
    s_slot[q] = 0;
    if (e < NSL) {
      const int j = min(max(__ldg(ctr + L.idx_s + e), 0), n);
      s_fin[q] = __ldg(clk + L.fin_s + e);
      s_fn[q] = R.fn(j);
      s_p[q] = R.p(j);
      s_node[q] = e / NS;
      s_slot[q] = e - s_node[q] * NS;
    }
    n_busy[q] = e < NN ? __ldg(ctr + L.busy + e) : 0;
    n_chan[q] = e < NN ? __ldg(clk + L.chan + e) : 0.0f;
    const bool fe = e < F;
    f_head[q] = fe ? __ldg(ctr + L.head + e) : 0;
    f_narr[q] = fe ? __ldg(ctr + L.narr + e) : 0;
    f_rlen[q] = fe ? __ldg(ctr + L.rlen + e) : 0;
    f_rpos[q] = fe ? __ldg(ctr + L.rpos + e) : 0;
    f_rsum[q] = fe ? __ldg(clk + L.rsum + e) : 0.0f;
    f_last[q] = fe ? __ldg(clk + L.last_t + e) : 0.0f;
    f_prev[q] = fe ? __ldg(clk + L.prev_t + e) : 0.0f;
    f_est[q] = f_rlen[q] > 0
                   ? __fdiv_rn(f_rsum[q], static_cast<float>(f_rlen[q]))
                   : 0.0f;
    const int* ev = fn_ev + (fe ? e : 0) * kq;
    f_idx[q] = fe ? __ldg(ev + min(f_head[q], kq - 1)) : n;
    f_nidx[q] = fe ? __ldg(ev + min(f_head[q] + 1, kq - 1)) : n;
    f_th[q] = R.t(f_idx[q]);
    f_cnt[q] = 0;
    // the ring entry the next push evicts once the ring is full
    f_old[q] = fe ? ring[e * W + f_rpos[q]] : 0.0f;
  }
  // FC counts of the arrivals the carry has already taken (none in a fresh
  // carry): cumf[ai] - cumf[0]
  for (int i = 0; i < ai && i < n; ++i) {
    const int f = R.fn(i);
    if (R.t(i) != inf) {
#pragma unroll
      for (int q = 0; q < pl; ++q)
        if (lane * pl + q == f) f_cnt[q] += 1;
    }
  }
  int k0 = 0;
  float t_k0 = R.t(0), t_km1 = -inf;
  float t_a = ai <= n ? R.t(ai) : inf;     // the next arrival, loaded ahead
  int f_a = R.fn(min(ai, n));
  // the earliest completion time and its key, carried from step to step;
  // its slot is looked up when it completes (the first with that key)
  unsigned nx_key = least_key<PL>(s_fin, pl);
  float nx_t = key_float(nx_key);
  // with one slot a lane, the free slots (completion time +inf) as a mask
  unsigned free_mask = 0;
  if constexpr (PL == 1) free_mask = __ballot_sync(FULL, isinf(s_fin[0]));
  // with one slot a lane, also the slots below cores of each node (low, in
  // the node's bits) and those of the active nodes (usable); when the
  // carry's busy counts are its occupied usable slots (counted; true of
  // every carry the bucket runner makes, and kept so by the steps), a step
  // with no free usable slot dispatches nothing and skips the reductions
  unsigned low = 0, usable = 0;
  bool counted = false;
  if constexpr (PL == 1) {
    const int below = min(cores, NS);
    low = below >= 32 ? FULL : below <= 0 ? 0u : (1u << below) - 1u;
    usable = __ballot_sync(FULL, lane < NSL && s_node[0] < nodes &&
                                     s_slot[0] < cores);
    const unsigned occ = ~free_mask & (NSL >= 32 ? FULL : (1u << NSL) - 1u);
    const unsigned mine = lane < NN ? occ >> (lane * NS) : 0u;
    const unsigned node_bits = NS >= 32 ? FULL : (1u << NS) - 1u;
    const bool ok = lane >= NN || ((mine & node_bits & ~low) == 0 &&
                                   __popc(mine & low) == n_busy[0]);
    counted = __all_sync(FULL, ok && f_head[0] <= f_narr[0]) &&
              nodes >= 1 && cores <= NS && (occ & ~usable) == 0;
  }
  // the calls queued (a count kept when the carry is counted)
  int queued = 0;
#pragma unroll
  for (int q = 0; q < pl; ++q) queued += max(f_narr[q] - f_head[q], 0);
  queued = __reduce_add_sync(FULL, queued);
  float* const o_start = a.start + row;
  float* const o_finish = a.finish + row;
  float* const o_prio = a.prio + row;
  int* const o_node = a.node + row;

  for (int step = 0; step < D.n_steps; ++step) {
    // -- event selection: the next arrival or the earliest completion (an
    // arrival wins an exact tie)
    const bool do_arr = t_a <= nx_t;
    const float now = do_arr ? t_a : nx_t;
    if (now == inf) break;      // no event left: the carry is fixed

    if (do_arr) {
      // -- arrival: enqueue, observe on the controller estimator; the FC
      // count of its function grows by one (ai passes its row)
#pragma unroll
      for (int q = 0; q < pl; ++q) {
        if (lane * pl + q == f_a) {
          f_prev[q] = f_narr[q] == 0 ? now : f_last[q];
          f_last[q] = now;
          f_narr[q] += 1;
          f_cnt[q] += 1;
        }
      }
      ++ai;
      ++queued;
      t_a = ai <= n ? R.t(ai) : inf;
      f_a = R.fn(min(ai, n));
    } else {
      // -- completion: the slot's owner hands over its call's function,
      // runtime and node; free the slot and the node, find the next
      // earliest completion, and feed the controller ring
      const int kflat = first_slot<PL>(s_fin, pl, lane, nx_key);
      const int src = kflat / pl, qs = kflat % pl;
      int sf = s_fn[0], sn = s_node[0];
      float sv = s_p[0];
#pragma unroll
      for (int q = 1; q < pl; ++q)
        if (q == qs) { sf = s_fn[q]; sn = s_node[q]; sv = s_p[q]; }
      const int f_done = __shfl_sync(FULL, sf, src);
      const int kn = __shfl_sync(FULL, sn, src);
      const float v = __shfl_sync(FULL, sv, src);
#pragma unroll
      for (int q = 0; q < pl; ++q) {
        const int e = lane * pl + q;
        if (e == kflat) s_fin[q] = inf;
        if (e == kn) n_busy[q] -= 1;
      }
      if constexpr (PL == 1) free_mask |= 1u << kflat;
      nx_key = least_key<PL>(s_fin, pl);
#pragma unroll
      for (int q = 0; q < pl; ++q) {
        const int e = lane * pl + q;
        if (e == f_done) {
          const bool full = f_rlen[q] == W;
          const int pos = f_rpos[q];
          const int npos = pos + 1 == W ? 0 : pos + 1;
          f_rsum[q] = __fsub_rn(__fadd_rn(f_rsum[q], v),
                                full ? f_old[q] : 0.0f);
          ring[f_done * W + pos] = v;
          f_old[q] = ring[f_done * W + npos];
          if (!full) f_rlen[q] += 1;
          f_rpos[q] = npos;
          f_est[q] = __fdiv_rn(f_rsum[q], static_cast<float>(f_rlen[q]));
        }
      }
      nx_t = key_float(nx_key);
    }

    // -- dispatch, when a call is queued and an invoker has a free slot
    // (else the step leaves the dispatch state as it is)
    bool go;
    if (counted) {
      go = queued > 0 && (free_mask & usable) != 0;
    } else {
      bool q_any = false;
#pragma unroll
      for (int q = 0; q < pl; ++q) q_any |= f_head[q] < f_narr[q];
      go = __any_sync(FULL, q_any);
    }
    if (go) {
      if (D.use_fc) {
        // -- FC window: calls among the arrivals in (now - horizon, now];
        // k0 passes the rows at or before now - horizon
        const float lim = __fsub_rn(now, horizon);
        if ((k0 < n && t_k0 <= lim) || (k0 > 0 && t_km1 > lim)) {
          while (k0 < n && t_k0 <= lim) {
            const int f = R.fn(k0);
            if (t_k0 != inf) {
#pragma unroll
              for (int q = 0; q < pl; ++q)
                if (lane * pl + q == f) f_cnt[q] -= 1;
            }
            t_km1 = t_k0;
            ++k0;
            t_k0 = R.t(k0);
          }
          while (k0 > 0 && t_km1 > lim) {     // only if lim fell
            --k0;
            t_k0 = t_km1;
            t_km1 = k0 > 0 ? R.t(k0 - 1) : -inf;
            const int f = R.fn(k0);
            if (t_k0 != inf) {
#pragma unroll
              for (int q = 0; q < pl; ++q)
                if (lane * pl + q == f) f_cnt[q] += 1;
            }
          }
        }
      }
      // the invoker with the most free slots (first on ties), one redux
      // over (free slots, index) -- two on the wide path, where an index
      // may not fit in 8 bits ...
      int k_d;
      if constexpr (PL > 0) {
        unsigned nk = 0;
#pragma unroll
        for (int q = 0; q < PL; ++q) {
          const int e = lane * PL + q;
          const int x = e < nodes ? cores - n_busy[q] : -1;
          const unsigned key = (static_cast<unsigned>(x + 2) << 8) |
                               static_cast<unsigned>(255 - e);
          if (e < NN && key > nk) nk = key;
        }
        const unsigned nmax = __reduce_max_sync(FULL, nk);
        k_d = 255 - static_cast<int>(nmax & 255u);
      } else {
        int bx = INT_MIN, be = INT_MAX;
        for (int q = 0; q < pl; ++q) {
          const int e = lane * pl + q;
          const int x = e < nodes ? cores - n_busy[q] : -1;
          if (e < NN && x > bx) { bx = x; be = e; }
        }
        const int xmax = __reduce_max_sync(FULL, bx);
        k_d = __reduce_min_sync(FULL, bx == xmax ? be : INT_MAX);
      }
      const int kd_src = k_d / pl, kd_q = k_d % pl;
      int sb = n_busy[0];
      float sch = n_chan[0];
#pragma unroll
      for (int q = 1; q < pl; ++q)
        if (q == kd_q) { sb = n_busy[q]; sch = n_chan[q]; }
      const int busy_kd = __shfl_sync(FULL, sb, kd_src);
      const float chan_kd = __shfl_sync(FULL, sch, kd_src);
      // ... and its first free slot below cores (slot 0 if none)
      int se;
      bool none_free;
      if constexpr (PL == 1) {
        const unsigned m = (free_mask >> (k_d * NS)) & low;
        none_free = m == 0;
        se = k_d * NS + (none_free ? 0 : __ffs(m) - 1);
      } else {
        se = INT_MAX;
#pragma unroll
        for (int q = pl - 1; q >= 0; --q)
          if (s_node[q] == k_d && s_slot[q] < cores && isinf(s_fin[q]))
            se = lane * pl + q;
        se = __reduce_min_sync(FULL, se);
        none_free = se == INT_MAX;
        if (none_free) se = k_d * NS;
      }

      // ... pulls the best queue head: least priority, then least event index
      unsigned pk = NO_KEY;
      int pj = INT_MAX;
      float pv = 0.0f;
#pragma unroll
      for (int q = 0; q < pl; ++q) {
        float w = c2;
        if (D.use_fc)
          w = __fadd_rn(c2, __fmul_rn(c3, __int2float_rn(f_cnt[q])));
        const float base = __fadd_rn(__fmul_rn(c1, f_prev[q]),
                                     __fmul_rn(w, f_est[q]));
        const float pr = __fadd_rn(__fmul_rn(c0, f_th[q]), base);
        const unsigned k = f_head[q] < f_narr[q] ? order_key(pr) : NO_KEY;
        if (k < pk || (k == pk && f_idx[q] < pj)) {
          pk = k; pj = f_idx[q]; pv = pr;
        }
      }
      const unsigned pmin = __reduce_min_sync(FULL, pk);
      const int j = pmin == NO_KEY
                        ? n
                        : __reduce_min_sync(FULL, pk == pmin ? pj : INT_MAX);

      if (j < n && busy_kd < cores) {
        --queued;
        const float cost_j = R.cost(j), p_j = R.p(j);
        const int f_j = R.fn(j);
        const float exec_start = __fadd_rn(fmaxf(now, chan_kd), cost_j);
        const float fin_j = __fadd_rn(exec_start, p_j);
#pragma unroll
        for (int q = 0; q < pl; ++q) {
          const int e = lane * pl + q;
          if (e == se) { s_fin[q] = fin_j; s_fn[q] = f_j; s_p[q] = p_j; }
          if (e == k_d) { n_chan[q] = exec_start; n_busy[q] += 1; }
          if (e == f_j) {
            // the next head, loaded one dispatch ahead, and the one after it
            f_head[q] += 1;
            f_idx[q] = f_nidx[q];
            f_th[q] = R.t(f_idx[q]);
            f_nidx[q] = __ldg(fn_ev + e * kq + min(f_head[q] + 1, kq - 1));
          }
        }
        // the winning head's lane records the dispatch
        if (pk == pmin && pj == j) {
          o_start[j] = exec_start;
          o_finish[j] = fin_j;
          o_prio[j] = pv;
          o_node[j] = k_d;
        }
        // the new call may complete first; a call put into a busy slot (a
        // carry with no free slot below cores) takes a fresh look
        if constexpr (PL == 1) {
          free_mask = (free_mask & ~(1u << se)) |
                      (isinf(fin_j) ? 1u << se : 0u);
          if (isinf(fin_j)) counted = false;   // busy, yet "free"
        }
        if (none_free) {
          nx_key = least_key<PL>(s_fin, pl);
          nx_t = key_float(nx_key);
        } else {
          const unsigned kj = order_key(fin_j);
          if (kj < nx_key) { nx_key = kj; nx_t = fin_j; }
        }
      }
    }
  }
}

template <int PL, bool STAGED>
int launch(const Args& a, const Layout& L, const Dims& D, int cell,
           float horizon, cudaStream_t stream, int pl_wide = 0,
           int wide_words = 0) {
  auto kernel = event_step_kernel<PL, STAGED>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, L, D, cpb, cell, horizon, pl_wide, wide_words);
  return static_cast<int>(cudaGetLastError());
}

template <int PL>
int launch_pl(bool staged, const Args& a, const Layout& L, const Dims& D,
              int cell, float horizon, cudaStream_t stream) {
  return staged ? launch<PL, true>(a, L, D, cell, horizon, stream)
                : launch<PL, false>(a, L, D, cell, horizon, stream);
}

// ---------------------------------------------------------------------------
// The frozen-priority regime: single-node cells and push cells (least-loaded
// or home balancer), the freeze branch of _scan_cell_kernel that the JAX
// package runs as XLA's lax.scan (repro/core/fastpath.py:821; its Pallas
// kernel covers pull only).  The plain PyTorch version is
// repro_torch/kernels/event_step.py::freeze_scan_ref.
//
// Each arrival is routed at once and its priority fixed from the estimator
// of the node it went to; a step dispatches only on the node its event
// touched, the least frozen priority queued there (first index on ties).
// One warp a cell, as above, and the same rules of exactness (--fmad=false,
// _rn arithmetic in the oracle's order, order-preserving keys, first-index
// ties).  What differs:
// - The queue: each row's frozen priority as its order key (32 bits) and
//   the node it waits on (16 bits staged, 32 in device memory; none once
//   dispatched or not yet arrived).  A dispatch scans the rows between the
//   first still queued (lo) and the last arrived (hi), row i by lane i %
//   32, so each lane reads only rows it wrote itself; two reductions give
//   the least (key, row).  That is O(queue) a dispatch: a per-node heap is
//   later work.  A step whose node has no free slot, or (in a fresh carry)
//   nothing queued, scans nothing.
// - Per-(node, function) estimators (sum, last and previous arrival,
//   length, position, arrivals, FC ring position) and their runtime rings
//   in shared memory, read and written by lane 0 alone: only one entry is
//   touched an event, so no other lane needs them.
// - Slots and nodes (busy, queued, channel clock) are lane-owned as above
//   (Own<T, PL>); a cell of more than 256 slots or nodes keeps them in a
//   device-memory scratch (PL = 0), so no width is refused.
// - Push FC: each arrival is logged in its node's ring of fc_ring times for
//   its function, in device memory (up to 64 KB a cell at Fig 6's width);
//   the window count is the ring's entries above now - horizon, counted
//   across the warp with the new time in place (entry r read and written by
//   lane r % 32 only).  Single-node FC reads the static count cnt.
// - Staged (ops.event_step_freeze_plan): estimators, queue and rows in
//   shared memory; otherwise estimators and queue in the scratch and rows
//   read in place.  Outputs: prio and node are each row's frozen values
//   (the carry's at the start, overwritten at arrival); start and finish
//   are written at dispatch and stay 0 otherwise.
// ---------------------------------------------------------------------------

constexpr int kFLayout = 18;  // carry entries, see struct FLayout
constexpr int kFDims = 12;    // integer launch dimensions, see struct FDims
constexpr int kFPlan = 5;     // per_lane, staged, wide, cell_bytes, words
// lane-owned arrays of the wide path: 5 a slot, 3 a node
constexpr int kFreezeWideArrays = 8;
// per-(node, function) estimator arrays (see above)
constexpr int kEstArrays = 7;
constexpr unsigned KEY_INF = 0xff800000u;   // order_key(+inf)

// Offsets of the carry entries: the first eight in the clk plane, the rest
// in the ctr plane (EVENT_STEP_FREEZE_LAYOUT in ops.py); fcr and fcp are 0
// without the push FC rings.
struct FLayout {
  int chan, fin_s, fprio, last_t, prev_t, ring, rsum, fcr;
  int ai, busy, idx_s, narr, node_of, pend, qn, rlen, rpos, fcp;
};

struct FDims {
  int B, n, n_nodes, n_slots, window, n_fns, ncoef, f_len, i_len, fc_push,
      fc_ring, n_steps;
};

struct FArgs {
  const float* clk;
  const int* ctr;
  const float* t;
  const int* fnid;
  const float* p;
  const float* cost;
  const float* coef;
  const int* cores;
  const int* nodes;
  const float* cnt;
  const int* home0;
  const int* route;
  float* start;
  float* finish;
  float* prio;
  int* node;
  uint32_t* scratch;
};

// Words of one cell's estimators: the scalar arrays, then the rings.
// ops.event_step_freeze_est_words computes the same.
__host__ __device__ constexpr int est_words(int E, int W) {
  return kEstArrays * round_up(E, 4) + round_up(E * W, 4);
}

// Shared-memory bytes of one staged cell: estimators, queue keys and nodes,
// rows.  ops.event_step_freeze_cell_bytes computes the same.
__host__ __device__ constexpr int freeze_cell_bytes(int n1, int E, int W) {
  return 4 * est_words(E, W) + 4 * round_up(n1, 4) + 2 * round_up(n1, 8) +
         12 * round_up(n1, 4) + round_up(n1, 16);
}

// Scratch words of one cell: the wide path's lane-owned arrays, then
// (unstaged) the estimators and the queue, then the push FC rings.
// ops.event_step_freeze_plan computes the same.
__host__ __device__ constexpr long freeze_scratch_words(bool staged,
                                                        bool wide, int pl,
                                                        int n1, int E, int W,
                                                        bool fc_push,
                                                        int RF) {
  return (wide ? kFreezeWideArrays * 32L * pl : 0L) +
         (staged ? 0L : est_words(E, W) + 2L * round_up(n1, 4)) +
         (fc_push ? static_cast<long>(E) * RF : 0L);
}

// Entry e of a lane-owned array, on every lane (from its owner).
template <typename T, int PL>
__device__ __forceinline__ T owned(const Own<T, PL>& arr, int pl, int e) {
  const int src = e / pl, qe = e % pl;
  T v;
  if constexpr (PL == 0) {
    v = arr[qe];
  } else {
    v = arr[0];
#pragma unroll
    for (int q = 1; q < PL; ++q)
      if (q == qe) v = arr[q];
  }
  return __shfl_sync(FULL, v, src);
}

template <int PL, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxCellsPerBlock)
    freeze_kernel(const FArgs a, const FLayout L, const FDims D,
                  const int cells_per_block, const int bytes_per_cell,
                  const float horizon, const int pl_wide, const int words) {
  static_assert(PL > 0 || !STAGED, "the wide path keeps its state in the "
                                   "scratch");
  using QN = std::conditional_t<STAGED, uint16_t, int>;
  const QN kNone = static_cast<QN>(STAGED ? 0xffff : -1);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * cells_per_block + warp;
  if (b >= D.B) return;

  const int n = D.n, n1 = D.n + 1;
  const int NN = D.n_nodes, NS = D.n_slots, NSL = D.n_nodes * D.n_slots;
  const int F = D.n_fns, W = D.window, E = NN * F, RF = D.fc_ring;
  const float inf = __int_as_float(0x7f800000);
  const size_t row = static_cast<size_t>(b) * n1;
  const float* clk = a.clk + static_cast<size_t>(b) * D.f_len;
  const int* ctr = a.ctr + static_cast<size_t>(b) * D.i_len;
  const int pl = PL > 0 ? PL : pl_wide;    // entries a lane owns

  // -- this warp's cell: estimators and queue in shared memory (staged) or
  // in the scratch, the FC rings in the scratch
  uint32_t* cw = a.scratch == nullptr
                     ? nullptr
                     : a.scratch + static_cast<size_t>(b) * words;
  uint32_t* lw = nullptr;
  size_t used = 0;     // scratch words before the FC rings
  if constexpr (PL == 0) {
    lw = cw + lane;
    used = static_cast<size_t>(kFreezeWideArrays) * 32 * pl;
  }
  uint32_t* est;
  if constexpr (STAGED) {
    est = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(warp) *
                                                 bytes_per_cell);
  } else {
    est = cw + used;
    used += est_words(E, W) + 2 * round_up(n1, 4);
  }
  const int E4 = round_up(E, 4);
  float* const e_rsum = reinterpret_cast<float*>(est);
  float* const e_last = e_rsum + E4;
  float* const e_prev = e_last + E4;
  int* const e_rlen = reinterpret_cast<int*>(e_prev + E4);
  int* const e_rpos = e_rlen + E4;
  int* const e_narr = e_rpos + E4;
  int* const e_fcp = e_narr + E4;
  float* const ring = reinterpret_cast<float*>(e_fcp + E4);
  unsigned* const q_key =
      reinterpret_cast<unsigned*>(ring + round_up(E * W, 4));
  QN* const q_node = reinterpret_cast<QN*>(q_key + round_up(n1, 4));
  float* const fcr =
      D.fc_push ? reinterpret_cast<float*>(cw + used) : nullptr;
  Rows<STAGED> R;
  if constexpr (STAGED) {
    float* st = reinterpret_cast<float*>(q_node + round_up(n1, 8));
    float* sp = st + round_up(n1, 4);
    float* sc = sp + round_up(n1, 4);
    uint8_t* sfn = reinterpret_cast<uint8_t*>(sc + round_up(n1, 4));
    for (int i = lane; i < n1; i += 32) {
      cp_async4(st + i, a.t + row + i);
      cp_async4(sp + i, a.p + row + i);
      cp_async4(sc + i, a.cost + row + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    stage8(sfn, a.fnid + row, n1, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    R = Rows<STAGED>{st, sp, sc, sfn};
  } else {
    R = Rows<STAGED>{a.t + row, a.p + row, a.cost + row, a.fnid + row};
  }
  for (int i = lane; i < E; i += 32) {
    e_rsum[i] = __ldg(clk + L.rsum + i);
    e_last[i] = __ldg(clk + L.last_t + i);
    e_prev[i] = __ldg(clk + L.prev_t + i);
    e_rlen[i] = __ldg(ctr + L.rlen + i);
    e_rpos[i] = __ldg(ctr + L.rpos + i);
    e_narr[i] = __ldg(ctr + L.narr + i);
    e_fcp[i] = D.fc_push ? __ldg(ctr + L.fcp + i) : 0;
  }
  for (int i = lane; i < E * W; i += 32) ring[i] = __ldg(clk + L.ring + i);
  if (D.fc_push)
    for (int i = lane; i < E * RF; i += 32) fcr[i] = __ldg(clk + L.fcr + i);
  // the queue and the frozen outputs from the carry: row i by lane i % 32
  float* const o_start = a.start + row;
  float* const o_finish = a.finish + row;
  float* const o_prio = a.prio + row;
  int* const o_node = a.node + row;
  int hi = 0;     // one past the last queued row
  for (int i = lane; i < n1; i += 32) {
    const bool pend = __ldg(ctr + L.pend + i) != 0;
    const float fp = __ldg(clk + L.fprio + i);
    const int nd = __ldg(ctr + L.node_of + i);
    q_key[i] = order_key(fp);
    q_node[i] = pend ? static_cast<QN>(nd) : kNone;
    o_prio[i] = fp;
    o_node[i] = nd;
    if (pend) hi = i + 1;
  }
  hi = __reduce_max_sync(FULL, hi);
  const bool carried = hi > 0;    // calls queued in the carry
  __syncwarp();

  const float* cf = a.coef + static_cast<size_t>(b) * D.ncoef;
  const float c0 = __ldg(cf), c1 = __ldg(cf + 1), c2 = __ldg(cf + 2),
              c3 = __ldg(cf + 3);
  const int cores = __ldg(a.cores + b), nodes = __ldg(a.nodes + b);
  const int route = __ldg(a.route + b);
  const int* const home0 = a.home0 + row;
  const float* const cnt = a.cnt + row;

  // -- slots and nodes, from the planes into the owning lanes
  Own<float, PL> s_fin(lw, 0, pl);
  Own<float, PL> s_p(lw, 1, pl);
  Own<int, PL> s_fn(lw, 2, pl);
  Own<int, PL> s_node(lw, 3, pl);
  Own<int, PL> s_slot(lw, 4, pl);
  Own<int, PL> n_busy(lw, 5, pl);
  Own<int, PL> n_qn(lw, 6, pl);
  Own<float, PL> n_chan(lw, 7, pl);
  bool qn_zero = true;
#pragma unroll
  for (int q = 0; q < pl; ++q) {
    const int e = lane * pl + q;
    s_fin[q] = inf;
    s_p[q] = 0.0f;
    s_fn[q] = 0;
    s_node[q] = -1;
    s_slot[q] = 0;
    if (e < NSL) {
      const int j = min(max(__ldg(ctr + L.idx_s + e), 0), n);
      s_fin[q] = __ldg(clk + L.fin_s + e);
      s_fn[q] = R.fn(j);
      s_p[q] = R.p(j);
      s_node[q] = e / NS;
      s_slot[q] = e - s_node[q] * NS;
    }
    n_busy[q] = e < NN ? __ldg(ctr + L.busy + e) : 0;
    n_qn[q] = e < NN ? __ldg(ctr + L.qn + e) : 0;
    n_chan[q] = e < NN ? __ldg(clk + L.chan + e) : 0.0f;
    if (n_qn[q] != 0) qn_zero = false;
  }
  // in a fresh carry (nothing queued, every count 0) a node's queued count
  // is the number of calls queued on it, and a node with none is skipped
  const bool counted = !carried && __all_sync(FULL, qn_zero);
  int ai = __ldg(ctr + L.ai);
  int lo = 0;     // the first queued row (none before it)
  float t_a = ai <= n ? R.t(ai) : inf;     // the next arrival, loaded ahead
  int f_a = R.fn(min(ai, n));
  unsigned nx_key = least_key<PL>(s_fin, pl);
  float nx_t = key_float(nx_key);

  for (int step = 0; step < D.n_steps; ++step) {
    // -- event selection: the next arrival or the earliest completion (an
    // arrival wins an exact tie)
    const bool do_arr = t_a <= nx_t;
    const float now = do_arr ? t_a : nx_t;
    if (now == inf) break;      // no event left: the carry is fixed

    int k_d;                    // the node the event touched
    if (do_arr) {
      const int i = ai, f = f_a;
      // -- route: least busy + queued (first on ties; padded nodes 2^30),
      // or the first node with a free slot on the walk from home
      int k_arr;
      if (route == 1) {
        const int h0 = __ldg(home0 + i);
        const int m = max(nodes, 1);
        int wb = INT_MAX;
#pragma unroll
        for (int q = 0; q < pl; ++q) {
          const int e = lane * pl + q;
          if (e < NN && e < nodes && n_busy[q] < cores) {
            int w = (e - h0) % m;
            if (w < 0) w += m;
            wb = min(wb, w);
          }
        }
        const int wmin = __reduce_min_sync(FULL, wb);
        if (wmin == INT_MAX) {
          k_arr = h0;
        } else {
          k_arr = (h0 + wmin) % m;
          if (k_arr < 0) k_arr += m;
        }
      } else {
        int lb = INT_MAX, eb = INT_MAX;
#pragma unroll
        for (int q = 0; q < pl; ++q) {
          const int e = lane * pl + q;
          if (e < NN) {
            const int ld = e < nodes ? n_busy[q] + n_qn[q] : (1 << 30);
            if (ld < lb) { lb = ld; eb = e; }
          }
        }
        const int lmin = __reduce_min_sync(FULL, lb);
        k_arr = __reduce_min_sync(FULL, lb == lmin ? eb : INT_MAX);
      }
      // -- observe on the routed node's estimator (lane 0), log the FC
      // ring and count its window (the warp), freeze the priority
      const int ei = k_arr * F + f;
      int pf = 0;
      float prev_used = now, est = 0.0f;
      if (lane == 0) {
        const int narr0 = e_narr[ei];
        prev_used = narr0 == 0 ? now : e_last[ei];
        const int rl = e_rlen[ei];
        est = rl > 0 ? __fdiv_rn(e_rsum[ei], __int2float_rn(rl)) : 0.0f;
        pf = e_fcp[ei];
        e_prev[ei] = prev_used;
        e_last[ei] = now;
        e_narr[ei] = narr0 + 1;
        if (D.fc_push) e_fcp[ei] = pf + 1 == RF ? 0 : pf + 1;
      }
      float cnt_i;
      if (D.fc_push) {
        pf = __shfl_sync(FULL, pf, 0);
        float* const fr = fcr + static_cast<size_t>(ei) * RF;
        const float lim = __fsub_rn(now, horizon);
        int c = 0;
        for (int r = lane; r < RF; r += 32) {
          const float x = r == pf ? now : fr[r];
          c += x > lim ? 1 : 0;
        }
        if (pf % 32 == lane) fr[pf] = now;
        cnt_i = __int2float_rn(__reduce_add_sync(FULL, c));
      } else {
        cnt_i = __ldg(cnt + i);
      }
      const float w = __fadd_rn(c2, __fmul_rn(c3, cnt_i));
      float prio = __fadd_rn(__fadd_rn(__fmul_rn(c0, now),
                                       __fmul_rn(c1, prev_used)),
                             __fmul_rn(w, est));
      prio = __shfl_sync(FULL, prio, 0);
      if ((i & 31) == lane) {
        q_key[i] = order_key(prio);
        q_node[i] = static_cast<QN>(k_arr);
        o_prio[i] = prio;
        o_node[i] = k_arr;
      }
#pragma unroll
      for (int q = 0; q < pl; ++q)
        if (lane * pl + q == k_arr) n_qn[q] += 1;
      ++ai;
      hi = max(hi, ai);
      t_a = ai <= n ? R.t(ai) : inf;
      f_a = R.fn(min(ai, n));
      k_d = k_arr;
    } else {
      // -- completion: the slot's owner hands over its call's function,
      // runtime and node; free the slot and the node, find the next
      // earliest completion, and feed the node's ring (lane 0)
      const int kflat = first_slot<PL>(s_fin, pl, lane, nx_key);
      const int f_done = owned<int, PL>(s_fn, pl, kflat);
      const int kn = owned<int, PL>(s_node, pl, kflat);
      const float v = owned<float, PL>(s_p, pl, kflat);
#pragma unroll
      for (int q = 0; q < pl; ++q) {
        const int e = lane * pl + q;
        if (e == kflat) s_fin[q] = inf;
        if (e == kn) n_busy[q] -= 1;
      }
      nx_key = least_key<PL>(s_fin, pl);
      nx_t = key_float(nx_key);
      if (lane == 0) {
        const int ec = kn * F + f_done;
        const int rl = e_rlen[ec], pos = e_rpos[ec];
        const bool full = rl == W;
        float* const rg = ring + static_cast<size_t>(ec) * W;
        e_rsum[ec] =
            __fsub_rn(__fadd_rn(e_rsum[ec], v), full ? rg[pos] : 0.0f);
        rg[pos] = v;
        e_rlen[ec] = full ? rl : rl + 1;
        e_rpos[ec] = pos + 1 == W ? 0 : pos + 1;
      }
      k_d = kn;
    }

    // -- dispatch on the node the event touched, when it has a free slot
    // and a call queued: the least frozen priority, then the least row
    if (k_d < 0 || k_d >= NN) continue;
    const int busy_kd = owned<int, PL>(n_busy, pl, k_d);
    const int qn_kd = owned<int, PL>(n_qn, pl, k_d);
    if (busy_kd >= cores || (counted && qn_kd <= 0)) continue;
    const QN mine = static_cast<QN>(k_d);
    unsigned bk = NO_KEY;
    int bj = INT_MAX;
    int i = (lo & ~31) + lane;
    if (i < lo) i += 32;
    for (; i < hi; i += 32) {
      if (q_node[i] == mine) {
        const unsigned k = q_key[i];
        if (k < bk) { bk = k; bj = i; }
      }
    }
    const unsigned kmin = __reduce_min_sync(FULL, bk);
    if (kmin >= KEY_INF) continue;     // nothing queued below +inf
    const int j = __reduce_min_sync(FULL, bk == kmin ? bj : INT_MAX);
    const float chan_kd = owned<float, PL>(n_chan, pl, k_d);
    // ... into its first free slot below cores (slot 0 if none)
    int se = INT_MAX;
#pragma unroll
    for (int q = pl - 1; q >= 0; --q)
      if (s_node[q] == k_d && s_slot[q] < cores && isinf(s_fin[q]))
        se = lane * pl + q;
    se = __reduce_min_sync(FULL, se);
    const bool none_free = se == INT_MAX;
    if (none_free) se = k_d * NS;
    const float cost_j = R.cost(j), p_j = R.p(j);
    const int f_j = R.fn(j);
    const float exec_start = __fadd_rn(fmaxf(now, chan_kd), cost_j);
    const float fin_j = __fadd_rn(exec_start, p_j);
#pragma unroll
    for (int q = 0; q < pl; ++q) {
      const int e = lane * pl + q;
      if (e == se) { s_fin[q] = fin_j; s_fn[q] = f_j; s_p[q] = p_j; }
      if (e == k_d) { n_chan[q] = exec_start; n_busy[q] += 1; n_qn[q] -= 1; }
    }
    if ((j & 31) == lane) {
      q_node[j] = kNone;
      o_start[j] = exec_start;
      o_finish[j] = fin_j;
    }
    // the new call may complete first; a call put into a busy slot (a
    // carry with no free slot below cores) takes a fresh look
    if (none_free) {
      nx_key = least_key<PL>(s_fin, pl);
      nx_t = key_float(nx_key);
    } else {
      const unsigned kj = order_key(fin_j);
      if (kj < nx_key) { nx_key = kj; nx_t = fin_j; }
    }
    // the first queued row moves past the rows no longer queued, 32 at a
    // time (row i read by lane i % 32)
    if (j == lo) {
      for (int base = lo & ~31;; base += 32) {
        const int r = base + lane;
        const unsigned m = __ballot_sync(
            FULL, r >= lo && r < hi && q_node[r] != kNone);
        if (m != 0) { lo = base + __ffs(m) - 1; break; }
        if (base + 32 >= hi) { lo = hi; break; }
      }
    }
  }
}

template <int PL, bool STAGED>
int launch_freeze(const FArgs& a, const FLayout& L, const FDims& D, int cell,
                  float horizon, cudaStream_t stream, int pl, int words) {
  auto kernel = freeze_kernel<PL, STAGED>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, L, D, cpb, cell, horizon, pl, words);
  return static_cast<int>(cudaGetLastError());
}

template <int PL>
int launch_freeze_pl(bool staged, const FArgs& a, const FLayout& L,
                     const FDims& D, int cell, float horizon,
                     cudaStream_t stream, int words) {
  return staged
             ? launch_freeze<PL, true>(a, L, D, cell, horizon, stream, PL,
                                       words)
             : launch_freeze<PL, false>(a, L, D, cell, horizon, stream, PL,
                                        words);
}

// ---------------------------------------------------------------------------
// The float64 pull regime: pull cells with capacity dynamics (scheduled node
// failures, the autoscaler; `dyn`), node speeds (`het`) and the cold-start
// containers (`cold`, the warm=False regime with ample memory), the dyn /
// het / cold branches of _scan_cell_kernel that the JAX package runs as
// XLA's lax.scan in float64 (repro/core/fastpath.py:821; its Pallas kernel
// covers the base pull configuration only).  The plain PyTorch version is
// repro_torch/kernels/event_step.py::event_step_ref with dyn / het / cold.
//
// What bounds it: the same serial chain of one event a step as the pull
// kernel above, now of up to 2 n + the dynamics' budget steps, each a few
// dependent loads and float64 warp reductions.  The design keeps that
// chain short and simple rather than lean: a first, exact kernel.
// - One warp a cell, several a block; rows t / p / cost (float64) and fnid
//   (8 bits) staged in shared memory when they fit (n_b up to ~9,000),
//   read in place past that (ops.event_step_plan(..., f64=True)).  The
//   runtime ring is in shared memory.
// - Lane-owned state: lane l owns slots l*PL .. l*PL+PL-1 (PL up to 8) and
//   node l and function l, in registers.  A cell of more than 256 slots or
//   32 nodes or functions takes the wide path (PL = 0): the same arrays in
//   a device-memory scratch (entry q of a lane at [q][lane]), ring
//   included.
// - Six candidate events a step, taken in the oracle's precedence (kill <
//   arrival <= completion < re-arrival < activation < tick, the first
//   minimum wins).  Each candidate is carried from step to step as a
//   warp-uniform value -- the earliest kill, completion, re-arrival and
//   pending activation, with their index -- and found again by a warp
//   reduction only when the event that moves it happens.
// - The rows a kill loses: their re-arrival times, the re-queued flags,
//   the clock each was last pulled at and the time each re-entered the
//   queue are per-row arrays in the scratch, with counts, so a step scans
//   them only while a re-arrival is pending or a re-queued call waits.
// - Float64 reductions: a 64-bit order-preserving key (-0.0 as +0.0), its
//   minimum by two redux.sync over its halves, then the least index among
//   the lanes holding it.
// - The FC window as a running count, as in the pull kernel (the events
//   come in time order here too: every new candidate is now plus a
//   non-negative delay).
// - Lane 0 writes a dispatch's record, so the last dispatch of a call lost
//   to a kill and dispatched again is the one that stays; the outputs of a
//   call never dispatched stay 0.  At the end the cell's calls lost and
//   done, nodes provisioned, activation times and dead flags go to the
//   summary outputs.
// - Cold starts (COLD, a template parameter: as a runtime flag its state
//   cost the dyn / het buckets 1-9% of their time, registers being tight
//   at 128 a thread): each (node, function)'s free containers are a count
//   in shared memory after the rows (in the scratch on the wide path),
//   read and written by lane 0 alone, which hands the warm-hit bit to the
//   warp: a completion returns its container (or, at `cores` free ones,
//   evicts it), a dispatch takes one or starts cold, adding the prewarm
//   charge kPrewarmExtra to its management cost before the node's speed
//   divides it.  The cold starts and evictions are warp-uniform counts;
//   each row's flag starts as the carry's and lane 0 writes it at
//   dispatch, so the last dispatch's stays.
// Bit-identity: --fmad=false, no fast math; _rn float64 arithmetic in the
// oracle's order as XLA compiles it: a dispatch's cost and runtime on a
// node of speed s slowed by d are (x * d) / s (the oracle writes x / (s /
// d), which XLA's algebraic simplifier rewrites so), the slowdown a
// product in episode order.
// ---------------------------------------------------------------------------

constexpr int kDLayout = 30;  // carry entries, see struct DLayout
constexpr int kDDims = 16;    // integer launch dimensions, see struct DDims
constexpr int kDPlan = 5;     // per_lane, staged, wide, cell_bytes, words
// Offsets of the carry entries: the first twelve in the clk plane, the rest
// in the ctr plane (EVENT_STEP_DYN_LAYOUT in ops.py); the entries of a
// segment the bucket lacks (dyn, cold) are 0.
struct DLayout {
  int chan, fin_s, last_t, prev_t, ring, rsum, act_t, killq, rearr,
      next_tick, rq_rt, enq_t;
  int ai, busy, head, idx_s, narr, qn, rlen, rpos, dead, act_pend, prov,
      nfail, ndone, xq, freec, ncold, nevt, coldq;
};

struct DDims {
  int B, n, n_nodes, n_slots, window, n_fns, kq, ncoef, n_ep, f_len, i_len,
      use_fc, dyn, het, cold, n_steps;
};

struct DArgs {
  const double* clk;
  const int* ctr;
  const double* t;
  const int* fnid;
  const double* p;
  const double* cost;
  const double* coef;
  const int* cores;
  const int* nodes;
  const int* fn_ev;
  const double* dynp;
  const int* maxn;
  const int* nreq;
  const double* spd;
  const int* epn;
  const double* ept0;
  const double* ept1;
  const double* epf;
  double* start;
  double* finish;
  double* prio;
  int* node;
  int* summ;         // (B, 3): calls lost, calls done, nodes provisioned
  double* act_out;   // (B, nodes): activation times at the end
  int* dead_out;     // (B, nodes): dead flags at the end
  int* cold_out;     // (B, 2): cold starts, evictions
  int* coldq_out;    // (B, n + 1): each row's cold-start flag
  uint32_t* scratch;
};

// Shared-memory bytes of one cell (register path): the ring, when staged
// the rows, then `nfree` free-container counts.
// ops.event_step_dyn_cell_bytes computes the same.
__host__ __device__ constexpr int dyn_cell_bytes(bool staged, int n1, int F,
                                                 int W, int nfree) {
  return 8 * round_up(F * W, 2) +
         (staged ? 24 * round_up(n1, 2) + round_up(n1, 16) : 0) +
         4 * round_up(nfree, 4);
}

// Scratch words of one cell: on the wide path the ring, the lane-owned
// arrays (3 words a slot, 11 a node, 16 a function) and the `nfree`
// free-container counts, then with dynamics the per-row arrays
// (re-arrival time, last pull clock, enqueue time: two words each;
// re-queued flag: one) and each function's pull-time base.
// ops.event_step_plan computes the same.
__host__ __device__ constexpr long dyn_scratch_words(bool wide, int pls,
                                                     int pln, int plf,
                                                     int n1, int F, int W,
                                                     bool dyn, int nfree) {
  return (wide ? 2L * round_up(F * W, 2) +
                     32L * (3 * pls + 11 * pln + 16 * plf) +
                     round_up(nfree, 2)
               : 0L) +
         (dyn ? 7L * round_up(n1, 2) + 2L * F : 0L);
}

template <int PL, bool STAGED, bool COLD>
__global__ void __launch_bounds__(32 * kMaxCellsPerBlock)
    dyn_kernel(const DArgs a, const DLayout L, const DDims D,
               const int cells_per_block, const int bytes_per_cell,
               const float horizon_f, const int pl_wide, const int words) {
  static_assert(PL > 0 || !STAGED, "the wide path reads rows in place");
  constexpr int NQ = PL > 0 ? 1 : 0;   // nodes / functions a lane: 1, or
                                       // the scratch
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * cells_per_block + warp;
  if (b >= D.B) return;

  const int n = D.n, n1 = D.n + 1;
  const int NN = D.n_nodes, NS = D.n_slots, NSL = D.n_nodes * D.n_slots;
  const int F = D.n_fns, W = D.window, kq = D.kq;
  const bool DYN = D.dyn != 0, HET = D.het != 0;
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  const double horizon = static_cast<double>(horizon_f);
  const size_t row = static_cast<size_t>(b) * n1;
  const double* clk = a.clk + static_cast<size_t>(b) * D.f_len;
  const int* ctr = a.ctr + static_cast<size_t>(b) * D.i_len;
  // entries a lane owns: slots, nodes, functions
  const int pls = PL > 0 ? PL : pl_wide;
  const int pln = PL > 0 ? 1 : (NN + 31) / 32;
  const int plf = PL > 0 ? 1 : (F + 31) / 32;

  // -- the cell's scratch: (wide) the ring and the lane arrays, then the
  // per-row dynamics arrays and the functions' bases
  uint32_t* cw = a.scratch == nullptr
                     ? nullptr
                     : a.scratch + static_cast<size_t>(b) * words;
  uint32_t* wp = cw;
  double* ring;
  if constexpr (PL == 0) {
    ring = reinterpret_cast<double*>(wp);
    wp += 2 * round_up(F * W, 2);
  } else {
    ring = reinterpret_cast<double*>(smem + static_cast<size_t>(warp) *
                                                bytes_per_cell);
  }
  // a lane-owned double array of `cnt` entries a lane (wide: scratch)
  auto dbl = [&](int cnt) {
    double* p = reinterpret_cast<double*>(wp) + lane;
    if constexpr (PL == 0) wp += 64 * cnt;
    return p;
  };
  auto i32 = [&](int cnt) {
    int* p = reinterpret_cast<int*>(wp) + lane;
    if constexpr (PL == 0) wp += 32 * cnt;
    return p;
  };
  Lane<double, PL> s_fin(dbl(pls));
  Lane<double, NQ> n_chan(dbl(pln)), n_act(dbl(pln)), n_kill(dbl(pln)),
      n_spd(dbl(pln));
  Lane<double, NQ> f_rsum(dbl(plf)), f_last(dbl(plf)), f_prev(dbl(plf)),
      f_est(dbl(plf)), f_th(dbl(plf));
  Lane<int, PL> s_row(i32(pls));
  Lane<int, NQ> n_busy(i32(pln)), n_dead(i32(pln)), n_pend(i32(pln));
  Lane<int, NQ> f_head(i32(plf)), f_narr(i32(plf)), f_rlen(i32(plf)),
      f_rpos(i32(plf)), f_cnt(i32(plf)), f_idx(i32(plf));
  // per-row dynamics arrays and the functions' bases
  double* const r_rearr = reinterpret_cast<double*>(wp);
  double* const r_rqrt = r_rearr + round_up(n1, 2);
  double* const r_enq = r_rqrt + round_up(n1, 2);
  double* const f_base = r_enq + round_up(n1, 2);
  int* const r_xq = reinterpret_cast<int*>(f_base + F);
  // the free containers of each (node, function): after the rows in
  // shared memory, or (wide) after the dynamics arrays in the scratch
  int* fcnt;
  if constexpr (PL == 0) {
    fcnt = reinterpret_cast<int*>(wp) +
           (DYN ? 7 * round_up(n1, 2) + 2 * F : 0);
  } else {
    fcnt = reinterpret_cast<int*>(
        smem + static_cast<size_t>(warp) * bytes_per_cell +
        8 * round_up(F * W, 2) +
        (STAGED ? 24 * round_up(n1, 2) + round_up(n1, 16) : 0));
  }
  int* const o_coldq = COLD ? a.coldq_out + row : nullptr;

  DRows<STAGED> R;
  if constexpr (STAGED) {
    double* st = ring + round_up(F * W, 2);
    double* sp = st + round_up(n1, 2);
    double* sc = sp + round_up(n1, 2);
    uint8_t* sfn = reinterpret_cast<uint8_t*>(sc + round_up(n1, 2));
    for (int i = lane; i < n1; i += 32) {
      st[i] = __ldg(a.t + row + i);
      sp[i] = __ldg(a.p + row + i);
      sc[i] = __ldg(a.cost + row + i);
    }
    stage8(sfn, a.fnid + row, n1, lane);
    R = DRows<STAGED>{st, sp, sc, sfn};
  } else {
    R = DRows<STAGED>{a.t + row, a.p + row, a.cost + row, a.fnid + row};
  }
  for (int i = lane; i < F * W; i += 32) ring[i] = __ldg(clk + L.ring + i);
  // the per-row dynamics carry into the scratch, with its counts
  int n_re = 0, n_xq = 0;
  if (DYN) {
    for (int i = lane; i < n1; i += 32) {
      r_rearr[i] = __ldg(clk + L.rearr + i);
      r_rqrt[i] = __ldg(clk + L.rq_rt + i);
      r_enq[i] = __ldg(clk + L.enq_t + i);
      r_xq[i] = __ldg(ctr + L.xq + i);
      n_re += r_rearr[i] != inf;
      n_xq += r_xq[i] != 0;
    }
    n_re = __reduce_add_sync(FULL, n_re);
    n_xq = __reduce_add_sync(FULL, n_xq);
  }
  // the container carry: the free counts, each row's flag into its output
  int ncold = 0, nevt = 0;
  if constexpr (COLD) {
    for (int i = lane; i < NN * F; i += 32) fcnt[i] = __ldg(ctr + L.freec + i);
    for (int i = lane; i < n1; i += 32) o_coldq[i] = __ldg(ctr + L.coldq + i);
    ncold = __ldg(ctr + L.ncold);
    nevt = __ldg(ctr + L.nevt);
  }
  __syncwarp();

  const double* cf = a.coef + static_cast<size_t>(b) * D.ncoef;
  const double c0 = __ldg(cf), c1 = __ldg(cf + 1), c2 = __ldg(cf + 2),
               c3 = __ldg(cf + 3), c4 = DYN ? __ldg(cf + 4) : 0.0;
  const int cores = __ldg(a.cores + b), nodes = __ldg(a.nodes + b);
  double interval = 0.0, thr = 0.0, delay = 0.0, detect = 0.0;
  int maxn = 0, nreq = 0;
  if (DYN) {
    const double* dp = a.dynp + static_cast<size_t>(b) * 5;
    interval = __ldg(dp);
    thr = __ldg(dp + 1);
    delay = __ldg(dp + 2);
    detect = __ldg(dp + 3);
    maxn = __ldg(a.maxn + b);
    nreq = __ldg(a.nreq + b);
  }
  const int* epn = HET ? a.epn + static_cast<size_t>(b) * D.n_ep : nullptr;
  const double* ept0 =
      HET ? a.ept0 + static_cast<size_t>(b) * D.n_ep : nullptr;
  const double* ept1 =
      HET ? a.ept1 + static_cast<size_t>(b) * D.n_ep : nullptr;
  const double* epf = HET ? a.epf + static_cast<size_t>(b) * D.n_ep : nullptr;

  // -- the carry, from the planes into the owning lanes
#pragma unroll
  for (int q = 0; q < pls; ++q) {
    const int e = lane * pls + q;
    s_fin[q] = e < NSL ? __ldg(clk + L.fin_s + e) : inf;
    s_row[q] = e < NSL ? min(max(__ldg(ctr + L.idx_s + e), 0), n) : n;
  }
  int qsum = 0;       // the calls queued: the sum of the carry's qn
  for (int q = 0; q < pln; ++q) {
    const int e = lane * pln + q;
    const bool ne = e < NN;
    n_busy[q] = ne ? __ldg(ctr + L.busy + e) : 0;
    n_chan[q] = ne ? __ldg(clk + L.chan + e) : 0.0;
    qsum += ne ? __ldg(ctr + L.qn + e) : 0;
    n_act[q] = ne && DYN ? __ldg(clk + L.act_t + e) : 0.0;
    n_kill[q] = ne && DYN ? __ldg(clk + L.killq + e) : inf;
    n_dead[q] = ne && DYN ? __ldg(ctr + L.dead + e) : 0;
    n_pend[q] = ne && DYN ? __ldg(ctr + L.act_pend + e) : 0;
    n_spd[q] = ne && HET ? __ldg(a.spd + static_cast<size_t>(b) * NN + e)
                         : 1.0;
  }
  qsum = __reduce_add_sync(FULL, qsum);
  const int* const fn_ev = a.fn_ev + static_cast<size_t>(b) * F * kq;
  for (int q = 0; q < plf; ++q) {
    const int e = lane * plf + q;
    const bool fe = e < F;
    f_head[q] = fe ? __ldg(ctr + L.head + e) : 0;
    f_narr[q] = fe ? __ldg(ctr + L.narr + e) : 0;
    f_rlen[q] = fe ? __ldg(ctr + L.rlen + e) : 0;
    f_rpos[q] = fe ? __ldg(ctr + L.rpos + e) : 0;
    f_rsum[q] = fe ? __ldg(clk + L.rsum + e) : 0.0;
    f_last[q] = fe ? __ldg(clk + L.last_t + e) : 0.0;
    f_prev[q] = fe ? __ldg(clk + L.prev_t + e) : 0.0;
    f_est[q] = f_rlen[q] > 0
                   ? __ddiv_rn(f_rsum[q], static_cast<double>(f_rlen[q]))
                   : 0.0;
    f_idx[q] = fe ? __ldg(fn_ev + e * kq + min(f_head[q], kq - 1)) : n;
    f_th[q] = R.t(f_idx[q]);
    f_cnt[q] = 0;
  }
  int ai = __ldg(ctr + L.ai);
  // FC counts of the arrivals the carry has already taken
  for (int i = 0; i < ai && i < n; ++i) {
    const int f = R.fn(i);
    if (R.t(i) != inf)
      for (int q = 0; q < plf; ++q)
        if (lane * plf + q == f) f_cnt[q] += 1;
  }
  int k0 = 0;
  double t_k0 = R.t(0), t_km1 = -inf;
  double t_a = ai <= n ? R.t(ai) : inf;
  int f_a = R.fn(min(ai, n));
  int nfail = DYN ? __ldg(ctr + L.nfail) : 0;
  int ndone = DYN ? __ldg(ctr + L.ndone) : 0;
  int prov = DYN ? __ldg(ctr + L.prov) : 0;
  double next_tick = DYN ? __ldg(clk + L.next_tick) : inf;

  // the warp-uniform candidates: earliest completion, kill, re-arrival and
  // pending activation (each found again when its event moves it)
  unsigned long long nx_key;
  double nx_t;
  auto find_completion = [&]() {
    unsigned long long k = NO_KEY64;
#pragma unroll
    for (int q = 0; q < pls; ++q) k = min(k, order_key64(s_fin[q]));
    nx_key = warp_min64(k);
    nx_t = nx_key == NO_KEY64 ? inf : key_double(nx_key);
  };
  double kill_t = inf, act_min = inf;
  int kill_k = 0, act_k = 0;
  auto find_node = [&](bool kill) {
    unsigned long long k = NO_KEY64;
    int idx = INT_MAX;
    for (int q = 0; q < pln; ++q) {
      const int e = lane * pln + q;
      const double v = kill ? n_kill[q] : (n_pend[q] ? n_act[q] : inf);
      const unsigned long long kv = order_key64(v);
      if (e < NN && kv < k) { k = kv; idx = e; }
    }
    int at;
    const unsigned long long m = warp_argmin64(k, idx, &at);
    const double v = m == NO_KEY64 ? inf : key_double(m);
    if (kill) { kill_t = v; kill_k = at == INT_MAX ? 0 : at; }
    else { act_min = v; act_k = at == INT_MAX ? 0 : at; }
  };
  double re_min = inf;
  auto find_rearr = [&]() {     // the least re-arrival time
    __syncwarp();
    unsigned long long k = NO_KEY64;
    for (int i = lane; i < n1; i += 32) k = min(k, order_key64(r_rearr[i]));
    k = warp_min64(k);
    re_min = k == NO_KEY64 ? inf : key_double(k);
  };
  find_completion();
  if (DYN) {
    find_node(true);
    find_node(false);
    if (n_re > 0) find_rearr();
  }

  double* const o_start = a.start + row;
  double* const o_finish = a.finish + row;
  double* const o_prio = a.prio + row;
  int* const o_node = a.node + row;

  for (int step = 0; step < D.n_steps; ++step) {
    // -- event selection: kill < arrival <= completion < re-arrival <
    // activation < tick (the first minimum wins)
    double now = kill_t;
    int ev = 0;
    if (t_a < now) { now = t_a; ev = 1; }
    if (nx_t < now) { now = nx_t; ev = 2; }
    if (re_min < now) { now = re_min; ev = 3; }
    if (act_min < now) { now = act_min; ev = 4; }
    if (next_tick < now) { now = next_tick; ev = 5; }
    if (now == inf) break;      // no event left: the carry is fixed

    int ir = n;     // the re-arriving row (ev 3)
    if (ev == 2) {
      // -- completion: free the slot and its node, feed the ring
      int ce = INT_MAX;
      for (int q = pls - 1; q >= 0; --q)
        if (order_key64(s_fin[q]) == nx_key) ce = lane * pls + q;
      const int kflat = __reduce_min_sync(FULL, ce);
      const int j_done = lane_get(s_row, pls, kflat);
      const int kn = kflat / NS;
#pragma unroll
      for (int q = 0; q < pls; ++q)
        if (lane * pls + q == kflat) s_fin[q] = inf;
      for (int q = 0; q < pln; ++q)
        if (lane * pln + q == kn) n_busy[q] -= 1;
      const int f_done = R.fn(j_done);
      const double v = R.p(j_done);
      for (int q = 0; q < plf; ++q) {
        if (lane * plf + q == f_done) {
          const bool full = f_rlen[q] == W;
          const int pos = f_rpos[q];
          const double old = ring[f_done * W + pos];
          f_rsum[q] = __dsub_rn(__dadd_rn(f_rsum[q], v), full ? old : 0.0);
          ring[f_done * W + pos] = v;
          if (!full) f_rlen[q] += 1;
          f_rpos[q] = pos + 1 == W ? 0 : pos + 1;
          f_est[q] = __ddiv_rn(f_rsum[q], static_cast<double>(f_rlen[q]));
        }
      }
      if constexpr (COLD) {
        // release: the container returns to its node's free pool of the
        // function, or is evicted when the pool holds `cores`
        int evict = 0;
        if (lane == 0) {
          int& c = fcnt[kn * F + f_done];
          evict = c >= cores;
          if (!evict) c += 1;
        }
        nevt += __shfl_sync(FULL, evict, 0);
      }
      ndone += 1;
      find_completion();
    } else if (ev == 0) {
      // -- kill: the node's running calls re-arrive after the detection
      // delay; its slots are freed and it is dead (the queue stays)
      const int kk = kill_k;
      const double back = __dadd_rn(now, detect);
      int lost = 0;
#pragma unroll
      for (int q = 0; q < pls; ++q) {
        const int e = lane * pls + q;
        if (e < NSL && e / NS == kk) {
          if (s_fin[q] != inf) {
            r_rearr[s_row[q]] = back;
            ++lost;
          }
          s_fin[q] = inf;
        }
      }
      lost = __reduce_add_sync(FULL, lost);
      for (int q = 0; q < pln; ++q) {
        if (lane * pln + q == kk) {
          n_busy[q] = 0;
          n_dead[q] = 1;
          n_kill[q] = inf;
        }
      }
      nfail += lost;
      n_re += lost;
      if (lost > 0) re_min = back < re_min ? back : re_min;
      find_node(true);
      find_completion();
      __syncwarp();
    } else if (ev == 5) {
      // -- autoscaler tick: provision one node while the queue per live
      // slot is above the threshold
      const bool alldone = ndone >= nreq;
      int alive = 0;
      for (int q = 0; q < pln; ++q) {
        const int e = lane * pln + q;
        alive += e < NN && n_act[q] <= now && !n_dead[q];
      }
      alive = __reduce_add_sync(FULL, alive);
      const bool fire =
          !alldone && prov < maxn &&
          static_cast<double>(qsum) >
              __dmul_rn(thr, static_cast<double>(max(alive * cores, 1)));
      if (fire) {
        for (int q = 0; q < pln; ++q) {
          if (lane * pln + q == prov) {
            n_act[q] = __dadd_rn(now, delay);
            n_pend[q] = 1;
          }
        }
        ++prov;
        find_node(false);
      }
      next_tick = alldone ? inf : __dadd_rn(now, interval);
    } else if (ev == 3) {
      // -- re-arrival: the first row due joins the queue again
      __syncwarp();
      int first = INT_MAX;
      for (int i = lane; i < n1; i += 32)
        if (r_rearr[i] == re_min) { first = i; break; }
      ir = __reduce_min_sync(FULL, first);
      if (lane == 0) {
        r_rearr[ir] = inf;
        r_xq[ir] = 1;
      }
      n_re -= 1;
      n_xq += 1;
      ++qsum;
      if (n_re > 0) find_rearr(); else re_min = inf;
    } else if (ev == 1) {
      // -- arrival: enqueue, observe on the controller estimator
      for (int q = 0; q < plf; ++q) {
        if (lane * plf + q == f_a) {
          f_prev[q] = f_narr[q] == 0 ? now : f_last[q];
          f_last[q] = now;
          f_narr[q] += 1;
          f_cnt[q] += 1;
        }
      }
      ++ai;
      ++qsum;
      t_a = ai <= n ? R.t(ai) : inf;
      f_a = R.fn(min(ai, n));
    }
    // ev 4 (activation) changes nothing before the dispatch

    // -- dispatch: on an arrival, completion, re-arrival or activation
    bool can = false;
    if (ev >= 1 && ev <= 4) {
      bool q_any = n_xq > 0;
      for (int q = 0; q < plf; ++q) q_any |= f_head[q] < f_narr[q];
      q_any = __any_sync(FULL, q_any);
      if (q_any) {
        if (D.use_fc) {
          // -- FC window: k0 passes the rows at or before now - horizon
          const double lim = __dsub_rn(now, horizon);
          while (k0 < n && t_k0 <= lim) {
            const int f = R.fn(k0);
            if (t_k0 != inf)
              for (int q = 0; q < plf; ++q)
                if (lane * plf + q == f) f_cnt[q] -= 1;
            t_km1 = t_k0;
            ++k0;
            t_k0 = R.t(k0);
          }
          while (k0 > 0 && t_km1 > lim) {     // only if lim fell
            --k0;
            t_k0 = t_km1;
            t_km1 = k0 > 0 ? R.t(k0 - 1) : -inf;
            const int f = R.fn(k0);
            if (t_k0 != inf)
              for (int q = 0; q < plf; ++q)
                if (lane * plf + q == f) f_cnt[q] += 1;
          }
        }
        // the active invoker with the most free slots (first on ties)
        int bx = INT_MIN, be = INT_MAX;
        for (int q = 0; q < pln; ++q) {
          const int e = lane * pln + q;
          const bool act =
              DYN ? (n_act[q] <= now && !n_dead[q]) : e < nodes;
          const int x = act ? cores - n_busy[q] : -1;
          if (e < NN && x > bx) { bx = x; be = e; }
        }
        const int xmax = __reduce_max_sync(FULL, bx);
        const int k_d = __reduce_min_sync(FULL, bx == xmax ? be : INT_MAX);
        const int busy_kd = lane_get(n_busy, pln, k_d);
        const double chan_kd = lane_get(n_chan, pln, k_d);
        bool ok = busy_kd < cores;
        if (DYN)
          ok = ok && lane_get(n_act, pln, k_d) <= now &&
               !lane_get(n_dead, pln, k_d);
        // the best queue head: least priority, then least event index
        unsigned long long pk = NO_KEY64;
        int pj = INT_MAX;
        double pv = 0.0;
        for (int q = 0; q < plf; ++q) {
          double w = c2;
          if (D.use_fc)
            w = __dadd_rn(c2, __dmul_rn(c3, static_cast<double>(f_cnt[q])));
          const double base = __dadd_rn(__dmul_rn(c1, f_prev[q]),
                                        __dmul_rn(w, f_est[q]));
          double pr = __dadd_rn(__dmul_rn(c0, f_th[q]), base);
          if (DYN) pr = __dadd_rn(pr, __dmul_rn(c4, now));
          const unsigned long long k =
              f_head[q] < f_narr[q] ? order_key64(pr) : NO_KEY64;
          if (k < pk || (k == pk && f_idx[q] < pj)) {
            pk = k; pj = f_idx[q]; pv = pr;
          }
          if (DYN && n_xq > 0 && lane * plf + q < F)
            f_base[lane * plf + q] = base;
        }
        int j;
        const unsigned long long pmin = warp_argmin64(pk, pj, &j);
        double prio_j = inf;
        if (pmin == NO_KEY64) {
          j = n;
        } else {
          const unsigned win = __ballot_sync(FULL, pk == pmin && pj == j);
          prio_j = __shfl_sync(FULL, pv, __ffs(win) - 1);
        }
        bool pick_x = false;
        if (DYN && n_xq > 0) {
          // a re-queued call ranks by the clock it was last pulled at and
          // wins an equal priority only if it re-entered the queue before
          // the head arrived
          __syncwarp();
          unsigned long long xk = NO_KEY64;
          int xj = INT_MAX;
          double xv = 0.0;
          for (int i = lane; i < n; i += 32) {
            if (r_xq[i]) {
              const double px = __dadd_rn(
                  __dadd_rn(__dmul_rn(c0, R.t(i)), f_base[R.fn(i)]),
                  __dmul_rn(c4, r_rqrt[i]));
              const unsigned long long k = order_key64(px);
              if (k < xk) { xk = k; xj = i; xv = px; }
            }
          }
          int j_x;
          const unsigned long long xmin = warp_argmin64(xk, xj, &j_x);
          if (xmin != NO_KEY64) {
            const unsigned win =
                __ballot_sync(FULL, xk == xmin && xj == j_x);
            const double best_x = __shfl_sync(FULL, xv, __ffs(win) - 1);
            pick_x = best_x < prio_j ||
                     (best_x == prio_j && r_enq[j_x] < R.t(j));
            if (pick_x) j = j_x;
            prio_j = best_x < prio_j ? best_x : prio_j;
          }
          __syncwarp();
        }
        can = ok && (DYN ? prio_j < inf : j < n);
        if (can) {
          double cost_j = R.cost(j), p_j = R.p(j);
          if constexpr (COLD) {
            // acquire: a free container of the node and function is a
            // warm hit, else a prewarmed one starts cold
            int hit = 0;
            if (lane == 0) {
              int& c = fcnt[k_d * F + R.fn(j)];
              hit = c > 0;
              if (hit) c -= 1;
              o_coldq[j] = !hit;
            }
            hit = __shfl_sync(FULL, hit, 0);
            cost_j = __dadd_rn(cost_j, hit ? 0.0 : kPrewarmExtra);
            ncold += !hit;
          }
          if (HET) {
            // the node's speed at dispatch divides cost and runtime
            double slow = 1.0;
            for (int ep = 0; ep < D.n_ep; ++ep)
              if (__ldg(epn + ep) == k_d && __ldg(ept0 + ep) <= now &&
                  now < __ldg(ept1 + ep))
                slow = __dmul_rn(slow, __ldg(epf + ep));
            // (x * slowdown) / speed: the oracle's x / (speed / slowdown)
            // as XLA's algebraic simplifier compiles it
            const double spd_k = lane_get(n_spd, pln, k_d);
            cost_j = __ddiv_rn(__dmul_rn(cost_j, slow), spd_k);
            p_j = __ddiv_rn(__dmul_rn(p_j, slow), spd_k);
          }
          const double exec_start = __dadd_rn(fmax(now, chan_kd), cost_j);
          const double fin_j = __dadd_rn(exec_start, p_j);
          // the first free slot below cores of the node
          int se = INT_MAX;
          for (int q = pls - 1; q >= 0; --q) {
            const int e = lane * pls + q;
            if (e < NSL && e / NS == k_d && e % NS < cores && s_fin[q] == inf)
              se = e;
          }
          se = __reduce_min_sync(FULL, se);
          const bool none_free = se == INT_MAX;   // (a carry with no free
          if (none_free) se = k_d * NS;           // slot: slot 0, as JAX)
#pragma unroll
          for (int q = 0; q < pls; ++q) {
            if (lane * pls + q == se) { s_fin[q] = fin_j; s_row[q] = j; }
          }
          for (int q = 0; q < pln; ++q) {
            if (lane * pln + q == k_d) {
              n_chan[q] = exec_start;
              n_busy[q] += 1;
            }
          }
          --qsum;
          if (pick_x) {
            if (lane == 0) r_xq[j] = 0;
            n_xq -= 1;
          } else {
            const int f_j = R.fn(j);
            for (int q = 0; q < plf; ++q) {
              if (lane * plf + q == f_j) {
                f_head[q] += 1;
                f_idx[q] = __ldg(fn_ev + f_j * kq + min(f_head[q], kq - 1));
                f_th[q] = R.t(f_idx[q]);
              }
            }
          }
          if (lane == 0) {
            if (DYN) r_rqrt[j] = now;
            o_start[j] = exec_start;
            o_finish[j] = fin_j;
            o_prio[j] = prio_j;
            o_node[j] = k_d;
          }
          if (none_free) {
            find_completion();
          } else {
            const unsigned long long kj = order_key64(fin_j);
            if (kj < nx_key) { nx_key = kj; nx_t = fin_j; }
          }
        }
      }
    }
    if (ev == 3 && lane == 0) r_enq[ir] = now;   // read above as it was
    if (ev == 4) {
      // the activation stays pending while the new node can take more
      const bool still = can && qsum > 0 &&
                         lane_get(n_busy, pln, act_k) < cores;
      if (!still) {
        for (int q = 0; q < pln; ++q)
          if (lane * pln + q == act_k) n_pend[q] = 0;
        find_node(false);
      }
    }
  }

  if (COLD && lane == 0) {
    a.cold_out[static_cast<size_t>(b) * 2] = ncold;
    a.cold_out[static_cast<size_t>(b) * 2 + 1] = nevt;
  }
  if (DYN) {
    int* const sm = a.summ + static_cast<size_t>(b) * 3;
    if (lane == 0) {
      sm[0] = nfail;
      sm[1] = ndone;
      sm[2] = prov;
    }
    for (int q = 0; q < pln; ++q) {
      const int e = lane * pln + q;
      if (e < NN) {
        a.act_out[static_cast<size_t>(b) * NN + e] = n_act[q];
        a.dead_out[static_cast<size_t>(b) * NN + e] = n_dead[q];
      }
    }
  }
}

template <int PL, bool STAGED, bool COLD>
int launch_dyn(const DArgs& a, const DLayout& L, const DDims& D, int cell,
               float horizon, cudaStream_t stream, int pl, int words) {
  auto kernel = dyn_kernel<PL, STAGED, COLD>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, L, D, cpb, cell, horizon, pl, words);
  return static_cast<int>(cudaGetLastError());
}

template <int PL, bool STAGED>
int launch_dyn_cold(bool cold, const DArgs& a, const DLayout& L,
                    const DDims& D, int cell, float horizon,
                    cudaStream_t stream, int pl, int words) {
  return cold ? launch_dyn<PL, STAGED, true>(a, L, D, cell, horizon, stream,
                                             pl, words)
              : launch_dyn<PL, STAGED, false>(a, L, D, cell, horizon, stream,
                                              pl, words);
}

template <int PL>
int launch_dyn_pl(bool staged, const DArgs& a, const DLayout& L,
                  const DDims& D, int cell, float horizon,
                  cudaStream_t stream, int words) {
  const bool cold = D.cold != 0;
  return staged ? launch_dyn_cold<PL, true>(cold, a, L, D, cell, horizon,
                                            stream, PL, words)
                : launch_dyn_cold<PL, false>(cold, a, L, D, cell, horizon,
                                             stream, PL, words);
}

// The instantiation of the bucket's segments: each of the seven sets of
// cold / het / dyn is compiled for 1 and 2 slots a lane in shared memory
// (ops.EVENT_STEP_FREEZE64_PER_LANE) and for the wide path; the hedged
// sets are compiled in csrc/event_step_hedge.cu and csrc/event_step_dup.cu,
// the resilience set in csrc/event_step_res.cu.
template <int PL>
int launch_f64_pl(const F64Args& a, const H64Args& h, const R64Args& r,
                  const F64Layout& L, const F64Dims& D, int cell,
                  float horizon, cudaStream_t stream, int pl, int words) {
  const int m = (D.cold ? 1 : 0) | (D.het ? 2 : 0) | (D.dyn ? 4 : 0);
#define SET(M, C, H, Y)                                                     \
  case M:                                                                   \
    return launch_f64<PL, C, H, Y>(a, h, r, L, D, cell, horizon, stream,    \
                                   pl, words);
  switch (m) {
    SET(1, true, false, false)
    SET(2, false, true, false)
    SET(3, true, true, false)
    SET(4, false, false, true)
    SET(5, true, false, true)
    SET(6, false, true, true)
    SET(7, true, true, true)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SET
}

int launch_f64_set(int pl_sel, const F64Args& a, const H64Args& h,
                   const R64Args& r, const F64Layout& L, const F64Dims& D,
                   int cell, float horizon, cudaStream_t stream, int pl,
                   int words) {
  switch (pl_sel) {
    case 0: return launch_f64_pl<0>(a, h, r, L, D, cell, horizon, stream,
                                    pl, words);
    case 1: return launch_f64_pl<1>(a, h, r, L, D, cell, horizon, stream,
                                    pl, words);
    case 2: return launch_f64_pl<2>(a, h, r, L, D, cell, horizon, stream,
                                    pl, words);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches the scan of D.B cells on `stream`.  `layout` holds the kLayout
// carry offsets, `dims` the kDims launch dimensions and `plan` the kPlan
// entries of ops.event_step_plan (entries per lane; rows staged in shared
// memory or not; shared-memory bytes a cell; scratch words a cell, which
// are 0 unless the cell takes the wide path), all in host memory.
// `scratch` holds D.B times the scratch words (null when they are 0).
// `cumf` is not read (see the FC window above).  Returns
// cudaGetLastError() after the launch, or the error that stopped it.
extern "C" int event_step_launch(
    const float* clk, const int* ctr, const float* t, const int* fnid,
    const float* p, const float* cost, const float* coef, const int* cores,
    const int* nodes, const float* cumf, const int* fn_ev, float* start,
    float* finish, float* prio, int* node, int* scratch, const int* layout,
    const int* dims, const int* plan, float horizon, void* stream) {
  (void)cumf;
  Layout L;
  Dims D;
  int P[kPlan];
  static_assert(sizeof(Layout) == kLayout * sizeof(int), "layout size");
  static_assert(sizeof(Dims) == kDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  std::memcpy(P, plan, sizeof(P));
  if (D.B == 0) return static_cast<int>(cudaSuccess);
  const int pl = P[0];
  const bool staged = P[1] != 0;
  const int cell = P[2];
  const int wide_words = P[3];
  const Args a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, fn_ev,
               start, finish, prio, node,
               reinterpret_cast<uint32_t*>(scratch)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (wide_words > 0) {
    const int widest = std::max({D.n_nodes * D.n_slots, D.n_nodes, D.n_fns});
    if (staged || scratch == nullptr || pl < 1 || 32 * pl < widest ||
        wide_words < scratch_words(pl, D.n_fns, D.window))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<0, false>(a, L, D, 0, horizon, s, pl, wide_words);
  }
  if (cell < cell_bytes(staged, D.n + 1, D.n_fns, D.window) ||
      cell % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl) {
    case 1: return launch_pl<1>(staged, a, L, D, cell, horizon, s);
    case 2: return launch_pl<2>(staged, a, L, D, cell, horizon, s);
    case 4: return launch_pl<4>(staged, a, L, D, cell, horizon, s);
    case 8: return launch_pl<8>(staged, a, L, D, cell, horizon, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the frozen-priority scan of D.B cells on `stream`.  `layout`
// holds the kFLayout carry offsets, `dims` the kFDims launch dimensions and
// `plan` the kFPlan entries of ops.event_step_freeze_plan (entries per lane;
// staged or not; wide or not; shared-memory bytes a cell; scratch words a
// cell), all in host memory.  `scratch` holds D.B times the scratch words
// (null when they are 0).  Returns cudaGetLastError() after the launch, or
// the error that stopped it.
extern "C" int event_step_freeze_launch(
    const float* clk, const int* ctr, const float* t, const int* fnid,
    const float* p, const float* cost, const float* coef, const int* cores,
    const int* nodes, const float* cnt, const int* home0, const int* route,
    float* start, float* finish, float* prio, int* node, int* scratch,
    const int* layout, const int* dims, const int* plan, float horizon,
    void* stream) {
  FLayout L;
  FDims D;
  int P[kFPlan];
  static_assert(sizeof(FLayout) == kFLayout * sizeof(int), "layout size");
  static_assert(sizeof(FDims) == kFDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  std::memcpy(P, plan, sizeof(P));
  if (D.B == 0) return static_cast<int>(cudaSuccess);
  const int pl = P[0];
  const bool staged = P[1] != 0, wide = P[2] != 0;
  const int cell = P[3], words = P[4];
  const int n1 = D.n + 1, E = D.n_nodes * D.n_fns;
  const int widest = std::max(D.n_nodes * D.n_slots, D.n_nodes);
  const FArgs a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, cnt, home0,
                route, start, finish, prio, node,
                reinterpret_cast<uint32_t*>(scratch)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (pl < 1 || 32 * pl < widest || D.fc_ring < 1 ||
      words != freeze_scratch_words(staged, wide, pl, n1, E, D.window,
                                    D.fc_push != 0, D.fc_ring) ||
      (words > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    if (staged || cell != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_freeze<0, false>(a, L, D, 0, horizon, s, pl, words);
  }
  if (staged ? (cell < freeze_cell_bytes(n1, E, D.window) || cell % 16 != 0 ||
                D.n_fns > 256)
             : cell != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl) {
    case 1:
      return launch_freeze_pl<1>(staged, a, L, D, cell, horizon, s, words);
    case 2:
      return launch_freeze_pl<2>(staged, a, L, D, cell, horizon, s, words);
    case 4:
      return launch_freeze_pl<4>(staged, a, L, D, cell, horizon, s, words);
    case 8:
      return launch_freeze_pl<8>(staged, a, L, D, cell, horizon, s, words);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the float64 pull scan (capacity dynamics with D.dyn, node speeds
// with D.het, cold starts with D.cold) of D.B cells on `stream`.  `layout`
// holds the kDLayout carry offsets, `dims` the kDDims launch dimensions and
// `plan` the kDPlan entries of ops.event_step_plan(..., f64=True) (slots a
// lane; staged or not; wide or not; shared-memory bytes a cell; scratch
// words a cell), all in host memory.  `dynp` / `maxn` / `nreq` and the
// summary outputs `summ` / `act_out` / `dead_out` are read and written with
// D.dyn (else null), `spd` / `epn` / `ept0` / `ept1` / `epf` read with
// D.het (else null), `cold_out` / `coldq_out` written with D.cold (else
// null).
// `scratch` holds D.B times the scratch words (null when they are 0).
// Returns cudaGetLastError() after the launch, or the error that stopped
// it.
extern "C" int event_step_dyn_launch(
    const double* clk, const int* ctr, const double* t, const int* fnid,
    const double* p, const double* cost, const double* coef, const int* cores,
    const int* nodes, const int* fn_ev, const double* dynp, const int* maxn,
    const int* nreq, const double* spd, const int* epn, const double* ept0,
    const double* ept1, const double* epf, double* start, double* finish,
    double* prio, int* node, int* summ, double* act_out, int* dead_out,
    int* cold_out, int* coldq_out, int* scratch, const int* layout,
    const int* dims, const int* plan, float horizon, void* stream) {
  DLayout L;
  DDims D;
  int P[kDPlan];
  static_assert(sizeof(DLayout) == kDLayout * sizeof(int), "layout size");
  static_assert(sizeof(DDims) == kDDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  std::memcpy(P, plan, sizeof(P));
  if (D.B == 0) return static_cast<int>(cudaSuccess);
  const int pl = P[0];
  const bool staged = P[1] != 0, wide = P[2] != 0;
  const int cell = P[3], words = P[4];
  const int n1 = D.n + 1, NSL = D.n_nodes * D.n_slots;
  const int pln = (D.n_nodes + 31) / 32, plf = (D.n_fns + 31) / 32;
  const bool dyn = D.dyn != 0, het = D.het != 0, cold = D.cold != 0;
  const int nfree = cold ? D.n_nodes * D.n_fns : 0;
  const DArgs a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, fn_ev,
                dynp, maxn, nreq, spd, epn, ept0, ept1, epf, start, finish,
                prio, node, summ, act_out, dead_out, cold_out, coldq_out,
                reinterpret_cast<uint32_t*>(scratch)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (pl < 1 || 32 * pl < NSL || (!wide && (D.n_nodes > 32 ||
                                            D.n_fns > 32)) ||
      words != dyn_scratch_words(wide, pl, pln, plf, n1, D.n_fns, D.window,
                                 dyn, nfree) ||
      (words > 0 && scratch == nullptr) ||
      (dyn && (dynp == nullptr || maxn == nullptr || nreq == nullptr ||
               summ == nullptr || act_out == nullptr ||
               dead_out == nullptr || D.ncoef < 5)) ||
      (het && (spd == nullptr || epn == nullptr || ept0 == nullptr ||
               ept1 == nullptr || epf == nullptr || D.n_ep < 1)) ||
      (cold && (cold_out == nullptr || coldq_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    if (staged || cell != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_dyn_cold<0, false>(cold, a, L, D, 0, horizon, s, pl,
                                     words);
  }
  if (cell != dyn_cell_bytes(staged, n1, D.n_fns, D.window, nfree) ||
      cell % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl) {
    case 1: return launch_dyn_pl<1>(staged, a, L, D, cell, horizon, s, words);
    case 2: return launch_dyn_pl<2>(staged, a, L, D, cell, horizon, s, words);
    case 4: return launch_dyn_pl<4>(staged, a, L, D, cell, horizon, s, words);
    case 8: return launch_dyn_pl<8>(staged, a, L, D, cell, horizon, s, words);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the float64 frozen-priority scan (capacity dynamics with D.dyn,
// node speeds with D.het, cold starts with D.cold; at least one of them)
// of D.B cells on `stream`.  `layout` holds the kF64Layout carry offsets,
// `dims` the kF64Dims launch dimensions and `plan` the kF64Plan entries of
// ops.event_step_plan(..., freeze=True, f64=True) (slots a lane; staged or
// not; wide or not; shared-memory bytes a cell; scratch words a cell), all
// in host memory.  `dynp` / `maxn` / `nreq` and the summary outputs `summ`
// / `act_out` / `dead_out` are read and written with D.dyn (else null),
// `spd` / `epn` / `ept0` / `ept1` / `epf` read with D.het (else null),
// `cold_out` / `coldq_out` written with D.cold (else null).  `scratch`
// holds D.B times the scratch words (null when they are 0).  Returns
// cudaGetLastError() after the launch, or the error that stopped it.
extern "C" int event_step_freeze64_launch(
    const double* clk, const int* ctr, const double* t, const int* fnid,
    const double* p, const double* cost, const double* coef, const int* cores,
    const int* nodes, const double* cnt, const int* home0, const int* route,
    const double* dynp, const int* maxn, const int* nreq, const double* spd,
    const int* epn, const double* ept0, const double* ept1, const double* epf,
    double* start, double* finish, double* prio, int* node, int* summ,
    double* act_out, int* dead_out, int* cold_out, int* coldq_out,
    int* scratch, const int* layout, const int* dims, const int* plan,
    float horizon, void* stream) {
  const F64Args a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, cnt,
                  home0, route, dynp, maxn, nreq, spd, epn, ept0, ept1, epf,
                  start, finish, prio, node, summ, act_out, dead_out,
                  cold_out, coldq_out, reinterpret_cast<uint32_t*>(scratch)};
  const H64Args h{nullptr, nullptr, nullptr, nullptr, nullptr};
  const R64Args r{nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr};
  return f64_launch_checked(a, h, r, layout, dims, plan, horizon, stream,
                            F64Sets::kPlain, launch_f64_set);
}
