// Batched base-pull cluster event scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/event_step.py::_event_kernel
// (launched by event_step_pallas).  It computes what that kernel and its
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

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0xffffffffu;   // above every non-NaN key
constexpr int kLayout = 14;   // carry entries, see struct Layout
constexpr int kDims = 13;     // integer launch dimensions, see struct Dims
constexpr int kPlan = 4;      // per_lane, staged, cell_bytes, scratch_words
constexpr int kMaxCellsPerBlock = 16;
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

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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
  int dev = 0, n_sm = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cell > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  // cells a block: as many as fit (at most kMaxCellsPerBlock), then as few
  // as keep the same number of waves, so that every SM gets cells
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
  const long waves = (D.B + per_wave - 1) / per_wave;
  const long spread = static_cast<long>(n_sm) * waves;
  const int cpb = static_cast<int>(
      std::min<long>(cap, (D.B + spread - 1) / spread));
  const int blocks = (D.B + cpb - 1) / cpb;
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
