// The pull kernels of the cluster event scan for Hopper (sm_90a), shared by
// csrc/event_step.cu (the whole-burst scans) and csrc/event_step_stream.cu
// (the chunked stream replay, STREAM = true): the float32 base-pull kernel
// (event_step_kernel) and the float64 pull kernel (dyn_kernel), with the
// helpers the frozen-priority kernel of csrc/event_step.cu shares.
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
//   per-node queue length qn decides nothing and is kept only under
//   STREAM, below, which writes the carry back.)
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
//
// STREAM (a template parameter of both kernels; csrc/event_step_stream.cu):
// one chunk of the chunked stream replay, the stream branch of
// repro/core/fastpath.py::_scan_cell_kernel (l. 821) that the JAX package
// runs as XLA's lax.scan, on pull cells.  The plain PyTorch version is
// event_step_ref with stream.  What differs:
// - The horizon: the scan stops at the first event at or past the cell's
//   t_stop (a kill, arrival, completion, re-arrival, activation or tick
//   alike), which is the next chunk's.
// - The queues are CSR lists: a function's entry h is fnev[clip(fnst[f] +
//   h, 0, n)], valid while h < qcnt[f], the carry's chunk-rebased count of
//   the calls its window holds (an arrival adds one; narr stays
//   cumulative, for RECT's first arrival).
// - The FC window needs nothing new: the arrivals of the previous chunks
//   still inside it are rows before the first fresh one (history rows,
//   which no queue lists), so the running count from t and fnid counts
//   them.
// - At the end every carry entry goes back out, at the offsets it was read
//   from (clk_out / ctr_out, copies of the planes the wrapper makes): the
//   slots (completion time and row: each slot keeps its row under STREAM),
//   the nodes (busy, channel clock, queue length qn: kept under STREAM) and
//   functions (head, arrivals, qcnt, the estimator and its ring, last and
//   previous arrival), the arrival cursor; with dynamics the activation
//   and kill times, dead and pending flags, the per-row re-arrival, last
//   pull and enqueue times and re-queued flags, the next tick, nodes
//   provisioned, calls lost and done; with COLD the free containers, the
//   counts and each row's flag.  Without STREAM the kernels are as they
//   were: no qcnt, no horizon, no write-back.

#pragma once

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "event_step_common.cuh"

namespace {

constexpr unsigned NO_KEY = 0xffffffffu;   // above every non-NaN key
constexpr int kLayout = 15;   // carry entries, see struct Layout
constexpr int kDims = 13;     // integer launch dimensions, see struct Dims
constexpr int kPlan = 4;      // per_lane, staged, cell_bytes, scratch_words
// lane-owned arrays of the wide path: 5 a slot, 2 a node, 13 a function;
// STREAM adds 3: each slot's row, each node's queue length, each
// function's qcnt
constexpr int kWideArrays = 20;
constexpr int kStreamWideArrays = 3;

template <bool STREAM>
__host__ __device__ constexpr int wide_arrays() {
  return kWideArrays + (STREAM ? kStreamWideArrays : 0);
}

// Offsets of the carry entries: the first six in the clk plane, the rest
// in the ctr plane (the order of EVENT_STEP_LAYOUT in ops.py); qcnt is 0
// outside a stream bucket.
struct Layout {
  int chan, fin_s, last_t, prev_t, ring, rsum;
  int ai, busy, head, idx_s, narr, qn, rlen, rpos, qcnt;
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
  const int* fn_ev;     // dense queue sequences (not STREAM)
  const int* fnev;      // STREAM: CSR queue entries (B, n + 1) ...
  const int* fnst;      // ... each function's first entry (B, F)
  const float* t_stop;  // STREAM: each cell's horizon
  float* start;
  float* finish;
  float* prio;
  int* node;
  float* clk_out;       // STREAM: the final carry planes
  int* ctr_out;
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
__host__ __device__ constexpr int scratch_words(int pl, int F, int W,
                                                bool stream) {
  return (kWideArrays + (stream ? kStreamWideArrays : 0)) * 32 * pl + F * W;
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

template <int PL, bool STAGED, bool STREAM>
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
    ring = reinterpret_cast<float*>(cw + wide_arrays<STREAM>() * 32 * pl);
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
  // STREAM: each slot's row, each node's queue length, each function's
  // chunk-rebased count of queued calls
  Own<int, PL> s_row(lw, 20, pl);
  Own<int, PL> n_qn(lw, 21, pl);
  Own<int, PL> f_qc(lw, 22, pl);
  // function e's queue sequence (device memory): entry h of the dense
  // fn_ev, or of the CSR lists under STREAM (clipped onto the sentinel)
  const int* const fn_ev =
      STREAM ? nullptr : a.fn_ev + static_cast<size_t>(b) * F * kq;
  const int* const fnev = STREAM ? a.fnev + row : nullptr;
  const int* const fnst = STREAM ? a.fnst + static_cast<size_t>(b) * F
                                 : nullptr;
  auto entry = [&](int e, int h) -> int {
    if constexpr (STREAM)
      return __ldg(fnev + min(max(__ldg(fnst + e) + h, 0), n));
    else
      return __ldg(fn_ev + e * kq + min(h, kq - 1));
  };
  const float t_stop = STREAM ? __ldg(a.t_stop + b) : inf;
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
    if constexpr (STREAM) {
      s_row[q] = e < NSL ? __ldg(ctr + L.idx_s + e) : 0;
      n_qn[q] = e < NN ? __ldg(ctr + L.qn + e) : 0;
      f_qc[q] = e < F ? __ldg(ctr + L.qcnt + e) : 0;
    }
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
    f_idx[q] = fe ? entry(e, f_head[q]) : n;
    f_nidx[q] = fe ? entry(e, f_head[q] + 1) : n;
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
    const int lim0 = STREAM ? f_qc[0] : f_narr[0];
    counted = __all_sync(FULL, ok && f_head[0] <= lim0) &&
              nodes >= 1 && cores <= NS && (occ & ~usable) == 0;
  }
  // the calls queued (a count kept when the carry is counted); a
  // function's window holds its arrivals, under STREAM its qcnt
  int queued = 0;
#pragma unroll
  for (int q = 0; q < pl; ++q)
    queued += max((STREAM ? f_qc[q] : f_narr[q]) - f_head[q], 0);
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
    if constexpr (STREAM) {
      if (now >= t_stop) break;   // the next chunk's event
    }

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
          if constexpr (STREAM) f_qc[q] += 1;
        }
      }
      if constexpr (STREAM) {
        if (lane == 0) n_qn[0] += 1;   // every arrival joins node 0's qn
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
      for (int q = 0; q < pl; ++q)
        q_any |= f_head[q] < (STREAM ? f_qc[q] : f_narr[q]);
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
        const int lim = STREAM ? f_qc[q] : f_narr[q];
        const unsigned k = f_head[q] < lim ? order_key(pr) : NO_KEY;
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
          if (e == se) {
            s_fin[q] = fin_j; s_fn[q] = f_j; s_p[q] = p_j;
            if constexpr (STREAM) s_row[q] = j;
          }
          if (e == k_d) {
            n_chan[q] = exec_start; n_busy[q] += 1;
            if constexpr (STREAM) n_qn[q] -= 1;
          }
          if (e == f_j) {
            // the next head, loaded one dispatch ahead, and the one after it
            f_head[q] += 1;
            f_idx[q] = f_nidx[q];
            f_th[q] = R.t(f_idx[q]);
            f_nidx[q] = entry(e, f_head[q] + 1);
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

  if constexpr (STREAM) {
    // -- the final carry, every entry at the offset it was read from
    float* const co = a.clk_out + static_cast<size_t>(b) * D.f_len;
    int* const io = a.ctr_out + static_cast<size_t>(b) * D.i_len;
    if (lane == 0) io[L.ai] = ai;
#pragma unroll
    for (int q = 0; q < pl; ++q) {
      const int e = lane * pl + q;
      if (e < NSL) {
        co[L.fin_s + e] = s_fin[q];
        io[L.idx_s + e] = s_row[q];
      }
      if (e < NN) {
        io[L.busy + e] = n_busy[q];
        co[L.chan + e] = n_chan[q];
        io[L.qn + e] = n_qn[q];
      }
      if (e < F) {
        io[L.head + e] = f_head[q];
        io[L.narr + e] = f_narr[q];
        io[L.qcnt + e] = f_qc[q];
        io[L.rlen + e] = f_rlen[q];
        io[L.rpos + e] = f_rpos[q];
        co[L.rsum + e] = f_rsum[q];
        co[L.last_t + e] = f_last[q];
        co[L.prev_t + e] = f_prev[q];
      }
    }
    __syncwarp();
    for (int i = lane; i < F * W; i += 32) co[L.ring + i] = ring[i];
  }
}

template <int PL, bool STAGED, bool STREAM>
int launch(const Args& a, const Layout& L, const Dims& D, int cell,
           float horizon, cudaStream_t stream, int pl_wide = 0,
           int wide_words = 0) {
  auto kernel = event_step_kernel<PL, STAGED, STREAM>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, L, D, cpb, cell, horizon, pl_wide, wide_words);
  return static_cast<int>(cudaGetLastError());
}

template <int PL, bool STREAM>
int launch_pl(bool staged, const Args& a, const Layout& L, const Dims& D,
              int cell, float horizon, cudaStream_t stream) {
  return staged ? launch<PL, true, STREAM>(a, L, D, cell, horizon, stream)
                : launch<PL, false, STREAM>(a, L, D, cell, horizon, stream);
}

// The checked launch of the pull kernel on D.B cells: `P` holds the kPlan
// entries of ops.event_step_plan (entries per lane; rows staged or not;
// shared-memory bytes a cell; scratch words a cell, 0 unless the cell takes
// the wide path).  Returns cudaGetLastError() after the launch, or the
// error that stopped it.
template <bool STREAM>
int pull_launch(const Args& a, const Layout& L, const Dims& D, const int* P,
                float horizon, cudaStream_t s) {
  if (D.B == 0) return static_cast<int>(cudaSuccess);
  const int pl = P[0];
  const bool staged = P[1] != 0;
  const int cell = P[2];
  const int wide_words = P[3];
  if (STREAM && (a.fnev == nullptr || a.fnst == nullptr ||
                 a.t_stop == nullptr || a.clk_out == nullptr ||
                 a.ctr_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide_words > 0) {
    const int widest = std::max({D.n_nodes * D.n_slots, D.n_nodes, D.n_fns});
    if (staged || a.scratch == nullptr || pl < 1 || 32 * pl < widest ||
        wide_words < scratch_words(pl, D.n_fns, D.window, STREAM))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<0, false, STREAM>(a, L, D, 0, horizon, s, pl, wide_words);
  }
  if (cell < cell_bytes(staged, D.n + 1, D.n_fns, D.window) ||
      cell % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl) {
    case 1: return launch_pl<1, STREAM>(staged, a, L, D, cell, horizon, s);
    case 2: return launch_pl<2, STREAM>(staged, a, L, D, cell, horizon, s);
    case 4: return launch_pl<4, STREAM>(staged, a, L, D, cell, horizon, s);
    case 8: return launch_pl<8, STREAM>(staged, a, L, D, cell, horizon, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// dependent loads and float64 warp reductions.  On the wide path a step's
// work is O(1) warp operations and a scan of the group summaries in
// shared memory (plf / 32 a lane), not O(F) loads from device memory.
// - One warp a cell, several a block; rows t / p / cost (float64) and fnid
//   (8 bits) staged in shared memory when they fit (n_b up to ~9,000),
//   read in place past that (ops.event_step_plan(..., f64=True)).  The
//   runtime ring is in shared memory.
// - Lane-owned state: lane l owns slots l*PL .. l*PL+PL-1 (PL up to 8) and
//   node l and function l, in registers.  A cell of more than 256 slots or
//   32 nodes or functions takes the wide path (PL = 0): the same arrays in
//   a device-memory scratch (entry q of a lane at [q][lane]), ring
//   included.
// - The wide path's dispatch reads group summaries, not every function.
//   Function f lives at lane f / plf, entry f % plf, and its owner updates
//   it in place.  Group g is entry g of every lane (one coalesced row of
//   the scratch, 32 functions); its summary, in shared memory, holds the
//   least (base, head row) of its queued functions, base = c0 t_head + c1
//   prev + (c2 + c3 cnt) est, and the least head row of any of them.  An
//   event changes the inputs of one function (an arrival, a completion's
//   estimate, a dispatch's head, a row leaving or re-entering the FC
//   window), and its group is summarized again: one load a lane of each
//   array and one warp reduction.  A dispatch takes the least of the
//   summaries' priorities (base + c4 now with the enqueue clock), then the
//   least head row among those equal.  Adding c4 now and rounding keeps
//   the order but can merge two bases: a group at that priority holding a
//   head row below the winner's is then scanned in full, entry by entry,
//   which gives the oracle's first-index tie-break (FIFO's equal bases
//   need no scan: each group's least row is its summary's).  The
//   functions' pull-time bases for the re-queued calls are kept current
//   at each update.  The register paths (PL > 0) scan their 32 functions,
//   one a lane, at each dispatch.
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

constexpr int kDLayout = 31;  // carry entries, see struct DLayout
constexpr int kDDims = 16;    // integer launch dimensions, see struct DDims
constexpr int kDPlan = 5;     // per_lane, staged, wide, cell_bytes, words
// Offsets of the carry entries: the first twelve in the clk plane, the rest
// in the ctr plane (EVENT_STEP_DYN_LAYOUT in ops.py); the entries of a
// segment the bucket lacks (dyn, cold, stream) are 0.
struct DLayout {
  int chan, fin_s, last_t, prev_t, ring, rsum, act_t, killq, rearr,
      next_tick, rq_rt, enq_t;
  int ai, busy, head, idx_s, narr, qn, rlen, rpos, dead, act_pend, prov,
      nfail, ndone, xq, freec, ncold, nevt, coldq, qcnt;
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
  const int* fn_ev;      // dense queue sequences (not STREAM)
  const int* fnev;       // STREAM: CSR queue entries (B, n + 1) ...
  const int* fnst;       // ... each function's first entry (B, F)
  const double* t_stop;  // STREAM: each cell's horizon
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
  double* clk_out;   // STREAM: the final carry planes
  int* ctr_out;
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

// shared memory one block may take on sm_90 (227 KB opted in;
// ops.SMEM_BLOCK_BYTES)
constexpr int kSmemBlockBytes = 232448;

// Bytes of the wide path's group summaries (below) of `plf` groups: a
// base (8 bytes), its head row and the least queued head row (4 each) a
// group.  They take the cell's shared memory when they fit, else the
// scratch.  ops.event_step_plan computes the same.
__host__ __device__ constexpr int dyn_group_bytes(int plf) {
  return 16 * plf;
}
__host__ __device__ constexpr bool dyn_groups_shared(int plf) {
  return dyn_group_bytes(plf) <= kSmemBlockBytes;
}

// Scratch words of one cell: on the wide path the ring, the lane-owned
// arrays (3 words a slot, 11 a node, 16 a function; under STREAM one more a
// node, its queue length, and a function, its qcnt) and the `nfree`
// free-container counts, then with dynamics the per-row arrays
// (re-arrival time, last pull clock, enqueue time: two words each;
// re-queued flag: one) and each function's pull-time base, then (wide)
// the group summaries when shared memory cannot hold them.
// ops.event_step_plan computes the same.
__host__ __device__ constexpr long dyn_scratch_words(bool wide, int pls,
                                                     int pln, int plf,
                                                     int n1, int F, int W,
                                                     bool dyn, int nfree,
                                                     bool stream) {
  const int sw = stream ? 1 : 0;
  return (wide ? 2L * round_up(F * W, 2) +
                     32L * (3 * pls + (11 + sw) * pln + (16 + sw) * plf) +
                     round_up(nfree, 2) +
                     (dyn_groups_shared(plf) ? 0L
                                             : dyn_group_bytes(plf) / 4L)
               : 0L) +
         (dyn ? 7L * round_up(n1, 2) + 2L * F : 0L);
}

template <int PL, bool STAGED, bool COLD, bool STREAM>
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
  // STREAM: each node's queue length, each function's chunk-rebased count
  // of queued calls
  Lane<int, NQ> n_qn(STREAM ? i32(pln) : nullptr);
  Lane<int, NQ> f_qc(STREAM ? i32(plf) : nullptr);
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
    if constexpr (STREAM) n_qn[q] = ne ? __ldg(ctr + L.qn + e) : 0;
    n_act[q] = ne && DYN ? __ldg(clk + L.act_t + e) : 0.0;
    n_kill[q] = ne && DYN ? __ldg(clk + L.killq + e) : inf;
    n_dead[q] = ne && DYN ? __ldg(ctr + L.dead + e) : 0;
    n_pend[q] = ne && DYN ? __ldg(ctr + L.act_pend + e) : 0;
    n_spd[q] = ne && HET ? __ldg(a.spd + static_cast<size_t>(b) * NN + e)
                         : 1.0;
  }
  qsum = __reduce_add_sync(FULL, qsum);
  // function e's entry h of its queue sequence: the dense fn_ev, or the
  // CSR lists under STREAM (clipped onto the sentinel)
  const int* const fn_ev =
      STREAM ? nullptr : a.fn_ev + static_cast<size_t>(b) * F * kq;
  const int* const fnev = STREAM ? a.fnev + row : nullptr;
  const int* const fnst = STREAM ? a.fnst + static_cast<size_t>(b) * F
                                 : nullptr;
  auto entry = [&](int e, int h) -> int {
    if constexpr (STREAM)
      return __ldg(fnev + min(max(__ldg(fnst + e) + h, 0), n));
    else
      return __ldg(fn_ev + e * kq + min(h, kq - 1));
  };
  const double t_stop = STREAM ? __ldg(a.t_stop + b) : inf;
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
    if constexpr (STREAM) f_qc[q] = fe ? __ldg(ctr + L.qcnt + e) : 0;
    f_idx[q] = fe ? entry(e, f_head[q]) : n;
    f_th[q] = R.t(f_idx[q]);
    f_cnt[q] = 0;
  }
  int ai = __ldg(ctr + L.ai);
  // FC counts of the arrivals the carry has already taken
  if constexpr (PL == 0) {
    // a row a lane, each count at its function's entry
    int* const cnt0 = &f_cnt[0] - lane;
    __syncwarp();
    for (int i = lane; i < ai && i < n; i += 32) {
      const int f = R.fn(i);
      if (R.t(i) != inf) atomicAdd(cnt0 + (f % plf) * 32 + f / plf, 1);
    }
    __syncwarp();
  } else {
    for (int i = 0; i < ai && i < n; ++i) {
      const int f = R.fn(i);
      if (R.t(i) != inf)
        for (int q = 0; q < plf; ++q)
          if (lane * plf + q == f) f_cnt[q] += 1;
    }
  }
  // -- (wide) the group summaries: group g is entry g of every lane; its
  // summary is kept by lane g % 32, which alone reads and writes it
  double* g_base = nullptr;   // the least (base, head row)'s base, ...
  int* g_row = nullptr;       // ... its head row (INT_MAX: none queued)
  int* g_rmin = nullptr;      // the least head row queued
  int nq_f = 0;               // functions with a queued head
  // function entry q's queue holds a call; its pull-time base
  auto queued = [&](int q) {
    return f_head[q] < (STREAM ? f_qc[q] : f_narr[q]);
  };
  auto fn_base = [&](int q) {
    double w = c2;
    if (D.use_fc)
      w = __dadd_rn(c2, __dmul_rn(c3, static_cast<double>(f_cnt[q])));
    return __dadd_rn(__dmul_rn(c1, f_prev[q]), __dmul_rn(w, f_est[q]));
  };
  // summarize group g again, and keep its functions' bases current
  auto regroup = [&](int g) {
    const int e = lane * plf + g;
    unsigned long long k = NO_KEY64;
    int r = INT_MAX;
    double sb = 0.0;
    if (e < F) {
      const double bs = fn_base(g);
      if (DYN) f_base[e] = bs;
      sb = __dadd_rn(__dmul_rn(c0, f_th[g]), bs);
      if (queued(g)) k = order_key64(sb);
      if (k != NO_KEY64) r = f_idx[g];
    }
    int at;
    const unsigned long long m = warp_argmin64(k, r, &at);
    const int rmin = __reduce_min_sync(FULL, r);
    const unsigned win = __ballot_sync(FULL, k == m && r == at);
    const double bw = __shfl_sync(FULL, sb, __ffs(win) - 1);
    if (lane == (g & 31)) {
      g_base[g] = bw;
      g_row[g] = at;
      g_rmin[g] = rmin;
    }
  };
  if constexpr (PL == 0) {
    unsigned char* gs =
        bytes_per_cell > 0
            ? smem + static_cast<size_t>(warp) * bytes_per_cell
            : reinterpret_cast<unsigned char*>(
                  fcnt + round_up(COLD ? NN * F : 0, 2));
    g_base = reinterpret_cast<double*>(gs);
    g_row = reinterpret_cast<int*>(g_base + plf);
    g_rmin = g_row + plf;
    int nq = 0;
    for (int g = 0; g < plf; ++g) {
      regroup(g);
      nq += lane * plf + g < F && queued(g);
    }
    nq_f = __reduce_add_sync(FULL, nq);
  }
  // (wide) the least queued head at `now` -- its row into *j (n if none)
  // and its priority into *prio -- from the group summaries: the least
  // priority M of a summary (its base + c4 now), then the least head row
  // among the summaries at M.  With c4 now != 0 the rounding can merge a
  // larger base into M; a group at M holding a head row below the winner's
  // is then scanned in full.
  auto pick_head = [&](double now_, int* j, double* prio) {
    const double c4n = DYN ? __dmul_rn(c4, now_) : 0.0;
    const bool merge = DYN && c4n != 0.0;
    auto summary_key = [&](int g, double* pr) {
      *pr = DYN ? __dadd_rn(g_base[g], c4n) : g_base[g];
      return order_key64(*pr);
    };
    unsigned long long lk = NO_KEY64;
    int lr = INT_MAX, lm = INT_MAX;
    double lv = 0.0;
    for (int g = lane; g < plf; g += 32) {
      const int r = g_row[g];
      if (r == INT_MAX) continue;
      double pr;
      const unsigned long long k = summary_key(g, &pr);
      const int rm = g_rmin[g];
      if (k < lk) {
        lk = k; lr = r; lv = pr; lm = rm;
      } else if (k == lk) {
        if (r < lr) { lr = r; lv = pr; }
        lm = min(lm, rm);
      }
    }
    int jw;
    const unsigned long long m = warp_argmin64(lk, lr, &jw);
    if (m == NO_KEY64) return;
    double pw = __shfl_sync(
        FULL, lv, __ffs(__ballot_sync(FULL, lk == m && lr == jw)) - 1);
    if (merge && __reduce_min_sync(FULL, lk == m ? lm : INT_MAX) < jw) {
      // the groups at M with a head row below the winner's, in order
      for (int gc = -1;;) {
        int gn = INT_MAX;
        for (int g = lane; g < plf; g += 32) {
          double pr;
          if (g > gc && g_row[g] != INT_MAX && g_rmin[g] < jw &&
              summary_key(g, &pr) == m) {
            gn = g;
            break;
          }
        }
        gn = __reduce_min_sync(FULL, gn);
        if (gn == INT_MAX) break;
        unsigned long long k = NO_KEY64;
        int r = INT_MAX;
        double pr = 0.0;
        if (lane * plf + gn < F && queued(gn)) {
          pr = __dadd_rn(__dadd_rn(__dmul_rn(c0, f_th[gn]), fn_base(gn)),
                         c4n);
          k = order_key64(pr);
          r = f_idx[gn];
        }
        const int rr = __reduce_min_sync(FULL, k == m ? r : INT_MAX);
        if (rr < jw) {
          jw = rr;
          pw = __shfl_sync(
              FULL, pr, __ffs(__ballot_sync(FULL, k == m && r == rr)) - 1);
        }
        gc = gn;
      }
    }
    *j = jw;
    *prio = pw;
  };
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
    if constexpr (STREAM) {
      if (now >= t_stop) break;   // the next chunk's event
    }

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
      // the owner of f_done's entries observes v (wide: addressed directly)
      const int q_lo = PL == 0 ? f_done % plf : 0;
      const int q_hi = PL == 0 ? q_lo + 1 : plf;
      for (int q = q_lo; q < q_hi; ++q) {
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
      if constexpr (PL == 0) regroup(q_lo);
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
      if constexpr (STREAM) {
        if (lane == 0) n_qn[0] += 1;   // node 0's qn counts it
      }
      if (n_re > 0) find_rearr(); else re_min = inf;
    } else if (ev == 1) {
      // -- arrival: enqueue, observe on the controller estimator
      const int q_lo = PL == 0 ? f_a % plf : 0;
      const int q_hi = PL == 0 ? q_lo + 1 : plf;
      int was = 0, is = 0;    // (wide) f_a's head queued before and after
      for (int q = q_lo; q < q_hi; ++q) {
        if (lane * plf + q == f_a) {
          if constexpr (PL == 0) was = queued(q);
          f_prev[q] = f_narr[q] == 0 ? now : f_last[q];
          f_last[q] = now;
          f_narr[q] += 1;
          f_cnt[q] += 1;
          if constexpr (STREAM) f_qc[q] += 1;
          if constexpr (PL == 0) is = queued(q);
        }
      }
      if constexpr (PL == 0) {
        nq_f += __shfl_sync(FULL, is - was, f_a / plf);
        regroup(q_lo);
      }
      if constexpr (STREAM) {
        if (lane == 0) n_qn[0] += 1;   // every arrival joins node 0's qn
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
      if constexpr (PL == 0) {
        q_any = q_any || nq_f > 0;
      } else {
        for (int q = 0; q < plf; ++q)
          q_any |= f_head[q] < (STREAM ? f_qc[q] : f_narr[q]);
        q_any = __any_sync(FULL, q_any);
      }
      if (q_any) {
        if (D.use_fc) {
          // -- FC window: k0 passes the rows at or before now - horizon
          const double lim = __dsub_rn(now, horizon);
          while (k0 < n && t_k0 <= lim) {
            const int f = R.fn(k0);
            if (t_k0 != inf) {
              const int q_lo = PL == 0 ? f % plf : 0;
              const int q_hi = PL == 0 ? q_lo + 1 : plf;
              for (int q = q_lo; q < q_hi; ++q)
                if (lane * plf + q == f) f_cnt[q] -= 1;
              if constexpr (PL == 0) regroup(q_lo);
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
              const int q_lo = PL == 0 ? f % plf : 0;
              const int q_hi = PL == 0 ? q_lo + 1 : plf;
              for (int q = q_lo; q < q_hi; ++q)
                if (lane * plf + q == f) f_cnt[q] += 1;
              if constexpr (PL == 0) regroup(q_lo);
            }
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
        int j = n;
        double prio_j = inf;
        if constexpr (PL == 0) {
          // (wide) from the group summaries; nothing to pick for a node
          // that cannot take a call
          if (ok) pick_head(now, &j, &prio_j);
        } else {
          unsigned long long pk = NO_KEY64;
          int pj = INT_MAX;
          double pv = 0.0;
          for (int q = 0; q < plf; ++q) {
            double w = c2;
            if (D.use_fc)
              w = __dadd_rn(c2,
                            __dmul_rn(c3, static_cast<double>(f_cnt[q])));
            const double base = __dadd_rn(__dmul_rn(c1, f_prev[q]),
                                          __dmul_rn(w, f_est[q]));
            double pr = __dadd_rn(__dmul_rn(c0, f_th[q]), base);
            if (DYN) pr = __dadd_rn(pr, __dmul_rn(c4, now));
            const unsigned long long k =
                f_head[q] < (STREAM ? f_qc[q] : f_narr[q]) ? order_key64(pr)
                                                           : NO_KEY64;
            if (k < pk || (k == pk && f_idx[q] < pj)) {
              pk = k; pj = f_idx[q]; pv = pr;
            }
            if (DYN && n_xq > 0 && lane * plf + q < F)
              f_base[lane * plf + q] = base;
          }
          const unsigned long long pmin = warp_argmin64(pk, pj, &j);
          if (pmin == NO_KEY64) {
            j = n;
          } else {
            const unsigned win = __ballot_sync(FULL, pk == pmin && pj == j);
            prio_j = __shfl_sync(FULL, pv, __ffs(win) - 1);
          }
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
              if constexpr (STREAM) n_qn[q] -= 1;
            }
          }
          --qsum;
          if (pick_x) {
            if (lane == 0) r_xq[j] = 0;
            n_xq -= 1;
          } else {
            const int f_j = R.fn(j);
            const int q_lo = PL == 0 ? f_j % plf : 0;
            const int q_hi = PL == 0 ? q_lo + 1 : plf;
            int is = 1;     // (wide) f_j's head still queued
            for (int q = q_lo; q < q_hi; ++q) {
              if (lane * plf + q == f_j) {
                f_head[q] += 1;
                f_idx[q] = entry(f_j, f_head[q]);
                f_th[q] = R.t(f_idx[q]);
                if constexpr (PL == 0) is = queued(q);
              }
            }
            if constexpr (PL == 0) {
              nq_f -= 1 - __shfl_sync(FULL, is, f_j / plf);
              regroup(q_lo);
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

  if constexpr (STREAM) {
    // -- the final carry, every entry at the offset it was read from
    double* const co = a.clk_out + static_cast<size_t>(b) * D.f_len;
    int* const io = a.ctr_out + static_cast<size_t>(b) * D.i_len;
    if (lane == 0) {
      io[L.ai] = ai;
      if (DYN) {
        co[L.next_tick] = next_tick;
        io[L.prov] = prov;
        io[L.nfail] = nfail;
        io[L.ndone] = ndone;
      }
      if constexpr (COLD) {
        io[L.ncold] = ncold;
        io[L.nevt] = nevt;
      }
    }
#pragma unroll
    for (int q = 0; q < pls; ++q) {
      const int e = lane * pls + q;
      if (e < NSL) {
        co[L.fin_s + e] = s_fin[q];
        io[L.idx_s + e] = s_row[q];
      }
    }
    for (int q = 0; q < pln; ++q) {
      const int e = lane * pln + q;
      if (e < NN) {
        io[L.busy + e] = n_busy[q];
        co[L.chan + e] = n_chan[q];
        io[L.qn + e] = n_qn[q];
        if (DYN) {
          co[L.act_t + e] = n_act[q];
          co[L.killq + e] = n_kill[q];
          io[L.dead + e] = n_dead[q];
          io[L.act_pend + e] = n_pend[q];
        }
      }
    }
    for (int q = 0; q < plf; ++q) {
      const int e = lane * plf + q;
      if (e < F) {
        io[L.head + e] = f_head[q];
        io[L.narr + e] = f_narr[q];
        io[L.qcnt + e] = f_qc[q];
        io[L.rlen + e] = f_rlen[q];
        io[L.rpos + e] = f_rpos[q];
        co[L.rsum + e] = f_rsum[q];
        co[L.last_t + e] = f_last[q];
        co[L.prev_t + e] = f_prev[q];
      }
    }
    __syncwarp();
    for (int i = lane; i < F * W; i += 32) co[L.ring + i] = ring[i];
    if (DYN) {
      for (int i = lane; i < n1; i += 32) {
        co[L.rearr + i] = r_rearr[i];
        co[L.rq_rt + i] = r_rqrt[i];
        co[L.enq_t + i] = r_enq[i];
        io[L.xq + i] = r_xq[i];
      }
    }
    if constexpr (COLD) {
      for (int i = lane; i < NN * F; i += 32) io[L.freec + i] = fcnt[i];
      for (int i = lane; i < n1; i += 32) io[L.coldq + i] = o_coldq[i];
    }
  }
}

template <int PL, bool STAGED, bool COLD, bool STREAM>
int launch_dyn(const DArgs& a, const DLayout& L, const DDims& D, int cell,
               float horizon, cudaStream_t stream, int pl, int words) {
  auto kernel = dyn_kernel<PL, STAGED, COLD, STREAM>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, L, D, cpb, cell, horizon, pl, words);
  return static_cast<int>(cudaGetLastError());
}

template <int PL, bool STAGED, bool STREAM>
int launch_dyn_cold(bool cold, const DArgs& a, const DLayout& L,
                    const DDims& D, int cell, float horizon,
                    cudaStream_t stream, int pl, int words) {
  return cold ? launch_dyn<PL, STAGED, true, STREAM>(a, L, D, cell, horizon,
                                                     stream, pl, words)
              : launch_dyn<PL, STAGED, false, STREAM>(a, L, D, cell, horizon,
                                                      stream, pl, words);
}

template <int PL, bool STREAM>
int launch_dyn_pl(bool staged, const DArgs& a, const DLayout& L,
                  const DDims& D, int cell, float horizon,
                  cudaStream_t stream, int words) {
  const bool cold = D.cold != 0;
  return staged ? launch_dyn_cold<PL, true, STREAM>(cold, a, L, D, cell,
                                                    horizon, stream, PL,
                                                    words)
                : launch_dyn_cold<PL, false, STREAM>(cold, a, L, D, cell,
                                                     horizon, stream, PL,
                                                     words);
}

// The checked launch of the float64 pull kernel on D.B cells: `P` holds
// the kDPlan entries of ops.event_step_plan(..., f64=True) (slots a lane;
// staged or not; wide or not; shared-memory bytes a cell, on the wide path
// its group summaries' or 0 where they are in the scratch; scratch words a
// cell).  The dyn inputs and summary outputs must be there with D.dyn,
// the het inputs with D.het, the cold outputs with D.cold, the CSR lists,
// horizons and final planes with STREAM.  Returns cudaGetLastError() after
// the launch, or the error that stopped it.
template <bool STREAM>
int dyn_launch(const DArgs& a, const DLayout& L, const DDims& D,
               const int* P, float horizon, cudaStream_t s) {
  if (D.B == 0) return static_cast<int>(cudaSuccess);
  const int pl = P[0];
  const bool staged = P[1] != 0, wide = P[2] != 0;
  const int cell = P[3], words = P[4];
  const int n1 = D.n + 1, NSL = D.n_nodes * D.n_slots;
  const int pln = (D.n_nodes + 31) / 32, plf = (D.n_fns + 31) / 32;
  const bool dyn = D.dyn != 0, het = D.het != 0, cold = D.cold != 0;
  const int nfree = cold ? D.n_nodes * D.n_fns : 0;
  if (pl < 1 || 32 * pl < NSL || (!wide && (D.n_nodes > 32 ||
                                            D.n_fns > 32)) ||
      words != dyn_scratch_words(wide, pl, pln, plf, n1, D.n_fns, D.window,
                                 dyn, nfree, STREAM) ||
      (words > 0 && a.scratch == nullptr) ||
      (dyn && (a.dynp == nullptr || a.maxn == nullptr || a.nreq == nullptr ||
               a.summ == nullptr || a.act_out == nullptr ||
               a.dead_out == nullptr || D.ncoef < 5)) ||
      (het && (a.spd == nullptr || a.epn == nullptr || a.ept0 == nullptr ||
               a.ept1 == nullptr || a.epf == nullptr || D.n_ep < 1)) ||
      (cold && (a.cold_out == nullptr || a.coldq_out == nullptr)) ||
      (STREAM && (a.fnev == nullptr || a.fnst == nullptr ||
                  a.t_stop == nullptr || a.clk_out == nullptr ||
                  a.ctr_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    if (staged || cell != (dyn_groups_shared(plf) ? dyn_group_bytes(plf) : 0))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_dyn_cold<0, false, STREAM>(cold, a, L, D, cell, horizon, s,
                                             pl, words);
  }
  if (cell != dyn_cell_bytes(staged, n1, D.n_fns, D.window, nfree) ||
      cell % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl) {
    case 1:
      return launch_dyn_pl<1, STREAM>(staged, a, L, D, cell, horizon, s,
                                      words);
    case 2:
      return launch_dyn_pl<2, STREAM>(staged, a, L, D, cell, horizon, s,
                                      words);
    case 4:
      return launch_dyn_pl<4, STREAM>(staged, a, L, D, cell, horizon, s,
                                      words);
    case 8:
      return launch_dyn_pl<8, STREAM>(staged, a, L, D, cell, horizon, s,
                                      words);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
