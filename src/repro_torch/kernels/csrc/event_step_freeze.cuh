// The float32 frozen-priority kernel (freeze_kernel) and its checked
// launch, shared by csrc/event_step.cu (the whole-burst scans) and
// csrc/event_step_freeze_stream.cu (the chunked stream replay, STREAM =
// true), so that each translation unit compiles only its own
// instantiations.

#pragma once

#include "event_step_common.cuh"
#include "event_step_pull.cuh"

namespace {

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
// One warp a cell, as in the pull kernel (csrc/event_step_pull.cuh), and
// the same rules of exactness (--fmad=false, _rn arithmetic in the
// oracle's order, order-preserving keys, first-index ties).  What differs:
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
// - Slots and nodes (busy, queued, channel clock) are lane-owned as in the
//   pull kernel (Own<T, PL>); a cell of more than 256 slots or nodes keeps them in a
//   device-memory scratch (PL = 0), so no width is refused.
// - Push FC: each arrival is logged in its node's ring of fc_ring times for
//   its function, in device memory (up to 64 KB a cell at Fig 6's width);
//   the window count is the ring's entries above now - horizon, counted
//   across the warp with the new time in place (entry r read and written by
//   lane r % 32 only).  Single-node FC reads the static count cnt.
// - Staged (ops.event_step_plan(..., freeze=True)): estimators, queue and rows in
//   shared memory; otherwise estimators and queue in the scratch and rows
//   read in place.  Outputs: prio and node are each row's frozen values
//   (the carry's at the start, overwritten at arrival); start and finish
//   are written at dispatch and stay 0 otherwise.
// - STREAM (a template parameter; its instantiations are built from
//   csrc/event_step_freeze_stream.cu): one chunk of the chunked stream
//   replay, the stream branch of _scan_cell_kernel on this regime
//   (freeze_scan_ref with stream).  The scan stops at the first event at
//   or past the cell's t_stop; each slot keeps its row (one more lane array
//   on the wide path); at the end every carry entry goes back out to
//   clk_out / ctr_out (copies of the planes the wrapper makes): the slots,
//   the nodes, the estimators and their rings, the FC rings, the queue
//   (pending flag, frozen priority, node) and the arrival cursor.  Not
//   staged, the estimators, their rings and the FC rings are read and
//   written in place in clk_out / ctr_out instead of the scratch.  Without
//   STREAM the kernel is as it was.
// ---------------------------------------------------------------------------

constexpr int kFLayout = 18;  // carry entries, see struct FLayout
constexpr int kFDims = 12;    // integer launch dimensions, see struct FDims
constexpr int kFPlan = 5;     // per_lane, staged, wide, cell_bytes, words
// lane-owned arrays of the wide path: 5 a slot, 3 a node; STREAM keeps each
// slot's row too
constexpr int kFreezeWideArrays = 8;
constexpr int kFreezeStreamWideArrays = 1;
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

// STREAM's arguments: each cell's horizon and the final carry planes.  The
// kernel's last parameter, so that the other parameters' offsets, and with
// them the whole-burst instantiations' code, do not depend on it.
struct FStream {
  const float* t_stop;
  float* clk_out;
  int* ctr_out;
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

// Lane-owned arrays of the wide path.
__host__ __device__ constexpr int freeze_wide_arrays(bool stream) {
  return kFreezeWideArrays + (stream ? kFreezeStreamWideArrays : 0);
}

// Scratch words of one cell: the wide path's lane-owned arrays, then
// (unstaged) the estimators and the queue, then the push FC rings.  An
// unstaged stream cell keeps its estimators, rings and FC rings in its
// output planes: none of them here.
// ops.event_step_plan(..., freeze=True) computes the same.
__host__ __device__ constexpr long freeze_scratch_words(bool staged,
                                                        bool wide, int pl,
                                                        int n1, int E, int W,
                                                        bool fc_push, int RF,
                                                        bool stream) {
  const int ex = stream && !staged ? 0 : E;
  return (wide ? freeze_wide_arrays(stream) * 32L * pl : 0L) +
         (staged ? 0L : est_words(ex, W) + 2L * round_up(n1, 4)) +
         (fc_push ? static_cast<long>(ex) * RF : 0L);
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

template <int PL, bool STAGED, bool STREAM>
__global__ void __launch_bounds__(32 * kMaxCellsPerBlock)
    freeze_kernel(const FArgs a, const FLayout L, const FDims D,
                  const int cells_per_block, const int bytes_per_cell,
                  const float horizon, const int pl_wide, const int words,
                  const FStream fs) {
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
    used = static_cast<size_t>(freeze_wide_arrays(STREAM)) * 32 * pl;
  }
  // STREAM and not staged: the estimators, rings and FC rings are read and
  // written where they lie in the output planes (copies of the input
  // planes), so that no warp copies them in and out; the scratch holds
  // none of them (ex entries)
  constexpr bool ALIAS = STREAM && !STAGED;
  const int ex = ALIAS ? 0 : E;
  uint32_t* est;
  if constexpr (STAGED) {
    est = reinterpret_cast<uint32_t*>(smem + static_cast<size_t>(warp) *
                                                 bytes_per_cell);
  } else {
    est = cw + used;
    used += est_words(ex, W) + 2 * round_up(n1, 4);
  }
  const int E4 = round_up(ex, 4);
  float* const co =
      STREAM ? fs.clk_out + static_cast<size_t>(b) * D.f_len : nullptr;
  int* const io =
      STREAM ? fs.ctr_out + static_cast<size_t>(b) * D.i_len : nullptr;
  float* const x_rsum = reinterpret_cast<float*>(est);
  float* const x_last = x_rsum + E4;
  float* const x_prev = x_last + E4;
  int* const x_rlen = reinterpret_cast<int*>(x_prev + E4);
  int* const x_rpos = x_rlen + E4;
  int* const x_narr = x_rpos + E4;
  int* const x_fcp = x_narr + E4;
  float* const x_ring = reinterpret_cast<float*>(x_fcp + E4);
  float* const e_rsum = ALIAS ? co + L.rsum : x_rsum;
  float* const e_last = ALIAS ? co + L.last_t : x_last;
  float* const e_prev = ALIAS ? co + L.prev_t : x_prev;
  int* const e_rlen = ALIAS ? io + L.rlen : x_rlen;
  int* const e_rpos = ALIAS ? io + L.rpos : x_rpos;
  int* const e_narr = ALIAS ? io + L.narr : x_narr;
  // (an arrival reads its FC ring position, used only with the rings:
  // under ALIAS without them it reads its arrival count instead, as the
  // scratch holds no (node, function) entry)
  int* const e_fcp = ALIAS ? io + (D.fc_push ? L.fcp : L.narr) : x_fcp;
  float* const ring = ALIAS ? co + L.ring : x_ring;
  unsigned* const q_key =
      reinterpret_cast<unsigned*>(x_ring + round_up(ex * W, 4));
  QN* const q_node = reinterpret_cast<QN*>(q_key + round_up(n1, 4));
  float* const fcr = !D.fc_push ? nullptr
                     : ALIAS    ? co + L.fcr
                                : reinterpret_cast<float*>(cw + used);
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
  if constexpr (!ALIAS) {
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
      for (int i = lane; i < E * RF; i += 32)
        fcr[i] = __ldg(clk + L.fcr + i);
  }
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
  Own<int, PL> s_row(lw, 8, pl);     // STREAM: each slot's row
  bool qn_zero = true;
#pragma unroll
  for (int q = 0; q < pl; ++q) {
    const int e = lane * pl + q;
    s_fin[q] = inf;
    s_p[q] = 0.0f;
    s_fn[q] = 0;
    s_node[q] = -1;
    s_slot[q] = 0;
    if constexpr (STREAM) s_row[q] = e < NSL ? __ldg(ctr + L.idx_s + e) : 0;
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
  const float t_stop = STREAM ? __ldg(fs.t_stop + b) : inf;
  int f_a = R.fn(min(ai, n));
  unsigned nx_key = least_key<PL>(s_fin, pl);
  float nx_t = key_float(nx_key);

  for (int step = 0; step < D.n_steps; ++step) {
    // -- event selection: the next arrival or the earliest completion (an
    // arrival wins an exact tie)
    const bool do_arr = t_a <= nx_t;
    const float now = do_arr ? t_a : nx_t;
    // no event left (STREAM: none before the horizon): the carry is fixed
    if (now == inf || (STREAM && now >= t_stop)) break;

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
      if (e == se) {
        s_fin[q] = fin_j;
        s_fn[q] = f_j;
        s_p[q] = p_j;
        if constexpr (STREAM) s_row[q] = j;
      }
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

  if constexpr (STREAM) {
    // -- the final carry, every entry at the offset it was read from (not
    // staged, the estimators and rings are there already)
    __syncwarp();
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
        io[L.qn + e] = n_qn[q];
        co[L.chan + e] = n_chan[q];
      }
    }
    if constexpr (!ALIAS) {
      for (int i = lane; i < E; i += 32) {
        co[L.rsum + i] = e_rsum[i];
        co[L.last_t + i] = e_last[i];
        co[L.prev_t + i] = e_prev[i];
        io[L.rlen + i] = e_rlen[i];
        io[L.rpos + i] = e_rpos[i];
        io[L.narr + i] = e_narr[i];
        if (D.fc_push) io[L.fcp + i] = e_fcp[i];
      }
      for (int i = lane; i < E * W; i += 32) co[L.ring + i] = ring[i];
      if (D.fc_push)
        for (int i = lane; i < E * RF; i += 32) co[L.fcr + i] = fcr[i];
    }
    // the queue: row i by lane i % 32, which wrote it
    for (int i = lane; i < n1; i += 32) {
      co[L.fprio + i] = o_prio[i];
      io[L.node_of + i] = o_node[i];
      io[L.pend + i] = q_node[i] != kNone ? 1 : 0;
    }
  }
}

template <int PL, bool STAGED, bool STREAM>
int launch_freeze(const FArgs& a, const FStream& fs, const FLayout& L,
                  const FDims& D, int cell, float horizon,
                  cudaStream_t stream, int pl, int words) {
  auto kernel = freeze_kernel<PL, STAGED, STREAM>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, L, D, cpb, cell, horizon, pl, words, fs);
  return static_cast<int>(cudaGetLastError());
}

template <int PL, bool STREAM>
int launch_freeze_pl(bool staged, const FArgs& a, const FStream& fs,
                     const FLayout& L, const FDims& D, int cell,
                     float horizon, cudaStream_t stream, int words) {
  return staged ? launch_freeze<PL, true, STREAM>(a, fs, L, D, cell, horizon,
                                                  stream, PL, words)
                : launch_freeze<PL, false, STREAM>(a, fs, L, D, cell,
                                                   horizon, stream, PL,
                                                   words);
}

// The checked launch of the frozen-priority kernel on D.B cells: `layout`
// holds the kFLayout carry offsets, `dims` the kFDims launch dimensions and
// `plan` the kFPlan entries of ops.event_step_plan(..., freeze=True)
// (entries per lane; staged or not; wide or not; shared-memory bytes a
// cell; scratch words a cell), all in host memory; `fs` STREAM's
// arguments (null pointers without it).  Returns cudaGetLastError() after
// the launch, or the error that stopped it.
template <bool STREAM>
int freeze_launch(const FArgs& a, const FStream& fs, const int* layout,
                  const int* dims, const int* plan, float horizon,
                  cudaStream_t s) {
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
  if (pl < 1 || 32 * pl < widest || D.fc_ring < 1 ||
      words != freeze_scratch_words(staged, wide, pl, n1, E, D.window,
                                    D.fc_push != 0, D.fc_ring, STREAM) ||
      (words > 0 && a.scratch == nullptr) ||
      (STREAM && (fs.t_stop == nullptr || fs.clk_out == nullptr ||
                  fs.ctr_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    if (staged || cell != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_freeze<0, false, STREAM>(a, fs, L, D, 0, horizon, s, pl,
                                           words);
  }
  if (staged ? (cell < freeze_cell_bytes(n1, E, D.window) || cell % 16 != 0 ||
                D.n_fns > 256)
             : cell != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pl) {
    case 1:
      return launch_freeze_pl<1, STREAM>(staged, a, fs, L, D, cell,
                                         horizon, s, words);
    case 2:
      return launch_freeze_pl<2, STREAM>(staged, a, fs, L, D, cell,
                                         horizon, s, words);
    case 4:
      return launch_freeze_pl<4, STREAM>(staged, a, fs, L, D, cell,
                                         horizon, s, words);
    case 8:
      return launch_freeze_pl<8, STREAM>(staged, a, fs, L, D, cell,
                                         horizon, s, words);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace
