// The float64 frozen-priority kernel (freeze64_kernel) and its launch,
// shared by csrc/event_step.cu (the sets without hedging),
// csrc/event_step_hedge.cu / csrc/event_step_dup.cu (the hedged sets),
// csrc/event_step_res.cu (the request lifecycle) and
// csrc/event_step_freeze_stream.cu (the chunked stream replay, STREAM =
// true), so that each translation unit compiles only its own
// instantiations.

#pragma once

#include "event_step_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The float64 frozen-priority regime: single-node and push cells with
// capacity dynamics (`DYN`: scheduled node failures, the autoscaler; push
// routes least-loaded), node speeds (`HET`), the cold-start containers
// (`COLD`), straggler hedging (`HEDGE`, `DUP`) or the request lifecycle
// (`RES`: timeouts, retries, shedding), the freeze branch of
// _scan_cell_kernel in float64 that the JAX package runs as XLA's
// lax.scan (repro/core/fastpath.py:821).  The plain PyTorch version is
// repro_torch/kernels/event_step.py::freeze_scan_ref with dyn / het /
// cold / hedge / dup / res.
//
// freeze_kernel's design in float64, with dyn_kernel's clocks and carried
// candidate events.  A first, exact kernel; what bounds it is the same
// serial chain of one event a step.
// - One warp a cell.  The register path (PL = 1 or 2 slots a lane, one node
//   a lane: up to 64 slots and 32 nodes) stages the rows t / p / cost
//   (float64) and fnid (8 bits), the per-(node, function) estimators and
//   runtime rings, the free containers (COLD) and the queue -- each row's
//   frozen priority as a 64-bit order key and the node it waits on (-1
//   once dispatched, lost or not yet arrived) -- in shared memory, when one
//   cell's fit (n_b up to ~5,000 at the push widths).  Otherwise the wide
//   path (PL = 0) keeps all of that and the lane arrays in a device-memory
//   scratch and reads the rows in place.
// - The estimators, the free containers and the FC rings' positions are
//   read and written by lane 0 alone (one entry an event), which hands
//   over what the warp needs by a shuffle.  A queue row i is read and
//   written by lane i % 32, as in freeze_kernel.
// - Candidate events, taken in the oracle's precedence (kill < arrival <=
//   completion < re-arrival < activation < tick, the first minimum wins),
//   each carried as a warp-uniform value and found again only when the
//   event that moves it happens.
// - A kill frees its node's slots and its queue: the running calls get
//   their launch sequence (stamped from the launch count at dispatch) as
//   their re-route rank, the queued ones the rank kRordQ, and all their
//   re-arrival time, in per-row arrays of the scratch (written by the slot
//   owners and the row lanes, then a __syncwarp).  A re-arrival takes,
//   among the rows due at that instant, the least rank, then among
//   ex-queued rows the least (frozen-priority key, row); it is routed,
//   observed and ranked like an arrival, and the first queued row (lo)
//   moves back to it if it is below.
// - HET: the node's speed at dispatch divides cost and runtime as
//   (x * slowdown) / speed, as XLA compiles the oracle's x / (speed /
//   slowdown); the slot keeps the call's measured service p / eff (eff =
//   speed / slowdown), which its completion logs in the node's ring (under
//   STREAM it keeps eff, the carry's sspd, and the completion divides).
// - COLD: a dispatch takes a free container of the node and function (lane
//   0) or starts cold, adding kPrewarmExtra to the cost before the speed
//   divides it; a completion returns the container or evicts it at
//   `cores` free ones.  Each row's flag starts as the carry's and lane 0
//   writes it at dispatch.
// - HEDGE (straggler hedging, push) and DUP (its duplicate mode; implies
//   HEDGE, excludes DYN): the hedge branch of the same body.  Each row
//   carries its watch's deadline (a second one under DYN) and a word of
//   its attempts and flags (stolen, no-more-hedging, first completion
//   done), each queue entry its push sequence (the step count at
//   insertion), all in the cell's area after the queue; lane 0 keeps the
//   controller's runtime ring (every completion's raw p) beside the nodes'.
//   The earliest deadline and its row are carried as warp-uniform values,
//   found again by a warp scan only when that row's deadline changes (a
//   fire, its call's dispatch, a kill).  A fire ranks after completions
//   (after the tick under DYN), and takes a step even when it is a no-op
//   (the step count numbers every insertion).  An acting fire cancels the
//   call on its node and inserts it, as an arrival, on the least-loaded
//   live peer (its own node when none), or under DUP inserts copy c =
//   attempts + 1 of row j at queue entry c (n+1) + j (a row's features
//   are read at q mod (n+1)); the first completion of any copy writes the
//   call's outputs.  Equal frozen keys on a node dispatch by push sequence.
// - RES (the request lifecycle: timeouts, retries, shedding; push and
//   single-node cells on a fixed uniform warm fleet, so none of the flags
//   above): the res branch of the same body.  Each row carries its timeout
//   deadline, its retry re-arrival time and the E[p] its admission added
//   to the shed gauge (float64, in the deadlines' place), its submissions,
//   failure flag and cause in one word, and its push sequence; each slot
//   its execution start (in the measured service's place: HET is off);
//   lane 0 keeps the controller's runtime ring (in the hedge ring's
//   place).  The earliest deadline and the earliest re-arrival and their
//   rows are carried as warp-uniform values.  A deadline fire ranks after
//   completions, a re-arrival after both.  A fire on a queued call takes it
//   off its node's queue and its E[p] off the gauge; on a running one the
//   slot's owner frees it, the seconds run join the wasted work and the
//   node dispatches; then the call re-arrives after its backoff or fails.
//   An arrival or re-arrival counts a submission and is shed when the
//   gauge over the fleet's free slots (a warp sum) exceeds the threshold;
//   else it adds the controller's E[p] to the gauge, arms its deadline and
//   is inserted as an arrival.  Equal frozen keys on a node dispatch by
//   push sequence, as under HEDGE.
// - STREAM (one chunk of the chunked stream replay, the stream branch of
//   _scan_cell_kernel on this regime; freeze_scan_ref with stream; not
//   beside DUP): the scan stops at the first event at or past the cell's
//   t_stop, ahead of every candidate; RES's retry jitter hashes each row's
//   global arrival rank (gseq) in place of its row; the arrival cursor
//   starts the queue's scan window (hi) at the chunk's first fresh row, so
//   that a carried call's re-arrival or retry is seen; and at the end
//   every carry entry goes back out to clk_out / ctr_out (copies of the
//   planes the wrapper makes) at the offsets it was read from -- slots,
//   nodes, the queue with each row's per-row state (dynamics, hedge, res),
//   the controller's ring, the counters and clocks -- with the step count
//   at the JAX scan's (all n_steps counted).  On the wide path (every
//   stream set's) the per-(node, function) estimators and rings, FC rings
//   and free containers are read and written in place in clk_out /
//   ctr_out instead of the scratch: a warp copying them in and out took
//   ~0.5 s a chunk at the planet fleet's ~250 MB.
// - DYN, HET, COLD, HEDGE, DUP, RES and STREAM are template parameters, so
//   the float32 kernels and every combination carry only the state they
//   use; the hedged, the resilience and the stream sets are compiled in
//   their own sources.
// Outputs: start / finish written at each dispatch (a re-dispatched call
// keeps its last; under DUP the winning copy's, at its completion), prio /
// node each row's frozen values (the carry's, overwritten at each arrival
// and re-arrival; under DUP node is the winner's), the summary, the cold
// counts and the hedge counts (backups, calls stolen or won by a copy,
// calls done, steps taken) and each row's attempts at the end; under RES
// the timeouts, sheds, retries, calls resolved, steps taken and wasted
// seconds, and each row's failure flag, cause and submissions.
// ---------------------------------------------------------------------------

constexpr int kF64Layout = 71;  // carry entries, see struct F64Layout
constexpr int kF64Dims = 20;    // integer launch dimensions, see F64Dims
constexpr int kF64Plan = 5;     // per_lane, staged, wide, cell_bytes, words
// lane-owned words of the wide path: a slot's completion time and measured
// service (2 words each), row and launch sequence; a node's channel clock,
// activation, kill time and speed (2 each), busy, queued, dead and pending
constexpr int kF64SlotWords = 6;
constexpr int kF64NodeWords = 12;
constexpr int kRordQ = 1 << 30;   // the re-route rank of a call lost queued
constexpr unsigned long long KEY64_INF = 0xfff0000000000000ull;  // +inf

// Offsets of the carry entries: the first thirteen in the clk plane, the
// next twenty-two in the ctr plane, then the hedge and dup entries, seven
// in the clk plane and ten in the ctr plane, then the res entries, eight
// in the clk plane and eleven in the ctr plane (EVENT_STEP_FREEZE64_LAYOUT
// in ops.py); the entries of a segment the bucket lacks are 0.
struct F64Layout {
  int chan, fin_s, fprio, last_t, prev_t, ring, rsum, fcr, sspd, act_t,
      killq, rearr, next_tick;
  int ai, busy, idx_s, narr, node_of, pend, qn, rlen, rpos, fcp, freec,
      ncold, nevt, coldq, dead, act_pend, prov, nfail, ndone, dseq, dcnt,
      rord;
  int hedge_t, hedge_t2, cring, crsum, win_start, win_fin, start_q;
  int att, nbk, stolen, crlen, crpos, qseq, stepc, unhedge, done0, win_node;
  int to_t, rto, eps, qep, sst, wst, zring, zrsum;
  int ratt, nfl, fcz, nto, nsh, nrt, ndn, qsq, stp, zrlen, zrpos;
};

struct F64Dims {
  int B, n, n_nodes, n_slots, window, n_fns, ncoef, n_ep, f_len, i_len,
      fc_push, fc_ring, dyn, het, cold, n_steps, hedge, dup, n_copies, res;
};

// The hedged sets' inputs and outputs (null without HEDGE).
struct H64Args {
  const double* hmult;   // (B,): the deadline's multiple of the estimate
  const double* hfloor;  // (B,): the estimate's floor
  const int* hmax;       // (B,): the backup cap
  int* hsum;             // (B, 4): backups, calls stolen or won by a copy,
                         //   calls done, steps taken
  int* att_out;          // (B, n + 1): each row's attempts
};

// The resilience sets' inputs and outputs (null without RES).
struct R64Args {
  const double* rto_p;   // (B, 4): timeout on, multiple, floor, absolute
  const double* rrt_p;   // (B, 6): max attempts, backoff base, cap, jitter,
                         //   retry on timeout, on shed
  const double* adm_p;   // (B, 2): shedding on, threshold
  int* rsum;             // (B, 5): timeouts, sheds, retries, calls
                         //   resolved, steps taken
  double* wst_out;       // (B,): the wasted execution seconds
  int* nfl_out;          // (B, n + 1): each row's failure flag
  int* fcz_out;          // (B, n + 1): its cause (1 timeout, 2 shed)
  int* ratt_out;         // (B, n + 1): its submissions
};

// The bits of a row's hedge word under its attempts (word >> kAttShift);
// under RES the word holds the failure cause (kCause) and flag (kFailed)
// under the submissions
constexpr int kStolen = 1, kUnhedge = 2, kDone0 = 4, kAttShift = 3;
constexpr int kCause = 3, kFailed = 4;

// The stream sets' inputs and outputs (null without STREAM).
struct S64Args {
  const double* t_stop;  // (B,): each cell's horizon
  const int* gseq;       // (B, n + 1): each row's global arrival rank (RES)
  double* clk_out;       // (B, f_len), (B, i_len): the final carry planes
  int* ctr_out;
};

struct F64Args {
  const double* clk;
  const int* ctr;
  const double* t;
  const int* fnid;
  const double* p;
  const double* cost;
  const double* coef;
  const int* cores;
  const int* nodes;
  const double* cnt;
  const int* home0;
  const int* route;
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

// The hedge or res segment's shape in a cell's area: functions (the
// controller's ring), whether the second deadline (DYN) and the copies
// (DUP) are there, the queue entries (n1, or n_copies n1 under DUP), and
// whether it is the res segment (three float64 row arrays in the
// deadlines' place; no copies, no second deadline).
struct HShape {
  int F;
  bool hedge, two, dup;
  int nq;
  bool res = false;
};

// Bytes of one cell's estimators, queue and free containers, hedge or res
// state and (staged) its rows, in shared memory (staged) or the scratch:
// the float64 arrays (sum, last and previous arrival; the rings; hedge or
// res: the controller's sum and ring; the rows; the queue keys; hedge:
// each row's deadline or two; res: each row's deadline, re-arrival time
// and admitted E[p]; dup: each entry's start), then the int32 ones
// (length, position, arrivals, FC ring position; the free containers; the
// queue nodes; hedge or res: the controller's length and position, each
// row's word, each entry's push sequence), then the staged fnid.
// ops.event_step_freeze64_cell_bytes computes the same.
__host__ __device__ constexpr int f64_cell_bytes(bool staged, int n1, int E,
                                                 int W, int nfree,
                                                 HShape h = HShape{
                                                     0, false, false, false,
                                                     0}) {
  const bool ctl = h.hedge || h.res;   // the controller's ring is there
  const int nq = h.hedge ? h.nq : n1;
  return round_up(
      8 * (3 * round_up(E, 2) + round_up(E * W, 2) +
           (ctl ? round_up(h.F, 2) + round_up(h.F * W, 2) : 0) +
           (staged ? 3 : 0) * round_up(n1, 2) + round_up(nq, 2) +
           (h.hedge ? (h.two ? 2 : 1) * round_up(n1, 2) : 0) +
           (h.res ? 3 * round_up(n1, 2) : 0) +
           (h.dup ? round_up(nq, 2) : 0)) +
          4 * (4 * round_up(E, 4) + round_up(nfree, 4) + round_up(nq, 4) +
               (ctl ? 2 * round_up(h.F, 4) + round_up(n1, 4) +
                          round_up(nq, 4)
                    : 0)) +
          (staged ? round_up(n1, 16) : 0),
      16);
}

// Scratch words of one cell: (wide) the lane arrays and the estimators and
// queue, then (dyn) each row's re-arrival time and rank, then (push FC)
// the float64 rings.  A stream cell (the wide path) keeps its per-(node,
// function) arrays in its output planes: none of them here.
// ops.event_step_plan computes the same.
__host__ __device__ constexpr long f64_scratch_words(bool wide, int pls,
                                                     int pln, int n1, int E,
                                                     int W, int nfree,
                                                     bool dyn, bool fc_push,
                                                     int RF, HShape h,
                                                     bool stream) {
  const int ex = stream ? 0 : E;
  return (wide ? 32L * (kF64SlotWords * pls + kF64NodeWords * pln) +
                     f64_cell_bytes(false, n1, ex, W, stream ? 0 : nfree,
                                    h) / 4
               : 0L) +
         (dyn ? 2L * round_up(n1, 2) + round_up(n1, 4) : 0L) +
         (fc_push ? 2L * ex * RF : 0L);
}

template <int PL, bool COLD, bool HET, bool DYN, bool HEDGE, bool DUP,
          bool RES, bool STREAM>
__global__ void __launch_bounds__(32 * kMaxCellsPerBlock)
    freeze64_kernel(const F64Args a, const H64Args h, const R64Args r,
                    const S64Args sa, const F64Layout L, const F64Dims D,
                    const int cells_per_block, const int bytes_per_cell,
                    const float horizon_f, const int pl_wide,
                    const int words) {
  static_assert(!DUP || (HEDGE && !DYN), "DUP needs HEDGE, excludes DYN");
  static_assert(!RES || !(COLD || HET || DYN || HEDGE || DUP),
                "RES excludes COLD, HET, DYN, HEDGE and DUP");
  static_assert(!(STREAM && DUP), "STREAM excludes DUP");
  constexpr bool CTL = HEDGE || RES;   // the controller's ring
  constexpr bool STAGED = PL > 0;      // the register path stages
  constexpr int NQ = PL > 0 ? 1 : 0;   // nodes a lane: 1, or the scratch
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * cells_per_block + warp;
  if (b >= D.B) return;

  const int n = D.n, n1 = D.n + 1;
  const int NN = D.n_nodes, NS = D.n_slots, NSL = D.n_nodes * D.n_slots;
  const int F = D.n_fns, W = D.window, E = NN * F, RF = D.fc_ring;
  const bool FCP = D.fc_push != 0;
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  const double horizon = static_cast<double>(horizon_f);
  const size_t row = static_cast<size_t>(b) * n1;
  const double* clk = a.clk + static_cast<size_t>(b) * D.f_len;
  const int* ctr = a.ctr + static_cast<size_t>(b) * D.i_len;
  const int pls = PL > 0 ? PL : pl_wide;           // slots a lane
  const int pln = PL > 0 ? 1 : (NN + 31) / 32;     // nodes a lane
  const int nfree = COLD ? E : 0;
  // queue entries: the rows, or under DUP each row's copies; an entry's
  // row features are its row's
  const int nq = DUP ? D.n_copies * n1 : n1;
  auto rw = [&](int q) { return DUP ? q % n1 : q; };
  const HShape hs{F, HEDGE, HEDGE && DYN, DUP, nq, RES};

  // -- the cell's scratch: (wide) lane arrays, estimators and queue; then
  // the per-row dynamics arrays and the FC rings
  uint32_t* wp = a.scratch == nullptr
                     ? nullptr
                     : a.scratch + static_cast<size_t>(b) * words;
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
  // a slot's completion time and measured service (HET; under STREAM its
  // effective speed), or under RES its execution start
  Lane<double, PL> s_fin(dbl(pls)), s_v(dbl(pls));
  Lane<int, PL> s_row(i32(pls)), s_dseq(i32(pls));
  Lane<double, NQ> n_chan(dbl(pln)), n_act(dbl(pln)), n_kill(dbl(pln)),
      n_spd(dbl(pln));
  Lane<int, NQ> n_busy(i32(pln)), n_qn(i32(pln)), n_dead(i32(pln)),
      n_pend(i32(pln));
  // STREAM on the wide path: the per-(node, function) arrays -- estimators,
  // rings, FC rings, free containers -- are read and written where they
  // lie in the output planes (copies of the input planes), so that no warp
  // copies them in and out (~250 MB a chunk at the planet fleet's widths);
  // the scratch holds none of them (ex entries, nfx free counts)
  constexpr bool ALIAS = STREAM && PL == 0;
  const int ex = ALIAS ? 0 : E, nfx = ALIAS ? 0 : nfree;
  unsigned char* cb;
  if constexpr (STAGED) {
    cb = smem + static_cast<size_t>(warp) * bytes_per_cell;
  } else {
    cb = reinterpret_cast<unsigned char*>(wp);
    wp += f64_cell_bytes(false, n1, ex, W, nfx, hs) / 4;
  }
  const int E2 = round_up(ex, 2), E4 = round_up(ex, 4), N2 = round_up(n1, 2);
  const int Q2 = round_up(nq, 2), Q4 = round_up(nq, 4);
  // STREAM: this cell's output planes
  double* const co = STREAM ? sa.clk_out + static_cast<size_t>(b) * D.f_len
                            : nullptr;
  int* const io = STREAM ? sa.ctr_out + static_cast<size_t>(b) * D.i_len
                         : nullptr;
  double* const x_rsum = reinterpret_cast<double*>(cb);
  double* const x_ring = x_rsum + 3 * E2;
  double* const e_rsum = ALIAS ? co + L.rsum : x_rsum;
  double* const e_last = ALIAS ? co + L.last_t : x_rsum + E2;
  double* const e_prev = ALIAS ? co + L.prev_t : x_rsum + 2 * E2;
  double* const ring = ALIAS ? co + L.ring : x_ring;
  // the controller's ring (HEDGE, RES): its sums, then its F x W entries
  double* const c_rsum = x_ring + round_up(ex * W, 2);
  double* const cring = c_rsum + (CTL ? round_up(F, 2) : 0);
  double* const rows_d = cring + (CTL ? round_up(F * W, 2) : 0);
  unsigned long long* const q_key = reinterpret_cast<unsigned long long*>(
      rows_d + (STAGED ? 3 * N2 : 0));
  // each row's deadline (and second one), each entry's start (DUP); under
  // RES each row's timeout deadline, retry re-arrival time and admitted
  // E[p]
  double* const h_t = reinterpret_cast<double*>(q_key + Q2);
  double* const h_t2 = h_t + (CTL ? N2 : 0);
  double* const r_eps = h_t2 + ((HEDGE && DYN) || RES ? N2 : 0);
  double* const start_q = r_eps + (RES ? N2 : 0);
  int* const x_rlen = reinterpret_cast<int*>(start_q + (DUP ? Q2 : 0));
  int* const e_rlen = ALIAS ? io + L.rlen : x_rlen;
  int* const e_rpos = ALIAS ? io + L.rpos : x_rlen + E4;
  int* const e_narr = ALIAS ? io + L.narr : x_rlen + 2 * E4;
  // (an arrival reads its FC ring position, used only with the rings:
  // under ALIAS without them it reads its arrival count instead, as the
  // scratch holds no (node, function) entry)
  int* const e_fcp = ALIAS ? io + (FCP ? L.fcp : L.narr) : x_rlen + 3 * E4;
  int* const fcnt = ALIAS && COLD ? io + L.freec : x_rlen + 4 * E4;
  int* const q_node = x_rlen + 4 * E4 + round_up(nfx, 4);
  // the controller's lengths and positions, each row's hedge word (its
  // attempts and flags; RES: its submissions, failure flag and cause),
  // each entry's push sequence
  int* const c_rlen = q_node + Q4;
  int* const c_rpos = c_rlen + (CTL ? round_up(F, 4) : 0);
  int* const hst = c_rpos + (CTL ? round_up(F, 4) : 0);
  int* const qseq = hst + (CTL ? round_up(n1, 4) : 0);
  int* const i_end = qseq + (CTL ? Q4 : 0);
  double* const r_rearr = reinterpret_cast<double*>(wp);
  int* const r_rord = reinterpret_cast<int*>(r_rearr + N2);
  double* const fcr =
      ALIAS && FCP ? co + L.fcr
                   : reinterpret_cast<double*>(
                         wp + (DYN ? 2 * N2 + round_up(n1, 4) : 0));

  DRows<STAGED> R;
  if constexpr (STAGED) {
    double* st = rows_d;
    double* sp = st + N2;
    double* sc = sp + N2;
    uint8_t* sfn = reinterpret_cast<uint8_t*>(i_end);
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
  if constexpr (!ALIAS) {
    for (int i = lane; i < E; i += 32) {
      e_rsum[i] = __ldg(clk + L.rsum + i);
      e_last[i] = __ldg(clk + L.last_t + i);
      e_prev[i] = __ldg(clk + L.prev_t + i);
      e_rlen[i] = __ldg(ctr + L.rlen + i);
      e_rpos[i] = __ldg(ctr + L.rpos + i);
      e_narr[i] = __ldg(ctr + L.narr + i);
      e_fcp[i] = FCP ? __ldg(ctr + L.fcp + i) : 0;
      if constexpr (COLD) fcnt[i] = __ldg(ctr + L.freec + i);
    }
    for (int i = lane; i < E * W; i += 32) ring[i] = __ldg(clk + L.ring + i);
    if (FCP)
      for (int i = lane; i < E * RF; i += 32)
        fcr[i] = __ldg(clk + L.fcr + i);
  }
  // the queue, the frozen outputs and the per-row carry: row i by lane
  // i % 32
  double* const o_start = a.start + row;
  double* const o_finish = a.finish + row;
  double* const o_prio = a.prio + row;
  int* const o_node = a.node + row;
  int* const o_coldq = COLD ? a.coldq_out + row : nullptr;
  int hi = 0;         // one past the last queued row
  int n_re = 0;       // rows with a re-arrival pending
  for (int i = lane; i < nq; i += 32) {
    const bool pend = __ldg(ctr + L.pend + i) != 0;
    const double fp = __ldg(clk + L.fprio + i);
    const int nd = __ldg(ctr + L.node_of + i);
    q_key[i] = order_key64(fp);
    q_node[i] = pend ? nd : -1;
    if (pend) hi = i + 1;
    if constexpr (HEDGE) qseq[i] = __ldg(ctr + L.qseq + i);
    if constexpr (RES) {
      qseq[i] = __ldg(ctr + L.qsq + i);
      h_t[i] = __ldg(clk + L.to_t + i);
      h_t2[i] = __ldg(clk + L.rto + i);
      r_eps[i] = __ldg(clk + L.eps + i);
      hst[i] = (__ldg(ctr + L.ratt + i) << kAttShift) |
               (__ldg(ctr + L.nfl + i) ? kFailed : 0) |
               (__ldg(ctr + L.fcz + i) & kCause);
    }
    if constexpr (DUP) {
      start_q[i] = __ldg(clk + L.start_q + i);
      if (i >= n1) continue;
    }
    o_prio[i] = fp;
    if constexpr (DUP) {
      // the outputs are the winning copies'
      o_node[i] = __ldg(ctr + L.win_node + i);
      o_start[i] = __ldg(clk + L.win_start + i);
      o_finish[i] = __ldg(clk + L.win_fin + i);
    } else {
      o_node[i] = nd;
    }
    if constexpr (COLD) o_coldq[i] = __ldg(ctr + L.coldq + i);
    if constexpr (DYN) {
      r_rearr[i] = __ldg(clk + L.rearr + i);
      r_rord[i] = __ldg(ctr + L.rord + i);
      n_re += r_rearr[i] != inf;
    }
    if constexpr (HEDGE) {
      h_t[i] = __ldg(clk + L.hedge_t + i);
      if constexpr (DYN) h_t2[i] = __ldg(clk + L.hedge_t2 + i);
      hst[i] = (__ldg(ctr + L.att + i) << kAttShift) |
               (__ldg(ctr + L.stolen + i) ? kStolen : 0) |
               (DYN && __ldg(ctr + L.unhedge + i) ? kUnhedge : 0) |
               (DUP && __ldg(ctr + L.done0 + i) ? kDone0 : 0);
    }
  }
  if constexpr (CTL) {
    // the controller's ring: lane 0 reads and writes it
    const int Ls = HEDGE ? L.crsum : L.zrsum, Ll = HEDGE ? L.crlen : L.zrlen;
    const int Lp = HEDGE ? L.crpos : L.zrpos, Lr = HEDGE ? L.cring : L.zring;
    for (int i = lane; i < F; i += 32) {
      c_rsum[i] = __ldg(clk + Ls + i);
      c_rlen[i] = __ldg(ctr + Ll + i);
      c_rpos[i] = __ldg(ctr + Lp + i);
    }
    for (int i = lane; i < F * W; i += 32) cring[i] = __ldg(clk + Lr + i);
  }
  hi = __reduce_max_sync(FULL, hi);
  if constexpr (DYN) n_re = __reduce_add_sync(FULL, n_re);
  const bool carried = hi > 0;    // calls queued in the carry
  __syncwarp();

  const double* cf = a.coef + static_cast<size_t>(b) * D.ncoef;
  const double c0 = __ldg(cf), c1 = __ldg(cf + 1), c2 = __ldg(cf + 2),
               c3 = __ldg(cf + 3);
  const int cores = __ldg(a.cores + b), nodes = __ldg(a.nodes + b);
  const int route = __ldg(a.route + b);
  double interval = 0.0, thr = 0.0, delay = 0.0, detect = 0.0;
  int maxn = 0, nreq = 0;
  if constexpr (DYN) {
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
  double hmult = 0.0, hfloor = 0.0;
  int hmax = 0;
  if constexpr (HEDGE) {
    hmult = __ldg(h.hmult + b);
    hfloor = __ldg(h.hfloor + b);
    hmax = __ldg(h.hmax + b);
  }
  // RES: the timeout (on, multiple, floor, absolute), the retries (max
  // attempts, backoff base, cap, jitter, on timeout, on shed), the
  // shedding (on, threshold)
  bool to_on = false, on_to = false, on_sh = false, adm_on = false;
  double to_mult = 0.0, to_floor = 0.0, to_abs = 0.0, rt_base = 0.0,
         rt_cap = 0.0, rt_jit = 0.0, adm_thr = 0.0;
  int maxa = 1;
  if constexpr (RES) {
    const double* tp = r.rto_p + static_cast<size_t>(b) * 4;
    const double* rp = r.rrt_p + static_cast<size_t>(b) * 6;
    const double* ap = r.adm_p + static_cast<size_t>(b) * 2;
    to_on = __ldg(tp) > 0.0;
    to_mult = __ldg(tp + 1);
    to_floor = __ldg(tp + 2);
    to_abs = __ldg(tp + 3);
    maxa = static_cast<int>(__ldg(rp));
    rt_base = __ldg(rp + 1);
    rt_cap = __ldg(rp + 2);
    rt_jit = __ldg(rp + 3);
    on_to = __ldg(rp + 4) > 0.0;
    on_sh = __ldg(rp + 5) > 0.0;
    adm_on = __ldg(ap) > 0.0;
    adm_thr = __ldg(ap + 1);
  }
  // RetryPolicy.delay after failed submission `att` of row `i`, term for
  // term: the 16-bit jitter hash of its arrival rank (the row, or under
  // STREAM its global rank) and the attempt, the power of two as a shift
  auto retry_delay = [&](int i, int att) {
    const int seq = STREAM ? __ldg(sa.gseq + row + i) : i;
    const long long hsh =
        (static_cast<long long>(seq) * 7919 +
         static_cast<long long>(att) * 104729 + 12345) % 65536;
    const double u = __ddiv_rn(static_cast<double>(hsh), 65536.0);
    const double shift = static_cast<double>(1 << max(att - 1, 0));
    const double raw = fmin(rt_cap, __dmul_rn(rt_base, shift));
    return __dmul_rn(raw, __dadd_rn(__dsub_rn(1.0, rt_jit),
                                    __dmul_rn(rt_jit, u)));
  };

  // -- slots and nodes, from the planes into the owning lanes
#pragma unroll
  for (int q = 0; q < pls; ++q) {
    const int e = lane * pls + q;
    const bool se = e < NSL;
    s_fin[q] = se ? __ldg(clk + L.fin_s + e) : inf;
    s_row[q] = se ? min(max(__ldg(ctr + L.idx_s + e), 0), nq - 1) : n;
    s_v[q] = HET && se ? (STREAM ? __ldg(clk + L.sspd + e)
                                 : __ddiv_rn(R.p(rw(s_row[q])),
                                             __ldg(clk + L.sspd + e)))
             : RES && se ? __ldg(clk + L.sst + e)
                         : 0.0;
    s_dseq[q] = DYN && se ? __ldg(ctr + L.dseq + e) : 0;
  }
  bool qn_zero = true;
  for (int q = 0; q < pln; ++q) {
    const int e = lane * pln + q;
    const bool ne = e < NN;
    n_busy[q] = ne ? __ldg(ctr + L.busy + e) : 0;
    n_qn[q] = ne ? __ldg(ctr + L.qn + e) : 0;
    n_chan[q] = ne ? __ldg(clk + L.chan + e) : 0.0;
    n_act[q] = ne && DYN ? __ldg(clk + L.act_t + e) : 0.0;
    n_kill[q] = ne && DYN ? __ldg(clk + L.killq + e) : inf;
    n_dead[q] = ne && DYN ? __ldg(ctr + L.dead + e) : 0;
    n_pend[q] = ne && DYN ? __ldg(ctr + L.act_pend + e) : 0;
    n_spd[q] = ne && HET ? __ldg(a.spd + static_cast<size_t>(b) * NN + e)
                         : 1.0;
    if (n_qn[q] != 0) qn_zero = false;
  }
  // in a fresh carry a node's queued count is the number of calls queued
  // on it, and a node with none is skipped
  const bool counted = !carried && __all_sync(FULL, qn_zero);
  int ai = __ldg(ctr + L.ai);
  int lo = 0;     // the first queued row (none before it)
  // a carried row (before the cursor) that re-arrives or retries is
  // queued below it
  hi = max(hi, min(ai, n));
  double t_a = ai <= n ? R.t(ai) : inf;
  const double t_stop = STREAM ? __ldg(sa.t_stop + b) : inf;
  int ncold = COLD ? __ldg(ctr + L.ncold) : 0;
  int nevt = COLD ? __ldg(ctr + L.nevt) : 0;
  int nfail = DYN ? __ldg(ctr + L.nfail) : 0;
  int ndone = DYN || HEDGE ? __ldg(ctr + L.ndone) : 0;
  int prov = DYN ? __ldg(ctr + L.prov) : 0;
  int dcnt = DYN ? __ldg(ctr + L.dcnt) : 0;
  double next_tick = DYN ? __ldg(clk + L.next_tick) : inf;
  int nbk = HEDGE ? __ldg(ctr + L.nbk) : 0;
  // the step count (RES: the push sequence's clock too)
  int stepc = HEDGE ? __ldg(ctr + L.stepc) : RES ? __ldg(ctr + L.stp) : 0;
  const int stepc0 = stepc;
  // RES: the timeouts, sheds and retries, the calls resolved (in ndone),
  // the shed gauge and the wasted seconds
  int nto = 0, nsh = 0, nrt = 0;
  double qep = 0.0, wst = 0.0;
  if constexpr (RES) {
    nto = __ldg(ctr + L.nto);
    nsh = __ldg(ctr + L.nsh);
    nrt = __ldg(ctr + L.nrt);
    ndone = __ldg(ctr + L.ndn);
    qep = __ldg(clk + L.qep);
    wst = __ldg(clk + L.wst);
  }

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
  // the queued calls of every node (the autoscaler's rule, an activation)
  auto queued_all = [&]() {
    int s = 0;
    for (int q = 0; q < pln; ++q) s += lane * pln + q < NN ? n_qn[q] : 0;
    return __reduce_add_sync(FULL, s);
  };
  auto active_node = [&](int q, int e, double now) {
    if constexpr (DYN) return e < NN && n_act[q] <= now && !n_dead[q];
    else return e < nodes;
  };
  // the least time of a per-row array and its row (the first on equal
  // times), each row read by its lane
  auto find_row_min = [&](const double* arr, double& t_min, int& t_row) {
    unsigned long long k = NO_KEY64;
    int idx = INT_MAX;
    for (int i = lane; i < n1; i += 32) {
      const unsigned long long kv = order_key64(arr[i]);
      if (kv < k) { k = kv; idx = i; }
    }
    int at;
    const unsigned long long m = warp_argmin64(k, idx, &at);
    t_min = m == NO_KEY64 ? inf : key_double(m);
    t_row = at == INT_MAX ? 0 : at;
  };
  // row w's time became v (written by its lane): the least moves to it, or
  // is found again when it was w's and grew
  auto row_min_set = [&](const double* arr, double& t_min, int& t_row, int w,
                         double v) {
    if (w == t_row) {
      if (v <= t_min) t_min = v; else find_row_min(arr, t_min, t_row);
    } else if (v < t_min || (v == t_min && w < t_row)) {
      t_min = v;
      t_row = w;
    }
  };
  // the earliest deadline (HEDGE: the watch's; RES: the timeout's) and
  // under RES the earliest retry re-arrival, with their rows
  double h_min = inf, rt_min = inf;
  int h_row = 0, rt_row = 0;
  auto find_deadline = [&]() { find_row_min(h_t, h_min, h_row); };
  auto deadline_set = [&](int w, double v) {
    row_min_set(h_t, h_min, h_row, w, v);
  };
  auto find_retry = [&]() { find_row_min(h_t2, rt_min, rt_row); };
  auto retry_set = [&](int w, double v) {
    row_min_set(h_t2, rt_min, rt_row, w, v);
  };
  // the first queued row moves past the rows no longer queued
  auto advance_lo = [&]() {
    for (int base = lo & ~31;; base += 32) {
      const int r = base + lane;
      const unsigned m =
          __ballot_sync(FULL, r >= lo && r < hi && q_node[r] >= 0);
      if (m != 0) { lo = base + __ffs(m) - 1; break; }
      if (base + 32 >= hi) { lo = hi; break; }
    }
  };
  find_completion();
  if constexpr (DYN) {
    find_node(true);
    find_node(false);
    if (n_re > 0) find_rearr();
  }
  if constexpr (CTL) find_deadline();
  if constexpr (RES) find_retry();

  for (int step = 0; step < D.n_steps; ++step) {
    // -- event selection: (kill <) arrival <= completion (< re-arrival <
    // activation < tick), the first minimum wins
    double now;
    int ev;
    if constexpr (DYN) {
      now = kill_t;
      ev = 0;
      if (t_a < now) { now = t_a; ev = 1; }
      if (nx_t < now) { now = nx_t; ev = 2; }
      if (re_min < now) { now = re_min; ev = 3; }
      if (act_min < now) { now = act_min; ev = 4; }
      if (next_tick < now) { now = next_tick; ev = 5; }
    } else {
      ev = t_a <= nx_t ? 1 : 2;
      now = ev == 1 ? t_a : nx_t;
    }
    // the earliest deadline ranks last; under RES the earliest timeout
    // ranks after completions, the earliest retry re-arrival after both
    if (HEDGE && h_min < now) { now = h_min; ev = 6; }
    if (RES && h_min < now) { now = h_min; ev = 7; }
    if (RES && rt_min < now) { now = rt_min; ev = 8; }
    // no event left (STREAM: none before the horizon): the carry is fixed
    if (now == inf || (STREAM && now >= t_stop)) break;

    int k_d = -1;               // the node a dispatch is tried on
    int ins = -1;               // the entry an (re-)arrival inserts
    int k_to = -1;              // a steal's or copy's node
    int h_from = -1;            // the row a steal or copy hedges
    if (ev == 1) {
      ins = ai;
    } else if (HEDGE && ev == 6) {
      // -- the earliest deadline fires: it acts on a call still queued
      // and under its backup cap (under DYN, not lost while running),
      // else it is a no-op (and does not re-arm)
      const int jh = h_row;
      int able = 0, old = 0, att = 0;
      if ((jh & 31) == lane) {
        const int w = hst[jh];
        old = q_node[jh];
        att = w >> kAttShift;
        able = old >= 0 && att < hmax && !(DYN && (w & kUnhedge));
        if constexpr (DYN) {
          h_t[jh] = h_t2[jh];
          h_t2[jh] = inf;
        } else {
          h_t[jh] = inf;
        }
      }
      able = __shfl_sync(FULL, able, jh & 31);
      old = __shfl_sync(FULL, old, jh & 31);
      att = __shfl_sync(FULL, att, jh & 31);
      find_deadline();
      // the least-loaded live peer, the call's node excluded (first on
      // ties); none: a steal goes back to its node, a copy is not made
      int lb = INT_MAX, eb = INT_MAX;
      for (int q = 0; q < pln; ++q) {
        const int e = lane * pln + q;
        if (e < NN && e != old && active_node(q, e, now)) {
          const int ld = n_busy[q] + n_qn[q];
          if (ld < lb) { lb = ld; eb = e; }
        }
      }
      const int lmin = __reduce_min_sync(FULL, lb);
      const int peer = __reduce_min_sync(FULL, lb == lmin ? eb : INT_MAX);
      if (able && !(DUP && peer == INT_MAX)) {
        h_from = jh;
        k_to = peer == INT_MAX ? old : peer;
        ins = DUP ? (att + 1) * n1 + jh : jh;   // copy att + 1 of row jh
        if constexpr (!DUP) {
          // the stolen call leaves its node's queue
          for (int q = 0; q < pln; ++q)
            if (lane * pln + q == old) n_qn[q] -= 1;
        }
      }
    } else if (ev == 2) {
      // -- completion: free the slot and its node, feed the node's ring
      int ce = INT_MAX;
#pragma unroll
      for (int q = pls - 1; q >= 0; --q)
        if (order_key64(s_fin[q]) == nx_key) ce = lane * pls + q;
      const int kflat = __reduce_min_sync(FULL, ce);
      const int j_done = lane_get(s_row, pls, kflat);
      const int jr = rw(j_done);
      const int kn = kflat / NS;
      double v = HET ? lane_get(s_v, pls, kflat) : R.p(jr);
      if constexpr (HET && STREAM) v = __ddiv_rn(R.p(jr), v);
#pragma unroll
      for (int q = 0; q < pls; ++q)
        if (lane * pls + q == kflat) s_fin[q] = inf;
      for (int q = 0; q < pln; ++q)
        if (lane * pln + q == kn) n_busy[q] -= 1;
      find_completion();
      const int f_done = R.fn(jr);
      int evict = 0;
      if (lane == 0) {
        const int ec = kn * F + f_done;
        const int rl = e_rlen[ec], pos = e_rpos[ec];
        const bool full = rl == W;
        double* const rg = ring + static_cast<size_t>(ec) * W;
        e_rsum[ec] = __dsub_rn(__dadd_rn(e_rsum[ec], v), full ? rg[pos] : 0.0);
        rg[pos] = v;
        e_rlen[ec] = full ? rl : rl + 1;
        e_rpos[ec] = pos + 1 == W ? 0 : pos + 1;
        if constexpr (CTL) {
          // the controller's ring logs the raw p
          const double pr = R.p(jr);
          const int cl = c_rlen[f_done], cp = c_rpos[f_done];
          const bool cfull = cl == W;
          double* const cg = cring + static_cast<size_t>(f_done) * W;
          c_rsum[f_done] = __dsub_rn(__dadd_rn(c_rsum[f_done], pr),
                                     cfull ? cg[cp] : 0.0);
          cg[cp] = pr;
          c_rlen[f_done] = cfull ? cl : cl + 1;
          c_rpos[f_done] = cp + 1 == W ? 0 : cp + 1;
        }
        if constexpr (COLD) {
          // release: the container returns to its node's free pool of
          // the function, or is evicted when the pool holds `cores`
          int& c = fcnt[ec];
          evict = c >= cores;
          if (!evict) c += 1;
        }
      }
      if constexpr (COLD) nevt += __shfl_sync(FULL, evict, 0);
      if constexpr (DYN || (HEDGE && !DUP) || RES) ndone += 1;
      if constexpr (RES) {
        // the completion clears its call's deadline
        if ((jr & 31) == lane) h_t[jr] = inf;
        deadline_set(jr, inf);
      }
      if constexpr (DUP) {
        // the first completion among a call's copies is the call's: its
        // start, finish and node; it clears the watch, and a copy's win
        // counts as a steal
        double sq = 0.0;
        if ((j_done & 31) == lane) sq = start_q[j_done];
        sq = __shfl_sync(FULL, sq, j_done & 31);
        int take = 0;
        if ((jr & 31) == lane) {
          const int w = hst[jr];
          take = !(w & kDone0);
          if (take) {
            hst[jr] = w | kDone0 | (j_done >= n1 ? kStolen : 0);
            o_start[jr] = sq;
            o_finish[jr] = now;
            o_node[jr] = kn;
            h_t[jr] = inf;
          }
        }
        take = __shfl_sync(FULL, take, jr & 31);
        if (take) {
          ndone += 1;
          deadline_set(jr, inf);
        }
      }
      k_d = kn;
    } else if (ev == 0) {
      // -- kill: the node's running and queued calls re-arrive after the
      // detection delay, ranked; its slots and queue are emptied
      const int kk = kill_k;
      const double back = __dadd_rn(now, detect);
      int lost = 0;
#pragma unroll
      for (int q = 0; q < pls; ++q) {
        const int e = lane * pls + q;
        if (e < NSL && e / NS == kk) {
          if (s_fin[q] != inf) {
            const int r = s_row[q];
            r_rearr[r] = back;
            r_rord[r] = s_dseq[q];
            if constexpr (HEDGE) {
              // an attempt more, no steal; lost running: never hedged
              // again
              hst[r] = ((hst[r] + (1 << kAttShift)) & ~kStolen) | kUnhedge;
              h_t[r] = inf;
              h_t2[r] = inf;
            }
            ++lost;
          }
          s_fin[q] = inf;
        }
      }
      int i = (lo & ~31) + lane;
      if (i < lo) i += 32;
      for (; i < hi; i += 32) {
        if (q_node[i] == kk) {
          q_node[i] = -1;
          r_rearr[i] = back;
          r_rord[i] = kRordQ;
          if constexpr (HEDGE) {
            // an attempt more, no steal; the deadlines after the outage
            // stay, in order
            hst[i] = (hst[i] + (1 << kAttShift)) & ~kStolen;
            const double d1 = h_t[i] > back ? h_t[i] : inf;
            const double d2 = h_t2[i] > back ? h_t2[i] : inf;
            h_t[i] = fmin(d1, d2);
            h_t2[i] = fmax(d1, d2);
          }
          ++lost;
        }
      }
      lost = __reduce_add_sync(FULL, lost);
      for (int q = 0; q < pln; ++q) {
        if (lane * pln + q == kk) {
          n_busy[q] = 0;
          n_qn[q] = 0;
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
      if constexpr (HEDGE) find_deadline();
    } else if (ev == 5) {
      // -- autoscaler tick: provision one node while the queue per live
      // slot is above the threshold (both counts as float32, as the oracle)
      const bool alldone = ndone >= nreq;
      int alive = 0;
      for (int q = 0; q < pln; ++q)
        alive += active_node(q, lane * pln + q, now) ? 1 : 0;
      alive = __reduce_add_sync(FULL, alive);
      const int queued = queued_all();
      const bool fire =
          !alldone && prov < maxn &&
          static_cast<double>(static_cast<float>(queued)) >
              __dmul_rn(thr, static_cast<double>(
                                 static_cast<float>(max(alive * cores, 1))));
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
      // -- re-arrival: among the rows due now, the least rank (ex-running
      // calls in launch order), then the least (priority key, row)
      __syncwarp();
      int rk = INT_MAX, rr = INT_MAX, qr = INT_MAX, qs = INT_MAX;
      unsigned long long qk = NO_KEY64;
      for (int i = lane; i < n1; i += 32) {
        if (r_rearr[i] == re_min) {
          const int o = r_rord[i];
          if (o < kRordQ) {
            if (o < rk) { rk = o; rr = i; }
          } else if (q_key[i] < qk ||
                     (HEDGE && q_key[i] == qk && qseq[i] < qs)) {
            // under HEDGE equal keys go by push sequence
            qk = q_key[i];
            qr = i;
            if constexpr (HEDGE) qs = qseq[i];
          }
        }
      }
      const int rmin = __reduce_min_sync(FULL, rk);
      if (rmin != INT_MAX) {
        ins = __reduce_min_sync(FULL, rk == rmin ? rr : INT_MAX);
      } else if constexpr (HEDGE) {
        const unsigned long long m = warp_min64(qk);
        const int sm = __reduce_min_sync(FULL, qk == m ? qs : INT_MAX);
        ins = __reduce_min_sync(FULL, qk == m && qs == sm ? qr : INT_MAX);
      } else {
        warp_argmin64(qk, qr, &ins);
      }
      if ((ins & 31) == lane) r_rearr[ins] = inf;
      n_re -= 1;
      if (n_re > 0) find_rearr(); else re_min = inf;
    } else if (RES && ev == 7) {
      // -- the earliest timeout fires: its call leaves its node's queue,
      // or frees its slot mid-run and the node dispatches; then it
      // re-arrives after its backoff, or fails
      const int jt = h_row;
      int old = -1, word = 0;
      double e_jt = 0.0;
      if ((jt & 31) == lane) {
        old = q_node[jt];
        word = hst[jt];
        e_jt = r_eps[jt];
        h_t[jt] = inf;
        q_node[jt] = -1;
      }
      old = __shfl_sync(FULL, old, jt & 31);
      word = __shfl_sync(FULL, word, jt & 31);
      e_jt = __shfl_sync(FULL, e_jt, jt & 31);
      find_deadline();
      if (old >= 0) {
        // queued: off its node's queue, its E[p] off the gauge
        for (int q = 0; q < pln; ++q)
          if (lane * pln + q == old) n_qn[q] -= 1;
        qep = __dsub_rn(qep, e_jt);
        if (jt == lo) advance_lo();
      } else {
        // running: its slot's owner frees it, the seconds run are wasted
        int se = INT_MAX;
#pragma unroll
        for (int q = pls - 1; q >= 0; --q)
          if (lane * pls + q < NSL && s_row[q] == jt && s_fin[q] != inf)
            se = lane * pls + q;
        se = __reduce_min_sync(FULL, se);
        if (se != INT_MAX) {
          const double s0 = lane_get(s_v, pls, se);
#pragma unroll
          for (int q = 0; q < pls; ++q)
            if (lane * pls + q == se) s_fin[q] = inf;
          const int rn = se / NS;
          for (int q = 0; q < pln; ++q)
            if (lane * pln + q == rn) n_busy[q] -= 1;
          wst = __dadd_rn(wst, fmax(__dsub_rn(now, s0), 0.0));
          find_completion();
          k_d = rn;
        }
      }
      nto += 1;
      // retry or fail: the submissions counted are the failed attempt's
      // number
      const int att = word >> kAttShift;
      if (on_to && att < maxa) {
        const double back = __dadd_rn(now, retry_delay(jt, att));
        if ((jt & 31) == lane) h_t2[jt] = back;
        retry_set(jt, back);
        nrt += 1;
      } else {
        if ((jt & 31) == lane) hst[jt] = (word & ~kCause) | kFailed | 1;
        ndone += 1;
      }
    } else if (RES && ev == 8) {
      // -- the earliest retry re-arrives, through the arrival's path
      ins = rt_row;
      if ((ins & 31) == lane) h_t2[ins] = inf;
      find_retry();
    } else {
      k_d = act_k;               // ev 4: the activation's node
    }

    if (RES && ins >= 0) {
      // -- admission: count the submission, then shed it when the gauge
      // over the fleet's free slots exceeds the threshold (no node sees
      // it), else add the controller's E[p] to the gauge and arm its
      // deadline
      const int i = ins;
      int word = 0;
      if ((i & 31) == lane) {
        word = hst[i] + (1 << kAttShift);
        hst[i] = word;
      }
      word = __shfl_sync(FULL, word, i & 31);
      const int att = word >> kAttShift;
      double est_z = 0.0;
      if (lane == 0) {
        const int f = R.fn(i), cl = c_rlen[f];
        est_z = cl > 0 ? __ddiv_rn(c_rsum[f], static_cast<double>(cl)) : 0.0;
      }
      est_z = __shfl_sync(FULL, est_z, 0);
      int free_n = 0;
      for (int q = 0; q < pln; ++q) {
        const int e = lane * pln + q;
        if (e < NN && e < nodes) free_n += cores - n_busy[q];
      }
      free_n = __reduce_add_sync(FULL, free_n);
      if (adm_on &&
          __ddiv_rn(qep, static_cast<double>(max(free_n, 1))) > adm_thr) {
        nsh += 1;
        if (on_sh && att < maxa) {
          const double back = __dadd_rn(now, retry_delay(i, att));
          if ((i & 31) == lane) h_t2[i] = back;
          retry_set(i, back);
          nrt += 1;
        } else {
          if ((i & 31) == lane) hst[i] = (word & ~kCause) | kFailed | 2;
          ndone += 1;
        }
        if (ev == 1) {
          ++ai;
          hi = max(hi, ai);
          t_a = ai <= n ? R.t(ai) : inf;
        }
        ins = -1;
      } else {
        qep = __dadd_rn(qep, est_z);
        const double dl =
            to_abs > 0.0
                ? __dadd_rn(now, to_abs)
                : __dadd_rn(now, __dmul_rn(to_mult, fmax(est_z, to_floor)));
        if ((i & 31) == lane) {
          r_eps[i] = est_z;
          if (to_on) h_t[i] = dl;
        }
        if (to_on) deadline_set(i, dl);
      }
    }

    if (ins >= 0) {
      // -- arrival, re-arrival, steal or copy: route (a steal or copy
      // has its node), observe on the routed node (lane 0), log the FC
      // ring and count its window (the warp), freeze the priority
      const int i = ins, ir = rw(i), f = R.fn(ir);
      int k_arr;
      if (HEDGE && k_to >= 0) {
        k_arr = k_to;
      } else if (!DYN && route == 1) {
        // the first node with a free slot on the walk from home
        const int h0 = __ldg(a.home0 + row + ir);
        const int m = max(nodes, 1);
        int wb = INT_MAX;
        for (int q = 0; q < pln; ++q) {
          const int e = lane * pln + q;
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
        // least busy + queued over the active nodes, first on ties
        int lb = INT_MAX, eb = INT_MAX;
        for (int q = 0; q < pln; ++q) {
          const int e = lane * pln + q;
          if (e < NN) {
            const int ld =
                active_node(q, e, now) ? n_busy[q] + n_qn[q] : (1 << 30);
            if (ld < lb) { lb = ld; eb = e; }
          }
        }
        const int lmin = __reduce_min_sync(FULL, lb);
        k_arr = __reduce_min_sync(FULL, lb == lmin ? eb : INT_MAX);
      }
      const int ei = k_arr * F + f;
      int pf = 0;
      double prev_used = now, est = 0.0;
      if (lane == 0) {
        const int narr0 = e_narr[ei];
        prev_used = narr0 == 0 ? now : e_last[ei];
        const int rl = e_rlen[ei];
        est = rl > 0 ? __ddiv_rn(e_rsum[ei], static_cast<double>(rl)) : 0.0;
        pf = e_fcp[ei];
        e_prev[ei] = prev_used;
        e_last[ei] = now;
        e_narr[ei] = narr0 + 1;
        if (FCP) e_fcp[ei] = pf + 1 == RF ? 0 : pf + 1;
      }
      double cnt_i;
      if (FCP) {
        pf = __shfl_sync(FULL, pf, 0);
        double* const fr = fcr + static_cast<size_t>(ei) * RF;
        const double lim = __dsub_rn(now, horizon);
        int c = 0;
        for (int r = lane; r < RF; r += 32) {
          const double x = r == pf ? now : fr[r];
          c += x > lim ? 1 : 0;
        }
        if (pf % 32 == lane) fr[pf] = now;
        cnt_i = static_cast<double>(__reduce_add_sync(FULL, c));
      } else {
        cnt_i = __ldg(a.cnt + row + ir);
      }
      const double w = __dadd_rn(c2, __dmul_rn(c3, cnt_i));
      double prio = __dadd_rn(__dadd_rn(__dmul_rn(c0, now),
                                        __dmul_rn(c1, prev_used)),
                              __dmul_rn(w, est));
      prio = __shfl_sync(FULL, prio, 0);
      if ((i & 31) == lane) {
        q_key[i] = order_key64(prio);
        q_node[i] = k_arr;
        if (!DUP || i < n1) o_prio[i] = prio;
        if (!DUP) o_node[i] = k_arr;
        if constexpr (CTL) qseq[i] = stepc;
      }
      for (int q = 0; q < pln; ++q)
        if (lane * pln + q == k_arr) n_qn[q] += 1;
      if constexpr (HEDGE) {
        // (re-)arm the call's watch from the controller's estimate
        double arm = 0.0;
        if (lane == 0) {
          const int cl = c_rlen[f];
          const double est_h =
              cl > 0 ? __ddiv_rn(c_rsum[f], static_cast<double>(cl)) : 0.0;
          arm = __dadd_rn(now, __dmul_rn(hmult, fmax(est_h, hfloor)));
        }
        arm = __shfl_sync(FULL, arm, 0);
        double dl = arm;
        if ((ir & 31) == lane) {
          if constexpr (DYN) {
            // merged into the sorted pair: a re-arrival may find its
            // pre-kill deadline still pending
            const double lo1 = fmin(h_t[ir], h_t2[ir]);
            const double hi1 = fmax(h_t[ir], h_t2[ir]);
            h_t[ir] = fmin(lo1, arm);
            h_t2[ir] = fmin(hi1, fmax(lo1, arm));
          } else {
            h_t[ir] = arm;
          }
          dl = h_t[ir];
          if (h_from >= 0) {
            // a backup: one attempt more (a steal is marked)
            hst[ir] = (hst[ir] + (1 << kAttShift)) | (DUP ? 0 : kStolen);
          }
        }
        dl = __shfl_sync(FULL, dl, ir & 31);
        deadline_set(ir, dl);
        if (h_from >= 0) nbk += 1;
      }
      lo = min(lo, i);
      if constexpr (DUP) hi = max(hi, i + 1);   // a copy past the rows
      if (ev == 1) {
        ++ai;
        hi = max(hi, ai);
        t_a = ai <= n ? R.t(ai) : inf;
      }
      k_d = k_arr;
    }

    // -- dispatch on the node the event touched, when it is active, has a
    // free slot below cores and a call queued: the least frozen priority,
    // then (HEDGE, RES) the least push sequence, then the least entry
    bool can = false;
    if (k_d >= 0 && k_d < NN) {
      bool ok = lane_get(n_busy, pln, k_d) < cores &&
                !(counted && lane_get(n_qn, pln, k_d) <= 0);
      if constexpr (DYN)
        ok = ok && lane_get(n_act, pln, k_d) <= now &&
             !lane_get(n_dead, pln, k_d);
      unsigned long long kmin = NO_KEY64;
      int j = INT_MAX;
      if (ok) {
        unsigned long long bk = NO_KEY64;
        int bj = INT_MAX, bs = INT_MAX;
        int i = (lo & ~31) + lane;
        if (i < lo) i += 32;
        for (; i < hi; i += 32) {
          if (q_node[i] == k_d) {
            const unsigned long long k = q_key[i];
            if constexpr (CTL) {
              const int sq = qseq[i];
              if (k < bk || (k == bk && sq < bs)) { bk = k; bj = i; bs = sq; }
            } else {
              if (k < bk) { bk = k; bj = i; }
            }
          }
        }
        if constexpr (CTL) {
          kmin = warp_min64(bk);
          const int sm = __reduce_min_sync(FULL, bk == kmin ? bs : INT_MAX);
          j = __reduce_min_sync(FULL, bk == kmin && bs == sm ? bj : INT_MAX);
        } else {
          kmin = warp_argmin64(bk, bj, &j);
        }
      }
      can = ok && kmin < KEY64_INF;
      if (can) {
        const double chan_kd = lane_get(n_chan, pln, k_d);
        const int jr = rw(j);
        const int f_j = R.fn(jr);
        double cost_j = R.cost(jr), p_j = R.p(jr), v_j = p_j;
        if constexpr (COLD) {
          // acquire: a free container of the node and function is a warm
          // hit, else a prewarmed one starts cold
          int hit = 0;
          if (lane == 0) {
            int& c = fcnt[k_d * F + f_j];
            hit = c > 0;
            if (hit) c -= 1;
            // the flag is the original's own dispatch's
            if (!DUP || j < n1) o_coldq[j] = !hit;
          }
          hit = __shfl_sync(FULL, hit, 0);
          cost_j = __dadd_rn(cost_j, hit ? 0.0 : kPrewarmExtra);
          ncold += !hit;
        }
        if constexpr (HET) {
          // the node's speed at dispatch divides cost and runtime, as
          // (x * slowdown) / speed; the slot keeps p / (speed / slowdown),
          // or under STREAM speed / slowdown itself
          double slow = 1.0;
          for (int ep = 0; ep < D.n_ep; ++ep)
            if (__ldg(epn + ep) == k_d && __ldg(ept0 + ep) <= now &&
                now < __ldg(ept1 + ep))
              slow = __dmul_rn(slow, __ldg(epf + ep));
          const double spd_k = lane_get(n_spd, pln, k_d);
          const double eff = __ddiv_rn(spd_k, slow);
          v_j = STREAM ? eff : __ddiv_rn(p_j, eff);
          cost_j = __ddiv_rn(__dmul_rn(cost_j, slow), spd_k);
          p_j = __ddiv_rn(__dmul_rn(p_j, slow), spd_k);
        }
        const double exec_start = __dadd_rn(fmax(now, chan_kd), cost_j);
        const double fin_j = __dadd_rn(exec_start, p_j);
        // ... into its first free slot below cores (slot 0 if none)
        int se = INT_MAX;
#pragma unroll
        for (int q = pls - 1; q >= 0; --q) {
          const int e = lane * pls + q;
          if (e < NSL && e / NS == k_d && e % NS < cores && s_fin[q] == inf)
            se = e;
        }
        se = __reduce_min_sync(FULL, se);
        const bool none_free = se == INT_MAX;
        if (none_free) se = k_d * NS;
#pragma unroll
        for (int q = 0; q < pls; ++q) {
          if (lane * pls + q == se) {
            s_fin[q] = fin_j;
            s_row[q] = j;
            s_v[q] = RES ? exec_start : v_j;
            s_dseq[q] = dcnt;
          }
        }
        for (int q = 0; q < pln; ++q) {
          if (lane * pln + q == k_d) {
            n_chan[q] = exec_start;
            n_busy[q] += 1;
            n_qn[q] -= 1;
          }
        }
        if constexpr (DYN) ++dcnt;
        double e_j = 0.0;
        if ((j & 31) == lane) {
          q_node[j] = -1;
          if constexpr (RES) e_j = r_eps[j];
          if constexpr (DUP) {
            start_q[j] = exec_start;
          } else {
            o_start[j] = exec_start;
            o_finish[j] = fin_j;
          }
          if (HEDGE && j < n1) {
            // a dispatched original's watch can never act again (a
            // copy's dispatch leaves it live)
            h_t[j] = inf;
            if constexpr (DYN) h_t2[j] = inf;
          }
        }
        if (HEDGE && j < n1) deadline_set(j, inf);
        // RES: the call's E[p] leaves the gauge
        if constexpr (RES) qep = __dsub_rn(qep, __shfl_sync(FULL, e_j, j & 31));
        if (none_free) {
          find_completion();
        } else {
          const unsigned long long kj = order_key64(fin_j);
          if (kj < nx_key) { nx_key = kj; nx_t = fin_j; }
        }
        if (j == lo) advance_lo();
      }
    }
    if constexpr (DYN) {
      if (ev == 4) {
        // the activation stays pending while its node can take more
        const bool still = can && queued_all() > 0 &&
                           lane_get(n_busy, pln, act_k) < cores;
        if (!still) {
          for (int q = 0; q < pln; ++q)
            if (lane * pln + q == act_k) n_pend[q] = 0;
          find_node(false);
        }
      }
    }
    if constexpr (CTL) ++stepc;
  }

  if (COLD && lane == 0) {
    a.cold_out[static_cast<size_t>(b) * 2] = ncold;
    a.cold_out[static_cast<size_t>(b) * 2 + 1] = nevt;
  }
  if constexpr (DYN) {
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
  if constexpr (RES) {
    for (int i = lane; i < n1; i += 32) {
      const int w = hst[i];
      r.nfl_out[row + i] = (w & kFailed) ? 1 : 0;
      r.fcz_out[row + i] = w & kCause;
      r.ratt_out[row + i] = w >> kAttShift;
    }
    if (lane == 0) {
      int* const rs = r.rsum + static_cast<size_t>(b) * 5;
      rs[0] = nto;
      rs[1] = nsh;
      rs[2] = nrt;
      rs[3] = ndone;
      rs[4] = stepc;
      r.wst_out[b] = wst;
    }
  }
  if constexpr (HEDGE) {
    int stolen = 0;
    for (int i = lane; i < n1; i += 32) {
      h.att_out[row + i] = hst[i] >> kAttShift;
      stolen += hst[i] & kStolen ? 1 : 0;
    }
    stolen = __reduce_add_sync(FULL, stolen);
    if (lane == 0) {
      int* const hsum = h.hsum + static_cast<size_t>(b) * 4;
      hsum[0] = nbk;
      hsum[1] = stolen;
      hsum[2] = ndone;
      hsum[3] = stepc;
    }
  }

  if constexpr (STREAM) {
    // -- the final carry, every entry at the offset it was read from (the
    // per-row arrays by their rows' lanes, after the warp's writes; on the
    // wide path the per-(node, function) arrays are there already)
    __syncwarp();
    if (lane == 0) {
      io[L.ai] = ai;
      if constexpr (COLD) {
        io[L.ncold] = ncold;
        io[L.nevt] = nevt;
      }
      if constexpr (DYN) {
        io[L.nfail] = nfail;
        io[L.prov] = prov;
        io[L.dcnt] = dcnt;
        co[L.next_tick] = next_tick;
      }
      if constexpr (DYN || HEDGE) io[L.ndone] = ndone;
      if constexpr (HEDGE) {
        io[L.nbk] = nbk;
        io[L.stepc] = stepc0 + D.n_steps;
      }
      if constexpr (RES) {
        io[L.nto] = nto;
        io[L.nsh] = nsh;
        io[L.nrt] = nrt;
        io[L.ndn] = ndone;
        io[L.stp] = stepc0 + D.n_steps;
        co[L.qep] = qep;
        co[L.wst] = wst;
      }
    }
#pragma unroll
    for (int q = 0; q < pls; ++q) {
      const int e = lane * pls + q;
      if (e < NSL) {
        co[L.fin_s + e] = s_fin[q];
        io[L.idx_s + e] = s_row[q];
        if constexpr (HET) co[L.sspd + e] = s_v[q];
        if constexpr (RES) co[L.sst + e] = s_v[q];
        if constexpr (DYN) io[L.dseq + e] = s_dseq[q];
      }
    }
    for (int q = 0; q < pln; ++q) {
      const int e = lane * pln + q;
      if (e < NN) {
        io[L.busy + e] = n_busy[q];
        io[L.qn + e] = n_qn[q];
        co[L.chan + e] = n_chan[q];
        if constexpr (DYN) {
          co[L.act_t + e] = n_act[q];
          co[L.killq + e] = n_kill[q];
          io[L.dead + e] = n_dead[q];
          io[L.act_pend + e] = n_pend[q];
        }
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
        if (FCP) io[L.fcp + i] = e_fcp[i];
        if constexpr (COLD) io[L.freec + i] = fcnt[i];
      }
      for (int i = lane; i < E * W; i += 32) co[L.ring + i] = ring[i];
      if (FCP)
        for (int i = lane; i < E * RF; i += 32) co[L.fcr + i] = fcr[i];
    }
    if constexpr (CTL) {
      const int Ls = HEDGE ? L.crsum : L.zrsum, Ll = HEDGE ? L.crlen : L.zrlen;
      const int Lp = HEDGE ? L.crpos : L.zrpos, Lr = HEDGE ? L.cring : L.zring;
      for (int i = lane; i < F; i += 32) {
        co[Ls + i] = c_rsum[i];
        io[Ll + i] = c_rlen[i];
        io[Lp + i] = c_rpos[i];
      }
      for (int i = lane; i < F * W; i += 32) co[Lr + i] = cring[i];
    }
    for (int i = lane; i < n1; i += 32) {
      co[L.fprio + i] = o_prio[i];
      io[L.node_of + i] = o_node[i];
      io[L.pend + i] = q_node[i] >= 0 ? 1 : 0;
      if constexpr (COLD) io[L.coldq + i] = o_coldq[i];
      if constexpr (DYN) {
        co[L.rearr + i] = r_rearr[i];
        io[L.rord + i] = r_rord[i];
      }
      if constexpr (HEDGE) {
        const int w = hst[i];
        co[L.hedge_t + i] = h_t[i];
        io[L.att + i] = w >> kAttShift;
        io[L.stolen + i] = (w & kStolen) ? 1 : 0;
        io[L.qseq + i] = qseq[i];
        if constexpr (DYN) {
          co[L.hedge_t2 + i] = h_t2[i];
          io[L.unhedge + i] = (w & kUnhedge) ? 1 : 0;
        }
      }
      if constexpr (RES) {
        const int w = hst[i];
        co[L.to_t + i] = h_t[i];
        co[L.rto + i] = h_t2[i];
        co[L.eps + i] = r_eps[i];
        io[L.ratt + i] = w >> kAttShift;
        io[L.nfl + i] = (w & kFailed) ? 1 : 0;
        io[L.fcz + i] = w & kCause;
        io[L.qsq + i] = qseq[i];
      }
    }
  }
}

template <int PL, bool COLD, bool HET, bool DYN, bool HEDGE = false,
          bool DUP = false, bool RES = false, bool STREAM = false>
int launch_f64(const F64Args& a, const H64Args& h, const R64Args& r,
               const S64Args& s, const F64Layout& L, const F64Dims& D,
               int cell, float horizon, cudaStream_t stream, int pl,
               int words) {
  auto kernel = freeze64_kernel<PL, COLD, HET, DYN, HEDGE, DUP, RES, STREAM>;
  int cpb = 0, blocks = 0;
  const int e = block_shape(kernel, D.B, cell, &cpb, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, 32 * cpb, static_cast<size_t>(cpb) * cell, stream>>>(
      a, h, r, s, L, D, cpb, cell, horizon, pl, words);
  return static_cast<int>(cudaGetLastError());
}

// One set's launch at `pl` slots a lane (1 or 2 in shared memory, 0 the
// wide path): each translation unit passes its own instantiations.
using F64Launch = int (*)(int pl_sel, const F64Args&, const H64Args&,
                          const R64Args&, const S64Args&, const F64Layout&,
                          const F64Dims&, int cell, float horizon,
                          cudaStream_t, int pl, int words);

// The sets a translation unit compiles: without hedging or resilience (at
// least one of cold / het / dyn; csrc/event_step.cu), hedged (steal or
// duplicate), the resilience set, or the stream sets (every set but the
// duplicate ones, on the wide path alone).
enum class F64Sets { kPlain, kHedged, kRes, kStream };

// Checks a bucket's launch arguments and plan, then launches it through
// `launch_set`; `sets` says which sets the caller compiled.
inline int f64_launch_checked(const F64Args& a, const H64Args& h,
                              const R64Args& r, const S64Args& s,
                              const int* layout, const int* dims,
                              const int* plan, float horizon, void* stream,
                              F64Sets sets, F64Launch launch_set) {
  F64Layout L;
  F64Dims D;
  int P[kF64Plan];
  static_assert(sizeof(F64Layout) == kF64Layout * sizeof(int),
                "layout size");
  static_assert(sizeof(F64Dims) == kF64Dims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  std::memcpy(P, plan, sizeof(P));
  if (D.B == 0) return static_cast<int>(cudaSuccess);
  const int pl = P[0];
  const bool staged = P[1] != 0, wide = P[2] != 0;
  const int cell = P[3], words = P[4];
  const int n1 = D.n + 1, NSL = D.n_nodes * D.n_slots;
  const int E = D.n_nodes * D.n_fns;
  const int pln = (D.n_nodes + 31) / 32;
  const bool dyn = D.dyn != 0, het = D.het != 0, cold = D.cold != 0;
  const bool hedge = D.hedge != 0, dup = D.dup != 0, res = D.res != 0;
  const int nfree = cold ? E : 0;
  const HShape hs{D.n_fns, hedge, hedge && dyn, dup,
                  dup ? D.n_copies * n1 : n1, res};
  const auto cs = static_cast<cudaStream_t>(stream);
  const bool streamed = sets == F64Sets::kStream;
  if ((!streamed && (hedge != (sets == F64Sets::kHedged) ||
                     res != (sets == F64Sets::kRes))) ||
      (sets == F64Sets::kPlain && !(dyn || het || cold)) ||
      (streamed && (dup || !wide || s.t_stop == nullptr ||
                    s.clk_out == nullptr || s.ctr_out == nullptr ||
                    (res && s.gseq == nullptr))) ||
      (res && (dyn || het || cold || hedge)) ||
      (dup && (!hedge || dyn || D.n_copies < 1)) ||
      (!dup && D.n_copies != 1) || pl < 1 || 32 * pl < NSL ||
      D.fc_ring < 1 || D.ncoef < 4 || wide == staged ||
      (!wide && (D.n_nodes > 32 || D.n_fns > 256)) ||
      words != f64_scratch_words(wide, pl, pln, n1, E, D.window, nfree, dyn,
                                 D.fc_push != 0, D.fc_ring, hs, streamed) ||
      (words % 2 != 0) || (words > 0 && a.scratch == nullptr) ||
      (dyn && (a.dynp == nullptr || a.maxn == nullptr || a.nreq == nullptr ||
               a.summ == nullptr || a.act_out == nullptr ||
               a.dead_out == nullptr)) ||
      (het && (a.spd == nullptr || a.epn == nullptr || a.ept0 == nullptr ||
               a.ept1 == nullptr || a.epf == nullptr || D.n_ep < 1)) ||
      (cold && (a.cold_out == nullptr || a.coldq_out == nullptr)) ||
      (hedge && (h.hmult == nullptr || h.hfloor == nullptr ||
                 h.hmax == nullptr || h.hsum == nullptr ||
                 h.att_out == nullptr)) ||
      (res && (r.rto_p == nullptr || r.rrt_p == nullptr ||
               r.adm_p == nullptr || r.rsum == nullptr ||
               r.wst_out == nullptr || r.nfl_out == nullptr ||
               r.fcz_out == nullptr || r.ratt_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    if (cell != 0) return static_cast<int>(cudaErrorInvalidValue);
    return launch_set(0, a, h, r, s, L, D, 0, horizon, cs, pl, words);
  }
  if (cell != f64_cell_bytes(true, n1, E, D.window, nfree, hs) ||
      (pl != 1 && pl != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_set(pl, a, h, r, s, L, D, cell, horizon, cs, pl, words);
}

// The hedged sets of one mode at `PL` slots a lane: steal mode (!DUP) with
// or without cold starts, node speeds and capacity dynamics; duplicate mode
// (DUP) with or without cold starts and node speeds.  A translation unit
// that calls it compiles that mode's sets alone.
template <int PL, bool DUP>
int launch_hedged_pl(const F64Args& a, const H64Args& h, const R64Args& r,
                     const S64Args& s, const F64Layout& L, const F64Dims& D,
                     int cell, float horizon, cudaStream_t stream, int pl,
                     int words) {
  const int m = (D.cold ? 1 : 0) | (D.het ? 2 : 0) | (D.dyn ? 4 : 0);
#define SET(M, C, H, Y)                                                     \
  case M:                                                                   \
    return launch_f64<PL, C, H, Y, true, DUP>(a, h, r, s, L, D, cell,       \
                                              horizon, stream, pl, words);
  switch (m) {
    SET(0, false, false, false)
    SET(1, true, false, false)
    SET(2, false, true, false)
    SET(3, true, true, false)
    default: break;
  }
  if constexpr (!DUP) {
    switch (m) {
      SET(4, false, false, true)
      SET(5, true, false, true)
      SET(6, false, true, true)
      SET(7, true, true, true)
      default: break;
    }
  }
#undef SET
  return static_cast<int>(cudaErrorInvalidValue);
}

// The hedged sets of one mode (DUP false: steal, true: duplicate) or (RES)
// the resilience set, at `pl_sel` slots a lane (0: the wide path).
template <bool DUP, bool RES>
int launch_f64_family(int pl_sel, const F64Args& a, const H64Args& h,
                      const R64Args& r, const S64Args& s, const F64Layout& L,
                      const F64Dims& D, int cell, float horizon,
                      cudaStream_t stream, int pl, int words) {
  if ((D.dup != 0) != DUP) return static_cast<int>(cudaErrorInvalidValue);
  switch (pl_sel) {
#define PL_CASE(P)                                                          \
  case P:                                                                   \
    if constexpr (RES)                                                      \
      return launch_f64<P, false, false, false, false, false, true>(        \
          a, h, r, s, L, D, cell, horizon, stream, pl, words);              \
    else                                                                    \
      return launch_hedged_pl<P, DUP>(a, h, r, s, L, D, cell, horizon,      \
                                      stream, pl, words);
    PL_CASE(0)
    PL_CASE(1)
    PL_CASE(2)
#undef PL_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Defines `extern "C" int NAME(...)`, the launcher of one family of sets
// compiled in its own source: the hedged sets of one mode (RES false; DUP
// false: steal, true: duplicate) or (RES true) the resilience set.  It
// launches the float64 frozen-priority scan of D.B cells on `stream`:
// event_step_freeze64_launch's arguments (csrc/event_step.cu), with the
// hedge inputs `hmult` / `hfloor` / `hmax` (B,) and outputs `hsum` (B, 4:
// backups, calls stolen or won by a copy, calls done, steps taken) and
// `att_out` (B, n + 1: each row's attempts), and the resilience inputs
// `rto_p` (B, 4) / `rrt_p` (B, 6) / `adm_p` (B, 2) and outputs `rsum` (B,
// 5: timeouts, sheds, retries, calls resolved, steps taken), `wst_out`
// (B: wasted seconds) and `nfl_out` / `fcz_out` / `ratt_out` (B, n + 1:
// each row's failure flag, cause and submissions), the family's own set
// (the other's null).  Returns cudaGetLastError() after the launch, or the
// error that stopped it.
#define EVENT_STEP_F64_FAMILY_LAUNCHER(NAME, DUP, RES)                      \
  extern "C" int NAME(                                                      \
      const double* clk, const int* ctr, const double* t, const int* fnid,  \
      const double* p, const double* cost, const double* coef,              \
      const int* cores, const int* nodes, const double* cnt,                \
      const int* home0, const int* route, const double* dynp,               \
      const int* maxn, const int* nreq, const double* spd, const int* epn,  \
      const double* ept0, const double* ept1, const double* epf,            \
      const double* hmult, const double* hfloor, const int* hmax,           \
      const double* rto_p, const double* rrt_p, const double* adm_p,        \
      double* start, double* finish, double* prio, int* node, int* summ,    \
      double* act_out, int* dead_out, int* cold_out, int* coldq_out,        \
      int* hsum, int* att_out, int* rsum, double* wst_out, int* nfl_out,    \
      int* fcz_out, int* ratt_out, int* scratch, const int* layout,         \
      const int* dims, const int* plan, float horizon, void* stream) {      \
    const F64Args a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, cnt,    \
                    home0, route, dynp, maxn, nreq, spd, epn, ept0, ept1,   \
                    epf, start, finish, prio, node, summ, act_out,          \
                    dead_out, cold_out, coldq_out,                          \
                    reinterpret_cast<uint32_t*>(scratch)};                  \
    const H64Args h{hmult, hfloor, hmax, hsum, att_out};                    \
    const R64Args r{rto_p, rrt_p, adm_p, rsum, wst_out, nfl_out, fcz_out,   \
                    ratt_out};                                              \
    const S64Args s{nullptr, nullptr, nullptr, nullptr};                    \
    return f64_launch_checked(a, h, r, s, layout, dims, plan, horizon,      \
                              stream,                                       \
                              RES ? F64Sets::kRes : F64Sets::kHedged,       \
                              launch_f64_family<DUP, RES>);                 \
  }
