// The chunked stream replay on the frozen-priority regime (push and
// single-node cells): the STREAM instantiations of the float32
// frozen-priority kernel (freeze_kernel, event_step_freeze.cuh) and of the
// float64 one (freeze64_kernel, event_step_freeze64.cuh), the stream branch
// of repro/core/fastpath.py::_scan_cell_kernel (l. 821) on push and
// single-node cells.  The plain PyTorch version is
// repro_torch/kernels/event_step.py::freeze_scan_ref with stream.  Its own
// translation unit, so that the whole-burst kernels of event_step.cu,
// event_step_hedge.cu and event_step_res.cu build beside it: the float32
// kernel's sets (slots a lane 1, 2, 4 or 8, staged or not, and the wide
// path) and the float64 kernel's sets that the JAX package streams (cold /
// het / dyn, each with or without steal-mode hedging, and the resilience
// set; no duplicate hedging), each on the wide path alone: a stream bucket
// is one cell, so its block shares no shared memory, and the 2-slot
// register path would double the source's build (110 s against 70 s for
// event_step.cu on an H100 host; ops.event_step_plan follows).
//
// What bounds it: the chain of one event a step, as for the whole-burst
// kernels; a stream bucket is one cell (one warp on one SM), so a chunk's
// time is its steps times the latency of one step, and a dispatch scans
// the queued rows of the chunk.  At the planet fleet's widths (128 nodes of
// one slot, 16,384 functions) the float64 kernel takes the wide path, its
// per-(node, function) estimators and rings (~200 MB) read and written in
// place in clk_out / ctr_out, the copies of the input planes that the
// wrapper makes; the scratch holds none of them.

#include "event_step_freeze.cuh"
#include "event_step_freeze64.cuh"

namespace {

// The stream sets on the wide path (PL = 0): cold / het / dyn (at least
// one) with or without steal hedging, hedging alone, and the resilience set
// alone.
template <int PL>
int launch_stream_pl(const F64Args& a, const H64Args& h, const R64Args& r,
                     const S64Args& s, const F64Layout& L, const F64Dims& D,
                     int cell, float horizon, cudaStream_t stream, int pl,
                     int words) {
  const int m = (D.cold ? 1 : 0) | (D.het ? 2 : 0) | (D.dyn ? 4 : 0);
  if (D.res) {
    if (m != 0 || D.hedge) return static_cast<int>(cudaErrorInvalidValue);
    return launch_f64<PL, false, false, false, false, false, true, true>(
        a, h, r, s, L, D, cell, horizon, stream, pl, words);
  }
#define SET(M, C, H, Y)                                                     \
  case M:                                                                   \
    return D.hedge ? launch_f64<PL, C, H, Y, true, false, false, true>(     \
                         a, h, r, s, L, D, cell, horizon, stream, pl,       \
                         words)                                             \
                   : launch_f64<PL, C, H, Y, false, false, false, true>(    \
                         a, h, r, s, L, D, cell, horizon, stream, pl,       \
                         words);
  switch (m) {
    case 0:
      if (!D.hedge) return static_cast<int>(cudaErrorInvalidValue);
      return launch_f64<PL, false, false, false, true, false, false, true>(
          a, h, r, s, L, D, cell, horizon, stream, pl, words);
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

int launch_stream_set(int pl_sel, const F64Args& a, const H64Args& h,
                      const R64Args& r, const S64Args& s, const F64Layout& L,
                      const F64Dims& D, int cell, float horizon,
                      cudaStream_t stream, int pl, int words) {
  if (pl_sel != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_stream_pl<0>(a, h, r, s, L, D, cell, horizon, stream, pl,
                             words);
}

}  // namespace

// Launches one chunk of the stream replay of D.B frozen-priority cells
// (float32) on `stream`: as event_step_freeze_launch, with each cell's
// horizon `t_stop` (B,) and the final carry planes written to `clk_out` /
// `ctr_out` (which the caller fills with copies of clk / ctr).  `plan` holds
// the kFPlan entries of ops.event_step_plan(..., freeze=True, stream=True).
extern "C" int event_step_freeze_stream_launch(
    const float* clk, const int* ctr, const float* t, const int* fnid,
    const float* p, const float* cost, const float* coef, const int* cores,
    const int* nodes, const float* cnt, const int* home0, const int* route,
    const float* t_stop, float* start, float* finish, float* prio, int* node,
    float* clk_out, int* ctr_out, int* scratch, const int* layout,
    const int* dims, const int* plan, float horizon, void* stream) {
  const FArgs a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, cnt, home0,
                route, start, finish, prio, node,
                reinterpret_cast<uint32_t*>(scratch)};
  return freeze_launch<true>(a, FStream{t_stop, clk_out, ctr_out}, layout,
                             dims, plan, horizon,
                             static_cast<cudaStream_t>(stream));
}

// Launches one chunk of the stream replay of D.B float64 frozen-priority
// cells (cold starts, node speeds, capacity dynamics, steal hedging or the
// request lifecycle) on `stream`: the arguments of the hedged and
// resilience launchers (EVENT_STEP_F64_FAMILY_LAUNCHER in
// event_step_freeze64.cuh; each family's null without it), with each
// cell's horizon `t_stop` (B,), each row's global arrival rank `gseq` (B,
// n + 1; with D.res, else null) and the final carry planes written to
// `clk_out` / `ctr_out` (copies of clk / ctr from the caller).  `plan`
// holds the kF64Plan entries of ops.event_step_plan(..., freeze=True,
// f64=True, stream=True).
extern "C" int event_step_freeze64_stream_launch(
    const double* clk, const int* ctr, const double* t, const int* fnid,
    const double* p, const double* cost, const double* coef,
    const int* cores, const int* nodes, const double* cnt, const int* home0,
    const int* route, const double* dynp, const int* maxn, const int* nreq,
    const double* spd, const int* epn, const double* ept0,
    const double* ept1, const double* epf, const double* hmult,
    const double* hfloor, const int* hmax, const double* rto_p,
    const double* rrt_p, const double* adm_p, const double* t_stop,
    const int* gseq, double* start, double* finish, double* prio, int* node,
    int* summ, double* act_out, int* dead_out, int* cold_out, int* coldq_out,
    int* hsum, int* att_out, int* rsum, double* wst_out, int* nfl_out,
    int* fcz_out, int* ratt_out, double* clk_out, int* ctr_out, int* scratch,
    const int* layout, const int* dims, const int* plan, float horizon,
    void* stream) {
  const F64Args a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, cnt,
                  home0, route, dynp, maxn, nreq, spd, epn, ept0, ept1, epf,
                  start, finish, prio, node, summ, act_out, dead_out,
                  cold_out, coldq_out, reinterpret_cast<uint32_t*>(scratch)};
  const H64Args h{hmult, hfloor, hmax, hsum, att_out};
  const R64Args r{rto_p, rrt_p, adm_p, rsum, wst_out, nfl_out, fcz_out,
                  ratt_out};
  const S64Args s{t_stop, gseq, clk_out, ctr_out};
  return f64_launch_checked(a, h, r, s, layout, dims, plan, horizon, stream,
                            F64Sets::kStream, launch_stream_set);
}
