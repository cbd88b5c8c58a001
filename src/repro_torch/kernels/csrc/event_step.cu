// Batched cluster event scans for Hopper (sm_90a): the launchers of the
// base-pull kernel (event_step_kernel) and the float64 pull kernel
// (dyn_kernel), both in event_step_pull.cuh (their STREAM instantiations
// are built from event_step_stream.cu); of the frozen-priority kernel
// (freeze_kernel, in event_step_freeze.cuh) for single-node and push
// cells; and of the float64 frozen-priority kernel (freeze64_kernel, its
// body in event_step_freeze64.cuh) for single-node and push cells with
// capacity dynamics, node speeds or cold starts; its hedged sets are built
// from event_step_hedge.cu and event_step_dup.cu, its resilience set from
// event_step_res.cu, and both frozen-priority kernels' STREAM sets from
// event_step_freeze_stream.cu.

#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "event_step_common.cuh"
#include "event_step_freeze.cuh"
#include "event_step_freeze64.cuh"
#include "event_step_pull.cuh"

namespace {

// The instantiation of the bucket's segments: each of the seven sets of
// cold / het / dyn is compiled for 1 and 2 slots a lane in shared memory
// (ops.EVENT_STEP_FREEZE64_PER_LANE) and for the wide path; the hedged
// sets are compiled in csrc/event_step_hedge.cu and csrc/event_step_dup.cu,
// the resilience set in csrc/event_step_res.cu.
template <int PL>
int launch_f64_pl(const F64Args& a, const H64Args& h, const R64Args& r,
                  const S64Args& s, const F64Layout& L, const F64Dims& D,
                  int cell, float horizon, cudaStream_t stream, int pl,
                  int words) {
  const int m = (D.cold ? 1 : 0) | (D.het ? 2 : 0) | (D.dyn ? 4 : 0);
#define SET(M, C, H, Y)                                                     \
  case M:                                                                   \
    return launch_f64<PL, C, H, Y>(a, h, r, s, L, D, cell, horizon, stream, \
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
                   const R64Args& r, const S64Args& s, const F64Layout& L,
                   const F64Dims& D, int cell, float horizon,
                   cudaStream_t stream, int pl, int words) {
  switch (pl_sel) {
    case 0: return launch_f64_pl<0>(a, h, r, s, L, D, cell, horizon, stream,
                                    pl, words);
    case 1: return launch_f64_pl<1>(a, h, r, s, L, D, cell, horizon, stream,
                                    pl, words);
    case 2: return launch_f64_pl<2>(a, h, r, s, L, D, cell, horizon, stream,
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
// `cumf` is not read (see the FC window in event_step_pull.cuh).  Returns
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
  static_assert(sizeof(Layout) == kLayout * sizeof(int), "layout size");
  static_assert(sizeof(Dims) == kDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  const Args a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, fn_ev,
               nullptr, nullptr, nullptr, start, finish, prio, node,
               nullptr, nullptr, reinterpret_cast<uint32_t*>(scratch)};
  return pull_launch<false>(a, L, D, plan, horizon,
                            static_cast<cudaStream_t>(stream));
}

// Launches the frozen-priority scan of D.B cells on `stream`.  `layout`
// holds the kFLayout carry offsets, `dims` the kFDims launch dimensions and
// `plan` the kFPlan entries of ops.event_step_plan(..., freeze=True)
// (entries per lane; staged or not; wide or not; shared-memory bytes a
// cell; scratch words a cell), all in host memory.  `scratch` holds D.B
// times the scratch words (null when they are 0).  Returns
// cudaGetLastError() after the launch, or the error that stopped it.
extern "C" int event_step_freeze_launch(
    const float* clk, const int* ctr, const float* t, const int* fnid,
    const float* p, const float* cost, const float* coef, const int* cores,
    const int* nodes, const float* cnt, const int* home0, const int* route,
    float* start, float* finish, float* prio, int* node, int* scratch,
    const int* layout, const int* dims, const int* plan, float horizon,
    void* stream) {
  const FArgs a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, cnt, home0,
                route, start, finish, prio, node,
                reinterpret_cast<uint32_t*>(scratch)};
  return freeze_launch<false>(a, FStream{nullptr, nullptr, nullptr}, layout,
                              dims, plan, horizon,
                              static_cast<cudaStream_t>(stream));
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
  static_assert(sizeof(DLayout) == kDLayout * sizeof(int), "layout size");
  static_assert(sizeof(DDims) == kDDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  const DArgs a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, fn_ev,
                nullptr, nullptr, nullptr, dynp, maxn, nreq, spd, epn, ept0,
                ept1, epf, start, finish, prio, node, summ, act_out,
                dead_out, cold_out, coldq_out, nullptr, nullptr,
                reinterpret_cast<uint32_t*>(scratch)};
  return dyn_launch<false>(a, L, D, plan, horizon,
                           static_cast<cudaStream_t>(stream));
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
  const S64Args s{nullptr, nullptr, nullptr, nullptr};
  return f64_launch_checked(a, h, r, s, layout, dims, plan, horizon, stream,
                            F64Sets::kPlain, launch_f64_set);
}
