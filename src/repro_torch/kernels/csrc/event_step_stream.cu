// The chunked stream replay on the pull regime: the STREAM instantiations
// of the float32 pull kernel (event_step_kernel) and the float64 pull
// kernel (dyn_kernel) of event_step_pull.cuh, the stream branch of
// repro/core/fastpath.py::_scan_cell_kernel (l. 821) on pull cells.  The
// plain PyTorch version is repro_torch/kernels/event_step.py::
// event_step_ref with stream.  Its own translation unit, so that the whole-
// burst kernels of event_step.cu build beside it: each kernel's sets (slots
// a lane 1, 2, 4 or 8, rows staged or not, and the wide path; with and
// without COLD for the float64 one) are compiled once more here.
//
// What bounds it: the chain of one event a step, as for the whole-burst
// kernels; a stream bucket is one cell (one warp on one SM), so a chunk's
// time is its steps times the latency of one step.  At the planet fleet's
// widths (128 nodes of one slot, 16,384 functions) the float64 kernel
// takes the wide path: each step's scan over the functions reads 512
// entries a lane from the scratch.

#include "event_step_pull.cuh"

// Launches one chunk of the stream replay of D.B pull cells (float32) on
// `stream`: as event_step_launch, with the CSR queue lists `fnev` (B, n +
// 1) and `fnst` (B, F) in place of fn_ev, each cell's horizon `t_stop`
// (B,), and the final carry planes written to `clk_out` / `ctr_out` (which
// the caller fills with copies of clk / ctr).  `layout` holds the kLayout
// offsets (qcnt included), `dims` the kDims dimensions (kq and nc unused),
// `plan` the kPlan entries of ops.event_step_plan(..., stream=True).
extern "C" int event_step_stream_launch(
    const float* clk, const int* ctr, const float* t, const int* fnid,
    const float* p, const float* cost, const float* coef, const int* cores,
    const int* nodes, const int* fnev, const int* fnst, const float* t_stop,
    float* start, float* finish, float* prio, int* node, float* clk_out,
    int* ctr_out, int* scratch, const int* layout, const int* dims,
    const int* plan, float horizon, void* stream) {
  Layout L;
  Dims D;
  static_assert(sizeof(Layout) == kLayout * sizeof(int), "layout size");
  static_assert(sizeof(Dims) == kDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  const Args a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, nullptr,
               fnev, fnst, t_stop, start, finish, prio, node, clk_out,
               ctr_out, reinterpret_cast<uint32_t*>(scratch)};
  return pull_launch<true>(a, L, D, plan, horizon,
                           static_cast<cudaStream_t>(stream));
}

// Launches one chunk of the stream replay of D.B float64 pull cells
// (capacity dynamics with D.dyn, node speeds with D.het, cold starts with
// D.cold) on `stream`: as event_step_dyn_launch, with `fnev` / `fnst` in
// place of fn_ev, each cell's horizon `t_stop`, and the final carry planes
// written to `clk_out` / `ctr_out` (copies of clk / ctr from the caller).
// `layout` holds the kDLayout offsets (qcnt included), `plan` the kDPlan
// entries of ops.event_step_plan(..., f64=True, stream=True).
extern "C" int event_step_dyn_stream_launch(
    const double* clk, const int* ctr, const double* t, const int* fnid,
    const double* p, const double* cost, const double* coef, const int* cores,
    const int* nodes, const int* fnev, const int* fnst, const double* t_stop,
    const double* dynp, const int* maxn, const int* nreq, const double* spd,
    const int* epn, const double* ept0, const double* ept1, const double* epf,
    double* start, double* finish, double* prio, int* node, int* summ,
    double* act_out, int* dead_out, int* cold_out, int* coldq_out,
    double* clk_out, int* ctr_out, int* scratch, const int* layout,
    const int* dims, const int* plan, float horizon, void* stream) {
  DLayout L;
  DDims D;
  static_assert(sizeof(DLayout) == kDLayout * sizeof(int), "layout size");
  static_assert(sizeof(DDims) == kDDims * sizeof(int), "dims size");
  std::memcpy(&L, layout, sizeof(L));
  std::memcpy(&D, dims, sizeof(D));
  const DArgs a{clk, ctr, t, fnid, p, cost, coef, cores, nodes, nullptr,
                fnev, fnst, t_stop, dynp, maxn, nreq, spd, epn, ept0, ept1,
                epf, start, finish, prio, node, summ, act_out, dead_out,
                cold_out, coldq_out, clk_out, ctr_out,
                reinterpret_cast<uint32_t*>(scratch)};
  return dyn_launch<true>(a, L, D, plan, horizon,
                          static_cast<cudaStream_t>(stream));
}
