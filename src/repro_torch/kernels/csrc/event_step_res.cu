// Request resilience (timeouts, retries with backoff, admission shedding)
// through the float64 frozen-priority kernel
// (csrc/event_step_freeze64.cuh): the res branch of
// repro/core/fastpath.py::_scan_cell_kernel (l. 821), on push and
// single-node cells of a fixed uniform warm fleet (no cold starts, node
// speeds, capacity dynamics or hedging beside it).  The plain PyTorch
// version is repro_torch/kernels/event_step.py::freeze_scan_ref with res.
// Its own translation unit: the one set is compiled for 1 and 2 slots a
// lane in shared memory and for the wide path.

#include "event_step_freeze64.cuh"

EVENT_STEP_F64_FAMILY_LAUNCHER(event_step_res_launch, false, true)
