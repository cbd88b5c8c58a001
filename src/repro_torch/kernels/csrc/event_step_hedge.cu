// Straggler hedging in steal mode through the float64 frozen-priority
// kernel (csrc/event_step_freeze64.cuh): the hedge branch of
// repro/core/fastpath.py::_scan_cell_kernel (l. 821), with or without cold
// starts, node speeds and capacity dynamics.  The plain PyTorch version is
// repro_torch/kernels/event_step.py::freeze_scan_ref with hedge.  Its own
// translation unit, so that csrc/event_step.cu does not grow: the eight
// sets are each compiled for 1 and 2 slots a lane in shared memory and for
// the wide path.

#include "event_step_freeze64.cuh"

EVENT_STEP_F64_FAMILY_LAUNCHER(event_step_hedge_launch, false, false)
