// Straggler hedging in duplicate mode through the float64 frozen-priority
// kernel (csrc/event_step_freeze64.cuh): the hedge and dup branches of
// repro/core/fastpath.py::_scan_cell_kernel (l. 821), with or without cold
// starts and node speeds (duplicate mode takes no capacity dynamics under
// push).  The plain PyTorch version is
// repro_torch/kernels/event_step.py::freeze_scan_ref with hedge and dup.
// Its own translation unit: the four sets are each compiled for 1 and 2
// slots a lane in shared memory and for the wide path.

#include "event_step_freeze64.cuh"

EVENT_STEP_F64_FAMILY_LAUNCHER(event_step_dup_launch, true, false)
