"""RG-LRU linear recurrence: the plain PyTorch version and the launcher of
``csrc/rglru_scan.cu``.

Counterpart of ``repro.kernels.rglru_scan``: a, gx (B, S, W), h0 (B, W) ->
(hs (B, S, W), hT (B, W)) in the input dtype, ``h_t = a_t * h_{t-1} +
gx_t`` per channel with h carried in float32, as the Pallas kernel carries
it.  (The JAX model's own ``layers.rglru_scan`` carries h in the model
dtype and rounds it every step; in float32 the two are the same.)  Any S,
S = 1 included, and any W: the Pallas kernel's block asserts are not
carried over.  The CUDA side has two kernels: a direct one for a decode
step or a short prompt (S <= ``DIRECT_MAX_S``) and one that stages time
tiles through shared memory for longer runs; both take the same float32
steps as the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ._operand import DTYPE_CODE, check_operand

# S at or below which the direct kernel runs (its U = 8 steps of loads in
# one round trip), above it the staged kernel
DIRECT_MAX_S = 8

_fn = None


def rglru_scan_ref(a, gx, h0):
    """The plain version, on any device: one step at a time."""
    S = a.shape[1]
    h = h0.float()
    hs = torch.empty_like(a)
    for t in range(S):
        h = a[:, t].float() * h + gx[:, t].float()
        hs[:, t] = h.to(a.dtype)
    return hs, h.to(a.dtype)


def _lib():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("rglru_scan").rglru_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rglru_scan_cuda(a, gx, h0):
    """Launch ``csrc/rglru_scan.cu`` on the current stream: the direct
    kernel for S <= ``DIRECT_MAX_S``, else the staged one."""
    if a.device.type != "cuda":
        raise ValueError(f"a is on {a.device}, the kernel needs CUDA")
    if a.dtype not in DTYPE_CODE:
        raise TypeError(f"the RG-LRU kernel takes float32 or bfloat16, not "
                        f"{a.dtype}")
    if a.dim() != 3:
        raise ValueError(f"a must be (B, S, W), got {tuple(a.shape)}")
    B, S, W = a.shape
    check_operand(a, "a", a.device, a.dtype, (B, S, W))
    check_operand(gx, "gx", a.device, a.dtype, (B, S, W))
    check_operand(h0, "h0", a.device, a.dtype, (B, W))
    hs = torch.empty_like(a)
    hT = torch.empty_like(h0)
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), gx.data_ptr(), h0.data_ptr(), hs.data_ptr(),
                 hT.data_ptr(), B, S, W, DTYPE_CODE[a.dtype],
                 int(S <= DIRECT_MAX_S), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    return hs, hT
