"""RWKV-6 time-mix recurrence: the plain PyTorch version and the launcher
of ``csrc/rwkv6_scan.cu``.

Counterpart of ``repro.kernels.rwkv6_scan``.  r, k, v (B, S, H, dh) in the
model dtype, w (B, S, H, dh) float32, u (H, dh), s0 (B, H, dh, dh) float32
(zeros when not given) -> (out (B, S, H, dh) in r's dtype, sT (B, H, dh,
dh) float32).  Per head, with a float32 state S:

    out_t = r_t @ (S + diag(u) k_t v_t^T)
    S    <- diag(w_t) S + k_t v_t^T

The Pallas kernel starts from zero and returns only ``out``; the port's
model carries the state from a prefill into every decode step, so both
versions here take s0 and return sT, as the jnp oracle ``ref.rwkv6_ref``
does.  Every product is taken in float32, as in the Pallas kernel.  (The
JAX model's own time mix rounds k v^T and S + u k v^T to the model dtype
before the product with r; in float32 the two are the same.)

The CUDA side has two paths: a direct step-by-step kernel for a decode step
or a short prompt (S <= ``DIRECT_MAX_S``), and for longer runs three
kernels over chunks of ``CHUNK`` steps (each chunk's decay and k v^T sum,
then the chunks' start states in sequence, then every chunk's outputs from
its start state), which need a float32 scratch of ``B * ceil(S / CHUNK) *
H * dh * (dh + 1)`` values.
"""

from __future__ import annotations

import ctypes

import torch

from ._operand import DTYPE_CODE, check_operand

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# S at or below which the direct kernel runs: three launches and a scratch
# cost more than they save on a few steps
DIRECT_MAX_S = 16
# time steps a chunk of the chunked path (the kernel's CHUNK; 64 measured
# faster than 32 on an H100, PERF.md)
CHUNK = 64

_fn = None


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """The plain version, on any device: one step at a time, in float32
    (float64 when r is float64, a yardstick for the float32 rounding)."""
    B, S, H, dh = r.shape
    acc = torch.promote_types(r.dtype, torch.float32)
    s = (torch.zeros(B, H, dh, dh, dtype=acc, device=r.device)
         if s0 is None else s0.to(acc).clone())
    rf, kf, vf, wf = (x.to(acc) for x in (r, k, v, w))
    uf = u.to(acc)[None, :, :, None]
    out = torch.empty_like(r)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 s + uf * kv).to(r.dtype)
        s = wf[:, t, :, :, None] * s + kv
    return out, s


def _lib():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("rwkv6_scan").rwkv6_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rwkv6_scan_cuda(r, k, v, w, u, s0=None):
    """Launch ``csrc/rwkv6_scan.cu`` on the current stream: the direct
    kernel for S <= ``DIRECT_MAX_S``, else the three chunked passes.
    The kernels read ``u`` in r's dtype or in float32; another floating
    dtype is cast to float32 (H x dh values)."""
    if r.device.type != "cuda":
        raise ValueError(f"r is on {r.device}, the kernel needs CUDA")
    if r.dtype not in DTYPE_CODE:
        raise TypeError(f"the RWKV-6 kernel takes float32 or bfloat16, not "
                        f"{r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, dh), got {tuple(r.shape)}")
    B, S, H, dh = r.shape
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the RWKV-6 kernel takes head size in "
                         f"{KERNEL_HEAD_DIMS}, not {dh}")
    f32 = torch.float32
    for x, name in ((r, "r"), (k, "k"), (v, "v")):
        check_operand(x, name, r.device, r.dtype, (B, S, H, dh))
    check_operand(w, "w", r.device, f32, (B, S, H, dh))
    if u.device != r.device or tuple(u.shape) != (H, dh):
        raise ValueError(f"u must be ({H}, {dh}) on {r.device}, got "
                         f"{tuple(u.shape)} on {u.device}")
    if not u.dtype.is_floating_point:
        raise TypeError(f"u has dtype {u.dtype}")
    uf = (u if u.dtype in (r.dtype, f32) else u.to(f32)).contiguous()
    if s0 is None:
        s0 = torch.zeros(B, H, dh, dh, dtype=f32, device=r.device)
    check_operand(s0, "s0", r.device, f32, (B, H, dh, dh))
    out = torch.empty_like(r)
    sT = torch.empty_like(s0)
    chunk = 0 if S <= DIRECT_MAX_S else CHUNK
    if chunk:
        n_chunk = -(-S // chunk)
        kstate = torch.empty(B, n_chunk, H, dh, dh, dtype=f32,
                             device=r.device)
        decay = torch.empty(B, n_chunk, H, dh, dtype=f32, device=r.device)
        scratch = (kstate.data_ptr(), decay.data_ptr())
    else:
        scratch = (None, None)
    fn = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 uf.data_ptr(), s0.data_ptr(), out.data_ptr(), sT.data_ptr(),
                 *scratch, B, S, H, dh, chunk, DTYPE_CODE[r.dtype],
                 DTYPE_CODE[uf.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    return out, sT
