"""Flash-attention forward: the plain PyTorch version and the launchers of
``csrc/flash_attention_wgmma.cu`` (bfloat16, on the tensor cores) and
``csrc/flash_attention.cu`` (float32, on the CUDA cores).

Counterpart of ``repro.kernels.flash_attention``: q (B, Sq, Hq, dh), k / v
(B, Sk, Hkv, dh) -> (B, Sq, Hq, dh) in q's dtype.  Positions are aligned
suffixes (query i at absolute position Sk - Sq + i); ``causal`` keeps keys at
or before the query, ``window > 0`` keeps the last ``window`` positions, GQA
folds query head h onto KV head h // G.  A query row with no key to attend
to gives 0, as the Pallas kernel does (the jnp oracle ``ref.attention_ref``
gives the mean of V there instead).

Arithmetic of both versions: scores in float32, p = exp(s - max) rounded
to the input dtype before the P·V product (``p.astype(v.dtype)`` in the
Pallas kernel), the sum of p in float32, the division at the end.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._operand import DTYPE_CODE, check_operand

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128, 256)

# the kernel source that takes each dtype
SOURCE = {torch.bfloat16: "flash_attention_wgmma",
          torch.float32: "flash_attention"}

_fns: dict = {}


def softmax_weights(s: torch.Tensor, dtype: torch.dtype):
    """``(p, l)`` for float32 scores ``s`` whose masked entries are
    ``NEG_INF``: ``p = exp(s - max)`` rounded to ``dtype`` as the kernels
    round it before P·V, and ``l`` the row sums of p before rounding, 1 for
    a row with nothing to attend to (whose p is all 0)."""
    m = s.amax(-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    return p.to(dtype).float(), torch.where(l == 0, 1.0, l)


def flash_attention_ref(q, k, v, *, causal=True, window=-1,
                        softmax_scale=None):
    """The plain version, on any device: full score matrices."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(dh))
    qg = q.float().reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = s.masked_fill(~mask, NEG_INF)
    p, l = softmax_weights(s, v.dtype)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh).to(q.dtype)


def cuda_operand(x: torch.Tensor, name: str, like: torch.Tensor,
                 shape: tuple) -> torch.Tensor:
    """Raise unless ``x`` can go to an attention kernel beside ``like``
    (the query): same CUDA device and dtype, ``shape``, contiguous, and
    16-byte aligned for the kernels' vector loads."""
    check_operand(x, name, like.device, like.dtype, shape)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
    return x


def check_kernel_shape(q: torch.Tensor, Hq: int, Hkv: int, dh: int) -> int:
    """The kernels' dtype code; raise for what they do not take."""
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"the attention kernels take float32 or bfloat16, "
                        f"not {q.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, not {dh}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not fold onto {Hkv} KV heads")
    return DTYPE_CODE[q.dtype]


def _lib(dtype: torch.dtype):
    """The launcher of the kernel that takes ``dtype``."""
    name = SOURCE[dtype]
    fn = _fns.get(name)
    if fn is None:
        from .build import load

        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def flash_attention_cuda(q, k, v, *, causal=True, window=-1,
                         softmax_scale=None):
    """Launch the kernel of q's dtype on the current stream: bfloat16 goes
    to ``csrc/flash_attention_wgmma.cu``, float32 to
    ``csrc/flash_attention.cu``."""
    B, Sq, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}, the kernel needs CUDA")
    check_kernel_shape(q, Hq, Hkv, dh)
    cuda_operand(q, "q", q, (B, Sq, Hq, dh))
    cuda_operand(k, "k", q, (B, Sk, Hkv, dh))
    cuda_operand(v, "v", q, (B, Sk, Hkv, dh))
    scale = softmax_scale or (1.0 / math.sqrt(dh))
    out = torch.empty_like(q)
    fn = _lib(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, Hq, Hkv, dh, float(scale), int(bool(causal)),
                 int(window), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: a TMA tensor map could not be "
                           f"encoded (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
