"""One-token decode attention over a ragged KV cache: the plain PyTorch
version and the launcher of ``csrc/decode_attention.cu``.

Counterpart of ``repro.kernels.decode_attention``: q (B, Hq, dh), k / v
(B, Sk, Hkv, dh), lengths (B,) int32 -> (B, Hq, dh) in q's dtype.  Row b
attends to its first ``lengths[b]`` cache entries; GQA folds query head h
onto KV head h // G.  A row of length 0 gives 0, as the Pallas kernel does
(the jnp oracle ``ref.decode_attention_ref`` gives the mean of V there).
The arithmetic is that of ``flash_attention``: float32 scores, p rounded to
the input dtype before P·V, the division at the end.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .flash_attention import (NEG_INF, check_kernel_shape, cuda_operand,
                              softmax_weights)

MAX_GROUP = 16       # query heads a KV head the kernel takes

_fn = None


def decode_attention_ref(q, k, v, lengths, *, softmax_scale=None):
    """The plain version, on any device."""
    B, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(dh))
    qg = q.float().reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    valid = (torch.arange(Sk, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p, l = softmax_weights(s, v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float()) / l
    return out.reshape(B, Hq, dh).to(q.dtype)


def _lib():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("decode_attention").decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention_cuda(q, k, v, lengths, *, softmax_scale=None):
    """Launch ``csrc/decode_attention.cu`` on the current stream."""
    B, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}, the kernel needs CUDA")
    code = check_kernel_shape(q, Hq, Hkv, dh)
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"the decode kernel takes at most {MAX_GROUP} query "
                         f"heads a KV head, not {Hq // Hkv}")
    cuda_operand(q, "q", q, (B, Hq, dh))
    cuda_operand(k, "k", q, (B, Sk, Hkv, dh))
    cuda_operand(v, "v", q, (B, Sk, Hkv, dh))
    if lengths.device != q.device or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},) on {q.device}, got "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if lengths.dtype != torch.int32:
        if lengths.dtype.is_floating_point:
            raise TypeError(f"lengths has dtype {lengths.dtype}")
        lengths = lengths.to(torch.int32)
    lengths = lengths.contiguous()
    scale = softmax_scale or (1.0 / math.sqrt(dh))
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sk, dh,
                 float(scale), code, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
