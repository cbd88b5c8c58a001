"""One-token decode attention over a ragged KV cache: the plain PyTorch
version and the launcher of ``csrc/decode_attention.cu``, which splits a row
over blocks and merges the parts (flash-decoding).

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
import functools
import math

import torch

from .flash_attention import (NEG_INF, check_kernel_shape, cuda_operand,
                              softmax_weights)

MAX_GROUP = 16       # query heads a KV head the kernel takes
SMS = 132            # streaming multiprocessors of an H100
KEY_STRIDE = 32      # keys the kernel's 8 warps take in one step (4 each)
BLOCKS_PER_SM = 16   # split blocks aimed for on each SM when rows are full
# a cache of at most this many keys stays one split: each warp walks it in
# two steps, less than the merge's launch would cost (the serving caches)
ONE_SPLIT_KEYS = 64

_fn = None


@functools.lru_cache(maxsize=256)
def split_plan(Sk: int, B: int, Hkv: int) -> tuple[int, int]:
    """``(n_split, chunk)``: each cache row is cut into ``n_split`` chunks of
    ``chunk`` keys, one block each for every KV head (and part of a group).
    Taken from Sk and the launch geometry only, never from ``lengths``:
    reading them on the host would synchronise every decode step.  Enough
    splits for BLOCKS_PER_SM (row, KV head) blocks on each of the SMS SMs
    when every row is full, ``chunk`` a multiple of KEY_STRIDE; one split
    (one launch, no scratch) up to ONE_SPLIT_KEYS."""
    if Sk <= ONE_SPLIT_KEYS:
        return 1, max(Sk, 1)
    n_split = min(-(-BLOCKS_PER_SM * SMS // (B * Hkv)), -(-Sk // KEY_STRIDE))
    if n_split <= 1:
        return 1, Sk
    chunk = -(-Sk // n_split)
    chunk = -(-chunk // KEY_STRIDE) * KEY_STRIDE
    return -(-Sk // chunk), chunk


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


def decode_attention_split_ref(q, k, v, lengths, n_split, chunk, *,
                              softmax_scale=None):
    """The kernel's split-and-merge arithmetic in plain PyTorch: split s of
    row b takes keys [s chunk, min((s + 1) chunk, lengths[b])) with its own
    max m_s, sum l_s of the unrounded p and acc_s of p rounded to the input
    dtype times V; the splits merge as sum acc_s e^(m_s - M) / sum l_s
    e^(m_s - M) with M the largest m_s; a row of length 0 gives 0."""
    B, Hq, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = softmax_scale or (1.0 / math.sqrt(dh))
    qg = q.float().reshape(B, Hkv, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    length = lengths.to(q.device).long()[:, None]
    pos = torch.arange(Sk, device=q.device)[None, :]
    M = torch.full((B, Hkv, G, 1), NEG_INF, device=q.device)
    parts = []
    for i in range(n_split):
        keys = (pos >= i * chunk) & (pos < (i + 1) * chunk) & (pos < length)
        si = s.masked_fill(~keys[:, None, None, :], NEG_INF)
        m = si.amax(-1, keepdim=True)
        p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(si - m))
        acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(),
                           v.float())
        parts.append((m, p.sum(-1, keepdim=True), acc))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    O = torch.zeros((B, Hkv, G, dh), device=q.device)
    for m, l, acc in parts:
        c = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - M))
        L = L + c * l
        O = O + c * acc
    out = O / torch.where(L == 0, 1.0, L)
    return out.reshape(B, Hq, dh).to(q.dtype)


def _lib():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("decode_attention").decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def decode_attention_cuda(q, k, v, lengths, *, softmax_scale=None):
    """Launch ``csrc/decode_attention.cu`` on the current stream: one kernel
    when ``split_plan`` gives one split, else the split kernel and the merge
    over a float32 scratch of (B, n_split, Hq, dh + 2)."""
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
    n_split, chunk = split_plan(Sk, B, Hkv)
    out = torch.empty_like(q)
    scratch = (torch.empty((B, n_split, Hq, dh + 2), dtype=torch.float32,
                           device=q.device) if n_split > 1 else None)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, Hq, Hkv,
                 Sk, dh, n_split, chunk, float(scale), code, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
