"""Carry state across from the JAX package: its bucket input dict and
``(clk, ctr)`` carry planes, as numpy arrays, become the port's tensors."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = np.float32 if np.issubdtype(a.dtype, np.floating) else np.int32
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def bucket_from_numpy(inp: dict, clk=None, ctr=None, device=None):
    """``(inp, clk, ctr)`` as tensors on ``device``: float arrays become
    float32, integer and bool arrays int32 (the dtypes of float32 scan
    buckets).  ``clk``/``ctr`` stay ``None`` when not given."""
    dev = resolve_device(device)
    tens = {k: _tensor(v, dev) for k, v in inp.items()}
    return (tens, None if clk is None else _tensor(clk, dev),
            None if ctr is None else _tensor(ctr, dev))
