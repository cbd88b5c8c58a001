"""Carry state across from the JAX package, as numpy arrays: its bucket
input dict and ``(clk, ctr)`` carry planes, and its model parameter tree,
become the port's tensors."""

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


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The JAX parameter tree, as numpy arrays (``groups/pos{i}`` leaves
    stacked to (n_groups, ...), ``embed``, ``final_norm``, ``lm_head``), as
    the port's parameters in ``cfg.dtype`` on ``device``.  bfloat16 arrays
    (numpy's ``ml_dtypes`` type) cross through float32, which is exact.
    Raises ``ValueError`` unless the tree has the port's names and shapes
    (``models.param_shapes``)."""
    from .models.model import param_shapes, torch_dtype

    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def conv(shapes, sub, path):
        if isinstance(shapes, dict):
            if not isinstance(sub, dict) or set(sub) != set(shapes):
                got = sorted(sub) if isinstance(sub, dict) else type(sub)
                raise ValueError(f"{path or 'params'}: keys {got}, expected "
                                 f"{sorted(shapes)}")
            return {k: conv(shapes[k], sub[k], f"{path}/{k}".lstrip("/"))
                    for k in sorted(shapes)}
        a = np.asarray(sub)
        if a.shape != tuple(shapes):
            raise ValueError(f"{path}: shape {a.shape}, expected {shapes}")
        t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        return t.to(device=dev, dtype=dtype)

    return conv(param_shapes(cfg), tree, "")
