"""What every kernel of the port needs of a tensor, and the dtype codes its
plain C interfaces take."""

from __future__ import annotations

import torch

# the ``dtype`` argument of the attention and recurrence launchers
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(x: torch.Tensor, name: str, device: torch.device,
                  dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``x`` is on ``device``, of ``dtype`` and ``shape``, and
    contiguous."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
