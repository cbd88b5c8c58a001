"""Slot-based KV cache manager for batched serving (port of
``repro.serving.kvcache``).

A fixed pool of ``n_slots`` lanes, each with a ``max_len`` KV budget -- the
accelerator analogue of "exactly one CPU core per container" (paper §IV-A):
a request owns one lane with a fixed device-memory reservation until
completion, so the batch is never recomposed mid-flight.

The manager tracks per-slot fill levels for ragged attention (the
``lengths`` operand of ``kernels.ops.decode_attention``) and exposes assign
/ release with O(1) free-list operations.

``Lane`` is the serving engine's form of one slot: a batch-1 cache of its
own with the token and position its decode step reads, static tensors that
a captured CUDA graph keeps reading and writing, zeroed for each new call.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models import init_cache
from ..models.config import ModelConfig


@dataclass
class SlotPool:
    cfg: ModelConfig
    n_slots: int
    max_len: int
    device: str | torch.device | None = None
    cache: dict = None                  # batched cache, (..., B, S, ...)
    lengths: np.ndarray = None          # (n_slots,) fill level
    owners: list = None                 # request id per slot (None = free)
    _free: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.cache = init_cache(self.cfg, self.n_slots, self.max_len,
                                device=self.device)
        self.lengths = np.zeros(self.n_slots, np.int32)
        self.owners = [None] * self.n_slots
        self._free = list(range(self.n_slots))

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def assign(self, request_id: int) -> int:
        """Reserve a lane; raises IndexError when full (caller queues)."""
        slot = self._free.pop()
        self.owners[slot] = request_id
        self.lengths[slot] = 0
        return slot

    def advance(self, slot: int, n: int = 1) -> None:
        self.lengths[slot] = min(self.lengths[slot] + n, self.max_len)

    def release(self, slot: int) -> None:
        assert self.owners[slot] is not None, f"slot {slot} already free"
        self.owners[slot] = None
        self.lengths[slot] = 0
        self._free.append(slot)

    def lengths_array(self) -> torch.Tensor:
        """Fill levels as an int32 tensor on the pool's device."""
        return torch.from_numpy(self.lengths.copy()).to(self.device)

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.n_slots


def zero_cache(cache: dict) -> dict:
    """Zero every leaf of a cache tree in place and return it: the fresh
    cache ``init_cache`` makes (all zeros, as JAX's ``init_cache``)."""
    for leaf in cache.values():
        if isinstance(leaf, dict):
            zero_cache(leaf)
        else:
            leaf.zero_()
    return cache


@dataclass(eq=False)
class Lane:
    """One decode lane of an endpoint: ``cache`` (batch 1, from
    ``init_cache``), ``token`` (1,) int32 and ``pos`` 0-dim int32, the next
    step's inputs; ``logits`` (1, V), the last step's output; ``graph``, the
    step captured on CUDA (None on the CPU); ``busy`` while a call holds
    the lane."""
    cache: dict
    token: torch.Tensor
    pos: torch.Tensor
    logits: torch.Tensor | None = None
    graph: object = None
    busy: bool = False

    @classmethod
    def new(cls, cfg: ModelConfig, cache_len: int, device) -> "Lane":
        return cls(cache=init_cache(cfg, 1, cache_len, device=device),
                   token=torch.zeros((1,), dtype=torch.int32, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))

    def reset(self) -> None:
        """A fresh call's state, in place: the cache zeroed, token and pos
        0."""
        zero_cache(self.cache)
        self.token.zero_()
        self.pos.zero_()
