"""Token samplers (greedy / temperature / top-k); port of
``repro.serving.sampler``.  Randomness comes from a ``torch.Generator``
on the logits' device, in place of a JAX key."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(-1).to(torch.int32)


def _draw(logits: torch.Tensor, generator: torch.Generator,
          t: float) -> torch.Tensor:
    """One index per row from softmax(logits / t)."""
    probs = torch.softmax(logits.float() / max(t, 1e-4), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    pick = torch.multinomial(flat, 1, generator=generator)
    return pick.reshape(probs.shape[:-1])


def temperature(logits: torch.Tensor, generator: torch.Generator,
                t: float = 1.0) -> torch.Tensor:
    return _draw(logits, generator, t).to(torch.int32)


def top_k(logits: torch.Tensor, generator: torch.Generator, k: int = 40,
          t: float = 1.0) -> torch.Tensor:
    vals, idx = torch.topk(logits, k, dim=-1)
    choice = _draw(vals, generator, t)
    return idx.gather(-1, choice[..., None])[..., 0].to(torch.int32)
