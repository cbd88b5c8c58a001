"""Serving engine driven by the paper's node scheduler (port of
``repro.serving.engine``).

The real-execution counterpart of the simulator: endpoints are (model
config, generation profile) pairs, each with resident parameters ("warm
container" = parameters on the device and a first decode step run; cold
start = parameter init plus that first step, measured for real).  The node
has ``slots`` decode lanes; admission is non-preemptive and slot-based as
in paper §IV-A: a request admitted to a lane generates to completion, the
queue is a priority queue over FIFO/SEPT/EECT/RECT/FC, and E[p] comes from
the last 10 completed calls of the same endpoint.

PyTorch on CUDA returns before the card is done, so ``warm_up`` and
``_finish`` synchronise before they read the clock: response times measure
the card's work, not the launch queue.  Each endpoint's parameters come
from a ``torch.Generator`` seeded from the engine's seed stream, in place
of JAX's key splits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.estimator import RuntimeEstimator
from ..core.policies import make_policy
from ..core.queues import PriorityQueue
from ..core.request import Request
from ..device import resolve_device
from ..models import decode_step, init, init_cache
from ..models.config import ModelConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Endpoint:
    """A deployable function: model + generation profile."""

    name: str
    cfg: ModelConfig
    prompt_len: int = 8
    gen_len: int = 16
    params: dict | None = None        # resident weights (warm)
    device: torch.device | None = None
    _warm: bool = False

    @property
    def cache_len(self) -> int:
        return self.prompt_len + self.gen_len + 8

    def warm_up(self, seed: int) -> float:
        """Materialise the parameters from ``seed`` and run one decode step
        (the 'container cold start').  Returns wall seconds, the card's
        work included."""
        self.device = resolve_device(self.device)
        t0 = time.monotonic()
        if self.params is None:
            self.params = init(self.cfg, seed, self.device)
        if not self._warm:
            cache = init_cache(self.cfg, 1, self.cache_len,
                               device=self.device)
            tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
            decode_step(self.params, self.cfg, tok, cache, 0)
            self._warm = True
        _sync(self.device)
        return time.monotonic() - t0

    @property
    def is_warm(self) -> bool:
        return self.params is not None and self._warm


@dataclass
class ActiveCall:
    request: Request
    endpoint: Endpoint
    cache: dict
    pos: int
    remaining: int
    token: torch.Tensor


class ServingEngine:
    """Single-node engine: priority queue + slot lanes + per-endpoint
    decode.  ``device``: where every endpoint runs (CUDA by default)."""

    def __init__(self, endpoints: list[Endpoint], slots: int = 4,
                 policy: str = "fc", seed: int = 0, prewarm: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.endpoints = {e.name: e for e in endpoints}
        for ep in endpoints:
            ep.device = self.device
        self.slots = slots
        self.policy = make_policy(policy)
        self.estimator = RuntimeEstimator()
        self.queue = PriorityQueue()
        self.active: list[ActiveCall] = []
        self.completed: list[Request] = []
        self.cold_starts = 0
        self.decode_steps = 0
        self._seeds = np.random.default_rng(seed)
        self._t0 = time.monotonic()
        if prewarm:
            for ep in endpoints:
                ep.warm_up(self._next_seed())

    def _next_seed(self) -> int:
        return int(self._seeds.integers(2**62))

    # -- clock ----------------------------------------------------------------
    def now(self) -> float:
        return time.monotonic() - self._t0

    # -- intake ---------------------------------------------------------------
    def submit(self, endpoint: str,
               request_time: float | None = None) -> Request:
        req = Request(fn=endpoint, r=request_time if request_time is not None
                      else self.now())
        now = self.now()
        req.r_prime = now
        self.estimator.observe_arrival(req.fn, now)
        self.queue.push(req, self.policy.priority(req, self.estimator, now))
        return req

    # -- scheduling (paper §IV: slot admission, non-preemptive) ---------------
    def _admit(self) -> None:
        while self.queue and len(self.active) < self.slots:
            req = self.queue.pop()
            ep = self.endpoints[req.fn]
            if not ep.is_warm:                  # cold start, measured
                ep.warm_up(self._next_seed())
                self.cold_starts += 1
                req.cold_start = True
            req.start = self.now()
            cache = init_cache(ep.cfg, 1, ep.cache_len, device=self.device)
            self.active.append(ActiveCall(
                request=req, endpoint=ep, cache=cache, pos=0,
                remaining=ep.prompt_len + ep.gen_len,
                token=torch.zeros((1,), dtype=torch.int32,
                                  device=self.device)))

    # -- execution -------------------------------------------------------------
    def _step_call(self, call: ActiveCall) -> None:
        ep = call.endpoint
        logits, call.cache = decode_step(ep.params, ep.cfg, call.token,
                                         call.cache, call.pos)
        call.token = logits.argmax(-1).to(torch.int32)
        call.pos += 1
        call.remaining -= 1
        self.decode_steps += 1

    def run(self, until_idle: bool = True, max_wall_s: float = 120.0) -> None:
        """Drive the engine until all submitted work completes."""
        deadline = time.monotonic() + max_wall_s
        while (self.queue or self.active) and time.monotonic() < deadline:
            self._admit()
            if not self.active:
                time.sleep(0.001)
                continue
            # one decode step per active lane (lockstep batch iteration)
            for call in list(self.active):
                self._step_call(call)
                if call.remaining <= 0:
                    self._finish(call)

    def _finish(self, call: ActiveCall) -> None:
        _sync(self.device)                  # the call's steps are done
        self.active.remove(call)
        req = call.request
        req.finish = self.now()
        req.c = req.finish
        service = req.finish - req.start
        req.p_true = service
        self.estimator.observe_completion(req.fn, service)
        self.completed.append(req)

    # -- metrics ----------------------------------------------------------------
    def summary(self) -> dict:
        resp = np.array([r.response_time for r in self.completed])
        return {
            "n": len(self.completed),
            "R_avg": float(resp.mean()),
            "R_p50": float(np.percentile(resp, 50)),
            "R_p95": float(np.percentile(resp, 95)),
            "cold_starts": self.cold_starts,
        }
