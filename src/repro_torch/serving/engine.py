"""Serving engine driven by the paper's node scheduler (port of
``repro.serving.engine``).

The real-execution counterpart of the simulator: endpoints are (model
config, generation profile) pairs, each with resident parameters ("warm
container" = parameters on the device and a compiled decode step; cold
start = parameter init, one eager decode step and the step's capture,
measured for real, as JAX's is init plus compile).  The node
has ``slots`` decode lanes; admission is non-preemptive and slot-based as
in paper §IV-A: a request admitted to a lane generates to completion, the
queue is a priority queue over FIFO/SEPT/EECT/RECT/FC, and E[p] comes from
the last 10 completed calls of the same endpoint.

Where JAX jits ``decode_step`` once per endpoint, the port captures it in
a CUDA graph once per (endpoint, slot lane): each lane owns a static cache,
token and position (``kvcache.Lane``), and its graph holds the decode step,
the greedy argmax into the lane's token and the step of its position, so a
decode step costs the host one replay.  A call admitted to a lane finds it
zeroed, the fresh cache JAX gives each call.  The lanes' graphs of one
endpoint share one memory pool.  A capture that fails raises: there is no
eager fallback on CUDA.  On the CPU (``device="cpu"``) the same lane code
runs the step eagerly; there are no graphs.

Kernel launches under replay: ``kernels.ops`` counts a launch where its
wrapper is called, which a replay does not do, so each endpoint records
the launches its step captured (``Endpoint.captured``) and the engine
counts the replays (``replays``); ``kernel_launches()`` is their product.

PyTorch on CUDA returns before the card is done, so ``warm_up`` and
``_finish`` synchronise before they read the clock: response times measure
the card's work, not the launch queue.  Each endpoint's parameters come
from a ``torch.Generator`` seeded from the engine's seed stream, in place
of JAX's key splits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.estimator import RuntimeEstimator
from ..core.policies import make_policy
from ..core.queues import PriorityQueue
from ..core.request import Request
from ..device import resolve_device
from ..kernels import ops
from ..models import decode_step, init
from ..models.config import ModelConfig
from .kvcache import Lane


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
    lanes: list[Lane] = field(default_factory=list)
    # kernel launches of one captured step: {kernel: n} (CUDA)
    captured: dict | None = None
    _pool: tuple | None = None        # the lanes' graph memory pool
    _warm: bool = False

    @property
    def cache_len(self) -> int:
        return self.prompt_len + self.gen_len + 8

    def warm_up(self, seed: int, lanes: int = 1) -> float:
        """Materialise the parameters from ``seed``, run one decode step
        eagerly (it builds the kernels and the matrix library's handles)
        and, on CUDA, capture the step of each of ``lanes`` lanes (the
        'container cold start').  Returns wall seconds, the card's work
        included."""
        self.device = resolve_device(self.device)
        t0 = time.monotonic()
        if self.params is None:
            self.params = init(self.cfg, seed, self.device)
        if not self._warm:
            scratch = self._new_lane()
            if self.device.type == "cuda":
                # off the stream that captures, as torch.cuda.graph asks
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self._step(scratch)
                torch.cuda.current_stream(self.device).wait_stream(side)
            else:
                self._step(scratch)
            self._warm = True
        new = [self._new_lane() for _ in range(lanes - len(self.lanes))]
        if self.device.type == "cuda":
            for lane in new:
                self._capture(lane)
        self.lanes += new
        _sync(self.device)
        return time.monotonic() - t0

    @property
    def is_warm(self) -> bool:
        return self.params is not None and self._warm

    def _new_lane(self) -> Lane:
        return Lane.new(self.cfg, self.cache_len, self.device)

    def _step(self, lane: Lane) -> None:
        """The lane's decode step: the logits, the greedy next token into
        ``lane.token`` and ``pos`` + 1, all on the device."""
        lane.logits, _ = decode_step(self.params, self.cfg, lane.token,
                                     lane.cache, lane.pos)
        lane.token.copy_(lane.logits.argmax(-1))
        lane.pos.add_(1)

    def _capture(self, lane: Lane) -> None:
        """Capture ``lane``'s step in a CUDA graph in the endpoint's pool
        and record its kernel launches in ``captured``; raises if the
        capture fails or records a plain version."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        lane.graph = torch.cuda.CUDAGraph()
        with ops.counted_apart() as counts:
            with torch.cuda.graph(lane.graph, pool=self._pool):
                self._step(lane)
        plain = {k: v["plain"] for k, v in counts.items() if v["plain"]}
        if plain:
            raise RuntimeError(f"{self.name}: the captured decode step runs "
                               f"plain versions {plain}")
        self.captured = {k: v["kernel"] for k, v in counts.items()
                         if v["kernel"]}

    def step(self, lane: Lane) -> None:
        """One decode step of the call in ``lane``: its graph's replay on
        CUDA, the step itself on the CPU."""
        if self.device.type == "cuda":
            lane.graph.replay()
        else:
            self._step(lane)


@dataclass
class ActiveCall:
    request: Request
    endpoint: Endpoint
    lane: Lane
    remaining: int


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
        self.replays: dict[str, int] = {}     # graph replays by endpoint
        self._seeds = np.random.default_rng(seed)
        self._t0 = time.monotonic()
        if prewarm:
            for ep in endpoints:
                ep.warm_up(self._next_seed(), self.slots)

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
                ep.warm_up(self._next_seed(), self.slots)
                self.cold_starts += 1
                req.cold_start = True
            req.start = self.now()
            # at most ``slots`` calls are active, so a lane is free
            lane = next(lane for lane in ep.lanes if not lane.busy)
            lane.busy = True
            lane.reset()
            self.active.append(ActiveCall(
                request=req, endpoint=ep, lane=lane,
                remaining=ep.prompt_len + ep.gen_len))

    # -- execution -------------------------------------------------------------
    def _step_call(self, call: ActiveCall) -> None:
        ep = call.endpoint
        ep.step(call.lane)
        if ep.device.type == "cuda":
            self.replays[ep.name] = self.replays.get(ep.name, 0) + 1
        call.remaining -= 1
        self.decode_steps += 1

    def kernel_launches(self) -> dict:
        """``{kernel: n}``: the launches of the replayed decode steps, each
        endpoint's replays times the launches its graph captured."""
        out: dict = {}
        for name, n in self.replays.items():
            for kernel, k in self.endpoints[name].captured.items():
                out[kernel] = out.get(kernel, 0) + n * k
        return out

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
        call.lane.busy = False
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
