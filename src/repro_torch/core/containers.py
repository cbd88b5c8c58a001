"""Container / warm-executable pool (own copy of
``repro.core.containers``, paper §III, §IV-A, §VI).

Models the three container states OpenWhisk distinguishes: the **free
pool** (runtime and function initialised: warm), the **prewarm pool**
(runtime only) and **busy** (executing a call), under two admission
disciplines: ``baseline`` (stock OpenWhisk, memory-based: a request with
no matching free container creates one while memory allows, evicting idle
non-matching containers, so busy containers are unbounded) and ``ours``
(CPU-based: busy containers <= cores, each owning one core, and at most
``cores`` warm containers a function).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Cost constants (seconds) -- calibrated to the paper's measurements:
# "It takes 500 ms on the average [21] (and, in our measurements, up to 2 s)
#  to fully initialize a new container."
COLD_CREATE_S = 1.8      # create container from scratch (docker run + init)
PREWARM_INIT_S = 0.6     # initialise the function inside a prewarm container


@dataclass
class Container:
    fn: str | None           # None => prewarm (runtime only)
    memory_mb: int
    busy: bool = False
    last_used: float = 0.0
    created_at: float = 0.0


@dataclass
class AcquireResult:
    container: Container
    startup_delay: float     # 0 for warm, PREWARM_INIT_S / COLD_CREATE_S otherwise
    cold_start: bool         # true when the request pays any initialisation


@dataclass
class ContainerPool:
    memory_mb: int                     # node memory pool (OpenWhisk userMemory)
    container_mb: int = 256            # default per-container reservation
    discipline: str = "ours"           # "ours" | "baseline"
    cores: int = 10                    # used by "ours" to bound the pool
    prewarm_count: int = 2             # stock OpenWhisk keeps a few prewarms
    fn_memory: dict | None = None      # per-function container sizes (MB)
    containers: list[Container] = field(default_factory=list)
    # counters (read by benchmarks / Fig. 2)
    cold_starts: int = 0
    evictions: int = 0
    creations: int = 0

    def __post_init__(self) -> None:
        for _ in range(self.prewarm_count):
            if self._mem_used() + self.container_mb <= self.memory_mb:
                self.containers.append(Container(fn=None, memory_mb=self.container_mb))

    def _size(self, fn: str | None) -> int:
        if fn is not None and self.fn_memory:
            return int(self.fn_memory.get(fn, self.container_mb))
        return self.container_mb

    # -- queries -------------------------------------------------------------
    def _mem_used(self) -> int:
        return sum(c.memory_mb for c in self.containers)

    def busy_count(self) -> int:
        return sum(1 for c in self.containers if c.busy)

    def warm_count(self, fn: str | None = None) -> int:
        return sum(
            1
            for c in self.containers
            if not c.busy and c.fn is not None and (fn is None or c.fn == fn)
        )

    # -- acquisition ---------------------------------------------------------
    def acquire(self, fn: str, now: float) -> AcquireResult | None:
        """Find/create a container for ``fn``.  Returns None when the request
        must stay queued (no capacity).  Mirrors the invoker algorithm in
        paper §III: free pool -> prewarm pool -> create -> evict+create."""
        # 1. free-pool container already initialised with fn (warm start)
        best: Container | None = None
        for c in self.containers:
            if not c.busy and c.fn == fn:
                if best is None or c.last_used > best.last_used:
                    best = c
        if best is not None:
            best.busy = True
            best.last_used = now
            return AcquireResult(best, 0.0, cold_start=False)

        # 2. prewarm container (runtime present, init the function)
        for c in self.containers:
            if not c.busy and c.fn is None:
                c.fn = fn
                c.busy = True
                c.last_used = now
                self.cold_starts += 1
                self._replenish_prewarm()
                return AcquireResult(c, PREWARM_INIT_S, cold_start=True)

        # 3. create a new container if memory allows
        if self._mem_used() + self._size(fn) <= self.memory_mb:
            c = Container(fn=fn, memory_mb=self._size(fn), busy=True,
                          created_at=now, last_used=now)
            self.containers.append(c)
            self.creations += 1
            self.cold_starts += 1
            return AcquireResult(c, COLD_CREATE_S, cold_start=True)

        # 4. evict idle non-matching free-pool containers (LRU), then create
        idle = [c for c in self.containers if not c.busy and c.fn != fn]
        idle.sort(key=lambda c: c.last_used)
        while idle and self._mem_used() + self._size(fn) > self.memory_mb:
            victim = idle.pop(0)
            self.containers.remove(victim)
            self.evictions += 1
        if self._mem_used() + self._size(fn) <= self.memory_mb:
            c = Container(fn=fn, memory_mb=self._size(fn), busy=True,
                          created_at=now, last_used=now)
            self.containers.append(c)
            self.creations += 1
            self.cold_starts += 1
            return AcquireResult(c, COLD_CREATE_S, cold_start=True)

        # 5. nothing available: the call stays queued
        return None

    def release(self, container: Container, now: float) -> None:
        container.busy = False
        container.last_used = now
        if self.discipline == "ours":
            self._trim_ours(now)

    # -- warm-pool discipline --------------------------------------------------
    def _trim_ours(self, now: float) -> None:
        """Our discipline upper-bounds warm containers per function by
        ``cores`` (paper §VI: max containers = #functions × #cores)."""
        by_fn: dict[str, list[Container]] = {}
        for c in self.containers:
            if not c.busy and c.fn is not None:
                by_fn.setdefault(c.fn, []).append(c)
        for fn, lst in by_fn.items():
            if len(lst) > self.cores:
                lst.sort(key=lambda c: c.last_used)
                for victim in lst[: len(lst) - self.cores]:
                    self.containers.remove(victim)
                    self.evictions += 1

    def _replenish_prewarm(self) -> None:
        """Stock OpenWhisk keeps the prewarm pool topped up."""
        n_prewarm = sum(1 for c in self.containers if c.fn is None)
        while (
            n_prewarm < self.prewarm_count
            and self._mem_used() + self.container_mb <= self.memory_mb
        ):
            self.containers.append(Container(fn=None, memory_mb=self.container_mb))
            n_prewarm += 1

    # -- warm-up (experiment protocol §V-A) -----------------------------------
    def warm_up(self, fns: list[str], per_fn: int, now: float = 0.0) -> None:
        """Pre-create ``per_fn`` warm containers for each function, as the
        experiment warm-up phase does (c parallel calls per function)."""
        # round-robin across functions so a tight pool still warms every fn
        for i in range(per_fn):
            for fn in fns:
                if self._mem_used() + self._size(fn) <= self.memory_mb:
                    self.containers.append(
                        Container(fn=fn, memory_mb=self._size(fn), last_used=now)
                    )
