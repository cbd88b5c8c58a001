"""Stable priority queue for action calls (own copy of
``repro.core.queues``).

Replaces the invoker's simple FIFO queue (paper §IV-B).  The priority of a
request is computed once, at push time; ties are broken by push order so the
queue degenerates to exact FIFO under the FIFO policy.

``remove`` is O(1) amortised (an id -> entry map plus lazy-deletion
tombstones scrubbed at the next pop/peek): hedging-heavy straggler cells
cancel queued calls constantly, and the old linear heap scan made that an
O(n) hot path.
"""

from __future__ import annotations

import heapq
import itertools

from .request import Request


class PriorityQueue:
    """Min-heap of [priority, seq, request]; stable for equal priorities.

    Entries are mutable lists so a removed request can be tombstoned in
    place (``entry[2] = None``); the unique ``seq`` field makes comparisons
    never reach the request slot.  ``len``/truthiness count live entries
    only.
    """

    def __init__(self) -> None:
        self._heap: list[list] = []
        self._seq = itertools.count()
        self._by_id: dict[int, list] = {}    # req.id -> live heap entry
        self._live = 0

    def push(self, req: Request, priority: float) -> None:
        req.priority = float(priority)
        entry = [req.priority, next(self._seq), req]
        # same-id re-push (a stolen call re-enqueued) tracks the newest copy
        self._by_id[req.id] = entry
        heapq.heappush(self._heap, entry)
        self._live += 1

    def _scrub(self) -> None:
        while self._heap and self._heap[0][2] is None:
            heapq.heappop(self._heap)

    def pop(self) -> Request:
        self._scrub()
        if not self._heap:
            raise IndexError("pop from empty PriorityQueue")
        _, seq, req = heapq.heappop(self._heap)
        self._live -= 1
        entry = self._by_id.get(req.id)
        if entry is not None and entry[1] == seq:
            del self._by_id[req.id]
        return req

    def peek(self) -> Request:
        self._scrub()
        if not self._heap:
            raise IndexError("peek from empty PriorityQueue")
        return self._heap[0][2]

    def remove(self, req: Request) -> bool:
        """Remove a specific request (O(1) amortised); used for straggler
        cancellation.  Returns True if found."""
        entry = self._by_id.get(req.id)
        if entry is None:
            return False
        del self._by_id[req.id]
        entry[2] = None                     # tombstone; scrubbed lazily
        self._live -= 1
        return True

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0

    def __iter__(self):
        """Iterate live entries in heap (not sorted) order; inspection only."""
        return (e[2] for e in self._heap if e[2] is not None)
