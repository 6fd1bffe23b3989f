"""Deterministic discrete-event engine (heap-ordered, cancellable).

Port of ``repro.cluster.events``: framework-free, a copy. Events at the
same time fire in scheduling order (the ``itertools.count()`` tie-break),
as in the reference, so both packages replay a trace event for event.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass(order=True)
class Event:
    t: float
    seq: int
    fn: Callable = field(compare=False)
    cancelled: bool = field(default=False, compare=False)

    def cancel(self):
        self.cancelled = True


class EventLoop:
    def __init__(self):
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.processed = 0

    def schedule(self, t: float, fn: Callable) -> Event:
        if t < self.now:
            t = self.now
        ev = Event(t=t, seq=next(self._seq), fn=fn)
        heapq.heappush(self._heap, ev)
        return ev

    def schedule_in(self, dt: float, fn: Callable) -> Event:
        return self.schedule(self.now + dt, fn)

    def run_one(self) -> bool:
        """Process exactly one (non-cancelled) event; False when empty."""
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.t
            self.processed += 1
            ev.fn()
            return True
        return False

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000):
        while self._heap and self.processed < max_events:
            if until is not None and self._heap[0].t > until:
                self.now = until
                return
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self.now = ev.t
            self.processed += 1
            ev.fn()
        if until is not None:
            self.now = max(self.now, until)

    @property
    def empty(self) -> bool:
        return not any(not e.cancelled for e in self._heap)
