"""Per-request latency tracing for the serving path: named point events
(first audio, end) and span durations (decode fetch, synthesis), exposed
by the server's ``/stats``."""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Trace:
    name: str
    t0: float = field(default_factory=time.perf_counter)
    events: List[tuple] = field(default_factory=list)
    durations: Dict[str, List[float]] = field(
        default_factory=lambda: defaultdict(list))

    def mark(self, event: str) -> float:
        """Record a point event at time-since-start; returns the offset (s)."""
        dt = time.perf_counter() - self.t0
        self.events.append((event, dt))
        return dt

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def first(self, event: str) -> Optional[float]:
        for e, dt in self.events:
            if e == event:
                return dt
        return None

    def summary(self) -> Dict[str, float]:
        out = {}
        for e, dt in self.events:
            out.setdefault(e, dt)
        for name, ds in self.durations.items():
            out[f"{name}_total"] = sum(ds)
            out[f"{name}_count"] = len(ds)
        return out


class _Span:
    def __init__(self, trace: Trace, name: str):
        self.trace, self.name = trace, name

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.durations[self.name].append(time.perf_counter() - self._t)
        return False
