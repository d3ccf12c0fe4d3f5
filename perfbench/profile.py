"""The traced sub-window: ``torch.profiler`` over the measured window's
last second or two, reduced in memory to what the per-layer
metrics read.  Nothing is exported, so a traced run writes no trace file.

The reduction keeps, for the device: the union of every operation's
interval (kernels, copies, sets) clipped to the sub-window (``busy_s``),
the time of each kernel name, and the idle gaps between the intervals,
each named by the host span (``system.Taps``) it overlaps most.
Only the device's activity is recorded (the host's spans come from the
harness): a served step replays CUDA graphs of hundreds of kernels, and
host events would add as many again.  The profiler's timestamps are
epoch nanoseconds; the offset to ``time.monotonic()``, read at the start,
aligns them with the harness's clock.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


class SubWindow:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.t0 = self.t1 = None
        self.offset_ns = 0

    @staticmethod
    def warm() -> None:
        """Start and stop a profiler once: the first start in a process
        pays the profiler's own set-up (seconds), which a traced run pays
        before its window."""
        w = SubWindow()
        w.prof.__enter__()
        w.prof.__exit__(None, None, None)

    def start(self) -> None:
        self.prof.__enter__()
        self.offset_ns = time.monotonic_ns() - time.time_ns()
        self.t0 = time.monotonic()

    def stop(self, at: Optional[float] = None) -> None:
        self.t1 = time.monotonic() if at is None else at
        self.prof.__exit__(None, None, None)

    def reduce(self, spans: Optional[List[Tuple]] = None) -> Dict:
        """``reduce_ops`` over the device's operations in the sub-window."""
        offset = self.offset_ns
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if (e.device_type() != torch.autograd.DeviceType.CUDA
                    or e.is_user_annotation()):
                continue
            a = (e.start_ns() + offset) * 1e-9
            ops.append((e.name(), a, a + e.duration_ns() * 1e-9))
        return reduce_ops(ops, self.t0, self.t1, spans or [])


def reduce_ops(ops, w0: float, w1: float, spans) -> Dict:
    """Device operations (name, start s, end s) and host spans (start,
    end, what), all on one clock, over the window [w0, w1]: {"window_s",
    "busy_s" (the union of the operations' intervals), "kernels" {name:
    s}, "device_ops" [(name, s)] the top 10, "idle_gaps" [(what the host
    was doing, s)] the 10 longest, "n_ops"}."""
    ivals: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ivals.append((a, b))
        by_name[name] += b - a
    ivals.sort()
    busy, gaps = 0.0, []
    last = w0
    for a, b in ivals:
        if a > last:
            gaps.append((last, a))
        if b > last:
            busy += b - max(a, last)
            last = b
    if w1 > last:
        gaps.append((last, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_host_doing(spans, a, b), b - a) for a, b in gaps[:10]]
    top = [(short_name(n), t) for n, t in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": w1 - w0, "busy_s": busy, "kernels": dict(by_name),
            "device_ops": top, "idle_gaps": named, "n_ops": len(ivals)}


def short_name(name: str, n: int = 120) -> str:
    """A kernel's name without its template arguments, at most ``n``
    characters."""
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)[:n]


def _host_doing(spans: List[Tuple], a: float, b: float) -> str:
    """The host span that overlaps [a, b] most, or what none does."""
    best, name = 0.0, "host: scheduler and event loop (no span)"
    for t0, t1, what in spans:
        ov = min(b, t1) - max(a, t0)
        if ov > best:
            best, name = ov, "host: " + what
    return name


def kernel_seconds(trace: Dict, patterns) -> float:
    """Device seconds of the kernels whose name holds any of
    ``patterns``."""
    return sum(s for n, s in trace["kernels"].items()
               if any(p in n for p in patterns))
