"""Spans and counters of the serving path, on one clock.

One recorder per process, on ``time.monotonic_ns()`` (the clock
``perfbench/profile.py`` maps the card's trace onto):

- A span is a ``Span``: its name, start and end (ns), the thread's name,
  the request it serves (``REQUEST``, which the server sets and the
  request's tasks inherit), the pool step or LLM iteration it belongs to
  (``new_step``; a span without one takes its parent's), its own id, its
  parent's (the span open around it in the same task or thread) and an
  ``info``: what it is of (a graph's name, a dispatch job's owner, a
  request's marks).
- Spans are off until ``enable``.  Off, a site costs one check of
  ``ACTIVE`` and allocates nothing.  On, they go into a bounded buffer:
  ``drain`` takes every span recorded since the last drain, and a full
  buffer drops its oldest spans and counts them (``counters()``).
- A span submitted on one thread and run on another is a ``begin`` /
  ``end`` pair (``dispatched`` makes the dispatch thread's).
- Inside ``utils/runtime.profile_trace`` every span is also a
  ``torch.profiler.record_function`` range in its Chrome trace.
- Counters (``count``) are plain numbers, always on.
- ``Trace`` is one request's view: its id, its marks (``admitted``,
  ``first_text``, ``first_audio``, ``end``) and the seconds of its
  named waits, which the server's ``/stats`` keeps; with spans on its
  ``request`` span carries the marks.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    t0: int                 # ns, time.monotonic_ns()
    t1: int
    thread: str
    request: Optional[int]
    step: Optional[int]
    sid: int
    parent: Optional[int]
    info: object


CAPACITY = 1 << 20

# spans recorded or profiled: the one check a site makes
ACTIVE = False
_recording = False
_profiling = 0

REQUEST: contextvars.ContextVar = contextvars.ContextVar(
    "llmvox_request", default=None)
# (id, step) of the span open in this task or thread
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "llmvox_open_span", default=None)

# reentrant: a collection, and so the gc hook, may run at any bytecode
_lock = threading.RLock()
_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_steps = itertools.count(1)
_counts: Dict[str, float] = {"sched_rounds": 0, "sched_backlog": 0,
                             "spans_recorded": 0, "spans_dropped": 0}
_gc_t0: Optional[int] = None


def _set_active() -> None:
    global ACTIVE
    ACTIVE = _recording or _profiling > 0


def _append(span: Span) -> None:
    with _lock:
        if len(_buf) == _buf.maxlen:
            _counts["spans_dropped"] += 1
        _buf.append(span)
        _counts["spans_recorded"] += 1


def _gc_hook(phase: str, info: Dict) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.monotonic_ns()
    elif _gc_t0 is not None:
        _append(Span("gc", _gc_t0, time.monotonic_ns(),
                     threading.current_thread().name, None, None, next(_ids),
                     None, info.get("generation")))
        _gc_t0 = None


def enable() -> None:
    """Record spans from now on, into the buffer of ``CAPACITY`` spans, and
    every garbage collection as a ``gc`` span."""
    global _recording
    with _lock:
        if _gc_hook not in gc.callbacks:
            gc.callbacks.append(_gc_hook)
        _recording = True
        _set_active()


def disable() -> None:
    """Record no more spans; the buffer keeps what it holds."""
    global _recording
    with _lock:
        _recording = False
        _set_active()
        if _gc_hook in gc.callbacks:
            gc.callbacks.remove(_gc_hook)


def drain() -> List[Span]:
    """Every span recorded since the last drain, oldest first."""
    with _lock:
        out = list(_buf)
        _buf.clear()
    return out


@contextlib.contextmanager
def profiling():
    """Inside: every span is also a ``record_function`` range
    (``utils/runtime.profile_trace``)."""
    global _profiling
    with _lock:
        _profiling += 1
        _set_active()
    try:
        yield
    finally:
        with _lock:
            _profiling -= 1
            _set_active()


def count(name: str, n: float = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, float]:
    """The recorder's counters: the scheduler's rounds and text backlog,
    the spans recorded and dropped."""
    with _lock:
        return dict(_counts)


def new_step() -> Optional[int]:
    """A fresh step id for the spans of one pool step or LLM iteration
    (None while spans are off)."""
    return next(_steps) if ACTIVE else None


def detach() -> None:
    """Serve no request and sit under no span in the current task from
    here on (a pool's loops, which the first request's task starts)."""
    REQUEST.set(None)
    _OPEN.set(None)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    __slots__ = ("name", "info", "step", "sid", "parent", "t0", "token",
                 "range")

    def __init__(self, name: str, info, step: Optional[int]):
        self.name, self.info, self.step = name, info, step

    def __enter__(self):
        outer = _OPEN.get()
        self.parent = None
        if outer is not None:
            self.parent = outer[0]
            if self.step is None:
                self.step = outer[1]
        self.sid = next(_ids)
        self.token = _OPEN.set((self.sid, self.step))
        self.range = None
        if _profiling:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _OPEN.reset(self.token)
        if _recording:
            _append(Span(self.name, self.t0, t1,
                         threading.current_thread().name, REQUEST.get(),
                         self.step, self.sid, self.parent, self.info))
        return False


def span(name: str, info=None, step: Optional[int] = None):
    """A span around a ``with`` block on one task or thread."""
    if not ACTIVE:
        return _NULL
    return _Open(name, info, step)


def begin(name: str, info=None, step: Optional[int] = None):
    """The start of a span that ``end`` closes, maybe on another thread;
    None while spans are off."""
    if not _recording:
        return None
    outer = _OPEN.get()
    if step is None and outer is not None:
        step = outer[1]
    return (name, time.monotonic_ns(), REQUEST.get(), step, next(_ids),
            None if outer is None else outer[0], info)


def end(token) -> None:
    if token is None:
        return
    t1 = time.monotonic_ns()
    name, t0, req, step, sid, parent, info = token
    _append(Span(name, t0, t1, threading.current_thread().name, req, step,
                 sid, parent, info))


def dispatched(fn, owner: str, step: Optional[int]):
    """``fn`` as a job submitted now to another thread: a
    ``dispatch.wait`` span from now until the job starts there, then the
    job inside a ``dispatch.run`` span, both with ``owner`` as their info,
    in the submitter's request and under its open span."""
    outer = _OPEN.get()
    if step is None and outer is not None:
        step = outer[1]
    wait = begin("dispatch.wait", owner, step)
    req = REQUEST.get()

    def job(*args, **kwargs):
        end(wait)
        r, o = REQUEST.set(req), _OPEN.set(outer)
        try:
            with span("dispatch.run", owner, step):
                return fn(*args, **kwargs)
        finally:
            _OPEN.reset(o)
            REQUEST.reset(r)
    return job


class _Timed:
    """One named wait of a request: its seconds go to the request's
    totals, and, with spans on, it is a span."""

    __slots__ = ("trace", "key", "inner", "t0")

    def __init__(self, trace: "Trace", name: str, key: str):
        self.trace, self.key = trace, key
        self.inner = span(name)

    def __enter__(self):
        self.inner.__enter__()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self.trace.durations[self.key].append(
            (time.monotonic_ns() - self.t0) * 1e-9)
        return self.inner.__exit__(*exc)


class Trace:
    """One request: its id, its marks (the first time of each event, ns)
    and the seconds of its named waits."""

    def __init__(self, name: str, rid: Optional[int] = None):
        self.name, self.id = name, rid
        self.t0 = time.monotonic_ns()
        self.marks: Dict[str, int] = {}
        self.durations: Dict[str, List[float]] = collections.defaultdict(
            list)

    def mark(self, event: str) -> float:
        """Note ``event`` now, unless it was noted before; returns its
        time since the request began (s)."""
        t = self.marks.setdefault(event, time.monotonic_ns())
        return (t - self.t0) * 1e-9

    def first(self, event: str) -> Optional[float]:
        t = self.marks.get(event)
        return None if t is None else (t - self.t0) * 1e-9

    def span(self, name: str, key: str) -> _Timed:
        """Time a wait: its seconds go to ``key``'s total, and with spans
        on it is a span named ``name``."""
        return _Timed(self, name, key)

    def summary(self) -> Dict[str, float]:
        """What ``/stats`` keeps: the id, each mark in seconds since the
        request began (``admission_s`` is ``admitted``'s), and each wait's
        total seconds and count."""
        out: Dict[str, float] = {"id": self.id}
        for e in self.marks:
            out[e] = self.first(e)
        if "admitted" in out:
            out["admission_s"] = out["admitted"]
        for key, ds in self.durations.items():
            out[f"{key}_total"] = sum(ds)
            out[f"{key}_count"] = len(ds)
        return out
