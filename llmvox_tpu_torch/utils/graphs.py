"""CUDA graphs for the serving paths: static buffers, capture, replay.

The JAX engine runs a whole decode block as one compiled device program;
here a block is hundreds of eager launches, which leave the card idle
most of the time.  So every body that serving runs (a decode block, a
pool step, a speculative iteration, a codec bucket) is written as a
function of **static buffers**: its inputs are copied into device
tensors that live as long as the engine, and it writes its outputs, and
the next ``DecodeState``, into tensors of the same kind, in place.  On a
card ``StepGraph`` captures such a body once, at warmup, and each call
is one replay; on the CPU (or with ``graphs=False``) a call runs the body
directly.  The buffers and their aliasing are one code path on both.

Rules:
- Capture happens only in ``capture()``, which warmup calls: an eager
  pass on a side stream first (kernel builds, ``cudaFuncSetAttribute``,
  the cuBLAS, cuDNN and cuFFT handles and plans), then the capture into
  the device's one shared graph memory pool.  Bodies allocate nothing
  that outlives them, so the pool holds only intermediates, which are
  dead once a replay ends, and graphs may replay in any order (they
  serialise on the device's stream).
- Calling a body whose graph was not captured raises: no shape falls back
  to eager on the card, and nothing is captured while serving.
- The kernel wrappers count their launches in Python, which a replay
  does not run.  Each registers its counter (``register_counter``, as
  the decoder does ``SPEC_ITERATIONS``); a capture records how far each
  registered count moved, takes that back out, and every replay adds it
  again, so the counts read as if the body had run eagerly.

``CAPTURES`` and ``CAPTURE_S`` add up the captures of this process, and
``pool_bytes()`` reads what the graph pools hold.  A capture ends with
one replay: a graph's first launch uploads it to the device, which takes
longer than a replay, and it belongs to warmup, not to the first
request.  Graphs, unlike XLA executables, do not outlive the process.
"""
from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# every count a replay adds to: "module.attribute" -> (module, attribute,
# that counter's lock), filled by ``register_counter``
_COUNTERS: Dict[str, Tuple[object, str, threading.Lock]] = {}

CAPTURES = 0
CAPTURE_S = 0.0
_stats_lock = threading.Lock()
# per device: the shared graph memory pool and the stream captures run on
_pools: Dict[torch.device, tuple] = {}


def register_counter(module: str, name: str, lock: threading.Lock) -> None:
    """Have every replay add to the int ``module.name`` (changed under
    ``lock``) what the body's capture added to it.  A kernel wrapper that
    counts its launches calls this at import, beside its counter."""
    _COUNTERS[f"{module}.{name}"] = (sys.modules[module], name, lock)


def counts() -> Dict[str, int]:
    """The current value of every registered counter."""
    return {k: getattr(m, a) for k, (m, a, _) in _COUNTERS.items()}


def _add(delta: Dict[str, int]) -> None:
    for k, d in delta.items():
        if d:
            mod, a, lock = _COUNTERS[k]
            with lock:
                setattr(mod, a, getattr(mod, a) + d)


def pool_bytes() -> Optional[int]:
    """Bytes the graph pools of this process hold now: the allocator's
    segments of each pool (None where the allocator does not name a
    segment's pool)."""
    if not _pools:
        return 0
    handles = {tuple(h) for h, _ in _pools.values()}
    total = 0
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        if tuple(seg["segment_pool_id"]) in handles:
            total += seg["total_size"]
    return total


def stats() -> Dict:
    """Captures of this process: count, seconds, graph pool bytes."""
    return {"graphs": CAPTURES, "capture_s": CAPTURE_S,
            "pool_bytes": pool_bytes()}


def summary() -> str:
    """One line on the captures so far, for warmup's report."""
    b = pool_bytes()
    return (f"CUDA graphs captured: {CAPTURES} in {CAPTURE_S:.2f} s, graph "
            f"pool {'not measured' if b is None else f'{b} bytes'}")


def settle() -> None:
    """End of a warmup: one full garbage collection now.  Warmup leaves
    many new objects and much garbage (old engines' cycles, their graphs),
    and Python's next full collection would otherwise fall due during the
    first requests, on whichever thread allocates, the event loop's too."""
    gc.collect()


def use_graphs(device: torch.device, graphs: Optional[bool]) -> bool:
    """The ``graphs`` keyword of the engines, the pool and the codec: None
    means on for a card and off for the CPU."""
    return device.type == "cuda" if graphs is None else bool(graphs)


def fill(static: torch.Tensor, host: np.ndarray) -> None:
    """Copy a host array into the head of a static device buffer: one
    copy, from pinned memory on a card, so it does not sync."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if static.is_cuda:
        t = t.pin_memory()
    static[:t.numel()].copy_(t, non_blocking=True)


def _pool(device: torch.device):
    if device not in _pools:
        with torch.cuda.device(device):
            _pools[device] = (torch.cuda.graph_pool_handle(),
                              torch.cuda.Stream(device))
    return _pools[device]


def _warm(body: Callable[[], None], device: torch.device) -> None:
    """One eager pass on the device's capture stream, as PyTorch's capture
    recipe asks (the libraries' workspaces for that stream exist then)."""
    side = _pool(device)[1]
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record(body: Callable[[], None], device: torch.device,
            generators: Sequence[torch.Generator] = ()):
    """Capture ``body`` into the device's shared graph pool.  Each of
    ``generators`` (device generators the body draws from) is registered
    with the graph first, so every replay advances it and draws new
    numbers."""
    handle, side = _pool(device)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator "
                "with a CUDA graph (CUDAGraph.register_generator_state); "
                "sampled decode needs it")
        graph.register_generator_state(gen)
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=handle,
                                                     stream=side):
        body()
    return graph


class StepGraph:
    """One body over static buffers, and the static outputs it writes:
    captured and replayed, or, without graphs, called directly."""

    __slots__ = ("body", "out", "device", "enabled", "graph", "delta",
                 "name", "upload_s", "generators")

    def __init__(self, body: Callable[[], None], out, device: torch.device,
                 enabled: bool, name: str = "",
                 generators: Sequence[torch.Generator] = ()):
        self.body, self.out, self.device = body, out, device
        self.enabled, self.graph, self.delta, self.name = (enabled, None,
                                                           None, name)
        self.upload_s = None   # host seconds of the first replay
        self.generators = tuple(generators)

    def capture(self) -> None:
        """Warm pass, capture, first replay; once.  Without graphs, one
        eager pass (it builds the kernels and warms the libraries'
        plans)."""
        global CAPTURES, CAPTURE_S
        if not self.enabled:
            self.body()
            return
        if self.graph is not None:
            return
        t0 = time.perf_counter()
        _warm(self.body, self.device)
        before = counts()
        graph = _record(self.body, self.device, self.generators)
        self.delta = {k: v - before.get(k, 0)
                      for k, v in counts().items()}
        _add({k: -d for k, d in self.delta.items()})
        t1 = time.perf_counter()
        graph.replay()
        _add(self.delta)
        _sync(self.device)
        self.upload_s = time.perf_counter() - t1
        self.graph = graph
        with _stats_lock:
            CAPTURES += 1
            CAPTURE_S += time.perf_counter() - t0

    def __call__(self):
        """Run the body (one replay on a card); returns its outputs."""
        if not self.enabled:
            self.body()
        elif self.graph is None:
            raise RuntimeError(f"CUDA graph {self.name} was not captured "
                               f"at warmup")
        else:
            self.graph.replay()
            _add(self.delta)
        return self.out


class GraphSet:
    """The StepGraphs of one path, by key (a block length, a (width,
    rung), a (batch, bucket)).  ``make(key)`` allocates the key's static
    buffers and returns ``(body, outputs)``.  With graphs, only
    ``capture`` (warmup) makes a key, and calling a key that was not
    captured raises; without graphs a key is made on first use."""

    def __init__(self, name: str, device: torch.device, enabled: bool,
                 make: Callable,
                 generators: Sequence[torch.Generator] = ()):
        self.name, self.device, self.enabled = name, device, enabled
        self.make = make
        self.generators = tuple(generators)
        self.graphs: Dict = {}
        self._lock = threading.Lock()

    def get(self, key) -> StepGraph:
        """The key's StepGraph (its ``out`` holds the static buffers to
        fill and read); made here only without graphs."""
        return self._get(key, not self.enabled)

    def _get(self, key, create: bool) -> StepGraph:
        with self._lock:
            g = self.graphs.get(key)
            if g is None:
                if not create:
                    raise RuntimeError(
                        f"{self.name}: no CUDA graph for {key!r}; warmup "
                        f"captured {sorted(self.graphs)}, and serving "
                        f"neither captures nor falls back to eager")
                body, out = self.make(key)
                g = self.graphs[key] = StepGraph(
                    body, out, self.device, self.enabled,
                    f"{self.name} {key!r}", self.generators)
            return g

    def capture(self, key) -> None:
        self._get(key, True).capture()
