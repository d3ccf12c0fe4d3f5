"""Profiler helper: a device trace around a block of work.

Counterpart of ``llmvox_tpu/utils/runtime.py``'s ``profile_trace``
(``jax.profiler.trace``), on ``torch.profiler``: the trace records the
host's ops and, on a card, the CUDA kernels (CUPTI), and is written as a
Chrome trace (``trace.json`` under ``out_dir``) that Perfetto or
``chrome://tracing`` loads.  JAX's ``annotate`` (``TraceAnnotation``) is
``utils/trace.py``'s ``span``: inside ``profile_trace`` each span is a
``record_function`` range in the trace.  JAX's
``enable_compilation_cache`` has no counterpart: the built kernels stay
in ``ops/build.py``'s directory, and CUDA graphs are captured at warmup.

    with profile_trace("trace_dir"):
        with trace.span("tts"):
            engine.tts("hello")
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Iterator, Optional

import torch

from llmvox_tpu_torch.utils import trace as tracing


@contextlib.contextmanager
def profile_trace(out_dir: Optional[str] = None) -> Iterator:
    """Profile the block and write ``<out_dir>/trace.json`` when it ends
    (``out_dir`` defaults to a fresh temporary directory); the device's
    kernels are in it when a card is present.  Yields the
    ``torch.profiler.profile``, whose ``trace_path`` names the file once
    the block has ended."""
    out_dir = out_dir or tempfile.mkdtemp(prefix="llmvox_trace_")
    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.trace_path = os.path.join(out_dir, "trace.json")
    with prof, tracing.profiling():
        yield prof
    prof.export_chrome_trace(prof.trace_path)
