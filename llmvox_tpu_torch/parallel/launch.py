"""Run a function on the ranks of a process group, one process each.

The training CLIs run under ``torchrun``; ``spawn`` is the same launch
from Python, for the tests (gloo ranks on the CPU) and ``chip_smoke.py``
(NCCL ranks, one a card, or gloo ranks sharing one card).  Each rank is
a fresh interpreter (the ``spawn`` start method: CUDA does not survive a
fork) that forms the group through a ``file://`` store in a directory of
its own, so concurrent launches never contend for a TCP port.

    results = spawn(fn, 2, arg, backend="gloo", devices=["cpu", "cpu"])

calls ``fn(rank, arg)`` on each rank after ``initialize_distributed`` and
returns the results in rank order.  A rank that raises fails the launch:
its traceback is re-raised here; a rank that does not answer within
``timeout_s`` fails it too, and every process is stopped.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

from llmvox_tpu_torch.parallel.mesh import initialize_distributed


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str,
               device: str, threads: int, timeout_s: float, args, out):
    try:
        import torch
        import torch.distributed as dist
        if threads:
            torch.set_num_threads(threads)
        initialize_distributed(init_method, rank, world, backend, device,
                               timeout_s=timeout_s)
        try:
            result = fn(rank, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          devices: Optional[Sequence[str]] = None, threads: int = 0,
          timeout_s: float = 300.0) -> List:
    """``fn(rank, *args)`` on ``world`` ranks; their results in rank
    order.  ``devices[r]`` is rank r's device (``cuda:i`` or ``cpu``; the
    CPU for all by default); ``threads`` caps each rank's intra-op
    threads (0 leaves torch's default)."""
    devices = list(devices or ["cpu"] * world)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="llmvox_ranks_")
    init = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, init, backend, devices[r], threads, timeout_s, args,
        out)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout_s
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} "
                                   f"did not answer within {timeout_s} s")
            try:
                r, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results[r] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
