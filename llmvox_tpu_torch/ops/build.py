"""Build and load the port's CUDA kernels.

Each ``llmvox_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with ctypes.
Nothing is compiled when a module is imported: the first kernel call (or
``build_all()``) compiles every source that has no up-to-date library,
one ``nvcc`` per source, all started together.  Libraries go to
``build/llmvox_tpu_torch/`` at the root of the checkout, named by a hash
of the source, every shared header (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.
Without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "llmvox_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers():
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source without a current library, in parallel.
    Returns {stem: seconds} for the sources compiled by this call."""
    with _lock:
        todo = [s for s in sources() if not _lib_path(s).exists()]
        if not todo:
            return {}
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        seconds = {}
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            seconds[src.stem] = time.perf_counter() - t0
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out)   # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return seconds


def build_log(stem: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for the current build of ``csrc/<stem>.cu``."""
    return _lib_path(CSRC_DIR / f"{stem}.cu").with_suffix(".log").read_text()


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    lib = _libs.get(stem)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(stem)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(CSRC_DIR / f"{stem}.cu")))
                _libs[stem] = lib
    return lib
