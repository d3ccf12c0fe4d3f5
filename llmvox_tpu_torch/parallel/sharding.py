"""Data-parallel layouts over a mesh: which rows each device keeps.

Counterpart of the dp part of ``llmvox_tpu/parallel/sharding.py``.  A
``Sharding`` names, per mesh axis, the leading dimensions it splits, as a
JAX ``PartitionSpec`` does: ``P("dp")`` gives the device at dp index i
the i-th contiguous block of rows, in device order, and the devices along
the other axes the same block; ``P()`` gives every device all of it.
``blocks`` lists each device's index (a tuple of slices) in the mesh's
row-major device order, as ``jax.device_put(x, sharding)``'s
``addressable_shards`` hold them.  The tensor-parallel, FSDP and Llama
rules are still to port (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import itertools
from typing import List, NamedTuple, Sequence, Tuple

from llmvox_tpu_torch.parallel.mesh import DP_AXIS, SP_AXIS, Mesh


def dp_rows(n: int, index: int, parts: int) -> slice:
    """The ``index``-th of ``parts`` contiguous blocks of ``n`` rows
    (``n % parts == 0``, as GSPMD requires of an even split)."""
    if n % parts:
        raise ValueError(f"{n} rows do not split evenly over {parts}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


class Sharding(NamedTuple):
    """``spec[d]`` is the mesh axis that splits dimension d (None: not
    split); dimensions past the spec are not split."""
    mesh: Mesh
    spec: Tuple

    def blocks(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """Each device's index into an array of ``shape``, in the mesh's
        row-major device order."""
        names = self.mesh.axis_names
        sizes = self.mesh.devices.shape
        out = []
        for coord in itertools.product(*(range(s) for s in sizes)):
            idx = []
            for d, n in enumerate(shape):
                axis = self.spec[d] if d < len(self.spec) else None
                if axis is None:
                    idx.append(slice(0, n))
                else:
                    a = names.index(axis)
                    idx.append(dp_rows(n, coord[a], sizes[a]))
            out.append(tuple(idx))
        return out


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over dp."""
    return Sharding(mesh, (DP_AXIS,))


def batch_seq_sharding(mesh: Mesh) -> Sharding:
    """(B, T, ...) split over (dp, sp): the sequence-parallel trainer's
    input layout."""
    return Sharding(mesh, (DP_AXIS, SP_AXIS))
