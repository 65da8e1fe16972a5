"""Named axes over the ranks of a ``torch.distributed`` world.

Counterpart of ``autoawq_tpu/parallel/mesh.py`` (``build_mesh`` :26-53).
JAX builds a ``jax.sharding.Mesh`` and lets GSPMD place the collectives;
the port has no partitioner, so a :class:`Mesh` names each rank's
coordinates and one process group per axis, and the port's code calls the
collectives itself (``parallel/distributed.py``).

Axes, in JAX's row-major order over the ranks (rank = ((data * pipe +
stage) * expert + expert_index) * tensor + tensor_index):

  data   - batch and calibration-sample parallelism (``AwqQuantizer(
           mesh=...)``, ``parallel/pipeline.py``)
  pipe   - GPipe stages (``parallel/pipeline.py``); in the mesh only when
           pipe > 1, as in JAX, so a (data, expert, tensor) mesh keeps its
           axes and its process groups
  expert - expert parallelism of stacked MoE experts
  tensor - Megatron tensor parallelism (column / row shards)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "expert", "tensor")
PIPE_AXES = ("data", "pipe", "expert", "tensor")


@dataclass(frozen=True)
class Axis:
    """One axis of a mesh as seen from this rank: its name, size, this
    rank's index along it and the process group of the ranks that differ
    only along it (None when no process group is initialized, which only a
    mesh of one rank has). Parameter trees carry these as their
    collective markers (``tp_psum``, ``tp_ep``, ...), where JAX's carry an
    axis name."""
    name: str
    size: int
    index: int
    group: Any = None


class Mesh:
    """The ranks of the world as a (data, [pipe,] expert, tensor) grid.
    ``shape`` maps each axis to its size, ``coords`` to this rank's index
    along it; :meth:`axis` returns the :class:`Axis` handle the collectives
    take, :meth:`neighbours` the global ranks beside this one along an axis
    (where a stage's point-to-point sends go)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, Any], rank: int = 0):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self._groups = dict(groups)
        self.rank = rank
        self.axis_names: Tuple[str, ...] = tuple(shape)

    def size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def axis(self, name: str) -> Axis:
        return Axis(name, self.size(name), self.index(name),
                    self._groups.get(name))

    def neighbours(self, name: str) -> Tuple[Optional[int], Optional[int]]:
        """(previous, next) global rank along ``name``: the ranks whose
        other coordinates are this rank's; None past either end."""
        stride = 1
        for a in reversed(self.axis_names):
            if a == name:
                break
            stride *= self.shape[a]
        i, n = self.index(name), self.size(name)
        return (self.rank - stride if i > 0 else None,
                self.rank + stride if i < n - 1 else None)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def _coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Row-major coordinates of ``rank`` over the axes of ``sizes``, in
    their order (the last varies fastest)."""
    out = {}
    for name in reversed(tuple(sizes)):
        out[name] = rank % sizes[name]
        rank //= sizes[name]
    return {name: out[name] for name in sizes}


def build_mesh(tensor: int = 1, data: Optional[int] = None, expert: int = 1,
               pipe: int = 1) -> Mesh:
    """A (data, expert, tensor) mesh, or (data, pipe, expert, tensor) with
    pipe > 1, over the ranks of the initialized world
    (``parallel/distributed.initialize``), or over one rank when no
    process group is initialized. ``data`` defaults to whatever the other
    axes leave. Every rank must call this, in the same order as its other
    meshes: each axis's process groups are created collectively, axis by
    axis in the mesh's order. The errors for sizes that do not divide are
    JAX's."""
    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    if data is None:
        if n % (tensor * expert * pipe):
            raise ValueError(
                f"{n} devices not divisible by tensor={tensor} x "
                f"expert={expert} x pipe={pipe}")
        data = n // (tensor * expert * pipe)
    if data * tensor * expert * pipe != n:
        raise ValueError(f"mesh {data}x{pipe}x{expert}x{tensor} != {n} devices")
    rank = dist.get_rank() if ready else 0
    sizes = {"data": data, "pipe": pipe, "expert": expert, "tensor": tensor}
    sizes = {a: sizes[a] for a in (PIPE_AXES if pipe > 1 else AXES)}
    coords = _coords(rank, sizes)
    groups: Dict[str, Any] = {}
    for name in sizes:
        # the ranks that share every other coordinate, one list per line
        lines: Dict[Tuple, List[int]] = {}
        for r in range(n):
            c = _coords(r, sizes)
            key = tuple(c[a] for a in sizes if a != name)
            lines.setdefault(key, []).append(r)
        mine = tuple(coords[a] for a in sizes if a != name)
        if ready:
            for key, members in lines.items():  # collective: every rank
                g = dist.new_group(members)
                if key == mine:
                    groups[name] = g
    return Mesh(sizes, coords, groups, rank)
