"""The device mesh over torch.distributed ranks.

The counterpart of ``tony_tpu/parallel/mesh.py``. The axes and their order
are the reference's (``MESH_AXES``: dp, pp, fsdp, ep, tp, sp, outermost
first). Where the reference lays devices into a ``jax.sharding.Mesh``, the
port lays the default group's ranks into the same shape, row-major in that
order (rank = the flat index of its coordinates), and gives each axis of
size above 1 a process group over the ranks that differ only along it
(:class:`~tony_tpu_torch.parallel.dist.Axis`). One rank is one device.

Training takes dp and fsdp. The other axes build, but the trainer refuses
them above 1 (tp, sp, pp and ep are ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch.distributed as dist

from tony_tpu_torch.parallel.dist import Axis, world

# Canonical axis order: slice-crossing / outermost first.
MESH_AXES = ("dp", "pp", "fsdp", "ep", "tp", "sp")


@dataclass(frozen=True)
class MeshShape:
    """Per-axis sizes. Product must equal the number of ranks used."""

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def sizes(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.ep, self.tp, self.sp)

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes)

    def __post_init__(self) -> None:
        for name, v in zip(MESH_AXES, self.sizes):
            if v < 1:
                raise ValueError(f"mesh axis {name!r} must be >= 1, got {v}")


def default_shape(n_devices: int, *, tp: int = 1, sp: int = 1) -> MeshShape:
    """FSDP-first default: all non-tp/sp parallelism goes to ``fsdp``."""
    if n_devices % (tp * sp):
        raise ValueError(f"{n_devices} devices not divisible by tp*sp={tp * sp}")
    return MeshShape(dp=1, fsdp=n_devices // (tp * sp), tp=tp, sp=sp)


class Mesh:
    """The ranks of the default group in ``MESH_AXES`` order, as this rank
    sees them: ``shape`` (axis -> size, like ``jax.sharding.Mesh.shape``),
    ``size``, this rank and one :class:`Axis` per name."""

    def __init__(self, shape: MeshShape, rank: int, axes: dict[str, Axis]):
        self.shape = dict(zip(MESH_AXES, shape.sizes))
        self.size = shape.n_devices
        self.rank = rank
        self._axes = axes

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def build_mesh(shape: MeshShape | None = None) -> Mesh:
    """A :class:`Mesh` over the default group's ranks (one rank without a
    group). ``shape`` defaults to ``default_shape(world size)`` and must
    use every rank: an undersized mesh leaves ranks with no place in it,
    which the reference refuses multi-host as well. Every rank calls this
    with the same shape: each axis's process groups are made collectively,
    in one order."""
    rank, size = world()
    if shape is None:
        shape = default_shape(size)
    if shape.n_devices != size:
        raise ValueError(f"mesh shape {shape.sizes} needs {shape.n_devices} ranks, "
                         f"the default group has {size}")
    grid = np.arange(size).reshape(shape.sizes)
    coords = np.unravel_index(rank, shape.sizes)
    axes = {}
    for i, name in enumerate(MESH_AXES):
        n = shape.sizes[i]
        if n == 1:
            axes[name] = Axis(name, 1, 0, (rank,), None)
            continue
        # one group per line along the axis: every other coordinate fixed
        for line in np.moveaxis(grid, i, -1).reshape(-1, n):
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks))
            if rank in ranks:
                axes[name] = Axis(name, n, int(coords[i]), ranks, group)
    return Mesh(shape, rank, axes)


# The mesh the model-level hooks (overlap_matmul) resolve against; fit()
# registers its mesh here, as the reference's fit() does.
_DEFAULT_MESH: Mesh | None = None
_MANUAL_DEPTH = 0


def set_default_mesh(mesh: Mesh | None) -> None:
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_default_mesh() -> Mesh | None:
    return _DEFAULT_MESH


@contextlib.contextmanager
def manual_region() -> Iterator[None]:
    """Mark code that already runs per rank over an axis's communication
    (a ring op, the counterpart of a shard_map manual region): an
    ``overlap_matmul`` inside it returns None instead of entering the ring
    again."""
    global _MANUAL_DEPTH
    _MANUAL_DEPTH += 1
    try:
        yield
    finally:
        _MANUAL_DEPTH -= 1


def inside_manual_region() -> bool:
    """True inside :func:`manual_region` (the reference's: inside a
    shard_map manual computation)."""
    return _MANUAL_DEPTH > 0


__all__ = ["MESH_AXES", "Mesh", "MeshShape", "build_mesh", "default_shape",
           "get_default_mesh", "inside_manual_region", "manual_region",
           "set_default_mesh"]
