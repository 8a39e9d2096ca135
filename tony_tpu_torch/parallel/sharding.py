"""Logical-axis sharding rules, and a rank's blocks of a tensor.

The counterpart of ``tony_tpu/parallel/sharding.py``: models name every
tensor dimension logically (``models.llama.logical_axes``), a rules table
maps logical names to mesh axes, and :func:`spec_for` turns a tuple of
names into a spec, one entry per dimension: None (replicated), a mesh axis,
or a tuple of mesh axes (the dimension split over their product, the first
outermost), as a ``jax.sharding.PartitionSpec`` holds them.

Where the reference places a ``NamedSharding`` and lets XLA move the
blocks, the port keeps each rank's block itself: :func:`shard` cuts it out
of a full tensor by the spec and :func:`unshard` all-gathers it back. Only
even blocks are cut: a dimension its axes do not divide raises (GSPMD would
pad it).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.mesh import Mesh

# logical dimension name -> mesh axis (or tuple of axes, or None = replicate)
Rules = Mapping[str, "str | tuple[str, ...] | None"]
Spec = tuple  # per dimension: None, a mesh axis, or a tuple of mesh axes

# The reference's rules for a Megatron-sharded decoder transformer + FSDP:
#   - "embed"  (model dim)        sharded over fsdp  (ZeRO-style param shard)
#   - "heads"/"ffn" (wide dims)   sharded over tp
#   - "vocab"  sharded over tp    (output projection column-parallel)
#   - "batch"  over dp+fsdp+ep, "seq" over sp (activations)
#   - "expert" over ep
#   - "layers" replicated
DEFAULT_RULES: Rules = {
    "batch": ("dp", "fsdp", "ep"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "ffn": "tp",
    "vocab": "tp",
    "expert": "ep",
    "layers": None,
    "head_dim": None,
    "norm": None,
}


def spec_for(logical_axes: tuple[str | None, ...], rules: Rules = DEFAULT_RULES) -> Spec:
    """Translate a tuple of logical axis names into a spec."""
    parts = []
    used: set[str] = set()
    for name in logical_axes:
        axis = rules.get(name) if name is not None else None
        # a mesh axis may appear at most once in a spec; later dims replicate
        if axis is None:
            parts.append(None)
        elif isinstance(axis, tuple):
            fresh = tuple(a for a in axis if a not in used)
            used.update(fresh)
            parts.append(fresh if fresh else None)
        elif axis in used:
            parts.append(None)
        else:
            used.add(axis)
            parts.append(axis)
    return tuple(parts)


def overlap_gather_dim(
    logical_axes: tuple[str | None, ...],
    rules: Rules = DEFAULT_RULES,
    mesh_axis: str = "fsdp",
) -> int | None:
    """Which positional dim of a weight the rules shard over ``mesh_axis``
    — the dim the decomposed all-gather-matmul ring rotates
    (``ops/overlap.py``). None when the weight carries no shard on that
    axis or more than one dim maps to it."""
    dims = []
    for i, name in enumerate(logical_axes):
        axis = rules.get(name) if name is not None else None
        axes = axis if isinstance(axis, tuple) else (axis,)
        if mesh_axis in axes:
            dims.append(i)
    return dims[0] if len(dims) == 1 else None


def _is_leaf(x: Any) -> bool:
    return isinstance(x, tuple)


def tree_specs(logical_tree: Any, rules: Rules = DEFAULT_RULES) -> Any:
    """Map a nested dict of logical-axes tuples to the same dict of specs."""
    if _is_leaf(logical_tree):
        return spec_for(logical_tree, rules)
    return {k: tree_specs(v, rules) for k, v in logical_tree.items()}


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block(mesh: Mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of a dimension split
    over ``axes``, the first outermost."""
    idx, count = 0, 1
    for a in axes:
        ax = mesh.axis(a)
        idx, count = idx * ax.size + ax.index, count * ax.size
    return idx, count


def local_shape(shape: tuple[int, ...], spec: Spec, mesh: Mesh) -> tuple[int, ...]:
    """The shape of a rank's block of a tensor of ``shape``; raises when a
    split dimension is not a multiple of its blocks."""
    out = []
    for i, (n, entry) in enumerate(zip(shape, _padded(spec, len(shape)))):
        _, count = _block(mesh, _entry_axes(entry))
        if n % count:
            raise ValueError(f"dim {i} of {tuple(shape)} ({n}) is not a multiple of its "
                             f"{count} blocks over {entry}: the port cuts even blocks only")
        out.append(n // count)
    return tuple(out)


def _padded(spec: Spec, ndim: int) -> tuple:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``: a
    contiguous copy, or ``t`` itself where every dimension is whole."""
    sizes = local_shape(tuple(t.shape), spec, mesh)
    out = t
    for dim, entry in enumerate(_padded(spec, t.ndim)):
        idx, count = _block(mesh, _entry_axes(entry))
        if count > 1:
            out = out.narrow(dim, idx * sizes[dim], sizes[dim])
    return out if out is t else out.contiguous()


def unshard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block (the inverse of
    :func:`shard`): all-gathered along each split dimension, innermost
    axis first. Every rank of the split axes calls it."""
    out = t
    for dim, entry in enumerate(_padded(spec, t.ndim)):
        for a in reversed(_entry_axes(entry)):
            out = pdist.all_gather(out, mesh.axis(a), dim)
    return out


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """:func:`shard` over a nested dict, with a dict of specs of its
    layout."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard(tree, specs, mesh)


def unshard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """:func:`unshard` over a nested dict."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return unshard(tree, specs, mesh)


__all__ = ["DEFAULT_RULES", "Rules", "Spec", "local_shape", "overlap_gather_dim",
           "shard", "shard_tree", "spec_for", "tree_specs", "unshard", "unshard_tree"]
