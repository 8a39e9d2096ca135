"""Parameter trees across the package boundary: numpy <-> torch.

The reference's parameters are a pytree of stacked arrays
(``tony_tpu.models.llama.init_params``); ``jax.tree.map(np.asarray, params)``
turns it into nested dicts of numpy arrays, and :func:`params_from_numpy`
turns those into this package's tensors with the same keys, shapes and
dtypes. Every parity test carries weights across this way, because the two
frameworks' random generators give different numbers from one seed.
:func:`shards_from_numpy` gives a rank of a mesh its blocks of the same
tree, cut on the host by the rules' specs (``parallel/sharding.py``): the
MoE expert weights over ep and fsdp, the router over fsdp and ep.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, Params, logical_axes, param_shapes
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules, shard, tree_specs


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the caller's arrays stay untouched
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _check(tree: Any, shapes: Any, path: str) -> None:
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path or 'params'}: keys {got} != {sorted(shapes)}")
        for k in shapes:
            _check(tree[k], shapes[k], f"{path}.{k}" if path else k)
        return
    if tuple(np.shape(tree)) != tuple(shapes):
        raise ValueError(f"{path}: shape {np.shape(tree)} != {tuple(shapes)}")


def params_from_numpy(tree: Params, cfg: LlamaConfig,
                      device: str | torch.device | None = None) -> Params:
    """Nested dict of numpy arrays (the reference's parameter pytree) ->
    the same dict of tensors on ``device`` (``None`` means CUDA, and raises
    without it), dtypes kept. Raises ValueError when a key or shape does
    not match ``cfg``'s layout."""
    device = resolve_device(device)
    _check(tree, param_shapes(cfg), "")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, device)

    return conv(tree)


def shards_from_numpy(tree: Params, cfg: LlamaConfig, mesh, rules: Rules = DEFAULT_RULES,
                      device: str | torch.device | None = None) -> Params:
    """The reference's parameter tree (numpy) -> this rank's blocks of it
    under the rules' specs of ``logical_axes(cfg)`` over ``mesh``, on
    ``device`` (``None`` means CUDA, and raises without it). Each block is
    cut on the host, so the whole tree never reaches the device."""
    device = resolve_device(device)
    _check(tree, param_shapes(cfg), "")

    def conv(node, spec):
        if isinstance(node, dict):
            return {k: conv(v, spec[k]) for k, v in node.items()}
        return shard(_to_tensor(node, "cpu"), spec, mesh).to(device)

    return conv(tree, tree_specs(logical_axes(cfg), rules))


__all__ = ["params_from_numpy", "shards_from_numpy"]
