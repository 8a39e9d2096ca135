"""Parameter trees across the package boundary: numpy <-> torch.

The reference's parameters are a pytree of stacked arrays
(``tony_tpu.models.llama.init_params``); ``jax.tree.map(np.asarray, params)``
turns it into nested dicts of numpy arrays, and :func:`params_from_numpy`
turns those into this package's tensors with the same keys, shapes and
dtypes. Every parity test carries weights across this way, because the two
frameworks' random generators give different numbers from one seed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, Params, param_shapes


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


__all__ = ["params_from_numpy"]
