"""Serving: slot-batched continuous decoding over a paged, prefix-shared KV
cache, and multi-host inference gangs (``serve.gang``, ``serve.frontend``).

The engine surface is exported lazily (a module ``__getattr__``): the gang's
control plane (``serve.gang``'s settings, ``serve.frontend``, the ``serve``
runtime in every executor of a serve job) imports this package and must load
neither torch nor numpy. ``from tony_tpu_torch.serve import Engine`` loads
the engine on first use.
"""

import importlib

_EXPORTS = {
    "BlockPool": "cache", "PagedKVCache": "cache", "create_cache": "cache",
    "grow_cache": "cache", "shrink_cache": "cache",
    "AdmissionRejected": "engine", "Completion": "engine", "Engine": "engine",
    "Request": "engine", "ServeConfig": "engine",
    "PrefixStore": "prefix",
}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


__all__ = sorted(_EXPORTS)
