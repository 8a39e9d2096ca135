"""Serving: slot-batched continuous decoding over a paged, prefix-shared KV
cache."""

from tony_tpu_torch.serve.cache import (
    BlockPool, PagedKVCache, create_cache, grow_cache, shrink_cache,
)
from tony_tpu_torch.serve.engine import (
    AdmissionRejected, Completion, Engine, Request, ServeConfig,
)
from tony_tpu_torch.serve.prefix import PrefixStore

__all__ = [
    "AdmissionRejected", "BlockPool", "Completion", "Engine",
    "PagedKVCache", "PrefixStore", "Request", "ServeConfig",
    "create_cache", "grow_cache", "shrink_cache",
]
