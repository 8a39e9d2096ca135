"""Model families: Llama decoder configuration, training forward, KV-cache
forward and generation."""

from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.generate import KVCache, forward_with_cache, generate
from tony_tpu_torch.models.llama import LlamaConfig, forward, init_params, loss_fn

__all__ = [
    "KVCache",
    "LlamaConfig",
    "forward",
    "forward_with_cache",
    "generate",
    "init_params",
    "loss_fn",
    "params_from_numpy",
]
