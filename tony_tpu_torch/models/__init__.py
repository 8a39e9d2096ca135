"""Model families: Llama decoder configuration, KV-cache forward and
generation."""

from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.generate import KVCache, forward_with_cache, generate
from tony_tpu_torch.models.llama import LlamaConfig, init_params

__all__ = [
    "KVCache",
    "LlamaConfig",
    "forward_with_cache",
    "generate",
    "init_params",
    "params_from_numpy",
]
