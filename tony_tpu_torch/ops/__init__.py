"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, built with nvcc at
first use), each beside its plain PyTorch version for CPU tensors, and the
chunked CE head (the scan head in plain PyTorch, the pallas head on its
kernels)."""

from tony_tpu_torch.ops.attention import flash_attention
from tony_tpu_torch.ops.decode_attention import LAUNCHES, decode_attention

__all__ = ["LAUNCHES", "decode_attention", "flash_attention"]
