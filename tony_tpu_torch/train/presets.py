"""Named training presets: model + mesh + batch recipes in one place.

The port's counterpart of ``tony_tpu/train/presets.py``: the north-star
recipe, plus the two recipes the card's checks train (``chip_smoke.py``),
so every caller shares one definition instead of copies drifting apart.
"""

from __future__ import annotations

import torch

from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.parallel.mesh import MeshShape


def north_star_7b_v4_32() -> tuple[LlamaConfig, MeshShape, int, int]:
    """The reference's north-star configuration: Llama-2-7B under ZeRO-3
    over ``fsdp=32`` (the reference's 32-chip slice), batch 32 x seq 4096,
    remat ``save_attn_kernel`` and flash attention.

    Returns ``(cfg, mesh_shape, global_batch, seq_len)``."""
    cfg = LlamaConfig.llama2_7b(
        dtype=torch.bfloat16,
        remat=True,
        remat_policy="save_attn_kernel",
        attention_impl="flash",
    )
    return cfg, MeshShape(fsdp=32), 32, 4096


def bench_1b4_recipe(**kw) -> LlamaConfig:
    """The dense training recipe of the reference's bench (``bench.py``'s
    ``dense_1b4_b8``, trained at batch 8 x seq 2048 with a bfloat16 first
    moment): bench_1b4, flash attention, remat ``save_attn_kernel`` and the
    scan CE head. ``kw`` overrides any field."""
    return LlamaConfig.bench_1b4(**{
        "attention_impl": "flash", "remat": True, "remat_policy": "save_attn_kernel",
        "ce_impl": "scan", **kw})


def bench_moe_recipe(**kw) -> LlamaConfig:
    """The MoE training recipe: the reference bench's ``grouped_pallas``
    variant of bench_moe with the preset's own 8 experts (flash attention,
    remat ``save_attn_kernel``, scan CE, the grouped dispatch through the
    grouped-matmul kernels at a 128-row group block, aux coefficient
    0.01). ``kw`` overrides any field."""
    return LlamaConfig.bench_moe(**{
        "attention_impl": "flash", "remat": True, "remat_policy": "save_attn_kernel",
        "ce_impl": "scan", "moe_dispatch": "grouped", "moe_gmm_impl": "pallas",
        "moe_group_block": 128, "moe_aux_coef": 0.01, **kw})


__all__ = ["bench_1b4_recipe", "bench_moe_recipe", "north_star_7b_v4_32"]
