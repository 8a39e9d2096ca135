"""Parallelism of the port. One device so far: the MoE FFN
(``parallel/moe.py``); meshes are not ported yet."""

from tony_tpu_torch.parallel.moe import (
    MoEConfig, init_moe_params, moe_block, routing_stats,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_block", "routing_stats"]
