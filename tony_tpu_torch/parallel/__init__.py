"""Parallelism of the port: the mesh over torch.distributed ranks
(``parallel/mesh.py``, its process groups and collectives in
``parallel/dist.py``), the logical-axis sharding rules
(``parallel/sharding.py``), the pipeline schedules over pp
(``parallel/pipeline.py``: GPipe and 1F1B) and the MoE FFN
(``parallel/moe.py``)."""

from tony_tpu_torch.parallel.mesh import (
    MESH_AXES, Mesh, MeshShape, build_mesh, get_default_mesh, set_default_mesh,
)
from tony_tpu_torch.parallel.moe import (
    MoEConfig, init_moe_params, moe_block, routing_stats,
)
from tony_tpu_torch.parallel.pipeline import (
    microbatch, pipeline_apply, pipeline_local, pipeline_train_1f1b, unmicrobatch,
)
from tony_tpu_torch.parallel.sharding import pp_rules

__all__ = ["MESH_AXES", "Mesh", "MeshShape", "MoEConfig", "build_mesh", "get_default_mesh",
           "init_moe_params", "microbatch", "moe_block", "pipeline_apply", "pipeline_local",
           "pipeline_train_1f1b", "pp_rules", "routing_stats", "set_default_mesh",
           "unmicrobatch"]
