"""Framework runtimes: per-framework cluster bootstrap adapters.

The port's copy of ``tony_tpu/runtime/``. ``pytorch`` is the first-class
runtime (its env contract is what ``parallel/dist.py`` forms the default
process group from); ``tensorflow``, ``horovod``, ``mxnet`` and
``generic`` are the reference's adapters as they are, and ``serve`` exports
the gang's env to the port's decode hosts (``serve/gang.py``). The port has
no ``jax`` runtime, and :func:`make_runtime` refuses it with the reference's
message for an unknown framework. ``elastic`` runs one process per rank
(``ElasticRuntime``: every member a rank of one group). ``torch_dist``
holds the counterparts of the reference's ``jax_tpu`` helpers that
``fit()`` reads.
"""

from tony_tpu_torch.runtime.base import Runtime, TaskIdentity
from tony_tpu_torch.runtime.frameworks import (
    ElasticRuntime,
    HorovodRuntime,
    MLGenericRuntime,
    MXNetRuntime,
    PyTorchRuntime,
    ServeRuntime,
    TFRuntime,
)
from tony_tpu_torch.runtime.torch_dist import in_tony_job, num_processes, process_id

_RUNTIMES = {
    cls.name: cls
    for cls in (TFRuntime, PyTorchRuntime, HorovodRuntime, MXNetRuntime, MLGenericRuntime,
                ElasticRuntime, ServeRuntime)
}


def make_runtime(framework: str) -> Runtime:
    """Runtime factory keyed by the ``application.framework`` config value."""
    try:
        return _RUNTIMES[framework]()
    except KeyError:
        raise ValueError(
            f"unknown framework {framework!r} (expected one of {sorted(_RUNTIMES)})"
        ) from None


__all__ = [
    "ElasticRuntime",
    "HorovodRuntime",
    "MLGenericRuntime",
    "MXNetRuntime",
    "PyTorchRuntime",
    "Runtime",
    "ServeRuntime",
    "TFRuntime",
    "TaskIdentity",
    "in_tony_job",
    "make_runtime",
    "num_processes",
    "process_id",
]
