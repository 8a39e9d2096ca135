"""Observability: the port's counterparts of ``tony_tpu/obs/``.

Ported: throughput/MFU accounting (``metrics``), the trace spine
(``trace``), the metrics registry (``registry``), the device-memory watch
(``hbm``), the numerics health sentinel (``health``), the live series and
the SLO engine (``series``, ``slo``), the profile controller and its
capture primitive (``profile``, ``profiler``), periodic stack traces
(``diagnostics``), the cross-run regression verdicts (``perf_diff``), the
device memory metrics and the process sampler (``device_metrics``, the
counterpart of ``tpu_metrics``; ``monitor``), the collective ledger
(``comms``), the step anatomy (``anatomy``), the pusher from a job's
user process to its AM (``reporter``), and the operator's read side: the
trace merge (``trace_tool``), ``tony top`` (``top``), the job-history
portal (``portal``) and the port-forwarding proxy (``proxy``). ``fit()``
and the serve ``Engine`` arm them from the env, the AM from the job's
config. ``compiles`` has no eager counterpart.

As in the reference, only the stdlib ``TaskMonitor`` is exported here:
``metrics`` imports torch, and the control-plane processes (AM, executor,
CLI) import this package and must not pay for torch or numpy. Every other
module is imported by its own name.
"""

from tony_tpu_torch.obs.monitor import TaskMonitor

__all__ = ["TaskMonitor"]
