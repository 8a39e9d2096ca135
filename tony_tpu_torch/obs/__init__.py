"""Observability: the port's counterparts of ``tony_tpu/obs/``.

Ported: throughput/MFU accounting (``metrics``), the trace spine
(``trace``), the metrics registry (``registry``), the device-memory watch
(``hbm``), the numerics health sentinel (``health``), the live series and
the SLO engine (``series``, ``slo``), the profile controller and its
capture primitive (``profile``, ``profiler``), periodic stack traces
(``diagnostics``), the cross-run regression verdicts (``perf_diff``), the
device memory metrics and the process sampler (``device_metrics``, the
counterpart of ``tpu_metrics``; ``monitor``), the collective ledger
(``comms``) and the step anatomy (``anatomy``). ``fit()`` and the serve
``Engine`` arm them from the env. Still to come: the modules only a job's
application master or CLI reach, ``reporter``, ``portal``, ``top``,
``trace_tool``, ``proxy`` and ``trace.install_from_config`` (ROADMAP
queue 1, item 10). ``compiles`` has no eager counterpart.
"""

from tony_tpu_torch.obs.metrics import DecodeMetrics, StepTimer, chip_peak_flops

__all__ = ["DecodeMetrics", "StepTimer", "chip_peak_flops"]
