"""Observability: the port's counterparts of ``tony_tpu/obs/``.

Ported: throughput/MFU accounting (``metrics``), the trace spine
(``trace``), the metrics registry (``registry``), the device-memory watch
(``hbm``), the numerics health sentinel (``health``), the live series and
the SLO engine (``series``, ``slo``), the profile controller and its
capture primitive (``profile``, ``profiler``) and periodic stack traces
(``diagnostics``). ``fit()`` and the serve ``Engine`` arm them from the
env. Still to come: ``perf_diff``, ``anatomy``, ``comms``, ``monitor`` and
``tpu_metrics`` (ROADMAP queue 1, item 6); the modules only a job's
application master or CLI reach, ``reporter``, ``portal``, ``top``,
``trace_tool``, ``proxy`` and ``trace.install_from_config`` (ROADMAP
queue 1, item 10). ``compiles`` has no eager counterpart.
"""

from tony_tpu_torch.obs.metrics import DecodeMetrics, StepTimer, chip_peak_flops

__all__ = ["DecodeMetrics", "StepTimer", "chip_peak_flops"]
