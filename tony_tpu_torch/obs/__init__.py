"""Serving counters and training throughput/MFU accounting (the
observability spine is not ported yet)."""

from tony_tpu_torch.obs.metrics import DecodeMetrics, StepTimer, chip_peak_flops

__all__ = ["DecodeMetrics", "StepTimer", "chip_peak_flops"]
