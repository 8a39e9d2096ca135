"""Serving counters (the observability spine is not ported yet)."""

from tony_tpu_torch.obs.metrics import DecodeMetrics

__all__ = ["DecodeMetrics"]
