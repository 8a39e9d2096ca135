"""Device memory metrics: the counterpart of ``tony_tpu/obs/tpu_metrics.py``.

The reference reads ``device.memory_stats()`` of each local TPU device;
here the caching allocator's statistics of each visible card give the
same three numbers under the reference's keys:

- ``hbm_mb``: ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``;
- ``hbm_peak_mb``: ``"allocated_bytes.all.peak"``;
- ``hbm_limit_mb``: the card's total memory, ``torch.cuda.mem_get_info()[1]``;

each in MB (1e6 bytes), with a ``_dev{i}`` suffix when the process sees
more than one card, as the reference suffixes its devices. A card this
process never allocated on is left out (reading its total would open a
context on it), as the reference leaves out a device without statistics.
Without a card
the source yields nothing (``[]``, ``{}``), as the reference's does where
``memory_stats`` is missing: there is no fallback.

Only the process that owns a card reads it: ``fit()`` adds
:func:`device_metrics_dict` to every metrics push, and a
:class:`~tony_tpu_torch.obs.monitor.TaskMonitor` in that process takes
:func:`device_memory_samples` among its ``extra_sources``.
"""

from __future__ import annotations

import time

import torch

from tony_tpu_torch.obs.monitor import Sample


def device_memory_samples() -> list[Sample]:
    """Memory samples for every visible card; [] without one."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    n = torch.cuda.device_count()
    now = time.time()
    out: list[Sample] = []
    for i in range(n):
        stats = torch.cuda.memory_stats(i)
        if not stats.get("allocated_bytes.all.peak"):
            continue            # a card this process never allocated on
        suffix = f"_dev{i}" if n > 1 else ""
        if "allocated_bytes.all.current" in stats:
            out.append((f"hbm_mb{suffix}", stats["allocated_bytes.all.current"] / 1e6, now))
        if "allocated_bytes.all.peak" in stats:
            out.append((f"hbm_peak_mb{suffix}", stats["allocated_bytes.all.peak"] / 1e6, now))
        out.append((f"hbm_limit_mb{suffix}", torch.cuda.mem_get_info(i)[1] / 1e6, now))
    return out


def device_metrics_dict() -> dict[str, float]:
    """Same numbers keyed for a metrics-dict push (fit()'s on_metrics)."""
    return {name: value for name, value, _ in device_memory_samples()}


__all__ = ["device_memory_samples", "device_metrics_dict"]
