"""TaskMonitor: the process-tree resource sampler. The port's copy of
``tony_tpu/obs/monitor.py``.

A sampler an executor runs beside the user process: cpu% and RSS of the
process tree from /proc (stdlib only, no psutil), and whatever
``extra_sources`` add. On a card, the device numbers come from
``obs/device_metrics.py``'s :func:`~tony_tpu_torch.obs.device_metrics.
device_memory_samples`, which only the process that owns the card can
read (the reference reads its TPU runtime's ``memory_stats`` the same
way); step-level throughput and MFU come from the trainer's pushes.
"""

from __future__ import annotations

import os
import time

# name, value, unix-seconds — matches rpc MetricSample
Sample = tuple[str, float, float]

_CLK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _proc_stat_jiffies(pid: int) -> float:
    """utime+stime (+children) of a process, in clock ticks."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().rsplit(") ", 1)[-1].split()
        # fields after comm: state is parts[0]; utime=parts[11], stime=parts[12]
        return float(parts[11]) + float(parts[12])
    except (OSError, IndexError, ValueError):
        return 0.0


def _proc_rss_bytes(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return float(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        return 0.0


def _children(pid: int) -> list[int]:
    """Direct + transitive children via /proc/<pid>/task/*/children."""
    out, stack = [], [pid]
    while stack:
        p = stack.pop()
        try:
            for tid in os.listdir(f"/proc/{p}/task"):
                path = f"/proc/{p}/task/{tid}/children"
                try:
                    with open(path) as f:
                        kids = [int(c) for c in f.read().split()]
                except OSError:
                    continue
                out.extend(kids)
                stack.extend(kids)
        except OSError:
            continue
    return out


class TaskMonitor:
    """Samples this process tree's cpu%/rss; extend via ``extra_sources``
    (``device_metrics.device_memory_samples`` in the process that owns the
    card)."""

    def __init__(self, pid: int | None = None, extra_sources: list | None = None):
        self.pid = pid or os.getpid()
        self._last_jiffies = 0.0
        self._last_t = 0.0
        self.extra_sources: list = list(extra_sources or [])

    def sample(self) -> list[Sample]:
        now = time.time()
        pids = [self.pid, *_children(self.pid)]
        jiffies = sum(_proc_stat_jiffies(p) for p in pids)
        rss = sum(_proc_rss_bytes(p) for p in pids)
        samples: list[Sample] = [("rss_mb", rss / 1e6, now)]
        if self._last_t > 0 and now > self._last_t:
            cpu = (jiffies - self._last_jiffies) / _CLK / (now - self._last_t) * 100
            samples.append(("cpu_percent", max(cpu, 0.0), now))
        self._last_jiffies, self._last_t = jiffies, now
        for source in self.extra_sources:
            try:
                samples.extend(source())
            except Exception:
                pass
        return samples


__all__ = ["Sample", "TaskMonitor"]
