"""Device-memory observatory: phase watermarks, sampled memory counters,
OOM forensics. The port's counterpart of ``tony_tpu/obs/hbm.py``.

The raw device counter (the caching allocator's peak of allocated bytes)
is a cumulative per-process high-water mark: within one process a later
phase inherits every earlier phase's peak. :class:`HbmWatch` fixes the
attribution:

- ``phase(name)`` marks live + cumulative-peak bytes on entry and measures
  on exit. When the cumulative peak ADVANCED during the phase, the phase
  owns the new high-water mark exactly (``peak_exact: True``); when it
  stayed under an earlier phase's peak, the best honest bound is the larger
  of the entry/exit live readings (``peak_exact: False``).
- ``sample()`` is the hot-path seam (one global load + ``None`` compare
  when disarmed, stride-counted when armed): every ``sample_every``-th
  call reads per-device live/peak bytes, records them in a bounded history
  ring, updates registry gauges, and emits a counter-track row (``ph:
  "C"``) through the armed tracer. Reading the allocator's statistics is
  host bookkeeping: no device sync.
- :func:`oom_guard` wraps ``fit()`` and ``Engine.run``: a
  ``torch.cuda.OutOfMemoryError`` escaping the loop dumps the watermark/
  sample history and ``torch.cuda.memory_snapshot()`` (the allocator's
  segments and blocks, where the reference dumps the device memory
  profile) into ``<app_dir>/oom/`` before re-raising.

Readings come from ``torch.cuda.memory_stats`` (``bytes_in_use`` and
``peak_bytes_in_use`` are the allocated bytes, current and peak, as
``torch.cuda.max_memory_allocated`` reports them; ``bytes_limit`` is the
card's total from ``torch.cuda.mem_get_info``). Without CUDA there are no
readings, and every consumer treats that as "no data", as the reference
does on the CPU. There is no compile ledger: PyTorch runs eagerly.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import deque
from typing import Any, Callable

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process, next to TONY_TRACE_*)
ENV_ENABLED = "TONY_OBS_HBM"          # "0" disables arming
ENV_SAMPLE = "TONY_OBS_HBM_SAMPLE"    # sampling stride (calls per reading)
ENV_HISTORY = "TONY_OBS_HBM_HISTORY"  # sample-history ring size

GB = float(2**30)

# stats keys this module reads (the reference's memory_stats vocabulary)
_LIVE = "bytes_in_use"
_PEAK = "peak_bytes_in_use"
_LIMIT = "bytes_limit"


def default_stats_fn() -> list[tuple[str, dict]]:
    """Per-device readings as ``(label, stats)`` pairs, for each CUDA
    device this process has allocated on; an empty list (no CUDA, nothing
    allocated) means the platform has nothing to watch, which every
    consumer treats as "no data", never an error."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        peak = int(stats.get("allocated_bytes.all.peak", 0))
        if not peak:
            continue        # a device this process never allocated on
        _, total = torch.cuda.mem_get_info(i)
        out.append((f"dev{i}", {
            _LIVE: int(stats.get("allocated_bytes.all.current", 0)),
            _PEAK: peak,
            _LIMIT: int(total),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
            "num_ooms": int(stats.get("num_ooms", 0)),
        }))
    return out


class Phase:
    """One mark/measure window. Use as a context manager; ``result`` holds
    the per-device measurement after exit (``{}`` while still open)."""

    __slots__ = ("name", "args", "result", "_watch", "_t0", "_enter")

    def __init__(self, watch: "HbmWatch", name: str, args: dict[str, Any]):
        self._watch = watch
        self.name = name
        self.args = args
        self.result: dict[str, Any] = {}
        self._t0 = 0.0
        self._enter: dict[str, tuple[int, int]] = {}

    def __enter__(self) -> "Phase":
        self._t0 = time.perf_counter()
        self._enter = self._watch.mark()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.result = {
            "name": self.name,
            "ts": time.time(),
            "dur_s": round(time.perf_counter() - self._t0, 3),
            "devices": self._watch.measure_since(self._enter),
            **self.args,
        }
        self._watch._record_phase(self.result)
        return False

    def bench_keys(self) -> dict[str, Any]:
        """Device-0 watermarks as flat bench-JSON keys (``{}`` when the
        platform reports no stats)."""
        devices = self.result.get("devices", {})
        if not devices:
            return {}
        rec = next(iter(devices.values()))
        out = {
            "phase_peak_hbm_gb": round(rec["peak_bytes"] / GB, 3),
            "phase_delta_peak_gb": round(rec["delta_peak_bytes"] / GB, 3),
            "live_end_gb": round(rec["live_end_bytes"] / GB, 3),
            "peak_exact": rec["peak_exact"],
        }
        if "limit_bytes" in rec:
            out["hbm_limit_gb"] = round(rec["limit_bytes"] / GB, 2)
        return out


class HbmWatch:
    """Phase watermarks + stride-sampled per-device memory readings.

    ``stats_fn`` is pluggable (tests inject deterministic fakes; the
    default reads every local device's ``memory_stats``). The watch keeps
    a bounded phase list and sample-history ring — both land in the OOM
    forensics dump — and mirrors the newest reading into registry gauges
    (``tony_hbm_live_bytes`` / ``tony_hbm_peak_bytes``, labelled by
    device) and a tracer counter track when a tracer is armed."""

    def __init__(self, stats_fn: Callable[[], list] | None = None,
                 registry=None, sample_every: int = 16,
                 history: int = 512, max_phases: int = 256):
        self._stats_fn = stats_fn or default_stats_fn
        self._registry = registry
        self.sample_every = max(int(sample_every), 1)
        self.history: deque = deque(maxlen=max(int(history), 16))
        self.phases: deque = deque(maxlen=max(int(max_phases), 16))
        self._n = 0

    def read(self) -> list[tuple[str, dict]]:
        try:
            return list(self._stats_fn())
        except Exception:
            return []

    def phase(self, name: str, **args: Any) -> Phase:
        return Phase(self, name, dict(args))

    def mark(self) -> dict[str, tuple[int, int]]:
        """Per-device (live, cumulative-peak) snapshot — the entry half of
        the mark/measure watermark (``Phase`` and the fit()/engine
        shutdown summaries share it)."""
        return {
            label: (int(stats.get(_LIVE, 0)), int(stats.get(_PEAK, 0)))
            for label, stats in self.read()
        }

    def measure_since(self, marks: dict[str, tuple[int, int]]
                      ) -> dict[str, dict[str, Any]]:
        """Scoped watermark since :meth:`mark`, per device. THE attribution
        rule this module exists for: a window that advanced the process's
        cumulative peak OWNS the new mark exactly (``peak_exact``); one
        that stayed under an earlier window's peak can only be bounded by
        its own live readings — never report the inherited number."""
        devices: dict[str, dict[str, Any]] = {}
        for label, stats in self.read():
            live1 = int(stats.get(_LIVE, 0))
            cum1 = int(stats.get(_PEAK, 0))
            live0, cum0 = marks.get(label, (live1, cum1))
            peak_exact = cum1 > cum0
            peak = cum1 if peak_exact else max(live0, live1)
            rec: dict[str, Any] = {
                "live_start_bytes": live0,
                "live_end_bytes": live1,
                "live_delta_bytes": live1 - live0,
                "peak_bytes": peak,
                "delta_peak_bytes": max(peak - live0, 0),
                "peak_exact": peak_exact,
            }
            if _LIMIT in stats:
                rec["limit_bytes"] = int(stats[_LIMIT])
            devices[label] = rec
        return devices

    def peak_since(self, marks: dict[str, tuple[int, int]]
                   ) -> tuple[float, bool]:
        """(peak GB, exact?) across devices since :meth:`mark` — the
        shutdown-summary form of :meth:`measure_since`; (0.0, False) when
        the platform reports no stats."""
        devices = self.measure_since(marks)
        if not devices:
            return 0.0, False
        top = max(devices.values(), key=lambda rec: rec["peak_bytes"])
        # the exact flag belongs to the device whose peak is reported — a
        # sibling device's bound must not downgrade an exact measurement
        return round(top["peak_bytes"] / GB, 3), top["peak_exact"]

    def _record_phase(self, result: dict) -> None:
        self.phases.append(result)

    def sample(self, **args: Any) -> dict | None:
        """Stride-counted reading; returns the sample dict on a stride hit,
        None otherwise. The off-stride cost is one increment + modulo."""
        self._n += 1
        if self._n % self.sample_every:
            return None
        return self.force_sample(**args)

    def force_sample(self, **args: Any) -> dict | None:
        """Read now regardless of stride (phase boundaries, shutdown)."""
        readings = self.read()
        if not readings:
            return None
        sample: dict[str, Any] = {"ts": time.time(), **args}
        from tony_tpu_torch.obs import trace

        tracer = trace.active_tracer()
        for label, stats in readings:
            live = int(stats.get(_LIVE, 0))
            peak = int(stats.get(_PEAK, 0))
            sample[label] = {"live_bytes": live, "peak_bytes": peak}
            if self._registry is not None:
                self._set_gauges(self._registry, label, live, peak)
            if tracer is not None:
                # one counter track per device: Perfetto renders each args
                # series as a line on the memory timeline
                tracer.counter(
                    f"hbm.{label}",
                    live_gb=round(live / GB, 4),
                    peak_gb=round(peak / GB, 4),
                )
        self.history.append(sample)
        return sample

    @staticmethod
    def _set_gauges(registry, label: str, live: int, peak: int) -> None:
        registry.gauge(
            "tony_hbm_live_bytes", "device HBM bytes in use", device=label,
        ).set(live)
        registry.gauge(
            "tony_hbm_peak_bytes", "device cumulative peak HBM bytes",
            device=label,
        ).set(peak)

    def export_gauges(self, registry) -> None:
        """Write a fresh reading's per-device gauges into ``registry`` —
        fit() and the engine call this right before their shutdown
        snapshot, so ``tony_hbm_*`` lands in the job-history metrics the
        portal's ``/metrics`` endpoint serves (the watch's own registry is
        the process-global one, which nothing snapshots)."""
        for label, stats in self.read():
            self._set_gauges(
                registry, label,
                int(stats.get(_LIVE, 0)), int(stats.get(_PEAK, 0)),
            )

    def to_dict(self) -> dict:
        """Everything the forensics dump wants: phases + sample history +
        a fresh reading."""
        return {
            "sample_every": self.sample_every,
            "phases": list(self.phases),
            "history": list(self.history),
            "current": {label: stats for label, stats in self.read()},
        }


# --- process-global arming (the trace.py pattern) ----------------------------

_watch: HbmWatch | None = None


def active_watch() -> HbmWatch | None:
    return _watch


def install(watch: HbmWatch) -> HbmWatch:
    global _watch
    _watch = watch
    return watch


def uninstall() -> None:
    global _watch
    _watch = None


def sample() -> None:
    """The hot-path seam (train/serve step loops). Disarmed: one global
    load + ``None`` compare. Call sites must pass no computed arguments
    (graft-lint GL005 enforces this like the trace/chaos hooks)."""
    w = _watch
    if w is not None:
        w.sample()


def install_from_env() -> HbmWatch | None:
    """Arm this process from the ``TONY_OBS_HBM*`` env the AM exported
    (defaults apply standalone — bench and bare fit() runs get watermarks
    without a job). Idempotent; ``TONY_OBS_HBM=0`` disables."""
    if _watch is not None:
        return _watch
    if os.environ.get(ENV_ENABLED, "") == "0":
        return None

    def _env_int(key: str, default: int) -> int:
        try:
            return int(os.environ.get(key, "") or default)
        except ValueError:
            return default

    from tony_tpu_torch.obs.registry import get_registry

    return install(HbmWatch(
        registry=get_registry(),
        sample_every=_env_int(ENV_SAMPLE, 16),
        history=_env_int(ENV_HISTORY, 512),
    ))


# --- OOM forensics -----------------------------------------------------------


def is_oom(exc: BaseException) -> bool:
    """True for the CUDA caching allocator's failure."""
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError)


def dump_oom(where: str, exc: BaseException,
             app_dir: str | None = None) -> list[str]:
    """Write the forensics bundle into ``<app_dir>/oom/`` and return the
    written paths. Best-effort by design: the process is dying of OOM, so
    every part is independently guarded and a failed part costs only
    itself."""
    app_dir = app_dir if app_dir is not None else os.environ.get("TONY_APP_DIR", "")
    if not app_dir:
        return []
    from tony_tpu_torch.obs import trace

    proc = trace.default_proc_name()
    out_dir = os.path.join(app_dir, "oom")
    try:
        os.makedirs(out_dir, exist_ok=True)
    except OSError:
        return []
    written: list[str] = []
    report: dict[str, Any] = {
        "where": where,
        "proc": proc,
        "ts": time.time(),
        "error": f"{type(exc).__name__}: {str(exc)[:2000]}",
    }
    watch = _watch
    if watch is not None:
        try:
            report["hbm"] = watch.to_dict()
        except Exception:
            pass
    else:
        report["hbm"] = {"current": dict(default_stats_fn())}
    path = os.path.join(out_dir, f"{proc}_{where}.json")
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report, f, default=str)
        written.append(path)
    except OSError:
        pass
    # the allocator's own view: every segment and block it holds, by
    # stream and state (torch.cuda.memory_snapshot), the "what exactly is
    # resident" answer no watermark has
    try:
        import torch

        snap = torch.cuda.memory_snapshot()
        spath = os.path.join(out_dir, f"{proc}_{where}.memsnap.json")
        with open(spath, "w", encoding="utf-8") as f:
            json.dump(snap, f, default=str)
        written.append(spath)
    except Exception:
        pass
    if written:
        log.error("OOM in %s: forensics written to %s", where, out_dir)
    return written


@contextlib.contextmanager
def oom_guard(where: str):
    """Re-raising out-of-memory handler: the forensics bundle lands
    in the app dir (where the chaos post-mortem flow picks it up) and the
    exception continues to the caller unchanged."""
    try:
        yield
    except BaseException as e:  # noqa: B036 — inspect, dump, ALWAYS re-raise
        if is_oom(e):
            dump_oom(where, e)
        raise


def forensics_files(app_dir: str) -> list[str]:
    """OOM bundle filenames under an app dir (the chaos runner lists these
    in its post-mortem report)."""
    out_dir = os.path.join(app_dir, "oom")
    try:
        return sorted(os.listdir(out_dir))
    except OSError:
        return []


__all__ = [
    "ENV_ENABLED", "ENV_HISTORY", "ENV_SAMPLE", "HbmWatch", "Phase",
    "active_watch", "default_stats_fn", "dump_oom", "forensics_files",
    "install", "install_from_env", "is_oom", "oom_guard", "sample",
    "uninstall",
]
