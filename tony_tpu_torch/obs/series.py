"""Live fleet time-series: the flight recorder's *now* axis.

The observability stack so far is retrospective — registry metrics are
shutdown snapshots, traces merge post-hoc, health verdicts land at trip
time. A production orchestrator must also answer *what is happening now*:
per-host step progress, TTFT/queue-depth trends, HBM headroom — the feed
``tony top`` renders and the SLO engine (obs/slo.py) alerts on.

:class:`SeriesRecorder` holds the established disarmed-hook contract
(trace/hbm/health twins; graft-lint GL005, tests/test_perf_guard.py):

- :func:`sample` is the hot-path seam. Disarmed it is ONE global load +
  ``None`` compare; armed off-stride it is one counter bump. Every
  ``sample_steps``-th call *scrapes* the attached sources (cheap host-side
  dict builders — the engine's :meth:`~tony_tpu_torch.serve.engine.Engine.
  stats_snapshot`, fit()'s step/goodput closure) plus the built-in
  HBM/health readers into one flat point.
- The point is enqueued to a bounded queue drained by a daemon writer:
  JSON serialization and file I/O never land on the step loop. A full
  queue drops the point (counted in ``dropped``), never blocks.
- Points journal to ring-rotated ``series/<proc>.jsonl`` under the app
  dir (the trace.py retention scheme: at the size cap the journal rotates
  to ``<proc>.0.jsonl`` and the NEWEST window survives — disk stays
  bounded at ~2x ``obs.series.max_journal_mb``).
- Observers (the SLO engine) see each point on the writer thread — rule
  evaluation is asynchronous by construction, like the health sentinel.

Read paths (:func:`read_series`, :func:`fleet_rollup`) are deviceless and
shared by ``tony top``, the portal's ``/api/series`` endpoints, and tests
— ONE reader, one layout. Staleness is first-class: a dead host's frozen
series reports its ``age_s``, never masquerades as current.

The port's copy of ``tony_tpu/obs/series.py``; stdlib-only (its HBM and
health readers import the port's ``obs/hbm.py`` and ``obs/health.py``
lazily, at scrape time).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Callable

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process, next to TONY_TRACE_* /
# TONY_OBS_HBM* / TONY_OBS_HEALTH*)
ENV_ENABLED = "TONY_OBS_SERIES"              # "0" disables arming
ENV_SAMPLE = "TONY_OBS_SERIES_SAMPLE"        # scrape stride (steps)
ENV_JOURNAL_MB = "TONY_OBS_SERIES_JOURNAL_MB"  # journal rotation size


class SeriesRecorder:
    """Stride-scraped time-series journal over pluggable sources.

    ``attach(name, fn)`` registers a source: a callable returning a flat
    ``{key: number}`` dict (cheap host-side reads only — sources must
    never sync a device; the engine's ``stats_snapshot`` and fit()'s
    closure are the wired shapes). A scrape merges every source into one
    point ``{"ts": ..., **kwargs, **source_values}``; later sources win
    key collisions (rare by construction: sources own their key
    vocabularies).

    ``path=None`` records to the in-memory ring only (standalone fit()/
    engine runs outside a job still feed the SLO engine and tests).
    """

    def __init__(self, path: str | None, proc: str, *,
                 sample_every: int = 16, max_journal_mb: int = 16,
                 ring: int = 512, queue_size: int = 64):
        from tony_tpu_torch.obs import trace

        self.path = path
        self.proc = proc or trace.default_proc_name()
        self.sample_every = max(int(sample_every), 1)
        self.ring: deque = deque(maxlen=max(int(ring), 16))
        self.dropped = 0          # queue overflow (writer slower than scrapes)
        self._n = 0               # seam stride counter
        self._sources: dict[str, Callable[[], dict]] = {}
        self._observers: list[Callable[[dict], None]] = []
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._pending = 0
        self._closed = False
        self._max_bytes = max(int(max_journal_mb), 1) * 2**20
        self._written = 0
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # append-mode reopen (re-arm cycles, relaunch reusing a proc
            # name): count what's there or the 2x disk bound breaks
            self._f = open(path, "a", encoding="utf-8")
            self._written = self._f.tell()
        self._q: queue.Queue = queue.Queue(maxsize=max(int(queue_size), 4))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="tony-series"
        )
        self._thread.start()

    # --- sources / observers --------------------------------------------------

    def attach(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a scrape source (idempotent per name; last wins)."""
        with self._lock:
            self._sources[name] = fn

    def detach(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def add_observer(self, fn: Callable[[dict], None]) -> None:
        """``fn(point)`` runs on the WRITER thread for every recorded
        point — the SLO engine's async evaluation seam."""
        with self._lock:
            self._observers.append(fn)

    # --- hot path -------------------------------------------------------------

    def sample(self, **args: Any) -> dict | None:
        """Stride-counted scrape; returns the point on a stride hit, None
        otherwise. The off-stride cost is one increment + modulo."""
        self._n += 1
        if self._n % self.sample_every:
            return None
        return self.force_sample(**args)

    def force_sample(self, **args: Any) -> dict | None:
        """Scrape now regardless of stride (shutdown, tests)."""
        point: dict[str, Any] = {"ts": time.time(), **args}
        with self._lock:
            sources = list(self._sources.items())
        for _, fn in sources:
            try:
                vals = fn()
            except Exception:
                log.debug("series source failed", exc_info=True)
                continue
            if vals:
                point.update(vals)
        self._builtin_readers(point)
        self.ring.append(point)
        if self._stop.is_set():
            # closed recorder (a holder outliving an uninstall): the ring
            # still records, nothing enqueues toward the dead writer
            return point
        try:
            with self._lock:
                self._pending += 1
            self._q.put_nowait(point)
        except queue.Full:
            with self._lock:
                self._pending -= 1
                self.dropped += 1
        return point

    @staticmethod
    def _builtin_readers(point: dict[str, Any]) -> None:
        """HBM live/peak/limit (device 0) and the health verdict ride every
        point without per-caller wiring — the SLO engine's
        ``hbm_headroom_frac`` input and ``tony top``'s health column."""
        from tony_tpu_torch.obs import hbm, health

        watch = hbm.active_watch()
        if watch is not None:
            readings = watch.read()
            if readings:
                _, stats = readings[0]
                live = int(stats.get("bytes_in_use", 0))
                point["hbm_live_bytes"] = live
                point["hbm_peak_bytes"] = int(stats.get("peak_bytes_in_use", 0))
                limit = int(stats.get("bytes_limit", 0))
                if limit > 0:
                    point["hbm_limit_bytes"] = limit
                    point["hbm_headroom_frac"] = round(
                        max(1.0 - live / limit, 0.0), 4
                    )
        sentinel = health.active_sentinel()
        if sentinel is not None:
            point["health_tripped"] = 1.0 if sentinel.verdict == "tripped" else 0.0

    # --- writer thread --------------------------------------------------------

    def _worker(self) -> None:
        while True:
            try:
                point = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if point is None:  # close() sentinel
                return
            try:
                self._write_point(point)
                with self._lock:
                    observers = list(self._observers)
                for obs in observers:
                    try:
                        obs(point)
                    except Exception:
                        log.debug("series observer failed", exc_info=True)
            finally:
                with self._lock:
                    self._pending -= 1

    def _write_point(self, point: dict) -> None:
        if self._f is None:
            return
        line = json.dumps(point, separators=(",", ":"), default=str) + "\n"
        # the io lock EXISTS to serialize journal writes (writer thread vs
        # close); the scrape path never takes it — the queue decouples
        # them — so holding it across file I/O is the design, not a stall
        # hazard (the trace.py flush discipline). A write error costs the
        # point (counted in dropped), never the instrumented path.
        with self._io_lock:
            if self._closed:
                with self._lock:
                    self.dropped += 1
                return
            try:
                if self._written + len(line) > self._max_bytes:
                    self._rotate()  # graft-lint: disable=GL004
                self._written += len(line)
                self._f.write(line)  # graft-lint: disable=GL004
                self._f.flush()  # graft-lint: disable=GL004
            except OSError:
                with self._lock:
                    self.dropped += 1

    def _rotate(self) -> None:
        """Flight-recorder retention at the size cap (the trace.py scheme):
        the current journal becomes ``<proc>.0.jsonl`` and a fresh file
        starts — the NEWEST window survives, disk stays ~2x the cap."""
        try:
            self._f.close()
        except Exception:
            pass
        base, ext = os.path.splitext(self.path)
        os.replace(self.path, base + ".0" + ext)
        self._f = open(self.path, "w", encoding="utf-8")
        self._written = 0

    # --- lifecycle ------------------------------------------------------------

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Wait (bounded) until every enqueued point has been written and
        observed — shutdown calls this so a final scrape (and any SLO trip
        it causes) lands before the verdict files are read."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            if self._stop.is_set() and not self._thread.is_alive():
                return False  # writer gone; waiting cannot help
            time.sleep(0.005)
        return False

    def close(self, join_timeout_s: float = 2.0) -> None:
        self.drain(timeout_s=join_timeout_s)
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=max(join_timeout_s, 0.0))
        with self._io_lock:
            self._closed = True
            if self._f is not None:
                try:
                    self._f.close()
                except Exception:
                    pass


# --- process-global arming (the trace/hbm/health pattern) ---------------------

_recorder: SeriesRecorder | None = None


def active_recorder() -> SeriesRecorder | None:
    return _recorder


def install(recorder: SeriesRecorder) -> SeriesRecorder:
    global _recorder
    if _recorder is not None and _recorder is not recorder:
        _recorder.close()
    _recorder = recorder
    return recorder


def uninstall() -> None:
    global _recorder
    if _recorder is not None:
        _recorder.close()
        _recorder = None


def sample(**args: Any) -> None:
    """The hot-path seam (train/serve step loops). Disarmed: one global
    load + ``None`` compare. Call sites must pass precomputed names only
    (graft-lint GL005 enforces this like the trace/chaos/hbm/health hooks)."""
    r = _recorder
    if r is not None:
        r.sample(**args)


def install_from_env(proc: str = "") -> SeriesRecorder | None:
    """Arm this process from the ``TONY_OBS_SERIES*`` env the AM exported.
    Defaults apply standalone — a bare fit() or engine records to the
    in-memory ring (and feeds an armed SLO engine) without a job; under a
    job (TONY_APP_DIR) points journal to ``<app_dir>/series/<proc>.jsonl``.
    Idempotent; ``TONY_OBS_SERIES=0`` disables. Also wires the SLO engine
    (obs/slo.py) as an observer when ``TONY_SLO`` names active targets —
    ONE arming point for the live stack."""
    if _recorder is not None:
        return _recorder
    if os.environ.get(ENV_ENABLED, "") == "0":
        return None

    def _env_int(key: str, default: int) -> int:
        try:
            return int(os.environ.get(key, "") or default)
        except ValueError:
            return default

    from tony_tpu_torch.obs import trace

    proc = trace.sanitize_proc(proc) if proc else trace.default_proc_name()
    app_dir = os.environ.get("TONY_APP_DIR", "")
    path = os.path.join(app_dir, "series", f"{proc}.jsonl") if app_dir else None
    try:
        recorder = install(SeriesRecorder(
            path, proc,
            sample_every=_env_int(ENV_SAMPLE, 16),
            max_journal_mb=_env_int(ENV_JOURNAL_MB, 16),
        ))
    except OSError:
        log.warning("could not open series journal under %s", app_dir,
                    exc_info=True)
        return None
    from tony_tpu_torch.obs import slo

    slo.attach_from_env(recorder, proc=proc)
    return recorder


# --- read paths (tony top, portal, SLO forensics, tests) ----------------------


def read_series(series_dir: str,
                tail_bytes: int | None = None) -> dict[str, list[dict]]:
    """Per-process points under a ``series/`` dir (proc -> time-ordered
    points). Rotated windows (``<proc>.0.jsonl``) merge into the same
    process; torn trailing lines (a SIGKILLed writer) are skipped, not
    fatal. ONE reader for ``tony top``, ``/api/series``, and tests.

    ``tail_bytes`` bounds the read per file: seek that far from the end
    and drop the first (possibly partial) line. A live viewer redrawing
    every few seconds must not re-parse a journal sitting at its
    multi-MB rotation cap to render the last 120 points."""
    out: dict[str, list[dict]] = {}
    try:
        names = sorted(os.listdir(series_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        proc = name[:-len(".jsonl")]
        if proc.endswith(".0"):
            proc = proc[:-2]
        points = out.setdefault(proc, [])
        try:
            # binary mode: byte-offset seeks are only well-defined there,
            # and a partial UTF-8 sequence at the cut decodes leniently
            with open(os.path.join(series_dir, name), "rb") as f:
                if tail_bytes is not None:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    if size > tail_bytes:
                        f.seek(size - tail_bytes)
                        f.readline()  # drop the partial first line
                    else:
                        f.seek(0)
                for raw in f:
                    line = raw.decode("utf-8", errors="replace").strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail from a killed process
                    if isinstance(rec, dict):
                        points.append(rec)
        except OSError:
            continue
    for points in out.values():
        # two hosts' clocks can disagree; WITHIN a proc the journal is
        # append-ordered, so a stable sort on ts keeps skewed-but-ordered
        # windows intact instead of interleaving them wrongly
        points.sort(key=lambda p: float(p.get("ts", 0.0) or 0.0))
    return out


def freshness(app_dir: str, *, now: float | None = None) -> dict[str, dict]:
    """Per-proc journal freshness WITHOUT parsing the journals: file
    mtime is the last-write proxy (the writer flushes per point), size a
    rough volume signal. The fleet ``/api/series`` summary reads this —
    stat calls, not tens of MB of JSON per scrape."""
    now = time.time() if now is None else now
    out: dict[str, dict] = {}
    sdir = os.path.join(app_dir, "series")
    try:
        names = sorted(os.listdir(sdir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        proc = name[:-len(".jsonl")]
        if proc.endswith(".0"):
            proc = proc[:-2]
        try:
            st = os.stat(os.path.join(sdir, name))
        except OSError:
            continue
        rec = out.setdefault(proc, {"age_s": None, "bytes": 0})
        age = round(max(now - st.st_mtime, 0.0), 1)
        rec["age_s"] = age if rec["age_s"] is None else min(rec["age_s"], age)
        rec["bytes"] += st.st_size
    return out


def fleet_rollup(app_dir: str, *, tail: int = 120,
                 now: float | None = None) -> dict[str, Any]:
    """The app-level live view: per-proc series tails with explicit
    staleness. ``age_s`` is clamped at 0 — a clock-skewed host whose last
    point is "in the future" reports fresh, never a negative age (and
    never hides a genuinely stale sibling)."""
    now = time.time() if now is None else now
    # bounded per-file read: the ``tail`` newest points fit comfortably
    # in the tail window (points are small flat dicts), and a journal at
    # its multi-MB rotation cap must not be re-parsed per redraw
    procs = read_series(
        os.path.join(app_dir, "series"), tail_bytes=max(tail, 1) * 4096
    )
    out: dict[str, Any] = {"ts": now, "procs": {}}
    for proc, points in sorted(procs.items()):
        if not points:
            continue
        last = points[-1]
        last_ts = float(last.get("ts", 0.0) or 0.0)
        out["procs"][proc] = {
            "n": len(points),
            "last_ts": last_ts,
            "age_s": round(max(now - last_ts, 0.0), 1),
            "latest": {k: v for k, v in last.items() if k != "ts"},
            "points": points[-tail:],
        }
    return out


__all__ = [
    "ENV_ENABLED", "ENV_JOURNAL_MB", "ENV_SAMPLE", "SeriesRecorder",
    "active_recorder", "fleet_rollup", "freshness", "install",
    "install_from_env", "read_series", "sample", "uninstall",
]
