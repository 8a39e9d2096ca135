"""Declarative SLO engine: multi-window burn-rate alerting over the series.

The ROADMAP's open items all name operational contracts — TTFT collapse,
goodput under preemption, slot-budget headroom — but nothing *watches*
them. This module is the SRE-shaped answer (multi-window burn rates,
Beyer et al., "Site Reliability Engineering" ch. 5 alerting): declare
targets as ``slo.*`` config keys, and the engine evaluates them over the
live time-series (obs/series.py) as points arrive.

Targets (0 / unset = not contracted; only nonzero targets are watched):

- ``slo.ttft_p99_s``       — windowed p99 TTFT must stay UNDER the target
- ``slo.step_time_p99_s``  — windowed p99 train-step time, ditto
- ``slo.goodput_floor``    — ``goodput_frac`` must stay ABOVE the floor
- ``slo.hbm_headroom_frac``— device HBM headroom must stay ABOVE the floor
- ``slo.error_rate``       — serve error fraction must stay UNDER the target

Burn-rate semantics: a point is *bad* when its metric violates the target.
Each SLO is evaluated over TWO windows — fast (``slo.fast_window_s``,
default 5m: catches an incident now) and slow (``slo.slow_window_s``,
default 1h: proves it is sustained, clipped to the data actually
recorded) — and trips only when the bad fraction exceeds the error budget
(``slo.budget_frac``) in BOTH, with at least ``min_points`` samples in the
fast window so a single blip cannot page. The reported ``burn`` is
``bad_frac / budget_frac`` (1.0 = exactly consuming budget).

A trip follows the health-sentinel latch pattern: it latches for the
engine's lifetime, emits an ``slo.<name>`` trace instant (flushed
immediately — survives a chaos SIGKILL), bumps
``tony_slo_trips_total{slo=}`` + ``tony_slo_verdict`` registry metrics,
writes ``<app_dir>/slo/verdict_<proc>.json``, and dumps a forensics
bundle (the series window at trip + the offending values) next to it.
``tony top`` renders the verdict column; the chaos invariant checker's
``slo-surfaced`` rule refuses to report a tripped run clean.

The port's copy of ``tony_tpu/obs/slo.py``: stdlib-only, evaluation on
the series recorder's writer thread. ``SloConfig.from_config`` reads the
reference's ``slo.*`` key names, spelled out here.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process): the resolved slo.* group
# as one JSON blob, so workers need no config-file round trip
ENV_SLO = "TONY_SLO"

# slo name -> (series point key, bad direction): "above" = a value above
# the target violates it, "below" = a value below the floor does
RULES: dict[str, tuple[str, str]] = {
    "ttft_p99_s": ("ttft_p99_s", "above"),
    "step_time_p99_s": ("step_time_p99_s", "above"),
    "goodput_floor": ("goodput_frac", "below"),
    "hbm_headroom_frac": ("hbm_headroom_frac", "below"),
    "error_rate": ("error_rate", "above"),
}


@dataclass(frozen=True)
class SloConfig:
    """Resolved ``slo.*`` key group (docs/OBS.md "SLO + time series")."""

    ttft_p99_s: float = 0.0
    step_time_p99_s: float = 0.0
    goodput_floor: float = 0.0
    hbm_headroom_frac: float = 0.0
    error_rate: float = 0.0
    budget_frac: float = 0.1
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    min_points: int = 3

    @classmethod
    def from_config(cls, config) -> "SloConfig":
        return cls(
            ttft_p99_s=config.get_float("slo.ttft_p99_s", 0.0),
            step_time_p99_s=config.get_float("slo.step_time_p99_s", 0.0),
            goodput_floor=config.get_float("slo.goodput_floor", 0.0),
            hbm_headroom_frac=config.get_float("slo.hbm_headroom_frac", 0.0),
            error_rate=config.get_float("slo.error_rate", 0.0),
            budget_frac=config.get_float("slo.budget_frac", 0.1),
            fast_window_s=config.get_float("slo.fast_window_s", 300.0),
            slow_window_s=config.get_float("slo.slow_window_s", 3600.0),
            min_points=config.get_int("slo.min_points", 3),
        )

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "SloConfig":
        return cls(**json.loads(blob))

    def active(self) -> list[str]:
        """The SLO names with a nonzero target — what the engine watches."""
        return [name for name in RULES if getattr(self, name) > 0]


class SloEngine:
    """Latching burn-rate evaluator over series points.

    ``observe(point)`` is the feed (the series recorder calls it from its
    writer thread — never the step loop). Points older than the slow
    window are evicted; each active SLO re-evaluates on every new point
    that carries its metric. Trips latch: one forensics bundle per cause,
    repeats counted but not re-reported (the health-sentinel discipline).
    """

    def __init__(self, cfg: SloConfig, *, registry=None,
                 app_dir: str | None = None, proc: str = ""):
        from tony_tpu_torch.obs import trace

        self.cfg = cfg
        self._registry = registry
        self.app_dir = (
            app_dir if app_dir is not None
            else os.environ.get("TONY_APP_DIR", "")
        )
        self.proc = proc or trace.default_proc_name()
        self._active = cfg.active()
        self._points: deque = deque()
        self._newest = 0.0
        self._trips: dict[str, int] = {}
        self._trip_detail: dict[str, dict] = {}
        self._lock = threading.Lock()

    # --- evaluation -----------------------------------------------------------

    def observe(self, point: dict[str, Any]) -> None:
        if not self._active:
            return
        ts = float(point.get("ts", 0.0) or time.time())
        self._points.append((ts, point))
        # evict by the NEWEST timestamp seen, not wall clock: replayed or
        # clock-skewed journals still window consistently
        newest = self._newest = max(self._newest, ts)
        horizon = newest - self.cfg.slow_window_s
        while self._points and self._points[0][0] < horizon:
            self._points.popleft()
        for name in self._active:
            if name in self._trips:
                with self._lock:
                    self._trips[name] += 1 if self._bad(name, point) else 0
                continue
            self._evaluate(name, newest)

    def _bad(self, name: str, point: dict[str, Any]) -> bool | None:
        """Whether one point violates the SLO; None when the point does
        not carry the metric (no data is never a violation)."""
        key, direction = RULES[name]
        v = point.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            return None
        target = getattr(self.cfg, name)
        return v > target if direction == "above" else v < target

    def _window_frac(self, name: str, since: float) -> tuple[int, int]:
        """(bad, total) over points carrying the metric since ``since``."""
        bad = total = 0
        for ts, point in self._points:
            if ts < since:
                continue
            verdict = self._bad(name, point)
            if verdict is None:
                continue
            total += 1
            bad += int(verdict)
        return bad, total

    def _evaluate(self, name: str, now: float) -> None:
        cfg = self.cfg
        fast_bad, fast_n = self._window_frac(name, now - cfg.fast_window_s)
        if fast_n < max(cfg.min_points, 1):
            return  # a blip (or an empty/single-sample window) never pages
        slow_bad, slow_n = self._window_frac(name, now - cfg.slow_window_s)
        budget = max(cfg.budget_frac, 1e-9)
        fast_frac = fast_bad / fast_n
        slow_frac = slow_bad / max(slow_n, 1)
        if fast_frac <= budget or slow_frac <= budget:
            return
        key, direction = RULES[name]
        offending = [
            point.get(key) for ts, point in self._points
            if ts >= now - cfg.fast_window_s and self._bad(name, point)
        ]
        self._trip(name, {
            "metric": key,
            "direction": direction,
            "target": getattr(cfg, name),
            "fast_bad_frac": round(fast_frac, 4),
            "slow_bad_frac": round(slow_frac, 4),
            "burn_fast": round(fast_frac / budget, 2),
            "burn_slow": round(slow_frac / budget, 2),
            "fast_points": fast_n,
            "slow_points": slow_n,
            "worst": (
                max(offending) if direction == "above" else min(offending)
            ) if offending else None,
        })

    # --- tripping (the health-sentinel latch pattern) -------------------------

    def _trip(self, name: str, detail: dict[str, Any]) -> None:
        with self._lock:
            if name in self._trips:
                return
            self._trips[name] = 1
            self._trip_detail[name] = {"ts": time.time(), **detail}
        log.error("SLO %r tripped: %s", name, detail)
        from tony_tpu_torch.obs import trace

        # precomputed args (GL005 discipline), flushed immediately so a
        # chaos SIGKILL racing the flusher cannot outrun the marker
        args = {
            k: v for k, v in detail.items()
            if isinstance(v, (int, float, str, bool)) or v is None
        }
        trace.instant(f"slo.{name}", **args)
        trace.flush()
        if self._registry is not None:
            self._export_into(self._registry)
        self._dump_bundle(name, detail)
        self.write_verdict()

    def _export_into(self, registry) -> None:
        with self._lock:
            trips = dict(self._trips)
        for name, n in trips.items():
            c = registry.counter(
                "tony_slo_trips_total",
                "SLO burn-rate trips (latched; counts repeat violations)",
                slo=name,
            )
            c.inc(n - c.value)
        registry.gauge(
            "tony_slo_verdict", "SLO verdict: 0 met, 1 tripped",
        ).set(1.0 if trips else 0.0)

    def export(self, registry) -> None:
        """Write ``tony_slo_*`` into ``registry`` (fit()/engine call this
        on their per-run registry before the shutdown snapshot, the
        health/hbm export pattern, so the portal ``/metrics`` serves it)."""
        self._export_into(registry)

    # --- forensics / verdict --------------------------------------------------

    def _slo_dir(self) -> str:
        return os.path.join(self.app_dir, "slo") if self.app_dir else ""

    def _dump_bundle(self, name: str, detail: dict[str, Any]) -> None:
        """One bundle per tripped SLO, written synchronously at trip time:
        the fast-window series slice that burned the budget plus the
        offending quantiles — the "what did the incident look like"
        evidence. Best effort: a full disk costs the bundle, not the run."""
        out_dir = self._slo_dir()
        if not out_dir:
            return
        now = time.time()
        # the window slices by the NEWEST point ts, exactly like
        # evaluation — a wall-clock filter would ship an empty bundle for
        # a skew-lagged or replayed feed (the very trip it documents)
        horizon = self._newest - self.cfg.fast_window_s
        window = [point for ts, point in self._points if ts >= horizon]
        bundle = {
            "slo": name,
            "ts": now,
            "proc": self.proc,
            "detail": detail,
            "config": asdict(self.cfg),
            "window": window[-256:],
        }
        path = os.path.join(out_dir, f"{self.proc}_{name}.trip.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
            os.replace(path + ".tmp", path)
        except OSError:
            log.warning("could not write SLO bundle %s", path, exc_info=True)

    def write_verdict(self) -> None:
        out_dir = self._slo_dir()
        if not out_dir:
            return
        with self._lock:
            payload = {
                "verdict": "tripped" if self._trips else "met",
                "proc": self.proc,
                "ts": time.time(),
                "watched": list(self._active),
                "slos": {
                    name: {"trips": n, **self._trip_detail.get(name, {})}
                    for name, n in self._trips.items()
                },
            }
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"verdict_{self.proc}.json")
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(path + ".tmp", path)
        except OSError:
            log.warning("could not write SLO verdict", exc_info=True)

    # --- reporting ------------------------------------------------------------

    @property
    def verdict(self) -> str:
        return "tripped" if self._trips else "met"

    def trip_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._trips)

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "verdict": "tripped" if self._trips else "met",
                "watched": list(self._active),
                "trips": dict(self._trips),
                "detail": dict(self._trip_detail),
            }


# --- process-global arming ----------------------------------------------------

_engine: SloEngine | None = None


def active_engine() -> SloEngine | None:
    return _engine


def install(engine: SloEngine) -> SloEngine:
    global _engine
    _engine = engine
    return engine


def uninstall() -> None:
    global _engine
    _engine = None


def attach_from_env(recorder, proc: str = "") -> SloEngine | None:
    """Wire an SLO engine onto a series recorder from the ``TONY_SLO`` env
    the AM exported. No active targets (or no env) = nothing installed —
    the recorder keeps journaling, nothing alerts. Idempotent."""
    if _engine is not None:
        return _engine
    blob = os.environ.get(ENV_SLO, "")
    if not blob:
        return None
    try:
        cfg = SloConfig.from_json(blob)
    except (ValueError, TypeError):
        log.warning("malformed %s env; SLO engine not armed", ENV_SLO)
        return None
    if not cfg.active():
        return None
    from tony_tpu_torch.obs.registry import get_registry

    engine = install(SloEngine(cfg, registry=get_registry(), proc=proc))
    recorder.add_observer(engine.observe)
    return engine


# --- read paths (CLI, portal, invariant checker) ------------------------------


def read_verdicts(app_dir: str) -> dict[str, dict]:
    """Per-process SLO verdicts under ``<app_dir>/slo/`` (proc -> payload).
    Deviceless read path shared by ``tony top``, the portal, and the chaos
    invariant checker — ONE reader, one layout."""
    sdir = os.path.join(app_dir, "slo")
    out: dict[str, dict] = {}
    try:
        names = sorted(os.listdir(sdir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("verdict_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(sdir, name), encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(payload, dict):
            out[payload.get("proc") or name[len("verdict_"):-5]] = payload
    return out


def forensics_files(app_dir: str) -> list[str]:
    sdir = os.path.join(app_dir, "slo")
    try:
        return sorted(n for n in os.listdir(sdir) if n.endswith(".trip.json"))
    except OSError:
        return []


def rollup(app_dir: str) -> dict[str, Any]:
    """Merged per-app SLO view (`tony top`'s status column): ``tripped``
    when ANY process tripped, ``met`` when at least one verdict exists and
    none tripped, ``unwatched`` otherwise (no targets configured, or the
    job predates the engine)."""
    verdicts = read_verdicts(app_dir)
    bundles = forensics_files(app_dir)
    tripped = {
        proc: v for proc, v in verdicts.items()
        if v.get("verdict") == "tripped"
    }
    slos: dict[str, int] = {}
    for v in tripped.values():
        for name, info in (v.get("slos") or {}).items():
            slos[name] = slos.get(name, 0) + int((info or {}).get("trips", 1) or 1)
    if tripped or bundles:
        verdict = "tripped"
    elif verdicts:
        verdict = "met"
    else:
        verdict = "unwatched"
    return {
        "verdict": verdict,
        "procs": verdicts,
        "slos": slos,
        "bundles": bundles,
    }


__all__ = [
    "ENV_SLO", "RULES", "SloConfig", "SloEngine", "active_engine",
    "attach_from_env", "forensics_files", "install", "read_verdicts",
    "rollup", "uninstall",
]
