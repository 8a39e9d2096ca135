"""Counters / gauges / fixed-bucket histograms with Prometheus exposition.

The per-component accounting objects (StepTimer, DecodeMetrics) report
averages; a production serving/training plane needs *distributions* — p50
vs p99 TTFT are different operational stories. This registry is the shared
sink: instrumented code observes into named metrics, each process snapshots
its registry into ``<app_dir>/metrics/<proc>.json`` at shutdown (the job-
history record), and the portal's ``/metrics`` endpoint renders every
snapshot under its apps root in Prometheus text exposition format (0.0.4)
with ``app``/``proc`` labels, so a scrape of one portal covers the fleet.

Histograms are fixed-bucket (Prometheus-style, cumulative at render time):
``observe()`` is a bisect + two adds — cheap enough for per-step and
per-token paths — and ``quantile()`` interpolates within the bucket that
crosses the requested rank, which is exactly the precision a bucketed
histogram can honestly claim.

Metric name catalogue (docs/OBS.md): ``tony_step_time_seconds``,
``tony_ttft_seconds``, ``tony_tpot_seconds``, ``tony_decode_step_seconds``,
``tony_queue_depth``, ``tony_rpc_requests_total``, and friends.

The port's copy of ``tony_tpu/obs/registry.py``; stdlib-only.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
from typing import Any, Iterable

# latency-shaped default buckets (seconds), 1ms .. 120s — the top must
# cover big-model step times and worst-case TTFT, because quantile()
# clamps to the largest finite bound (Prometheus semantics): a saturated
# histogram reports the top bound, not the true quantile
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _label_str(labels: dict[str, str], extra: dict[str, str] | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


class Counter:
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed upper-bound buckets; counts are per-bucket internally and
    cumulated at render/quantile time (the Prometheus ``le`` convention)."""

    __slots__ = ("name", "labels", "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, labels: dict[str, str],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (0 when empty). q in [0, 1].
        Clamps to the largest finite bound when the rank falls in the
        +Inf bucket (Prometheus ``histogram_quantile`` semantics) — size
        buckets to the workload or the top quantiles saturate."""
        with self._lock:
            counts = list(self._counts)
        return quantile_from_counts(self.bounds, counts, q)


def quantile_from_counts(bounds: tuple[float, ...], counts: list[int],
                         q: float) -> float:
    """The bucket-interpolation rule over an explicit per-bucket count
    vector (``Histogram.quantile`` and the windowed-delta readers share
    it — ONE quantile semantics for cumulative and since-last-scrape)."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q * total
    acc = 0
    lo = 0.0
    for i, c in enumerate(counts):
        if acc + c >= rank and c > 0:
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (rank - acc) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        acc += c
        lo = bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


class HistogramWindow:
    """Since-last-call quantile reader over histograms.

    A cumulative histogram answers "over the whole run"; a live series
    point wants "since the last scrape" — p99 TTFT *now*, not blended
    with an hour-old warmup. ``delta(hist)`` diffs the per-bucket counts
    against this window's previous reading of the same histogram family
    and returns ``{count, p50, p99}`` over just the new observations
    (zeros when nothing landed). A replaced histogram object (engine
    ``reset_metrics`` builds a fresh registry) re-baselines from zero
    instead of reporting negative deltas."""

    def __init__(self) -> None:
        self._prev: dict[str, tuple[Any, list[int]]] = {}

    def delta(self, hist: Histogram) -> dict[str, float]:
        with hist._lock:
            counts = list(hist._counts)
        prev_obj, prev_counts = self._prev.get(hist.name, (None, None))
        if prev_obj is not hist or prev_counts is None:
            prev_counts = [0] * len(counts)
        d = [max(a - b, 0) for a, b in zip(counts, prev_counts)]
        self._prev[hist.name] = (hist, counts)
        n = sum(d)
        return {
            "count": float(n),
            "p50": quantile_from_counts(hist.bounds, d, 0.5),
            "p99": quantile_from_counts(hist.bounds, d, 0.99),
        }


class Registry:
    """Named metric families; a family's children differ by labels."""

    def __init__(self) -> None:
        self._metrics: dict[tuple, Any] = {}
        self._help: dict[str, tuple[str, str]] = {}  # name -> (kind, help)
        self._lock = threading.Lock()

    def _get(self, kind: str, cls, name: str, help_: str,
             labels: dict[str, str], **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            # kind conflicts must fail for existing children too — handing
            # a Counter to a caller that asked for a gauge corrupts the
            # export (or explodes later inside the instrumented path)
            known = self._help.get(name)
            if known is not None and known[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {known[0]}"
                )
            m = self._metrics.get(key)
            if m is None:
                self._help.setdefault(name, (kind, help_))
                m = self._metrics[key] = cls(name, dict(labels), **kw)
            return m

    def counter(self, name: str, help_: str = "", **labels: str) -> Counter:
        return self._get("counter", Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "", **labels: str) -> Gauge:
        return self._get("gauge", Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get("histogram", Histogram, name, help_, labels,
                         buckets=buckets)

    # --- snapshot / render ----------------------------------------------------

    def snapshot(self) -> list[dict]:
        """JSON-able dump, one entry per metric child (the on-disk form the
        portal re-renders; see :func:`write_snapshot`)."""
        out = []
        with self._lock:
            metrics = list(self._metrics.values())
            helps = dict(self._help)
        for m in metrics:
            kind, help_ = helps.get(m.name, ("counter", ""))
            entry: dict[str, Any] = {
                "kind": kind, "name": m.name, "help": help_,
                "labels": dict(m.labels),
            }
            if isinstance(m, Histogram):
                entry["bounds"] = list(m.bounds)
                entry["counts"] = list(m._counts)
                entry["sum"] = m.sum
                entry["count"] = m.count
            else:
                entry["value"] = m.value
            out.append(entry)
        return out

    def render(self) -> str:
        return render_snapshots([({}, self.snapshot())])


def render_snapshots(
    snaps: Iterable[tuple[dict[str, str], list[dict]]]
) -> str:
    """Prometheus text exposition (0.0.4) over snapshot dumps, each with
    extra labels (the portal attaches ``app``/``proc``). One HELP/TYPE
    header per family regardless of how many snapshots carry it."""
    families: dict[str, list[tuple[dict, dict]]] = {}
    meta: dict[str, tuple[str, str]] = {}
    for extra, entries in snaps:
        for e in entries:
            # one malformed snapshot entry (older format, hand-edited
            # file) must not take down the whole fleet-wide scrape
            if not isinstance(e, dict) or not e.get("name"):
                continue
            families.setdefault(e["name"], []).append((extra, e))
            meta.setdefault(e["name"], (e.get("kind", "counter"), e.get("help", "")))
    lines: list[str] = []
    for name in sorted(families):
        kind, help_ = meta[name]
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for extra, e in families[name]:
            labels = dict(e.get("labels", {}))
            try:
                if kind == "histogram":
                    bucket_lines = []
                    bounds = list(e["bounds"]) + [math.inf]
                    acc = 0
                    for b, c in zip(bounds, e["counts"]):
                        acc += c
                        le = _label_str(labels, {**extra, "le": _fmt(b)})
                        bucket_lines.append(f"{name}_bucket{le} {acc}")
                    ls = _label_str(labels, extra)
                    bucket_lines.append(f"{name}_sum{ls} {_fmt(e['sum'])}")
                    bucket_lines.append(f"{name}_count{ls} {e['count']}")
                    lines.extend(bucket_lines)
                else:
                    ls = _label_str(labels, extra)
                    lines.append(f"{name}{ls} {_fmt(e['value'])}")
            except (KeyError, TypeError, ValueError):
                continue  # skip the malformed entry, keep the scrape alive
    return "\n".join(lines) + "\n"


# --- process-global default registry -----------------------------------------

_registry = Registry()


def get_registry() -> Registry:
    return _registry


def write_snapshot(path: str, registry: Registry | None = None,
                   proc: str = "") -> None:
    """Atomically journal a registry snapshot (fit()/engine shutdown →
    ``<app_dir>/metrics/<proc>.json``; the portal's /metrics source)."""
    reg = registry if registry is not None else _registry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"proc": proc, "metrics": reg.snapshot()}
    with open(path + ".tmp", "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)


def snapshot_to_app_dir(proc: str, registry: Registry | None = None) -> str:
    """Write this process's snapshot under the job's app dir when running
    inside a tony-tpu job (TONY_APP_DIR); returns the path ('' outside)."""
    app_dir = os.environ.get("TONY_APP_DIR", "")
    if not app_dir:
        return ""
    from tony_tpu_torch.obs.trace import sanitize_proc  # one shared naming rule

    proc = sanitize_proc(proc)
    path = os.path.join(app_dir, "metrics", f"{proc}.json")
    try:
        write_snapshot(path, registry, proc=proc)
    except OSError:
        return ""
    return path


__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "HistogramWindow",
    "Registry", "get_registry", "quantile_from_counts", "render_snapshots",
    "snapshot_to_app_dir", "write_snapshot",
]
