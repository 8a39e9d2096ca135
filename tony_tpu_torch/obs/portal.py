"""Job-history portal: the tony-portal analogue.

The port's copy of ``tony_tpu/obs/portal.py``, stdlib only like it.

The reference ships a Play-framework web UI that scans the finished-jobs
HDFS dir, parses avro .jhist files, and renders jobs / per-job config /
events / metrics pages (SURVEY.md sections 2 "tony-portal", 3.5). Here the
same read path is a stdlib ThreadingHTTPServer over the apps root: each
application dir carries status.json, config.json, events/*.jhist.jsonl and
logs/ — everything the portal needs, no database.

Endpoints:
    /                    jobs table (HTML)
    /job/<app_id>        job detail: status, tasks, config, events (HTML)
    /job/<app_id>/log/<task>   task log (text)
    /api/jobs            jobs list (JSON)
    /api/job/<app_id>    full detail (JSON)
    /api/serve           fleet gang-serving rollup: per-app request /
                         replay / rejection counts from the frontend
                         ledgers under <app_dir>/serve/ (JSON)
    /api/serve/<app_id>  one app's serving rollup (JSON)
    /api/series          fleet live-series summary: per-app proc/task
                         freshness off the series journals + AM rollup
    /api/series/<app_id> one app's live series (obs/series.py journals +
                         the AM's heartbeat-path rollup), every proc and
                         task labelled with its age_s staleness
    /metrics             Prometheus text exposition over every app's
                         registry snapshots (step time / TTFT / TPOT
                         histograms etc., labelled app= and proc=), plus
                         the portal's own LIVE registry (request counts,
                         chart drops) and a tony_snapshot_age_seconds
                         gauge per snapshot — a dead host's frozen
                         metrics are visibly stale, not current
    /healthz             numerics-health verdicts for every app (JSON;
                         obs/health.py rollup)
    /healthz/<app_id>    one app's verdict rollup — HTTP 200 healthy/
                         unknown, 503 tripped (probe-friendly)

Run:  python -m tony_tpu_torch.obs.portal --port 8080 [--apps-root DIR]
"""

from __future__ import annotations

import argparse
import html
import json
import os
import re
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tony_tpu_torch.am.events import read_history
from tony_tpu_torch.cli.client import default_apps_root

_APP_ID_RE = re.compile(r"^[\w.-]+$")  # path-traversal guard


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class PortalData:
    """Filesystem read layer (kept separate from HTTP for tests)."""

    def __init__(self, apps_root: str):
        from tony_tpu_torch.obs.registry import Registry

        self.apps_root = apps_root
        # the portal's own metrics, served by /metrics next to the app
        # snapshots: hidden NaNs are what the health sentinel hunts, so a
        # chart filter may drop them from a polyline but must COUNT them
        self.registry = Registry()
        self.nonfinite_dropped = self.registry.counter(
            "tony_portal_nonfinite_dropped",
            "non-finite metric samples excluded from portal charts "
            "(counted, never silently hidden)",
        )
        # render-idempotent accounting: each distinct non-finite sample
        # counts ONCE, however many times its page is re-rendered — the
        # counter must track NaN production, not page views
        self._drop_seen: set[tuple] = set()

    # the full route vocabulary: labels stay bounded however hostile the
    # traffic (a crawler probing /wp-login must not mint counter children)
    _ROUTES = frozenset({"/", "job", "api", "metrics", "healthz"})

    def count_request(self, route: str) -> None:
        """The live half of /metrics: requests served by THIS portal
        process, labelled by NORMALIZED top-level route — proof a scrape
        is hitting a live process, next to the snapshot-derived (and
        staleness-labelled) per-app series."""
        route = route or "/"
        self.registry.counter(
            "tony_portal_requests_total",
            "HTTP requests served by this portal process",
            route=route if route in self._ROUTES else "other",
        ).inc()

    def jobs(self) -> list[dict]:
        out = []
        if not os.path.isdir(self.apps_root):
            return out
        for app_id in sorted(os.listdir(self.apps_root), reverse=True):
            app_dir = os.path.join(self.apps_root, app_id)
            if not os.path.isdir(app_dir):
                continue
            status = _read_json(os.path.join(app_dir, "status.json"))
            config = _read_json(os.path.join(app_dir, "config.json")) or {}
            out.append(
                {
                    "app_id": app_id,
                    "state": (status or {}).get("state", "RUNNING?"),
                    "exit_code": (status or {}).get("exit_code", ""),
                    "framework": config.get("application.framework", ""),
                    "name": config.get("application.name", ""),
                }
            )
        return out

    def job(self, app_id: str) -> dict | None:
        if not _APP_ID_RE.match(app_id):
            return None
        app_dir = os.path.join(self.apps_root, app_id)
        if not os.path.isdir(app_dir):
            return None
        events = []
        ev_dir = os.path.join(app_dir, "events")
        if os.path.isdir(ev_dir):
            for name in sorted(os.listdir(ev_dir)):
                if name.endswith(".jsonl"):
                    try:
                        events.extend(read_history(os.path.join(ev_dir, name)))
                    except (OSError, json.JSONDecodeError):
                        pass
        logs = []
        logs_dir = os.path.join(app_dir, "logs")
        if os.path.isdir(logs_dir):
            logs = sorted(os.listdir(logs_dir))
        self.count_drops(app_id, events)
        return {
            "app_id": app_id,
            "status": _read_json(os.path.join(app_dir, "status.json")),
            "config": _read_json(os.path.join(app_dir, "config.json")),
            "events": events,
            "logs": logs,
        }

    def count_drops(self, app_id: str, events: list[dict]) -> None:
        """Count each distinct non-finite metric sample into
        ``tony_portal_nonfinite_dropped`` exactly once (the journal is
        append-only, so the event index is a stable identity)."""
        import math

        for i, e in enumerate(events):
            if e.get("type") != "METRICS" or not isinstance(
                e.get("samples"), dict
            ):
                continue
            for name, value in e["samples"].items():
                # only floats can be non-finite; bools/ints never are
                if isinstance(value, float) and not math.isfinite(value):
                    key = (app_id, i, str(e.get("task", "")), name)
                    if key not in self._drop_seen:
                        self._drop_seen.add(key)
                        self.nonfinite_dropped.inc()

    def log(self, app_id: str, name: str) -> str | None:
        if not _APP_ID_RE.match(app_id) or os.sep in name or name.startswith("."):
            return None
        path = os.path.join(self.apps_root, app_id, "logs", name)
        try:
            with open(path, errors="replace") as f:
                return f.read()
        except OSError:
            return None

    def metric_snapshots(self) -> list[tuple[dict, list[dict]]]:
        """Every registry snapshot under every app's ``metrics/`` dir, as
        (extra-labels, entries) pairs for registry.render_snapshots — the
        fit()/engine/AM shutdown snapshots become one fleet-wide scrape.

        Each snapshot additionally carries a synthetic
        ``tony_snapshot_age_seconds`` gauge (file mtime age): every series
        derived from that snapshot is thereby staleness-labelled — a dead
        host's frozen histogram scrapes as N-seconds-old data, never as a
        current reading."""
        out: list[tuple[dict, list[dict]]] = []
        if not os.path.isdir(self.apps_root):
            return out
        now = time.time()
        for app_id in sorted(os.listdir(self.apps_root)):
            mdir = os.path.join(self.apps_root, app_id, "metrics")
            if not os.path.isdir(mdir):
                continue
            for name in sorted(os.listdir(mdir)):
                if not name.endswith(".json"):
                    continue
                path = os.path.join(mdir, name)
                snap = _read_json(path)
                if not isinstance(snap, dict):
                    continue
                entries = snap.get("metrics")
                if isinstance(entries, list):
                    try:
                        age = max(now - os.path.getmtime(path), 0.0)
                    except OSError:
                        age = 0.0
                    entries = list(entries) + [{
                        "kind": "gauge",
                        "name": "tony_snapshot_age_seconds",
                        "help": "age of the registry snapshot these "
                                "app/proc series were rendered from "
                                "(stale = a process that stopped writing)",
                        "labels": {},
                        "value": round(age, 1),
                    }]
                    out.append((
                        {"app": app_id, "proc": snap.get("proc", name[:-5])},
                        entries,
                    ))
        return out

    def series_rollup(self, app_id: str) -> dict | None:
        """One app's live series: the per-proc journal rollup
        (obs/series.py ``fleet_rollup``) merged with the AM's heartbeat-
        path rollup — every proc/task labelled with its ``age_s``. None
        for unknown app ids."""
        from tony_tpu_torch.obs.series import fleet_rollup

        if not _APP_ID_RE.match(app_id):
            return None
        app_dir = os.path.join(self.apps_root, app_id)
        if not os.path.isdir(app_dir):
            return None
        roll = fleet_rollup(app_dir)
        out = {"app_id": app_id, "procs": roll["procs"]}
        am_roll = _read_json(os.path.join(app_dir, "series", "am_rollup.json"))
        if isinstance(am_roll, dict):
            # re-label staleness against NOW, not the AM's write time: a
            # dead AM leaves a frozen rollup whose embedded ages lie
            now = time.time()
            tasks = {}
            for tid, rec in (am_roll.get("tasks") or {}).items():
                rec = dict(rec or {})
                last = float(rec.get("last_ts", 0.0) or 0.0)
                rec["age_s"] = round(max(now - last, 0.0), 1)
                tasks[tid] = rec
            out["am_rollup"] = {
                "rollup_age_s": round(
                    max(now - float(am_roll.get("ts", 0.0) or 0.0), 0.0), 1
                ),
                "tasks": tasks,
            }
        return out

    def series_summaries(self) -> dict[str, dict]:
        """Fleet ``/api/series`` view: per-app proc freshness from journal
        mtimes (stat calls only — the fleet scrape must NOT parse every
        journal; the per-app ``/api/series/<id>`` endpoint does the full
        read). Apps with neither journals nor an AM rollup are omitted."""
        from tony_tpu_torch.obs.series import freshness

        out: dict[str, dict] = {}
        if not os.path.isdir(self.apps_root):
            return out
        now = time.time()
        for app_id in sorted(os.listdir(self.apps_root)):
            if not _APP_ID_RE.match(app_id):
                continue
            app_dir = os.path.join(self.apps_root, app_id)
            procs: dict[str, dict] = dict(freshness(app_dir, now=now))
            am_roll = _read_json(
                os.path.join(app_dir, "series", "am_rollup.json")
            )
            if isinstance(am_roll, dict):
                for tid, rec in (am_roll.get("tasks") or {}).items():
                    last = float((rec or {}).get("last_ts", 0.0) or 0.0)
                    procs.setdefault(
                        tid, {"age_s": round(max(now - last, 0.0), 1)}
                    )
            if procs:
                out[app_id] = {"procs": procs}
        return out

    def prometheus(self) -> str:
        from tony_tpu_torch.obs.registry import render_snapshots

        return render_snapshots(
            [({"proc": "portal"}, self.registry.snapshot())]
            + self.metric_snapshots()
        )

    def serve_summary(self, app_id: str) -> dict | None:
        """Roll up one app's gang-serving ledgers (serve/frontend.py
        writes ``<app_dir>/serve/requests_*.json``): request counts by
        finish reason, replays, rejected, worst TTFT — the fleet view of
        the no-request-lost contract. None for unknown app ids, a zeroed
        summary for jobs that never served."""
        if not _APP_ID_RE.match(app_id):
            return None
        app_dir = os.path.join(self.apps_root, app_id)
        if not os.path.isdir(app_dir):
            return None
        out = {
            "app_id": app_id, "requests": 0, "finished": 0, "errors": 0,
            "replays": 0, "rejected": 0, "pending": 0, "ttft_max_s": 0.0,
            "ledgers": [],
            # disaggregated-gang handoff rollup (zeros for classic gangs)
            "handoffs": 0, "handoff_failures": 0,
            "handoff_blocks_shipped": 0, "handoff_bytes": 0,
        }
        serve_dir = os.path.join(app_dir, "serve")
        if not os.path.isdir(serve_dir):
            return out
        for name in sorted(os.listdir(serve_dir)):
            if not (name.startswith("requests_") and name.endswith(".json")):
                continue
            ledger = _read_json(os.path.join(serve_dir, name))
            if not isinstance(ledger, dict):
                continue
            out["ledgers"].append(name)
            out["rejected"] += int(ledger.get("rejected", 0))
            out["pending"] += len(ledger.get("pending", []))
            for entry in ledger.get("requests", []):
                out["requests"] += 1
                reason = entry.get("finish_reason", "")
                if reason in ("eos", "length"):
                    out["finished"] += 1
                elif reason in ("rejected", "draining"):
                    # explicit backpressure — the invariant checker does
                    # not count these as losses, so neither does the fleet
                    # view (a clean job must not chart as erroring)
                    out["rejected"] += 1
                else:
                    out["errors"] += 1
                out["replays"] += int(entry.get("replays", 0))
                out["ttft_max_s"] = max(
                    out["ttft_max_s"], float(entry.get("ttft_s", 0.0))
                )
            for h in ledger.get("handoffs", []):
                if h.get("ok"):
                    out["handoffs"] += 1
                else:
                    out["handoff_failures"] += 1
                out["handoff_blocks_shipped"] += int(h.get("shipped", 0))
                out["handoff_bytes"] += int(h.get("bytes", 0))
        return out

    def serve_summaries(self) -> dict[str, dict]:
        """Per-app serving rollups for the fleet ``/api/serve`` view
        (apps without ledgers are omitted — most jobs train)."""
        out: dict[str, dict] = {}
        if not os.path.isdir(self.apps_root):
            return out
        for app_id in sorted(os.listdir(self.apps_root)):
            s = self.serve_summary(app_id)
            if s is not None and s["ledgers"]:
                out[app_id] = s
        return out

    def health(self, app_id: str) -> dict | None:
        """One app's numerics-health rollup (verdicts + bundle listing,
        obs/health.py layout); None for unknown/invalid app ids."""
        from tony_tpu_torch.obs.health import rollup

        if not _APP_ID_RE.match(app_id):
            return None
        app_dir = os.path.join(self.apps_root, app_id)
        if not os.path.isdir(app_dir):
            return None
        return {"app_id": app_id, **rollup(app_dir)}

    def healths(self) -> dict[str, dict]:
        """Per-app verdict map for the fleet-wide /healthz view. Apps that
        never armed a sentinel report ``unknown`` rather than vanishing —
        absence of a verdict is itself information."""
        out: dict[str, dict] = {}
        if not os.path.isdir(self.apps_root):
            return out
        for app_id in sorted(os.listdir(self.apps_root)):
            if not os.path.isdir(os.path.join(self.apps_root, app_id)):
                continue
            h = self.health(app_id)
            if h is not None:
                out[app_id] = {
                    "verdict": h["verdict"],
                    "rules": h["rules"],
                    "bundles": len(h["bundles"]),
                }
        return out


_PAGE = """<!doctype html><html><head><title>tony-tpu portal</title><style>
body {{ font-family: monospace; margin: 2em; }} table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 4px 10px; text-align: left; }}
.SUCCEEDED {{ color: #080 }} .FAILED {{ color: #b00 }} .KILLED {{ color: #b60 }}
pre {{ background: #f4f4f4; padding: 1em; overflow-x: auto; }}
</style></head><body>{body}</body></html>"""


def _jobs_html(jobs: list[dict]) -> str:
    rows = "".join(
        f"<tr><td><a href='/job/{html.escape(j['app_id'])}'>{html.escape(j['app_id'])}</a></td>"
        f"<td class='{html.escape(str(j['state']))}'>{html.escape(str(j['state']))}</td>"
        f"<td>{html.escape(str(j['exit_code']))}</td>"
        f"<td>{html.escape(str(j['framework']))}</td></tr>"
        for j in jobs
    )
    return _PAGE.format(
        body=f"<h1>tony-tpu jobs</h1><table><tr><th>application</th><th>state</th>"
        f"<th>exit</th><th>framework</th></tr>{rows}</table>"
    )


def _latest_metrics(events: list[dict]) -> dict[str, dict]:
    """task -> latest METRICS samples (the portal's utilisation view; the
    reference charts the utilisation embedded in its history events the same
    way, SURVEY.md section 3.5)."""
    latest: dict[str, dict] = {}
    for e in events:
        if e.get("type") == "METRICS" and isinstance(e.get("samples"), dict):
            latest[str(e.get("task", "?"))] = e["samples"]
    return latest


def _metric_series(events: list[dict]) -> dict[str, dict[str, list[float]]]:
    """task -> metric name -> time-ordered values (for the charts)."""
    import math

    series: dict[str, dict[str, list[float]]] = {}
    for e in events:
        if e.get("type") == "METRICS" and isinstance(e.get("samples"), dict):
            per_task = series.setdefault(str(e.get("task", "?")), {})
            for name, value in e["samples"].items():
                if not isinstance(value, (int, float)) or isinstance(value, bool):
                    continue  # bools would chart as 0/1
                # NaN/Inf (a diverged loss — the moment the operator opens
                # this page) would poison the polyline's min/max into an
                # invisible chart: excluded from the line, but COUNTED
                # once per distinct sample by PortalData.count_drops —
                # hidden NaNs are precisely what the health sentinel hunts
                if not math.isfinite(value):
                    continue
                per_task.setdefault(name, []).append(float(value))
    return series


def _sparkline(values: list[float], w: int = 160, h: int = 28) -> str:
    """Inline SVG polyline — the portal's metrics chart (the reference
    renders utilisation charts from its history events the same way)."""
    if len(values) < 2:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{2 + i * (w - 4) / (len(values) - 1):.1f},"
        f"{h - 2 - (v - lo) / span * (h - 4):.1f}"
        for i, v in enumerate(values)
    )
    return (
        f"<svg width='{w}' height='{h}' viewBox='0 0 {w} {h}'>"
        f"<polyline points='{pts}' fill='none' stroke='#36c' stroke-width='1.5'/>"
        f"</svg>"
    )


def _charts_html(series: dict[str, dict[str, list[float]]]) -> str:
    chart_metrics = ["tokens_per_sec", "mfu", "loss", "rss_mb", "hbm_mb"]
    rows = ""
    for task in sorted(series):
        cells = ""
        for m in chart_metrics:
            values = series[task].get(m, [])
            svg = _sparkline(values)
            if svg:
                cells += (
                    f"<td>{html.escape(m)}<br>{svg}<br>"
                    f"<small>{_fmt_num(values[0])} → {_fmt_num(values[-1])}"
                    f"</small></td>"
                )
        if cells:
            rows += f"<tr><td>{html.escape(task)}</td>{cells}</tr>"
    if not rows:
        return ""
    return f"<table>{rows}</table>"


def _metrics_html(metrics: dict[str, dict]) -> str:
    if not metrics:
        return "<p>(no metrics reported)</p>"
    # stable column order: the headline numbers first, then the rest
    preferred = ["step", "loss", "tokens_per_sec", "tokens_per_sec_per_chip",
                 "mfu", "grad_norm", "cpu_percent", "rss_mb", "hbm_mb",
                 "hbm_peak_mb"]
    seen = {k for samples in metrics.values() for k in samples}
    cols = [c for c in preferred if c in seen]
    cols += sorted(seen - set(cols))
    head = "".join(f"<th>{html.escape(c)}</th>" for c in cols)
    rows = ""
    for task in sorted(metrics):
        cells = "".join(
            f"<td>{_fmt_num(metrics[task].get(c))}</td>" for c in cols
        )
        rows += f"<tr><td>{html.escape(task)}</td>{cells}</tr>"
    return f"<table><tr><th>task</th>{head}</tr>{rows}</table>"


def _fmt_num(v) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.4g}"
    return html.escape(str(v))


def _job_html(detail: dict) -> str:
    app_id = html.escape(detail["app_id"])
    status = detail["status"] or {}
    tasks = "".join(
        f"<tr><td>{html.escape(t['task'])}</td><td class='{html.escape(t['state'])}'>"
        f"{html.escape(t['state'])}</td><td>{t.get('exit_code')}</td>"
        f"<td>{t.get('attempts')}</td></tr>"
        for t in status.get("tasks", [])
    )
    logs = "".join(
        f"<li><a href='/job/{app_id}/log/{html.escape(n)}'>{html.escape(n)}</a></li>"
        for n in detail["logs"]
    )
    events = html.escape(
        "\n".join(json.dumps(e, sort_keys=True) for e in detail["events"])
    )
    config = html.escape(json.dumps(detail["config"] or {}, indent=1, sort_keys=True))
    return _PAGE.format(
        body=f"<h1>{app_id}</h1>"
        f"<p>state: <b class='{html.escape(str(status.get('state')))}'>"
        f"{html.escape(str(status.get('state', 'RUNNING?')))}</b>"
        f" exit={status.get('exit_code')}</p>"
        f"<h2>tasks</h2><table><tr><th>task</th><th>state</th><th>exit</th>"
        f"<th>attempts</th></tr>{tasks}</table>"
        f"<h2>metrics</h2>{_metrics_html(_latest_metrics(detail['events']))}"
        f"{_charts_html(_metric_series(detail['events']))}"
        f"<h2>logs</h2><ul>{logs}</ul>"
        f"<h2>events</h2><pre>{events}</pre>"
        f"<h2>config</h2><pre>{config}</pre>"
        f"<p><a href='/'>&larr; all jobs</a></p>"
    )


def make_handler(data: PortalData):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: str, ctype: str = "text/html") -> None:
            raw = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", f"{ctype}; charset=utf-8")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            parts = [p for p in self.path.split("/") if p]
            data.count_request(parts[0] if parts else "/")
            if not parts:
                return self._send(200, _jobs_html(data.jobs()))
            if parts[0] == "metrics" and len(parts) == 1:
                return self._send(
                    200, data.prometheus(), "text/plain; version=0.0.4"
                )
            if parts[0] == "healthz":
                if len(parts) == 1:
                    return self._send(
                        200, json.dumps(data.healths()), "application/json"
                    )
                if len(parts) == 2:
                    h = data.health(parts[1])
                    if h is None:
                        return self._send(404, "{}", "application/json")
                    # probe semantics: a tripped verdict is a 503, so a
                    # plain HTTP check (k8s-style) needs no JSON parsing
                    code = 503 if h["verdict"] == "tripped" else 200
                    return self._send(code, json.dumps(h), "application/json")
                return self._send(404, "{}", "application/json")
            if parts[0] == "api":
                if len(parts) == 2 and parts[1] == "jobs":
                    return self._send(200, json.dumps(data.jobs()), "application/json")
                if len(parts) == 2 and parts[1] == "serve":
                    return self._send(
                        200, json.dumps(data.serve_summaries()), "application/json"
                    )
                if len(parts) == 3 and parts[1] == "serve":
                    s = data.serve_summary(parts[2])
                    if s is not None:
                        return self._send(200, json.dumps(s), "application/json")
                    return self._send(404, "{}", "application/json")
                if len(parts) == 2 and parts[1] == "series":
                    return self._send(
                        200, json.dumps(data.series_summaries()),
                        "application/json",
                    )
                if len(parts) == 3 and parts[1] == "series":
                    s = data.series_rollup(parts[2])
                    if s is not None:
                        return self._send(200, json.dumps(s), "application/json")
                    return self._send(404, "{}", "application/json")
                if len(parts) == 3 and parts[1] == "job":
                    detail = data.job(parts[2])
                    if detail is not None:
                        return self._send(200, json.dumps(detail), "application/json")
                return self._send(404, "{}", "application/json")
            if parts[0] == "job" and len(parts) >= 2:
                detail = data.job(parts[1])
                if detail is None:
                    return self._send(404, _PAGE.format(body="<h1>not found</h1>"))
                if len(parts) == 4 and parts[2] == "log":
                    text = data.log(parts[1], parts[3])
                    if text is None:
                        return self._send(404, "not found", "text/plain")
                    return self._send(200, text, "text/plain")
                return self._send(200, _job_html(detail))
            return self._send(404, _PAGE.format(body="<h1>not found</h1>"))

    return Handler


def serve_portal(apps_root: str, port: int = 0, host: str = "127.0.0.1"):
    """Start the portal; returns (server, bound_port). server.serve_forever().

    A configured (non-ephemeral) port goes through the bounded
    bind-with-retry (utils/net.py): a portal restart racing its
    predecessor's TIME_WAIT socket retries briefly instead of crashing or
    silently landing elsewhere.
    """
    from tony_tpu_torch.utils.net import bind_with_retry

    handler = make_handler(PortalData(apps_root))
    servers: list[ThreadingHTTPServer] = []

    def _bind(p: int) -> int:
        servers.append(ThreadingHTTPServer((host, p), handler))
        return servers[-1].server_address[1]

    bound = bind_with_retry(_bind, port, attempts=8)
    return servers[-1], bound


def main() -> None:
    from tony_tpu_torch.config.config import TonyConfig
    from tony_tpu_torch.config.keys import Keys

    p = argparse.ArgumentParser(description="tony-tpu job-history portal")
    p.add_argument(
        "--port", type=int,
        default=TonyConfig(read_env=True).get_int(Keys.PORTAL_PORT, 8080),
        help="defaults to the portal.port config key",
    )
    p.add_argument("--apps-root", default=default_apps_root())
    p.add_argument(
        "--host", default="127.0.0.1",
        help="bind address; 0.0.0.0 exposes the portal (job configs + logs) "
             "to the network — opt in deliberately",
    )
    args = p.parse_args()
    server, port = serve_portal(args.apps_root, args.port, host=args.host)
    print(f"portal serving {args.apps_root} on :{port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
