"""Trace post-processing: merge per-process journals, goodput, stragglers.

The port's copy of ``tony_tpu/obs/trace_tool.py``, stdlib only like it.

``tony trace <app_id>`` drives this module: every ``trace/*.jsonl`` journal
the processes of one application wrote (obs/trace.py) is merged into a
single Chrome-trace-event JSON loadable in Perfetto / chrome://tracing,
with each tony process as one Chrome "process" row. On top of the merged
timeline it computes:

- a **goodput roll-up**: productive step time vs compile / restore /
  input-blocked / restart over the job's span window — the "where did the
  wall clock go" answer a chaos post-mortem starts from;
- **straggler flagging** from heartbeat-reported step progress (the METRICS
  events each task pushes through the AM): a task whose latest reported
  step lags the fleet max by more than the threshold is flagged with its
  lag and step rate.

Sampled spans scale honestly: train/serve step spans carry their sampling
stride as the ``every`` arg, and the roll-up multiplies duration by it —
1-in-16 sampling yields an estimate, not a 16x undercount.
"""

from __future__ import annotations

import json
import os
from typing import Any

from tony_tpu_torch.am.events import EventType, read_history


def load_journals(trace_dir: str) -> list[dict[str, Any]]:
    """Read every per-process journal: returns one entry per process,
    ``{"proc", "pid", "trace", "dropped", "spans": [...], "instants": [...],
    "counters": [...]}``.
    Torn trailing lines (a SIGKILLed writer) are skipped, not fatal; a
    rotated window (``<proc>.0.jsonl``, written when the journal hits its
    size cap) merges into the same process entry."""
    procs: list[dict[str, Any]] = []
    by_proc: dict[str, dict[str, Any]] = {}
    if not os.path.isdir(trace_dir):
        return procs
    for name in sorted(os.listdir(trace_dir)):
        if not name.endswith(".jsonl"):
            continue
        entry: dict[str, Any] = {
            "proc": name[:-len(".jsonl")], "pid": 0, "trace": "",
            "dropped": 0, "spans": [], "instants": [], "opens": [],
            "counters": [],
        }
        try:
            with open(os.path.join(trace_dir, name), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail from a killed process
                    ph = rec.get("ph")
                    if ph == "M":
                        entry["proc"] = rec.get("proc", entry["proc"])
                        entry["pid"] = rec.get("pid", entry["pid"])
                        entry["trace"] = rec.get("trace", entry["trace"])
                        entry["dropped"] += int(rec.get("dropped", 0))
                    elif ph == "X":
                        entry["spans"].append(rec)
                    elif ph == "i":
                        entry["instants"].append(rec)
                    elif ph == "B":
                        # begin-only: a span open when a chaos SIGKILL hit
                        # (emergency_flush journals these pre-kill)
                        entry["opens"].append(rec)
                    elif ph == "C":
                        # counter-track sample (per-device HBM, obs/hbm.py)
                        entry["counters"].append(rec)
        except OSError:
            continue
        prev = by_proc.get(entry["proc"])
        if prev is None:
            by_proc[entry["proc"]] = entry
            procs.append(entry)
        else:
            prev["spans"].extend(entry["spans"])
            prev["instants"].extend(entry["instants"])
            prev["opens"].extend(entry["opens"])
            prev["counters"].extend(entry["counters"])
            prev["dropped"] += entry["dropped"]
            prev["pid"] = prev["pid"] or entry["pid"]
            prev["trace"] = prev["trace"] or entry["trace"]
    # a span can journal as begin-only more than once (emergency_flush at a
    # survived fault, then close()) or later complete normally — keep one B
    # per sid and drop it entirely when the finished X record exists
    for entry in procs:
        ended = {s.get("sid") for s in entry["spans"]}
        seen: set = set()
        uniq = []
        for o in entry["opens"]:
            sid = o.get("sid")
            if sid in ended or sid in seen:
                continue
            seen.add(sid)
            uniq.append(o)
        entry["opens"] = uniq
    return procs


def merge_chrome(app_dir: str,
                 procs: list[dict[str, Any]] | None = None) -> dict[str, Any]:
    """One Chrome-trace JSON over every process journal of the app."""
    if procs is None:
        procs = load_journals(os.path.join(app_dir, "trace"))
    events: list[dict[str, Any]] = []
    for i, p in enumerate(procs, start=1):
        events.append({
            "ph": "M", "name": "process_name", "pid": i, "tid": 0,
            "args": {"name": p["proc"], "os_pid": p["pid"],
                     "dropped_events": p["dropped"]},
        })
        for s in p["spans"]:
            events.append({
                "ph": "X", "name": s.get("name", "?"), "cat": "tony",
                "ts": s.get("ts", 0), "dur": s.get("dur", 0),
                "pid": i, "tid": s.get("tid", 0),
                "args": {**s.get("args", {}), "sid": s.get("sid", ""),
                         "psid": s.get("psid", "")},
            })
        for inst in p["instants"]:
            events.append({
                "ph": "i", "name": inst.get("name", "?"), "cat": "tony",
                "ts": inst.get("ts", 0), "pid": i, "tid": inst.get("tid", 0),
                "s": "p", "args": inst.get("args", {}),
            })
        for o in p["opens"]:
            # span open at a SIGKILL: a begin-only Chrome event (Perfetto
            # renders it as running until the end of the trace)
            events.append({
                "ph": "B", "name": o.get("name", "?"), "cat": "tony",
                "ts": o.get("ts", 0), "pid": i, "tid": o.get("tid", 0),
                "args": {**o.get("args", {}), "killed": True,
                         "sid": o.get("sid", ""), "psid": o.get("psid", "")},
            })
        for c in p["counters"]:
            # counter track (per-device HBM live/peak): each numeric arg
            # renders as one series on the process's memory timeline
            events.append({
                "ph": "C", "name": c.get("name", "?"), "cat": "tony",
                "ts": c.get("ts", 0), "pid": i, "tid": 0,
                "args": c.get("args", {}),
            })
    events.sort(key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def goodput(app_dir: str,
            procs: list[dict[str, Any]] | None = None) -> dict[str, Any]:
    """Wall-clock attribution over the merged timeline (seconds).

    - ``productive_s``: train.step span time x sampling stride, plus serve
      prefill/decode-step time;
    - ``compile_s`` / ``restore_s`` / ``first_batch_s``: fit() startup
      phases (overlapped with each other — they can sum past wall time);
    - ``input_blocked_s``: per-step input fetch time carried on sampled
      step spans, scaled by the stride;
    - ``restart_s``: gaps between one task's consecutive user-process
      spans (the relaunch dead time a gang restart costs) PLUS
      ``elastic.reshard`` span time (the warm-restart cost of an elastic
      generation change — fence, donate, re-lower; docs/ELASTIC.md), so
      restart cost is read straight off the merged trace instead of
      inferred from ``unattributed_s``. ``generation_changes`` counts the
      elastic boundaries separately from cold ``restarts``;
    - ``window_s``: first span start to last span end across processes;
    - ``unattributed_s``: the window time NO bucket claims, reported
      explicitly instead of silently folding into the denominator — the
      reconciliation seam between this roll-up and the step-anatomy
      budget (obs/anatomy.py attributes *inside* the step; whatever
      neither tool claims is visible here, never hidden). A lower bound:
      startup phases overlap each other by design, so their sum can
      exceed their wall share.
    """
    if procs is None:
        procs = load_journals(os.path.join(app_dir, "trace"))
    spans = [s for p in procs for s in p["spans"]]
    opens = [o for p in procs for o in p["opens"]]
    out = {
        "window_s": 0.0, "productive_s": 0.0, "compile_s": 0.0,
        "restore_s": 0.0, "first_batch_s": 0.0, "input_blocked_s": 0.0,
        "restart_s": 0.0, "restarts": 0, "generation_changes": 0,
        "sampled_steps": 0,
    }
    if not spans and not opens:
        return out
    # begin-only records (SIGKILLed processes) count toward the window —
    # the tail up to the kill is exactly what a chaos post-mortem measures
    t_min = min(s["ts"] for s in spans + opens)
    t_max = max(s.get("fts", s["ts"] + s.get("dur", 0)) for s in spans + opens)
    out["window_s"] = round((t_max - t_min) / 1e6, 3)
    user_spans: dict[str, list[dict]] = {}
    for s in spans:
        name = s.get("name", "")
        args = s.get("args", {})
        dur_s = s.get("dur", 0) / 1e6
        if name in ("train.step", "serve.step"):
            every = max(int(args.get("every", 1) or 1), 1)
            out["productive_s"] += dur_s * every
            out["input_blocked_s"] += float(args.get("fetch_ms", 0.0)) / 1e3 * every
            out["sampled_steps"] += 1
        elif name == "serve.prefill":
            out["productive_s"] += dur_s
        elif name == "fit.startup.compile":
            out["compile_s"] += dur_s
        elif name == "fit.startup.restore":
            out["restore_s"] += dur_s
        elif name == "fit.startup.first_batch":
            out["first_batch_s"] += dur_s
        elif name == "executor.user_process":
            user_spans.setdefault(str(args.get("task", "?")), []).append(s)
        elif name == "am.gang_restart":
            out["restarts"] += 1
        elif name == "elastic.reshard":
            # warm restart: the generation boundary's fence+donate+relower
            # window, journaled by the trainer (train/loop.py _Elastic)
            out["restart_s"] += dur_s
            out["generation_changes"] += 1
    # a SIGKILLed attempt's user_process span is begin-only (``ph: "B"``,
    # emergency-flushed): its ``fts`` flush timestamp is the kill-time
    # proxy, without which restart_s misses exactly the kill_container
    # restarts the flight recorder exists to measure
    for p in procs:
        for o in p["opens"]:
            if o.get("name") == "executor.user_process" and o.get("fts"):
                user_spans.setdefault(
                    str(o.get("args", {}).get("task", "?")), []
                ).append({
                    "ts": o["ts"], "dur": max(o["fts"] - o["ts"], 0),
                    "args": o.get("args", {}),
                })
    # relaunch dead time: the hole between attempt N's user process ending
    # and attempt N+1's starting, per task
    for task_spans in user_spans.values():
        task_spans.sort(key=lambda s: s["ts"])
        for a, b in zip(task_spans, task_spans[1:]):
            gap = (b["ts"] - (a["ts"] + a.get("dur", 0))) / 1e6
            if gap > 0:
                out["restart_s"] += gap
    for k in ("productive_s", "compile_s", "restore_s", "first_batch_s",
              "input_blocked_s", "restart_s"):
        out[k] = round(out[k], 3)
    # explicit residual: window time no bucket above claims (clamped at 0
    # because the buckets can overlap — see the docstring). Goodput and
    # the anatomy budget reconcile through this number instead of both
    # quietly normalising by the window.
    attributed = sum(
        out[k] for k in ("productive_s", "compile_s", "restore_s",
                         "first_batch_s", "input_blocked_s", "restart_s")
    )
    out["unattributed_s"] = round(max(out["window_s"] - attributed, 0.0), 3)
    return out


def stragglers(app_dir: str, lag_frac: float = 0.2) -> list[dict[str, Any]]:
    """Cross-host straggler flags from heartbeat-reported step progress.

    Each task's latest ``step`` METRICS sample (pushed through the AM and
    journaled to .jhist) is compared against the fleet max; tasks lagging
    by more than ``lag_frac`` of the max are flagged with their lag and
    observed step rate. Empty when fewer than two tasks report steps."""
    events = _all_events(app_dir)
    progress: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("type") != EventType.METRICS:
            continue
        samples = e.get("samples", {})
        if not isinstance(samples, dict) or "step" not in samples:
            continue
        progress.setdefault(str(e.get("task", "?")), []).append(
            (float(e.get("ts", 0.0)), float(samples["step"]))
        )
    if len(progress) < 2:
        return []
    latest = {t: max(p, key=lambda x: x[0]) for t, p in progress.items()}
    max_step = max(s for _, s in latest.values())
    if max_step <= 0:
        return []
    flagged = []
    for task, (ts, step) in sorted(latest.items()):
        lag = max_step - step
        if lag / max_step <= lag_frac:
            continue
        pts = sorted(progress[task])
        rate = 0.0
        if len(pts) >= 2 and pts[-1][0] > pts[0][0]:
            rate = (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])
        flagged.append({
            "task": task, "step": step, "behind_steps": lag,
            "behind_frac": round(lag / max_step, 3),
            "steps_per_s": round(rate, 3),
        })
    return flagged


def _all_events(app_dir: str) -> list[dict]:
    ev_dir = os.path.join(app_dir, "events")
    events: list[dict] = []
    if os.path.isdir(ev_dir):
        for name in sorted(os.listdir(ev_dir)):
            if name.endswith(".jsonl"):
                try:
                    events.extend(read_history(os.path.join(ev_dir, name)))
                except (OSError, json.JSONDecodeError):
                    pass
    return events


def report(app_dir: str,
           procs: list[dict[str, Any]] | None = None) -> dict[str, Any]:
    """Everything ``tony trace`` prints beside the merged file. Pass
    ``procs`` (from :func:`load_journals`) to avoid re-reading the
    journals the caller already parsed."""
    if procs is None:
        procs = load_journals(os.path.join(app_dir, "trace"))
    out = {
        "processes": [
            {"proc": p["proc"], "spans": len(p["spans"]),
             "instants": len(p["instants"]), "open_at_kill": len(p["opens"]),
             "counters": len(p["counters"]), "dropped": p["dropped"]}
            for p in procs
        ],
        "goodput": goodput(app_dir, procs),
        "stragglers": stragglers(app_dir),
    }
    # pointer at available step-anatomy captures (obs/profile.py): the
    # op-level drill-down of whatever this roll-up flags as slow
    from tony_tpu_torch.obs.profile import list_captures

    captures = list_captures(app_dir)
    if captures:
        out["profile_captures"] = captures
    return out


__all__ = ["goodput", "load_journals", "merge_chrome", "report", "stragglers"]
