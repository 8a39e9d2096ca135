"""``tony top <app_id>``: a live terminal view of one application.

The port's copy of ``tony_tpu/obs/top.py``, stdlib only like it.

The ``yarn top`` analogue, fed by the live observability stack instead of
the scheduler alone: per-host rows come from the series journals
(obs/series.py) and the AM's heartbeat-path rollup, sparklines render the
recent TTFT / queue-depth / step trend, straggler flags reuse the trace
tool's heartbeat-progress analysis (obs/trace_tool.stragglers), and the
SLO / health columns read the verdict files — everything a deviceless
read, so ``tony top`` works on a live job, a dead one, and from any
machine that can see the app dir.

``--once`` prints a single frame (scripts, tests); the default loop
redraws every ``--interval`` seconds until Ctrl-C.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from tony_tpu_torch.obs import series, slo
from tony_tpu_torch.obs.health import rollup as health_rollup
from tony_tpu_torch.obs.trace_tool import stragglers

_SPARK = "▁▂▃▄▅▆▇█"

# sparkline metric per row, first key present wins: serve hosts trend
# queue depth, trainers step time, the frontend gang TTFT
_TREND_KEYS = ("queue_depth", "step_time_p99_s", "ttft_p99_s", "step")

# columns: (header, point key, format)
_VALUE_COLS = (
    ("step", "step", "{:.0f}"),
    ("ttft_p99", "ttft_p99_s", "{:.3f}s"),
    ("queue", "queue_depth", "{:.0f}"),
    ("occup", "occupancy", "{:.2f}"),
    ("hit%", "prefix_hit_rate", "{:.2f}"),  # prefix-store reuse (serve)
    ("tok/st", "tokens_per_step", "{:.2f}"),  # >1 = speculation paying off
    ("kvB/t", "kv_bytes_per_token", "{:.0f}"),  # drops under quantized KV
    ("goodput", "goodput_frac", "{:.2f}"),
    ("hbm_gb", "hbm_live_bytes", None),  # formatted specially
)


def sparkline(values: list[float], width: int = 16) -> str:
    """Unicode block sparkline over the last ``width`` values (flat
    series render as a flat midline; empty as blanks)."""
    values = [v for v in values if isinstance(v, (int, float))][-width:]
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK[3] * len(values)
    return "".join(
        _SPARK[min(int((v - lo) / span * (len(_SPARK) - 1)), len(_SPARK) - 1)]
        for v in values
    )


def _task_of_proc(proc: str) -> str:
    """Journal proc names (``worker_0_user``, ``decode_1_exec_a0``) map
    loosely onto AM task ids (``worker:0``) for straggler correlation."""
    parts = proc.split("_")
    if len(parts) >= 2 and parts[1].isdigit():
        return f"{parts[0]}:{parts[1]}"
    return proc


def _pool_of(task: str, latest: dict) -> str:
    """Pool column for serving rows. The engine journals its own pool
    label (a string riding the series point); AM-rollup rows lost it (the
    metrics push is numeric-only), so the task TYPE is the membership —
    pool assignment in a disaggregated gang is by task type. Non-serve
    rows stay blank."""
    pool = latest.get("pool")
    if isinstance(pool, str) and pool:
        return pool
    if any(k in latest for k in ("occupancy", "tpot_p50_s", "ttft_p50_s")):
        jt = task.partition(":")[0]
        if jt in ("prefill", "decode"):
            return jt
    return ""


def _pool_rollup(rows: list[dict]) -> dict[str, dict]:
    """Split TTFT/TPOT view per pool. Per-host quantiles cannot be merged
    exactly, so the rollup reports the observation-weighted mean p50 and
    the WORST host's p99 — the per-pool SLO question is "is any host of
    this pool blowing its tail", and max answers it conservatively."""
    pools: dict[str, dict] = {}
    for row in rows:
        pool = row.get("pool")
        if not pool:
            continue
        latest = row["latest"]
        agg = pools.setdefault(pool, {"hosts": 0, "queue_depth": 0.0})
        agg["hosts"] += 1
        agg["queue_depth"] += float(latest.get("queue_depth") or 0.0)
        for prefix in ("ttft", "tpot"):
            n = latest.get(f"{prefix}_n")
            p50 = latest.get(f"{prefix}_p50_s")
            p99 = latest.get(f"{prefix}_p99_s")
            if not n or p50 is None or p99 is None:
                continue
            agg[f"{prefix}_n"] = agg.get(f"{prefix}_n", 0.0) + float(n)
            agg[f"_{prefix}_p50_sum"] = (
                agg.get(f"_{prefix}_p50_sum", 0.0) + float(p50) * float(n)
            )
            agg[f"{prefix}_p99_s"] = max(
                agg.get(f"{prefix}_p99_s", 0.0), float(p99)
            )
    for agg in pools.values():
        for prefix in ("ttft", "tpot"):
            n = agg.get(f"{prefix}_n", 0.0)
            s = agg.pop(f"_{prefix}_p50_sum", 0.0)
            if n:
                agg[f"{prefix}_p50_s"] = round(s / n, 4)
    return pools


def build_view(app_dir: str, *, now: float | None = None) -> dict[str, Any]:
    """Everything one frame renders, as data (tests assert on this; the
    renderer only formats)."""
    now = time.time() if now is None else now
    status = {}
    try:
        with open(os.path.join(app_dir, "status.json"), encoding="utf-8") as f:
            status = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    roll = series.fleet_rollup(app_dir, now=now)
    slo_roll = slo.rollup(app_dir)
    health_roll = health_rollup(app_dir)
    lagging = {s["task"]: s for s in stragglers(app_dir)}
    # tripped SLOs/rules per proc for the status column
    slo_by_proc = {
        proc: sorted((v.get("slos") or {}))
        for proc, v in slo_roll["procs"].items()
        if v.get("verdict") == "tripped"
    }
    rows = []
    seen_tasks = set()
    for proc, rec in roll["procs"].items():
        task = _task_of_proc(proc)
        seen_tasks.add(task)
        rows.append(_row(proc, task, rec, slo_by_proc, lagging))
    # AM-rollup tasks with no local journal (remote hosts): still rows —
    # the fleet view must not depend on a shared filesystem
    am_roll = _read_am_rollup(app_dir, now)
    for tid, rec in am_roll.items():
        if tid in seen_tasks:
            continue
        rows.append(_row(tid, tid, rec, slo_by_proc, lagging))
    rows.sort(key=lambda r: r["proc"])
    return {
        "app_dir": app_dir,
        "state": str(status.get("state", "RUNNING?")),
        "ts": now,
        "rows": rows,
        "pools": _pool_rollup(rows),
        "slo": {"verdict": slo_roll["verdict"], "tripped": slo_roll["slos"]},
        "health": {"verdict": health_roll["verdict"],
                   "rules": health_roll["rules"]},
        "stragglers": sorted(lagging),
    }


def _read_am_rollup(app_dir: str, now: float) -> dict[str, dict]:
    path = os.path.join(app_dir, "series", "am_rollup.json")
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    out = {}
    for tid, rec in (raw.get("tasks") or {}).items():
        points = [p for p in rec.get("points", []) if isinstance(p, dict)]
        if not points:
            continue
        last_ts = float(rec.get("last_ts", 0.0) or 0.0)
        out[tid] = {
            "points": points,
            "latest": {k: v for k, v in points[-1].items() if k != "ts"},
            "age_s": round(max(now - last_ts, 0.0), 1),
            "n": len(points),
        }
    return out


def _row(proc: str, task: str, rec: dict, slo_by_proc: dict,
         lagging: dict) -> dict[str, Any]:
    latest = rec.get("latest", {})
    points = rec.get("points", [])
    trend_key = next((k for k in _TREND_KEYS if k in latest), None)
    trend = [
        p[trend_key] for p in points
        if isinstance(p, dict) and trend_key in p
    ] if trend_key else []
    tripped = slo_by_proc.get(proc) or slo_by_proc.get(task) or []
    flags = []
    if task in lagging:
        flags.append(f"straggler(-{lagging[task]['behind_steps']:.0f})")
    if latest.get("health_tripped"):
        flags.append("health!")
    return {
        "proc": proc,
        "task": task,
        "pool": _pool_of(task, latest),
        "latest": latest,
        "age_s": rec.get("age_s", 0.0),
        "stale": rec.get("age_s", 0.0) > 30.0,
        "trend_key": trend_key,
        "trend": trend,
        "slo": "TRIP:" + ",".join(tripped) if tripped else "ok",
        "flags": flags,
    }


def render(view: dict[str, Any]) -> str:
    """One frame as text (pure formatting over build_view's data)."""
    lines = [
        f"tony top — {os.path.basename(view['app_dir'].rstrip('/'))}  "
        f"state={view['state']}  slo={view['slo']['verdict']}  "
        f"health={view['health']['verdict']}  "
        f"{time.strftime('%H:%M:%S', time.localtime(view['ts']))}",
    ]
    if view["slo"]["tripped"]:
        lines.append(
            "  TRIPPED SLOs: " + ", ".join(sorted(view["slo"]["tripped"]))
        )
    for pool in sorted(view.get("pools") or {}):
        agg = view["pools"][pool]
        parts = [f"{pool}: {agg['hosts']} host(s)"]
        for prefix in ("ttft", "tpot"):
            if f"{prefix}_p50_s" in agg:
                parts.append(
                    f"{prefix} p50/p99 {agg[f'{prefix}_p50_s']:.3f}/"
                    f"{agg[f'{prefix}_p99_s']:.3f}s"
                )
        parts.append(f"queue {agg['queue_depth']:.0f}")
        lines.append("  pool " + "  ".join(parts))
    header = (
        f"{'proc':<26} {'pool':<8} {'age':>6} "
        + " ".join(f"{h:>9}" for h, _, _ in _VALUE_COLS)
        + f" {'trend':<18} {'slo':<14} flags"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for row in view["rows"]:
        latest = row["latest"]
        cells = []
        for _, key, fmt in _VALUE_COLS:
            v = latest.get(key)
            if v is None:
                cells.append(f"{'-':>9}")
            elif key == "hbm_live_bytes":
                cells.append(f"{v / 2**30:>9.2f}")
            else:
                cells.append(f"{fmt.format(float(v)):>9}")
        age = f"{row['age_s']:.0f}s" + ("!" if row["stale"] else "")
        trend = sparkline(row["trend"])
        if row["trend_key"]:
            trend = f"{trend} {row['trend_key'].split('_')[0]}"
        lines.append(
            f"{row['proc']:<26} {row.get('pool') or '-':<8} {age:>6} "
            + " ".join(cells)
            + f" {trend:<18} {row['slo']:<14} {' '.join(row['flags'])}"
        )
    if not view["rows"]:
        lines.append("(no series yet — job predates the recorder, or "
                     "obs.series.enabled is false)")
    return "\n".join(lines)


def run_top(app_dir: str, *, once: bool = False,
            interval_s: float = 2.0, out=None) -> int:
    """The CLI loop: redraw until Ctrl-C (or a single frame with
    ``once``). Returns 0; a tripped SLO shows in the view, not the exit
    code — ``top`` is a viewer, not a gate."""
    import sys

    out = out or sys.stdout
    while True:
        frame = render(build_view(app_dir))
        if once:
            print(frame, file=out)
            return 0
        # ANSI clear + home keeps the terminal stable between redraws
        print("\x1b[2J\x1b[H" + frame, file=out, flush=True)
        try:
            time.sleep(max(interval_s, 0.2))
        except KeyboardInterrupt:
            return 0


__all__ = ["build_view", "render", "run_top", "sparkline"]
