"""Step anatomy: where one training or decode step's time goes. The
counterpart of ``tony_tpu/obs/anatomy.py``.

Per captured step, a budget — **compute / exposed-collective /
host-blocked / input-wait** — whose rows sum to the measured step time,
plus per-collective achieved bandwidth and the compute/collective overlap
fraction. The interval algebra, :func:`step_budget`,
:func:`collective_table`, :func:`proc_report` and :func:`build_anatomy`
are the reference's. Inputs are what a coordinated capture
(``obs/profile.py``) landed under ``<app_dir>/profile/<proc>/<id>/``:

- the **manifest** (host step boundaries and per-step input wait,
  measured at the ``maybe_capture`` seam; ``read_manifests``);
- the **Chrome trace** ``torch.profiler`` wrote (``trace.json``), whose
  ``anatomy.step`` regions bracket each captured step on the timeline;
- the **comms ledger** of the window (``comms.json``, ``obs/comms.py``):
  what each kind of collective moved, paired with its measured time BY
  KIND (the trace's collective events carry no call site) to yield
  achieved GB/s.

Classification (:func:`load_device_trace`): CUDA kernels are compute
(the port's ``csrc/`` kernels among them), NCCL kernels collectives;
gloo's collective ops (``gloo:*`` on its worker threads, ``c10d::*``
where the rank issues them) and the host-staged copies ``parallel/dist.py``
makes for gloo over CUDA tensors (its ``comms.*`` regions, and the device
copies inside them) are collectives. A capture with no kernels is a CPU
run: there the ``aten::`` ops on the thread that holds the
``anatomy.step`` regions are compute.

Attribution rule (the reference's, stated once): within a step window,
compute is the union of compute intervals; the part of collective time
not overlapped by compute is *exposed*; input-wait is the host fetch the
seam recorded; host-blocked is the non-negative residual — so the four
rows sum to the measured step time by construction.

Stdlib-only: the report builds in deviceless processes.
"""

from __future__ import annotations

import json
import os
from typing import Any

from tony_tpu_torch.obs import comms
from tony_tpu_torch.obs import profile as profile_mod

# --- interval algebra ---------------------------------------------------------


def _merge(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted union of half-open intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _total(merged: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def _clip(merged: list[tuple[float, float]],
          window: tuple[float, float]) -> list[tuple[float, float]]:
    ws, we = window
    return [(max(s, ws), min(e, we)) for s, e in merged
            if min(e, we) > max(s, ws)]


def _subtract(a: list[tuple[float, float]],
              b: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """a minus b, both merged; the exposed-collective computation."""
    out: list[tuple[float, float]] = []
    bi = 0
    for s, e in a:
        cur = s
        while bi < len(b) and b[bi][1] <= cur:
            bi += 1
        j = bi
        while j < len(b) and b[j][0] < e:
            bs, be = b[j]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            j += 1
        if cur < e:
            out.append((cur, e))
    return out


# --- trace parsing ------------------------------------------------------------

# substrings of a collective event's name (lower case, no '_') -> its kind
_KIND_OF = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
            ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
            ("broadcast", "collective-broadcast"), ("sendrecv", "collective-permute"),
            ("send", "collective-permute"), ("recv", "collective-permute"))


def collective_kind(name: str) -> str:
    """The reference's kind of a collective event (``gloo:all_reduce``,
    ``ncclDevKernel_AllGather_RING_LL``, ``comms.all-gather``); '' when
    the name says none."""
    if name.startswith("comms."):
        return name[len("comms."):]
    flat = name.lower().replace("_", "").replace("-", "")
    for key, kind in _KIND_OF:
        if key in flat:
            return kind
    return ""


def _trace_files(artifact: str) -> list[str]:
    if os.path.isfile(artifact):
        return [artifact]
    if not artifact or not os.path.isdir(artifact):
        return []
    return [os.path.join(artifact, n) for n in sorted(os.listdir(artifact))
            if n.endswith(".json") and n != profile_mod.MANIFEST_FILE
            and n != comms.LEDGER_FILE]


def load_device_trace(artifact: str) -> dict[str, Any]:
    """Parse the Chrome trace of one capture (the manifest's ``artifact``:
    the trace file, or the directory holding it) into step windows and
    compute / collective intervals (seconds, trace timebase); see the
    module's docstring for the classification. ``collective_events`` are
    the collectives' own ops (gloo's and NCCL's), named by kind, for the
    per-collective table."""
    out: dict[str, Any] = {
        "found": False, "step_windows": [], "compute": [], "collective": [],
        "collective_events": [], "files": [],
    }
    for path in _trace_files(artifact):
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        events = [e for e in data.get("traceEvents") or [] if e.get("ph") == "X"]
        steps = [e for e in events if e.get("name") == profile_mod.STEP_ANNOTATION
                 and e.get("cat") == "user_annotation"]
        main = {e.get("tid") for e in steps}
        on_device = any(e.get("cat") == "kernel" for e in events)
        staged = _merge([(float(e["ts"]) / 1e6, (float(e["ts"]) + float(e.get("dur", 0))) / 1e6)
                         for e in events if str(e.get("name", "")).startswith("comms.")])
        for e in events:
            name, cat = str(e.get("name", "")), e.get("cat")
            ts = float(e.get("ts", 0.0)) / 1e6
            iv = (ts, ts + float(e.get("dur", 0.0)) / 1e6)
            if name == profile_mod.STEP_ANNOTATION:
                if cat == "user_annotation":
                    out["step_windows"].append(iv)
                continue
            if cat == "kernel":
                if "nccl" in name.lower():
                    out["collective"].append(iv)
                    out["collective_events"].append(
                        {"name": collective_kind(name) or name, "ts": ts, "dur_s": iv[1] - ts})
                else:
                    out["compute"].append(iv)
            elif cat in ("gpu_memcpy", "gpu_memset"):
                # a copy inside a comms.* region is a gloo transfer's staging
                inside = any(s < iv[1] and iv[0] < e_ for s, e_ in staged)
                out["collective" if inside else "compute"].append(iv)
            elif name.startswith(("comms.", "c10d::", "gloo:")):
                out["collective"].append(iv)
                if name.startswith("gloo:"):      # the transfer itself, once a call
                    out["collective_events"].append(
                        {"name": collective_kind(name) or name, "ts": ts,
                         "dur_s": iv[1] - ts})
            elif (not on_device and cat == "cpu_op" and name.startswith("aten::")
                  and e.get("tid") in main):
                out["compute"].append(iv)
        out["files"].append(os.path.basename(path))
        out["found"] = True
    out["step_windows"].sort()
    return out


# --- the budget table ---------------------------------------------------------


def step_budget(manifest: dict[str, Any],
                trace_data: dict[str, Any]) -> dict[str, Any]:
    """Per-step budget rows for one process's capture (see the module
    docstring for the attribution rule)."""
    step_times = [float(x) for x in manifest.get("step_time_s", [])]
    waits = [float(x) for x in manifest.get("input_wait_s", [])]
    windows = list(trace_data.get("step_windows", []))
    compute_all = _merge(trace_data.get("compute", []))
    coll_all = _merge(trace_data.get("collective", []))
    device_trace = bool(trace_data.get("found")) and bool(
        compute_all or coll_all
    )
    rows: list[dict[str, Any]] = []
    tot = {"step_time_s": 0.0, "compute_s": 0.0, "exposed_collective_s": 0.0,
           "input_wait_s": 0.0, "host_blocked_s": 0.0, "collective_s": 0.0}
    # overlap accumulators EXCLUDE pure-comm steps (collective time with
    # zero compute in the window — a sync barrier, an init broadcast): such
    # a step has no compute to hide under, so its collective time is 100%
    # exposed by construction and would dilute overlap_frac — one barrier
    # step could mask a real overlap regression in the training steps
    ov_coll = ov_exposed = 0.0
    pure_comm_steps = 0
    for i, step_time in enumerate(step_times):
        wait = waits[i] if i < len(waits) else 0.0
        compute_s = exposed_s = coll_s = 0.0
        if device_trace and i < len(windows):
            w = windows[i]
            compute = _clip(compute_all, w)
            coll = _clip(coll_all, w)
            compute_s = _total(compute)
            coll_s = _total(coll)
            exposed_s = _total(_subtract(coll, compute))
        host = max(step_time - compute_s - exposed_s - wait, 0.0)
        pure_comm = coll_s > 0.0 and compute_s == 0.0
        row = {
            "step": i + 1,
            "step_time_s": round(step_time, 6),
            "compute_s": round(compute_s, 6),
            "exposed_collective_s": round(exposed_s, 6),
            "input_wait_s": round(wait, 6),
            "host_blocked_s": round(host, 6),
        }
        if pure_comm:
            row["pure_comm"] = True
            pure_comm_steps += 1
        else:
            ov_coll += coll_s
            ov_exposed += exposed_s
        rows.append(row)
        tot["step_time_s"] += step_time
        tot["compute_s"] += compute_s
        tot["exposed_collective_s"] += exposed_s
        tot["input_wait_s"] += wait
        tot["host_blocked_s"] += host
        tot["collective_s"] += coll_s
    n = max(len(rows), 1)
    out = {
        "steps": len(rows),
        "device_trace": device_trace,
        "table": rows,
        "totals": {k: round(v, 6) for k, v in tot.items()},
        "per_step_ms": {
            k: round(tot[k] / n * 1e3, 3)
            for k in ("step_time_s", "compute_s", "exposed_collective_s",
                      "input_wait_s", "host_blocked_s")
        },
    }
    if pure_comm_steps:
        out["pure_comm_steps"] = pure_comm_steps
    if ov_coll > 0:
        # fraction of collective time hidden under compute: the overlap
        # number `tony perf diff` judges higher-is-better. Pure-comm steps
        # are excluded (flagged per row) — they have nothing to overlap.
        out["overlap_frac"] = round(1.0 - ov_exposed / ov_coll, 4)
    return out


def collective_table(trace_data: dict[str, Any],
                     ledger_rows: list[dict[str, Any]] | None
                     ) -> list[dict[str, Any]]:
    """Per-collective rows: static bytes/replica-groups from the compile
    ledger (obs/comms.py) joined with measured device-trace time BY OP
    NAME; achieved bandwidth where both sides exist. Ledger-only rows
    (never executed in the window) and trace-only rows (no AOT entry —
    e.g. a lazily jitted fn) are kept, flagged by what they miss — the
    table never silently drops either side."""
    measured: dict[str, dict[str, float]] = {}
    for ev in trace_data.get("collective_events", []):
        m = measured.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        m["count"] += 1
        m["total_s"] += ev["dur_s"]
    by_name: dict[str, dict[str, Any]] = {}
    for row in ledger_rows or []:
        by_name.setdefault(row["name"], {
            "name": row["name"], "kind": row["kind"],
            "bytes": int(row.get("bytes", 0)),
            "replica_groups": row.get("replica_groups", ""),
        })
    for name, m in measured.items():
        entry = by_name.setdefault(name, {
            "name": name, "kind": name.split(".")[0], "bytes": 0,
            "replica_groups": "",
        })
        entry["count"] = int(m["count"])
        entry["total_s"] = round(m["total_s"], 6)
        entry["mean_us"] = round(m["total_s"] / m["count"] * 1e6, 3)
        if entry["bytes"] and m["total_s"] > 0:
            # 4 significant figures, not fixed decimals: CPU-test and DCN
            # bandwidths live orders of magnitude below ICI ones
            entry["achieved_gbps"] = float(
                f"{entry['bytes'] * m['count'] / m['total_s'] / 1e9:.4g}"
            )
    rows = sorted(
        by_name.values(),
        key=lambda r: (-r.get("total_s", 0.0), -r.get("bytes", 0), r["name"]),
    )
    return rows


def ledger_collectives(ledger_payload: dict[str, Any] | None
                       ) -> list[dict[str, Any]]:
    """Flatten one process's compile-ledger snapshot (obs/compiles.py) to
    its AOT entries' collective rows, tagged with the entry fn."""
    rows: list[dict[str, Any]] = []
    for entry in (ledger_payload or {}).get("entries", []) or []:
        for c in entry.get("collectives") or []:
            rows.append({**c, "fn": entry.get("fn", "")})
    return rows


def kind_rows(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Ledger rows summed by the kind the transport runs (``runs_as``:
    gloo's reduce-scatter is an all-reduce) and named by it, ``bytes`` the
    mean payload a call: the side :func:`collective_table` joins with a
    trace's collective events, which are named by kind."""
    merged: dict[str, dict[str, Any]] = {}
    for r in rows:
        kind = r.get("runs_as") or r["kind"]
        m = merged.setdefault(kind, {"name": kind, "kind": kind, "calls": 0,
                                     "total_bytes": 0, "replica_groups": []})
        calls = int(r.get("calls", 1))
        m["calls"] += calls
        m["total_bytes"] += int(r.get("total_bytes", r.get("bytes", 0) * calls))
        m["replica_groups"] += [g for g in r.get("replica_groups") or []
                                if g not in m["replica_groups"]]
    return [dict(m, bytes=m["total_bytes"] // max(m["calls"], 1)) for m in merged.values()]


def proc_report(manifest: dict[str, Any],
                ledger_rows: list[dict[str, Any]] | None = None
                ) -> dict[str, Any]:
    """The full anatomy of ONE process's capture; ``ledger_rows`` default
    to the window's comms ledger beside the manifest, by kind."""
    trace_data = load_device_trace(manifest.get("artifact", ""))
    budget = step_budget(manifest, trace_data)
    if ledger_rows is None:
        ledger_rows = kind_rows(ledger_collectives(
            comms.read_window(manifest.get("out_dir", ""))))
    colls = collective_table(trace_data, ledger_rows)
    return {
        "profile_id": manifest.get("profile_id", ""),
        "proc": manifest.get("proc", ""),
        "artifact": manifest.get("artifact", ""),
        **budget,
        "collectives": colls,
    }


def build_anatomy(app_dir: str, profile_id: str = "") -> dict[str, Any]:
    """``tony profile report``: every process's budget table + collective
    rows for one capture (newest when unspecified; each process's comms
    ledger of the window beside its manifest), plus the cross-rank
    critical path — per aligned step, the process whose step took longest
    is the one gating the gang (pipeline stage or decode host alike)."""
    manifests = profile_mod.read_manifests(app_dir, profile_id)
    out: dict[str, Any] = {"profile_id": profile_id, "procs": {}}
    if not manifests:
        return out
    for proc, manifest in sorted(manifests.items()):
        out["profile_id"] = manifest.get("profile_id", profile_id)
        out["procs"][proc] = proc_report(manifest)
    # critical path: per step index, the slowest process owns the fleet's
    # wall clock for that step
    by_step: list[dict[str, Any]] = []
    n_steps = max(
        (r["steps"] for r in out["procs"].values()), default=0
    )
    dominated: dict[str, int] = {}
    for i in range(n_steps):
        best_proc, best_t = "", -1.0
        for proc, rep in out["procs"].items():
            if i < len(rep["table"]):
                t = rep["table"][i]["step_time_s"]
                if t > best_t:
                    best_proc, best_t = proc, t
        if best_proc:
            by_step.append({
                "step": i + 1, "proc": best_proc,
                "step_time_s": round(best_t, 6),
            })
            dominated[best_proc] = dominated.get(best_proc, 0) + 1
    if by_step:
        out["critical_path"] = {
            "proc": max(dominated, key=dominated.get),
            "dominated_steps": dominated,
            "by_step": by_step,
        }
    return out


__all__ = [
    "build_anatomy", "collective_kind", "collective_table", "kind_rows",
    "ledger_collectives", "load_device_trace", "proc_report", "step_budget",
]
