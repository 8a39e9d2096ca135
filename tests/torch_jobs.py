"""Run one job through both packages' clients on the local backend and
compare what each ends with (the job tests of ``tests/test_torch_jobs_*.py``).

A job is a dict of config overrides, submitted through ``tony_tpu``'s and
``tony_tpu_torch``'s ``TonyClient`` side by side (two threads: each job
mostly waits on its processes). :func:`outcome` reduces a finished job to
what must match across the packages: the client's exit code, the final
state, each task's state and attempts in ``status.json``, and the history's
event types, per task in order (tasks race each other, a task's own events
do not) and the task-less ones in order. ``METRICS`` events are left out:
the executor's sampler pushes on a clock.
"""

from __future__ import annotations

import json
import os
import threading
from collections import defaultdict

from tony_tpu.am.events import read_history as ref_read_history
from tony_tpu.chaos.invariants import check_invariants as ref_check_invariants
from tony_tpu.cli.client import TonyClient as RefClient
from tony_tpu.config.config import TonyConfig as RefConfig
from tony_tpu_torch.am.events import read_history
from tony_tpu_torch.chaos.invariants import check_invariants
from tony_tpu_torch.cli.client import TonyClient
from tony_tpu_torch.config.config import TonyConfig

# the reference's e2e cadence (tests/test_e2e.py FAST)
FAST = {
    "task.heartbeat_interval_ms": 200,
    "task.max_missed_heartbeats": 10,
    "application.timeout_s": 90,
}
PACKAGES = {"ref": (RefConfig, RefClient, ref_read_history),
            "port": (TonyConfig, TonyClient, read_history)}


def client(pkg: str, root, overrides: dict, src_dir: str = ""):
    conf, cls, _ = PACKAGES[pkg]
    stage = os.path.join(str(root), pkg)
    os.makedirs(stage, exist_ok=True)
    cfg = conf.load(overrides={**FAST, "application.stage_dir": stage, **overrides})
    return cls(cfg, src_dir=src_dir)


def submit(pkg: str, root, overrides: dict, src_dir: str = "") -> tuple[int, str]:
    c = client(pkg, root, overrides, src_dir)
    return c.run(quiet=True), c.app_dir


def submit_both(root, overrides: dict, src_dir: str = "", **per_pkg) -> dict:
    """Both packages' jobs at once; ``per_pkg`` maps "ref"/"port" to extra
    overrides (a marker path each, say). Returns {pkg: (code, app_dir)}."""
    out: dict = {}

    def run(pkg):
        out[pkg] = submit(pkg, root, {**overrides, **per_pkg.get(pkg, {})}, src_dir)

    threads = [threading.Thread(target=run, args=(p,)) for p in PACKAGES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert set(out) == set(PACKAGES), f"a job did not finish: {out}"
    return out


def status(app_dir: str) -> dict:
    with open(os.path.join(app_dir, "status.json")) as f:
        return json.load(f)


def events(app_dir: str) -> list[dict]:
    ev_dir = os.path.join(app_dir, "events")
    (name,) = [f for f in os.listdir(ev_dir) if f.endswith(".jsonl")]
    return read_history(os.path.join(ev_dir, name))


def outcome(code: int, app_dir: str, racy: tuple[str, ...] = ()) -> dict:
    """What must match across the packages; the tasks in ``racy`` (whose
    end races the job's teardown) keep only their first events."""
    st = status(app_dir)
    per_task: dict[str, list[str]] = defaultdict(list)
    global_: list[str] = []
    for e in events(app_dir):
        if e["type"] == "METRICS":
            continue
        if "task" in e:
            per_task[e["task"]].append(e["type"] + (f":{e['state']}" if "state" in e else ""))
        else:
            global_.append(e["type"])
    for t in racy:
        per_task[t] = per_task[t][:2]
    return {
        "code": code, "state": st["state"], "exit_code": st["exit_code"],
        "tasks": {t["task"]: (t["state"], t["attempts"]) for t in st["tasks"]
                  if t["task"] not in racy},
        "events": dict(per_task), "global": global_,
    }


def assert_same(runs: dict, racy: tuple[str, ...] = ()) -> dict:
    ref, port = (outcome(*runs[p], racy=racy) for p in ("ref", "port"))
    assert ref == port, (ref, port)
    return port


def check_both(app_dirs, rm_root: str = ""):
    """The post-mortem invariant report over ``app_dirs`` (and the lease
    store at ``rm_root``) from the reference's checker and from the port's:
    held equal, the port's returned."""
    ref = ref_check_invariants(app_dirs, rm_root=rm_root)
    port = check_invariants(app_dirs, rm_root=rm_root)
    assert port.to_dict() == ref.to_dict(), (ref.to_json(), port.to_json())
    return port


def log_tails(app_dir: str, n: int = 3000) -> str:
    logs = os.path.join(app_dir, "logs")
    return "\n".join(f"===== {f}\n" + open(os.path.join(logs, f), errors="replace").read()[-n:]
                     for f in sorted(os.listdir(logs)))


__all__ = ["FAST", "PACKAGES", "assert_same", "check_both", "client", "events",
           "log_tails", "outcome",
           "status", "submit", "submit_both"]
