"""Jobs under the reference's chaos schedules (``tests/test_chaos.py``'s
scenarios), through both packages' client, AM, local backend and executor
at once: the same exit code, final state, task states and event types
(``tests/torch_jobs.py``), and the post-mortem invariant checkers of both
packages (``chaos/invariants.py``) clean and equal on both packages'
artifacts, which share their formats."""

import json
import time

from tony_tpu.cluster.lease import LeaseStore
from torch_jobs import assert_same, check_both, status, submit_both


def chaos_both(tmp_path, overrides: dict, faults: list, **per_pkg):
    runs = submit_both(tmp_path, {"application.framework": "generic",
                                  "chaos.enabled": True, "chaos.faults": json.dumps(faults),
                                  **overrides}, **per_pkg)
    for pkg, (_, app_dir) in runs.items():
        rm_root = per_pkg.get(pkg, {}).get("cluster.rm_root", "")
        report = check_both([app_dir], rm_root=rm_root)
        assert report.ok, (pkg, report.to_json())
    return runs


def test_kill_container_restarts_the_gang(tmp_path):
    runs = chaos_both(tmp_path, {
        "application.name": "chaos-killc", "restart.policy": "gang",
        "restart.max_worker_restarts": 2, "job.worker.instances": 2,
        "job.worker.command": 'python -c "import time; time.sleep(2)"',
    }, [{"type": "kill_container", "task": "worker:0", "at_count": 2}])
    out = assert_same(runs)
    assert out["code"] == 0 and all(a == 2 for _, a in out["tasks"].values())
    assert "GANG_RESTART" in out["global"]


def test_kill_am_recovers_and_returns_the_leases(tmp_path):
    """The AM dies at supervision tick 3 with leases in a shared store; the
    successor reaps, re-leases, finishes, and the store ends empty."""
    rm = {pkg: {"cluster.rm_root": str(tmp_path / f"rm_{pkg}")} for pkg in ("ref", "port")}
    runs = chaos_both(tmp_path, {
        "application.name": "chaos-killam", "am.retry_count": 1,
        "job.worker.instances": 2,
        "job.worker.command": 'python -c "import time; time.sleep(4)"',
    }, [{"type": "kill_am", "at_count": 3}], **rm)
    got = {}
    for pkg, (code, app_dir) in runs.items():
        with open(f"{app_dir}/am.state.json") as f:
            snap = json.load(f)
        summary = LeaseStore(rm[pkg]["cluster.rm_root"]).summary()
        got[pkg] = (code, status(app_dir)["state"], snap["am_attempt"],
                    snap["generation"] >= 1, summary["apps"], summary["queue"])
    assert got["ref"] == got["port"] == (0, "SUCCEEDED", 1, True, {}, [])


def test_hung_store_fences_and_the_client_sees_failed(tmp_path):
    """The store hangs in the AM: the lease keeper goes silent, the
    staleness fence fires at ttl/2, teardown skips the release that would
    wedge, and the client sees FAILED well before the app timeout."""
    rm = {pkg: {"cluster.rm_root": str(tmp_path / f"rm_{pkg}")} for pkg in ("ref", "port")}
    t0 = time.monotonic()
    runs = chaos_both(tmp_path, {
        "application.name": "chaos-hang", "cluster.lease_ttl_s": 2,
        "application.timeout_s": 60, "job.worker.instances": 1,
        "job.worker.command": 'python -c "import time; time.sleep(30)"',
    }, [{"type": "hang_store", "after_s": 3, "duration_s": 120, "role": "am"}], **rm)
    took = time.monotonic() - t0
    out = assert_same(runs, racy=("worker:0",))
    assert out["code"] != 0 and out["state"] == "FAILED"
    for _, app_dir in runs.values():
        assert "leases lost" in status(app_dir)["diagnostics"]
    assert took < 25, f"fence took {took:.1f} s: teardown blocked on the hung store?"


def test_dropped_heartbeats_lose_the_task(tmp_path):
    runs = chaos_both(tmp_path, {
        "application.name": "chaos-hbdrop", "task.heartbeat_interval_ms": 100,
        "task.max_missed_heartbeats": 5, "job.worker.instances": 1,
        "job.worker.command": 'python -c "import time; time.sleep(30)"',
    }, [{"type": "drop_heartbeats", "task": "worker:0", "from_count": 3}])
    out = assert_same(runs)
    assert out["code"] != 0 and out["tasks"]["worker:0"] == ("LOST", 1)
