"""Jobs through both packages' client, AM, local backend and executor (the
first half of ``tests/test_e2e.py``'s cases): the same exit code, final
state, task states and event types (``tests/torch_jobs.py``)."""

import sys

from torch_jobs import assert_same, events, status, submit_both


def test_two_generic_workers(tmp_path):
    runs = submit_both(tmp_path, {
        "application.name": "ok",
        "application.framework": "generic",
        "job.worker.instances": 2,
        "job.worker.command": (
            'python -c "import os, json; '
            "spec = json.loads(os.environ['TONY_CLUSTER_SPEC']); "
            'assert len(spec[\'worker\']) == 2"'),
    })
    out = assert_same(runs)
    assert out["code"] == 0 and out["state"] == "SUCCEEDED"
    assert out["global"] == ["APPLICATION_INITED", "APPLICATION_FINISHED"]
    assert out["events"]["worker:0"] == ["TASK_STARTED", "TASK_REGISTERED",
                                         "TASK_FINISHED:SUCCEEDED"]


def test_exit_code_propagates(tmp_path):
    """Worker 1 exits 7: the job fails with 7. Worker 0's end races the
    teardown, so only its first events are compared."""
    runs = submit_both(tmp_path, {
        "application.name": "fail",
        "application.framework": "generic",
        "job.worker.instances": 2,
        "job.worker.command": (
            "python -c \"import os, sys; "
            "sys.exit(7 if os.environ['TONY_TASK_INDEX'] == '1' else 0)\""),
    })
    out = assert_same(runs, racy=("worker:0",))
    assert out["code"] == 7 and out["state"] == "FAILED"
    assert out["tasks"]["worker:1"] == ("FAILED", 1)


def test_untracked_type_never_fails_the_job(tmp_path):
    runs = submit_both(tmp_path, {
        "application.name": "untracked",
        "application.framework": "generic",
        "job.worker.instances": 1,
        "job.worker.command": 'python -c "pass"',
        "job.tensorboard.instances": 1,
        "job.tensorboard.untracked": True,
        "job.tensorboard.command": 'python -c "import time; time.sleep(600)"',
    })
    out = assert_same(runs, racy=("tensorboard:0",))
    assert out["code"] == 0 and out["state"] == "SUCCEEDED"


def test_ps_worker_dependency_under_the_tf_runtime(tmp_path):
    """FCFS with workers depending on ps, TF_CONFIG from the tensorflow
    runtime."""
    check = (
        'python -c "import os, json; tf = json.loads(os.environ[\'TF_CONFIG\']); '
        "assert set(tf['cluster']) == {'ps', 'worker'}; "
        "assert tf['task']['type'] == os.environ['TONY_JOB_NAME']\"")
    runs = submit_both(tmp_path, {
        "application.name": "psworker",
        "application.framework": "tensorflow",
        "scheduler.mode": "FCFS",
        "job.ps.instances": 1,
        "job.ps.command": check,
        "job.worker.instances": 2,
        "job.worker.depends_on": "ps",
        "job.worker.depends_timeout_s": 30,
        "job.worker.command": check,
    })
    out = assert_same(runs)
    assert out["code"] == 0 and set(out["tasks"]) == {"ps:0", "worker:0", "worker:1"}


def test_failed_only_restart(tmp_path):
    """Fail once, restart the failed task alone, succeed."""
    def script(marker):
        return (f'{sys.executable} -c "import os, sys; p = {str(marker)!r}; '
                "first = not os.path.exists(p); open(p, 'a').write('x'); "
                'sys.exit(1 if first else 0)"')
    base = {"application.name": "restart", "application.framework": "generic",
            "restart.policy": "failed_only", "restart.max_worker_restarts": 2,
            "job.worker.instances": 1}
    runs = submit_both(tmp_path, base, **{
        pkg: {"job.worker.command": script(tmp_path / f"{pkg}.marker")}
        for pkg in ("ref", "port")})
    out = assert_same(runs)
    assert out["code"] == 0 and out["tasks"]["worker:0"] == ("SUCCEEDED", 2)
    assert out["events"]["worker:0"] == [
        "TASK_STARTED", "TASK_REGISTERED", "TASK_FINISHED:FAILED",
        "TASK_STARTED", "TASK_REGISTERED", "TASK_FINISHED:SUCCEEDED"]


def test_gang_restart_restarts_every_worker(tmp_path):
    """Worker 0 fails on the first attempt: the whole gang restarts, and
    both workers succeed on the second."""
    def script(marker):
        return (f'{sys.executable} -c "import os, sys, time; p = {str(marker)!r}; '
                "idx = os.environ['TONY_TASK_INDEX']; first = not os.path.exists(p); "
                "(open(p, 'a').write('x'), sys.exit(1)) if (first and idx == '0') "
                "else time.sleep(3 if first else 0)\"")
    base = {"application.name": "gang", "application.framework": "generic",
            "restart.policy": "gang", "restart.max_worker_restarts": 2,
            "job.worker.instances": 2}
    runs = submit_both(tmp_path, base, **{
        pkg: {"job.worker.command": script(tmp_path / f"{pkg}.marker")}
        for pkg in ("ref", "port")})
    # worker 1's first attempt ends after its 3 s sleep unless the restart
    # kills it first: under load either comes first, in either package, so
    # that one event is left out; the rest of its list and its status are held
    out = assert_same(runs, racy=("worker:1",))
    assert out["code"] == 0 and out["tasks"] == {"worker:0": ("SUCCEEDED", 2)}
    assert out["global"] == ["APPLICATION_INITED", "GANG_RESTART", "APPLICATION_FINISHED"]
    for code, app_dir in runs.values():
        tasks = {t["task"]: (t["state"], t["attempts"]) for t in status(app_dir)["tasks"]}
        assert tasks["worker:1"] == ("SUCCEEDED", 2)
        ev = [e["type"] + (f":{e['state']}" if "state" in e else "")
              for e in events(app_dir) if e.get("task") == "worker:1"
              and e["type"] != "METRICS"]
        first = ev[:ev.index("TASK_STARTED", 1)]
        assert first in (["TASK_STARTED", "TASK_REGISTERED"],
                         ["TASK_STARTED", "TASK_REGISTERED", "TASK_FINISHED:SUCCEEDED"]), ev
        assert ev[len(first):] == ["TASK_STARTED", "TASK_REGISTERED",
                                   "TASK_FINISHED:SUCCEEDED"], ev
