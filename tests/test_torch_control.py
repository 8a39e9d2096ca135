"""The port's control plane held against the reference's, unit by unit.

Each test drives the same inputs through ``tony_tpu`` and ``tony_tpu_torch``
(config layering, the AM's session and scheduler, the history files, the
shared lease store, the runtimes' env, the ApplicationRpc service, the chaos
schedule parser) and compares what comes out, exactly unless a test says
otherwise. The port's differences by design are named where they show: the
``application.framework`` default (``pytorch``), no ``jax`` runtime, no
``TONY_JAX_CACHE_DIR``. Also here: fit()'s job env (the checkpoint half of
``apply_job_env``) and the control plane's import weight (no torch, no
numpy). Nothing needs a card.
"""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import grpc
import pytest
from google.protobuf import json_format

import tony_tpu.am.app_master as ram
import tony_tpu.am.events as rev
import tony_tpu.am.scheduler as rsch
import tony_tpu.am.session as rses
import tony_tpu.chaos.faults as rfaults
import tony_tpu.cluster.backend as rback
import tony_tpu.cluster.lease as rlease
import tony_tpu.config.config as rconf
import tony_tpu.rpc as rrpc
import tony_tpu.rpc.service as rservice
import tony_tpu.runtime as rrt
import tony_tpu_torch.am.app_master as pam
import tony_tpu_torch.am.events as pev
import tony_tpu_torch.am.scheduler as psch
import tony_tpu_torch.am.session as pses
import tony_tpu_torch.chaos.faults as pfaults
import tony_tpu_torch.cluster.backend as pback
import tony_tpu_torch.cluster.lease as please
import tony_tpu_torch.config.config as pconf
import tony_tpu_torch.rpc as prpc
import tony_tpu_torch.rpc.service as pservice
import tony_tpu_torch.runtime as prt

ROOT = Path(__file__).resolve().parent.parent
PKGS = {
    "ref": dict(conf=rconf, ses=rses, sch=rsch, ev=rev, back=rback, lease=rlease,
                rpc=rrpc, service=rservice, rt=rrt, am=ram, faults=rfaults, name="tony_tpu"),
    "port": dict(conf=pconf, ses=pses, sch=psch, ev=pev, back=pback, lease=please,
                 rpc=prpc, service=pservice, rt=prt, am=pam, faults=pfaults,
                 name="tony_tpu_torch"),
}
FRAMEWORK = "application.framework"

TOML = """
[application]
name = "layered"
timeout_s = 30
tags = "a,b"

[job.worker]
instances = 2
memory_mb = 1024
tpu_chips = 4
command = "python train.py"
env = ["A=1", "B=two"]

[job.ps]
instances = 1
untracked = true
depends_timeout_s = 5

[checkpoint]
dir = "/ckpt"
interval_steps = 50
"""


# --- config --------------------------------------------------------------------

@pytest.mark.parametrize("framework_in_file", [False, True])
def test_config_layers_equal_but_the_framework_default(tmp_path, monkeypatch,
                                                       framework_in_file):
    """Defaults, a TOML file, ``-D`` overrides and ``TONY_CONF_*`` layered in
    both packages: equal dicts and task specs, except the framework default
    (the port's is ``pytorch``) when nothing sets it."""
    path = tmp_path / "job.toml"
    path.write_text(TOML.replace('name = "layered"', 'name = "layered"\nframework = '
                                 '"tensorflow"') if framework_in_file else TOML)
    monkeypatch.setenv("TONY_CONF_AM__RETRY_COUNT", "2")
    monkeypatch.setenv("TONY_CONF_RESTART__POLICY", "gang")
    overrides = ["job.worker.instances=3", "task.heartbeat_interval_ms=250",
                 "checkpoint.keep=5", "application.security.enabled=true"]
    r = rconf.TonyConfig.load(path, overrides=overrides, read_env=True)
    p = pconf.TonyConfig.load(path, overrides=overrides, read_env=True)
    rd, pd = r.to_dict(), p.to_dict()
    if framework_in_file:
        assert rd == pd and pd[FRAMEWORK] == "tensorflow"
    else:
        assert (rd.pop(FRAMEWORK), pd.pop(FRAMEWORK)) == ("jax", "pytorch")
        assert rd == pd
    assert pd["am.retry_count"] == 2 and pd["job.worker.instances"] == 3
    assert {n: s.to_dict() for n, s in r.task_specs().items()} == \
        {n: s.to_dict() for n, s in p.task_specs().items()}
    # a config shipped by one package's client loads in the other's AM
    assert pconf.TonyConfig.from_json(r.to_json()).to_dict() == r.to_dict()
    assert rconf.TonyConfig.from_json(p.to_json()).to_dict() == p.to_dict()


def test_config_keys_and_defaults_are_the_references():
    from tony_tpu.config import keys as rkeys
    from tony_tpu_torch.config import keys as pkeys

    names = {k for k in vars(rkeys.Keys) if k.isupper()}
    assert names == {k for k in vars(pkeys.Keys) if k.isupper()}
    assert {k: getattr(rkeys.Keys, k) for k in names} == \
        {k: getattr(pkeys.Keys, k) for k in names}
    r, p = dict(rkeys.DEFAULTS), dict(pkeys.DEFAULTS)
    assert (r.pop(FRAMEWORK), p.pop(FRAMEWORK)) == ("jax", "pytorch")
    assert r == p and rkeys.JOB_SUFFIXES == pkeys.JOB_SUFFIXES


# --- session --------------------------------------------------------------------

def _specs(m):
    T = m["conf"].TaskTypeSpec
    return {"worker": T(name="worker", instances=2), "ps": T(name="ps", instances=1),
            "tensorboard": T(name="tensorboard", instances=1, untracked=True)}


def _session_snapshot(s):
    with s.lock:
        return {
            "state": s.state.value, "generation": s.generation,
            "tasks": {tid: (t.state.value, t.host, t.port, t.exit_code, t.attempt,
                            t.restarts) for tid, t in sorted(s.tasks.items())},
            "spec": s.cluster_spec_json(), "ranks": s.rank_table(),
            "coord": s.coordinator_task().task_id if s.coordinator_task() else None,
            "all_registered": s.all_registered(), "done": s.job_done(),
            "final": (s.final_status()[0].value, s.final_status()[1]),
            "failed": sorted(t.task_id for t in s.failed_tasks()),
        }


def _session_trace(m, chief: bool):
    specs = _specs(m)
    if chief:
        specs["chief"] = m["conf"].TaskTypeSpec(name="chief", instances=1)
    s = m["ses"].Session(specs, chief_type="chief" if chief else "")
    out = [_session_snapshot(s)]
    ops = [
        lambda: s.register("worker", 0, "h0", 100, 0),
        lambda: s.register("worker", 1, "h1", 101, 1),        # stale attempt
        lambda: s.register("nope", 0, "h", 1, 0),             # unknown task
        lambda: s.register("worker", 1, "h1", 101, 0),
        lambda: s.register("ps", 0, "hp", 200, 0),
        lambda: s.register("tensorboard", 0, "ht", 300, 0),
        lambda: s.register("chief", 0, "hc", 400, 0) if chief else None,
        lambda: s.touch("worker", 0, 0),
        lambda: s.touch("worker", 0, 3),
        lambda: s.mark_running("worker", 0),
        lambda: s.mark_running("ps", 0),
        lambda: s.on_task_completed("worker", 0, 0),
        lambda: s.on_task_completed("worker", 0, 5),          # already terminal
        lambda: s.on_task_lost("ps", 0),
        lambda: s.on_task_completed("worker", 1, 7),
        lambda: sorted(t.task_id for t in s.reset_for_restart({"worker"})),
        lambda: s.register("worker", 0, "h0", 102, 1),
        lambda: s.on_task_completed("chief", 0, 0) if chief else None,
        lambda: sorted(t.task_id for t in s.reset_for_restart(None)),
    ]
    for op in ops:
        out.append((op(), _session_snapshot(s)))
    return out


@pytest.mark.parametrize("chief", [False, True])
def test_session_rank_table_spec_and_transitions(chief):
    """One register / heartbeat / finish / restart sequence through both
    sessions: the same rank table, cluster spec, task states, barrier,
    completion and final status after every step."""
    assert _session_trace(PKGS["ref"], chief) == _session_trace(PKGS["port"], chief)


# --- scheduler ------------------------------------------------------------------

class _Backend:
    """An inventory that records its grants (the scheduler's view of a
    backend), built over one package's Resource and errors."""

    def __init__(self, m, capacity, per_host=None):
        self.m, self.cap = m, capacity
        self.per_host = per_host or capacity
        self.used = m["back"].Resource(0, 0, 0)
        self.granted: list[str] = []
        self.reserved = None

    def total_capacity(self):
        return self.cap

    def fits_one(self, r):
        return r.fits_in(self.per_host)

    def reserve_job(self, asks, *, timeout_s=None, cancel=None):
        self.reserved = [(a.tpu_chips, label) for a, label in asks]

    def allocate(self, req):
        if not req.resource.fits_in(self.cap - self.used):
            raise self.m["back"].InsufficientResources("full")
        self.used = self.used + req.resource
        self.granted.append(req.task_id)
        return self.m["back"].Container(f"c{len(self.granted)}", "host", req.resource, req)


def _scheduler(m, specs, backend, **kw):
    session = m["ses"].Session(specs)
    hooks = m["sch"].SchedulerHooks(
        make_request=lambda spec, i: m["back"].ContainerRequest(
            spec.name, i, m["back"].Resource(spec.memory_mb, spec.cpus, spec.tpu_chips),
            argv=["true"]),
        on_allocated=lambda *a: None)
    return session, m["sch"].TaskScheduler(session, backend, hooks, poll_interval_s=0.02,
                                           **kw)


def _gang(m):
    T, R = m["conf"].TaskTypeSpec, m["back"].Resource
    specs = {"worker": T(name="worker", instances=3, tpu_chips=2),
             "ps": T(name="ps", instances=1, memory_mb=512)}
    b = _Backend(m, R(1 << 20, 64, 8))
    session, sch = _scheduler(m, specs, b)
    sch.schedule_all(specs)
    return b.granted, b.reserved, {t: x.state.value for t, x in sorted(session.tasks.items())}


def _depends(m):
    """worker depends_on ps: nothing of worker is allocated until ps
    registers; then all of it."""
    T, R = m["conf"].TaskTypeSpec, m["back"].Resource
    specs = {"worker": T(name="worker", instances=2, depends_on="ps", depends_timeout_s=30),
             "ps": T(name="ps", instances=1)}
    b = _Backend(m, R(1 << 20, 64, 8))
    session, sch = _scheduler(m, specs, b)
    t = threading.Thread(target=sch.schedule_all, args=(specs,))
    t.start()
    deadline = time.monotonic() + 20
    while "ps:0" not in b.granted and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    before = list(b.granted)
    session.register("ps", 0, "h", 1, 0)
    t.join(20)
    return before, b.granted


def _dep_timeout(m):
    T, R = m["conf"].TaskTypeSpec, m["back"].Resource
    specs = {"worker": T(name="worker", instances=1, depends_on="ps", depends_timeout_s=0),
             "ps": T(name="ps", instances=1)}
    session, sch = _scheduler(m, specs, _Backend(m, R(1 << 20, 64, 8)),
                              allocation_timeout_s=0.3)
    with pytest.raises(m["sch"].DependencyTimeout) as e:
        sch.schedule_all(specs)
    return str(e.value)


def _refusals(m):
    T, R = m["conf"].TaskTypeSpec, m["back"].Resource
    out = []
    for specs, cap, per_host in (
            ({"w": T(name="w", instances=3, tpu_chips=4)}, R(1 << 20, 64, 8), None),
            ({"w": T(name="w", instances=1, tpu_chips=8)}, R(1 << 20, 64, 8),
             R(1 << 20, 64, 4))):
        _, sch = _scheduler(m, specs, _Backend(m, cap, per_host))
        with pytest.raises(m["back"].InsufficientResources) as e:
            sch.schedule_all(specs)
        out.append(str(e.value))
    return out


@pytest.mark.parametrize("case", [_gang, _depends, _dep_timeout, _refusals],
                         ids=["gang", "depends_on", "dependency_timeout", "capacity"])
def test_scheduler_decisions_equal(case):
    """The scheduler's grants (order, gang reservation), its depends_on
    gate and timeout, and its capacity refusals, in both packages."""
    assert case(PKGS["ref"]) == case(PKGS["port"])


# --- history --------------------------------------------------------------------

def _write_history(m, root: Path, app_id: str):
    app_dir = root / app_id
    app_dir.mkdir(parents=True)
    (app_dir / "submitted_at").write_text(json.dumps({"ts": time.time() - 2.0}))
    w = m["ev"].EventWriter(app_id, str(app_dir / "events"))
    E = m["ev"].EventType
    w.emit(E.APPLICATION_INITED, framework="x")
    w.emit(E.TASK_STARTED, task="worker:0", attempt=0)
    w.emit(E.TASK_REGISTERED, task="worker:0", address="h:1", attempt=0)
    w.emit(E.METRICS, task="worker:0", samples={"rss_mb": 10.0})
    w.emit(E.METRICS, task="worker:0", samples={"step": 1.0, "loss": 2.5,
                                                "startup_compile_s": 0.5})
    w.emit(E.TASK_FINISHED, task="worker:0", exit_code=0, state="SUCCEEDED")
    w.emit(E.APPLICATION_FINISHED, state="SUCCEEDED", diagnostics="")
    w.close()
    return str(app_dir), w.path


def test_each_package_reads_the_others_history(tmp_path):
    """A history file written by either package's EventWriter reads the
    same through either's ``read_history``, and ``submit_latency`` (the
    submit-to-first-step breakdown) finds the same phases."""
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"} for e in evs]  # noqa: E731
    for writer in ("ref", "port"):
        app_dir, path = _write_history(PKGS[writer], tmp_path / writer, f"app-{writer}")
        r, p = rev.read_history(path), pev.read_history(path)
        assert r == p and len(r) == 7
        assert strip(r)[0]["type"] == "APPLICATION_INITED"
        lr, lp = rev.submit_latency(app_dir), pev.submit_latency(app_dir)
        assert lr == lp and lp["startup"] == {"compile_s": 0.5}
    ref_file = next((tmp_path / "ref").rglob("*.jhist.jsonl"))
    port_file = next((tmp_path / "port").rglob("*.jhist.jsonl"))
    assert strip(rev.read_history(str(ref_file))) == [
        {**e, "app_id": "app-ref"} for e in strip(pev.read_history(str(port_file)))]
    assert {k: v for k, v in vars(rev.EventType).items() if k.isupper()} == \
        {k: v for k, v in vars(pev.EventType).items() if k.isupper()}


# --- lease store ------------------------------------------------------------------

def _summary(store):
    s = store.summary()
    s.pop("root")
    return s


def _dead_holder(m, root: str, app_id: str) -> None:
    """A process of package ``m`` leases 1 chip on h2 and exits: its owner
    is dead, and the next locked operation reaps it."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            f"from {m['name']}.cluster.lease import GangAsk, LeaseStore\n"
            f"from {m['name']}.cluster.backend import Resource\n"
            f"LeaseStore({root!r}).reserve_gang({app_id!r}, "
            "[GangAsk(Resource(64, 1, 1), host='h2')], timeout_s=0)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)


def _lease_sequence(root: str, stores):
    """One sequence of gang asks, renewals, queueing, grow/shrink, reaps
    and releases over one store directory; ``stores(i)`` is the handle of
    step i (alternating packages shows each reads the other's state)."""
    out = []
    s = stores(0)
    R, Ask, Insufficient = s._R, s._Ask, s._Insufficient
    res = lambda chips: R(64, 1, chips)  # noqa: E731
    s.register_hosts({"h1": R(256, 8, 4), "h2": R(256, 8, 4)})
    pack = stores(1).reserve_gang("a", [Ask(res(4)), Ask(res(2))], timeout_s=0)
    out.append([h for _, h in pack])
    with pytest.raises(Insufficient) as e:
        stores(2).reserve_gang("b", [Ask(res(4))], timeout_s=0)
    out.append(str(e.value))
    out.append(stores(3).renew_app("a"))
    out.append(_summary(stores(4)))
    # two waiters queue FIFO behind a; the queue order, then the grant order
    order, threads = [], []
    for i, app in enumerate(("b", "c")):
        def wait(app=app, i=i):
            stores(5 + i).reserve_gang(app, [Ask(res(4))], timeout_s=30)
            order.append(app)
        threads.append(threading.Thread(target=wait))
        threads[-1].start()
        deadline = time.monotonic() + 20
        while len(stores(7).summary()["queue"]) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    out.append([t["app_id"] for t in stores(8).summary()["queue"]])
    out.append(stores(9).release_app("a"))
    for t in threads:
        t.join(30)
    out.append(order)
    out.append(_summary(stores(10)))
    out.append(stores(11).shrink_gang("b", "containers", ask=Ask(res(4))))
    out.append(stores(12).grow_gang("b", "containers", Ask(res(4))))
    out.append(stores(13).release_gang("c", "containers"))
    _dead_holder(PKGS["ref"], root, "dead-ref")
    _dead_holder(PKGS["port"], root, "dead-port")
    out.append(sorted(_summary(stores(14))["apps"]))       # reaped on this op
    out.append(_summary(stores(15)))
    stores(16).force_release_app("b")
    out.append(_summary(stores(17)))
    return out


def _store(m, root):
    s = m["lease"].LeaseStore(root, lease_ttl_s=60)
    s._R, s._Ask = m["back"].Resource, m["lease"].GangAsk
    s._Insufficient = m["back"].InsufficientResources
    return s


def test_lease_stores_grant_alike_and_read_each_other(tmp_path):
    """The same sequence over three store directories: one driven by the
    reference alone, one by the port alone, one alternating between them
    op by op. Equal grants, rejections, queue order, grow/shrink, reaps of
    a dead owner (of either package) and summaries; the state file's
    entries carry the reference's fields."""
    runs = {}
    for label, pick in (("ref", lambda i: "ref"), ("port", lambda i: "port"),
                        ("mixed", lambda i: ("ref", "port")[i % 2])):
        root = str(tmp_path / label)
        runs[label] = _lease_sequence(root, lambda i, r=root, p=pick: _store(PKGS[p(i)], r))
    assert runs["ref"] == runs["port"] == runs["mixed"]
    assert runs["port"][0] == ["h1", "h2"] and runs["port"][4] == runs["port"][6] == ["b", "c"]
    assert please.STATE_FILE == rlease.STATE_FILE
    please.LeaseStore(str(tmp_path / "mixed")).reserve_gang(
        "z", [please.GangAsk(pback.Resource(64, 1, 1))], timeout_s=0)
    state = json.loads((tmp_path / "mixed" / please.STATE_FILE).read_text())
    app = state["apps"]["z"]
    assert set(app) == {"owner_host", "owner_pid", "owner_start", "renewed_at", "ttl_s",
                        "gangs"}


# --- runtimes --------------------------------------------------------------------

def _identity(m, spec):
    return m["rt"].TaskIdentity(job_name="worker", index=1, cluster_spec=spec,
                                coordinator_address="h0:1234", process_id=2,
                                num_processes=4, generation=3)


@pytest.mark.parametrize("framework", ["pytorch", "tensorflow", "horovod", "mxnet",
                                       "generic"])
@pytest.mark.parametrize("ckpt", [False, True])
def test_build_env_equal_but_the_jax_cache(framework, ckpt, monkeypatch):
    """Every runtime the port has builds the reference's env from the same
    identity and config, less ``TONY_JAX_CACHE_DIR`` (nothing to cache in
    eager PyTorch); validate() refuses alike."""
    monkeypatch.setenv("TONY_AM_ADDR", "amhost:9")
    monkeypatch.setenv("TONY_HOROVOD_RENDEZVOUS_PORT", "777")
    spec = {"worker": ["h0:1234", "h1:1235", "h2:1236", "h3:1237"],
            "scheduler": ["hs:1"], "server": ["hv:2"]}
    values = {"profiler.enabled": True, "diagnostics.enabled": True,
              "job.scheduler.instances": 1, "job.worker.instances": 4}
    if ckpt:
        values.update({"checkpoint.dir": "/ck", "checkpoint.interval_steps": 7,
                       "restart.resume_from_checkpoint": False})
    envs = [m["rt"].make_runtime(framework).build_env(
        _identity(m, spec), m["conf"].TonyConfig(values)) for m in (PKGS["ref"], PKGS["port"])]
    assert envs[0].pop("TONY_JAX_CACHE_DIR")
    assert envs[0] == envs[1]
    if ckpt:
        assert envs[1]["TONY_RESUME_FROM_CHECKPOINT"] == "false"
    bad = {"job.worker.instances": 1}
    errors = []
    for m in (PKGS["ref"], PKGS["port"]):
        try:
            m["rt"].make_runtime(framework).validate(m["conf"].TonyConfig(bad))
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert prt.make_runtime(framework).needs_data_port() == \
        rrt.make_runtime(framework).needs_data_port()


def test_runtimes_the_port_refuses():
    """``jax`` is refused with the reference's message for an unknown
    framework, listing the port's runtimes. ``serve`` is the port's since
    gang serving (tests/test_torch_gang.py holds its env against the
    reference's), ``elastic`` since the elastic runtime for one process per
    rank (tests/test_torch_elastic_job.py)."""
    with pytest.raises(ValueError) as e:
        rrt.make_runtime("caffe")
    with pytest.raises(ValueError) as p:
        prt.make_runtime("jax")
    assert str(p.value) == str(e.value).replace("'caffe'", "'jax'").replace("'jax', ", "")
    assert type(prt.make_runtime("elastic")).__name__ == "ElasticRuntime"
    assert type(prt.make_runtime("serve")).__name__ == "ServeRuntime"


def test_torch_dist_helpers_read_the_job_env(monkeypatch):
    from tony_tpu.runtime import jax_tpu
    from tony_tpu_torch.runtime import torch_dist

    for env in ({}, {"TONY_COORDINATOR_ADDR": "h:1", "TONY_PROCESS_ID": "3",
                     "TONY_NUM_PROCESSES": "4"}):
        for k in ("TONY_COORDINATOR_ADDR", "TONY_PROCESS_ID", "TONY_NUM_PROCESSES"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("in_tony_job", "process_id", "num_processes"):
            assert getattr(torch_dist, fn)() == getattr(jax_tpu, fn)()


# --- the ApplicationRpc service ---------------------------------------------------

def test_messages_and_methods_are_the_references():
    """The port's messages are the reference's serialized file, and its
    ApplicationRpc table names the same methods over the same messages
    (every field: name, number, type, label, default)."""
    rpb, ppb = rrpc.pb, prpc.pb
    assert ppb.DESCRIPTOR.serialized_pb == rpb.DESCRIPTOR.serialized_pb
    assert pservice.SERVICE_NAME == rservice.SERVICE_NAME == "tony_tpu.ApplicationRpc"
    assert list(pservice._METHODS) == list(rservice._METHODS)

    def fields(cls):
        return [(f.name, f.number, f.type, f.is_repeated,
                 None if f.is_repeated else f.default_value)
                for f in cls.DESCRIPTOR.fields]
    for name, (req, resp) in pservice._METHODS.items():
        rreq, rresp = rservice._METHODS[name]
        assert req.DESCRIPTOR.full_name == rreq.DESCRIPTOR.full_name
        assert resp.DESCRIPTOR.full_name == rresp.DESCRIPTOR.full_name
        assert fields(req) == fields(rreq) and fields(resp) == fields(rresp)


def _am(m, tmp_path: Path, mode: str):
    cfg = m["conf"].TonyConfig({
        "application.framework": "generic", "scheduler.mode": mode,
        "job.worker.instances": 2, "job.worker.command": "true",
        "job.ps.instances": 1, "job.ps.command": "true", "job.worker.depends_on": "ps",
        "obs.profile.max_steps": 8,
    })
    app_dir = tmp_path / m["name"] / mode
    app_dir.mkdir(parents=True)
    return m["am"].ApplicationMaster(cfg, "app", str(app_dir))


def _calls(c, pb):
    """One sequence of calls (the executors', then the CLI's)."""
    yield c.register_worker_spec("worker", 0, "h0", 10, attempt=0)
    yield c.register_worker_spec("worker", 1, "h1", 11, attempt=2)       # stale
    yield c.get_cluster_spec("worker", 0, 0)
    yield c.register_worker_spec("ps", 0, "hp", 20, attempt=0)
    yield c.get_cluster_spec("worker", 0, 0)                 # FCFS: ready
    yield c.get_cluster_spec("ps", 0, 0)
    yield c.register_worker_spec("worker", 1, "h1", 11, attempt=0)
    yield c.get_cluster_spec("worker", 1, 0)                 # GANG: ready
    yield c.get_cluster_spec("worker", 1, 5)                 # stale: not ready
    yield c.heartbeat("worker", 0, 0)
    yield c.heartbeat("worker", 0, 9)                        # stale: ABORT
    yield c.heartbeat("nope", 0, 0)
    c.push_metrics("worker", 0, [("loss", 2.5, 1.0), ("step", 1.0, 1.0)])
    c.register_tensorboard_url("http://tb:6006")
    yield c.get_task_infos()
    yield c.get_application_status()
    yield c.start_profile(steps=0, duration_s=0.0)
    resp = c.start_profile(steps=20)
    yield pb.StartProfileResponse(accepted=resp.accepted, message=resp.message)
    yield c.register_execution_result("worker", 0, 3, message="m", attempt=0)
    c.stop_application("enough")
    yield c.heartbeat("worker", 1, 0)                        # after stop: ABORT


def _as_dicts(msgs):
    return [json_format.MessageToDict(x, preserving_proto_field_name=True,
                                      always_print_fields_with_no_presence=True)
            for x in msgs]


@pytest.mark.parametrize("mode", ["GANG", "FCFS"])
def test_rpc_methods_answer_alike(tmp_path, mode):
    """Each package's AM served over gRPC on the same session state: every
    method's responses, as dicts, equal for the same calls; a port client
    reaches the reference's AM and a reference client the port's."""
    out, servers = {}, []
    try:
        for label, m in PKGS.items():
            am = _am(m, tmp_path, mode)
            server, port = m["rpc"].serve(am, host="127.0.0.1")
            servers.append(server)
            with m["rpc"].ApplicationRpcClient(f"127.0.0.1:{port}") as c:
                out[label] = _as_dicts(_calls(c, m["rpc"].pb))
            assert am.session.tensorboard_url == "http://tb:6006"
            assert am._latest_metrics == {"worker:0": {"loss": 2.5, "step": 1.0}}
            am.events.close()
            # across the packages: the other's client on this AM's wire
            other = PKGS["port" if label == "ref" else "ref"]
            with other["rpc"].ApplicationRpcClient(f"127.0.0.1:{port}") as c:
                st = c.get_application_status()
                assert st.state == "NEW" and len(st.tasks) == 3
    finally:
        for s in servers:
            s.stop(0)
    assert out["ref"] == out["port"]
    ready = [d for d in out["port"] if "ready" in d]
    assert [d["ready"] for d in ready] == ([False, False, True, True, False] if mode == "FCFS"
                                          else [False, False, False, True, False])


class _Broken:
    def GetTaskInfos(self, request, context):  # noqa: N802
        raise RuntimeError("servicer bug")


def _error_codes(m, tmp_path):
    codes = []
    base = m["rpc"].ApplicationRpcServicer()
    for name in m["service"]._METHODS:
        if name != "GetTaskInfos":
            setattr(_Broken, name, getattr(type(base), name))
    for servicer, token, client_token in ((base, None, None), (_Broken(), None, None),
                                          (base, "secret", "wrong"), (base, "secret", None),
                                          (base, "secret", "secret")):
        server, port = m["rpc"].serve(servicer, host="127.0.0.1", token=token)
        try:
            with m["rpc"].ApplicationRpcClient(f"127.0.0.1:{port}", timeout_s=5,
                                               token=client_token) as c:
                c.get_task_infos()
            codes.append(None)
        except grpc.RpcError as e:
            codes.append((e.code(), e.details().split(":")[0]))
        finally:
            server.stop(0)
    return codes


def test_rpc_errors_reach_the_client_alike(tmp_path):
    """An unimplemented method, an exception in the servicer and a bad or
    missing token reach the client as UNIMPLEMENTED, INTERNAL and
    UNAUTHENTICATED, in both packages."""
    r, p = _error_codes(PKGS["ref"], tmp_path), _error_codes(PKGS["port"], tmp_path)
    assert r == p
    assert [c[0] if c else None for c in p] == [
        grpc.StatusCode.UNIMPLEMENTED, grpc.StatusCode.INTERNAL,
        grpc.StatusCode.UNAUTHENTICATED, grpc.StatusCode.UNAUTHENTICATED,
        grpc.StatusCode.UNIMPLEMENTED]


def test_token_files_are_shared(tmp_path):
    from tony_tpu.rpc import auth as rauth
    from tony_tpu_torch.rpc import auth as pauth

    token = pauth.mint_token(str(tmp_path))
    assert rauth.read_token(str(tmp_path)) == token == pauth.read_token(str(tmp_path))
    assert oct(os.stat(tmp_path / pauth.TOKEN_FILE).st_mode & 0o777) == "0o600"
    assert pauth.client_metadata("t") == rauth.client_metadata("t")


# --- chaos ----------------------------------------------------------------------

SCHEDULES = [
    "",
    '[{"type": "kill_container", "task": "worker:0", "at_count": 3}]',
    [{"type": "delay_rpc", "method": "Heartbeat", "delay_ms": 5, "jitter_ms": 2},
     {"type": "hang_store", "duration_s": 1.5, "after_s": 2},
     {"type": "delay_point", "point": "backend.allocate", "delay_ms": 1}],
    '[{"type": "drop_heartbeats", "from_count": 2, "to_count": 5, "attempt": 0}]',
    '[{"type": "explode"}]',
    '[{"type": "delay_point"}]',
    '{"type": "kill_am"}',
    "not json",
]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=range(len(SCHEDULES)))
def test_parse_faults_alike(schedule):
    """The same schedules parse to the same fault specs, or fail alike."""
    def parse(m):
        try:
            return [(f.describe(), {k: v for k, v in vars(f).items() if k != "raw"})
                    for f in m["faults"].parse_faults(schedule)]
        except Exception as e:  # noqa: BLE001 (the error is what is compared)
            return (type(e).__name__, str(e))
    assert parse(PKGS["ref"]) == parse(PKGS["port"])
    assert pfaults.POINTS == rfaults.POINTS


def test_chaos_hook_disarmed_and_armed_alike(monkeypatch):
    for m in (PKGS["ref"], PKGS["port"]):
        f = m["faults"]
        assert f.chaos_hook("executor.beat", task="worker:0") is None
        cfg = m["conf"].TonyConfig({"chaos.enabled": True, "chaos.faults": SCHEDULES[3]})
        assert f.install_from_config(cfg, role="executor")
        try:
            fired = [bool(f.chaos_hook("executor.beat", task="worker:0", attempt=0))
                     for _ in range(6)]
        finally:
            f.uninstall()
        assert fired == [False, True, True, True, True, False]


# --- fit()'s job env (F2) and the control plane's imports (F3) -----------------------

@pytest.mark.parametrize("env", [
    {},
    {"TONY_CHECKPOINT_DIR": "/job/ckpt", "TONY_CHECKPOINT_INTERVAL_STEPS": "25",
     "TONY_CHECKPOINT_KEEP": "2", "TONY_RESUME_FROM_CHECKPOINT": "true"},
    {"TONY_CHECKPOINT_DIR": "/job/ckpt", "TONY_CHECKPOINT_INTERVAL_STEPS": "0",
     "TONY_CHECKPOINT_KEEP": "5", "TONY_RESUME_FROM_CHECKPOINT": "false"},
    {"TONY_CHECKPOINT_INTERVAL_STEPS": "25", "TONY_RESUME_FROM_CHECKPOINT": "false"},
])
@pytest.mark.parametrize("preset", [{}, {"checkpoint_dir": "/mine", "checkpoint_every": 3},
                                    {"checkpoint_every": 4, "checkpoint_keep": 9}])
def test_apply_job_env_sets_the_checkpoint_fields_alike(monkeypatch, env, preset):
    """The executor's TONY_CHECKPOINT_* env through both FitConfigs'
    ``apply_job_env``: the same checkpoint dir, interval, keep and resume."""
    from tony_tpu.train import FitConfig as JFitConfig
    from tony_tpu_torch.train import FitConfig

    for k in ("TONY_CHECKPOINT_DIR", "TONY_CHECKPOINT_INTERVAL_STEPS",
              "TONY_CHECKPOINT_KEEP", "TONY_RESUME_FROM_CHECKPOINT", "TONY_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = []
    for cls in (JFitConfig, FitConfig):
        cfg = cls(**preset)
        cfg.apply_job_env()
        got.append((cfg.checkpoint_dir, cfg.checkpoint_every, cfg.checkpoint_keep,
                    cfg.resume))
    assert got[0] == got[1]
    if env.get("TONY_CHECKPOINT_DIR") and not preset.get("checkpoint_dir"):
        assert got[1][0] == env["TONY_CHECKPOINT_DIR"]


CONTROL_MODULES = ("obs", "obs.trace", "obs.reporter", "obs.hbm", "obs.health",
                   "obs.profile", "obs.series", "obs.slo", "obs.registry", "obs.monitor",
                   "elastic.protocol", "am.app_master", "executor.task_executor", "cli.main",
                   "cli.client", "cluster", "rpc", "runtime", "chaos", "config", "utils",
                   "serve", "serve.gang", "serve.frontend", "serve.prefix",
                   "chaos.invariants", "chaos.runner", "obs.trace_tool", "obs.top",
                   "obs.proxy", "obs.portal", "cli.notebook")


def test_control_plane_imports_neither_torch_nor_numpy():
    """A fresh process importing the port's obs spine, elastic protocol,
    AM, executor, CLI, cluster, RPC, runtimes, chaos (the invariant checker
    and runner too), config modules and operator tools (trace tool, top,
    proxy, portal, notebook),
    and the gang's control plane (the serve package, ``serve.gang``'s
    settings, the frontend), then building a decode host's env through the
    ``serve`` runtime as an executor does, loads neither torch nor numpy
    (nor jax), as the reference's control plane loads neither jax nor numpy
    (the reference's ``serve.gang`` does load both: its package imports the
    engine)."""
    code = ("import sys, importlib\n"
            f"for m in {CONTROL_MODULES!r}:\n"
            "    importlib.import_module('tony_tpu_torch.' + m)\n"
            "from tony_tpu_torch.config.config import TonyConfig\n"
            "from tony_tpu_torch.runtime import TaskIdentity, make_runtime\n"
            "env = make_runtime('serve').build_env(TaskIdentity(\n"
            "    job_name='decode', index=0, cluster_spec={'decode': ['h0:7001']},\n"
            "    coordinator_address='h0:7001', process_id=0, num_processes=1),\n"
            "    TonyConfig({'job.decode.instances': 1}))\n"
            "assert env['TONY_SERVE_PORT'] == '7001' and env['TONY_SERVE_GANG']\n"
            "print(sorted(k for k in ('torch', 'numpy', 'jax', 'tony_tpu') if k in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_port_refuses_backends_it_lacks():
    from tony_tpu_torch.cluster import make_backend

    for name in ("remote", "tpu_vm"):
        with pytest.raises(ValueError, match=r"ROADMAP queue 1, item 10"):
            make_backend(name, pconf.TonyConfig())
    with pytest.raises(ValueError, match="unknown cluster backend"):
        make_backend("yarn")
    assert type(make_backend("local", pconf.TonyConfig())).__name__ == "LocalProcessBackend"


# --- the reference's round-5 repairs, held in both packages ---------------------------

@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_fenced_backend_skips_lease_release(tmp_path, pkg):
    """After fence_leases(), stop() leaves the store alone (releasing could
    block on the very store whose hang caused the fence)."""
    m = PKGS[pkg]
    local = __import__(f"{m['name']}.cluster.local", fromlist=["LocalProcessBackend"])
    R = m["back"].Resource
    store = m["lease"].LeaseStore(str(tmp_path / "rm"), lease_ttl_s=600)
    b = local.LocalProcessBackend(R(4096, 4, 16), lease_store=store, app_id="fenced-job")
    b.start()
    b.reserve_job([(R(64, 1, 4), "")], timeout_s=5)
    b.fence_leases()
    t0 = time.monotonic()
    b.stop()
    assert time.monotonic() - t0 < 5
    assert "fenced-job" in m["lease"].LeaseStore(str(tmp_path / "rm")).summary()["apps"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_losing_ondemand_leases_go_back(tmp_path, pkg):
    """A store whose view of this host is wider than the local inventory
    grants on-demand leases the backend can never claim: allocate() fails
    bounded and hands every one back."""
    m = PKGS[pkg]
    local = __import__(f"{m['name']}.cluster.local", fromlist=["LocalProcessBackend"])
    net = __import__(f"{m['name']}.utils.net", fromlist=["local_host"])
    R = m["back"].Resource
    root = str(tmp_path / "rm")
    m["lease"].LeaseStore(root, owner_host="first-registrar").register_hosts(
        {net.local_host(): R(1 << 20, 256, 64)})
    b = local.LocalProcessBackend(R(4096, 4, 4), lease_store=m["lease"].LeaseStore(root),
                                  app_id="overask-job")
    b.start()
    req = m["back"].ContainerRequest(task_type="w", task_index=0, resource=R(64, 1, 8),
                                     argv=["true"], env={}, log_path="")
    with pytest.raises(m["back"].InsufficientResources):
        b.allocate(req)
    assert "overask-job" not in m["lease"].LeaseStore(root).summary()["apps"]
    b.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_lease_ttl_clamped_against_heartbeat(tmp_path, pkg):
    m = PKGS[pkg]
    make_backend = __import__(f"{m['name']}.cluster", fromlist=["make_backend"]).make_backend
    cfg = m["conf"].TonyConfig({"cluster.rm_root": str(tmp_path / "rm"),
                                "cluster.lease_ttl_s": 0.5,
                                "task.heartbeat_interval_ms": 1000})
    assert make_backend("local", cfg, app_id="clamped").lease_ttl_s() == 4.0
    cfg2 = m["conf"].TonyConfig({"cluster.rm_root": str(tmp_path / "rm2"),
                                 "cluster.lease_ttl_s": 600})
    assert make_backend("local", cfg2, app_id="ok").lease_ttl_s() == 600.0


@pytest.mark.parametrize("incumbent_pkg", ["ref", "port"])
def test_reentry_refuses_takeover_from_a_live_incumbent(tmp_path, incumbent_pkg):
    """A duplicate submit of the same app id from the other package must not
    take over a live incumbent's reservation; the operator's
    force_release_app still clears the way."""
    inc, dup_m = PKGS[incumbent_pkg], PKGS["port" if incumbent_pkg == "ref" else "ref"]
    root = str(tmp_path / "rm")
    R = inc["back"].Resource
    incumbent = inc["lease"].LeaseStore(root, owner_host="other-submit-host", lease_ttl_s=600)
    incumbent.register_hosts({"h1": R(256, 8, 4)})
    incumbent.reserve_gang("app", [inc["lease"].GangAsk(R(64, 1, 4))], timeout_s=0)
    dup = dup_m["lease"].LeaseStore(root, lease_ttl_s=600)
    ask = [dup_m["lease"].GangAsk(dup_m["back"].Resource(64, 1, 4))]
    with pytest.raises(dup_m["lease"].LeaseStoreError, match="refusing ownership takeover"):
        dup.reserve_gang("app", ask, timeout_s=0)
    owner = inc["lease"].LeaseStore(root).summary()["apps"]["app"]["owner"]
    assert owner.startswith("other-submit-host:")
    dup.force_release_app("app")
    dup.reserve_gang("app", ask, timeout_s=0)
    assert dup.release_app("app") is True
