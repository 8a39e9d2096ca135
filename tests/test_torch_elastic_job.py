"""Elastic jobs that survive a dead member, on the CPU: the port's
``elastic`` runtime (``runtime/frameworks.py`` ``ElasticRuntime``), its
member agent (``elastic/member.py``) and ``fit()``'s dead-member path
(``train/loop.py`` ``_Elastic``) against the JAX package's.

- ``ElasticRuntime.validate`` refuses what the reference's refuses, with
  the same messages once the member module's name is swapped; its env is
  the ``pytorch`` contract plus the reference's ``TONY_ELASTIC*`` keys.
- The reference's ``test_elastic_job_end_to_end`` (tests/test_elastic.py)
  as one CPU job through each package's client: a chief and one member,
  the member's container killed once training is underway, the shrink, the
  relaunch and the grow, and the reference test's assertions on both app
  dirs, with both packages' invariant checkers. The port job's losses are
  then held within 1e-4 of the port's own elastic ``fit()`` on gloo ranks
  (``tests/torch_ranks.py``) under the plan its journal recorded.
- A rank killed between the dp gradient sum and the update: the survivor
  redoes that step from the state it held, its parameters bit-equal to a
  run in which that step ran with member 0 alone.
- A relaunched member finds its running gang on rank 0's store and keeps
  the backend its script asked for.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

from tony_tpu.config.config import TonyConfig as RefConfig
from tony_tpu.runtime import ElasticRuntime as RefElasticRuntime
from tony_tpu.runtime.base import TaskIdentity as RefIdentity
from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.elastic import journal_path, read_history, read_journal
from tony_tpu_torch.runtime import ElasticRuntime, make_runtime
from tony_tpu_torch.runtime.base import TaskIdentity
from torch_jobs import check_both, log_tails, submit
from torch_ranks import spawn

DATA = dict(global_batch=8, seq_len=32, vocab_size=128)
LOSS_ATOL = 1e-4

# --- the runtime ----------------------------------------------------------------

_JOB = {"application.framework": "elastic", "job.chief.instances": 1,
        "job.chief.command": "python train.py"}
REFUSALS = {
    "no chief": {"application.framework": "elastic", "job.worker.instances": 2,
                 "job.worker.command": "python train.py"},
    "member type sorts before chief": {**_JOB, "job.agents.instances": 1,
                                       "job.agents.command": "MEMBER"},
    "one member": dict(_JOB),
    "min_members out of range": {**_JOB, "job.worker.instances": 1,
                                 "job.worker.command": "MEMBER",
                                 "elastic.min_members": 2},
}


def _member_cmd(pkg: str) -> str:
    return f"{sys.executable} -m {pkg}.elastic.member"


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_validate_refuses_like_reference(case):
    """The four refusals, each with the reference's message once the member
    module's name is swapped."""
    over = REFUSALS[case]
    errors = {}
    for pkg, conf, runtime in (("tony_tpu", RefConfig, RefElasticRuntime),
                               ("tony_tpu_torch", TonyConfig, ElasticRuntime)):
        cfg = conf.load(overrides={k: _member_cmd(pkg) if v == "MEMBER" else v
                                   for k, v in over.items()})
        with pytest.raises(ValueError) as e:
            runtime().validate(cfg)
        errors[pkg] = str(e.value)
    assert errors["tony_tpu_torch"] == errors["tony_tpu"].replace(
        "tony_tpu.elastic.member", "tony_tpu_torch.elastic.member")
    assert type(make_runtime("elastic")) is ElasticRuntime


@pytest.mark.parametrize("rank", [0, 1])
def test_build_env_is_the_pytorch_contract_and_the_elastic_keys(rank):
    """Every member is a rank of one group: the ``pytorch`` runtime's keys
    (rank 0's task the master), the reference's ``TONY_ELASTIC*`` keys
    with its values, and the job's detection time; not the reference's
    single-process ``TONY_NUM_PROCESSES=1`` / ``JAX_*`` keys."""
    over = {**_JOB, "job.worker.instances": 1, "job.worker.command": "M",
            "elastic.poll_interval_s": 0.1, "elastic.shadow_interval_steps": 4,
            "task.heartbeat_interval_ms": 200, "task.max_missed_heartbeats": 10}
    spec = {"chief": ["h0:4000"], "worker": ["h1:4001"]}
    job, index = ("chief", 0) if rank == 0 else ("worker", 0)
    args = dict(job_name=job, index=index, cluster_spec=spec,
                coordinator_address="h0:4000", process_id=rank, num_processes=2)
    env = ElasticRuntime().build_env(TaskIdentity(**args), TonyConfig.load(overrides=over))
    ref = RefElasticRuntime().build_env(RefIdentity(**args), RefConfig.load(overrides=over))
    assert {k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                                "LOCAL_RANK", "TONY_NUM_PROCESSES")} == {
        "MASTER_ADDR": "h0", "MASTER_PORT": "4000", "RANK": str(rank), "WORLD_SIZE": "2",
        "LOCAL_RANK": "0", "TONY_NUM_PROCESSES": "2"}
    elastic = [k for k in ref if k.startswith("TONY_ELASTIC")]
    assert len(elastic) == 5 and {k: env[k] for k in elastic} == {k: ref[k] for k in elastic}
    assert env["TONY_ELASTIC_MEMBER"] == str(rank)
    assert float(env["TONY_ELASTIC_DETECT_S"]) == 2.0
    assert not [k for k in env if k.startswith("JAX_")]
    assert ref["TONY_NUM_PROCESSES"] == "1"


# --- the reference's end-to-end job, through both clients ---------------------------

# the reference test's trainer (tests/test_elastic.py:595-616); the port's
# differs in its imports, its device and in asserting the summary on the
# chief alone, since every member runs it
_TRAIN = """import logging, os, time
logging.basicConfig(level=logging.INFO)
{imports}
def pace(m):
    # pacing keeps the run alive across the shrink->grow window
    # and arms the chaos kill only once training is mid-step
    if m['step'] >= 3:
        open({marker!r}, 'a').close()
    time.sleep(0.1)
out = fit(FitConfig(
    model=LlamaConfig.tiny(),
    data=DataConfig(global_batch=8, seq_len=32, vocab_size=128),
    steps=120, log_every=1, warmup_steps=2,
    on_metrics=pace){device})
e = out.get('elastic') or {{}}
print('ELASTIC SUMMARY', e)
{check}assert e.get('reshards', 0) >= 2, e
{check}assert e.get('members') == [0, 1], e
"""
_IMPORTS = {
    "tony_tpu": "from tony_tpu.train import fit, FitConfig\n"
                "from tony_tpu.train.data import DataConfig\n"
                "from tony_tpu.models.llama import LlamaConfig",
    "tony_tpu_torch": "from tony_tpu_torch.train import fit, FitConfig\n"
                      "from tony_tpu_torch.train.data import DataConfig\n"
                      "from tony_tpu_torch.models.llama import LlamaConfig",
}


def _overrides(pkg: str, marker: str) -> dict:
    """The reference test's job config (tests/test_elastic.py:617-642)."""
    return {
        "application.timeout_s": 240,
        "application.name": "elastic-e2e",
        "application.framework": "elastic",
        "elastic.grow_retry_s": 0.5,
        "elastic.poll_interval_s": 0.1,
        "elastic.shadow_interval_steps": 4,
        "job.chief.instances": 1,
        "job.chief.command": f"{sys.executable} train.py",
        "job.chief.env": ["JAX_PLATFORMS=cpu", "OMP_NUM_THREADS=1"],
        "job.worker.instances": 1,
        "job.worker.command": _member_cmd(pkg),
        "job.worker.env": ["OMP_NUM_THREADS=1"],
        "chaos.enabled": True,
        "chaos.faults": json.dumps([{
            "type": "kill_container", "task": "worker:0",
            "from_count": 1, "on_file": marker,
        }]),
        "trace.sample_steps": 1,
    }


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{pkg: app dir} of the reference test's job through each package's
    client, both at once."""
    root = tmp_path_factory.mktemp("elastic-jobs")
    out: dict = {}

    def run(pkg: str):
        src = root / f"src-{pkg}"
        src.mkdir()
        marker = str(root / f"underway-{pkg}")
        port = pkg == "tony_tpu_torch"
        (src / "train.py").write_text(_TRAIN.format(
            imports=_IMPORTS[pkg], marker=marker, device=", device='cpu'" if port else "",
            check="if os.environ.get('TONY_JOB_NAME') == 'chief': " if port else ""))
        out[pkg] = submit("port" if port else "ref", root, _overrides(pkg, marker),
                          src_dir=str(src))

    threads = [threading.Thread(target=run, args=(p,)) for p in _IMPORTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert set(out) == set(_IMPORTS), out
    for pkg, (code, app_dir) in out.items():
        assert code == 0, f"{pkg}: exit {code}\n{log_tails(app_dir)}"
    return {pkg: app_dir for pkg, (_, app_dir) in out.items()}


def _events_of(app_dir):
    from tony_tpu_torch.am.events import read_history as read_jhist

    ev_dir = os.path.join(app_dir, "events")
    return [e for n in sorted(os.listdir(ev_dir)) if n.endswith(".jsonl")
            for e in read_jhist(os.path.join(ev_dir, n))]


@pytest.mark.parametrize("pkg", sorted(_IMPORTS))
def test_elastic_job_end_to_end_like_reference(jobs, pkg):
    """The reference test's assertions on each package's job: start ->
    shrink (member 1 dead) -> grow (back); two reshards with no lost step;
    a batch fingerprint on the loss records; a clean post-mortem by both
    checkers; the ELASTIC_SHRINK and ELASTIC_GROW events; two generation
    changes and a restart time in the merged trace's goodput; two
    ``elastic.reshard`` spans in the chief's journal; one kill instant;
    ``tony elastic`` exits 0 (each package's tools on each app dir)."""
    from tony_tpu.cli.main import main as ref_cli
    from tony_tpu.obs import trace_tool as ref_trace
    from tony_tpu_torch.am.events import EventType
    from tony_tpu_torch.cli.main import main as port_cli
    from tony_tpu_torch.obs import trace_tool

    app_dir = jobs[pkg]
    hist = read_history(app_dir)
    boundaries = [r.boundary for r in hist]
    assert boundaries[:1] == ["start"]
    assert "shrink" in boundaries and "grow" in boundaries
    shrink = next(r for r in hist if r.boundary == "shrink")
    grow = next(r for r in hist if r.boundary == "grow")
    assert shrink.members == (0,) and shrink.dead == (1,)
    assert grow.members == (0, 1) and grow.added == (1,)
    gens = [r.generation for r in hist]
    assert gens == sorted(gens) and len(set(gens)) == len(gens)

    recs = read_journal(journal_path(app_dir, 0))
    reshards = [r for r in recs if r["type"] == "reshard"]
    assert [r["boundary"] for r in reshards] == ["shrink", "grow"]
    assert all(r["lost_steps"] == 0 for r in reshards)
    assert any("fp" in r for r in recs if r["type"] == "loss")

    assert check_both(app_dir).ok

    ev_types = {e.get("type") for e in _events_of(app_dir)}
    assert EventType.ELASTIC_SHRINK in ev_types and EventType.ELASTIC_GROW in ev_types

    for tool in (trace_tool, ref_trace):
        procs = tool.load_journals(os.path.join(app_dir, "trace"))
        g = tool.goodput(app_dir, procs)
        assert g["generation_changes"] == 2
        assert g["restart_s"] > 0
        chief = [p for p in procs if p["proc"].startswith("chief_0_user")]
        spans = [s["name"] for p in chief for s in p["spans"]]
        assert spans.count("elastic.reshard") == 2
        kills = [i for p in procs for i in p["instants"] if i["name"] == "chaos.kill_container"]
        assert len(kills) == 1
    for cli in (port_cli, ref_cli):
        assert cli(["elastic", app_dir]) == 0


def test_port_job_losses_match_its_own_elastic_fit(jobs, tmp_path):
    """The port job's chief losses, step by step, within 1e-4 of the
    port's elastic ``fit()`` on two gloo ranks under the plan the job's
    journal recorded (the shrink at the failed step, the grow where the
    relaunched member joined); the relaunched member ran the chief's
    command under the ``elastic.member`` span and received the state at
    the grow."""
    app_dir = jobs["tony_tpu_torch"]
    recs = read_journal(journal_path(app_dir, 0))
    plan = [[r["at_step"], r["members"]] for r in recs if r["type"] == "reshard"]
    job = {r["step"]: r["loss"] for r in recs if r["type"] == "loss"}
    assert len(plan) == 2 and sorted(job) == list(range(120))
    twin_dir = tmp_path / "twin"
    twin_dir.mkdir()
    (res, _) = spawn(2, "elastic", {"runs": [{
        "model": {}, "data": DATA, "fit": {
            "steps": 120, "warmup_steps": 2, "elastic_members": 2,
            "elastic_dir": str(twin_dir), "plan": plan}}]}, tmp_path)
    twin = {r["step"]: r["loss"] for r in read_journal(journal_path(str(twin_dir), 0))
            if r["type"] == "loss"}
    assert sorted(twin) == sorted(job)
    assert max(abs(job[s] - twin[s]) for s in job) < LOSS_ATOL
    assert res["runs"][0]["final"]["elastic"]["reshards"] == 2
    logs = os.path.join(app_dir, "logs")
    relaunched = open(os.path.join(logs, "worker_0_attempt1.log"), errors="replace").read()
    assert "training as its rank" in relaunched and "ELASTIC SUMMARY" in relaunched
    procs = [json.loads(line) for line in open(os.path.join(app_dir, "trace",
                                                            "worker_0_user_a1.jsonl"))
             if line.strip()]
    names = {r.get("name") for r in procs}
    assert {"elastic.member", "elastic.rank_reshard", "train.fit"} <= names


# --- a rank killed between the gradient sum and the update -------------------------

KILL_STEP = 3
KILL_STEPS = 6


def test_a_rank_killed_after_its_gradient_sum_leaves_the_state_untouched(tmp_path):
    """Rank 1 dies right after its dp gradient sum of step KILL_STEP, before
    the loss mean and the update. The survivor's next collective fails; it
    waits for the declared shrink, re-forms its group and redoes the step:
    its parameters after the run are bit-equal to a run whose plan takes
    member 1 out at that step, and its journal shows the boundary at the
    failed step, no lost step and every step once."""
    base = {"steps": KILL_STEPS, "warmup_steps": 2, "elastic_members": 2}
    runs = {}
    for name, extra in (("killed", {"kill": {"rank": 1, "step": KILL_STEP}}),
                        ("plan", {})):
        d = tmp_path / name
        d.mkdir()
        fit_kw = {**base, "elastic_dir": str(d)}
        if name == "plan":
            fit_kw["plan"] = [[KILL_STEP, [0]]]
        runs[name] = spawn(2, "elastic", {"runs": [{"model": {}, "data": DATA,
                                                    "fit": fit_kw, **extra}]},
                           tmp_path / f"{name}-ranks", may_die=(1,) if extra else ())
        runs[name] = (runs[name], str(d))
    (killed, killed_dir), (plan, _) = runs["killed"], runs["plan"]
    assert killed[1] is None and plan[1] is not None
    got, want = killed[0]["runs"][0], plan[0]["runs"][0]
    assert sorted(got["params"]) == sorted(want["params"])
    for name in want["params"]:
        assert np.array_equal(got["params"][name], want["params"][name]), name
    assert got["final"]["elastic"]["members"] == [0]
    (bound,) = got["final"]["elastic_boundaries"]
    assert bound["at_step"] == KILL_STEP and bound["failure_to_group_s"] > 0
    recs = read_journal(journal_path(killed_dir, 0))
    (reshard,) = [r for r in recs if r["type"] == "reshard"]
    assert (reshard["boundary"], reshard["at_step"], reshard["skipped"],
            reshard["lost_steps"]) == ("shrink", KILL_STEP, {"1": [KILL_STEP, -1]}, 0)
    assert [r["step"] for r in recs if r["type"] == "step"] == list(range(KILL_STEPS))


# --- a relaunched member finds its gang on the run's store -------------------------


def test_relaunched_member_joins_through_the_store_on_its_first_backend(monkeypatch):
    """A relaunched member (attempt 1, rank 1) of an elastic job brings up
    no group at the launch's world size when rank 0's store holds a
    running gang's key: it keeps a client of that store and the backend
    the first call asked for, which ``fit()``'s second call (CUDA's
    default NCCL on a card) does not replace."""
    import socket
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from tony_tpu_torch.parallel import dist as pdist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = dist.TCPStore("127.0.0.1", port, is_master=True, wait_for_workers=False,
                           timeout=timedelta(seconds=30))
    server.set(pdist.ELASTIC_RUN_KEY, "elastic/run-1")
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": "1",
           "WORLD_SIZE": "2", "LOCAL_RANK": "0", "TONY_ATTEMPT": "1", "TONY_ELASTIC": "1",
           "TONY_ELASTIC_DETECT_S": "2.0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(pdist, "_rejoin", None)
    assert pdist.elastic_timeout() == timedelta(seconds=pdist.ELASTIC_TIMEOUT_FLOOR_S)
    assert pdist.initialize(torch.device("cpu"), backend="gloo") is False
    assert pdist.initialize(torch.device("cuda")) is False
    store, backend = pdist.elastic_rejoin()
    assert backend == "gloo" and not dist.is_initialized()
    assert store.get(pdist.ELASTIC_RUN_KEY) == b"elastic/run-1"


@pytest.mark.parametrize("command,argv", [
    ("python train.py --steps 5", ["train.py", "--steps", "5"]),
    (f"{sys.executable} train.py", ["train.py"]),
    ("python -m trainer", None),
    ("bash run.sh", None),
    ("python", None),
])
def test_member_runs_the_chiefs_python_script(command, argv):
    """The member agent runs the chief's ``python SCRIPT ARGS`` in its own
    process and refuses any other command."""
    from tony_tpu_torch.elastic.member import trainer_argv

    if argv is None:
        with pytest.raises(ValueError, match="python SCRIPT"):
            trainer_argv(command)
    else:
        assert trainer_argv(command) == argv
