"""The port's chaos checker and runner (``tony_tpu_torch/chaos/invariants.py``,
``runner.py``, ``tony chaos``) against the reference's, on the same inputs.

- ``check_invariants`` over hand-made app dirs, one for each way an
  invariant is violated (and a clean one), with and without a lease store:
  both checkers give the same report, violations, details and notes;
- ``tony chaos`` through both packages' CLIs on one CPU job under one
  schedule (``kill_container`` on ``worker:0``): the same exit code, final
  state and report, and each checker's report over the other package's app
  dir equal to its own; a bad or empty schedule exits 2 in both before
  anything is submitted."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from tony_tpu.chaos.invariants import check_invariants as ref_check
from tony_tpu_torch.chaos.invariants import check_invariants
from tony_tpu_torch.cluster.lease import STATE_FILE

ROOT = Path(__file__).resolve().parents[1]
FINISHED = {"type": "APPLICATION_FINISHED", "ts": 9, "state": "SUCCEEDED"}


def _journal(steps=6, reshard_at=3, **edit):
    """An elastic trainer journal: members [0, 1], member 1 out from
    ``reshard_at`` on (declared), smooth losses, distinct fingerprints;
    ``edit`` names the records to change (see the cases)."""
    recs = [{"type": "meta", "member": 0, "members": 2,
             "tolerance": {"window": 4, "z": 4.0, "frac": 0.25}}]
    for s in range(steps):
        if s == reshard_at:
            recs.append({"type": "reshard", "gen": 1, "at_step": s, "boundary": "shrink",
                         "members": [0], "dead": [1], "added": [],
                         "skipped": edit.get("skipped", {"1": [s, -1]})})
        members = [0, 1] if s < reshard_at else [0]
        recs.append({"type": "step", "step": edit.get("step_at", {}).get(s, s), "gen": 0,
                     "members": members})
        loss = edit.get("loss_from", (steps, 0.0))
        recs.append({"type": "loss", "step": s, "gen": 0,
                     "loss": loss[1] if s >= loss[0] else 5.0 - 0.01 * s,
                     "fp": edit.get("fp_at", {}).get(s, 100 + s)})
    return recs


def _ledger(**edit):
    led = {"ttft_budget_s": 2.0, "pending": [], "handoffs": [
        {"rid": "r0", "ok": True, "shipped": 3, "adopted": 2, "freed": 1}],
        "requests": [{"rid": f"r{i}", "finish_reason": "length", "tokens": 8,
                      "replays": 0, "replay_consistent": True, "ttft_s": 0.5}
                     for i in range(3)]}
    for k, v in edit.items():
        if k == "request":
            led["requests"][1].update(v)
        elif k == "handoff":
            led["handoffs"][0].update(v)
        else:
            led[k] = v
    return led


# name: (status (None: no file), events, extra files {relative path: payload}, store)
CASES = {
    "clean": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {}, None),
    "no_status": (None, [FINISHED], {}, None),
    "non_terminal": ({"state": "RUNNING", "exit_code": -1}, [FINISHED], {}, None),
    "succeeded_nonzero": ({"state": "SUCCEEDED", "exit_code": 3}, [FINISHED], {}, None),
    "killed_zero": ({"state": "KILLED", "exit_code": 0},
                    [{**FINISHED, "state": "KILLED"}], {}, None),
    "no_finished": ({"state": "SUCCEEDED", "exit_code": 0}, [], {}, None),
    "journal_disagrees": ({"state": "FAILED", "exit_code": 1}, [FINISHED], {}, None),
    "generation_rewinds": ({"state": "SUCCEEDED", "exit_code": 0}, [
        {"type": "GANG_RESTART", "ts": 1, "generation": 2},
        {"type": "METADATA", "ts": 2, "recovered_generation": 1}, FINISHED], {}, None),
    "health_tripped": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {
        "health/verdict_worker_0.json": {"verdict": "tripped", "proc": "worker_0",
                                         "rules": {"nonfinite": {"trips": 3}}}}, None),
    "slo_tripped": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {
        "slo/verdict_w0.json": {"verdict": "tripped", "proc": "w0",
                                "slos": {"ttft_p99_s": {"trips": 9}}}}, None),
    "elastic_clean": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED],
                      {"elastic/journal_m0.jsonl": _journal()}, None),
    "elastic_repeated_step": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED],
                              {"elastic/journal_m0.jsonl": _journal(step_at={2: 1})}, None),
    "elastic_undeclared_gap": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED],
                               {"elastic/journal_m0.jsonl": _journal(skipped={})}, None),
    "elastic_fingerprint": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED],
                            {"elastic/journal_m0.jsonl": _journal(fp_at={4: 103})}, None),
    "elastic_discontinuity": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED],
                              {"elastic/journal_m0.jsonl": _journal(loss_from=(3, 9.5))},
                              None),
    "elastic_nonfinite": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {
        "elastic/journal_m0.jsonl": _journal(loss_from=(3, float("nan")))}, None),
    "serve_clean": ({"state": "KILLED", "exit_code": 143},
                    [{**FINISHED, "state": "KILLED"}],
                    {"serve/requests_frontend.json": _ledger()}, None),
    "serve_pending": ({"state": "KILLED", "exit_code": 143}, [{**FINISHED, "state": "KILLED"}],
                      {"serve/requests_frontend.json": _ledger(pending=["r9"])}, None),
    "serve_failed": ({"state": "KILLED", "exit_code": 143}, [{**FINISHED, "state": "KILLED"}],
                     {"serve/requests_frontend.json": _ledger(
                         request={"finish_reason": "error", "message": "host lost"})}, None),
    "serve_replay_parted": ({"state": "KILLED", "exit_code": 143},
                            [{**FINISHED, "state": "KILLED"}],
                            {"serve/requests_frontend.json": _ledger(
                                request={"replays": 1, "replay_consistent": False})}, None),
    "serve_ttft_over": ({"state": "KILLED", "exit_code": 143}, [{**FINISHED, "state": "KILLED"}],
                        {"serve/requests_frontend.json": _ledger(request={"ttft_s": 7.5})},
                        None),
    "handoff_leak": ({"state": "KILLED", "exit_code": 143}, [{**FINISHED, "state": "KILLED"}],
                     {"serve/requests_frontend.json": _ledger(handoff={"freed": 0})}, None),
    "handoff_failed_lost": ({"state": "KILLED", "exit_code": 143},
                            [{**FINISHED, "state": "KILLED"}],
                            {"serve/requests_frontend.json": _ledger(
                                handoff={"rid": "r7", "ok": False, "message": "dead"})}, None),
    "serve_unreadable": ({"state": "KILLED", "exit_code": 143}, [{**FINISHED, "state": "KILLED"}],
                         {"serve/requests_frontend.json": "{not json"}, None),
    "lease_clean": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {},
                    {"hosts": {"h1": {"memory_mb": 256, "cpus": 4, "tpu_chips": 8}},
                     "apps": {}, "queue": [], "events": []}),
    "lease_strand": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {},
                     {"hosts": {"h1": {"memory_mb": 256, "cpus": 4, "tpu_chips": 8}},
                      "apps": {"APP": {"owner_host": "elsewhere", "owner_pid": 1,
                                       "ttl_s": 0, "gangs": []}},
                      "queue": [{"app_id": "APP", "seq": 4, "owner_host": "elsewhere"}],
                      "events": []}),
    "lease_events_audit": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {},
                           {"hosts": {"h1": {"memory_mb": 256, "cpus": 4, "tpu_chips": 8}},
                            "apps": {}, "queue": [],
                            "events": [{"ts": 1.0, "op": "grow", "app_id": "x",
                                        "owner": "a:1", "host": "ghost"}]}),
    "lease_double_book": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {},
                          {"hosts": {"h1": {"memory_mb": 256, "cpus": 4, "tpu_chips": 8}},
                           "apps": {"other": {"owner_host": "elsewhere", "ttl_s": 30,
                                              "renewed_at": 0, "gangs": [{
                                                  "asks": [{"memory_mb": 200, "cpus": 2,
                                                            "tpu_chips": 8}] * 2,
                                                  "hosts": ["h1", "h1"]}]}},
                           "queue": [], "events": []}),
    "lease_unreadable": ({"state": "SUCCEEDED", "exit_code": 0}, [FINISHED], {}, "{torn"),
}

# the invariant each case breaks (None: clean)
EXPECT = {
    "clean": None, "no_status": "terminal-status", "non_terminal": "terminal-status",
    "succeeded_nonzero": "terminal-status", "killed_zero": "terminal-status",
    "no_finished": "events-complete", "journal_disagrees": "events-complete",
    "generation_rewinds": "generation-monotonic", "health_tripped": "health-verdict-surfaced",
    "slo_tripped": "slo-surfaced", "elastic_clean": None,
    "elastic_repeated_step": "elastic-no-data-loss",
    "elastic_undeclared_gap": "elastic-no-data-loss",
    "elastic_fingerprint": "elastic-no-data-loss",
    "elastic_discontinuity": "elastic-loss-continuity",
    "elastic_nonfinite": "elastic-loss-continuity", "serve_clean": None,
    "serve_pending": "serve-no-request-lost", "serve_failed": "serve-no-request-lost",
    "serve_replay_parted": "serve-no-request-lost", "serve_ttft_over": "serve-ttft-bounded",
    "handoff_leak": "handoff-no-block-leak", "handoff_failed_lost": "handoff-no-block-leak",
    "serve_unreadable": "serve-no-request-lost", "lease_clean": None,
    "lease_strand": "lease-no-strand", "lease_events_audit": "lease-events-audit",
    "lease_double_book": "lease-no-double-book", "lease_unreadable": "lease-no-strand",
}


def _write(path: Path, payload) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(payload, str):
        path.write_text(payload)
    elif isinstance(payload, list):
        path.write_text("".join(json.dumps(r) + "\n" for r in payload))
    else:
        path.write_text(json.dumps(payload))


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_invariants_matches_reference(tmp_path, case):
    status, events, files, store = CASES[case]
    app = tmp_path / "APP"
    app.mkdir()
    if status is not None:
        _write(app / "status.json", {**status, "tasks": []})
    _write(app / "events" / "APP.jhist.jsonl", events)
    for rel, payload in files.items():
        _write(app / rel, payload)
    rm_root = ""
    if store is not None:
        rm_root = str(tmp_path / "rm")
        _write(Path(rm_root) / STATE_FILE, store)
    ours = check_invariants([str(app)], rm_root=rm_root)
    theirs = ref_check([str(app)], rm_root=rm_root)
    assert ours.to_dict() == theirs.to_dict()
    assert type(ours).__module__ == "tony_tpu_torch.chaos.invariants"
    kinds = {v.invariant for v in ours.violations}
    if EXPECT[case] is None:
        assert ours.ok, ours.to_json()
    else:
        assert EXPECT[case] in kinds, ours.to_json()


# --- tony chaos through both CLIs -------------------------------------------------

JOB = ("[application]\nname = \"chaos-cli\"\nframework = \"generic\"\n"
       "stage_dir = \"{stage}\"\ntimeout_s = 90\n"
       "[task]\nheartbeat_interval_ms = 200\nmax_missed_heartbeats = 10\n"
       "[restart]\npolicy = \"gang\"\nmax_worker_restarts = 2\n"
       "[job.worker]\ninstances = 2\n"
       "command = \"python -c \\\"import time; time.sleep(2)\\\"\"\n")
KILL = '[{"type": "kill_container", "task": "worker:0", "at_count": 2}]'
PACKAGES = ("tony_tpu", "tony_tpu_torch")


def _cli(pkg: str, *argv: str, cwd=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", *argv], cwd=cwd or ROOT,
                          capture_output=True, text=True, timeout=240,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


def _masked(payload: dict) -> dict:
    app = payload["app_id"]
    return json.loads(json.dumps({k: v for k, v in payload.items()
                                  if k not in ("app_id", "app_dir")}).replace(app, "APP"))


def test_tony_chaos_through_both_clis(tmp_path):
    runs: dict = {}

    def run(pkg):
        stage = tmp_path / pkg
        stage.mkdir()
        conf = tmp_path / f"{pkg}.toml"
        conf.write_text(JOB.format(stage=stage))
        runs[pkg] = _cli(pkg, "chaos", "--conf", str(conf), "--quiet", "--faults", KILL,
                         "--expect", "SUCCEEDED")

    threads = [threading.Thread(target=run, args=(p,)) for p in PACKAGES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    out = {}
    for pkg, r in runs.items():
        assert r.returncode == 0, (pkg, r.stdout, r.stderr[-3000:])
        out[pkg] = json.loads(r.stdout[r.stdout.index("{"):])
    ref, port = out["tony_tpu"], out["tony_tpu_torch"]
    assert _masked(ref) == _masked(port)
    assert port["state"] == "SUCCEEDED" and port["report"]["ok"]
    for pkg in PACKAGES:
        with open(os.path.join(out[pkg]["app_dir"], "status.json")) as f:
            assert all(t["attempts"] == 2 for t in json.load(f)["tasks"]), pkg
    # each checker over the other package's app dir
    for d in (ref["app_dir"], port["app_dir"]):
        assert check_invariants([d]).to_dict() == ref_check([d]).to_dict()
        assert check_invariants([d]).ok


@pytest.mark.parametrize("faults", ['[{"type": "nope"}]', "[]", "{bad json"],
                         ids=["unknown_type", "empty", "malformed"])
def test_tony_chaos_refuses_a_bad_schedule_alike(tmp_path, faults):
    conf = tmp_path / "job.toml"
    conf.write_text(JOB.format(stage=tmp_path / "stage"))
    got = [_cli(pkg, "chaos", "--conf", str(conf), "--faults", faults) for pkg in PACKAGES]
    assert [r.returncode for r in got] == [2, 2]
    assert got[0].stderr.splitlines()[-1] == got[1].stderr.splitlines()[-1]
    assert got[0].stderr.startswith("bad fault schedule")
    assert not (tmp_path / "stage").exists()
