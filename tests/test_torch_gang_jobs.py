"""Gang-serving jobs through both packages' client, AM, local backend,
executor and ``serve`` runtime, the decode hosts real processes on the CPU
(the port's started with ``--device cpu``):

- the reference's ``test_gang_serve_e2e_kill_container_midstream`` in both
  packages at once: two hosts, speculative decoding on, chaos SIGKILLs
  decode:0 once a stream is mid-flight on it; every request completes with
  a consistent replay, the AM relaunches decode:0 alone, both packages'
  post-mortem invariant checkers are clean and equal on both app dirs, and the journaled
  ``serve.reprefill`` span hangs off its request's ``serve.request`` span.

``python -m tony_tpu_torch.cli serve --demo 4`` is held in
``tests/test_torch_gang.py``, beside the in-process hosts, to keep each
file's time under a minute.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

import tony_tpu.cli.client as rclient
import tony_tpu.config.config as rconf
import tony_tpu.obs.trace as rtrace
import tony_tpu.rpc as rrpc
import tony_tpu.serve.frontend as rfront
import tony_tpu.serve.gang as rgang
import tony_tpu_torch.cli.client as pclient
import tony_tpu_torch.config.config as pconf
import tony_tpu_torch.obs.trace as ptrace
import tony_tpu_torch.rpc as prpc
import tony_tpu_torch.serve.frontend as pfront
import tony_tpu_torch.serve.gang as pgang
from torch_jobs import check_both

ROOT = Path(__file__).resolve().parent.parent
PKGS = {
    "ref": dict(client=rclient, conf=rconf, trace=rtrace, rpc=rrpc, front=rfront,
                gang=rgang, worker=f"{sys.executable} -m tony_tpu.serve.gang"),
    "port": dict(client=pclient, conf=pconf, trace=ptrace, rpc=prpc, front=pfront,
                 gang=pgang,
                 worker=f"{sys.executable} -m tony_tpu_torch.serve.gang --device cpu"),
}
NEW_TOKENS = 96


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, n).astype(np.int32)


def _kill_midstream(pkg: str, tmp_path) -> dict:
    m = PKGS[pkg]
    trigger = tmp_path / f"kill-now-{pkg}"
    cfg = m["conf"].TonyConfig.load(overrides={
        "task.heartbeat_interval_ms": 200,
        "task.max_missed_heartbeats": 20,
        "application.timeout_s": 300,
        "application.stage_dir": str(tmp_path / pkg),
        "application.name": "serve-gang-kill",
        "application.framework": "serve",
        "serve.gang.hosts": 2,
        "serve.gang.model": "tiny",
        "serve.gang.slots": 2,
        "serve.gang.max_len": 256,
        "serve.gang.max_queue": 8,
        "serve.gang.ttft_budget_s": 120,
        "serve.spec.enabled": True,
        "job.decode.instances": 2,
        "job.decode.command": m["worker"],
        "job.decode.env": ["JAX_PLATFORMS=cpu"],
        "chaos.enabled": True,
        "chaos.faults": json.dumps([{"type": "kill_container", "task": "decode:0",
                                     "on_file": str(trigger)}]),
        "trace.sample_steps": 1,
    })
    client = m["client"].TonyClient(cfg)
    client.stage()
    client.launch_am()
    app_dir = client.app_dir
    fe = None
    out = {}
    try:
        am_addr = client.am_address(timeout_s=60.0)
        m["trace"].install_from_config(cfg, app_dir, client.app_id, proc="frontend")
        fe = m["front"].GangFrontend(am_addr, m["gang"].GangSettings.from_config(cfg),
                                     app_dir=app_dir)
        fe.wait_ready(2, timeout_s=150.0)
        rids = [fe.submit(_prompt(4, seed=i), NEW_TOKENS) for i in range(4)]
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            with fe._lock:
                flights = list(fe._flights.values())
            if any(f.result.tokens and f.result.hosts and f.result.hosts[-1] == "decode:0"
                   and not f.done.is_set() for f in flights):
                break
            time.sleep(0.02)
        else:
            raise AssertionError("no stream reached decode:0 before the kill window")
        trigger.write_text("")
        res = {rid: fe.result(rid, timeout_s=180.0) for rid in rids}
        out["requests"] = sorted((c.finish_reason, len(c.tokens), c.replay_consistent)
                                 for c in res.values())
        replayed = [c for c in res.values() if c.replays]
        out["replayed"] = bool(replayed)
        out["moved"] = any(c.hosts[0] == "decode:0" and c.hosts[-1] != "decode:0"
                           for c in replayed)
        fe.close()
        fe = None
    finally:
        if fe is not None:
            fe.close(wait_s=0.0)
        try:
            with m["rpc"].ApplicationRpcClient(client.am_address(timeout_s=5.0),
                                               timeout_s=5.0) as c:
                c.stop_application("serve e2e done")
        except Exception:
            pass
        code = client.monitor(quiet=True)
        m["trace"].uninstall()
    with open(os.path.join(app_dir, "status.json")) as f:
        status = json.load(f)
    attempts = {t["task"]: t["attempts"] for t in status["tasks"]}
    out.update(code=code, state=status["state"],
               attempts=(attempts["decode:0"] >= 2, attempts["decode:1"]))
    report = check_both([app_dir])
    assert report.ok, (pkg, report.to_json())
    with open(os.path.join(app_dir, "serve", "requests_frontend.json")) as f:
        ledger = json.load(f)
    out["ledger"] = (len(ledger["requests"]), ledger["pending"],
                     any(e["replays"] for e in ledger["requests"]),
                     all(e["replay_consistent"] for e in ledger["requests"]))
    with open(os.path.join(app_dir, "trace", "frontend.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    spans = [r for r in recs if r.get("ph") == "X"]
    reqs = {r["sid"]: r for r in spans if r["name"] == "serve.request"}
    refills = [r for r in spans if r["name"] == "serve.reprefill"]
    out["reprefill_parented"] = bool(refills) and all(
        r["psid"] in reqs and reqs[r["psid"]]["args"]["rid"] == r["args"]["rid"]
        for r in refills)
    trace_dir = os.path.join(app_dir, "trace")
    out["chaos_instant"] = any("chaos.kill_container" in Path(trace_dir, n).read_text()
                               for n in os.listdir(trace_dir))
    return out


def test_gang_serve_e2e_kill_container_midstream(tmp_path):
    got, errors = {}, {}

    def run(pkg):
        try:
            got[pkg] = _kill_midstream(pkg, tmp_path)
        except BaseException as e:  # reported below, with the other package's result
            errors[pkg] = repr(e)

    threads = [threading.Thread(target=run, args=(pkg,)) for pkg in PKGS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(400)
    assert not errors, errors
    assert got["ref"] == got["port"], got
    port = got["port"]
    assert port["requests"] == [("length", NEW_TOKENS, True)] * 4
    assert port["replayed"] and port["moved"]
    assert (port["code"], port["state"], port["attempts"]) == (143, "KILLED", (True, 1))
    assert port["ledger"] == (4, [], True, True)
    assert port["reprefill_parented"] and port["chaos_instant"]

