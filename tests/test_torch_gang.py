"""Gang serving in the port (``tony_tpu_torch.serve.gang`` / ``.frontend``,
the ServeRpc half of ``rpc/service.py``, the ``serve`` runtime) held against
the reference's, on the tiny float32 config, hosts in this process.

- ``GangSettings`` and ``ServeRuntime`` read one config alike in both
  packages, and each package's JSON reads back in the other's;
- the engine's streaming seam (``queue_depth``, ``rejected_total``,
  ``completion_of``, ``take_completion``) and a deterministic re-prefill on a
  fresh engine: greedy tokens equal the reference engine's, sampled tokens
  equal draw for draw the port's own uninterrupted run;
- the ServeRpc wire: the same method table, a port client against a
  reference host and a reference client against a port host with equal
  greedy streams, UNIMPLEMENTED and UNAUTHENTICATED alike;
- the reference's frontend tests (routing, fail-over, drain, bounded
  admission, both autoscale hooks, a prefill host killed mid-handoff) run
  in both packages with the same outcome;
- ``python -m tony_tpu_torch.cli serve --demo 4`` through a job of two
  port decode hosts on the CPU exits 0.

Every host of both packages holds the same weights: the port's
``init_params`` is replaced, for these tests, by the reference's draws
carried across ``models/convert.py``, so tokens compare across packages.
"""

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import asdict
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
import torch

import tony_tpu.chaos as rchaos
import tony_tpu.cluster.backend as rback
import tony_tpu.cluster.lease as rlease
import tony_tpu.config.config as rconf
import tony_tpu.rpc as rrpc
import tony_tpu.rpc.service as rservice
import tony_tpu.runtime as rrt
import tony_tpu.runtime.base as rrtbase
import tony_tpu.serve.engine as rengine
import tony_tpu.serve.frontend as rfront
import tony_tpu.serve.gang as rgang
import tony_tpu_torch.chaos as pchaos
import tony_tpu_torch.cluster.backend as pback
import tony_tpu_torch.cluster.lease as please
import tony_tpu_torch.config.config as pconf
import tony_tpu_torch.models.llama as pllama
import tony_tpu_torch.rpc as prpc
import tony_tpu_torch.rpc.service as pservice
import tony_tpu_torch.runtime as prt
import tony_tpu_torch.runtime.base as prtbase
import tony_tpu_torch.serve.engine as pengine
import tony_tpu_torch.serve.frontend as pfront
import tony_tpu_torch.serve.gang as pgang
from tony_tpu.models import llama as jl
from tony_tpu_torch.models.convert import params_from_numpy
from torch_jobs import check_both

ROOT = Path(__file__).resolve().parent.parent
PKGS = {
    "ref": dict(gang=rgang, front=rfront, engine=rengine, rpc=rrpc, service=rservice,
                conf=rconf, rt=rrt, rtbase=rrtbase, lease=rlease, back=rback, chaos=rchaos),
    "port": dict(gang=pgang, front=pfront, engine=pengine, rpc=prpc, service=pservice,
                 conf=pconf, rt=prt, rtbase=prtbase, lease=please, back=pback,
                 chaos=pchaos),
}
_JPARAMS: dict[int, dict] = {}


def _ref_tree(seed: int) -> dict:
    if seed not in _JPARAMS:
        _JPARAMS[seed] = jax.tree.map(
            np.asarray, jl.init_params(jax.random.key(seed), jl.LlamaConfig.tiny()))
    return _JPARAMS[seed]


@pytest.fixture(autouse=True)
def reference_weights(monkeypatch):
    """The port's hosts draw the reference's weights for the generator's
    seed (what ``build_gang_engine`` seeds it with)."""
    def init_params(cfg, generator=None, device=None):
        return params_from_numpy(_ref_tree(generator.initial_seed()), cfg, device=device)

    monkeypatch.setattr(pllama, "init_params", init_params)


def factory(pkg: str, settings, pool: str = "decode"):
    if pkg == "ref":
        return lambda: rgang.build_gang_engine(settings, pool=pool)
    return lambda: pgang.build_gang_engine(settings, pool=pool, device="cpu")


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, n).astype(np.int32)


def start_host(pkg: str, settings, name: str, pool: str = "decode", token=None):
    m = PKGS[pkg]
    svc = m["gang"].DecodeHostService(factory(pkg, settings, pool), name, pool=pool)
    server, port = m["rpc"].serve_rpc(svc, host="127.0.0.1", port=0, token=token)
    svc.start()
    return svc, server, port


def stop_host(host) -> None:
    svc, server, _ = host
    svc.shutdown()
    server.stop(0)


# --- settings and the serve runtime -------------------------------------------------

CONFIGS = {
    "reference": {"serve.gang.hosts": 3, "serve.gang.model": "tiny",
                  "serve.gang.slots": 2, "serve.gang.max_queue": 5,
                  "serve.gang.ttft_budget_s": 2.5, "job.decode.instances": 3},
    "pools": {"serve.gang.hosts": 1, "serve.pool.prefill_hosts": 2,
              "serve.pool.handoff_min_tokens": 32, "serve.quant.enabled": True,
              "serve.quant.weights": True, "serve.quant.kv_dtype": "fp8_e4m3",
              "serve.spec.enabled": True, "serve.spec.max_draft": 6,
              "serve.prefix.budget_mb": 12.5, "serve.chunk_tokens": 64,
              "serve.gang.shard": True, "job.decode.instances": 1,
              "job.prefill.instances": 2},
}
BAD = {
    "no decode type": {"serve.gang.hosts": 2},
    "no prefill type": {"serve.pool.prefill_hosts": 1, "job.decode.instances": 1},
    "same type": {"serve.pool.prefill_hosts": 1, "serve.pool.prefill_job_type": "decode",
                  "job.decode.instances": 1},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gang_settings_and_runtime_env_equal(name, monkeypatch):
    monkeypatch.setenv("TONY_AM_ADDR", "amhost:9")
    values = CONFIGS[name]
    ref = rgang.GangSettings.from_config(rconf.TonyConfig(values))
    port = pgang.GangSettings.from_config(pconf.TonyConfig(values))
    assert asdict(ref) == asdict(port)
    assert asdict(pgang.GangSettings.from_json(ref.to_json())) == asdict(ref)
    assert asdict(rgang.GangSettings.from_json(port.to_json())) == asdict(port)
    assert ref.to_json() == port.to_json()
    envs = []
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        job = "decode" if name == "reference" else "prefill"
        identity = m["rtbase"].TaskIdentity(
            job_name=job, index=1,
            cluster_spec={job: ["h0:7001", "h1:7002", "h2:7003"]},
            coordinator_address="h0:7001", process_id=1, num_processes=3)
        rt = m["rt"].make_runtime("serve")
        rt.validate(m["conf"].TonyConfig(values))
        assert rt.needs_data_port()
        envs.append(rt.build_env(identity, m["conf"].TonyConfig(values)))
    envs[0].pop("TONY_JAX_CACHE_DIR", None)
    assert envs[0] == envs[1]
    assert envs[1]["TONY_SERVE_PORT"] == "7002"


@pytest.mark.parametrize("bad", sorted(BAD))
def test_serve_runtime_refuses_alike(bad):
    errors = []
    for pkg in ("ref", "port"):
        m = PKGS[pkg]
        with pytest.raises(ValueError) as e:
            m["rt"].make_runtime("serve").validate(m["conf"].TonyConfig(BAD[bad]))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_shard_is_a_noop_on_one_card_and_refused_on_more(monkeypatch):
    settings = pgang.GangSettings(model="tiny", slots=1, max_len=32, shard=True)
    assert pgang.build_gang_engine(settings, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1, item 10"):
        pgang.build_gang_engine(settings)
    with pytest.raises(ValueError, match="not a LlamaConfig preset"):
        pgang.build_gang_engine(pgang.GangSettings(model="gpt2"), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pgang.build_gang_engine(pgang.GangSettings(model="tiny", slots=1, max_len=32))


# --- the engine's streaming seam ----------------------------------------------------


def _engines(serve: dict, pkgs=("ref", "port")):
    cfg = pllama.LlamaConfig.tiny()
    tree = _ref_tree(0)
    out = {}
    if "ref" in pkgs:
        out["ref"] = rengine.Engine(jax.tree.map(jax.numpy.asarray, tree),
                                    jl.LlamaConfig.tiny(), rengine.ServeConfig(**serve))
    if "port" in pkgs:
        out["port"] = pengine.Engine(params_from_numpy(tree, cfg, device="cpu"), cfg,
                                     pengine.ServeConfig(**serve), device="cpu")
    return out


def test_engine_bounded_admission_alike():
    got = {}
    for pkg, eng in _engines(dict(slots=1, max_len=32, max_queue=2)).items():
        R = PKGS[pkg]["engine"].Request
        for _ in range(2):
            eng.submit(R(prompt=_prompt(3), max_new_tokens=2))
        assert eng.queue_depth == 2
        with pytest.raises(PKGS[pkg]["engine"].AdmissionRejected) as e:
            eng.submit(R(prompt=_prompt(3), max_new_tokens=2))
        snap = {x["name"]: x for x in eng.registry.snapshot()}
        first = (str(e.value), eng.rejected_total, snap["tony_serve_rejected_total"]["value"])
        eng.run()
        assert eng.queue_depth == 0
        eng.submit(R(prompt=_prompt(3), max_new_tokens=2))
        done = eng.run()
        got[pkg] = (first, eng.rejected_total, [c.tokens for c in done.values()])
    assert got["ref"] == got["port"]
    assert got["port"][0][1:] == (1, 1)


def test_completion_grows_in_place_and_take_completion_evicts():
    eng = _engines(dict(slots=2, max_len=32), ("port",))["port"]
    rid = eng.submit(pengine.Request(prompt=_prompt(4), max_new_tokens=6))
    assert eng.completion_of(rid) is None          # queued, not yet slotted
    eng.step()
    comp = eng.completion_of(rid)
    seen = [len(comp.tokens)]
    while not comp.finish_reason:
        eng.step()
        seen.append(len(comp.tokens))
    assert eng.completion_of(rid) is comp          # the same object, grown in place
    assert seen == list(range(2, 7)) and comp.finish_reason == "length"
    assert eng.take_completion(rid) is comp
    assert eng.completion_of(rid) is None and eng.take_completion(rid) is None
    assert eng.run() == {}                         # run() has nothing left to evict


def test_deterministic_reprefill_on_fresh_engine():
    """A request cut off mid-decode and replayed on a fresh engine with the
    same seed: greedy tokens equal the reference engine's; sampled tokens
    equal the port's own uninterrupted run on a busy engine draw for draw,
    the delivered prefix included."""
    serve = dict(slots=2, max_len=32, kv_block=8)
    out = {}
    for temp, top_k in ((0.0, 0), (0.9, 11)):
        req = dict(prompt=_prompt(5, seed=3), max_new_tokens=12, temperature=temp,
                   top_k=top_k, rng=1234)
        busy = {}
        for pkg, eng in _engines(serve, ("ref", "port") if temp == 0 else ("port",)).items():
            R = PKGS[pkg]["engine"].Request
            eng.submit(R(prompt=_prompt(4, seed=9), max_new_tokens=6))
            rid = eng.submit(R(**req))
            busy[pkg] = eng.run()[rid].tokens
        dead = _engines(dict(slots=1, max_len=32), ("port",))["port"]
        drid = dead.submit(pengine.Request(**req))
        for _ in range(4):
            dead.step()
        partial = list(dead.completion_of(drid).tokens)
        assert 0 < len(partial) < 12 and not dead.completion_of(drid).finish_reason
        surv = _engines(dict(slots=2, max_len=32), ("port",))["port"]
        srid = surv.submit(pengine.Request(**req))
        replay = surv.run()[srid].tokens
        assert replay == busy["port"] and replay[:len(partial)] == partial
        out[temp] = busy
    assert out[0.0]["port"] == out[0.0]["ref"]


# --- the ServeRpc wire ------------------------------------------------------------------


def test_serve_method_table_equal():
    def table(service):
        return {name: (req.DESCRIPTOR.full_name, resp.DESCRIPTOR.full_name, streaming)
                for name, (req, resp, streaming) in service._SERVE_METHODS.items()}

    assert table(pservice) == table(rservice)
    assert pservice.SERVE_SERVICE_NAME == rservice.SERVE_SERVICE_NAME == "tony_tpu.ServeRpc"
    assert set(prpc.__all__) == set(rrpc.__all__)


def _stream(rpc_mod, port: int, rid: str, prompt, n: int, **kw) -> tuple[list, str]:
    req = rpc_mod.pb.InferenceRequest(rid=rid, prompt=[int(t) for t in prompt],
                                      max_new_tokens=n, eos_id=-1, **kw)
    toks, reason = [], ""
    with rpc_mod.ServeRpcClient(f"127.0.0.1:{port}") as cli:
        for chunk in cli.generate(req, timeout_s=60):
            toks += list(chunk.tokens)
            if chunk.done:
                reason = chunk.finish_reason
        stats = cli.decode_stats()
    return toks, reason, stats


@pytest.mark.parametrize("client,host", [("port", "ref"), ("ref", "port")])
def test_cross_package_wire_streams_equal(client, host):
    """A client of one package against a decode host of the other: greedy
    streams equal what the client's own package's host streams."""
    settings = rgang.GangSettings(model="tiny", slots=2, max_len=64)
    hosts = {pkg: start_host(pkg, settings, f"decode:{pkg}") for pkg in (client, host)}
    try:
        prompts = [_prompt(5, seed=1), _prompt(9, seed=2)]
        got = {pkg: [_stream(PKGS[client]["rpc"], hosts[pkg][2], f"r{i}", p, 12)
                     for i, p in enumerate(prompts)] for pkg in hosts}
    finally:
        for h in hosts.values():
            stop_host(h)
    cross, own = got[host], got[client]
    assert [(t, r) for t, r, _ in cross] == [(t, r) for t, r, _ in own]
    assert all(r == "length" and len(t) == 12 for t, r, _ in cross)
    s = cross[-1][2]
    assert (s.host_id, s.slots, s.pool, s.generated_tokens) == (f"decode:{host}", 2,
                                                                "decode", 24)


def test_status_codes_alike():
    """A bare servicer answers UNIMPLEMENTED, a wrong token UNAUTHENTICATED,
    in both packages, to clients of either."""
    codes = {}
    for host in ("ref", "port"):
        m = PKGS[host]
        bare, bare_port = m["rpc"].serve_rpc(m["rpc"].ServeRpcServicer(), host="127.0.0.1")
        svc = m["gang"].DecodeHostService(
            factory(host, rgang.GangSettings(model="tiny", slots=1, max_len=32)),
            f"decode:{host}")
        locked, locked_port = m["rpc"].serve_rpc(svc, host="127.0.0.1", token="s3cret")
        svc.start()
        try:
            for client in ("ref", "port"):
                c = PKGS[client]["rpc"]
                row = []
                for port, token in ((bare_port, None), (locked_port, "wrong")):
                    with c.ServeRpcClient(f"127.0.0.1:{port}", token=token) as cli:
                        for call in (lambda: cli.decode_stats(timeout_s=10),
                                     lambda: list(cli.generate(
                                         c.pb.InferenceRequest(rid="x", prompt=[1, 2]),
                                         timeout_s=10))):
                            with pytest.raises(grpc.RpcError) as e:
                                call()
                            row.append(e.value.code())
                with c.ServeRpcClient(f"127.0.0.1:{locked_port}", token="s3cret") as cli:
                    row.append(cli.decode_stats().host_id)
                codes[(host, client)] = row
        finally:
            svc.shutdown()
            bare.stop(0)
            locked.stop(0)
    U, A = grpc.StatusCode.UNIMPLEMENTED, grpc.StatusCode.UNAUTHENTICATED
    for (host, _), row in codes.items():
        assert row == [U, U, A, A, f"decode:{host}"], row


# --- the frontend against in-process hosts (the reference's tests, both packages) -------


def _routes_fails_over_and_drains(pkg: str) -> dict:
    """The reference's ``test_frontend_routes_fails_over_and_drains`` in
    ``pkg``: a batch across both hosts; decode:0 killed mid-stream, its
    requests replayed on decode:1 with the delivered prefix verified; a
    deterministic refusal; a rolling drain recycling the survivor."""
    m = PKGS[pkg]
    settings = m["gang"].GangSettings(model="tiny", slots=2, max_len=128, max_queue=8,
                                      max_replays=3)
    h0 = start_host(pkg, settings, "decode:0")
    h1 = start_host(pkg, settings, "decode:1")
    fe = m["front"].GangFrontend("", settings)
    fe.add_host("decode:0", f"127.0.0.1:{h0[2]}")
    fe.add_host("decode:1", f"127.0.0.1:{h1[2]}")
    out = {}
    try:
        done = fe.run([_prompt(3), _prompt(4), _prompt(5)], max_new_tokens=8)
        out["first"] = sorted((c.finish_reason, len(c.tokens)) for c in done.values())
        out["first_hosts"] = sorted({h for c in done.values() for h in c.hosts})
        out["first_tokens"] = {rid: c.tokens for rid, c in done.items()}
        rids = [fe.submit(_prompt(4, seed=i), 60) for i in range(4)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with fe._lock:
                flights = list(fe._flights.values())
            if any(f.result.tokens and f.result.hosts[-1] == "decode:0" for f in flights):
                break
            time.sleep(0.01)
        else:
            pytest.fail("no stream reached decode:0 in time")
        h0[1].stop(None)
        res = {rid: fe.result(rid, timeout_s=120) for rid in rids}
        out["killed"] = sorted((c.finish_reason, len(c.tokens), c.replay_consistent)
                               for c in res.values())
        out["replayed"] = sum(c.replays for c in res.values()) >= 1
        out["moved"] = any(c.hosts[0] == "decode:0" and c.hosts[-1] == "decode:1"
                           for c in res.values() if c.replays)
        out["killed_tokens"] = {rid: c.tokens for rid, c in res.items()}
        bad = fe.result(fe.submit(_prompt(3), 500), timeout_s=30)
        out["bad"] = (bad.finish_reason, bad.replays, bad.tokens)
        out["restarted"] = fe.rolling_restart(recycle=True, timeout_s=10.0)
        after = fe.run([_prompt(6)], max_new_tokens=4)
        out["after"] = [(c.finish_reason, c.tokens) for c in after.values()]
        ledger = fe.close()
        out["ledger"] = (ledger["pending"], len(ledger["requests"]),
                         all(e["replay_consistent"] for e in ledger["requests"]),
                         sorted(e["finish_reason"] for e in ledger["requests"]))
    finally:
        fe._closed.set()
        h0[0].shutdown()
        stop_host(h1)
    return out


def test_frontend_routes_fails_over_and_drains():
    got = {pkg: _routes_fails_over_and_drains(pkg) for pkg in ("ref", "port")}
    assert got["ref"] == got["port"]
    port = got["port"]
    assert port["first"] == [("length", 8)] * 3
    assert port["first_hosts"] == ["decode:0", "decode:1"]
    assert port["killed"] == [("length", 60, True)] * 4
    assert port["replayed"] and port["moved"]
    assert port["bad"] == ("rejected", 0, [])
    assert port["restarted"] == ["decode:1"]
    assert port["ledger"] == ([], 9, True, ["length"] * 8 + ["rejected"])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_frontend_bounded_admission(pkg):
    m = PKGS[pkg]
    fe = m["front"].GangFrontend("", m["gang"].GangSettings(frontend_max_inflight=2))
    try:
        fe.submit(_prompt(3), 4)
        fe.submit(_prompt(3), 4)
        with pytest.raises(m["front"].FrontendRejected, match="max_inflight 2"):
            fe.submit(_prompt(3), 4)
        assert fe._c_rejected.value == 1
    finally:
        ledger = fe.close(wait_s=0.0)
    assert ledger["rejected"] == 1 and sorted(ledger["pending"]) == ["r1", "r2"]


def _autoscale(pkg: str, tmp_path) -> dict:
    """The reference's ``test_frontend_autoscale_tick_calls_store_hooks``
    in ``pkg``, its store under ``tmp_path``."""
    m = PKGS[pkg]
    R, GangAsk = m["back"].Resource, m["lease"].GangAsk
    store = m["lease"].LeaseStore(str(tmp_path / pkg / "rm"))
    store.register_hosts({"h1": R(8192, 8, 8)})
    store.reserve_gang("serve-auto", [GangAsk(R(1024, 1, 0))], timeout_s=0)
    settings = m["gang"].GangSettings(autoscale_queue_high=4, autoscale_queue_low=0,
                                      autoscale_window_s=1.0)
    fe = m["front"].GangFrontend("", settings, lease_store=store, app_id="serve-auto",
                                 grow_ask=GangAsk(R(2048, 2, 4)))
    fe2 = m["front"].GangFrontend("", settings, lease_store=store, app_id="serve-auto")
    try:
        t = 100.0
        ticks = [fe.autoscale_tick(d, t + dt) for d, dt in
                 ((10, 0), (10, 1.5), (0, 2.0), (0, 3.6))]
        leases = store.summary()["apps"]["serve-auto"]["leases"]
        fe2.autoscale_tick(10, 200.0)
        ticks2 = fe2.autoscale_tick(10, 201.5)
        leases2 = store.summary()["apps"]["serve-auto"]["leases"]
        return {"ticks": ticks, "actions": fe.autoscale_actions, "leases": len(leases),
                "ticks2": ticks2, "actions2": fe2.autoscale_actions, "leases2": len(leases2)}
    finally:
        fe.close(wait_s=0.0)
        fe2.close(wait_s=0.0)
        store.release_app("serve-auto")


def test_frontend_autoscale_tick_calls_store_hooks(tmp_path):
    got = {pkg: _autoscale(pkg, tmp_path) for pkg in ("ref", "port")}
    assert got["ref"] == got["port"]
    port = got["port"]
    assert port["ticks"] == [None, "grow", None, "shrink"]
    assert "leased h1" in port["actions"][0][1] and port["leases"] == 1
    assert port["ticks2"] == "grow" and "no grow_ask" in port["actions2"][0][1]
    assert port["leases2"] == 1


def _autoscale_pools(pkg: str, tmp_path) -> dict:
    """The reference's ``test_frontend_autoscale_per_pool_grows_the_right_ask``
    in ``pkg``."""
    m = PKGS[pkg]
    R, GangAsk = m["back"].Resource, m["lease"].GangAsk
    store = m["lease"].LeaseStore(str(tmp_path / pkg / "rm"))
    store.register_hosts({"h1": R(16384, 16, 8)})
    store.reserve_gang("serve-pools", [GangAsk(R(1024, 1, 0))], timeout_s=0)
    settings = m["gang"].GangSettings(autoscale_queue_high=4, autoscale_queue_low=0,
                                      autoscale_window_s=1.0)
    fe = m["front"].GangFrontend("", settings, lease_store=store, app_id="serve-pools",
                                 grow_asks={"decode": GangAsk(R(2048, 2, 4)),
                                            "prefill": GangAsk(R(4096, 4, 2))})
    try:
        fe.autoscale_tick({"decode": 2, "prefill": 9}, 100.0)
        tick = fe.autoscale_tick({"decode": 2, "prefill": 9}, 101.5)
        leases = store.summary()["apps"]["serve-pools"]["leases"]
        grown = [(x["memory_mb"], x["tpu_chips"]) for x in leases if x["memory_mb"] != 1024]
        shrunk = (bool(store.shrink_gang("serve-pools", "serve-autoscale-prefill")),
                  store.shrink_gang("serve-pools", "serve-autoscale"))
        return {"tick": tick, "actions": fe.autoscale_actions, "grown": grown,
                "shrunk": shrunk}
    finally:
        fe.close(wait_s=0.0)
        store.release_app("serve-pools")


def test_frontend_autoscale_per_pool_grows_the_right_ask(tmp_path):
    got = {pkg: _autoscale_pools(pkg, tmp_path) for pkg in ("ref", "port")}
    assert got["ref"] == got["port"]
    port = got["port"]
    assert port["tick"] == "grow" and [a for a, _ in port["actions"]] == ["grow"]
    assert "pool=prefill" in port["actions"][0][1] and "leased h1" in port["actions"][0][1]
    assert port["grown"] == [(4096, 2)] and port["shrunk"] == (True, None)


def _app_with_ledger(tmp_path, name, ledger) -> str:
    app = tmp_path / name
    (app / "serve").mkdir(parents=True)
    (app / "events").mkdir()
    (app / "status.json").write_text(json.dumps({"state": "SUCCEEDED", "exit_code": 0,
                                                 "tasks": []}))
    (app / "events" / f"{name}.jhist.jsonl").write_text(
        json.dumps({"type": "APPLICATION_FINISHED", "ts": 0, "state": "SUCCEEDED"}) + "\n")
    (app / "serve" / "requests_frontend.json").write_text(json.dumps(ledger))
    return str(app)


def _prefill_kill_mid_handoff(pkg: str, tmp_path) -> dict:
    """The reference's ``test_pooled_frontend_prefill_kill_mid_handoff`` in
    ``pkg``: a clean handoff, then the prefill host killed inside a chaos
    delay at the ``serve.handoff`` seam; the request completes by
    re-prefilling on the decode host, and both packages' invariant
    checkers hold over the ledger alike."""
    m = PKGS[pkg]
    settings = m["gang"].GangSettings(model="tiny", slots=2, max_len=128, max_queue=8,
                                      prefill_hosts=1, handoff_min_tokens=64)
    hp = start_host(pkg, settings, "prefill:0", pool="prefill")
    hd = start_host(pkg, settings, "decode:0", pool="decode")
    fe = m["front"].GangFrontend("", settings)
    fe.add_host("decode:0", f"127.0.0.1:{hd[2]}", pool="decode")
    fe.add_host("prefill:0", f"127.0.0.1:{hp[2]}", pool="prefill")
    trigger = tmp_path / f"kill-now-{pkg}"
    out = {}
    try:
        c1 = fe.result(fe.submit(_prompt(80, seed=31), 4), timeout_s=120)
        out["c1"] = (c1.finish_reason, c1.hosts, c1.tokens)
        with fe._lock:
            h1 = dict(fe._handoffs[-1])
        out["h1"] = (h1["ok"], h1["shipped"], h1["adopted"], h1["freed"], h1["bytes"])
        pools = []
        for port in (hp[2], hd[2]):
            with m["rpc"].ServeRpcClient(f"127.0.0.1:{port}") as cli:
                pools.append(cli.decode_stats().pool)
        out["pools"] = pools
        cfg = m["conf"].TonyConfig({"chaos.enabled": True, "chaos.faults": json.dumps([{
            "type": "delay_point", "point": "serve.handoff", "on_file": str(trigger),
            "delay_ms": 2500}])})
        assert m["chaos"].install_from_config(cfg, role="serve") is True
        trigger.write_text("")
        rid = fe.submit(_prompt(80, seed=32), 4)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            inj = m["chaos"].active_injector()
            if inj is not None and inj.fired:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the serve.handoff fault never fired")
        hp[1].stop(None)
        c2 = fe.result(rid, timeout_s=120)
        out["c2"] = (c2.finish_reason, c2.hosts, c2.tokens)
        with fe._lock:
            h2 = dict(fe._handoffs[-1])
        out["h2"] = (h2["ok"], "prefill host lost" in h2["message"])
        ledger = fe.close()
        out["ledger"] = (ledger["pending"], len(ledger["handoffs"]))
        report = check_both([_app_with_ledger(tmp_path, f"pooled-{pkg}", ledger)])
        assert report.ok, report.to_json()
    finally:
        m["chaos"].uninstall()
        fe._closed.set()
        hp[0].shutdown()
        stop_host(hd)
    return out


def test_pooled_frontend_prefill_kill_mid_handoff(tmp_path):
    got = {pkg: _prefill_kill_mid_handoff(pkg, tmp_path) for pkg in ("ref", "port")}
    assert got["ref"] == got["port"]
    port = got["port"]
    assert port["c1"][:2] == ("length", ["decode:0"]) and len(port["c1"][2]) == 4
    ok, shipped, adopted, freed, nbytes = port["h1"]
    assert ok and shipped == adopted + freed > 0 and nbytes > 0
    assert port["pools"] == ["prefill", "decode"]
    assert port["c2"][:2] == ("length", ["decode:0"]) and len(port["c2"][2]) == 4
    assert port["h2"] == (False, True) and port["ledger"] == ([], 2)


def test_a_host_serves_while_its_engine_builds_and_reports_kernel_counts(capsys):
    """The worker's port-only line: each drain logs every kernel wrapper's
    launches beside the decode steps (here the plain decode attention, once
    per layer and step, on the CPU)."""
    settings = pgang.GangSettings(model="tiny", slots=2, max_len=64)
    counts = pgang._KernelCounts("decode:7")
    drained = threading.Event()

    def on_idle(eng):
        counts.log_line("idle")
        drained.set()

    from tony_tpu_torch.ops.decode_attention import reset_launches

    reset_launches()
    svc = pgang.DecodeHostService(
        lambda: counts.track(pgang.build_gang_engine(settings, device="cpu")), "decode:7",
        on_idle=on_idle)
    server, port = prpc.serve_rpc(svc, host="127.0.0.1")
    svc.start()
    try:
        toks, reason, _ = _stream(prpc, port, "r1", _prompt(6), 9)
        assert drained.wait(30)
    finally:
        svc.shutdown()
        server.stop(0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (reason, len(toks), line["host"], line["at"]) == ("length", 9, "decode:7", "idle")
    assert line["decode_steps"] == 8
    assert line["launches"]["paged_decode_attention_plain"] == 8 * 2
    assert line["launches"]["paged_decode_attention"] == 0


def test_cli_serve_demo_exits_zero(tmp_path):
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "serve", "--demo", "4",
            "--max-new-tokens", "8",
            "-D", f"application.stage_dir={tmp_path}", "-D", "serve.gang.slots=2",
            "-D", "task.heartbeat_interval_ms=200",
            "-D", f"job.decode.command={sys.executable} -m tony_tpu_torch.serve.gang --device cpu"]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=180,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "gang of 2 x decode (model=tiny)" in lines[0]
    assert "2 decode host(s) serving" in lines[1]
    done = [x for x in lines if x.startswith("  r")]
    assert len(done) == 4 and all("8 tokens (length" in x for x in done)


def test_ship_blocks_past_grpc_default_message_size():
    """F5: one Llama-3-8B KV block is 4 MiB in int8, more than gRPC's
    default receive limit. A real handoff of about 5 MiB between two port
    hosts goes through (the port's ServeRpc server takes messages up to
    2 GiB); the reference's host refuses the same size on the wire."""
    cfg = pllama.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=8, n_kv_heads=8,
                             ffn_dim=512, max_seq_len=2048, dtype=torch.float32,
                             remat=False)
    params = params_from_numpy(jax.tree.map(np.asarray, jl.init_params(
        jax.random.key(1), jl.LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=8,
                                          n_kv_heads=8, ffn_dim=512, max_seq_len=2048,
                                          dtype=jax.numpy.float32, remat=False))),
        cfg, device="cpu")

    def host(name, pool):
        svc = pgang.DecodeHostService(lambda: pengine.Engine(
            params, cfg, pengine.ServeConfig(slots=1, max_len=2048, pool=pool),
            device="cpu"), name, pool=pool)
        server, port = prpc.serve_rpc(svc, host="127.0.0.1")
        svc.start()
        return svc, server, port

    prefill, decode = host("prefill:0", "prefill"), host("decode:0", "decode")
    ref = start_host("ref", rgang.GangSettings(model="tiny", slots=1, max_len=32), "decode:r")
    try:
        prompt = [int(t) for t in _prompt(1300, seed=5)]
        with prpc.ServeRpcClient(f"127.0.0.1:{prefill[2]}") as cli:
            resp = cli.prefill("r1", prompt, f"127.0.0.1:{decode[2]}", timeout_s=60)
        assert resp.ok, resp.message
        assert resp.shipped == resp.adopted == 20 and resp.bytes > 4 * 2**20
        big = prpc.pb.ShipBlocksRequest(rid="r2", src_host="x", tokens=prompt[:1280],
                                        k=bytes(resp.bytes), v=b"", shape=[1], dtype="float32")
        with rrpc.ServeRpcClient(f"127.0.0.1:{ref[2]}") as cli:
            with pytest.raises(grpc.RpcError) as e:
                cli.ship_blocks(big, timeout_s=30)
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    finally:
        for h in (prefill, decode, ref):
            stop_host(h)
