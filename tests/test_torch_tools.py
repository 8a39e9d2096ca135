"""The port's operator tools against the reference's, on the same app dirs:
``obs/trace_tool.py`` (``merge_chrome``, ``report``, ``stragglers``),
``obs/top.py`` (``build_view``, ``run_top(once=True)``), ``obs/portal.py``
(every route), ``obs/proxy.py`` with ``cli/notebook.py`` (the reference's
notebook round trip through each package), and the CLI's ``trace``,
``health``, ``elastic``, ``top``, ``profile``, ``perf diff`` and
``rm-status`` (exit codes and output of both ``main``s).

Two app dirs are read: one the port wrote (the port's example job, two
CPU workers on gloo at the tiny preset, 12 steps, worker 0 killed after
its first checkpoint landed at step 4 and the gang resumed from the
latest, every step traced) and one the reference wrote (a generic job
whose worker 0 is killed at its second heartbeat). Clocks and ages are
masked where a tool reads the wall clock."""

import json
import os
import re
import shutil
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tony_tpu.cli import main as ref_cli
from tony_tpu.cli.client import TonyClient as RefClient
from tony_tpu.config.config import TonyConfig as RefConfig
from tony_tpu.obs import portal as ref_portal
from tony_tpu.obs import top as ref_top
from tony_tpu.obs import trace_tool as ref_trace
from tony_tpu_torch.cli import main as port_cli
from tony_tpu_torch.cli.client import TonyClient
from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.obs import portal, top, trace_tool

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "llama_pretrain_torch"
FAST = {"task.heartbeat_interval_ms": 200, "task.max_missed_heartbeats": 10,
        "application.timeout_s": 120}
CLIS = {"ref": ref_cli.main, "port": port_cli.main}


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """{"port": app dir, "ref": app dir, "rm": the port job's lease store}."""
    root = tmp_path_factory.mktemp("apps")
    ckpt, rm = root / "ckpt", root / "rm"
    cfg = TonyConfig.load(str(EXAMPLE / "tony.toml"), overrides={
        **FAST, "application.stage_dir": str(root / "stage"), "job.worker.instances": 2,
        # the job tests' size and time limit (tests/test_torch_jobs_fit.py): two
        # ranks training on a CPU shared with the rest of the suite, one
        # thread each
        "application.timeout_s": 240, "job.worker.env": "OMP_NUM_THREADS=1",
        "job.worker.command": "python train.py --preset tiny --device cpu --backend gloo "
                              "--steps 12 --global-batch 8 --seq-len 32",
        "checkpoint.dir": str(ckpt), "checkpoint.interval_steps": 4,
        "trace.sample_steps": 1, "cluster.rm_root": str(rm), "chaos.enabled": True,
        "chaos.faults": json.dumps([{"type": "kill_container", "task": "worker:0",
                                     "on_file": str(ckpt / "4")}])})
    out: dict = {}

    def port():
        c = TonyClient(cfg, src_dir=str(EXAMPLE))
        out["port"] = (c.run(quiet=True), c.app_dir)

    def ref():
        c = RefClient(RefConfig.load(overrides={
            **FAST, "application.stage_dir": str(root / "stage"),
            "application.framework": "generic", "restart.policy": "gang",
            "restart.max_worker_restarts": 2, "job.worker.instances": 2,
            "job.worker.command": 'python -c "import time; time.sleep(2)"',
            "chaos.enabled": True, "chaos.faults": json.dumps([
                {"type": "kill_container", "task": "worker:0", "at_count": 2}])}))
        out["ref"] = (c.run(quiet=True), c.app_dir)

    threads = [threading.Thread(target=f) for f in (port, ref)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert out["port"][0] == 0 and out["ref"][0] == 0, out
    return {"port": out["port"][1], "ref": out["ref"][1], "rm": str(rm),
            "root": str(root / "stage")}


WHICH = ["port", "ref"]


def _mask(obj):
    """Ages, timestamps and clocks read from the wall clock, masked."""
    text = json.dumps(obj, sort_keys=True) if not isinstance(obj, str) else obj
    text = re.sub(r'("(?:age_s|rollup_age_s|ts|now|generated_at|freshness_s)": )[-0-9.e]+',
                  r"\1T", text)
    text = re.sub(r"\b\d\d:\d\d:\d\d\b", "HH:MM:SS", text)
    text = re.sub(r"\b\d+(\.\d+)?s\b", "Ns", text)
    text = re.sub(r"(tony_snapshot_age_seconds\{[^}]*\}) [-0-9.e+]+", r"\1 T", text)
    text = re.sub(r'(age|ago)[^<"]*?(\d+(\.\d+)?)', r"\1 T", text)
    return text


@pytest.mark.parametrize("which", WHICH)
def test_trace_merge_report_and_stragglers_match_reference(apps, which):
    app = apps[which]
    procs = trace_tool.load_journals(os.path.join(app, "trace"))
    assert procs == ref_trace.load_journals(os.path.join(app, "trace"))
    merged = trace_tool.merge_chrome(app, procs)
    assert merged == ref_trace.merge_chrome(app, procs)
    assert trace_tool.report(app, procs) == ref_trace.report(app, procs)
    assert trace_tool.stragglers(app) == ref_trace.stragglers(app)
    names = {(e.get("ph"), e.get("name")) for e in merged["traceEvents"]}
    # the killed attempt's executor left a span open: the user process's
    # where it died training (the port's job), the one it was in when its
    # second heartbeat fired (the reference's)
    assert any(ph == "B" for ph, _ in names), names
    if which == "port":
        assert {("B", "executor.user_process"), ("X", "train.fit"),
                ("X", "train.step")} <= names
        assert trace_tool.report(app, procs)["goodput"]["restarts"] == 1


@pytest.mark.parametrize("which", WHICH)
def test_top_view_and_frame_match_reference(apps, which, capsys):
    app = apps[which]
    assert _mask(top.build_view(app)) == _mask(ref_top.build_view(app))
    frames = []
    for run in (top.run_top, ref_top.run_top):
        assert run(app, once=True) == 0
        frames.append(_mask(capsys.readouterr().out))
    assert frames[0] == frames[1]
    if which == "port":
        # one row a worker's resumed process (a killed one that got past
        # the series stride before its kill may add its own)
        rows = {ln.split()[0] for ln in frames[0].splitlines() if ln.startswith("worker_")}
        assert {r for r in rows if r.endswith("_a1")} == {"worker_0_user_a1",
                                                           "worker_1_user_a1"}, frames[0]


def _get(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_portal_routes_match_reference(apps):
    servers = [mod.serve_portal(apps["root"]) for mod in (portal, ref_portal)]
    for server, _ in servers:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    port_id, ref_id = (os.path.basename(apps[w]) for w in WHICH)
    paths = ["/", "/api/jobs", "/api/serve", "/api/series", "/healthz", "/nope",
             "/job/missing", "/job/..%2f..", "/api/job/missing"]
    for app_id in (port_id, ref_id):
        paths += [f"/job/{app_id}", f"/api/job/{app_id}", f"/api/series/{app_id}",
                  f"/api/serve/{app_id}", f"/healthz/{app_id}",
                  f"/job/{app_id}/log/worker_0_attempt1.log",
                  f"/job/{app_id}/log/missing.log"]
    paths.append("/metrics")
    try:
        for path in paths:
            ours, theirs = (_get(bound, path) for _, bound in servers)
            assert ours[0] == theirs[0], path
            assert _mask(ours[1]) == _mask(theirs[1]), path
        assert _get(servers[0][1], "/")[0] == 200
        assert _get(servers[0][1], f"/job/{port_id}")[0] == 200
    finally:
        for server, _ in servers:
            server.shutdown()
            server.server_close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_notebook_submitter_proxied_roundtrip(tmp_path, pkg):
    """tests/test_e2e.py's notebook round trip through each package: a
    single-container notebook job announces its URL through the AM, the
    client proxies to it, and a GET through the proxy reaches it."""
    m = "tony_tpu" if pkg == "ref" else "tony_tpu_torch"
    nb = __import__(f"{m}.cli.notebook", fromlist=["launch_notebook"])
    rpc = __import__(f"{m}.rpc", fromlist=["ApplicationRpcClient"])
    conf = RefConfig if pkg == "ref" else TonyConfig
    base = conf.load(overrides={**FAST, "application.stage_dir": str(tmp_path),
                                "application.name": "nb"})
    config = nb.notebook_config(base, memory_mb=256)
    assert config.task_specs().keys() == {"notebook"}
    assert config.get_str("job.notebook.command") == f"python -m {m}.cli.notebook"
    client, proxy, url = nb.launch_notebook(config, timeout_s=60)
    try:
        body, status = "", 0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{proxy.port}/",
                                            timeout=10) as r:
                    body, status = r.read().decode(), r.status
                break
            except OSError:
                time.sleep(0.5)
        assert status == 200
        assert "tony-tpu notebook" in body or "jupyter" in body.lower()
    finally:
        addr = open(os.path.join(client.app_dir, "am.addr")).read().strip()
        with rpc.ApplicationRpcClient(addr) as c:
            c.stop_application("test done")
        code = client.monitor(quiet=True)
        proxy.stop()
    assert code == 143
    with open(os.path.join(client.app_dir, "status.json")) as f:
        assert json.load(f)["state"] == "KILLED"


# --- the CLI's read-side commands through both mains -----------------------------------


def _run(pkg: str, argv: list[str], capsys) -> tuple[int, str, str]:
    rc = CLIS[pkg](argv)
    got = capsys.readouterr()
    return rc, got.out, got.err


def _both(argv, capsys, mask=None) -> tuple[int, str]:
    (rc, out, err), (rc2, out2, err2) = (_run(p, argv, capsys) for p in ("ref", "port"))
    mask = mask or (lambda s: s)
    assert (rc, mask(out)) == (rc2, mask(out2)), (argv, out, out2)
    assert mask(err) == mask(err2), (argv, err, err2)
    return rc, out


@pytest.mark.parametrize("which", WHICH)
def test_cli_trace_matches_reference(apps, which, capsys, tmp_path):
    app = apps[which]
    outs = []
    for pkg in ("ref", "port"):
        rc, out, _ = _run(pkg, ["trace", app, "--out", str(tmp_path / f"{pkg}.json")],
                          capsys)
        assert rc == 0
        outs.append({k: v for k, v in json.loads(out).items() if k != "out"})
    assert outs[0] == outs[1] and outs[1]["events"] > 0
    assert json.loads((tmp_path / "ref.json").read_text()) == \
        json.loads((tmp_path / "port.json").read_text())
    empty = tmp_path / "empty-app"
    empty.mkdir()
    assert _both(["trace", str(empty)], capsys)[0] == 1


def test_cli_health_matches_reference(apps, capsys, tmp_path):
    rc, out = _both(["health", apps["port"]], capsys)
    assert rc == 0 and json.loads(out)["verdict"] == "healthy"
    assert _both(["health", apps["ref"]], capsys)[0] == 2
    tripped = tmp_path / "tripped"
    shutil.copytree(apps["port"], tripped)
    (tripped / "health" / "verdict_worker_9.json").write_text(json.dumps(
        {"verdict": "tripped", "proc": "worker_9", "rules": {"nonfinite": {"trips": 2}}}))
    (tripped / "health" / "forensics_worker_9_s3.json").write_text('{"rule": "nonfinite"}')
    assert _both(["health", str(tripped), "--bundles"], capsys)[0] == 1


def test_cli_elastic_matches_reference(apps, capsys, tmp_path):
    from tony_tpu_torch.elastic.protocol import GenerationRecord, write_generation

    assert _both(["elastic", apps["port"]], capsys)[0] == 2
    app = tmp_path / "elastic-app"
    app.mkdir()
    write_generation(str(app), GenerationRecord(0, (0, 1), ts=1.0))
    write_generation(str(app), GenerationRecord(1, (0,), boundary="shrink", dead=(1,),
                                                reason="member 1 lost", ts=2.0))
    (app / "elastic" / "journal_m0.jsonl").write_text("".join(json.dumps(r) + "\n" for r in (
        {"type": "meta", "member": 0}, {"type": "step", "step": 0, "members": [0, 1]},
        {"type": "reshard", "at_step": 1, "members": [0], "skipped": {"1": [1, -1]}},
        {"type": "step", "step": 1, "members": [0]})))
    rc, out = _both(["elastic", str(app)], capsys)
    assert rc == 0 and json.loads(out)["current"]["generation"] == 1


def test_cli_profile_matches_reference(apps, capsys, tmp_path):
    # no capture in either app: a report exits 2; no AM to broadcast to: 1
    for which in WHICH:
        assert _both(["profile", "report", apps[which]], capsys)[0] == 2
    stopped = tmp_path / "stopped"
    stopped.mkdir()
    assert _both(["profile", str(stopped), "--steps", "2"], capsys)[0] == 1
    assert _both(["profile", "report"], capsys)[0] == 2


def test_cli_perf_diff_matches_reference(capsys):
    fx = ROOT / "tests" / "fixtures" / "perf"
    base, bad = str(fx / "bench_base.json"), str(fx / "bench_regressed.json")
    assert _both(["perf", "diff", base, base], capsys)[0] == 0
    assert _both(["perf", "diff", base, bad, "--full"], capsys)[0] == 1
    assert _both(["perf", "diff", base, bad, "--tol-scale", "100"], capsys)[0] in (0, 1)
    assert _both(["perf", "diff", base, str(fx / "missing.json")], capsys)[0] == 2


def test_cli_rm_status_matches_reference(apps, capsys, tmp_path):
    rc, out = _both(["rm-status", "--rm-root", apps["rm"]], capsys)
    assert rc == 0 and json.loads(out)["apps"] == {}
    assert _both(["rm-status"], capsys)[0] == 2
    assert _both(["rm-status", "--rm-root", str(tmp_path / "typo")], capsys)[0] == 2
    copy = tmp_path / "rm"
    shutil.copytree(apps["rm"], copy)
    assert _both(["rm-status", "--rm-root", str(copy), "--release", "gone-app"], capsys)[0] == 0


def test_cli_top_once_matches_reference(apps, capsys):
    _both(["top", apps["port"], "--once"], capsys, mask=_mask)


def test_cli_has_every_reference_command_but_two():
    """The port's parser names every subcommand of the reference's but
    ``compiles`` (the XLA compile ledger) and ``lint`` (graft-lint)."""
    def names(mod):
        p = mod.build_parser()
        return set(p._subparsers._group_actions[0].choices)

    assert names(ref_cli) - names(port_cli) == {"compiles", "lint"}
    assert names(port_cli) <= names(ref_cli)
    assert "compiles" in port_cli.__doc__ and "lint" in port_cli.__doc__
