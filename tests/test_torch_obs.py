"""The port's observability spine (tony_tpu_torch/obs: registry, trace,
series, slo, hbm, profile, profiler, diagnostics) against the JAX
package's, and its wiring into ``fit()`` and the serve ``Engine``.

The stdlib engines (registry rendering, the tracer, the series recorder,
the SLO engine) are fed the same host sequences in both packages and held
equal once ids and clocks are masked. ``fit()`` and the engine run armed
in both packages on the tiny float32 config: the same span names and
nesting (less the reference's compile spans), the same registry counters
and per-request span sequences."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from tony_tpu.obs import health as jhealth
from tony_tpu.obs import registry as jregistry
from tony_tpu.obs import series as jseries
from tony_tpu.obs import slo as jslo
from tony_tpu.obs import trace as jtrace
from tony_tpu_torch.obs import (
    diagnostics, hbm, health, profile, registry, series, slo, trace,
)

# the reference's compile-ahead spans: PyTorch runs eagerly, with nothing
# to compile
COMPILE_SPANS = ("fit.startup.compile",)


@pytest.fixture(autouse=True)
def _disarm():
    """Every test starts and ends with both packages' process globals
    disarmed (fit() and the engine arm them from the env)."""
    mods = (trace, health, series, slo, hbm, profile,
            jtrace, jhealth, jseries, jslo)
    for m in mods:
        m.uninstall()
    yield
    for m in mods:
        m.uninstall()


# --- registry ---------------------------------------------------------------------


def _fill(mod):
    reg = mod.Registry()
    reg.counter("tony_requests_total", "requests", route="a").inc(3)
    reg.counter("tony_requests_total", "requests", route="b").inc()
    reg.gauge("tony_queue_depth", "queue").set(7)
    h = reg.histogram("tony_step_time_seconds", "step")
    win = mod.HistogramWindow()
    for v in (0.001, 0.02, 0.02, 0.3, 1.7, 45.0):
        h.observe(v)
    first = win.delta(h)
    for v in (0.5, 0.5):
        h.observe(v)
    return reg, first, win.delta(h), [h.quantile(q) for q in (0.5, 0.9, 0.99)]


def test_registry_renders_like_reference(tmp_path):
    """The same metrics in both registries: equal snapshots, Prometheus
    text, quantiles, window deltas, and the multi-snapshot rendering with
    app/proc labels."""
    got, want = _fill(registry), _fill(jregistry)
    assert got[0].render() == want[0].render()
    assert got[0].snapshot() == want[0].snapshot()
    assert got[1:] == want[1:]
    labels = [{"app": "app-1", "proc": "w_0"}, {"app": "app-2", "proc": "w_1"}]
    assert registry.render_snapshots([(lb, got[0].snapshot()) for lb in labels]) == \
        jregistry.render_snapshots([(lb, want[0].snapshot()) for lb in labels])
    for mod, reg, name in ((registry, got[0], "port"), (jregistry, want[0], "ref")):
        mod.write_snapshot(str(tmp_path / f"{name}.json"), reg, proc="w_0")
    with open(tmp_path / "port.json") as f, open(tmp_path / "ref.json") as g:
        assert json.load(f) == json.load(g)


# --- tracer -----------------------------------------------------------------------


def _record(mod, path):
    tr = mod.install(mod.Tracer(str(path), "worker_0", "tid0", sample_steps=2))
    with mod.span("root", steps=3):
        for step in range(4):
            with tr.sampled_span("train.step", step=step):
                mod.instant("tick", step=step)
        sp = tr.span("open", rid=1)
        tr.counter("hbm.dev0", live_gb=1.5)
        sp.end(tokens=4)
    mod.flush()
    mod.uninstall()
    return [json.loads(line) for line in open(path) if line.strip()]


def _tree(recs):
    """(kind, name, parent name, args) per record, ids and clocks masked."""
    by_id = {r["sid"]: r["name"] for r in recs if "sid" in r}
    out = []
    for r in recs:
        if r.get("ph") == "M":
            continue
        out.append((r.get("ph"), r.get("name"), by_id.get(r.get("psid")),
                    json.dumps(r.get("args"), sort_keys=True)))
    return sorted(out, key=str)


def test_tracer_journal_like_reference(tmp_path):
    """The same span program through both tracers: equal records (phase,
    name, parent, args), once span ids, timestamps and pids are masked."""
    got = _record(trace, tmp_path / "port.jsonl")
    want = _record(jtrace, tmp_path / "ref.jsonl")
    assert _tree(got) == _tree(want)
    assert [r["name"] for r in got if r.get("name") == "train.step"] == ["train.step"] * 2


# --- series and SLO ---------------------------------------------------------------


def _points():
    out = []
    for i in range(12):
        out.append({"ts": 1000.0 + 10 * i, "step": float(i + 1),
                    "ttft_p99_s": 0.1 if i < 5 else 2.5,
                    "goodput_frac": 0.95, "error_rate": 0.0})
    return out


def _run_slo(mod, app_dir):
    cfg = mod.SloConfig(ttft_p99_s=1.0, goodput_floor=0.9, budget_frac=0.1,
                        fast_window_s=60.0, slow_window_s=600.0, min_points=3)
    eng = mod.install(mod.SloEngine(cfg, app_dir=str(app_dir), proc="serve_0"))
    for p in _points():
        eng.observe(dict(p))
    eng.write_verdict()
    out = {"verdict": eng.verdict, "trips": eng.trip_counts(),
           "summary": eng.summary(), "rollup": mod.rollup(str(app_dir)),
           "files": mod.forensics_files(str(app_dir))}
    mod.uninstall()
    return out


def _mask(x):
    if isinstance(x, dict):
        return {k: _mask(v) for k, v in x.items()
                if k not in ("ts", "last_ts", "age_s", "t0_ts", "pid", "path")}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def test_slo_engine_like_reference(tmp_path):
    """The same series points through both SLO engines: equal verdicts,
    trips, summaries, roll-ups and forensics file names."""
    got = _run_slo(slo, tmp_path / "port")
    want = _run_slo(jslo, tmp_path / "ref")
    assert set(got["trips"]) == {"ttft_p99_s"}
    assert _mask(got) == _mask(want)


def _run_series(mod, app_dir):
    rec = mod.install(mod.SeriesRecorder(str(app_dir / "series" / "serve_0.jsonl"),
                                         "serve_0", sample_every=2))
    state = {"n": 0}

    def source():
        state["n"] += 1
        return {"queue_depth": float(state["n"] % 3), "step": float(state["n"])}

    rec.attach("engine", source)
    for _ in range(7):
        mod.sample()
    rec.force_sample(final=1)
    assert rec.drain(timeout_s=5.0)
    rec.detach("engine")
    mod.uninstall()
    got = mod.read_series(str(app_dir / "series"))
    return {"series": got, "rollup": mod.fleet_rollup(str(app_dir)),
            "fresh": sorted(mod.freshness(str(app_dir)))}


def test_series_recorder_like_reference(tmp_path):
    """Stride-sampled scrapes of the same source through both recorders:
    equal journals, roll-ups and freshness keys, clocks masked."""
    got = _run_series(series, tmp_path / "port")
    want = _run_series(jseries, tmp_path / "ref")
    assert len(got["series"]["serve_0"]) == 4
    assert _mask(got) == _mask(want)


# --- hbm, profile, diagnostics ----------------------------------------------------


def test_hbm_has_no_data_on_the_cpu_and_guards_only_oom(tmp_path, monkeypatch):
    """Without CUDA the watch reads nothing (the reference's CPU answer):
    no sample, no peak; ``oom_guard`` re-raises every error and dumps only
    for ``torch.cuda.OutOfMemoryError``."""
    monkeypatch.setenv("TONY_APP_DIR", str(tmp_path))
    assert hbm.default_stats_fn() == []
    watch = hbm.install(hbm.HbmWatch(sample_every=1))
    assert watch.force_sample() is None
    assert watch.peak_since(watch.mark()) == (0.0, False)
    with pytest.raises(ValueError):
        with hbm.oom_guard("fit"):
            raise ValueError("not an oom")
    assert hbm.forensics_files(str(tmp_path)) == []
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with hbm.oom_guard("fit"):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert hbm.forensics_files(str(tmp_path)) == ["proc_0_user_fit.json"]


def test_profile_window_writes_a_chrome_trace_and_manifest(tmp_path):
    """A two-step window through the controller: the capture is a Chrome
    trace holding the ``anatomy.step`` regions, beside a manifest with two
    step times, under ``profile/<proc>/<id>/``."""
    ctl = profile.install(profile.ProfileController(str(tmp_path / "profile"), "w_0"))
    req = ctl.trigger(steps=2)
    x = torch.ones(64, 64)
    for _ in range(4):
        profile.maybe_capture(fetch_s=0.001)
        x = x @ x / 64
    profile.finish_capture()
    man = profile.read_manifests(str(tmp_path))["w_0"]
    assert man["profile_id"] == req.id and man["steps"] == 2
    assert len(man["step_time_s"]) == 2
    with open(man["artifact"]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == profile.STEP_ANNOTATION for e in events) >= 2


def test_diagnostics_dumps_stacks_periodically(tmp_path, monkeypatch):
    """``TONY_TPU_DIAGNOSTICS`` arms a periodic dump of every thread's
    stack into the app dir; unset, the context is a no-op."""
    monkeypatch.setenv("TONY_APP_DIR", str(tmp_path))
    with diagnostics.diagnostics_context():
        pass
    assert not (tmp_path / "diagnostics").exists()
    monkeypatch.setenv(diagnostics.ENV_ENABLED, "1")
    monkeypatch.setenv(diagnostics.ENV_INTERVAL, "1")
    with diagnostics.diagnostics_context() as path:
        time.sleep(1.6)
    with open(path) as f:
        text = f.read()
    assert "Thread" in text and "test_diagnostics_dumps_stacks_periodically" in text


# --- fit() and the engine, armed in both packages ---------------------------------


def _fit_spans(tmp_path, name, resume: bool = False):
    """One armed 4-step ``fit()`` of the package ``name`` ("port" or "ref");
    with ``resume``, resumed from a step-2 checkpoint an unarmed run wrote."""
    from tony_tpu.models import llama as jl
    from tony_tpu.train import data as jdata
    from tony_tpu.train import loop as jloop
    from tony_tpu_torch.models import llama as pl
    from tony_tpu_torch.train import data as pdata
    from tony_tpu_torch.train import loop as ploop

    port = name == "port"
    loop, lm, dm, tr, hm = ((ploop, pl, pdata, trace, health) if port
                            else (jloop, jl, jdata, jtrace, jhealth))
    app = tmp_path / name

    def config(steps: int, **kw):
        return loop.FitConfig(
            model=lm.LlamaConfig.tiny(attention_impl="dot", remat=False),
            data=dm.DataConfig(global_batch=8, seq_len=16, vocab_size=256, prefetch=0),
            steps=steps, log_every=4, warmup_steps=1, **kw)

    ckpt = {}
    if resume:
        ckpt = {"checkpoint_dir": str(tmp_path / f"{name}-ckpt"), "checkpoint_every": 2}
        cfg = config(2, **ckpt)
        loop.fit(cfg, device="cpu") if port else loop.fit(cfg)
    env = {"TONY_APP_DIR": str(app), "TONY_TRACE_DIR": str(app / "trace"),
           "TONY_TRACE_PROC": "worker_0_user", "TONY_TRACE_SAMPLE": "1",
           "TONY_OBS_SERIES": "0", "TONY_OBS_HEALTH_SAMPLE": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = config(4, **ckpt)
        final = loop.fit(cfg, device="cpu") if port else loop.fit(cfg)
        tr.flush()
        tr.uninstall()
        hm.uninstall()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    recs = [json.loads(line) for line in open(app / "trace" / "worker_0_user.jsonl")
            if line.strip()]
    by_id = {r["sid"]: r["name"] for r in recs if "sid" in r}
    spans = [(r["name"], by_id.get(r.get("psid")), r["args"].get("step"))
             for r in recs if r.get("ph") == "X" and r["name"] not in COMPILE_SPANS]
    with open(app / "metrics" / "worker_0_user_fit.json") as f:
        snap = json.load(f)
    return final, sorted(spans, key=str), snap, health.read_verdicts(str(app))


def test_fit_armed_spans_and_verdict_like_reference(tmp_path):
    """Both packages' ``fit()`` with the tracer sampling every step and the
    sentinel armed: the same span names, parents and step numbers (less
    the reference's compile spans), the same verdict, and the registry
    snapshot's step-time histogram counting the steps after the first."""
    got, got_spans, got_snap, got_v = _fit_spans(tmp_path, "port")
    want, want_spans, want_snap, want_v = _fit_spans(tmp_path, "ref")
    assert got_spans == want_spans
    assert ("train.fit", None, None) in got_spans
    assert got["health_verdict"] == want["health_verdict"] == "healthy"
    assert got["loader"] == "synthetic"
    assert {p: v["verdict"] for p, v in got_v.items()} == \
        {p: v["verdict"] for p, v in want_v.items()}

    def count(snap):
        return [m["count"] for m in snap["metrics"]
                if m["name"] == "tony_step_time_seconds"]

    assert count(got_snap) == [3]


def test_fit_resumed_opens_the_restore_span_like_reference(tmp_path):
    """Both packages' armed ``fit()`` resumed from a checkpoint: the same
    span names and parents (less the compile spans), a
    ``fit.startup.restore`` span under ``train.fit`` among them, and a
    restore time above 0 in each package's ``tony trace`` goodput."""
    from tony_tpu.obs import trace_tool as jtrace_tool
    from tony_tpu_torch.obs import trace_tool

    got, got_spans, _, _ = _fit_spans(tmp_path, "port", resume=True)
    want, want_spans, _, _ = _fit_spans(tmp_path, "ref", resume=True)
    assert [s[:2] for s in got_spans] == [s[:2] for s in want_spans]
    assert ("fit.startup.restore", "train.fit", None) in got_spans
    assert got["startup"]["restore_s"] >= 0 and "restore_s" in want["startup"]
    for name, tool in (("port", trace_tool), ("ref", jtrace_tool)):
        app = str(tmp_path / name)
        assert tool.report(app, tool.load_journals(os.path.join(app, "trace"))
                           )["goodput"]["restore_s"] > 0


def _engine_run(tmp_path, port: bool):
    from tony_tpu.models import llama as jl
    from tony_tpu.serve import Engine as JEngine, Request as JRequest
    from tony_tpu.serve import ServeConfig as JServeConfig
    from tony_tpu_torch.models.convert import params_from_numpy
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.serve import Engine, Request, ServeConfig

    name = "port" if port else "ref"
    app = tmp_path / name
    tr_mod = trace if port else jtrace
    tr = tr_mod.install(tr_mod.Tracer(str(app / "trace.jsonl"), "serve_0", "t",
                                      sample_steps=1))
    serve = dict(slots=2, max_len=32, kv_block=8, prefill_buckets=(4, 8, 16, 32))
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 17)
    prompts = [base, rng.integers(0, 256, 5), np.concatenate([base[:16], [7, 9]]),
               rng.integers(0, 256, 9)]
    budgets = [4, 6, 3, 5]
    if port:
        cfg = LlamaConfig.tiny()
        eng = Engine(params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                       device="cpu"), cfg, ServeConfig(**serve),
                     device="cpu")
        req = Request
    else:
        eng = JEngine(jparams, jcfg, JServeConfig(decode_impl="pallas", **serve))
        req = JRequest
    ids = [eng.submit(req(prompt=p, max_new_tokens=m)) for p, m in zip(prompts, budgets)]
    out = eng.run()
    summary = eng.close()
    snap = eng.registry.snapshot()
    tr_mod.flush()
    tr_mod.uninstall()
    recs = [json.loads(line) for line in open(app / "trace.jsonl") if line.strip()]
    per_req: dict = {}
    for r in sorted((r for r in recs if r.get("ph") == "X"), key=lambda r: r["ts"]):
        rid = r["args"].get("rid")
        if rid is not None:
            args = {k: v for k, v in r["args"].items() if k in
                    ("rid", "slot", "bucket", "matched", "tokens", "reason", "prompt_len")}
            per_req.setdefault(rid, []).append((r["name"], args))
    steps = sum(r.get("name") == "serve.step" for r in recs)
    return [out[i].tokens for i in ids], snap, per_req, steps, summary


def test_engine_registry_and_request_spans_like_reference(tmp_path):
    """An armed tiny engine on the same traffic (slot churn, a prefix hit)
    in both packages: equal greedy tokens, equal registry counters and
    gauges and histogram counts, the same per-request span sequence
    (serve.queued -> serve.prefill -> serve.decode with their slot,
    bucket, matched, token and reason args) and as many serve.step spans."""
    got = _engine_run(tmp_path, port=True)
    want = _engine_run(tmp_path, port=False)
    assert got[0] == want[0]

    def values(snap):
        out = {}
        for m in snap:
            key = (m["name"], json.dumps(m.get("labels", {}), sort_keys=True))
            out[key] = m["count"] if m["kind"] == "histogram" else m["value"]
        return out

    assert values(got[1]) == values(want[1])
    assert got[2] == want[2]
    assert got[3] == want[3] > 0
    assert got[4]["health_verdict"] == want[4]["health_verdict"]
