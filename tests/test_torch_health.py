"""The port's numerics health sentinel (tony_tpu_torch/obs/health.py)
against the JAX package's: the device-side monitors on the same inputs,
the rule engine fed the same host sequences, the monitors wired into
``make_train_step`` (one rank, and over gloo meshes against the
reference's CPU mesh), the NaN chaos seam through ``fit()`` and the serve
engine's decode monitors.

Inputs come from numpy seeds, float32 on both sides. Counts are held
exact and the batch fingerprint bit-equal; the other monitors within rtol
1e-5 where both sides see the same tensors. Each test states its
tolerance."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.obs import health as jhealth
from tony_tpu_torch.obs import health

EXACT = ("health/nonfinite_loss", "health/nonfinite_grads", "health/nonfinite_params",
         "health/batch_fingerprint")


@pytest.fixture(autouse=True)
def _disarm():
    """Each test starts and ends with neither package's sentinel armed."""
    health.uninstall()
    jhealth.uninstall()
    yield
    health.uninstall()
    jhealth.uninstall()


def _trees(seed: int, poison: bool = False):
    """(grads, params, updates) as nested dicts of numpy float32 arrays with
    a stacked ``layers`` block, and an int32 token batch."""
    rng = np.random.default_rng(seed)
    L, D, V = 3, 8, 32

    def tree(scale):
        return {"tok_emb": rng.normal(size=(V, D)).astype(np.float32) * scale,
                "layers": {"wq": rng.normal(size=(L, D, D)).astype(np.float32) * scale,
                           "attn_norm": rng.normal(size=(L, D)).astype(np.float32) * scale},
                "final_norm": rng.normal(size=(D,)).astype(np.float32) * scale}

    grads, params, updates = tree(0.1), tree(1.0), tree(1e-3)
    if poison:
        grads["layers"]["wq"][1, 2, 3] = np.nan
        grads["tok_emb"][0, 0] = np.inf
        params["final_norm"][5] = -np.inf
    tokens = rng.integers(0, 128256, size=(4, 33)).astype(np.int32)
    return grads, params, updates, tokens


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in t.items()}


def _jax_tree(t):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in t.items()}


def _assert_monitors(got: dict, want: dict, rtol: float, exact=EXACT) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, ref in want.items():
        a = np.asarray(got[key].detach().cpu() if isinstance(got[key], torch.Tensor)
                       else got[key])
        b = np.asarray(ref)
        if key in exact:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                          err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=key)


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("loss", [2.5, float("nan")])
def test_graph_monitors_match_reference(poison, loss):
    """Every ``health/...`` key on the same trees: counts exact, the
    fingerprint bit-equal, update ratio and per-layer grad RMS within rtol
    1e-5."""
    grads, params, updates, tokens = _trees(1, poison)
    want = jhealth.graph_monitors(jnp.float32(loss), _jax_tree(grads), _jax_tree(params),
                                  _jax_tree(updates), jnp.asarray(tokens))
    got = health.graph_monitors(torch.tensor(loss), _torch_tree(grads),
                                _torch_tree(params), _torch_tree(updates),
                                torch.from_numpy(tokens))
    _assert_monitors(got, jax.device_get(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (4, 33), (8, 2048), (3, 4097)])
def test_batch_fingerprint_bit_equal(shape):
    """The uint32 checksum that wraps, in int64 masked to 32 bits, bit-equal
    to the reference's over token ids up to Llama-3's vocabulary; partial
    sums over row and column blocks add up to the whole modulo 2**32."""
    rng = np.random.default_rng(sum(shape))
    tokens = rng.integers(0, 128256, size=shape).astype(np.int32)
    want = int(jax.device_get(jhealth.batch_fingerprint(jnp.asarray(tokens))))
    t = torch.from_numpy(tokens)
    assert int(health.batch_fingerprint(t)) == want
    pos = torch.arange(t.numel(), dtype=torch.int64).reshape(shape)
    r, c = shape[0] // 2, shape[1] // 2
    parts = [health.fingerprint_sum(t[a, b], pos[a, b])
             for a in (slice(None, r), slice(r, None))
             for b in (slice(None, c), slice(c, None)) if t[a, b].numel()]
    assert int(sum(int(p) for p in parts) & 0xFFFFFFFF) == want


@pytest.mark.parametrize("poison", [False, True])
def test_decode_monitors_match_reference(poison):
    """Per-slot logits nonfinite counts exact and entropy within rtol 1e-5,
    a degenerate (one-hot) row and NaN/Inf rows included."""
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(5, 64)) * 3).astype(np.float32)
    logits[1] = -1e9
    logits[1, 3] = 50.0
    if poison:
        logits[2, 4] = np.nan
        logits[3, :2] = np.inf
    want = jax.device_get(jhealth.decode_monitors(jnp.asarray(logits)))
    got = health.decode_monitors(torch.from_numpy(logits))
    np.testing.assert_array_equal(got["logits_nonfinite"].numpy(), want["logits_nonfinite"])
    np.testing.assert_allclose(got["entropy"].numpy(), want["entropy"], rtol=1e-5,
                               atol=1e-6)


# --- the rule engine --------------------------------------------------------------


def _train_samples():
    """A loss trajectory that settles, spikes, explodes its grad norm,
    feeds one batch three times, then goes NaN."""
    out = []
    for step in range(1, 31):
        loss = 3.0 - 0.01 * step + (0.002 * (step % 3))
        gnorm = 1.0 + 0.01 * step
        fp = float(1000 + step)
        if step == 20:
            loss = 9.0
        if step == 22:
            gnorm = 5e4
        if step in (24, 25, 26):
            fp = 777.0
        metrics = {"step": step, "loss": loss, "grad_norm": gnorm,
                   "health/nonfinite_loss": 0.0, "health/nonfinite_grads": 0.0,
                   "health/nonfinite_params": 0.0, "health/update_ratio": 1e-3,
                   "health/batch_fingerprint": fp,
                   "health/layer_grad_rms": [0.1 * step, 0.2, 0.3]}
        if step >= 28:
            metrics["loss"] = float("nan")
            metrics["health/nonfinite_loss"] = 1.0
            metrics["health/nonfinite_grads"] = 12.0
        out.append({"metrics": metrics})
    return out


def _serve_samples():
    out = []
    for step in range(12):
        ent = [2.0, 0.01, 1.5]
        nonfinite = [0.0, 0.0, 3.0 if step == 5 else 0.0]
        out.append({"metrics": {"logits_nonfinite": nonfinite, "entropy": ent},
                    "slot_rids": [10, 11, 12], "live_slots": [0, 1, 2]})
    return out


def _run_sentinel(mod, app_dir, samples, **kw):
    s = mod.install(mod.HealthSentinel(mod.HealthRules(window=16, min_samples=4),
                                       app_dir=str(app_dir), proc="worker_0_user",
                                       sample_every=1, **kw))
    for smp in samples:
        s.sample(**smp)
    assert s.drain(timeout_s=10.0)
    out = {"verdict": s.verdict, "trips": s.trip_counts(),
           "detail": s.summary()["detail"], "files": mod.forensics_files(str(app_dir)),
           "rollup": mod.rollup(str(app_dir))}
    bundles = {}
    for name in out["files"]:
        with open(os.path.join(app_dir, "health", name)) as f:
            b = json.load(f)
        b.pop("ts")
        bundles[name] = b
    out["bundles"] = bundles
    mod.uninstall()
    return out


def _mask(x):
    """Drop wall-clock stamps from verdict payloads."""
    if isinstance(x, dict):
        return {k: _mask(v) for k, v in x.items() if k != "ts"}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_sentinel_rules_match_reference(tmp_path, kind):
    """The same host sequence through both packages' sentinels: equal
    verdicts, trip counts, trip details, bundle names and contents (the
    rings, causes and stream positions) and roll-ups, once wall-clock
    stamps are masked."""
    samples = _train_samples() if kind == "train" else _serve_samples()
    got = _run_sentinel(health, tmp_path / "port", samples)
    want = _run_sentinel(jhealth, tmp_path / "ref", samples)
    assert got["trips"], "the sequence must trip rules"
    assert _mask(got) == _mask(want)


def test_staged_sample_is_read_off_the_step_thread(tmp_path):
    """``sample`` hands the worker fresh host copies: a metrics tensor
    changed in place after the call does not change what the rules see."""
    s = health.install(health.HealthSentinel(app_dir=str(tmp_path), proc="p",
                                             sample_every=1))
    loss = torch.tensor(float("nan"))
    s.sample(metrics={"step": 1, "loss": loss, "grad_norm": torch.tensor(1.0)})
    assert s.drain(timeout_s=10.0)
    assert s.trip_counts() == {"nonfinite": 1}


# --- the monitors in the train step ---------------------------------------------


def _adam(opt_state):
    """The reference's optax Adam state (its ``mu`` and ``nu`` trees)."""
    return next(n for n in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu"))
                if hasattr(n, "mu"))


def _reseed(state, jstate, cfg) -> None:
    """The reference's parameters and Adam moments copied into the port's
    ``state`` in place: both sides take the next step from one state."""
    from torch_ranks import copy_tree

    from tony_tpu_torch.models.convert import params_from_numpy

    adam = _adam(jstate.opt_state)
    for dst, src in ((state.params, jstate.params), (state.opt_state["mu"], adam.mu),
                     (state.opt_state["nu"], adam.nu)):
        copy_tree(dst, params_from_numpy(jax.tree.map(np.asarray, src), cfg, device="cpu"))


def _one_rank_runs(monitors=True, steps=3):
    """The reference's and the port's ``make_train_step`` with monitors on
    the same batches, the port's state reseeded from the reference's
    before each step: each step's metrics."""
    from tony_tpu.models import llama as jl
    from tony_tpu.parallel.mesh import MeshShape, build_mesh
    from tony_tpu.train import data as jdata
    from tony_tpu.train import trainer as jtrainer
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.train.data import DataConfig, synthetic_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    knobs = dict(attention_impl="dot", remat=False)
    data = dict(global_batch=2, seq_len=16, vocab_size=256)
    jcfg = jl.LlamaConfig.tiny(**knobs)
    mesh = build_mesh(MeshShape(), devices=jax.devices()[:1])
    jopt = jtrainer.default_optimizer(lr=5e-3, warmup_steps=1, decay_steps=5)
    jstate = jtrainer.make_train_state(jax.random.key(0), jcfg, mesh, jopt)
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt, monitors=monitors)
    cfg = LlamaConfig.tiny(**knobs)
    opt = default_optimizer(lr=5e-3, warmup_steps=1, decay_steps=5)
    state = make_train_state(cfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, opt, monitors=monitors)
    jb = jdata.synthetic_batches(jdata.DataConfig(**data))
    pb = synthetic_batches(DataConfig(**data))
    got, want = [], []
    for _ in range(steps):
        _reseed(state, jstate, cfg)
        jstate, jm = jstep(jstate, *next(jb))
        state, m = step(state, *next(pb))
        want.append({k: np.asarray(v) for k, v in jax.device_get(jm).items()
                     if k.startswith("health/")})
        got.append({k: v for k, v in m.items() if k.startswith("health/")})
    return got, want


def test_train_step_monitors_match_reference():
    """Three steps of ``make_train_step(monitors=True)`` on both sides, each
    from the same state (the port's reseeded from the reference's) and
    batch: counts exact, fingerprints bit-equal, the update ratio (0 on the
    first step: warm-up's lr is 0) and grad RMS within rtol 1e-5."""
    got, want = _one_rank_runs()
    for g, w in zip(got, want):
        _assert_monitors(g, w, rtol=1e-5)
    assert float(got[0]["health/update_ratio"]) == 0.0
    assert float(got[1]["health/update_ratio"]) > 0.0


def test_due_predicts_the_stride_hit(tmp_path, monkeypatch):
    """``due()`` before each ``sample`` says whether the sentinel reads that
    sample (one in ``sample_every``); disarmed it is False."""
    assert not health.due()
    s = health.install(health.HealthSentinel(app_dir=str(tmp_path), proc="p",
                                             sample_every=4))
    read = []
    monkeypatch.setattr(s, "observe_async", lambda args: read.append(args["metrics"]["step"]))
    dues = []
    for i in range(1, 13):
        dues.append(health.due())
        health.sample(metrics={"step": i})
    assert read == [i for i, d in enumerate(dues, start=1) if d] == [4, 8, 12]


def test_armed_step_builds_monitors_only_on_the_steps_the_sentinel_reads(tmp_path):
    """With a sentinel armed at stride 3, ``make_train_step(monitors=None)``
    adds the ``health/`` keys on steps 3 and 6 only, each equal to an
    always-on step's from the same state, and the other metrics are equal
    on every step."""
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg = LlamaConfig.tiny(dtype=torch.float32, remat=False, attention_impl="dot")
    opt = default_optimizer(lr=5e-3, warmup_steps=1, decay_steps=8)
    gen = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, cfg.vocab_size, (2, 16), generator=gen) for _ in range(6)]
    always = make_train_step(cfg, opt, monitors=True)
    ref_state = make_train_state(cfg, opt, seed=0, device="cpu")
    health.install(health.HealthSentinel(app_dir=str(tmp_path), proc="p", sample_every=3))
    gated = make_train_step(cfg, opt)
    state = make_train_state(cfg, opt, seed=0, device="cpu")
    for i, tokens in enumerate(batches, start=1):
        ref_state, want = always(ref_state, tokens, tokens)
        state, got = gated(state, tokens, tokens)
        health.sample(metrics=got)
        keys = {k for k in got if k.startswith("health/")}
        assert bool(keys) == (i % 3 == 0), i
        for k, v in got.items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]), err_msg=k)
            assert not getattr(v, "requires_grad", False), k


def test_armed_engine_builds_decode_monitors_only_on_the_steps_the_sentinel_reads(
        tmp_path, monkeypatch):
    """An engine armed at stride 2 builds the decode monitors on every
    second decode step only, and the sentinel counts every step."""
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.serve import Engine, Request, ServeConfig

    built = []
    real = health.decode_monitors
    monkeypatch.setattr(health, "decode_monitors",
                        lambda logits: built.append(1) or real(logits))
    s = health.install(health.HealthSentinel(app_dir=str(tmp_path), proc="p",
                                             sample_every=2))
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(params, cfg, ServeConfig(slots=2, max_len=32, kv_block=8), device="cpu")
    rng = np.random.default_rng(1)
    for n in (5, 9, 3):
        eng.submit(Request(prompt=rng.integers(0, 256, n), max_new_tokens=5))
    eng.run()
    steps = eng.metrics.decode_steps
    assert steps >= 4
    assert s._n == steps and len(built) == steps // 2
    assert eng.close()["health_verdict"] == "healthy"


def test_monitors_off_compute_nothing_and_none_follows_the_sentinel():
    """``monitors=False`` and ``None`` without a sentinel add no key; with
    a sentinel armed that reads every step ``None`` adds them."""
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg = LlamaConfig.tiny(dtype=torch.float32, remat=False)
    opt = default_optimizer()
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(0))
    for monitors, armed, want in ((False, True, False), (None, False, False),
                                  (None, True, True)):
        if armed:
            health.install(health.HealthSentinel(app_dir="", sample_every=1))
        state = make_train_state(cfg, opt, seed=0, device="cpu")
        _, m = make_train_step(cfg, opt, monitors=monitors)(state, tokens, tokens)
        assert any(k.startswith("health/") for k in m) == want
        health.uninstall()


def test_nan_seam_poisons_the_reported_loss_only(monkeypatch):
    """``TONY_CHAOS_NAN_STEP=2``: the reported loss is NaN from step 2 on
    and the grad norm stays finite, on both sides."""
    monkeypatch.setenv(health.ENV_NAN_STEP, "2")
    got, want = _one_rank_runs(steps=3)
    for i, (g, w) in enumerate(zip(got, want)):
        assert float(g["health/nonfinite_loss"]) == float(w["health/nonfinite_loss"]) \
            == (1.0 if i >= 1 else 0.0)


def _fit_trip(mod_fit, mod_health, cfg_mod, data_mod, tmp_path, name):
    """Both packages' fit() armed with a sentinel sampling every step."""
    app = tmp_path / name
    os.environ["TONY_APP_DIR"] = str(app)
    try:
        mod_health.install(mod_health.HealthSentinel(app_dir=str(app), proc="worker_0_user",
                                                     sample_every=1))
        kw = dict(model=cfg_mod.LlamaConfig.tiny(attention_impl="dot", remat=False),
                  data=data_mod.DataConfig(global_batch=8, seq_len=16, vocab_size=256,
                                           prefetch=0),
                  steps=5, log_every=5, warmup_steps=1)
        final = mod_fit.fit(mod_fit.FitConfig(**kw)) if name == "ref" else \
            mod_fit.fit(mod_fit.FitConfig(**kw), device="cpu")
        return final, mod_health.forensics_files(str(app))
    finally:
        os.environ.pop("TONY_APP_DIR", None)
        mod_health.uninstall()


def test_fit_nan_injection_trips_like_reference(tmp_path, monkeypatch):
    """``TONY_CHAOS_NAN_STEP=3`` through both packages' ``fit()``: both trip
    ``nonfinite`` at step 3, with the same bundle name and trip count."""
    from tony_tpu.models import llama as jl
    from tony_tpu.train import data as jdata
    from tony_tpu.train import loop as jloop
    from tony_tpu_torch.models import llama as pl
    from tony_tpu_torch.train import data as pdata
    from tony_tpu_torch.train import loop as ploop

    monkeypatch.setenv(health.ENV_NAN_STEP, "3")
    monkeypatch.setenv("TONY_OBS_SERIES", "0")
    got, got_files = _fit_trip(ploop, health, pl, pdata, tmp_path, "port")
    want, want_files = _fit_trip(jloop, jhealth, jl, jdata, tmp_path, "ref")
    assert got["health_verdict"] == want["health_verdict"] == "tripped"
    assert got["health_trips"] == want["health_trips"]
    assert got_files == want_files == ["worker_0_user_nonfinite_step3.trip.json"]


# --- over a mesh ------------------------------------------------------------------


# mesh, microbatches (pp only)
MESH_CASES = {"fsdp2": ({"fsdp": 2}, 0), "tp2": ({"tp": 2}, 0),
              "dp2_pp2": ({"dp": 2, "pp": 2}, 2)}


def test_mesh_monitors_match_reference(tmp_path):
    """Five steps with monitors at fsdp 2, tp 2 and dp 2 x pp 2 on gloo ranks
    against the reference's step on its CPU mesh of the same shape, each
    step from the reference's state before it (parameters and Adam
    moments, cut into each rank's blocks): counts exact, fingerprints
    bit-equal (the ranks' partial sums over the global positions of their
    rows), grad RMS and update ratio within rtol 1e-5; every rank reports
    the same global monitors."""
    from torch_mesh_parity import DATA, OPT, STEPS, flatten, reference_params
    from torch_ranks import spawn, tiny_config

    from tony_tpu.models import llama as jl
    from tony_tpu.parallel.mesh import MeshShape, build_mesh, set_default_mesh
    from tony_tpu.train import data as jdata
    from tony_tpu.train import trainer as jtrainer

    knobs = {"n_layers": 4}
    _, params = reference_params(tmp_path, **knobs)
    wants, reseeds = {}, {}
    for name, (mesh_d, microbatches) in MESH_CASES.items():
        shape = MeshShape(**mesh_d)
        mesh = build_mesh(shape, devices=jax.devices()[:shape.n_devices])
        set_default_mesh(mesh)
        cfg = tiny_config(jl.LlamaConfig, knobs)
        opt = jtrainer.default_optimizer(**OPT)
        rules = jtrainer.pp_rules() if shape.pp > 1 else jtrainer.DEFAULT_RULES
        state = jtrainer.make_train_state(jax.random.key(0), cfg, mesh, opt, rules)
        step = jtrainer.make_train_step(cfg, mesh, opt, monitors=True,
                                        **({"n_microbatches": microbatches}
                                           if microbatches else {}))
        batches = jdata.synthetic_batches(jdata.DataConfig(**DATA))
        wants[name], reseeds[name] = [], []
        for i in range(STEPS):
            adam = _adam(state.opt_state)
            files = {}
            for part, tree in (("params", state.params), ("mu", adam.mu), ("nu", adam.nu)):
                files[part] = str(tmp_path / f"{name}-{i}-{part}.npz")
                np.savez(files[part], **flatten(jax.device_get(tree)))
            reseeds[name].append(files)
            state, m = step(state, *next(batches))
            wants[name].append({k: np.asarray(v) for k, v in jax.device_get(m).items()
                                if k.startswith("health/")})
        set_default_mesh(None)
    runs = {}
    for world in (2, 4):
        names = [n for n, (m, _) in MESH_CASES.items()
                 if int(np.prod(list(m.values()))) == world]
        args = [{"mesh": MESH_CASES[n][0], "steps": STEPS, "data": DATA, "opt": OPT,
                 "params": params, "model": knobs, "monitors": True,
                 "microbatches": MESH_CASES[n][1], "reseed": reseeds[n]} for n in names]
        ranks = spawn(world, "train", {"runs": args}, tmp_path / f"w{world}")
        for j, n in enumerate(names):
            runs[n] = [r["runs"][j] for r in ranks]
    for name in MESH_CASES:
        ranks = runs[name]
        for i, want in enumerate(wants[name]):
            for r in ranks:
                _assert_monitors(r["monitors"][i], ranks[0]["monitors"][i], rtol=0)
            _assert_monitors(ranks[0]["monitors"][i], want, rtol=1e-5)
