"""The user-facing training loop: ``fit()``.

The counterpart of ``tony_tpu/train/loop.py``'s ``fit``, in the same
order: distributed bootstrap and mesh, optimizer, train state, checkpoint
resume, batch stream (prefetched to the device), ``StepTimer`` and the
step loop, then the final report (``final_loss``, ``steps``,
``tokens_per_sec_per_chip``, ``mfu``, ``step_time_p50_s``/``_p99_s``).
Every step ends in a host sync on its loss, so each step's wall time is
measured and the quantiles are exact; the first step (warm-up: kernel
builds, allocator, cuBLAS handles) is left out of the throughput and
step-time figures, as in the reference.

Meshes. ``fit()`` joins the default process group from the ``pytorch``
runtime's env contract, or uses one the caller brought up
(``parallel/dist.py``), builds the mesh of ``mesh_shape`` (None: fsdp over
every rank), sets it as the default mesh and trains over dp, pp, fsdp, ep,
tp and sp (``train/trainer.py``), each rank on its block of every global
batch (its rows, and under sp its block of the sequence). With pp above 1
it applies ``pp_rules`` to the state, the batches and the checkpoints, as
the reference does, and trains under ``pp_schedule`` ('gpipe' or '1f1b')
over ``pp_microbatches`` microbatches (0: two a stage), each rank's rows
laid out by microbatch (``train/data.py``). Rank 0 alone logs and calls
``on_metrics``; every rank returns the final report. A checkpoint of a
mesh of more than one rank is sharded: each rank writes and reads its own
blocks (``train/checkpoint.py``), and a step restores onto whatever mesh
this run has.

The model overrides ``ce_impl``, ``moe_dispatch``, ``moe_group_block``,
``overlap_impl``, ``moe_overlap_impl`` and ``moe_overlap_chunk`` apply to
``cfg.model`` as in the reference. Not ported yet, and raising when set
to a non-default: elastic training (``elastic_*``, ROADMAP queue 1, item
9).

Observability, as the reference arms it (``obs/``): ``fit()`` arms the
trace spine (``TONY_TRACE_DIR``), the memory watch, the health sentinel,
the series recorder with its SLO engine and the profile controller from
the env (each ``install_from_env``; the watch, the sentinel and the
series arm by default, ``TONY_OBS_HBM=0``, ``TONY_OBS_HEALTH=0``,
``TONY_OBS_SERIES=0`` disarm them), runs under ``diagnostics_context``,
a ``train.fit`` root span and ``oom_guard``, and in the loop: a sampled
``train.step`` span (the step's own sync inside it, so no extra one),
``profile.maybe_capture``, a per-run ``Registry`` whose
``tony_step_time_seconds`` observes every step after the first, and the
``hbm``/``health``/``series`` samples after the step's sync. At the end
the health and SLO verdicts and the registry snapshot are exported, and
the final report says which batch stream ran (``loader``: 'native',
'mmap' or 'synthetic'). Left out: the metrics push to a job's AM and
compile-ahead with its ``fit.startup.compile`` spans (PyTorch runs
eagerly, with nothing to compile).
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field, fields, replace
from typing import Callable

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, train_flops_per_token
from tony_tpu_torch.obs import hbm, health, profile, series, slo, trace
from tony_tpu_torch.obs.diagnostics import diagnostics_context
from tony_tpu_torch.obs.metrics import StepTimer, chip_peak_flops
from tony_tpu_torch.obs.profiler import annotate
from tony_tpu_torch.obs.registry import HistogramWindow, Registry, snapshot_to_app_dir
from tony_tpu_torch.parallel.dist import initialize
from tony_tpu_torch.parallel.mesh import (
    MESH_AXES, Mesh, MeshShape, build_mesh, get_default_mesh, set_default_mesh,
)
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules, mesh_rules
from tony_tpu_torch.train.data import DataConfig, loader_kind, make_batches
from tony_tpu_torch.train.prefetch import close_batches
from tony_tpu_torch.train.trainer import (
    PP_SCHEDULES, check_1f1b, check_model_mesh, default_optimizer, make_train_state,
    make_train_step, state_specs,
)

log = logging.getLogger(__name__)


@dataclass
class FitConfig:
    model: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    data: DataConfig = field(default_factory=DataConfig)
    mesh_shape: MeshShape | None = None   # None -> FSDP over every rank
    steps: int = 100
    log_every: int = 10
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    lr: float = 3e-4
    warmup_steps: int = 100
    rules: Rules = field(default_factory=lambda: dict(DEFAULT_RULES))
    pp_microbatches: int = 0
    pp_schedule: str = "gpipe"
    # called every log_every steps (and on the first and last) with a
    # metrics dict
    on_metrics: Callable[[dict], None] | None = None
    resume: bool = True  # restore from checkpoint_dir if a checkpoint exists
    # Adam first-moment dtype ('float32' | 'bfloat16')
    mu_dtype: str = "float32"
    # loss-head override: '' keeps model.ce_impl
    ce_impl: str = ""
    moe_dispatch: str = ""
    # '' keeps model.overlap_impl; 'scan'/'pallas' stream the fsdp weight
    # all-gathers chunk by chunk through the decomposed ring (ops/overlap.py)
    overlap_impl: str = ""
    # dp gradient-reduction bucket size in MiB (0: one all-reduce); needs
    # dp > 1 to be read
    grad_bucket_mb: float = 0.0
    moe_group_block: int = 0
    # '' keeps model.moe_overlap_impl; 'scan'/'pallas' split the ep combine
    # into token chunks that overlap the expert FFN (ops/moe_overlap.py),
    # 'off' keeps the single blocking combine
    moe_overlap_impl: str = ""
    # 0 keeps model.moe_overlap_chunk: tokens per combine chunk
    moe_overlap_chunk: int = 0
    elastic_members: int = 0
    elastic_plan: dict | None = None
    elastic_dir: str = ""
    elastic_shadow_steps: int = 0


# fields the port does not port yet: setting one to a non-default raises
_UNPORTED = ("elastic_members", "elastic_plan", "elastic_dir", "elastic_shadow_steps")
# FitConfig fields that override the model config's field of the same name
# when set (the reference's overrides, tony_tpu/train/loop.py:411-426)
_MODEL_OVERRIDES = ("ce_impl", "moe_dispatch", "moe_group_block", "overlap_impl",
                    "moe_overlap_impl", "moe_overlap_chunk")


def _check_ported(cfg: FitConfig) -> None:
    defaults = {f.name: f.default for f in fields(FitConfig)}
    for name in _UNPORTED:
        if getattr(cfg, name) != defaults[name]:
            raise NotImplementedError(
                f"FitConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                "(ROADMAP queue 1, item 9)"
            )
    if cfg.pp_schedule not in PP_SCHEDULES:
        raise ValueError(f"unknown pp_schedule {cfg.pp_schedule!r} (expected gpipe | 1f1b)")
    if cfg.mesh_shape is not None:
        shape = dict(zip(MESH_AXES, cfg.mesh_shape.sizes))
        check_model_mesh(cfg.model, shape)
        if shape["pp"] > 1 and cfg.pp_schedule == "1f1b":
            check_1f1b(cfg.model)


def fit(cfg: FitConfig, device: str | torch.device | None = None) -> dict:
    """Train ``cfg.model`` to ``cfg.steps`` on ``device`` (``None`` means
    CUDA, and raises without it; over a mesh, this rank's device); returns
    the final metrics."""
    device = resolve_device(device)
    _check_ported(cfg)
    # the observability spine, armed from the env (each idempotent); the
    # sentinel before the train step is built, so the steps it reads build
    # their monitors
    trace.install_from_env()
    hbm.install_from_env()
    health.install_from_env()
    series.install_from_env()
    profile.install_from_env()
    initialize(device)
    mesh = build_mesh(cfg.mesh_shape)
    # the model-level hooks (the trunk's tp and sp, attention, overlap_matmul,
    # moe_block) resolve this mesh while fit() runs; the caller's comes back
    # after it, so no later step or forward in the process reads this one
    before = get_default_mesh()
    set_default_mesh(mesh)
    try:
        with diagnostics_context(), trace.span("train.fit", steps=cfg.steps):
            with hbm.oom_guard("fit"):
                return _fit(cfg, device, mesh)
    finally:
        set_default_mesh(before)


def _fit(cfg: FitConfig, device: torch.device, mesh: Mesh) -> dict:
    """fit()'s run over ``mesh``, which is the default mesh meanwhile."""
    lead = mesh.rank == 0
    if lead:
        log.info("mesh: %s over %d ranks", mesh.shape, mesh.size)
    model = replace(cfg.model, **{name: getattr(cfg, name) for name in _MODEL_OVERRIDES
                                  if getattr(cfg, name)})

    optimizer = default_optimizer(
        lr=cfg.lr, warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.steps, cfg.warmup_steps + 1), mu_dtype=cfg.mu_dtype,
    )
    rules = mesh_rules(cfg.rules, mesh)
    pp = mesh.shape["pp"]
    microbatches = (cfg.pp_microbatches or 2 * pp) if pp > 1 else 0
    step_fn = make_train_step(model, optimizer, mesh=mesh, rules=rules,
                              n_microbatches=microbatches, pp_schedule=cfg.pp_schedule,
                              grad_bucket_bytes=int(cfg.grad_bucket_mb * (1 << 20)))
    state = make_train_state(model, optimizer, seed=0, device=device, mesh=mesh,
                             rules=rules)

    manager = None
    start_step = 0
    if cfg.checkpoint_dir:
        from tony_tpu_torch.train.checkpoint import CheckpointManager

        manager = CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                                    save_interval_steps=cfg.checkpoint_every, mesh=mesh,
                                    specs=state_specs(model, rules).params)
        if cfg.resume:
            state, restored = manager.restore(state)
            if restored >= 0:
                start_step = restored
                log.info("resumed from checkpoint step %d", restored)

    batches = make_batches(cfg.data, device=device, start_step=start_step, mesh=mesh,
                           rules=rules, microbatches=microbatches)
    flops_per_token = train_flops_per_token(model, cfg.data.seq_len)
    tokens_per_step = cfg.data.global_batch * cfg.data.seq_len
    peak = chip_peak_flops(device) if device.type == "cuda" else None
    timer = StepTimer(flops_per_token=flops_per_token, tokens_per_step=tokens_per_step,
                      n_chips=mesh.size)

    # per-run registry: a second fit() in the process reports this run's
    # distribution, not a blend with the last one
    registry = Registry()
    h_step = registry.histogram(
        "tony_step_time_seconds",
        "train step wall time (every step after the first; each ends in a sync)")
    tracer = trace.active_tracer()
    recorder = series.active_recorder()
    watch = hbm.active_watch()
    hbm_mark = watch.mark() if watch is not None else None
    step_window = HistogramWindow()
    steady_t0: float | None = None
    host_steady_s = 0.0
    step = start_step

    def _series_source() -> dict:
        """Host-side locals only: read on a scrape's stride, never a sync."""
        out = {"step": float(step + 1)}
        if steady_t0 is not None:
            elapsed = max(time.perf_counter() - steady_t0, 1e-9)
            out["host_blocked_frac"] = round(host_steady_s / elapsed, 4)
            out["goodput_frac"] = round(max(1.0 - host_steady_s / elapsed, 0.0), 4)
        d = step_window.delta(h_step)
        if d["count"]:
            out["step_time_p50_s"] = round(d["p50"], 4)
            out["step_time_p99_s"] = round(d["p99"], 4)
            out["step_time_n"] = d["count"]
        return out

    if recorder is not None:
        recorder.attach("fit", _series_source)

    loss = float("nan")
    step_times: list[float] = []
    try:
        for step in range(start_step, cfg.steps):
            t0 = time.perf_counter()
            if step == start_step:
                with trace.span("fit.startup.first_batch"):
                    inputs, targets = next(batches)
            else:
                inputs, targets = next(batches)
            fetch_s = time.perf_counter() - t0
            if step != start_step:
                host_steady_s += fetch_s
            # coordinated-profiling seam: opens/advances a requested window
            profile.maybe_capture(fetch_s=fetch_s)
            # the first step (warm-up) is never a sampled span, as in the
            # reference; every step ends in its one host sync, inside the span
            sp = trace.NOOP_SPAN
            if tracer is not None and step != start_step:
                sp = tracer.sampled_span("train.step", step=step + 1,
                                         fetch_ms=round(fetch_s * 1e3, 3))
            with sp, (annotate("train.step") if sp is not trace.NOOP_SPAN
                      else contextlib.nullcontext()):
                state, metrics = step_fn(state, inputs, targets)
                loss = float(metrics["loss"])        # the step's one host sync
            dt = time.perf_counter() - t0
            hbm.sample()                 # allocator statistics: no sync
            health.sample(metrics=metrics)   # pinned async copies, read off-thread
            series.sample()              # host-side locals
            if step != start_step:                   # the first step warms up
                timer.record(dt, host_blocked_s=fetch_s)
                step_times.append(dt)
                h_step.observe(dt)
            else:
                steady_t0 = time.perf_counter()
            if (step == start_step or (step + 1) % cfg.log_every == 0
                    or step + 1 == cfg.steps):
                out = {
                    "step": step + 1, "loss": round(loss, 4),
                    "grad_norm": round(float(metrics["grad_norm"]), 4),
                    "step_time_s": dt, "host_blocked_s": fetch_s,
                }
                if "aux" in metrics:
                    out["aux"] = float(metrics["aux"])
                if lead:
                    log.info("step %(step)d loss=%(loss)s", out)
                    if cfg.on_metrics:
                        cfg.on_metrics(out)
            if manager is not None and manager.should_save(step + 1):
                manager.save(step + 1, state)
    finally:
        # a profile window still open (requested past the last step, or an
        # exception mid-capture) finalises here: its partial trace lands
        profile.finish_capture()
        close_batches(batches)
        if recorder is not None:
            # final scrape (the shutdown state lands, a last-window SLO trip
            # evaluates) before the source whose locals die is detached
            recorder.force_sample()
            recorder.drain()
            recorder.detach("fit")
    if manager is not None:
        if manager.latest_step() != cfg.steps:
            manager.save(cfg.steps, state, force=True)
        manager.close()

    final = {"final_loss": loss, "steps": cfg.steps, "loader": loader_kind(cfg.data)}
    if step_times:
        final["tokens_per_sec_per_chip"] = timer.tokens_per_sec_per_chip
        final["host_blocked_ms_per_step"] = timer.host_blocked_ms_per_step
        # MFU against the card's data-sheet peak; a CPU run has none
        final["mfu"] = timer.mfu(peak) if peak else None
        final["step_time_p50_s"] = float(np.percentile(step_times, 50))
        final["step_time_p99_s"] = float(np.percentile(step_times, 99))
    if device.type == "cuda":
        final["peak_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    # the health verdict: drain so a trip on the final steps lands here,
    # export tony_health_* into this run's registry, persist the verdict
    sentinel = health.active_sentinel()
    if sentinel is not None:
        sentinel.drain()
        final["health_verdict"] = sentinel.verdict
        trips = sentinel.trip_counts()
        if trips:
            final["health_trips"] = trips
        sentinel.export(registry)
        sentinel.write_verdict()
    slo_engine = slo.active_engine()
    if slo_engine is not None:
        final["slo_verdict"] = slo_engine.verdict
        slo_trips = slo_engine.trip_counts()
        if slo_trips:
            final["slo_trips"] = slo_trips
        slo_engine.export(registry)
        slo_engine.write_verdict()
    if watch is not None:
        watch.export_gauges(registry)
        peak_gb, peak_exact = watch.peak_since(hbm_mark)
        if peak_gb:
            final["peak_hbm_gb"] = peak_gb
            final["peak_hbm_exact"] = peak_exact
    # the registry snapshot into the job history (no-op outside a job),
    # suffixed so a train-then-serve process keeps both
    snapshot_to_app_dir(trace.default_proc_name("train") + "_fit", registry)
    return final


__all__ = ["FitConfig", "fit"]
