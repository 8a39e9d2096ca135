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
every rank), sets it as the default mesh and trains over dp, fsdp and ep
(``train/trainer.py``), each rank on its rows of every global batch. Rank
0 alone logs and calls ``on_metrics``; every rank returns the final
report. A checkpoint of a mesh of more than one rank is sharded: each rank
writes and reads its own blocks (``train/checkpoint.py``), and a step
restores onto whatever mesh this run has.

The model overrides ``ce_impl``, ``moe_dispatch``, ``moe_group_block``,
``overlap_impl``, ``moe_overlap_impl`` and ``moe_overlap_chunk`` apply to
``cfg.model`` as in the reference. Not ported yet, and raising when set
to a non-default: the mesh axes tp, sp and pp above 1, pipeline
parallelism (``pp_*``) and elastic training (``elastic_*``) (ROADMAP
queue 1, item 8). The reference's observability hooks
(``install_from_env``), the metrics push to a job's AM and compile-ahead
(PyTorch runs eagerly, with nothing to compile) are left out.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field, fields, replace
from typing import Callable

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, train_flops_per_token
from tony_tpu_torch.obs.metrics import StepTimer, chip_peak_flops
from tony_tpu_torch.parallel.dist import initialize
from tony_tpu_torch.parallel.mesh import MESH_AXES, MeshShape, build_mesh, set_default_mesh
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules
from tony_tpu_torch.train.data import DataConfig, make_batches
from tony_tpu_torch.train.prefetch import close_batches
from tony_tpu_torch.train.trainer import (
    check_mesh_axes, default_optimizer, make_train_state, make_train_step, state_specs,
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


# fields this slice does not port: setting one to a non-default raises
_UNPORTED = (
    "pp_microbatches", "pp_schedule",
    "elastic_members", "elastic_plan", "elastic_dir", "elastic_shadow_steps",
)
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
                "(ROADMAP queue 1, item 8)"
            )
    if cfg.mesh_shape is not None:
        check_mesh_axes(dict(zip(MESH_AXES, cfg.mesh_shape.sizes)))


def fit(cfg: FitConfig, device: str | torch.device | None = None) -> dict:
    """Train ``cfg.model`` to ``cfg.steps`` on ``device`` (``None`` means
    CUDA, and raises without it; over a mesh, this rank's device); returns
    the final metrics."""
    device = resolve_device(device)
    _check_ported(cfg)
    initialize(device)
    mesh = build_mesh(cfg.mesh_shape)
    # the model-level hooks (overlap_matmul) resolve this mesh
    set_default_mesh(mesh)
    lead = mesh.rank == 0
    if lead:
        log.info("mesh: %s over %d ranks", mesh.shape, mesh.size)
    model = replace(cfg.model, **{name: getattr(cfg, name) for name in _MODEL_OVERRIDES
                                  if getattr(cfg, name)})

    optimizer = default_optimizer(
        lr=cfg.lr, warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.steps, cfg.warmup_steps + 1), mu_dtype=cfg.mu_dtype,
    )
    step_fn = make_train_step(model, optimizer, mesh=mesh, rules=cfg.rules,
                              grad_bucket_bytes=int(cfg.grad_bucket_mb * (1 << 20)))
    state = make_train_state(model, optimizer, seed=0, device=device, mesh=mesh,
                             rules=cfg.rules)

    manager = None
    start_step = 0
    if cfg.checkpoint_dir:
        from tony_tpu_torch.train.checkpoint import CheckpointManager

        manager = CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                                    save_interval_steps=cfg.checkpoint_every, mesh=mesh,
                                    specs=state_specs(model, cfg.rules).params)
        if cfg.resume:
            state, restored = manager.restore(state)
            if restored >= 0:
                start_step = restored
                log.info("resumed from checkpoint step %d", restored)

    batches = make_batches(cfg.data, device=device, start_step=start_step, mesh=mesh,
                           rules=cfg.rules)
    flops_per_token = train_flops_per_token(model, cfg.data.seq_len)
    tokens_per_step = cfg.data.global_batch * cfg.data.seq_len
    peak = chip_peak_flops(device) if device.type == "cuda" else None
    timer = StepTimer(flops_per_token=flops_per_token, tokens_per_step=tokens_per_step,
                      n_chips=mesh.size)

    loss = float("nan")
    step_times: list[float] = []
    try:
        for step in range(start_step, cfg.steps):
            t0 = time.perf_counter()
            inputs, targets = next(batches)
            fetch_s = time.perf_counter() - t0
            state, metrics = step_fn(state, inputs, targets)
            loss = float(metrics["loss"])            # the step's one host sync
            dt = time.perf_counter() - t0
            if step != start_step:                   # the first step warms up
                timer.record(dt, host_blocked_s=fetch_s)
                step_times.append(dt)
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
        close_batches(batches)
    if manager is not None:
        if manager.latest_step() != cfg.steps:
            manager.save(cfg.steps, state, force=True)
        manager.close()

    final = {"final_loss": loss, "steps": cfg.steps}
    if step_times:
        final["tokens_per_sec_per_chip"] = timer.tokens_per_sec_per_chip
        final["host_blocked_ms_per_step"] = timer.host_blocked_ms_per_step
        # MFU against the card's data-sheet peak; a CPU run has none
        final["mfu"] = timer.mfu(peak) if peak else None
        final["step_time_p50_s"] = float(np.percentile(step_times, 50))
        final["step_time_p99_s"] = float(np.percentile(step_times, 99))
    if device.type == "cuda":
        final["peak_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return final


__all__ = ["FitConfig", "fit"]
