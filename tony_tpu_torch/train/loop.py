"""The user-facing training loop: ``fit()``.

The counterpart of ``tony_tpu/train/loop.py``'s ``fit``, in the same
order: distributed bootstrap and mesh, optimizer, train state, checkpoint
resume, batch stream (prefetched to the device), ``StepTimer`` and the
step loop, then the final report (``final_loss``, ``steps``,
``tokens_per_sec_per_chip``, ``mfu``, ``step_time_p50_s``/``_p95_s``/
``_p99_s``, ``host_blocked_frac``, ``startup``).
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
``cfg.model`` as in the reference.

Metrics. Every log boundary (the first step, every ``log_every``-th and
the last) pushes the reference's keys to ``on_metrics`` on rank 0:
``step``, ``loss``, ``tokens_per_sec``, ``tokens_per_sec_per_chip``,
``mfu`` (None without a card: no peak to hold it to), ``grad_norm`` and
``host_blocked_ms_per_step`` over the log window, the device memory keys
of ``obs/device_metrics.py`` (``hbm_mb``, ``hbm_peak_mb``,
``hbm_limit_mb``; none on the CPU), and on the first push ``startup_*``:
``compile_s``, ``first_batch_s`` and, with a checkpoint to resume from,
``restore_s``. The port keeps ``step_time_s``, ``host_blocked_s`` and,
for MoE, ``aux`` beside them. The reference's ``xla_compiles`` has no
eager counterpart. Inside a job (the executor exported the runtime's env)
with no ``on_metrics`` given, every rank pushes its own dict to the job's
AM through ``obs/reporter.py``'s ``MetricsReporter``, as the reference's
processes do; the reporter is closed at the end, and the final report has
``metrics_dropped`` when pushes were dropped.

Job env (:meth:`FitConfig.apply_job_env`, the reference's): unset
checkpoint fields come from the ``TONY_CHECKPOINT_*`` env the runtime
exports from the job's ``checkpoint.*`` and
``restart.resume_from_checkpoint`` keys, so a gang-restarted job resumes
from its last checkpoint.

Elastic training (``elastic_members`` >= 2, or ``TONY_ELASTIC=1`` with
``TONY_ELASTIC_MEMBERS`` through :meth:`FitConfig.apply_job_env`): one
process per rank, ``elastic_members`` members of ``mesh_shape`` ranks
each (dp 1 inside a member; None: fsdp over the member's ranks), the
members on dp. At a generation boundary (the ``elastic_plan``, which
outranks the broadcast file ``generation.json`` under ``elastic_dir`` or
the job's app dir) the process group is formed again over the live
members' ranks; see :class:`_Elastic`. A member lost in the middle of a
step (a collective raises ``DistError``) is the AM's to declare: the
survivors wait for its shrink, re-form the group and redo the step from
the state they held; a relaunched member joins the running gang.

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
'mmap' or 'synthetic'). Left out: compile-ahead with its
``fit.startup.compile`` spans (PyTorch runs eagerly, with nothing to
compile).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.llama import LlamaConfig, train_flops_per_token
from tony_tpu_torch.obs import hbm, health, profile, series, slo, trace
from tony_tpu_torch.obs.device_metrics import device_metrics_dict
from tony_tpu_torch.obs.diagnostics import diagnostics_context
from tony_tpu_torch.obs.metrics import StepTimer, chip_peak_flops
from tony_tpu_torch.obs.profiler import annotate
from tony_tpu_torch.obs.registry import HistogramWindow, Registry, snapshot_to_app_dir
from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.dist import initialize
from tony_tpu_torch.parallel.mesh import (
    MESH_AXES, Mesh, MeshShape, build_mesh, get_default_mesh, set_default_mesh,
)
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules, mesh_rules, unshard_tree
from tony_tpu_torch.runtime.torch_dist import in_tony_job
from tony_tpu_torch.train.data import DataConfig, loader_kind, make_batches
from tony_tpu_torch.train.prefetch import close_batches
from tony_tpu_torch.train.trainer import (
    PP_SCHEDULES, TrainState, check_1f1b, check_model_mesh, default_optimizer,
    make_train_state, make_train_step, state_specs, tree_leaves,
)

log = logging.getLogger(__name__)


@dataclass
class FitConfig:
    model: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    data: DataConfig = field(default_factory=DataConfig)
    # None -> FSDP over every rank; with elastic_members, the PER-MEMBER
    # shape (dp 1) and data.global_batch the full-membership batch
    mesh_shape: MeshShape | None = None
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
    # elastic training: the gang's member count at full strength (0 off,
    # >= 2 on); the scripted membership plan {step: (member, ...)} applied
    # at step boundaries (outranks the broadcast file); the broadcast and
    # journal root ('' -> TONY_APP_DIR); the shadow stride (0 -> env/16)
    elastic_members: int = 0
    elastic_plan: dict | None = None
    elastic_dir: str = ""
    elastic_shadow_steps: int = 0

    def apply_job_env(self) -> None:
        """Fill unset checkpoint fields from the TONY_CHECKPOINT_* env the
        executor exported (the checkpoint.dir / checkpoint.interval_steps /
        restart.resume_from_checkpoint job-config glue), and arm elastic
        membership from the TONY_ELASTIC* env an elastic job exports (the
        reference's ``apply_job_env``, field for field)."""
        if not self.checkpoint_dir and os.environ.get("TONY_CHECKPOINT_DIR"):
            self.checkpoint_dir = os.environ["TONY_CHECKPOINT_DIR"]
            if self.checkpoint_every == 0:
                self.checkpoint_every = int(
                    os.environ.get("TONY_CHECKPOINT_INTERVAL_STEPS", "0")
                )
            self.checkpoint_keep = int(
                os.environ.get("TONY_CHECKPOINT_KEEP", str(self.checkpoint_keep))
            )
            self.resume = os.environ.get("TONY_RESUME_FROM_CHECKPOINT", "true") == "true"
        if self.elastic_members == 0 and os.environ.get("TONY_ELASTIC") == "1":
            self.elastic_members = int(
                os.environ.get("TONY_ELASTIC_MEMBERS", "0") or 0
            )


# FitConfig fields that override the model config's field of the same name
# when set (the reference's overrides, tony_tpu/train/loop.py:411-426)
_MODEL_OVERRIDES = ("ce_impl", "moe_dispatch", "moe_group_block", "overlap_impl",
                    "moe_overlap_impl", "moe_overlap_chunk")


def _check_config(cfg: FitConfig) -> None:
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
    cfg.apply_job_env()
    _check_config(cfg)
    # the observability spine, armed from the env (each idempotent); the
    # sentinel before the train step is built, so the steps it reads build
    # their monitors
    trace.install_from_env()
    hbm.install_from_env()
    health.install_from_env()
    series.install_from_env()
    profile.install_from_env()
    initialize(device)
    el = _Elastic(cfg, device) if cfg.elastic_members >= 2 else None
    mesh = el.mesh if el is not None else build_mesh(cfg.mesh_shape)
    # the model-level hooks (the trunk's tp and sp, attention, overlap_matmul,
    # moe_block) resolve this mesh while fit() runs; the caller's comes back
    # after it, so no later step or forward in the process reads this one
    before = get_default_mesh()
    set_default_mesh(mesh)
    try:
        with diagnostics_context(), trace.span("train.fit", steps=cfg.steps):
            with hbm.oom_guard("fit"):
                return _fit(cfg, device, mesh, el)
    finally:
        if el is not None:
            el.close()
        set_default_mesh(before)


def _state_tree(state: TrainState) -> dict:
    return {"step": state.step, "params": state.params, "opt_state": state.opt_state}


# the boundary a left-out member reports when the run ended before a
# generation named it again
_ENDED = "ended"


class _Elastic:
    """fit()'s elastic runtime: the member topology, the generation
    watcher, the host shadow and the membership-aware batch stream, over
    one process per rank (the counterpart of the reference's ``_Elastic``,
    which is one controller process owning every member's devices).

    The coordinator is global rank 0 (member 0, the reference's chief,
    which a generation may not drop): its controller alone watches the
    broadcast file and writes the journal (``journal_m0.jsonl``). Every
    rank reads the same scripted plan; a file-broadcast generation reaches
    the other ranks by one small broadcast a step from rank 0 (an int64
    tensor of ``n_members + 1``: the generation and a live flag a member),
    made only when the run has an elastic dir to watch. A generation that
    adds a member is held back until every rank of it waits on the run's
    store. :meth:`reshard` is the generation boundary; a member left out
    of a generation leaves the group and waits (:meth:`_wait`) for one
    that names it.

    The dead member. A member killed in the middle of a step breaks that
    step's collectives on every survivor, and every collective across
    members (the per-step broadcast, the dp gradient sum, the loss mean)
    comes before the optimizer's update, so a survivor whose collective
    raised (``DistError``, :func:`~tony_tpu_torch.parallel.dist.wait_work`)
    still holds the state the step started from. :meth:`failed` then waits
    for the shrink, without the broken group: the coordinator reads the
    AM's declaration from the generation history, the other survivors the
    coordinator's announcement on the run's store; the boundary is the
    failed step, which is redone over the re-formed group, the dead
    member's rows from it skipped and declared. A relaunched member
    (``pdist.elastic_rejoin``) joins the running gang from the store: it
    adopts the last announced generation and waits for the one that
    names it, receiving the whole state by broadcast.
    """

    def __init__(self, cfg: FitConfig, device: torch.device):
        from tony_tpu_torch import elastic

        rejoin = pdist.elastic_rejoin()
        if not dist.is_initialized() and rejoin is None:
            raise RuntimeError(
                "elastic fit() runs one process per rank of every member: bring "
                "up the default process group (the env contract, or "
                "init_process_group) first")
        self._elastic = elastic
        self.cfg = cfg
        self.device = device
        # ONE parser for the TONY_ELASTIC* contract; FitConfig fields
        # override what they own
        settings = elastic.ElasticSettings.from_env() or elastic.ElasticSettings()
        settings.members = cfg.elastic_members or settings.members
        self.app_dir = cfg.elastic_dir or settings.app_dir or os.environ.get("TONY_APP_DIR", "")
        if cfg.elastic_shadow_steps:
            settings.shadow_interval_steps = cfg.elastic_shadow_steps
        if rejoin is None:
            rank, world = pdist.world()
        else:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        self.topology = elastic.ElasticTopology(cfg.elastic_members, per_member=cfg.mesh_shape,
                                                world=world)
        self.member, self.local = self.topology.member_of(rank)
        self.rank = rank                       # at full strength
        self.coordinator = rank == 0
        settings.member = self.member
        settings.app_dir = self.app_dir if self.coordinator else ""
        self.controller = elastic.ElasticController(settings, watch=bool(settings.app_dir))
        self.shadow = elastic.ShadowStore(interval_steps=settings.shadow_interval_steps)
        # an elastic job's collectives time out after its detection time
        # implies; how long a survivor waits for the shrink, too
        self.timeout = pdist.elastic_timeout()
        self.failure = None           # the shrink a failed collective waits on
        self._failed: tuple[float, str] | None = None     # (when, "step" | "agree")
        self.rejoining = rejoin is not None
        if rejoin is None:
            self.backend = dist.get_backend()
            # the store the run started with, under the default group's
            # prefix: every generation's group forms on a prefix of it,
            # and a waiting or relaunched member reads announcements there
            store = dist.distributed_c10d._get_default_store()
            while isinstance(store, dist.PrefixStore):
                store = store.underlying_store
            self.base_store = store
            key = [f"{os.getpid()}-{time.time_ns()}"]
            dist.broadcast_object_list(key, src=0)
            self.run_key = f"elastic/{key[0]}"
            if self.coordinator:
                self.base_store.set(pdist.ELASTIC_RUN_KEY, self.run_key)
            self.mesh = build_mesh(self.topology.shape_for(self.controller.members))
        else:
            if self.topology.ranks_per_member != 1:
                raise NotImplementedError(
                    "a relaunched elastic member rejoins as one rank; this gang's members "
                    f"are {self.topology.ranks_per_member} ranks each")
            self.base_store, self.backend = rejoin
            self.run_key = self.base_store.get(pdist.ELASTIC_RUN_KEY).decode()
            latest = self._latest()
            if latest:
                self.controller.applied(self._announced(latest)[0])
            self.mesh = build_mesh()          # one rank, until the join
        self.stream = None
        self.plan = {int(k): tuple(v) for k, v in (cfg.elastic_plan or {}).items()}
        self.reshards = 0
        self.reshard_s = 0.0
        self.boundaries: list[dict] = []
        self.model = cfg.model
        self.rules: Rules = cfg.rules

    @property
    def journal(self):
        return self.controller.journal

    def make_stream(self, start_step: int, rules: Rules, microbatches: int):
        self.rules = rules
        self._microbatches = microbatches
        self.stream = self._elastic.ElasticBatchStream(
            self.cfg.data, self.cfg.elastic_members, self.controller.members, self.mesh,
            start_step, member=self.member, rules=rules, microbatches=microbatches,
            device=self.device)
        return self.stream

    def _record(self, generation: int, members, reason: str):
        old, new = set(self.controller.members), {int(m) for m in members}
        return self._elastic.GenerationRecord(
            generation=generation, members=tuple(sorted(new)),
            boundary="shrink" if old - new else "grow",
            dead=tuple(sorted(old - new)), added=tuple(sorted(new - old)), reason=reason)

    def _key(self, *parts) -> str:
        return "/".join((self.run_key, *(str(p) for p in parts)))

    def _ready(self, rec) -> bool:
        """Whether every rank ``rec`` adds waits on the store, caught up
        with this generation (:meth:`_wait`)."""
        for m in rec.members:
            if m in self.controller.members:
                continue
            for local in range(self.topology.ranks_per_member):
                key = self._key("ready", self.topology.rank_of(m, local))
                if not self.base_store.check([key]) or \
                        int(self.base_store.get(key)) < self.controller.generation:
                    return False
        return True

    def _agree(self):
        """Rank 0's pending broadcast record on every live rank."""
        n = self.topology.n_members
        buf = torch.zeros(n + 1, dtype=torch.int64,
                          device=self.device if self.backend == "nccl" else "cpu")
        rec = self.controller.pending() if self.coordinator else None
        if rec is not None and not self._ready(rec):
            rec = None              # a member it adds is not waiting yet
        if rec is not None:
            buf[0] = rec.generation
            buf[1 + torch.tensor(rec.members, dtype=torch.int64)] = 1
        pdist.wait_work(dist.broadcast(buf, 0, async_op=True))
        gen, *flags = buf.tolist()
        if self.coordinator or not gen:
            return rec
        return self._record(gen, [m for m in range(n) if flags[m]], "file broadcast")

    def pending(self, step: int):
        """The membership change to apply at this boundary, if any: a
        failed collective's shrink first, then the scripted plan, which
        outranks the file broadcast. A record whose membership already
        matches is adopted here without a reshard."""
        if self.failure is not None:
            rec, self.failure = self.failure, None
            return rec
        rec_file = self._agree() if self.app_dir else None
        members = self.plan.pop(step, None)
        rec = None
        if members is not None and set(members) != set(self.controller.members):
            rec = self._record(self.controller.generation + 1, members, "scripted plan")
        elif rec_file is not None:
            if set(rec_file.members) == set(self.controller.members):
                self.controller.applied(rec_file)
                return None
            rec = rec_file
        if rec is not None and 0 not in rec.members:
            raise ValueError(f"elastic generation {rec.generation} drops member 0, which "
                             "holds the coordinator (the reference's chief)")
        return rec

    def failed(self, err: Exception, step: int, where: str = "step") -> None:
        """A collective of ``step`` raised ``err`` on this rank: a member is
        gone. ``where`` says which: the train step's (``"step"``, the step
        is redone) or the per-step broadcast before it (``"agree"``).
        Waits for the shrink generation (the coordinator: the AM's
        declaration in the history that leaves out a current member; the
        other ranks: the coordinator's announcement on the store) and keeps
        it as the next boundary, at ``step``. Raises ``err`` without an
        elastic dir to read the declaration from, or when none comes
        within the group timeout (or 60 s)."""
        self._failed = (time.perf_counter(), where)
        log.warning("elastic member %d: a collective of step %d failed (%s); waiting for "
                    "the shrink generation", self.member, step, str(err).splitlines()[0])
        if not self.app_dir:
            raise err
        wait_s = self.timeout.total_seconds() if self.timeout is not None else 60.0
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if self.coordinator:
                old = set(self.controller.members)
                rec = next((r for r in self._elastic.read_history(self.app_dir)
                            if r.generation > self.controller.generation
                            and not old <= set(r.members)), None)
                if rec is not None:
                    self.failure = self._record(rec.generation, rec.members,
                                                rec.reason or "member lost")
                    return
            else:
                latest = self._latest()
                if latest > self.controller.generation:
                    self.failure = self._announced(latest)[0]
                    return
                if self.base_store.check([self._key("done")]):
                    break
            time.sleep(0.05)
        raise err

    def note_step(self, step: int) -> None:
        if self.journal is not None:
            self.journal.step(step, self.controller.generation, self.controller.members)

    # --- the generation boundary ---------------------------------------------

    def boundary(self, step: int, state: TrainState, rebuild: Callable):
        """The generation boundary due at ``step``: None when there is none,
        else what :meth:`reshard` returns. A relaunched member joins the
        running gang here, at its first call."""
        if self.rejoining:
            self.rejoining = False
            return self._enter(self._wait(step), state, rebuild)
        try:
            rec = self.pending(step)
        except dist.DistError as e:     # the per-step broadcast
            self.failed(e, step, "agree")
            rec = self.pending(step)
        return None if rec is None else self.reshard(rec, step, state, rebuild)

    def reshard(self, rec, step: int, state: TrainState, rebuild: Callable):
        """One generation boundary at ``step``: returns ``(state, step_fn,
        mesh, rules, step)`` on the new generation's group, or ``_ENDED``
        when this rank was left out and the run ended before it was named
        again. ``rebuild(mesh)`` gives ``(rules, microbatches, step_fn)``.

        In order: synchronize and take the fenced state (the member's
        whole state, gathered over its own axes) into the shadow; destroy
        the group; form the new one on a prefix of the run's store
        (``<run>/gen<g>``; the backend the old group used, so gloo stays
        gloo); build its mesh and set it as the default mesh; rebuild the
        train step; put the shadow back as this rank's blocks
        (``reshard_state``); broadcast the whole state to grown members
        from the same local rank of the first surviving member; reshard
        the stream; journal the boundary and adopt the generation."""
        leaving = self.member not in rec.members
        with self._span(rec, step):
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            host = None if leaving else self._fence(step, state)
            dist.destroy_process_group()
            self._announce(rec, step)
            if leaving:
                self._done(rec, step, self.stream.reshard(rec.members, None), t0, 0)
            else:
                return (*self._join(rec, step, host, state, rebuild, t0), step)
        return self._enter(self._wait(step), state, rebuild)

    def _enter(self, got, state: TrainState, rebuild: Callable):
        """Join the generation :meth:`_wait` returned, from outside any group."""
        if got is None:
            return _ENDED
        rec, step = got
        with self._span(rec, step):
            return (*self._join(rec, step, None, state, rebuild, time.perf_counter()), step)

    def _span(self, rec, step: int):
        # the coordinator's span is the generation change ``tony trace``
        # counts (restart_s, generation_changes), one a boundary as the
        # reference's trainer journals it; every other rank's is its own
        name = "elastic.reshard" if self.coordinator else "elastic.rank_reshard"
        return trace.span(name, generation=rec.generation,
                          boundary=rec.boundary, at_step=step,
                          members=",".join(str(m) for m in sorted(rec.members)),
                          dead=",".join(str(m) for m in rec.dead))

    def _fence(self, step: int, state: TrainState) -> dict:
        """The fenced state into the shadow: the member's whole state."""
        specs = state_specs(self.model, self.rules).params
        whole = {"step": state.step, "params": unshard_tree(state.params, specs, self.mesh),
                 "opt_state": {"count": state.opt_state["count"],
                               "mu": unshard_tree(state.opt_state["mu"], specs, self.mesh),
                               "nu": unshard_tree(state.opt_state["nu"], specs, self.mesh)}}
        return self.shadow.capture_sync(step, whole)

    def _announce(self, rec, step: int) -> None:
        """The coordinator's word to members waiting on the store: the
        record, then the generation number that points at it."""
        if self.coordinator:
            self.base_store.set(self._key("announce", rec.generation),
                                json.dumps({**rec.to_dict(), "at_step": step}))
            self.base_store.set(self._key("generation"), str(rec.generation))

    def _latest(self) -> int:
        """The last generation the coordinator announced (0: none)."""
        key = self._key("generation")
        return int(self.base_store.get(key)) if self.base_store.check([key]) else 0

    def _announced(self, generation: int):
        """(record, boundary step) of an announced generation."""
        d = json.loads(self.base_store.get(self._key("announce", generation)))
        return self._elastic.GenerationRecord.from_dict(d), int(d["at_step"])

    def _form(self, members: tuple[int, ...], generation: int) -> None:
        rank = self.topology.rank_of(self.member, self.local, members)
        world = len(members) * self.topology.ranks_per_member
        store = dist.PrefixStore(self._key(f"gen{generation}"), self.base_store)
        dist.init_process_group(self.backend, store=store, rank=rank, world_size=world,
                                **({"timeout": self.timeout} if self.timeout else {}))

    def _join(self, rec, step: int, host, state: TrainState, rebuild: Callable, t0: float):
        """Steps 3-8 of the boundary for a rank of ``rec``'s membership:
        ``host`` is its fenced shadow (None for a grown member, which
        receives the whole state by broadcast)."""
        members = tuple(sorted(rec.members))
        old = self.controller.members
        self._form(members, rec.generation)
        formed = time.perf_counter()
        self.mesh = build_mesh(self.topology.shape_for(members))
        set_default_mesh(self.mesh)
        rules, microbatches, step_fn = rebuild(self.mesh)
        self.rules = rules
        if host is not None:
            state = self._elastic.reshard_state(host, self.mesh, rules, model=self.model,
                                                device=self.device)
        tb = time.perf_counter()
        sent = self._sync_grown(members, old, state)
        broadcast_s = time.perf_counter() - tb
        self.stream.step = step
        skipped = self.stream.reshard(members, self.mesh)
        self._done(rec, step, skipped, t0, sent, broadcast_s=broadcast_s, formed=formed)
        return state, step_fn, self.mesh, rules

    def _sync_grown(self, members: tuple[int, ...], old: tuple[int, ...],
                    state: TrainState) -> int:
        """Grown members receive the whole state from the same local rank
        of the first surviving member (parameters, AdamW moments, the step
        counts; the port's clip is stateless and it keeps no loss scaler)
        and its health sentinel's stride count, so every rank builds the
        step's monitors on the same steps (their sums share the step's
        all-reduces); survivors keep theirs. Returns the payload bytes this
        rank sent or received."""
        grown = [m for m in members if m not in old]
        if not grown:
            return 0
        src = next(m for m in members if m in old)
        rank = self.topology.rank_of(self.member, self.local, members)
        moved = 0
        for local in range(self.topology.ranks_per_member):
            ranks = tuple(self.topology.rank_of(m, local, members) for m in [src, *grown])
            group = dist.new_group(list(ranks), timeout=self.timeout)
            if rank not in ranks:
                continue
            axis = pdist.Axis("elastic", len(ranks), ranks.index(rank), ranks, group)
            leaves = [*tree_leaves(state.params), *tree_leaves(state.opt_state["mu"]),
                      *tree_leaves(state.opt_state["nu"])]
            sentinel = health.active_sentinel()
            counts = torch.tensor([state.step, state.opt_state["count"],
                                   sentinel.steps_seen if sentinel is not None else -1],
                                  dtype=torch.int64, device=leaves[0].device)
            with torch.no_grad():
                for t in [*leaves, counts]:
                    got = pdist.broadcast(t, axis, 0)
                    if axis.index:
                        t.copy_(got)
            nbytes = sum(t.numel() * t.element_size() for t in [*leaves, counts])
            moved = nbytes * (len(ranks) - 1) if axis.index == 0 else nbytes
            state.step, state.opt_state["count"], seen = (int(c) for c in counts.tolist())
            if sentinel is not None and seen >= 0:
                sentinel.steps_seen = seen
        return moved

    def _done(self, rec, step: int, skipped: dict, t0: float, moved: int,
              broadcast_s: float = 0.0, formed: float | None = None) -> None:
        dt = time.perf_counter() - t0
        self.reshards += 1
        self.reshard_s += dt
        entry = {"generation": rec.generation, "at_step": step, "boundary": rec.boundary,
                 "reshard_s": dt, "broadcast_bytes": moved, "broadcast_s": broadcast_s,
                 "wall": time.time()}
        if self._failed is not None and formed is not None:
            # from the collective that failed to the group re-formed without it
            entry["failure_to_group_s"] = formed - self._failed[0]
            entry["failed_in"] = self._failed[1]
            self._failed = None
        self.boundaries.append(entry)
        if self.journal is not None:
            self.journal.reshard(
                generation=rec.generation, at_step=step, boundary=rec.boundary,
                members=tuple(sorted(rec.members)), dead=rec.dead, added=rec.added,
                skipped=skipped, reshard_s=dt, lost_steps=0)
        self.controller.applied(rec)
        if self.coordinator:
            log.warning("elastic generation %d (%s) applied at step %d in %.2fs: "
                        "members=%s global_batch=%d", rec.generation, rec.boundary, step, dt,
                        list(rec.members), self.stream.global_batch)

    def _wait(self, step: int):
        """Out of the group: wait on the run's store for a generation that
        names this member, adopting each announced one that does not, and
        say on the store (``<run>/ready/<rank>``) which generation this
        rank has caught up with. Returns (record, boundary step), or None
        when the run ended."""
        named = 0
        self.base_store.set(self._key("ready", self.rank), str(self.controller.generation))
        while True:
            for g in range(self.controller.generation + 1, self._latest() + 1):
                if not self.base_store.check([self._key("announce", g)]):
                    continue          # adopted without a boundary: nothing to do
                rec, at = self._announced(g)
                if self.member in rec.members:
                    self.plan = {k: v for k, v in self.plan.items() if k > at}
                    return rec, at
                self.stream.step = at
                self._done(rec, at, self.stream.reshard(rec.members, None),
                           time.perf_counter(), 0)
                self.base_store.set(self._key("ready", self.rank),
                                    str(self.controller.generation))
            if self.base_store.check([self._key("done")]):
                return None
            if self.app_dir:
                rec = self._elastic.read_generation(self.app_dir)
                if rec is not None and rec.generation > named and self.member in rec.members:
                    named = rec.generation
                    log.info("elastic member %d named by generation %d: joining when the "
                             "survivors reach its boundary", self.member, rec.generation)
            time.sleep(0.05)

    def summary(self) -> dict:
        return {
            "generation": self.controller.generation,
            "members": list(self.controller.members),
            "reshards": self.reshards,
            "reshard_s": round(self.reshard_s, 3),
            "shadow_dropped": self.shadow.dropped,
        }

    def close(self) -> None:
        if self.coordinator:
            self.base_store.set(self._key("done"), "1")
        self.shadow.close()
        if self.stream is not None:
            self.stream.close()
        self.controller.close()


def _fit(cfg: FitConfig, device: torch.device, mesh: Mesh, el: _Elastic | None) -> dict:
    """fit()'s run over ``mesh``, which is the default mesh meanwhile."""
    lead = mesh.rank == 0
    if lead:
        log.info("mesh: %s over %d ranks", mesh.shape, mesh.size)
    model = replace(cfg.model, **{name: getattr(cfg, name) for name in _MODEL_OVERRIDES
                                  if getattr(cfg, name)})
    if el is not None:
        el.model = model

    optimizer = default_optimizer(
        lr=cfg.lr, warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.steps, cfg.warmup_steps + 1), mu_dtype=cfg.mu_dtype,
    )

    def build_step(mesh: Mesh):
        """(rules, microbatches, train step) over ``mesh``."""
        rules = mesh_rules(cfg.rules, mesh)
        pp = mesh.shape["pp"]
        microbatches = (cfg.pp_microbatches or 2 * pp) if pp > 1 else 0
        return rules, microbatches, make_train_step(
            model, optimizer, mesh=mesh, rules=rules, n_microbatches=microbatches,
            pp_schedule=cfg.pp_schedule,
            grad_bucket_bytes=int(cfg.grad_bucket_mb * (1 << 20)))

    rules, microbatches, step_fn = build_step(mesh)
    state = make_train_state(model, optimizer, seed=0, device=device, mesh=mesh,
                             rules=rules)

    # startup breakdown (the reference's, on the first push and in the
    # final report). Eager PyTorch compiles nothing ahead: compile_s is the
    # first step's own time less its batch fetch, the kernel builds and
    # first launches (allocator, cuBLAS handles) it pays
    startup: dict[str, float] = {}
    manager = None
    start_step = 0
    if cfg.checkpoint_dir:
        from tony_tpu_torch.train.checkpoint import CheckpointManager

        manager = CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                                    save_interval_steps=cfg.checkpoint_every, mesh=mesh,
                                    specs=state_specs(model, rules).params)
        # a relaunched elastic member receives the state by broadcast
        if cfg.resume and not (el is not None and el.rejoining):
            t0 = time.perf_counter()
            with trace.span("fit.startup.restore"):
                state, restored = manager.restore(state)
            startup["restore_s"] = round(time.perf_counter() - t0, 3)
            if restored >= 0:
                start_step = restored
                log.info("resumed from checkpoint step %d", restored)

    if el is not None:
        batches = el.make_stream(start_step, rules, microbatches)
        global_batch = el.stream.global_batch
    else:
        batches = make_batches(cfg.data, device=device, start_step=start_step, mesh=mesh,
                               rules=rules, microbatches=microbatches)
        global_batch = cfg.data.global_batch
    flops_per_token = train_flops_per_token(model, cfg.data.seq_len)
    tokens_per_step = global_batch * cfg.data.seq_len
    peak = chip_peak_flops(device) if device.type == "cuda" else None
    reporter = None
    on_metrics = cfg.on_metrics
    if on_metrics is None and in_tony_job():
        # push step metrics to the AM (TaskMonitor/MetricsRpc pipeline);
        # pushes are queued + drained by a daemon thread so an AM stall
        # can never block the step loop
        from tony_tpu_torch.obs.reporter import MetricsReporter

        reporter = MetricsReporter()
        if reporter.active:
            on_metrics = reporter.push
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
    # the log window: wall time, steps and input wait since the last push
    t_window, window, host_window_s = time.perf_counter(), 0, 0.0
    try:
        while step < cfg.steps:
            if el is not None:
                moved = el.boundary(step, state, build_step)
                if moved is _ENDED:       # left out, and the run ended meanwhile
                    break
                if moved is not None:
                    state, step_fn, mesh, rules, step = moved
                    batches = el.stream
                    lead = mesh.rank == 0
                    tokens_per_step = el.stream.global_batch * cfg.data.seq_len
                    timer.tokens_per_step, timer.n_chips = tokens_per_step, mesh.size
                    if manager is not None:
                        manager.mesh = mesh
            t0 = time.perf_counter()
            if step == start_step:
                with trace.span("fit.startup.first_batch"):
                    inputs, targets = next(batches)
            else:
                inputs, targets = next(batches)
            fetch_s = time.perf_counter() - t0
            if step != start_step:
                host_steady_s += fetch_s
                host_window_s += fetch_s
            # coordinated-profiling seam: opens/advances a requested window
            profile.maybe_capture(fetch_s=fetch_s)
            # the first step (warm-up) is never a sampled span, as in the
            # reference; every step ends in its one host sync, inside the span
            sp = trace.NOOP_SPAN
            if tracer is not None and step != start_step:
                sp = tracer.sampled_span("train.step", step=step + 1,
                                         fetch_ms=round(fetch_s * 1e3, 3))
            try:
                with sp, (annotate("train.step") if sp is not trace.NOOP_SPAN
                          else contextlib.nullcontext()):
                    state, metrics = step_fn(state, inputs, targets)
                    loss = float(metrics["loss"])        # the step's one host sync
            except dist.DistError as e:
                if el is None:
                    raise
                # a member is gone: the state is still this step's start
                # (_Elastic); the step is redone at the shrink's boundary
                el.failed(e, step)
                continue
            dt = time.perf_counter() - t0
            hbm.sample()                 # allocator statistics: no sync
            health.sample(metrics=metrics)   # pinned async copies, read off-thread
            series.sample()              # host-side locals
            if el is not None:
                el.note_step(step)
                el.shadow.maybe_update(step + 1, _state_tree(state))
            window += 1
            if step != start_step:                   # the first step warms up
                timer.record(dt, host_blocked_s=fetch_s)
                step_times.append(dt)
                h_step.observe(dt)
            else:
                startup["compile_s"] = round(dt - fetch_s, 3)
                startup["first_batch_s"] = round(fetch_s, 3)
                steady_t0 = time.perf_counter()
            if (step == start_step or (step + 1) % cfg.log_every == 0
                    or step + 1 == cfg.steps):
                wt = StepTimer(flops_per_token=flops_per_token,
                               tokens_per_step=tokens_per_step, n_chips=mesh.size)
                wt.record(time.perf_counter() - t_window, window, host_blocked_s=host_window_s)
                out = {
                    "step": step + 1, "loss": round(loss, 4),
                    "tokens_per_sec": round(wt.tokens_per_sec, 1),
                    "tokens_per_sec_per_chip": round(wt.tokens_per_sec_per_chip, 1),
                    "mfu": round(wt.mfu(peak), 4) if peak else None,
                    "grad_norm": round(float(metrics["grad_norm"]), 4),
                    "host_blocked_ms_per_step": round(wt.host_blocked_ms_per_step, 2),
                    "step_time_s": dt, "host_blocked_s": fetch_s,
                }
                if step == start_step:
                    out.update({f"startup_{k}": v for k, v in startup.items()})
                out.update(device_metrics_dict())
                if "aux" in metrics:
                    out["aux"] = float(metrics["aux"])
                if el is not None and el.journal is not None:
                    fp = metrics.get("health/batch_fingerprint")
                    el.journal.loss(step, el.controller.generation, loss,
                                    int(fp) if fp is not None else None)
                if lead:
                    log.info("step %(step)d loss=%(loss)s %(tokens_per_sec_per_chip)s "
                             "tok/s/chip mfu=%(mfu)s", out)
                # the caller's on_metrics on rank 0; the job's reporter on
                # every rank, each pushing as its own task
                if on_metrics and (lead or reporter is not None):
                    on_metrics(out)
                t_window, window, host_window_s = time.perf_counter(), 0, 0.0
            if manager is not None and manager.should_save(step + 1):
                manager.save(step + 1, state)
            step += 1
    finally:
        # a profile window still open (requested past the last step, or an
        # exception mid-capture) finalises here: its partial trace lands
        profile.finish_capture()
        close_batches(batches)
        if reporter is not None:
            reporter.close()     # flushes what the AM takes within its timeout
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
        final["host_blocked_frac"] = timer.host_blocked_frac
        # MFU against the card's data-sheet peak; a CPU run has none
        final["mfu"] = timer.mfu(peak) if peak else None
        for q in (50, 95, 99):
            final[f"step_time_p{q}_s"] = float(np.percentile(step_times, q))
    if startup:
        final["startup"] = dict(startup)
    if reporter is not None and reporter.dropped:
        final["metrics_dropped"] = reporter.dropped
    if el is not None:
        final["elastic"] = el.summary()
        final["elastic_boundaries"] = list(el.boundaries)
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
