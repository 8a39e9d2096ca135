"""ApplicationMaster: the brain of a job.

Rebuild of the reference's ``TonyApplicationMaster`` (SURVEY.md sections 2,
3.1, 3.3): registers with the resource substrate, requests containers per task
type, launches executors, runs the control-plane RPC server, assembles the
cluster spec after all registrations (gang semantics), supervises heartbeats,
applies the failure/retry policy including the elastic worker-restart path,
emits history events, and reports final status.

Threading discipline (the survey flags AM state races as "the bug farm",
section 7 hard part #2): RPC handlers and backend callbacks never apply
failure policy themselves — they update the Session table (internally locked)
and enqueue notifications; the single main supervision loop makes every
life-cycle decision (restart / fail / finish).

The port's copy of ``tony_tpu/am/app_master.py``. It launches the port's
executor (``python -m tony_tpu_torch.executor``), validates the job against
the port's runtimes (``pytorch`` by default) and arms the port's spine
from the job's config. The elastic and serve branches are the reference's
as they are: an ``elastic`` job's lost member becomes a shrink generation
in the app dir, which the chief's ``fit()`` reads, and grow-back
relaunches the member, whose executor's registration declares the grow.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
from typing import Any

from tony_tpu_torch.am.events import EventType, EventWriter
from tony_tpu_torch.chaos import chaos_hook
from tony_tpu_torch.obs import hbm, health, profile as profile_mod, series, slo, trace
from tony_tpu_torch.am.scheduler import SchedulerHooks, TaskScheduler
from tony_tpu_torch.am.session import JobState, Session, TaskState, TERMINAL
from tony_tpu_torch.cluster import make_backend
from tony_tpu_torch.cluster.backend import Container, ContainerRequest, Resource
from tony_tpu_torch.config.config import TaskTypeSpec, TonyConfig
from tony_tpu_torch.config.keys import Keys
from tony_tpu_torch.rpc import ApplicationRpcServicer, pb, serve

log = logging.getLogger(__name__)


class ApplicationMaster(ApplicationRpcServicer):
    """One instance per job. ``run()`` blocks until the job is terminal."""

    def __init__(self, config: TonyConfig, app_id: str, app_dir: str, am_attempt: int = 0):
        self.config = config
        self.app_id = app_id
        self.app_dir = app_dir
        self.am_attempt = am_attempt
        self.specs: dict[str, TaskTypeSpec] = config.task_specs()
        if not self.specs:
            raise ValueError("no job types configured (need job.<type>.instances)")
        max_total = config.get_int(Keys.TASK_MAX_TOTAL_INSTANCES, -1)
        total = sum(s.instances for s in self.specs.values())
        if 0 <= max_total < total:
            raise ValueError(
                f"{total} task instances exceed task.max_total_instances={max_total}"
            )
        chief = "chief" if "chief" in self.specs else ""
        # AM-side pre-schedule validation hook (reference: Framework.AMAdapter
        # validateConfig), e.g. mxnet requiring exactly one scheduler.
        from tony_tpu_torch.runtime import make_runtime

        make_runtime(config.get_str(Keys.APPLICATION_FRAMEWORK, "pytorch")).validate(config)
        self.session = Session(self.specs, chief_type=chief)
        self.backend = make_backend(
            config.get_str(Keys.CLUSTER_BACKEND, "local"), config, app_id=app_id
        )
        self.events = EventWriter(
            app_id,
            config.get_str(Keys.HISTORY_INTERMEDIATE_DIR)
            or os.path.join(app_dir, "events"),
            config.get_str(Keys.HISTORY_FINISHED_DIR),
        )
        self.scheduler = TaskScheduler(
            self.session,
            self.backend,
            SchedulerHooks(self._make_request, self._on_allocated),
            allocation_timeout_s=config.get_float(Keys.AM_ALLOCATION_TIMEOUT_S, 300.0),
        )
        self._notifications: queue.Queue[tuple[str, Any]] = queue.Queue()
        self._server = None
        self.port = 0
        self._killed = threading.Event()
        self._heartbeat_interval_s = config.get_int(Keys.TASK_HEARTBEAT_INTERVAL_MS, 1000) / 1000
        self._max_missed = config.get_int(Keys.TASK_MAX_MISSED_HEARTBEATS, 25)
        self._restart_policy = config.get_str(Keys.RESTART_POLICY, "never")
        self._max_restarts = config.get_int(Keys.RESTART_MAX_WORKER_RESTARTS, 0)
        if (
            config.get_str(Keys.APPLICATION_FRAMEWORK) == "serve"
            and self._restart_policy == "never"
        ):
            # gang-serving supervision: decode hosts are SERVICES. Under
            # `never` (the training-oriented baked default) one container
            # death fails the whole job and tears down every survivor
            # mid-stream — the opposite of the serving contract, where the
            # frontend re-queues the dead host's in-flight requests onto
            # survivors while the AM relaunches just the lost host. Jobs
            # that really want never can set restart.policy explicitly
            # alongside a max_worker_restarts of 0.
            self._restart_policy = "failed_only"
            if self._max_restarts <= 0:
                self._max_restarts = 2
            log.warning(
                "serve job: restart.policy never -> failed_only "
                "(max_worker_restarts %d): a lost decode host relaunches "
                "alone while survivors keep serving", self._max_restarts,
            )
        # elastic training (tony_tpu_torch/elastic/, docs/ELASTIC.md): on a lost
        # member the AM declares a new cluster generation instead of
        # cold-restarting the gang; auto-enabled for framework "elastic"
        self._elastic_enabled = (
            config.get_bool(Keys.ELASTIC_ENABLED, False)
            or config.get_str(Keys.APPLICATION_FRAMEWORK) == "elastic"
        )
        self._elastic_min_members = config.get_int(Keys.ELASTIC_MIN_MEMBERS, 1)
        self._elastic_grow_back = config.get_bool(Keys.ELASTIC_GROW_BACK, True)
        self._elastic_grow_retry_s = config.get_float(
            Keys.ELASTIC_GROW_RETRY_S, 2.0
        )
        # seats currently out of the membership: task_id -> member rank.
        # Detached tasks sit PENDING but UNSCHEDULED until grow-back
        # re-leases their capacity; _elastic_relaunching tracks the ones
        # back in flight (their registration declares the grow generation)
        self._elastic_detached: dict[str, int] = {}
        self._elastic_relaunching: set[str] = set()
        self._elastic_last_grow = 0.0
        self._latest_metrics: dict[str, dict[str, float]] = {}
        self._last_metrics_event: dict[str, float] = {}
        self._step_metric_seen: set[str] = set()
        self._metrics_event_min_interval_s = 30.0
        # per-task series scraped off the PushMetrics heartbeat-path RPC:
        # a bounded recent window per task plus the wall time it arrived,
        # rolled up into <app_dir>/series/am_rollup.json (throttled) —
        # the fleet view `tony top` and the portal /api/series serve even
        # when workers run on hosts whose journals the AM cannot read
        self._series_history: dict[str, Any] = {}
        self._series_push_ts: dict[str, float] = {}
        self._last_series_rollup = 0.0
        self._series_rollup_min_interval_s = 5.0
        # guards the two dicts above against concurrent PushMetrics
        # handler threads; held for dict ops only, NEVER across file I/O
        self._series_lock = threading.Lock()
        self._scheduler_mode = config.get_str(Keys.SCHEDULER_MODE, "GANG").upper()
        # serializes am.state.json writes (scheduler + supervise threads)
        self._am_state_write_lock = threading.Lock()
        # gloo rendezvous store for horovod jobs (the reference's AM-side
        # HorovodDriver, SURVEY.md section 3.4); started in run()
        self._rendezvous = None
        # shared-RM lease keeper (started in run()): renews from its own
        # thread so a hung store can never stall supervision
        self._lease_keeper_stop = threading.Event()
        self._lease_ok_t = time.monotonic()
        self._lease_ttl = 0.0
        # root span for the whole AM attempt (trace spine): opened in run(),
        # its id rides into every container env so executor/user spans nest
        # under it on the merged timeline
        self._run_span = trace.NOOP_SPAN

    # --- executor launch ----------------------------------------------------

    def _make_request(self, spec: TaskTypeSpec, index: int) -> ContainerRequest:
        task = self.session.task(spec.name, index)
        attempt = task.attempt if task else 0
        python = self.config.get_str(Keys.TASK_EXECUTOR_PYTHON) or sys.executable
        env = {
            "TONY_APP_ID": self.app_id,
            "TONY_APP_DIR": self.app_dir,
            "TONY_JOB_NAME": spec.name,
            "TONY_TASK_INDEX": str(index),
            "TONY_ATTEMPT": str(attempt),
            "TONY_AM_ADDR": f"{self.backend.am_advertise_host()}:{self.port}",
            "TONY_CONF_PATH": os.path.join(self.app_dir, "config.json"),
            **spec.env,
        }
        if self._rendezvous is not None:
            env["TONY_HOROVOD_RENDEZVOUS_PORT"] = str(self._rendezvous.port)
        tracer = trace.active_tracer()
        if tracer is not None:
            # trace context AM -> executor: same trace id, journals in the
            # shared app-dir trace/, executor roots under the AM run span
            env[trace.ENV_DIR] = os.path.join(self.app_dir, "trace")
            env[trace.ENV_TRACE_ID] = tracer.trace_id
            env[trace.ENV_SAMPLE] = str(tracer.sample_steps)
            env[trace.ENV_RING] = str(tracer.ring_size)
            env[trace.ENV_JOURNAL_MB] = str(tracer.max_journal_mb)
            env[trace.ENV_PROC] = f"{spec.name}_{index}_exec_a{attempt}"
            env[trace.ENV_PARENT] = self._run_span.sid
        # HBM-observatory contract (obs/hbm.py): the device-owning user
        # process arms itself from these; the AM holds no device
        env[hbm.ENV_ENABLED] = (
            "1" if self.config.get_bool(Keys.OBS_HBM_ENABLED, True) else "0"
        )
        env[hbm.ENV_SAMPLE] = str(
            self.config.get_int(Keys.OBS_HBM_SAMPLE_STEPS, 16)
        )
        env[hbm.ENV_HISTORY] = str(
            self.config.get_int(Keys.OBS_HBM_HISTORY, 512)
        )
        # numerics-sentinel contract (obs/health.py): armed in the
        # device-owning user process; the AM only exports the knobs
        env[health.ENV_ENABLED] = (
            "1" if self.config.get_bool(Keys.OBS_HEALTH_ENABLED, True) else "0"
        )
        env[health.ENV_SAMPLE] = str(
            self.config.get_int(Keys.OBS_HEALTH_SAMPLE_STEPS, 16)
        )
        env[health.ENV_WINDOW] = str(
            self.config.get_int(Keys.OBS_HEALTH_WINDOW, 64)
        )
        # live-series contract (obs/series.py): the worker journals
        # stride-scraped points under <app_dir>/series/; the AM also
        # aggregates the metrics pushes it already receives (PushMetrics)
        # into the app-level rollup `tony top` and /api/series read
        env[series.ENV_ENABLED] = (
            "1" if self.config.get_bool(Keys.OBS_SERIES_ENABLED, True) else "0"
        )
        env[series.ENV_SAMPLE] = str(
            self.config.get_int(Keys.OBS_SERIES_SAMPLE_STEPS, 16)
        )
        env[series.ENV_JOURNAL_MB] = str(
            self.config.get_int(Keys.OBS_SERIES_JOURNAL_MB, 16)
        )
        # SLO contract (obs/slo.py): the resolved slo.* group as one JSON
        # blob; workers arm a burn-rate engine only when targets are active
        env[slo.ENV_SLO] = slo.SloConfig.from_config(self.config).to_json()
        # coordinated-profiling contract (obs/profile.py): device-owning
        # processes watch <app_dir>/profile/request.json for the windows
        # the StartProfile RPC broadcasts; the AM only exports the knobs
        env[profile_mod.ENV_ENABLED] = (
            "1" if self.config.get_bool(Keys.OBS_PROFILE_ENABLED, True) else "0"
        )
        env[profile_mod.ENV_POLL] = str(
            self.config.get_float(Keys.OBS_PROFILE_POLL_S, 0.5)
        )
        env[profile_mod.ENV_MAX_STEPS] = str(
            self.config.get_int(Keys.OBS_PROFILE_MAX_STEPS, 64)
        )
        log_path = os.path.join(
            self.app_dir, "logs", f"{spec.name}_{index}_attempt{attempt}.log"
        )
        return ContainerRequest(
            task_type=spec.name,
            task_index=index,
            resource=Resource(spec.memory_mb, spec.cpus, spec.tpu_chips),
            argv=[python, "-m", "tony_tpu_torch.executor"],
            env=env,
            log_path=log_path,
            node_label=spec.node_label,
        )

    def _on_allocated(self, job_name: str, index: int, container: Container, log_path: str) -> None:
        t = self.session.task(job_name, index)
        if t is not None:
            t.log_path = log_path
            t.container_pid = container.pid
        self.events.emit(
            EventType.TASK_STARTED,
            task=f"{job_name}:{index}",
            container=container.container_id,
            attempt=t.attempt if t else 0,
        )
        self._write_am_state()

    # --- RPC handlers (executor-facing) -------------------------------------

    def RegisterWorkerSpec(self, request, context):  # noqa: N802
        ok = self.session.register(
            request.job_name, request.index, request.host, request.port, request.attempt
        )
        if ok:
            self.events.emit(
                EventType.TASK_REGISTERED,
                task=f"{request.job_name}:{request.index}",
                address=f"{request.host}:{request.port}",
                attempt=request.attempt,
            )
            log.info(
                "registered %s:%d at %s:%d (attempt %d)",
                request.job_name, request.index, request.host, request.port, request.attempt,
            )
            trace.instant(
                "am.task_registered",
                task=f"{request.job_name}:{request.index}", attempt=request.attempt,
            )
        return pb.RegisterWorkerSpecResponse(
            accepted=ok, message="" if ok else "unknown task or stale attempt"
        )

    def GetClusterSpec(self, request, context):  # noqa: N802
        # A poll proves liveness — but only for the CURRENT attempt: a ghost
        # from before a gang restart must neither refresh the replacement's
        # heartbeat nor receive the new generation's spec.
        if not self.session.touch(request.job_name, request.index, request.attempt):
            return pb.GetClusterSpecResponse(ready=False)
        task = self.session.task(request.job_name, request.index)
        if self._scheduler_mode == "FCFS":
            ready = self._fcfs_ready(request.job_name)
        else:
            ready = self.session.all_registered()
            if not ready and self._elastic_enabled:
                # a grown-back member polls while OTHER detached seats may
                # still be empty: the barrier counts live seats only —
                # detached tasks are out of the membership by declaration,
                # not stragglers the gang should wait for
                ready = self._elastic_ready()
        if not ready:
            return pb.GetClusterSpecResponse(ready=False)
        self.session.mark_running(request.job_name, request.index)
        table = self.session.rank_table()
        coord = self.session.coordinator_task()
        return pb.GetClusterSpecResponse(
            ready=True,
            spec_json=self.session.cluster_spec_json(),
            coordinator_address=coord.address if coord else "",
            process_id=table.get(task.task_id, -1),
            num_processes=len(table),
            generation=self.session.generation,
        )

    def _fcfs_ready(self, job_name: str) -> bool:
        """FCFS: a task may proceed once its own type + dependency chain are up."""
        spec = self.specs[job_name]
        names = {job_name}
        dep = spec.depends_on
        while dep:
            names.add(dep)
            dep = self.specs[dep].depends_on if dep in self.specs else ""
        return all(
            t.state not in (TaskState.PENDING, TaskState.ALLOCATED)
            for n in names
            for t in self.session.tasks_of_type(n)
        )

    # --- elastic membership (tony_tpu_torch/elastic/protocol.py) -------------

    def _elastic_ready(self) -> bool:
        with self.session.lock:
            return all(
                t.state not in (TaskState.PENDING, TaskState.ALLOCATED)
                or t.task_id in self._elastic_detached
                for t in self.session.tasks.values()
            )

    def _elastic_members_live(self) -> list[int]:
        """Current membership: every tracked seat not detached."""
        ranks = self.session.rank_table()
        return sorted(
            rank for tid, rank in ranks.items()
            if tid not in self._elastic_detached
        )

    def _elastic_declare(self, boundary: str, *, dead: list[int] = (),
                         added: list[int] = (), reason: str = "",
                         freed_host: str = "", granted_host: str = "") -> None:
        """Declare a new cluster generation: bump the session generation
        (the same monotonic counter gang restarts use — the
        generation-monotonic invariant covers both) and broadcast the
        membership over the shared app dir; survivors fence on it."""
        from tony_tpu_torch.elastic.protocol import GenerationRecord, write_generation

        with self.session.lock:
            if boundary != "start":
                self.session.generation += 1
            generation = self.session.generation
        members = self._elastic_members_live()
        rec = GenerationRecord(
            generation=generation, members=tuple(members), boundary=boundary,
            dead=tuple(dead), added=tuple(added), reason=reason,
            freed_host=freed_host, granted_host=granted_host,
        )
        write_generation(self.app_dir, rec)
        event = (
            EventType.ELASTIC_GROW if boundary == "grow"
            else EventType.ELASTIC_SHRINK
        )
        if boundary != "start":
            self.events.emit(
                event, generation=generation, members=members,
                dead=list(dead), added=list(added), reason=reason,
                freed_host=freed_host, granted_host=granted_host,
            )
        members_str = ",".join(str(m) for m in members)
        trace.instant(
            f"am.elastic_{boundary}", generation=generation,
            members=members_str,
        )
        log.warning(
            "elastic generation %d (%s): members=%s dead=%s added=%s",
            generation, boundary, members, list(dead), list(added),
        )

    def _elastic_detach(self, failed: list) -> list:
        """Handle lost members elastically; returns the tasks the normal
        failure policy must still judge (empty when fully absorbed).

        Falls back — whole, never partially — when the coordinator
        (member 0, the trainer) is among the dead or the survivors would
        drop below elastic.min_members: those cases need the cold
        restart.policy path (checkpoint resume), not a reshard.
        """
        ranks = self.session.rank_table()
        relaunch_failures = [
            t for t in failed if t.task_id in self._elastic_relaunching
        ]
        fresh = [t for t in failed if t.task_id not in self._elastic_relaunching]
        # a relaunch that died before its grow generation was declared
        # goes quietly back to detached — membership never included it,
        # and its grow lease is RETURNED (the next attempt grows again;
        # without the return a crash-looping relaunch leaks one lease
        # per retry until the store has nothing left to grant)
        for t in relaunch_failures:
            self._elastic_relaunching.discard(t.task_id)
            self._elastic_return_lease(t)
            self._requeue_detached(t)
            log.warning(
                "elastic relaunch of %s failed before rejoining; seat "
                "stays detached", t.task_id,
            )
        if not fresh:
            return []
        victims = [t for t in fresh if t.task_id in ranks]
        if any(ranks[t.task_id] == 0 for t in victims):
            return failed  # trainer lost: cold path
        live_after = [
            r for tid, r in ranks.items()
            if tid not in self._elastic_detached
            and tid not in {t.task_id for t in victims}
        ]
        if len(live_after) < max(self._elastic_min_members, 1):
            log.warning(
                "elastic shrink would leave %d member(s) < min_members %d; "
                "falling back to restart policy",
                len(live_after), self._elastic_min_members,
            )
            return failed
        dead_members = sorted(ranks[t.task_id] for t in victims)
        freed_hosts = []
        for t in victims:
            dead_host = t.host  # cleared by the requeue below
            self._elastic_detached[t.task_id] = ranks[t.task_id]
            self._requeue_detached(t)
            shrink = getattr(self.backend, "shrink_job_lease", None)
            if shrink is not None:
                spec = self.specs[t.job_name]
                freed = shrink(
                    Resource(spec.memory_mb, spec.cpus, spec.tpu_chips),
                    host=dead_host,
                )
                if freed:
                    freed_hosts.append(freed)
        self._elastic_declare(
            "shrink", dead=dead_members,
            reason="; ".join(sorted(t.task_id for t in victims)),
            freed_host=",".join(freed_hosts),
        )
        self._write_am_state()
        return [t for t in fresh if t not in victims]

    def _elastic_return_lease(self, t) -> None:
        """Hand back the lease a failed relaunch was granted (grow-back
        took one per attempt; the seat's next attempt grows afresh)."""
        shrink = getattr(self.backend, "shrink_job_lease", None)
        if shrink is None:
            return
        spec = self.specs[t.job_name]
        shrink(
            Resource(spec.memory_mb, spec.cpus, spec.tpu_chips), host=t.host
        )

    def _requeue_detached(self, t) -> None:
        """Reset a detached seat to PENDING-but-unscheduled: the attempt
        bump is the heartbeat fence (a surviving ghost of this member gets
        ABORT on its next beat), and the container release reaps the
        process group. Grow-back re-schedules it later."""
        with self.session.lock:
            cid = t.container_id
            t.state = TaskState.PENDING
            t.host, t.port = "", 0
            t.container_id = ""
            t.container_pid = 0
            t.exit_code = None
            t.attempt += 1
            t.last_heartbeat = 0.0
        if cid:
            self.backend.release(cid)

    def _elastic_tick(self) -> None:
        """Per-supervision-tick elastic upkeep: declare grow generations
        for relaunched members that registered, and retry capacity for
        detached seats (throttled)."""
        if not self._elastic_enabled:
            return
        # relaunched member back at the barrier -> it rejoins the
        # membership at the next generation boundary
        for tid in sorted(self._elastic_relaunching):
            t = self.session.tasks.get(tid)
            if t is None or t.state in (TaskState.PENDING, TaskState.ALLOCATED):
                continue
            if t.state in TERMINAL:
                # the relaunch died (or exited) before rejoining: the seat
                # goes back to detached — with its grow lease returned —
                # and the next tick tries again; it must not strand
                # half-promoted or leak a lease per retry
                self._elastic_relaunching.discard(tid)
                self._elastic_return_lease(t)
                self._requeue_detached(t)
                continue
            member = self._elastic_detached.pop(tid, None)
            self._elastic_relaunching.discard(tid)
            if member is None:
                continue
            self._elastic_declare(
                "grow", added=[member], reason=tid, granted_host=t.host,
            )
            self._write_am_state()
        # grow-back: re-lease capacity for seats still out
        if not self._elastic_grow_back:
            return
        waiting = [
            tid for tid in sorted(self._elastic_detached)
            if tid not in self._elastic_relaunching
        ]
        if not waiting:
            return
        now = time.monotonic()
        if now - self._elastic_last_grow < self._elastic_grow_retry_s:
            return
        self._elastic_last_grow = now
        grow = getattr(self.backend, "grow_job_lease", None)
        to_schedule = []
        for tid in waiting:
            t = self.session.tasks.get(tid)
            if t is None:
                continue
            if grow is not None:
                spec = self.specs[t.job_name]
                granted = grow(Resource(spec.memory_mb, spec.cpus, spec.tpu_chips))
                if granted is None:
                    log.info(
                        "elastic grow-back: no capacity for %s yet", tid
                    )
                    continue
            to_schedule.append(tid)
        if not to_schedule:
            return
        tasks_str = ",".join(to_schedule)
        log.warning("elastic grow-back: relaunching %s", tasks_str)
        trace.instant("am.elastic_relaunch", tasks=tasks_str)
        for tid in to_schedule:
            self._elastic_relaunch(tid)

    def _elastic_relaunch(self, tid: str) -> None:
        """Directly allocate ONE detached seat's container (the scheduler's
        schedule_all blocks until NO task is pending, which would wedge on
        sibling seats still waiting for capacity). Dependencies are moot —
        the gang is already running."""
        t = self.session.tasks.get(tid)
        if t is None:
            return
        spec = self.specs[t.job_name]
        req = self._make_request(spec, t.index)
        try:
            container = self.backend.allocate(req)
        except Exception:
            log.warning("elastic relaunch allocate failed for %s", tid,
                        exc_info=True)
            # hand the freshly-grown lease back; the next tick retries
            shrink = getattr(self.backend, "shrink_job_lease", None)
            if shrink is not None:
                shrink(Resource(spec.memory_mb, spec.cpus, spec.tpu_chips))
            return
        with self.session.lock:
            t.state = TaskState.ALLOCATED
            t.container_id = container.container_id
            t.host = container.host
            t.started_at = time.time()
        self._elastic_relaunching.add(tid)
        self._on_allocated(t.job_name, t.index, container, req.log_path)

    def Heartbeat(self, request, context):  # noqa: N802
        alive = self.session.touch(request.job_name, request.index, request.attempt)
        if not alive or self._killed.is_set():
            return pb.HeartbeatResponse(action=pb.HeartbeatResponse.ABORT)
        return pb.HeartbeatResponse(action=pb.HeartbeatResponse.NONE)

    def RegisterExecutionResult(self, request, context):  # noqa: N802
        self._notifications.put(
            ("result", (request.job_name, request.index, request.exit_code, request.attempt))
        )
        return pb.RegisterExecutionResultResponse(acknowledged=True)

    def RegisterTensorBoardUrl(self, request, context):  # noqa: N802
        self.session.tensorboard_url = request.url
        self.events.emit(EventType.METADATA, tensorboard_url=request.url)
        return pb.Empty()

    def PushMetrics(self, request, context):  # noqa: N802
        tid = f"{request.job_name}:{request.index}"
        samples = {s.name: s.value for s in request.samples}
        self._latest_metrics[tid] = samples
        self._record_series(tid, samples)
        # feed the history pipeline so the portal can chart them (the
        # reference embeds utilization in its avro events the same way).
        # samples nest under their own key (names are user-chosen and must
        # not collide with the event envelope), and emission is throttled
        # per task so long jobs don't grow the history file without bound.
        # a task's FIRST step-carrying sample bypasses the throttle: it is
        # the submit->first-step latency timestamp (north-star metric), and
        # a monitor rss sample arriving earlier must not eat its history
        # slot. Later step pushes obey the throttle — the unbounded-history
        # guard stays intact for long jobs.
        now = time.monotonic()
        first_step = "step" in samples and tid not in self._step_metric_seen
        if first_step:
            self._step_metric_seen.add(tid)
        if first_step or (
            now - self._last_metrics_event.get(tid, 0.0)
            >= self._metrics_event_min_interval_s
        ):
            self._last_metrics_event[tid] = now
            self.events.emit(EventType.METRICS, task=tid, samples=samples)
        return pb.Empty()

    def _record_series(self, tid: str, samples: dict[str, float]) -> None:
        """Fleet series aggregation off the existing metrics RPC: keep a
        bounded recent window per task and write the app-level rollup
        (throttled; best-effort — a full disk costs the rollup file, not
        the RPC). Runs on the RPC handler thread; the dict/list ops are
        cheap and the file write is throttled to one per interval."""
        ts = time.time()
        with self._series_lock:
            window = self._series_history.setdefault(tid, [])
            window.append({"ts": ts, **samples})
            if len(window) > 360:
                del window[: len(window) - 360]
            self._series_push_ts[tid] = ts
            now = time.monotonic()
            if (now - self._last_series_rollup
                    < self._series_rollup_min_interval_s):
                return
            self._last_series_rollup = now
        self._write_series_rollup()

    def _write_series_rollup(self) -> None:
        """Atomic ``<app_dir>/series/am_rollup.json``: per-task point
        windows with explicit staleness (age since the last push) — a
        dead host's frozen numbers must read as stale, never current.
        The payload snapshots under the series lock (pure dict copies);
        the file write happens outside it."""
        now = time.time()
        with self._series_lock:
            payload = {
                "ts": now,
                "tasks": {
                    tid: {
                        "last_ts": self._series_push_ts.get(tid, 0.0),
                        "age_s": round(
                            max(now - self._series_push_ts.get(tid, 0.0), 0.0),
                            1,
                        ),
                        "points": list(window)[-120:],
                    }
                    for tid, window in sorted(self._series_history.items())
                },
            }
        out_dir = os.path.join(self.app_dir, "series")
        path = os.path.join(out_dir, "am_rollup.json")
        # two RPC handler threads can race past the throttle: a unique tmp
        # name + atomic replace keeps the visible file whole without
        # holding any lock across file I/O (GL004 discipline)
        tmp = f"{path}.tmp{threading.get_native_id()}"
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            log.debug("could not write series rollup", exc_info=True)

    # --- RPC handlers (client-facing) ----------------------------------------

    def GetTaskInfos(self, request, context):  # noqa: N802
        return pb.GetTaskInfosResponse(tasks=self._task_infos())

    def GetApplicationStatus(self, request, context):  # noqa: N802
        state = self.session.state
        code = 0
        if state in (JobState.SUCCEEDED, JobState.FAILED, JobState.KILLED):
            code = self._client_exit_code()
        return pb.GetApplicationStatusResponse(
            state=state.value,
            exit_code=code,
            diagnostics=self.session.diagnostics,
            tensorboard_url=self.session.tensorboard_url,
            tasks=self._task_infos(),
        )

    def StartProfile(self, request, context):  # noqa: N802
        """Broadcast a bounded profile window to every process of the job
        (`tony profile <app_id>`; docs/OBS.md "Step anatomy"). The channel
        is the shared app dir: the request file lands atomically and each
        armed ProfileController picks it up on its poll — no per-executor
        RPC fan-out, and a worker mid-relaunch still sees the request when
        it arms (requests expire, so a stale one can never re-fire)."""
        steps = max(int(request.steps), 0)
        duration_s = max(float(request.duration_s), 0.0)
        if steps <= 0 and duration_s <= 0:
            return pb.StartProfileResponse(
                accepted=False, message="need steps > 0 or duration_s > 0"
            )
        max_steps = self.config.get_int(Keys.OBS_PROFILE_MAX_STEPS, 64)
        message = ""
        if steps > max_steps:
            message = f"steps clamped {steps} -> {max_steps} (obs.profile.max_steps)"
            steps = max_steps
        req = profile_mod.write_request(
            self.app_dir, steps=steps, duration_s=duration_s
        )
        self.events.emit(
            EventType.METADATA,
            profile_id=req.id, profile_steps=steps,
            profile_duration_s=duration_s,
        )
        trace.instant(
            "am.profile_requested", id=req.id, steps=steps,
            duration_s=duration_s,
        )
        log.info("profile %s broadcast (steps=%d duration_s=%.1f)",
                 req.id, steps, duration_s)
        return pb.StartProfileResponse(
            accepted=True, profile_id=req.id, message=message
        )

    def StopApplication(self, request, context):  # noqa: N802
        log.info("stop requested: %s", request.reason)
        self.session.diagnostics = request.reason or "stopped by client"
        self._killed.set()
        # unblock a schedule_all in flight (e.g. mid gang-restart) so the
        # stop is honoured now, not after allocation completes
        self.scheduler.stop()
        self._notifications.put(("stop", None))
        return pb.Empty()

    def _task_infos(self) -> list[pb.TaskInfo]:
        with self.session.lock:
            return [
                pb.TaskInfo(
                    job_name=t.job_name,
                    index=t.index,
                    host=t.host,
                    port=t.port,
                    state=t.state.value,
                    exit_code=t.exit_code or 0,
                    attempt=t.attempt,
                    log_path=t.log_path,
                )
                for t in self.session.tasks.values()
            ]

    # --- AM fault tolerance (am.retry_count) ---------------------------------

    def _am_state_path(self) -> str:
        return os.path.join(self.app_dir, "am.state.json")

    def _write_am_state(self) -> None:
        """Journal the minimum a successor AM attempt needs: which container
        process groups exist (to reap orphans) and the restart generation
        (so events/metrics stay monotonic across AM attempts)."""
        # refresh pids that were unknown at allocate time (a remote pid can
        # arrive after launch) so the journal never undercounts. The backend
        # query can block (ssh transport on remote backends), so collect the
        # stale tasks under the lock, query OUTSIDE it, write back under it —
        # an RPC handler must never wait on a remote host to touch the
        # session table (GL004 lock-discipline).
        with self.session.lock:
            stale = [
                (t.task_id, t.container_id)
                for t in self.session.tasks.values()
                if t.container_id and not t.container_pid and t.state not in TERMINAL
            ]
        pids = {
            task_id: (cid, self.backend.container_pid(cid))
            for task_id, cid in stale
        }
        with self.session.lock:
            for task_id, (cid, pid) in pids.items():
                t = self.session.tasks.get(task_id)
                # the task may have been restarted (new container) during
                # the unlocked backend query: only record the pid if it
                # still belongs to the container it was queried for
                if (t is not None and not t.container_pid
                        and t.container_id == cid and t.state not in TERMINAL):
                    t.container_pid = pid
            snap = {
                "am_attempt": self.am_attempt,
                "generation": self.session.generation,
                "containers": {
                    t.task_id: {
                        "pid": t.container_pid,
                        "host": t.host,
                        "attempt": t.attempt,
                    }
                    for t in self.session.tasks.values()
                    if t.container_pid
                },
            }
        path = self._am_state_path()
        # the write lock EXISTS to serialize this journal write between the
        # scheduler and supervise threads; holding it across the local file
        # I/O is its whole job, and no hot path ever waits on it
        with self._am_state_write_lock:
            with open(path + ".tmp", "w") as f:  # graft-lint: disable=GL004
                json.dump(snap, f)  # graft-lint: disable=GL004
            os.replace(path + ".tmp", path)  # graft-lint: disable=GL004

    def _recover_from_previous_attempt(self) -> None:
        """Attempt N+1 startup: reap the predecessor's orphaned container
        process groups, then carry the restart generation forward so the whole
        gang relaunches cleanly (fixed-topology barrier-restart semantics —
        the relaunched workers resume from the last checkpoint via the
        checkpoint.dir glue)."""
        try:
            with open(self._am_state_path()) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            return
        for tid, info in snap.get("containers", {}).items():
            pid = int(info.get("pid", 0))
            if pid <= 0:
                continue
            # route through the backend: for remote backends the pid is a
            # process group on another host, not a local one
            self.backend.kill_orphan(str(info.get("host", "")), pid)
            log.warning("reaped orphan container pg %d (%s)", pid, tid)
        with self.session.lock:
            self.session.generation = int(snap.get("generation", 0)) + 1
            # tasks start PENDING at attempt 0 in the fresh table; bump each
            # to one past the journalled attempt so any orphan that survived
            # the kill and still heartbeats is told to ABORT.
            for tid, info in snap.get("containers", {}).items():
                t = self.session.tasks.get(tid)
                if t is not None:
                    t.attempt = int(info.get("attempt", 0)) + 1
        self.events.emit(
            EventType.METADATA,
            am_attempt=self.am_attempt,
            recovered_generation=self.session.generation,
        )
        log.warning(
            "AM attempt %d recovered: generation -> %d",
            self.am_attempt, self.session.generation,
        )

    # --- backend callback ----------------------------------------------------

    def _on_container_completed(self, container: Container, code: int) -> None:
        self._notifications.put(
            ("container", (container.request.task_type, container.request.task_index,
                           container.container_id, code,
                           container.exit_authoritative))
        )

    # --- supervision loop -----------------------------------------------------

    def run(self) -> int:
        """Run the job to completion; returns the client exit code."""
        os.makedirs(os.path.join(self.app_dir, "logs"), exist_ok=True)
        self._run_span = trace.span("am.run", attempt=self.am_attempt)
        token = None
        if self.config.get_bool(Keys.APPLICATION_SECURITY_ENABLED, False):
            from tony_tpu_torch.rpc.auth import read_token

            token = read_token(self.app_dir)
            if not token:
                raise RuntimeError(
                    "application.security.enabled but no app.token staged"
                )
        self._server, self.port = serve(
            self,
            port=self.config.get_int(Keys.AM_RPC_PORT, 0),
            max_workers=max(16, self.config.get_int(Keys.AM_CPUS, 1) * 8),
            token=token,
        )
        # The client discovers the AM address from this file (the YARN
        # application-report analogue).
        addr_path = os.path.join(self.app_dir, "am.addr")
        with open(addr_path + ".tmp", "w") as f:
            f.write(f"{self.backend.am_advertise_host()}:{self.port}")
        os.replace(addr_path + ".tmp", addr_path)
        self.events.emit(
            EventType.APPLICATION_INITED,
            specs={n: s.to_dict() for n, s in self.specs.items()},
            framework=self.config.get_str(Keys.APPLICATION_FRAMEWORK),
            queue=self.config.get_str(Keys.APPLICATION_QUEUE, "default"),
            tags=self.config.get_list(Keys.APPLICATION_TAGS),
        )
        if self.config.get_str(Keys.APPLICATION_FRAMEWORK) == "horovod":
            from tony_tpu_torch.runtime.horovod_driver import RendezvousServer

            self._rendezvous = RendezvousServer().start()
            log.info("horovod gloo rendezvous serving on :%d", self._rendezvous.port)
        self.backend.set_completion_callback(self._on_container_completed)
        self.backend.start()
        self._start_lease_keeper()
        # The AM's own footprint consumes inventory, like a YARN AM container.
        self.backend.reserve(
            Resource(
                self.config.get_int(Keys.AM_MEMORY_MB, 2048),
                self.config.get_int(Keys.AM_CPUS, 1),
                0,
            )
        )
        self.session.state = JobState.RUNNING
        deadline = None
        timeout_s = self.config.get_int(Keys.APPLICATION_TIMEOUT_S, 0)
        if timeout_s > 0:
            deadline = time.monotonic() + timeout_s
        try:
            if self.am_attempt > 0:
                self._recover_from_previous_attempt()
            with trace.span("am.schedule", parent=self._run_span.sid or None,
                            generation=self.session.generation):
                self.scheduler.schedule_all(self.specs)
            if self._elastic_enabled:
                # baseline membership declaration: the record survivors'
                # journals and the post-mortem measure boundaries against
                self._elastic_declare("start")
            self._supervise(deadline)
        except Exception as e:
            log.exception("AM failed")
            self.session.state = JobState.FAILED
            self.session.diagnostics = f"{type(e).__name__}: {e}"
        finally:
            self._teardown()
        code = self._client_exit_code()
        self._write_status(code)
        self._run_span.end(state=self.session.state.value, exit_code=code)
        trace.flush()
        return code

    def _client_exit_code(self) -> int:
        """Exit code for the client, consistent between the status RPC and
        the final status file: task failures propagate their code; jobs
        failed for non-task reasons (timeout, scheduler error) report 1."""
        _, code = self.session.final_status()
        if self.session.state == JobState.KILLED:
            return 143
        if self.session.state == JobState.FAILED and code == 0:
            return 1
        return code

    def _start_lease_keeper(self) -> None:
        """Renew shared-RM lease TTLs from a DEDICATED thread, so that a
        hung store (a hard-mounted shared FS that partitions blocks
        forever in open()/flock, raising nothing) can never stall
        container supervision. The keeper posts a ``fence`` notification
        when renewal reports the leases lost; _supervise additionally
        fences on renewal STALENESS at half the TTL — the keeper being
        silently stuck is exactly the hang case the thread exists for,
        and fencing at ttl/2 keeps the owner ahead of survivors reaping
        at renewed_at + ttl on their own clocks."""
        renew = getattr(self.backend, "renew_leases", None)
        if renew is None:
            return
        self._lease_ttl = getattr(self.backend, "lease_ttl_s", lambda: 0.0)()
        if 0 < self._lease_ttl < 4 * self._heartbeat_interval_s:
            # make_backend clamps config-built stores; this catches
            # directly-constructed backends handed a mismatched pair
            log.warning(
                "lease TTL %.1fs is below 4x the heartbeat interval "
                "(%.2fs): renewal cadence is max(heartbeat, ttl/4), so a "
                "healthy cross-host owner can lapse between renewals and "
                "self-fence",
                self._lease_ttl, self._heartbeat_interval_s,
            )
        self._lease_ok_t = time.monotonic()

        def keeper():
            while not self._lease_keeper_stop.wait(self._heartbeat_interval_s):
                try:
                    ok = renew()
                except Exception:
                    log.exception("lease renewal raised (keeper carries on)")
                    continue
                if ok:
                    self._lease_ok_t = time.monotonic()
                else:
                    self._notifications.put(("fence", None))
                    return

        threading.Thread(target=keeper, daemon=True, name="lease-keeper").start()

    def _supervise(self, deadline: float | None) -> None:
        while True:
            # chaos seam: kill_am fires here (mid-run AM attempt death);
            # the per-point count makes "at supervision tick N" exact
            chaos_hook("am.tick", attempt=self.am_attempt)
            if self._killed.is_set():
                self.session.state = JobState.KILLED
                return
            if deadline is not None and time.monotonic() > deadline:
                self.session.diagnostics = "application timeout"
                self.session.state = JobState.FAILED
                return
            try:
                kind, payload = self._notifications.get(timeout=self._heartbeat_interval_s)
            except queue.Empty:
                kind, payload = "", None
            if kind == "stop":
                self.session.state = JobState.KILLED
                return
            if kind == "result":
                job_name, index, exit_code, attempt = payload
                task = self.session.task(job_name, index)
                if task is not None and attempt == task.attempt:
                    # executor-reported: its process group is exiting now
                    self._finish_task(job_name, index, exit_code, pid_dead=True)
            elif kind == "container":
                job_name, index, cid, code, authoritative = payload
                task = self.session.task(job_name, index)
                # Only meaningful if this is still the task's current
                # container and no result was reported (executor crash).
                if task is not None and task.container_id == cid and task.state not in TERMINAL:
                    self._finish_task(job_name, index, code, pid_dead=authoritative)
            self._check_heartbeats()
            # elastic upkeep: declare grow generations for members back at
            # the barrier, retry capacity for detached seats (throttled)
            self._elastic_tick()
            # Fence when the lease keeper says our leases are GONE, or
            # when it has been silently stuck (hung store) past the TTL:
            # either way survivors may re-lease the chips this job is
            # still running on — stop before that double-books.
            if kind == "fence" or (
                self._lease_ttl
                and time.monotonic() - self._lease_ok_t > self._lease_ttl / 2
            ):
                self.session.diagnostics = (
                    "shared-RM leases lost (TTL-reaped, operator release, "
                    "or store unreachable past the TTL); stopping to avoid "
                    "double-booking"
                )
                # the store is gone or unreachable: teardown must not call
                # release_app against it — the release would block in the
                # same flock the keeper is already hung in and the client
                # would never see this FAILED status (ADVICE round 5)
                fence = getattr(self.backend, "fence_leases", None)
                if fence is not None:
                    fence()
                self.session.state = JobState.FAILED
                return
            if self._apply_failure_policy():
                return
            if self.session.job_done():
                state, _ = self.session.final_status()
                self.session.state = state
                return

    def _finish_task(
        self, job_name: str, index: int, exit_code: int, *, pid_dead: bool = True
    ) -> None:
        self.session.on_task_completed(job_name, index, exit_code)
        t = self.session.task(job_name, index)
        if t is not None and pid_dead:
            # the container process group is provably gone; drop its pid from
            # the journal so a successor AM attempt never kill_orphan()s a
            # recycled pid. When the exit is NOT authoritative (an ssh
            # channel died, code 255), the pid stays journalled: the remote
            # group may still be alive and must remain reapable.
            t.container_pid = 0
        elif t is not None and t.container_pid:
            # best-effort reap NOW, before any restart relaunches on this
            # host — release() can't reach a group whose local channel
            # already exited, and waiting for a future AM attempt would let
            # a live orphan fight the replacement for the TPU devices
            log.warning(
                "non-authoritative exit for %s:%d; killing possible orphan "
                "pg %d on %s", job_name, index, t.container_pid, t.host,
            )
            try:
                self.backend.kill_orphan(t.host, t.container_pid)
            except Exception:
                log.exception("orphan kill failed (pid stays journalled)")
        self.events.emit(
            EventType.TASK_FINISHED,
            task=f"{job_name}:{index}",
            exit_code=exit_code,
            state=t.state.value if t else "",
        )
        self._write_am_state()
        trace.instant(
            "am.task_finished", task=f"{job_name}:{index}", exit_code=exit_code,
        )
        log.info("task %s:%d finished code=%d", job_name, index, exit_code)

    def _check_heartbeats(self) -> None:
        if self._max_missed <= 0:
            return
        cutoff = time.monotonic() - self._heartbeat_interval_s * self._max_missed
        with self.session.lock:
            stale = [
                t
                for t in self.session.tasks.values()
                if t.state in (TaskState.REGISTERED, TaskState.RUNNING)
                and t.last_heartbeat > 0
                and t.last_heartbeat < cutoff
            ]
        for t in stale:
            log.warning("task %s lost (missed heartbeats)", t.task_id)
            trace.instant("am.task_lost", task=t.task_id)
            self.session.on_task_lost(t.job_name, t.index)
            self.events.emit(EventType.TASK_FINISHED, task=t.task_id, state="LOST")
            if t.container_id:
                self.backend.release(t.container_id)
            # container_pid is intentionally KEPT: release() is best-effort
            # (an unreachable host ignores the kill), so a successor AM
            # attempt must still be able to reap this possible orphan.

    def _apply_failure_policy(self) -> bool:
        """Handle failed/lost tracked tasks. Returns True if the job is over."""
        failed = self.session.failed_tasks()
        if not failed:
            return False
        if self._elastic_enabled:
            # elastic-first: a lost member becomes a shrink generation, not
            # a restart — survivors keep training from in-memory state.
            # Whatever elastic cannot absorb (lost trainer, below
            # min_members) falls through to the cold policy below, whole.
            failed = self._elastic_detach(failed)
            if not failed:
                return False
        # chief semantics: a finished chief ends the job regardless of policy
        # — EXCEPT in an elastic job with a restart policy: there the chief
        # IS the trainer, the host most likely to be preempted, and the
        # documented fallback for losing it is the cold restart.policy path
        # (checkpoint resume), not a hard failure (docs/ELASTIC.md)
        if self.session.chief_type and any(
            t.job_name == self.session.chief_type for t in failed
        ):
            if not (self._elastic_enabled and self._restart_policy != "never"):
                self.session.state = JobState.FAILED
                self.session.diagnostics = "chief failed"
                return True
        if self._restart_policy == "never":
            self.session.state = JobState.FAILED
            self.session.diagnostics = (
                f"task(s) failed: {', '.join(t.task_id for t in failed)}"
            )
            return True
        over_budget = [t for t in failed if t.restarts >= self._max_restarts]
        if over_budget:
            self.session.state = JobState.FAILED
            self.session.diagnostics = (
                "restart budget exhausted for "
                + ", ".join(t.task_id for t in over_budget)
            )
            return True
        if self._restart_policy == "gang":
            self._gang_restart()
        elif self._rendezvous is not None:
            # gloo rendezvous is all-or-nothing: surviving ranks never
            # re-announce, so restarting only the failed task would strand
            # it polling forever — escalate to a full gang restart
            log.warning(
                "restart.policy=failed_only escalated to gang for the "
                "horovod rendezvous contract"
            )
            self._gang_restart()
        else:  # failed_only
            self._restart_tasks({t.job_name for t in failed}, only_failed=True)
        return False

    def _gang_restart(self) -> None:
        """Barrier-restart the whole gang (fixed-topology TPU slice semantics).

        Every container is released, every task reset to PENDING with a bumped
        attempt (stale executors get ABORT on their next heartbeat), and the
        scheduler re-launches the full job. User scripts resume from the last
        checkpoint (restart.resume_from_checkpoint glue in the trainer).
        """
        log.warning("gang restart (generation %d)", self.session.generation + 1)
        self.events.emit(EventType.GANG_RESTART, generation=self.session.generation + 1)
        with trace.span("am.gang_restart", parent=self._run_span.sid or None,
                        generation=self.session.generation + 1):
            with self.session.lock:
                cids = [t.container_id for t in self.session.tasks.values() if t.container_id]
            for cid in cids:
                self.backend.release(cid)
            self.session.reset_for_restart(None)
            if self._rendezvous is not None:
                self._rendezvous.clear()  # stale peer info must 404 after restart
            if self._elastic_enabled:
                # the cold path supersedes elastic bookkeeping: every seat
                # relaunches below, so nothing is detached any more — a
                # stale entry would double-allocate the seat on the next
                # grow tick AND exclude a live member from every future
                # generation. Declare a fresh full-membership baseline at
                # the restarted generation so relaunched trainers don't
                # fence on the pre-restart shrink record.
                self._elastic_detached.clear()
                self._elastic_relaunching.clear()
                self._elastic_declare("start", reason="gang restart")
            self._write_am_state()
            self._drain_notifications()
            self.scheduler.schedule_all(self.specs)

    def _restart_tasks(self, job_names: set[str], only_failed: bool) -> None:
        # reset the task table under the lock, release containers OUTSIDE
        # it (release can block on a remote backend, and RPC handlers need
        # the session lock to serve heartbeats meanwhile) — same collect-
        # then-release shape as _gang_restart and _check_heartbeats
        with self.session.lock:
            victims = [
                t
                for t in self.session.tasks.values()
                if t.job_name in job_names
                and (not only_failed or t.state in (TaskState.FAILED, TaskState.LOST))
            ]
            cids = [t.container_id for t in victims if t.container_id]
            for t in victims:
                t.state = TaskState.PENDING
                t.host, t.port = "", 0
                t.container_id = ""
                t.container_pid = 0
                t.exit_code = None
                t.attempt += 1
                t.restarts += 1
                t.last_heartbeat = 0.0
        for cid in cids:
            self.backend.release(cid)
        log.warning("restarting %s", ", ".join(t.task_id for t in victims))
        self._write_am_state()
        self.scheduler.schedule_all(self.specs)

    def _drain_notifications(self) -> None:
        """Drop queued notifications from superseded attempts after a restart."""
        try:
            while True:
                self._notifications.get_nowait()
        except queue.Empty:
            pass

    def _teardown(self) -> None:
        self._lease_keeper_stop.set()
        self.scheduler.stop()
        self.backend.stop()
        if self._rendezvous is not None:
            self._rendezvous.stop()
        self.events.emit(
            EventType.APPLICATION_FINISHED,
            state=self.session.state.value,
            diagnostics=self.session.diagnostics,
        )
        # registry snapshot into the job history (the AM's own counters —
        # served RPCs per method; portal /metrics re-renders it)
        try:
            from tony_tpu_torch.obs.registry import write_snapshot

            proc = f"am_a{self.am_attempt}"
            write_snapshot(
                os.path.join(self.app_dir, "metrics", f"{proc}.json"), proc=proc
            )
        except Exception:
            log.debug("registry snapshot failed", exc_info=True)
        self.events.close()
        # Leave the RPC server up briefly so the client's final status poll
        # lands; the process exits right after run() returns anyway.

    def _write_status(self, code: int) -> None:
        status = {
            "app_id": self.app_id,
            "state": self.session.state.value,
            "exit_code": code,
            "diagnostics": self.session.diagnostics,
            "tensorboard_url": self.session.tensorboard_url,
            "queue": self.config.get_str(Keys.APPLICATION_QUEUE, "default"),
            "tags": self.config.get_list(Keys.APPLICATION_TAGS),
            "tasks": [
                {
                    "task": t.task_id,
                    "state": t.state.value,
                    "exit_code": t.exit_code,
                    "attempts": t.attempt + 1,
                    "log": t.log_path,
                }
                for t in self.session.tasks.values()
            ],
        }
        path = os.path.join(self.app_dir, "status.json")
        with open(path + ".tmp", "w") as f:
            json.dump(status, f, indent=2, sort_keys=True)
        os.replace(path + ".tmp", path)


def main() -> None:
    """AM process entry: ``python -m tony_tpu_torch.am.app_master <app_dir>``."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s AM %(levelname)s %(name)s: %(message)s",
    )
    app_dir = sys.argv[1]
    app_id = os.path.basename(app_dir.rstrip("/"))
    config = TonyConfig.from_json(
        open(os.path.join(app_dir, "config.json")).read()
    )
    # arm fault injection for THIS process only when the job asks for it
    # (chaos.enabled + a schedule); inert otherwise
    from tony_tpu_torch.chaos import install_from_config

    install_from_config(config, role="am")
    am_attempt = int(os.environ.get("TONY_AM_ATTEMPT", "0"))
    # arm the trace spine for THIS process (on by default; trace.enabled
    # false disarms the whole job — container env is derived from this)
    trace.install_from_config(config, app_dir, app_id, proc=f"am_a{am_attempt}")
    am = ApplicationMaster(config, app_id, app_dir, am_attempt=am_attempt)
    code = am.run()
    trace.uninstall()  # flush + close the journal before exit
    # Give the client one status-poll interval to observe the final state.
    time.sleep(1.0)
    if am._server is not None:
        am._server.stop(0.5)
    sys.exit(code)


if __name__ == "__main__":
    main()
