"""Decode-host worker for `tony serve` gangs.

The port's copy of ``tony_tpu/serve/gang.py``. What differs: the engine is
the port's, built on the card unless the worker is started with ``--device
cpu`` (:func:`build_gang_engine` raises without a card, as every entry point
does); ``serve.gang.shard`` is a no-op on one visible card and refused on
more (the port's engine serves on one card); and the worker logs a JSON line
of every kernel wrapper's launch count beside the engine's decode steps each
time its engine drains and at SIGTERM (:func:`main`).

The marriage of the repo's two halves (ROADMAP open item 3): the AM
gang-schedules N containers of this worker — one continuous-batching
:class:`~tony_tpu_torch.serve.engine.Engine` each — and the thin RPC frontend
(serve/frontend.py) routes requests across them. Every host builds the
SAME weights deterministically from ``serve.gang.seed``, so any request
can run (or, after a host death, *re-run*) on any host and, because the
engine gives each request its own rng stream keyed by the frontend's
``rng_seed``, the replay is draw-for-draw identical to the original.

Process shape: the engine is single-threaded by design (one decode step,
host-side admission steering), so one dedicated **engine thread**
owns it exclusively. RPC handler threads never touch the engine; they
talk to the loop through a mailbox (submissions) and per-request output
queues (token streaming) — the same single-decision-maker discipline as
the AM supervision loop (GL004: nothing blocks under a lock; the RPC
seams are the queues).

Lifecycle: the worker binds the exact data port the executor registered
in the cluster spec (``utils.net.bind_with_retry`` closes the
pick-then-bind TOCTOU), serves until the executor forwards SIGTERM (job
teardown / AM abort), then closes the engine — the shutdown summary and
registry snapshot land in the app dir like any serve process. ``Drain``
implements the rolling-restart contract: stop admitting, finish the live
slots (KV state drains naturally as requests complete), optionally
recycle the engine (fresh KV cache) before taking traffic again.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable

from typing import TYPE_CHECKING

from tony_tpu_torch.chaos import chaos_hook
from tony_tpu_torch.config.config import TonyConfig
from tony_tpu_torch.config.keys import Keys
from tony_tpu_torch.obs import trace
from tony_tpu_torch.rpc import ServeRpcServicer, pb, serve_rpc

if TYPE_CHECKING:  # the engine (and torch) load lazily: the executor imports
    from tony_tpu_torch.serve.engine import Engine  # this module via the runtime

log = logging.getLogger(__name__)

# env the serve runtime exports AM -> executor -> worker (runtime/frameworks
# ServeRuntime): the data port this host must serve on, and the serve.gang.*
# key group as JSON so the worker needs no config-file round trip
ENV_SERVE_PORT = "TONY_SERVE_PORT"
ENV_SERVE_GANG = "TONY_SERVE_GANG"


@dataclass(frozen=True)
class GangSettings:
    """Resolved ``serve.gang.*`` key group (docs/SERVE.md "Gang serving")."""

    hosts: int = 2
    job_type: str = "decode"
    model: str = "tiny"
    seed: int = 0
    slots: int = 4
    max_len: int = 0
    max_queue: int = 16
    shard: bool = False
    # chunked prefill (serve.chunk_tokens): prompts longer than this prefill
    # in block-aligned chunks, one per decode step; 0 = whole-prompt prefill
    chunk_tokens: int = 0
    # disaggregated pools (serve.pool.*): when prefill_hosts > 0 the gang is
    # heterogeneous — prefill_hosts containers of prefill_job_type run the
    # prefill pool and ship finished KV blocks to the decode pool
    prefill_hosts: int = 0
    prefill_job_type: str = "prefill"
    handoff_min_tokens: int = 64
    frontend_max_inflight: int = 64
    max_replays: int = 3
    ttft_budget_s: float = 0.0
    drain_timeout_s: float = 30.0
    autoscale_queue_high: int = 0
    autoscale_queue_low: int = 0
    autoscale_window_s: float = 10.0
    # cross-request prefix reuse (serve/prefix.py) + the frontend's
    # prefix-affinity routing over it (serve.prefix.* keys)
    prefix: bool = True
    prefix_budget_mb: float = 64.0
    prefix_affinity: bool = True
    prefix_fingerprint_tokens: int = 64
    # speculative decoding (serve/spec.py; serve.spec.* keys)
    spec: bool = False
    spec_max_draft: int = 4
    spec_draft_source: str = "auto"
    # quantized serving (serve.quant.* keys): block-scaled KV cache and
    # optionally int8 weight-only decode matmuls
    quant: bool = False
    quant_kv_dtype: str = "int8"
    quant_weights: bool = False

    @classmethod
    def from_config(cls, config: TonyConfig) -> "GangSettings":
        return cls(
            hosts=config.get_int(Keys.SERVE_GANG_HOSTS, 2),
            job_type=config.get_str(Keys.SERVE_GANG_JOB_TYPE, "decode"),
            model=config.get_str(Keys.SERVE_GANG_MODEL, "tiny"),
            seed=config.get_int(Keys.SERVE_GANG_SEED, 0),
            slots=config.get_int(Keys.SERVE_GANG_SLOTS, 4),
            max_len=config.get_int(Keys.SERVE_GANG_MAX_LEN, 0),
            max_queue=config.get_int(Keys.SERVE_GANG_MAX_QUEUE, 16),
            shard=config.get_bool(Keys.SERVE_GANG_SHARD, False),
            chunk_tokens=config.get_int(Keys.SERVE_CHUNK_TOKENS, 0),
            prefill_hosts=config.get_int(Keys.SERVE_POOL_PREFILL_HOSTS, 0),
            prefill_job_type=config.get_str(
                Keys.SERVE_POOL_PREFILL_JOB_TYPE, "prefill"
            ),
            handoff_min_tokens=config.get_int(
                Keys.SERVE_POOL_HANDOFF_MIN_TOKENS, 64
            ),
            frontend_max_inflight=config.get_int(
                Keys.SERVE_GANG_MAX_INFLIGHT, 64
            ),
            max_replays=config.get_int(Keys.SERVE_GANG_MAX_REPLAYS, 3),
            ttft_budget_s=config.get_float(Keys.SERVE_GANG_TTFT_BUDGET_S, 0.0),
            drain_timeout_s=config.get_float(
                Keys.SERVE_GANG_DRAIN_TIMEOUT_S, 30.0
            ),
            autoscale_queue_high=config.get_int(
                Keys.SERVE_GANG_AUTOSCALE_HIGH, 0
            ),
            autoscale_queue_low=config.get_int(Keys.SERVE_GANG_AUTOSCALE_LOW, 0),
            autoscale_window_s=config.get_float(
                Keys.SERVE_GANG_AUTOSCALE_WINDOW_S, 10.0
            ),
            prefix=config.get_bool(Keys.SERVE_PREFIX_ENABLED, True),
            prefix_budget_mb=config.get_float(
                Keys.SERVE_PREFIX_BUDGET_MB, 64.0
            ),
            prefix_affinity=config.get_bool(Keys.SERVE_PREFIX_AFFINITY, True),
            prefix_fingerprint_tokens=config.get_int(
                Keys.SERVE_PREFIX_FINGERPRINT_TOKENS, 64
            ),
            spec=config.get_bool(Keys.SERVE_SPEC_ENABLED, False),
            spec_max_draft=config.get_int(Keys.SERVE_SPEC_MAX_DRAFT, 4),
            spec_draft_source=config.get_str(
                Keys.SERVE_SPEC_DRAFT_SOURCE, "auto"
            ),
            quant=config.get_bool(Keys.SERVE_QUANT_ENABLED, False),
            quant_kv_dtype=config.get_str(
                Keys.SERVE_QUANT_KV_DTYPE, "int8"
            ),
            quant_weights=config.get_bool(Keys.SERVE_QUANT_WEIGHTS, False),
        )

    def to_json(self) -> str:
        from dataclasses import asdict

        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "GangSettings":
        return cls(**json.loads(blob))


def build_gang_engine(settings: GangSettings, pool: str = "decode",
                      device: str | None = None) -> "Engine":
    """Deterministic per-host engine: same seed -> same weights on every
    replica, so routing (and replay) is host-agnostic. ``device=None``
    means CUDA and raises without it. ``serve.gang.shard`` is a no-op on
    one visible card; the port's engine has no multi-card path, so with
    more than one visible card it raises (ROADMAP queue 1, item 10)."""
    import torch

    from tony_tpu_torch._device import resolve_device
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.serve.engine import Engine, ServeConfig

    preset = getattr(LlamaConfig, settings.model, None)
    if preset is None or not callable(preset):
        raise ValueError(
            f"serve.gang.model {settings.model!r} is not a LlamaConfig preset"
        )
    dev = resolve_device(device)
    if settings.shard and dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"serve.gang.shard over {torch.cuda.device_count()} visible cards: the "
            "port's engine serves on one card (ROADMAP queue 1, item 10, "
            "\"serve.gang.shard over several cards\"); make one card visible "
            "to each decode host or set serve.gang.shard = false"
        )
    cfg = preset()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(settings.seed), dev)
    return Engine(
        params, cfg,
        ServeConfig(
            slots=settings.slots, max_len=settings.max_len,
            max_queue=settings.max_queue, prefix=settings.prefix,
            prefix_budget_mb=settings.prefix_budget_mb,
            spec=settings.spec, spec_max_draft=settings.spec_max_draft,
            spec_draft_source=settings.spec_draft_source,
            quant_kv=settings.quant_kv_dtype if settings.quant else "",
            quant_weights=settings.quant and settings.quant_weights,
            chunk_tokens=settings.chunk_tokens,
            pool=pool,
        ),
        device=dev,
    )


class DecodeHostService(ServeRpcServicer):
    """ServeRpc surface of one decode host (see module docstring).

    ``engine_factory`` defers engine construction to the engine thread
    (and rebuilds it on a recycling drain), so params/compiles never live
    on an RPC thread.
    """

    # engine-loop idle poll: long enough to sleep an idle host, short
    # enough that a fresh submission starts prefilling promptly
    _IDLE_WAIT_S = 0.05

    # serve-host series cadence over the AM metrics RPC: the fleet rollup
    # and `tony top`'s per-host rows come from these pushes (the same
    # heartbeat-path channel fit() uses), so a decode host is as visible
    # as a trainer
    _PUSH_INTERVAL_S = 2.0

    def __init__(self, engine_factory: Callable[[], Engine], host_id: str,
                 drain_timeout_s: float = 30.0, pool: str = "decode",
                 on_idle: Callable[[Engine], None] | None = None):
        self._engine_factory = engine_factory
        # called on the engine thread each time the engine drains (the
        # first idle poll after a step): the worker logs its kernel counts
        self._on_idle = on_idle
        self.host_id = host_id
        self.pool = pool
        self._drain_timeout_s = drain_timeout_s
        self._mailbox: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._draining = False
        self._started = threading.Event()
        self._start_error: BaseException | None = None
        # stats push AM-ward (obs/reporter.py: bounded queue + daemon
        # drain — an AM stall can never block the engine loop); inert
        # outside a tony job (no TONY_AM_ADDR)
        from tony_tpu_torch.obs.reporter import MetricsReporter

        self._reporter = MetricsReporter()
        self._last_push = 0.0
        # live per-request plumbing, owned by the engine thread; the lock
        # only guards the dict shape (handler threads read membership for
        # stats), never any blocking work
        self._streams_lock = threading.Lock()
        self._streams: dict[int, "_StreamState"] = {}
        self.engine: Engine | None = None
        self._thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="decode-engine"
        )
        self._thread.start()

    # --- engine thread --------------------------------------------------------

    def _engine_loop(self) -> None:
        try:
            self.engine = self._engine_factory()
        except BaseException as e:  # surface build failures to start()
            self._start_error = e
            self._started.set()
            raise
        self._started.set()
        eng = self.engine
        stepped = False
        while not self._stop.is_set():
            eng = self._apply_mailbox(eng)
            with self._streams_lock:
                idle = not self._streams
            if idle and not (eng.queue_depth or eng.n_live):
                # nothing in flight: block on the mailbox instead of
                # spinning the decode step against an empty engine. The
                # stats push still ticks — an IDLE host must read as
                # fresh-and-empty on `tony top`, not as stale
                if stepped and self._on_idle is not None:
                    self._on_idle(eng)
                stepped = False
                self._push_stats(eng)
                try:
                    item = self._mailbox.get(timeout=self._IDLE_WAIT_S)
                except queue.Empty:
                    continue
                eng = self._handle_item(eng, item)
                continue
            eng.step()
            stepped = True
            self._publish(eng)
            self._push_stats(eng)
        eng.close()

    def _push_stats(self, eng: Engine, force: bool = False) -> None:
        """Throttled DecodeStats push to the AM + a series scrape
        (engine thread only). The scrape here is FORCED, not
        stride-counted: this path already ticks at the 2s push throttle,
        and a stride on top of it would let an idle-but-healthy host's
        journal age past `tony top`'s stale threshold (stride x
        throttle = ~32s > 30s) — an idle host must read as
        fresh-and-empty, never as stale."""
        now = time.monotonic()
        if not force and now - self._last_push < self._PUSH_INTERVAL_S:
            return
        self._last_push = now
        from tony_tpu_torch.obs import series

        recorder = series.active_recorder()
        if recorder is not None:
            recorder.force_sample()
        if self._reporter.active:
            self._reporter.push(eng.stats_snapshot())

    def _apply_mailbox(self, eng: Engine) -> Engine:
        while True:
            try:
                item = self._mailbox.get_nowait()
            except queue.Empty:
                return eng
            eng = self._handle_item(eng, item)

    def _handle_item(self, eng: Engine, item: tuple) -> Engine:
        from tony_tpu_torch.serve.engine import AdmissionRejected

        kind = item[0]
        if kind == "submit":
            _, req, stream = item
            try:
                erid = eng.submit(req)
            except AdmissionRejected as e:
                stream.reject("rejected", str(e))
                return eng
            except ValueError as e:
                # oversized prompt/budget: deterministic — the same request
                # fails on every host, so the frontend must not retry it
                stream.reject("invalid", str(e))
                return eng
            with self._streams_lock:
                self._streams[erid] = stream
        elif kind == "recycle":
            _, done = item
            log.warning("%s: recycling engine (fresh KV state)", self.host_id)
            eng.close()
            self.engine = eng = self._engine_factory()
            done.set()
        elif kind == "call":
            # generic engine-thread closure (handoff export/adopt): the RPC
            # handler blocks on `res`, the engine stays single-threaded
            _, fn, res = item
            try:
                res.put(("ok", fn(eng)))
            except BaseException as e:
                res.put(("err", e))
        return eng

    def _call_on_engine(self, fn, timeout_s: float = 120.0):
        """Run ``fn(engine)`` on the engine thread; raise what it raises.
        Handler-thread side of the "call" mailbox op."""
        res: queue.Queue = queue.Queue()
        self._mailbox.put(("call", fn, res))
        try:
            kind, val = res.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError("engine call timed out") from None
        if kind == "err":
            raise val
        return val

    def _publish(self, eng: Engine) -> None:
        """Push newly decoded tokens to each live stream; close finished
        ones. Runs on the engine thread right after each step."""
        with self._streams_lock:
            live = list(self._streams.items())
        finished = []
        for erid, stream in live:
            comp = eng.completion_of(erid)
            if comp is None:
                continue
            stream.push(comp)
            if comp.finish_reason:
                finished.append(erid)
        if finished:
            for erid in finished:
                eng.take_completion(erid)
            with self._streams_lock:
                for erid in finished:
                    self._streams.pop(erid, None)

    # --- RPC handlers (run on server threads; engine untouched) ---------------

    def start(self, timeout_s: float = 120.0) -> None:
        """Block until the engine thread built its engine (or raise its
        build error) — callers bind the RPC port first, so registration
        order stays executor-driven."""
        if not self._started.wait(timeout_s):
            raise TimeoutError("engine build did not finish in time")
        if self._start_error is not None:
            raise RuntimeError(
                f"engine build failed: {self._start_error!r}"
            ) from self._start_error

    def Generate(self, request, context):  # noqa: N802 (rpc casing)
        if self._draining or self._stop.is_set():
            yield pb.TokenChunk(
                rid=request.rid, done=True, finish_reason="draining",
                message=f"{self.host_id} is draining",
            )
            return
        from tony_tpu_torch.serve.engine import Request

        req = Request(
            prompt=list(request.prompt),
            max_new_tokens=request.max_new_tokens or 32,
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            eos_id=request.eos_id if request.eos_id >= 0 else None,
            rng=int(request.rng_seed),
        )
        # request.skip_tokens is deliberately ignored: the frontend always
        # replays the FULL stream so it can verify the regenerated prefix
        # against what it already delivered (the replay_consistent
        # evidence) — resume-without-verify would silently skip that check
        stream = _StreamState(request.rid)
        self._mailbox.put(("submit", req, stream))
        yield from stream.chunks(context)

    def DecodeStats(self, request, context):  # noqa: N802
        eng = self.engine
        with self._streams_lock:
            streaming = len(self._streams)
        pending = self._mailbox.qsize()
        if eng is None:
            return pb.DecodeStatsResponse(
                host_id=self.host_id, draining=self._draining,
                in_flight=pending, pool=self.pool,
            )
        # ONE stats surface (Engine.stats_snapshot): the RPC, the series
        # recorder, and the AM push all read the same snapshot — the RPC
        # never walks private engine state
        snap = eng.stats_snapshot()
        return pb.DecodeStatsResponse(
            host_id=self.host_id,
            slots=int(snap["slots"]),
            live_slots=int(snap["live_slots"]),
            queue_depth=int(snap["queue_depth"]) + pending,
            in_flight=streaming + pending,
            generated_tokens=int(snap["generated_tokens"]),
            rejected_total=int(snap["rejected_total"]),
            draining=self._draining,
            occupancy=snap["occupancy"],
            pool=self.pool,
        )

    def Prefill(self, request, context):  # noqa: N802
        """Disaggregated-prefill entry (frontend -> prefill host): run the
        prompt's prefill here, then ship the finished full blocks to the
        decode host named in ``request.target`` via ShipBlocks. The 1-token
        Generate both executes the prefill and registers the prompt in this
        host's prefix store, which is what export reads."""
        t0 = time.monotonic()
        if self._draining or self._stop.is_set():
            return pb.PrefillResponse(
                ok=False, message=f"{self.host_id} is draining"
            )
        from tony_tpu_torch.serve.engine import Request

        req = Request(
            prompt=list(request.prompt), max_new_tokens=1,
            rng=int(request.rng_seed),
        )
        stream = _StreamState(request.rid)
        self._mailbox.put(("submit", req, stream))
        for chunk in stream.chunks(context):
            if chunk.done and chunk.finish_reason not in ("eos", "length"):
                return pb.PrefillResponse(
                    ok=False,
                    message=chunk.message or chunk.finish_reason,
                )
            if chunk.done:
                break
        out = self._call_on_engine(
            lambda eng: eng.export_prefix_blocks(list(request.prompt))
        )
        if out is None:
            return pb.PrefillResponse(
                ok=False, message="no full blocks to ship"
            )
        covered, payload = out
        from tony_tpu_torch.serve.cache import pack_payload

        packed = pack_payload(payload)
        ship = pb.ShipBlocksRequest(
            rid=request.rid, src_host=self.host_id, tokens=list(covered),
            n_blocks=payload.n_blocks, block=int(payload.k.shape[3]),
            dtype=packed["dtype"], shape=packed["shape"],
            k=packed["k"], v=packed["v"],
            k_scale=packed.get("k_scale", b""),
            v_scale=packed.get("v_scale", b""),
        )
        # chaos seam: a fault here (die/hang) models a prefill host lost
        # mid-handoff — blocks exported but never adopted by the target
        chaos_hook("serve.handoff", rid=request.rid, target=request.target)
        from tony_tpu_torch.rpc.service import ServeRpcClient

        try:
            with ServeRpcClient(request.target) as cli:
                resp = cli.ship_blocks(ship)
        except Exception as e:
            return pb.PrefillResponse(
                ok=False, shipped=payload.n_blocks,
                bytes=payload.nbytes,
                ms=(time.monotonic() - t0) * 1e3,
                message=f"ship to {request.target} failed: {e}",
            )
        return pb.PrefillResponse(
            ok=resp.ok, shipped=payload.n_blocks, adopted=resp.adopted,
            freed=resp.freed, bytes=payload.nbytes,
            ms=(time.monotonic() - t0) * 1e3, message=resp.message,
        )

    def ShipBlocks(self, request, context):  # noqa: N802
        """Adopt a shipped block payload into this host's pool + prefix
        store (decode side of the handoff). Malformed or mismatched
        payloads are refused — never adopted as garbage."""
        from tony_tpu_torch.serve.cache import unpack_payload

        try:
            payload = unpack_payload(
                bytes(request.k), bytes(request.v), list(request.shape),
                request.dtype, bytes(request.k_scale), bytes(request.v_scale),
            )
        except ValueError as e:
            return pb.ShipBlocksResponse(ok=False, message=str(e))
        toks = [int(t) for t in request.tokens]
        try:
            adopted, freed = self._call_on_engine(
                lambda eng: eng.adopt_blocks(toks, payload)
            )
        except (ValueError, RuntimeError) as e:
            return pb.ShipBlocksResponse(ok=False, message=str(e))
        trace.instant(
            "serve.adopt", host=self.host_id, rid=request.rid,
            src=request.src_host, adopted=adopted, freed=freed,
        )
        return pb.ShipBlocksResponse(ok=True, adopted=adopted, freed=freed)

    def Drain(self, request, context):  # noqa: N802
        """Rolling-restart seam: stop admitting, let live slots finish
        (the KV state drains as requests complete), optionally recycle the
        engine, then return to service."""
        timeout_s = max(request.timeout_s or self._drain_timeout_s, 0.1)
        log.warning("%s: drain requested (timeout %.1fs, recycle=%s)",
                    self.host_id, timeout_s, request.recycle)
        self._draining = True
        trace.instant("serve.drain", host=self.host_id, recycle=request.recycle)
        deadline = time.monotonic() + timeout_s
        try:
            while time.monotonic() < deadline:
                with self._streams_lock:
                    streaming = len(self._streams)
                if streaming == 0 and self._mailbox.qsize() == 0:
                    break
                time.sleep(self._IDLE_WAIT_S)
            with self._streams_lock:
                remaining = len(self._streams)
            drained = remaining == 0 and self._mailbox.qsize() == 0
            if drained and request.recycle and not self._stop.is_set():
                done = threading.Event()
                self._mailbox.put(("recycle", done))
                drained = done.wait(timeout=max(deadline - time.monotonic(), 60.0))
        finally:
            self._draining = False
        return pb.DrainResponse(drained=drained, remaining=remaining)

    def shutdown(self) -> None:
        self._stop.set()
        with self._streams_lock:
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            s.reject("error", "host shutting down")
        self._thread.join(timeout=30.0)
        self._reporter.close(timeout=2.0)


class _StreamState:
    """Bridge between the engine thread (producer) and one Generate RPC
    handler (consumer): tokens flow through a queue."""

    def __init__(self, rid: str):
        self.rid = rid
        self._sent = 0
        self._q: queue.Queue = queue.Queue()

    # producer side (engine thread)
    def push(self, comp) -> None:
        toks = comp.tokens[self._sent:]
        if toks:
            self._sent += len(toks)
            self._q.put(("tokens", list(toks), comp.prompt_len))
        if comp.finish_reason:
            self._q.put(("done", comp.finish_reason, comp.prompt_len))

    def reject(self, reason: str, message: str) -> None:
        self._q.put(("end", reason, message))

    # consumer side (RPC handler thread)
    def chunks(self, context):
        while True:
            try:
                item = self._q.get(timeout=300.0)
            except queue.Empty:
                yield pb.TokenChunk(
                    rid=self.rid, done=True, finish_reason="error",
                    message="decode stalled (no tokens for 300s)",
                )
                return
            kind = item[0]
            if kind == "tokens":
                _, toks, plen = item
                yield pb.TokenChunk(rid=self.rid, tokens=toks, prompt_len=plen)
            elif kind == "done":
                _, reason, plen = item
                yield pb.TokenChunk(
                    rid=self.rid, done=True, finish_reason=reason,
                    prompt_len=plen,
                )
                return
            else:  # "end": rejected / shutdown
                _, reason, message = item
                yield pb.TokenChunk(
                    rid=self.rid, done=True, finish_reason=reason,
                    message=message,
                )
                return


def _own_port() -> int:
    """The data port this host must serve on: the executor reserved it,
    registered it with the AM, and the serve runtime exported it — the
    frontend discovers us through the AM's task table at exactly this
    port, so serving anywhere else is serving nowhere."""
    port = os.environ.get(ENV_SERVE_PORT, "")
    if port:
        return int(port)
    spec = json.loads(os.environ.get("TONY_CLUSTER_SPEC", "{}"))
    job = os.environ.get("TONY_JOB_NAME", "")
    idx = int(os.environ.get("TONY_TASK_INDEX", "0"))
    try:
        return int(spec[job][idx].rpartition(":")[2])
    except (KeyError, IndexError, ValueError):
        return 0


def _load_settings() -> GangSettings:
    blob = os.environ.get(ENV_SERVE_GANG, "")
    if blob:
        return GangSettings.from_json(blob)
    app_dir = os.environ.get("TONY_APP_DIR", "")
    with open(os.path.join(app_dir, "config.json")) as f:
        return GangSettings.from_config(TonyConfig.from_json(f.read()))


class _KernelCounts:
    """The worker's kernel accounting: every kernel wrapper's launch count
    (process-wide) beside the decode steps of every engine this host built
    (a recycling drain builds a fresh one), as one JSON line in the task's
    log. chip_smoke holds the launches to the steps."""

    MODULES = ("attention", "decode_attention", "fused_ce", "grouped_mm",
               "quant_mm", "overlap")

    def __init__(self, host_id: str):
        self.host_id = host_id
        self._closed_steps = 0
        self._engine: Engine | None = None

    def track(self, eng: Engine) -> Engine:
        if self._engine is not None:
            self._closed_steps += self._engine.metrics.decode_steps
        self._engine = eng
        return eng

    def log_line(self, reason: str) -> None:
        import importlib

        launches: dict[str, int] = {}
        for name in self.MODULES:
            mod = importlib.import_module(f"tony_tpu_torch.ops.{name}")
            launches.update(mod.LAUNCHES)
        steps = self._closed_steps + (
            self._engine.metrics.decode_steps if self._engine is not None else 0
        )
        # one write: print() writes the line and its newline apart, and a log
        # record of another thread could land between them
        line = json.dumps({"host": self.host_id, "at": reason, "decode_steps": steps,
                           "launches": launches})
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def main(argv: list[str] | None = None) -> int:
    """Worker entry: ``python -m tony_tpu_torch.serve.gang [--device cpu]``
    inside a container; the engine is built on the card unless ``--device``
    says otherwise."""
    p = argparse.ArgumentParser(prog="python -m tony_tpu_torch.serve.gang")
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s SERVE %(levelname)s %(name)s: %(message)s",
    )
    trace.install_from_env()
    # arm the coordinated-profiling watcher BEFORE the engine builds (model
    # init can take a while): a `tony profile` broadcast issued meanwhile is
    # picked up the moment decode steps start
    from tony_tpu_torch.obs import profile

    profile.install_from_env()
    settings = _load_settings()
    job_name = os.environ.get("TONY_JOB_NAME", settings.job_type)
    host_id = f"{job_name}:{os.environ.get('TONY_TASK_INDEX', '0')}"
    # pool membership comes from the container's task type: a heterogeneous
    # gang launches prefill_job_type containers next to decode ones, and the
    # same worker binary serves either side of the handoff
    pool = "prefill" if job_name == settings.prefill_job_type else "decode"
    # the engine module loads here, before the RPC server answers: a
    # Generate handler importing it while the engine thread imports the
    # model would meet the models/serve import cycle half-initialized
    import tony_tpu_torch.serve.engine  # noqa: F401

    counts = _KernelCounts(host_id)
    service = DecodeHostService(
        lambda: counts.track(build_gang_engine(settings, pool=pool, device=args.device)),
        host_id, drain_timeout_s=settings.drain_timeout_s, pool=pool,
        on_idle=lambda eng: counts.log_line("idle"),
    )
    port = _own_port()
    with trace.span("serve.host_start", host=host_id, port=port):
        # the registered port is load-bearing (see _own_port); bounded
        # bind-with-retry rides out TIME_WAIT from a recycled predecessor
        server, bound = serve_rpc(service, port=port, bind_attempts=8)
        service.start()
    log.info("%s serving on :%d (model=%s slots=%d shard=%s device=%s)",
             host_id, bound, settings.model, settings.slots, settings.shard,
             service.engine.device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    log.info("%s: SIGTERM — draining and shutting down", host_id)
    service.shutdown()
    counts.log_line("sigterm")
    server.stop(grace=1.0).wait(timeout=5.0)
    trace.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
