"""Gang-serving frontend: admission, routing, replay, rolling restart.

The port's copy of ``tony_tpu/serve/frontend.py``, as it is there: it routes
over the ServeRpc wire, so its hosts may be the port's decode hosts or the
reference's, and it imports neither torch nor numpy (payloads cross as
bytes between the hosts).

The thin RPC frontend of a `tony serve` job (docs/SERVE.md "Gang
serving"). It discovers the decode hosts through the AM's task table (the
same GetTaskInfos the CLI uses), routes each request to the least-loaded
live host (keyed on the hosts' live ``DecodeStats``: slot occupancy +
queue depth), relays the token stream back, and owns the failure
semantics the gang exists for:

- **Bounded admission.** At ``serve.gang.frontend_max_inflight`` requests
  in flight, submit() rejects explicitly (``tony_serve_rejected_total``
  on the frontend registry) — backpressure propagates to the caller, it
  is never buried in a queue. Host-side rejections (the engine's
  ``max_queue`` seam) reroute to another host.
- **Prefix-affinity routing.** Requests sharing a prefix fingerprint
  (the leading ``serve.prefix.fingerprint_tokens`` tokens) route to the
  host whose prefix store already holds that prefix — the store is
  per-host, so scattering same-template traffic across the gang would
  re-prefill the prefix once per host instead of once per fleet. The
  affinity host is only *preferred*: dead, draining, excluded-by-replay,
  or clearly overloaded hosts fall back to least-loaded (and the
  fingerprint re-pins to wherever the request lands). Replay-on-host-
  death stays draw-for-draw identical — affinity changes WHERE a request
  runs, never its rng stream or sampling.
- **No request lost.** A decode host that dies mid-stream fails its
  relays with an RPC error; each such request is *re-queued* and
  *re-prefilled* on a survivor. Replay is draw-for-draw deterministic —
  every host builds identical weights from ``serve.gang.seed`` and the
  frontend assigns each request its ``rng_seed`` — so the frontend
  replays the FULL stream, verifies the regenerated prefix matches what
  it already delivered (``replay_consistent``, the evidence the
  ``serve-no-request-lost`` chaos invariant checks), and continues from
  the tail. The replay rides a ``serve.reprefill`` span parented on the
  original ``serve.request`` span, so the merged trace shows the
  recovery hanging off the request it rescued.
- **Rolling restart.** ``rolling_restart()`` drains hosts one at a time
  (stop admitting, live slots finish, KV state drains, engine recycles)
  while the rest keep serving.
- **Autoscale hooks.** Sustained aggregate queue depth feeds
  :class:`AutoscalePolicy`; with a lease store attached, a grow/shrink
  decision adjusts the job's gang reservation via
  ``LeaseStore.grow_gang``/``shrink_gang``.

Lock discipline (GL004): ``_lock`` guards the host/request tables only.
Every RPC, sleep, and queue wait happens outside it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import grpc

from tony_tpu_torch.obs import series, trace
from tony_tpu_torch.obs.registry import Registry, write_snapshot
from tony_tpu_torch.rpc import ApplicationRpcClient, ServeRpcClient, pb
from tony_tpu_torch.serve.gang import GangSettings
from tony_tpu_torch.serve.prefix import fingerprint

log = logging.getLogger(__name__)


@dataclass
class GangCompletion:
    """What the frontend hands back per request (the gang-level analogue
    of engine.Completion, plus the recovery evidence)."""

    rid: str
    tokens: list[int] = field(default_factory=list)
    prompt_len: int = 0
    finish_reason: str = ""   # eos | length | rejected | error
    message: str = ""
    ttft_s: float = 0.0
    replays: int = 0
    replay_consistent: bool = True
    hosts: list[str] = field(default_factory=list)


class FrontendRejected(RuntimeError):
    """submit() refused: the gang is at frontend_max_inflight."""


class AutoscalePolicy:
    """Grow/shrink decisions from sustained queue depth, tracked PER POOL.

    ``observe()`` returns "grow" once a pool's depth has stayed at or
    above ``high`` for ``window_s`` continuously, "shrink" once it has
    stayed at or below ``low`` for the window, else None. Each decision
    resets that pool's window, so a persistent overload emits one grow
    per window — paced, not a thundering herd. Every ``pool`` (task
    type) gets its OWN window state: a saturated prefill pool grows
    without the decode pool's idle queue masking it, and vice versa.
    Callers that predate pools omit ``pool`` and get the single default
    window — the old gang-wide behavior. ``high`` <= 0 disables the
    policy.
    """

    def __init__(self, high: int, low: int, window_s: float):
        self.high = int(high)
        self.low = int(low)
        self.window_s = float(window_s)
        # pool -> [above_since, below_since] window state
        self._windows: dict[str, list[float | None]] = {}

    def observe(
        self, queue_depth: int, now: float | None = None,
        pool: str = "decode",
    ) -> str | None:
        if self.high <= 0:
            return None
        now = time.monotonic() if now is None else now
        w = self._windows.setdefault(pool, [None, None])
        if queue_depth >= self.high:
            w[1] = None
            if w[0] is None:
                w[0] = now
            elif now - w[0] >= self.window_s:
                w[0] = None
                return "grow"
        elif queue_depth <= self.low:
            w[0] = None
            if w[1] is None:
                w[1] = now
            elif now - w[1] >= self.window_s:
                w[1] = None
                return "shrink"
        else:
            w[0] = w[1] = None
        return None


@dataclass
class _Host:
    task_id: str
    address: str
    attempt: int
    client: ServeRpcClient
    stats: "pb.DecodeStatsResponse | None" = None
    assigned: int = 0        # frontend-routed, not yet finished there
    dead: bool = False
    draining: bool = False
    pool: str = "decode"     # "decode" | "prefill" (task type's pool)

    def load(self) -> float:
        """Routing key: the host's own in-flight view when fresh, plus
        what this frontend has routed but the stats poll has not seen."""
        base = self.stats.in_flight + self.stats.live_slots if self.stats else 0
        return base + self.assigned


class _Flight:
    """One in-flight request's frontend state + its relay thread plumbing."""

    def __init__(self, rid: str, req: "pb.InferenceRequest", span,
                 fp: int | None = None):
        self.rid = rid
        self.req = req
        self.span = span          # serve.request, open until completion
        self.fp = fp              # prefix-affinity fingerprint (or None)
        self.submit_t = time.perf_counter()
        self.result = GangCompletion(rid=rid)
        self.done = threading.Event()
        self.handoff_tried = False  # one handoff per request, never on replay


class GangFrontend:
    """See module docstring. One instance per serve job; ``close()``
    writes the request ledger the chaos invariants audit."""

    STATS_INTERVAL_S = 0.25
    NO_HOST_WAIT_S = 0.25
    # bounded patience for "no routable host": covers an AM relaunching a
    # failed decode task; beyond it the request errs out visibly
    NO_HOST_TIMEOUT_S = 60.0
    # how long an errored (task_id, address, attempt) entry stays barred
    # from rediscovery: the AM's task table keeps showing the DEAD
    # incarnation as RUNNING until the relaunch lands, and re-adding it
    # would bounce every route off a refused connection. The relaunched
    # incarnation (new attempt/port) is never barred; after the TTL a
    # transiently-unreachable live host gets retried.
    TOMBSTONE_TTL_S = 10.0

    def __init__(
        self,
        am_addr: str,
        settings: GangSettings | None = None,
        *,
        app_dir: str = "",
        token: str | None = None,
        proc: str = "frontend",
        lease_store=None,
        app_id: str = "",
        grow_ask=None,
        grow_asks: dict | None = None,
    ):
        self.settings = settings or GangSettings()
        self.app_dir = app_dir
        self.proc = proc
        # "" = static mode: no AM discovery; hosts come from add_host()
        self._am = ApplicationRpcClient(am_addr, token=token) if am_addr else None
        self._token = token
        self._lock = threading.Lock()
        self._hosts: dict[str, _Host] = {}
        # errored incarnations barred from rediscovery until expiry:
        # (task_id, address, attempt) -> monotonic expiry
        self._tombstones: dict[tuple[str, str, int], float] = {}
        self._flights: dict[str, _Flight] = {}
        # finished, not yet collected via result(); collection evicts so a
        # long-lived frontend holds only what callers have not read
        self._results: dict[str, GangCompletion] = {}
        self._done_events: dict[str, threading.Event] = {}
        self._ledger: list[dict] = []
        self._seq = 0
        self._closed = threading.Event()
        self.registry = Registry()
        self._c_submitted = self.registry.counter(
            "tony_serve_requests_total", "requests accepted by the frontend")
        self._c_rejected = self.registry.counter(
            "tony_serve_rejected_total",
            "requests rejected by frontend bounded admission")
        self._c_replays = self.registry.counter(
            "tony_serve_replays_total",
            "re-queued + re-prefilled requests after a host death")
        self._c_affinity = self.registry.counter(
            "tony_serve_affinity_routed_total",
            "requests routed to their prefix-affinity host")
        self._g_hosts = self.registry.gauge(
            "tony_serve_gang_hosts", "routable decode hosts")
        self._g_inflight = self.registry.gauge(
            "tony_serve_frontend_inflight", "requests in flight at the frontend")
        self._h_ttft = self.registry.histogram(
            "tony_ttft_seconds", "submit -> first relayed token (gang-level)")
        self.autoscaler = AutoscalePolicy(
            self.settings.autoscale_queue_high,
            self.settings.autoscale_queue_low,
            self.settings.autoscale_window_s,
        )
        self._lease_store = lease_store
        self._app_id = app_id
        # prefix-affinity map: fingerprint -> task_id of the host whose
        # store holds that prefix (bounded LRU; guarded by _lock)
        self._affinity: OrderedDict[int, str] = OrderedDict()
        self._affinity_cap = 4096
        # the GangAsk one more host of each pool costs — the REAL container
        # resources (memory/cpus/tpu_chips of that pool's task type), or a
        # grow that leases a token ask would leave the new host's chips
        # looking free to every other job in the store (double-booking).
        # ``grow_asks`` keys by pool; the legacy ``grow_ask`` is the decode
        # pool's (a heterogeneous ask must never grow the wrong pool)
        self._grow_asks: dict = dict(grow_asks or {})
        if grow_ask is not None:
            self._grow_asks.setdefault("decode", grow_ask)
        self.autoscale_actions: list[tuple[str, str]] = []  # (action, detail)
        # blockwise KV handoff records (prefill -> decode), audited by the
        # handoff-no-block-leak chaos invariant via the ledger
        self._handoffs: list[dict] = []
        self._c_handoffs = self.registry.counter(
            "tony_serve_handoffs_total",
            "completed prefill->decode block handoffs")
        self._depth_by_pool: dict[str, int] = {}
        # gang-level live series (obs/series.py): the frontend publishes
        # fleet aggregates — routable hosts, summed queue depth, inflight,
        # windowed gang TTFT — as a scrape source; the stats loop is its
        # sampling cadence (the frontend has no step loop)
        self._fleet_depth = 0
        self._series = series.active_recorder()
        self._series_key = f"frontend@{id(self):x}"
        if self._series is not None:
            from tony_tpu_torch.obs.registry import HistogramWindow

            self._ttft_window = HistogramWindow()
            self._series.attach(self._series_key, self._series_source)
        self._stats_thread = threading.Thread(
            target=self._stats_loop, daemon=True, name="frontend-stats"
        )
        self._stats_thread.start()

    def _series_source(self) -> dict:
        out = {
            "gang_hosts": float(self._g_hosts.value),
            "queue_depth": float(self._fleet_depth),
            "inflight": float(self._g_inflight.value),
            "requests_total": float(self._c_submitted.value),
            "replays_total": float(self._c_replays.value),
            "rejected_total": float(self._c_rejected.value),
            "affinity_routed_total": float(self._c_affinity.value),
        }
        d = self._ttft_window.delta(self._h_ttft)
        if d["count"]:
            out["ttft_p50_s"] = round(d["p50"], 4)
            out["ttft_p99_s"] = round(d["p99"], 4)
            out["ttft_n"] = d["count"]
        # per-pool depth rollup (disaggregated gangs): the pool label rides
        # the series key, so portal/`tony top` can split the queues
        for pool, depth in self._depth_by_pool.items():
            out[f"queue_depth_{pool}"] = float(depth)
        if self._handoffs:
            out["handoffs_total"] = float(self._c_handoffs.value)
        return out

    # --- discovery / stats ----------------------------------------------------

    def add_host(self, task_id: str, address: str, attempt: int = 0,
                 pool: str = "decode") -> None:
        """Register a host explicitly (static deployments / tests);
        AM-discovered jobs never need this."""
        h = _Host(task_id, address, attempt,
                  ServeRpcClient(address, token=self._token), pool=pool)
        with self._lock:
            self._hosts[task_id] = h

    def refresh_hosts(self) -> int:
        """Sync the host table with the AM's task view. Returns the number
        of routable (live, non-draining) hosts."""
        if self._am is None:
            return self._routable_count()
        try:
            infos = self._am.get_task_infos().tasks
        except grpc.RpcError:
            return self._routable_count()
        # task type -> pool: a disaggregated gang contributes two types
        # (decode + prefill), a classic gang just the decode one
        pool_types = {self.settings.job_type: "decode"}
        if self.settings.prefill_hosts > 0:
            pool_types[self.settings.prefill_job_type] = "prefill"
        seen: dict[str, tuple[str, int, str]] = {}
        now = time.monotonic()
        with self._lock:
            self._tombstones = {
                k: exp for k, exp in self._tombstones.items() if exp > now
            }
            tombstoned = set(self._tombstones)
        for t in infos:
            if t.job_name not in pool_types or t.port <= 0:
                continue
            if t.state not in ("REGISTERED", "RUNNING"):
                continue
            task_id = f"{t.job_name}:{t.index}"
            address = f"{t.host}:{t.port}"
            if (task_id, address, t.attempt) in tombstoned:
                continue  # the dead incarnation the AM has not replaced yet
            seen[task_id] = (address, t.attempt, pool_types[t.job_name])
        stale: list[_Host] = []
        with self._lock:
            for task_id, h in list(self._hosts.items()):
                cur = seen.get(task_id)
                if cur is None or cur[:2] != (h.address, h.attempt):
                    # gone, restarted (new attempt), or moved: retire it —
                    # its relays fail over on their next RPC error
                    h.dead = True
                    stale.append(self._hosts.pop(task_id))
            known = set(self._hosts)
        for task_id, (address, attempt, pool) in seen.items():
            if task_id in known:
                continue
            h = _Host(
                task_id, address, attempt,
                ServeRpcClient(address, token=self._token), pool=pool,
            )
            with self._lock:
                self._hosts[task_id] = h
        for h in stale:
            try:
                h.client.close()
            except Exception:
                pass
        return self._routable_count()

    def _routable_count(self) -> int:
        with self._lock:
            return sum(
                1 for h in self._hosts.values() if not (h.dead or h.draining)
            )

    def wait_ready(self, n_hosts: int | None = None, timeout_s: float = 180.0) -> int:
        """Block until ``n_hosts`` (default: the configured gang size,
        both pools) hosts answer DecodeStats. Raises TimeoutError
        otherwise."""
        want = n_hosts or (
            self.settings.hosts + max(self.settings.prefill_hosts, 0)
        )
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.refresh_hosts()
            ready = 0
            for h in self._snapshot_hosts():
                try:
                    h.stats = h.client.decode_stats(timeout_s=2.0)
                    ready += 1
                except grpc.RpcError:
                    pass
            if ready >= want:
                self._g_hosts.set(ready)
                return ready
            time.sleep(0.25)
        raise TimeoutError(
            f"only {self._routable_count()} of {want} decode hosts became "
            f"reachable within {timeout_s:.0f}s"
        )

    def _snapshot_hosts(self) -> list[_Host]:
        with self._lock:
            return [h for h in self._hosts.values() if not h.dead]

    def _stats_loop(self) -> None:
        """Background poll: host discovery + per-host DecodeStats (the
        routing signal) + the autoscale policy tick. All RPCs outside the
        table lock."""
        while not self._closed.wait(self.STATS_INTERVAL_S):
            self.refresh_hosts()
            depth = 0
            by_pool: dict[str, int] = {}
            for h in self._snapshot_hosts():
                try:
                    h.stats = h.client.decode_stats(timeout_s=2.0)
                    h.draining = h.stats.draining
                    depth += h.stats.queue_depth
                    by_pool[h.pool] = by_pool.get(h.pool, 0) + h.stats.queue_depth
                except grpc.RpcError:
                    # unreachable != dead (it may be mid-restart); relays
                    # decide on their own stream errors
                    h.stats = None
            self._g_hosts.set(self._routable_count())
            self._fleet_depth = depth
            self._depth_by_pool = by_pool
            self.autoscale_tick(by_pool if by_pool else depth)
            series.sample()  # stride-counted gang-level series scrape

    # --- autoscale ------------------------------------------------------------

    def autoscale_tick(
        self, queue_depth: "int | dict[str, int]", now: float | None = None
    ) -> str | None:
        """Feed the sustained-queue-depth policy; apply a grow/shrink to
        the lease store when one is attached (the `tony serve` CLI passes
        the job's store + app id). Accepts the legacy int (decode-pool
        depth) or a per-pool ``{pool: depth}`` dict — each pool ticks its
        OWN policy window, and a grow leases that pool's own GangAsk (a
        heterogeneous ask must never grow the wrong pool). Always records
        decisions so tests and operators can see what WOULD have
        happened. Returns the last action taken (tests observe one pool
        at a time)."""
        depths = (
            queue_depth if isinstance(queue_depth, dict)
            else {"decode": int(queue_depth)}
        )
        last: str | None = None
        for pool in sorted(depths):
            depth = depths[pool]
            action = self.autoscaler.observe(depth, now, pool=pool)
            if action is None:
                continue
            # the decode pool keeps the pre-pool gang id so an upgraded
            # frontend keeps growing the reservation it already holds
            gang_id = (
                "serve-autoscale" if pool == "decode"
                else f"serve-autoscale-{pool}"
            )
            detail = f"pool={pool} queue_depth={depth}"
            if self._lease_store is not None and self._app_id:
                try:
                    if action == "grow":
                        ask = self._grow_asks.get(pool)
                        if ask is None:
                            detail += (
                                " -> no grow_ask configured for this pool "
                                "(pass its container GangAsk); decision "
                                "recorded only"
                            )
                        else:
                            host = self._lease_store.grow_gang(
                                self._app_id, gang_id, ask,
                            )
                            detail += (
                                f" -> leased {host}" if host
                                else " -> no capacity"
                            )
                    else:
                        freed = self._lease_store.shrink_gang(
                            self._app_id, gang_id
                        )
                        detail += (
                            f" -> freed {freed}" if freed
                            else " -> nothing to free"
                        )
                except Exception as e:
                    detail += f" -> store error {e}"
            log.warning("autoscale %s (%s)", action, detail)
            trace.instant(
                "serve.autoscale", action=action, pool=pool, detail=detail
            )
            self.autoscale_actions.append((action, detail))
            last = action
        return last

    # --- submission / routing -------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: int | None = None,
    ) -> str:
        """Admit one request; returns its rid. Raises FrontendRejected at
        the in-flight bound. The per-request rng seed is assigned HERE —
        frontend-owned seeds are what make a replay on a different host
        regenerate the identical stream."""
        with self._lock:
            if len(self._flights) >= self.settings.frontend_max_inflight:
                reject = True
            else:
                reject = False
                self._seq += 1
                seq = self._seq
        if reject:
            self._c_rejected.inc()
            raise FrontendRejected(
                f"frontend at max_inflight "
                f"{self.settings.frontend_max_inflight}"
            )
        rid = f"r{seq}"
        req = pb.InferenceRequest(
            rid=rid,
            prompt=list(int(t) for t in prompt),
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            top_k=int(top_k),
            top_p=float(top_p),
            eos_id=-1 if eos_id is None else int(eos_id),
            rng_seed=self.settings.seed * 1_000_003 + seq,
        )
        plen = len(req.prompt)  # precomputed: disarmed span() must stay cheap
        span = trace.span("serve.request", rid=rid, prompt_len=plen)
        fp = None
        if self.settings.prefix_affinity and self.settings.prefix:
            fp = fingerprint(req.prompt, self.settings.prefix_fingerprint_tokens)
        flight = _Flight(rid, req, span, fp=fp)
        with self._lock:
            self._flights[rid] = flight
            self._done_events[rid] = flight.done
        self._c_submitted.inc()
        self._g_inflight.set(len(self._flights))
        threading.Thread(
            target=self._relay, args=(flight,), daemon=True,
            name=f"relay-{rid}",
        ).start()
        return rid

    def _pick_host(self, exclude: set[str], fp: int | None = None) -> _Host | None:
        """Prefix-affinity host when ``fp`` names one that is routable and
        not clearly overloaded, else least-loaded (occupancy + queue depth
        via the stats poll, plus locally assigned work); ``exclude`` skips
        hosts this request already failed on — unless they are the only
        ones left (a restarted task reuses its task_id). The chosen host
        becomes (or stays) the fingerprint's affinity — after a failover
        the prefix re-pins to wherever the replay re-prefilled it."""
        with self._lock:
            alive = [
                h for h in self._hosts.values()
                if not (h.dead or h.draining) and h.pool == "decode"
            ]
            preferred = [h for h in alive if h.task_id not in exclude] or alive
            if not preferred:
                return None
            best = min(preferred, key=lambda h: h.load())
            if fp is not None:
                tid = self._affinity.get(fp)
                if tid is not None:
                    cand = next(
                        (h for h in preferred if h.task_id == tid), None
                    )
                    # overload fallback: pinning is worthless if the
                    # affinity host is saturated while another sits idle —
                    # re-prefilling the prefix there is cheaper than
                    # queueing behind a full host. A host whose stats poll
                    # is failing (stale entry, wedged process) gets the
                    # configured slot count as its estimate, so its
                    # locally-assigned backlog still bounds the pile-up.
                    if cand is not None:
                        slots_est = (
                            cand.stats.slots if cand.stats is not None
                            else self.settings.slots
                        )
                        if cand.load() < 2 * max(slots_est, 1):
                            best = cand
                            self._c_affinity.inc()
                self._affinity[fp] = best.task_id
                self._affinity.move_to_end(fp)
                while len(self._affinity) > self._affinity_cap:
                    self._affinity.popitem(last=False)
            best.assigned += 1
            return best

    def _pick_prefill_host(self) -> _Host | None:
        """Least-loaded live prefill-pool host (no affinity: prefill work
        is one-shot, the blocks leave with the handoff)."""
        with self._lock:
            alive = [
                h for h in self._hosts.values()
                if not (h.dead or h.draining) and h.pool == "prefill"
            ]
            if not alive:
                return None
            best = min(alive, key=lambda h: h.load())
            best.assigned += 1
            return best

    def _handoff(self, flight: _Flight, decode_host: _Host) -> None:
        """Disaggregated prefill: route the prompt through a prefill host,
        which ships the finished KV blocks to ``decode_host`` before the
        Generate lands there (its admission then sees a prefix hit).
        Failure is deliberately non-fatal — the decode host re-prefills
        whatever never arrived, correctness never depends on the handoff.
        Every attempt is recorded in the ledger; the handoff-no-block-leak
        chaos invariant audits shipped == adopted + freed post-mortem."""
        ph = self._pick_prefill_host()
        if ph is None:
            return
        rec = {
            "rid": flight.rid, "prefill_host": ph.task_id,
            "decode_host": decode_host.task_id, "shipped": 0, "adopted": 0,
            "freed": 0, "bytes": 0, "ms": 0.0, "ok": False, "message": "",
        }
        hop = trace.span(
            "serve.handoff", parent=flight.span.sid or None, rid=flight.rid,
            prefill=ph.task_id, decode=decode_host.task_id,
        )
        try:
            with hop:
                resp = ph.client.prefill(
                    flight.rid, list(flight.req.prompt), decode_host.address,
                    rng_seed=int(flight.req.rng_seed), timeout_s=600.0,
                )
                rec.update(
                    shipped=int(resp.shipped), adopted=int(resp.adopted),
                    freed=int(resp.freed), bytes=int(resp.bytes),
                    ms=round(resp.ms, 3), ok=bool(resp.ok),
                    message=resp.message,
                )
                hop.set(ok=resp.ok, shipped=resp.shipped)
        except grpc.RpcError as e:
            # prefill host lost mid-handoff: tombstone it and move on — the
            # decode host re-prefills, and the unadopted export dies with
            # the dead host's pool (nothing strands on a survivor)
            rec["message"] = (
                f"prefill host lost: {getattr(e, 'code', lambda: e)()}"
            )
            log.warning(
                "%s: handoff via %s failed (%s); decode host re-prefills",
                flight.rid, ph.task_id, rec["message"],
            )
            self._host_errored(ph)
        finally:
            with self._lock:
                ph.assigned = max(ph.assigned - 1, 0)
                self._handoffs.append(rec)
            if rec["ok"]:
                self._c_handoffs.inc()

    def _relay(self, flight: _Flight) -> None:
        """One request's life: route -> stream -> (on host death: re-queue
        + re-prefill on a survivor, verify the replayed prefix) -> finish.

        Two budgets, deliberately separate: ``max_replays`` is consumed
        only by attempts that made PROGRESS and then broke (a genuine
        mid-stream death); no-progress episodes — no routable host, a
        stale table entry refusing connections while the AM relaunches the
        task, admission rejections — are paced at NO_HOST_WAIT_S and
        bounded by one NO_HOST_TIMEOUT_S patience clock instead, so a
        restart window can never burn the replay budget in milliseconds.
        """
        res = flight.result
        stalled_since: float | None = None  # current no-progress episode
        try:
            while True:
                if (
                    stalled_since is not None
                    and time.monotonic() - stalled_since > self.NO_HOST_TIMEOUT_S
                ):
                    res.finish_reason = "error"
                    res.message = res.message or (
                        "no decode host made progress within "
                        f"{self.NO_HOST_TIMEOUT_S:.0f}s"
                    )
                    return
                failed: set[str] = set(res.hosts)
                host = self._pick_host(failed, flight.fp)
                if host is None:
                    stalled_since = stalled_since or time.monotonic()
                    time.sleep(self.NO_HOST_WAIT_S)
                    continue
                delivered = len(res.tokens)
                is_replay = bool(delivered or res.hosts)
                if (
                    not is_replay and not flight.handoff_tried
                    and self.settings.prefill_hosts > 0
                    and len(flight.req.prompt)
                    >= max(self.settings.handoff_min_tokens, 1)
                ):
                    # disaggregated prefill BEFORE the Generate is routed:
                    # the decode host is already chosen, so the blocks ship
                    # exactly where the request will decode. Never retried
                    # on replay — a replay re-prefills on the survivor,
                    # which is the correctness path the gang guarantees
                    flight.handoff_tried = True
                    self._handoff(flight, host)
                if is_replay:
                    # parented on the ORIGINAL request span: the merged
                    # trace shows the re-prefill hanging off the request
                    # the dead host dropped
                    hop = trace.span(
                        "serve.reprefill", parent=flight.span.sid or None,
                        rid=flight.rid, host=host.task_id,
                        delivered=delivered, replay=res.replays + 1,
                    )
                else:
                    hop = trace.span(
                        "serve.route", parent=flight.span.sid or None,
                        rid=flight.rid, host=host.task_id,
                    )
                res.hosts.append(host.task_id)
                outcome = ""
                try:
                    with hop:
                        outcome = self._stream_from(host, flight, delivered)
                        hop.set(outcome=outcome)
                except grpc.RpcError as e:
                    self._host_errored(host)
                    if len(res.tokens) > delivered:
                        # the re-queue moment: host died mid-stream;
                        # survivors re-prefill it
                        log.warning(
                            "%s: stream from %s failed mid-flight (%s); "
                            "re-queueing", flight.rid, host.task_id,
                            getattr(e, "code", lambda: e)(),
                        )
                        outcome = "host-lost"
                    else:
                        # connection-level failure before ANY progress: a
                        # stale table entry / relaunching host — a routing
                        # miss under the patience clock, not a replay
                        log.info(
                            "%s: %s unreachable before first token; "
                            "rerouting", flight.rid, host.task_id,
                        )
                        outcome = "unreachable"
                finally:
                    with self._lock:
                        host.assigned = max(host.assigned - 1, 0)
                if outcome in ("rejected", "draining", "unreachable"):
                    # unwind this hop and try elsewhere after a beat
                    res.hosts.pop()
                    stalled_since = stalled_since or time.monotonic()
                    time.sleep(self.NO_HOST_WAIT_S)
                    continue
                stalled_since = None  # the attempt streamed: progress
                if is_replay:
                    res.replays += 1
                    self._c_replays.inc()
                if outcome == "finished":
                    return
                if res.replays >= self.settings.max_replays:
                    res.finish_reason = "error"
                    res.message = (
                        f"replay budget exhausted after {res.replays} replays"
                    )
                    return
        finally:
            self._finish(flight)

    def _stream_from(self, host: _Host, flight: _Flight, delivered: int) -> str:
        """Relay one Generate stream. Returns 'finished' | 'rejected' |
        'draining' | 'stalled'. Raises grpc.RpcError on a broken stream
        (the caller's re-queue trigger). On replay (``delivered`` > 0) the
        FULL stream is requested and the regenerated prefix is verified
        against what was already delivered — the determinism evidence."""
        res = flight.result
        got: list[int] = []
        for chunk in host.client.generate(flight.req, timeout_s=600.0):
            if chunk.finish_reason in ("rejected", "draining"):
                return chunk.finish_reason
            if chunk.finish_reason == "invalid":
                # deterministic validation failure: identical on every
                # host — finish now instead of burning the replay budget
                res.finish_reason = "rejected"
                res.message = chunk.message
                return "finished"
            if chunk.finish_reason == "error":
                res.message = chunk.message
                return "stalled"
            if chunk.prompt_len:
                res.prompt_len = chunk.prompt_len
            got.extend(chunk.tokens)
            if not res.ttft_s and got:
                res.ttft_s = time.perf_counter() - flight.submit_t
                self._h_ttft.observe(res.ttft_s)
            if len(got) > delivered:
                if delivered and got[:delivered] != res.tokens[:delivered]:
                    # deterministic replay broken: record it loudly; the
                    # serve-no-request-lost invariant will flag the run
                    res.replay_consistent = False
                    log.error(
                        "%s: replay on %s diverged from the delivered "
                        "prefix", flight.rid, host.task_id,
                    )
                res.tokens = list(got)
                delivered = len(got)
            if chunk.done:
                if delivered and got[:delivered] != res.tokens[:delivered]:
                    res.replay_consistent = False
                res.finish_reason = chunk.finish_reason
                return "finished"
        # stream ended without a done chunk: the server went away between
        # chunks without an RPC error surfacing — treat as host loss
        raise grpc.RpcError()

    def _host_errored(self, host: _Host) -> None:
        with self._lock:
            host.dead = True
            self._hosts.pop(host.task_id, None)
            self._tombstones[(host.task_id, host.address, host.attempt)] = (
                time.monotonic() + self.TOMBSTONE_TTL_S
            )
        try:
            host.client.close()
        except Exception:
            pass

    def _finish(self, flight: _Flight) -> None:
        res = flight.result
        if not res.finish_reason:
            res.finish_reason = "error"
            res.message = res.message or "relay exited without a result"
        flight.span.end(
            reason=res.finish_reason, tokens=len(res.tokens),
            replays=res.replays,
        )
        with self._lock:
            self._flights.pop(flight.rid, None)
            self._results[flight.rid] = res
            inflight = len(self._flights)
        self._g_inflight.set(inflight)
        self._ledger.append({
            "rid": res.rid,
            "prompt_len": res.prompt_len or len(flight.req.prompt),
            "max_new_tokens": flight.req.max_new_tokens,
            "seed": int(flight.req.rng_seed),
            "tokens": len(res.tokens),
            "finish_reason": res.finish_reason,
            "message": res.message,
            "ttft_s": round(res.ttft_s, 4),
            "replays": res.replays,
            "replay_consistent": res.replay_consistent,
            "hosts": list(res.hosts),
        })
        flight.done.set()

    # --- results / restart ----------------------------------------------------

    def result(self, rid: str, timeout_s: float = 600.0) -> GangCompletion:
        """Block for one request's completion and collect (evict) it."""
        with self._lock:
            event = self._done_events.get(rid)
        if event is None:
            raise KeyError(f"unknown or already-collected rid {rid!r}")
        if not event.wait(timeout_s):
            raise TimeoutError(f"request {rid} still in flight")
        with self._lock:
            self._done_events.pop(rid, None)
            return self._results.pop(rid)

    def run(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32, **kw
    ) -> dict[str, GangCompletion]:
        """Submit a batch and wait for every completion (driver sugar)."""
        rids = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        return {rid: self.result(rid) for rid in rids}

    def rolling_restart(self, recycle: bool = True, timeout_s: float = 0.0) -> list[str]:
        """Drain + recycle hosts ONE at a time; the rest keep serving.
        Returns the task ids restarted. A host that fails to drain in its
        budget is skipped (and reported), never force-killed — that is
        the chaos schedule's job, not the restart path's."""
        done = []
        for h in self._snapshot_hosts():
            log.warning("rolling restart: draining %s", h.task_id)
            with self._lock:
                h.draining = True
            try:
                resp = h.client.drain(timeout_s=timeout_s, recycle=recycle)
                if resp.drained:
                    done.append(h.task_id)
                else:
                    log.error(
                        "rolling restart: %s kept %d in flight; skipping",
                        h.task_id, resp.remaining,
                    )
            except grpc.RpcError as e:
                log.error("rolling restart: drain of %s failed: %s", h.task_id, e)
            finally:
                with self._lock:
                    h.draining = False
        return done

    # --- shutdown -------------------------------------------------------------

    def ledger(self) -> dict:
        with self._lock:
            pending = [f.rid for f in self._flights.values()]
            handoffs = list(self._handoffs)
        return {
            "proc": self.proc,
            "ttft_budget_s": self.settings.ttft_budget_s,
            "rejected": int(self._c_rejected.value),
            "pending": pending,  # accepted but unfinished at ledger time
            "requests": list(self._ledger),
            "handoffs": handoffs,  # prefill->decode block-handoff records
        }

    def write_ledger(self) -> str | None:
        """Persist the request ledger under ``<app_dir>/serve/`` — the
        artifact the serve chaos invariants audit post-mortem."""
        if not self.app_dir:
            return None
        out_dir = os.path.join(self.app_dir, "serve")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"requests_{trace.sanitize_proc(self.proc)}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(self.ledger(), f, indent=1, sort_keys=True)
        os.replace(path + ".tmp", path)
        return path

    def close(self, wait_s: float = 5.0) -> dict:
        """Wait briefly for in-flight work, persist the ledger, snapshot
        the registry into the app dir (portal fleet /metrics), and drop
        every channel. Returns the ledger."""
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            with self._lock:
                flights = list(self._flights.values())
            if not flights:
                break
            flights[0].done.wait(min(0.25, max(deadline - time.monotonic(), 0)))
        self._closed.set()
        with self._lock:
            open_flights = list(self._flights.values())
        for f in open_flights:
            f.span.end(reason="shutdown")
        ledger = self.ledger()
        self.write_ledger()
        if self.app_dir:
            try:
                write_snapshot(
                    os.path.join(
                        self.app_dir, "metrics",
                        f"{trace.sanitize_proc(self.proc)}.json",
                    ),
                    self.registry, proc=self.proc,
                )
            except OSError:
                log.debug("frontend registry snapshot failed", exc_info=True)
        self._stats_thread.join(timeout=2.0)
        if self._series is not None:
            self._series.force_sample()
            self._series.drain()
            self._series.detach(self._series_key)
        for h in self._snapshot_hosts():
            try:
                h.client.close()
            except Exception:
                pass
        if self._am is not None:
            try:
                self._am.close()
            except Exception:
                pass
        return ledger


__all__ = [
    "AutoscalePolicy",
    "FrontendRejected",
    "GangCompletion",
    "GangFrontend",
]
