"""Declarative fault schedules and the process-global injector.

Recovery code is only as good as the failures it has actually seen
(ROADMAP north star; ADVICE.md round 5 found four failure-window bugs in
freshly-reviewed lease code). This module makes faults first-class:
a config-driven schedule (``chaos.*`` keys) of deterministic faults fired
from cheap hooks compiled into the hot paths — AM supervision, executor
heartbeats, lease-store access, RPC dispatch, container allocation.

The contract that keeps this safe to ship in production binaries:

- ``chaos_hook(point, **ctx)`` is the ONLY runtime surface. When no
  injector is armed (the default — ``chaos.enabled`` false or absent) it
  is a single global-load + ``None`` compare and returns ``None``.
- An injector is armed explicitly per process (``install_from_config`` in
  the AM / executor entrypoints), never as an import side effect, so
  client processes and library consumers can never trip a fault.
- Fault firing is deterministic: triggers are invocation counts per hook
  point and wall-time windows since arming; the only randomness (delay
  jitter) comes from a seeded RNG (``chaos.seed``).

Fault types (point they attach to):

====================  =================  =======================================
type                  point              effect
====================  =================  =======================================
``kill_container``    executor.beat      SIGKILL the executor's process group
``kill_am``           am.tick            SIGKILL the AM process mid-supervision
``hang_store``        lease.locked       block lease-store open/flock for
                                         ``duration_s`` (hard-mount hang)
``partition_host``    lease.locked       raise OSError from store access in
                                         THIS process only (one-owner partition)
``drop_heartbeats``   executor.beat      suppress executor→AM heartbeats
``delay_rpc``         rpc.server         sleep ``delay_ms`` (+ seeded jitter)
                                         before serving a control-plane RPC
``delay_point``       (explicit)         generic latency at any hook point,
                                         e.g. ``backend.allocate``
====================  =================  =======================================

The port's copy of ``tony_tpu/chaos/faults.py``.
"""

from __future__ import annotations

import json
import logging
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Mapping

from tony_tpu_torch.config.keys import Keys

log = logging.getLogger(__name__)

# hook points wired into the codebase (see module docstring table)
POINTS = (
    "am.tick",            # each AM supervision-loop iteration
    "executor.beat",      # each executor heartbeat-loop iteration
    "lease.locked",       # before each LeaseStore open/flock
    "rpc.server",         # before each served control-plane RPC
    "backend.allocate",   # before each container launch
    "serve.handoff",      # after KV-block export, before ShipBlocks lands
)

_POINT_OF_TYPE = {
    "kill_container": "executor.beat",
    "kill_am": "am.tick",
    "hang_store": "lease.locked",
    "partition_host": "lease.locked",
    "drop_heartbeats": "executor.beat",
    "delay_rpc": "rpc.server",
    "delay_point": "",  # must name its point explicitly
}

_DEFAULT_ROLE = {
    "kill_container": "executor",
    "kill_am": "am",
    "hang_store": "am",
    "partition_host": "am",
    "drop_heartbeats": "executor",
}


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. Triggers compose with AND: the fault fires only
    when every specified count/time window matches. Counts are 1-based
    per-point invocation counts inside the armed process."""

    type: str
    point: str
    role: str = ""            # only fire in processes armed with this role
    task: str = ""            # executor filter, e.g. "worker:0"
    method: str = ""          # rpc method filter, e.g. "Heartbeat"
    attempt: int | None = None  # task attempt / AM attempt filter
    at_count: int = 0         # fire exactly at the Nth hook invocation
    from_count: int = 0       # fire from the Nth invocation onward...
    to_count: int = 0         # ...up to this one (0 = no upper bound)
    after_s: float = 0.0      # fire only this long after arming...
    until_s: float = 0.0      # ...and before this (0 = no upper bound)
    # condition trigger: fire only once this file exists — the test or harness
    # creates it when the system reaches the state under attack (e.g. "kill
    # the decode host only once its streams are provably mid-flight"),
    # which count/time triggers can only approximate racily
    on_file: str = ""
    duration_s: float = 30.0  # hang_store block length
    delay_ms: float = 0.0     # delay_rpc / delay_point latency
    jitter_ms: float = 0.0    # extra random latency from the seeded RNG
    raw: Mapping[str, Any] = field(default_factory=dict, compare=False)

    def describe(self) -> str:
        parts = [self.type, f"point={self.point}"]
        for name in ("role", "task", "method"):
            v = getattr(self, name)
            if v:
                parts.append(f"{name}={v}")
        if self.attempt is not None:
            parts.append(f"attempt={self.attempt}")
        for name in ("at_count", "from_count", "to_count"):
            v = getattr(self, name)
            if v:
                parts.append(f"{name}={v}")
        for name in ("after_s", "until_s"):
            v = getattr(self, name)
            if v:
                parts.append(f"{name}={v:g}")
        if self.on_file:
            parts.append(f"on_file={self.on_file}")
        return " ".join(parts)


def parse_faults(raw: Any) -> list[FaultSpec]:
    """Parse ``chaos.faults``: a JSON string, or an already-parsed list of
    dicts (TOML array / programmatic config). Raises ``ValueError`` on an
    unknown fault type or malformed spec — a schedule that silently drops
    faults would report a vacuous all-clear."""
    if raw is None or raw == "":
        return []
    if isinstance(raw, str):
        try:
            raw = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ValueError(f"chaos.faults is not valid JSON: {e}") from e
    if isinstance(raw, Mapping):
        raw = [raw]
    if not isinstance(raw, list):
        raise ValueError(f"chaos.faults must be a list of fault objects, got {type(raw).__name__}")
    specs: list[FaultSpec] = []
    for i, d in enumerate(raw):
        if not isinstance(d, Mapping):
            raise ValueError(f"chaos.faults[{i}] must be an object, got {d!r}")
        ftype = str(d.get("type", ""))
        if ftype not in _POINT_OF_TYPE:
            raise ValueError(
                f"chaos.faults[{i}]: unknown fault type {ftype!r} "
                f"(expected one of {sorted(_POINT_OF_TYPE)})"
            )
        point = str(d.get("point", "") or _POINT_OF_TYPE[ftype])
        if not point:
            raise ValueError(f"chaos.faults[{i}]: fault type {ftype!r} needs an explicit 'point'")
        if point not in POINTS:
            raise ValueError(
                f"chaos.faults[{i}]: unknown hook point {point!r} (expected one of {POINTS})"
            )
        known = {
            "type", "point", "role", "task", "method", "attempt", "at_count",
            "from_count", "to_count", "after_s", "until_s", "duration_s",
            "delay_ms", "jitter_ms", "on_file",
        }
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"chaos.faults[{i}]: unknown field(s) {sorted(unknown)}")
        attempt = d.get("attempt", 0 if ftype in ("kill_container", "kill_am") else None)
        specs.append(
            FaultSpec(
                type=ftype,
                point=point,
                role=str(d.get("role", _DEFAULT_ROLE.get(ftype, ""))),
                task=str(d.get("task", "")),
                method=str(d.get("method", "")),
                attempt=None if attempt is None else int(attempt),
                at_count=int(d.get("at_count", 0)),
                from_count=int(d.get("from_count", 0)),
                to_count=int(d.get("to_count", 0)),
                after_s=float(d.get("after_s", 0.0)),
                until_s=float(d.get("until_s", 0.0)),
                duration_s=float(d.get("duration_s", 30.0)),
                delay_ms=float(d.get("delay_ms", 0.0)),
                jitter_ms=float(d.get("jitter_ms", 0.0)),
                on_file=str(d.get("on_file", "")),
                raw=dict(d),
            )
        )
    return specs


class ChaosInjector:
    """Evaluates the fault schedule at each hook invocation.

    One instance per armed process; hooks route here through the module
    global. Per-point invocation counters give deterministic count
    triggers (e.g. in an executor, ``executor.beat`` count == heartbeat
    number of that executor)."""

    def __init__(self, faults: list[FaultSpec], *, role: str, seed: int = 0):
        self.role = role
        self.faults = faults
        self._t0 = time.monotonic()
        self._counts: dict[str, int] = {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.fired: list[str] = []  # describe() of every fault that fired

    def fire(self, point: str, ctx: Mapping[str, Any]) -> FaultSpec | None:
        with self._lock:
            count = self._counts.get(point, 0) + 1
            self._counts[point] = count
        now = time.monotonic() - self._t0
        suppressed: FaultSpec | None = None
        for f in self.faults:
            if f.point != point or not self._matches(f, ctx, count, now):
                continue
            self._act(f, count, now)
            if f.type == "drop_heartbeats":
                suppressed = f
        return suppressed

    def _matches(self, f: FaultSpec, ctx: Mapping[str, Any], count: int, now: float) -> bool:
        if f.role and f.role != self.role:
            return False
        if f.task and f.task != ctx.get("task"):
            return False
        if f.method and f.method != ctx.get("method"):
            return False
        if f.attempt is not None and ctx.get("attempt") is not None and f.attempt != ctx["attempt"]:
            return False
        if f.at_count and count != f.at_count:
            return False
        if f.from_count and count < f.from_count:
            return False
        if f.to_count and count > f.to_count:
            return False
        if f.after_s and now < f.after_s:
            return False
        if f.until_s and now > f.until_s:
            return False
        if f.on_file and not os.path.exists(f.on_file):
            return False
        return True

    def _act(self, f: FaultSpec, count: int, now: float) -> None:
        with self._lock:
            self.fired.append(f.describe())
        # the injected fault lands on the shared trace timeline as an
        # instant event, so a post-mortem sees it BETWEEN the spans it
        # interrupted (no-op when this process is untraced)
        from tony_tpu_torch.obs import trace

        trace.instant(
            f"chaos.{f.type}", point=f.point, count=count, fault=f.describe()
        )
        if f.type in ("kill_container", "kill_am"):
            # log + flush first: the kill is immediate and unhandled — the
            # trace journal must land NOW, including the spans still OPEN
            # (they are what the fault interrupts; they die with the process)
            log.warning("chaos: firing %s (count=%d t=%.2fs) — SIGKILL", f.describe(), count, now)
            trace.emergency_flush()
            for h in logging.getLogger().handlers:
                try:
                    h.flush()
                except Exception:
                    pass
            if f.type == "kill_container":
                # the executor is its process group's leader
                # (start_new_session): take the user process down with it,
                # exactly like an OOM-killed container
                os.killpg(os.getpgrp(), signal.SIGKILL)
            else:
                os.kill(os.getpid(), signal.SIGKILL)
        elif f.type == "hang_store":
            log.warning("chaos: firing %s — blocking %.1fs", f.describe(), f.duration_s)
            time.sleep(f.duration_s)
        elif f.type == "partition_host":
            log.warning("chaos: firing %s — store unreachable", f.describe())
            raise OSError(f"chaos: lease store partitioned from this owner ({f.describe()})")
        elif f.type in ("delay_rpc", "delay_point"):
            delay = f.delay_ms
            if f.jitter_ms:
                with self._lock:
                    delay += self._rng.uniform(0.0, f.jitter_ms)
            time.sleep(delay / 1000.0)
        # drop_heartbeats: no side effect here; fire() returns it and the
        # call site skips its send


# --- process-global arming ---------------------------------------------------

_injector: ChaosInjector | None = None


def chaos_hook(point: str, **ctx: Any) -> FaultSpec | None:
    """The injection seam compiled into hot paths. Disarmed (the default):
    one global load + None compare, returns None. Armed: evaluates the
    schedule; side-effect faults act in place, suppression faults are
    returned for the call site to honour."""
    inj = _injector
    if inj is None:
        return None
    return inj.fire(point, ctx)


def install_from_config(config, role: str) -> bool:
    """Arm this process from ``chaos.*`` config. Returns True when armed.
    Strictly inert unless ``chaos.enabled`` is true AND the schedule is
    non-empty; call sites (AM / executor entrypoints) pay one config read."""
    if not config.get_bool(Keys.CHAOS_ENABLED, False):
        return False
    faults = parse_faults(config.get(Keys.CHAOS_FAULTS))
    if not faults:
        return False
    global _injector
    _injector = ChaosInjector(
        faults, role=role, seed=config.get_int(Keys.CHAOS_SEED, 0)
    )
    log.warning(
        "chaos injector ARMED (role=%s, seed=%d): %s",
        role,
        config.get_int(Keys.CHAOS_SEED, 0),
        "; ".join(f.describe() for f in faults),
    )
    return True


def uninstall() -> None:
    """Disarm (tests)."""
    global _injector
    _injector = None


def active_injector() -> ChaosInjector | None:
    return _injector


__all__ = [
    "ChaosInjector",
    "FaultSpec",
    "POINTS",
    "active_injector",
    "chaos_hook",
    "install_from_config",
    "parse_faults",
    "uninstall",
]
