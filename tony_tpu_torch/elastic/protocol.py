"""Elastic membership protocol: cluster generations over the shared app
dir. The port's copy of ``tony_tpu/elastic/protocol.py``, stdlib only like
it, with the same files, record types and field names, so either
package's readers (and the reference's ``chaos/invariants.py``) read the
other's files.

- the AM is the ONE membership authority. On a lost host it declares a new
  **cluster generation** — a :class:`GenerationRecord` naming the surviving
  members — by atomically writing ``<app_dir>/elastic/generation.json``
  and appending the record to ``<app_dir>/elastic/generations.jsonl``, so
  the whole membership history is auditable post-mortem.
- survivors **fence on the generation**: the trainer's
  :class:`ElasticController` watches the broadcast file from a daemon
  thread (synchronously once at arm time, so a generation declared while
  the trainer boots is honoured at the first step boundary) and surfaces
  the pending record to ``fit()``, which reshards at the next step
  boundary. In the port only the controller of global rank 0 watches the
  file; ``fit()`` hands its generation to the other ranks
  (``train/loop.py``).
- the trainer journals its side — per-step membership, log-boundary
  losses + batch fingerprints, and every reshard with the exact data
  ranges it skipped — to ``<app_dir>/elastic/journal_m<member>.jsonl``,
  the evidence the ``elastic-loss-continuity`` / ``elastic-no-data-loss``
  invariants audit.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process, next to TONY_TRACE_* /
# TONY_OBS_*): the ElasticRuntime exports these into every member
ENV_ENABLED = "TONY_ELASTIC"                  # "1" arms the trainer
ENV_MEMBERS = "TONY_ELASTIC_MEMBERS"          # gang size at full strength
ENV_MEMBER = "TONY_ELASTIC_MEMBER"            # this process's member id
ENV_POLL = "TONY_ELASTIC_POLL_S"              # generation-file poll cadence
ENV_SHADOW = "TONY_ELASTIC_SHADOW_STEPS"      # checkpoint-shadow stride

GENERATION_FILE = "generation.json"
HISTORY_FILE = "generations.jsonl"

# loss-continuity tolerance the trainer stamps into its journal meta line;
# the invariant checker judges boundary jumps against exactly these numbers
# (a post-mortem must not invent its own thresholds)
DEFAULT_TOLERANCE = {"window": 8, "z": 4.0, "frac": 0.25}


@dataclass(frozen=True)
class GenerationRecord:
    """One membership declaration (the generation.json payload)."""

    generation: int
    members: tuple[int, ...]           # surviving member ids, sorted
    boundary: str = "start"            # start | shrink | grow
    dead: tuple[int, ...] = ()         # members removed at this boundary
    added: tuple[int, ...] = ()        # members restored at this boundary
    reason: str = ""
    ts: float = 0.0
    freed_host: str = ""               # lease handed back on shrink
    granted_host: str = ""             # lease re-acquired on grow

    def to_dict(self) -> dict:
        d = asdict(self)
        for k in ("members", "dead", "added"):
            d[k] = list(d[k])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "GenerationRecord":
        return cls(
            generation=int(d.get("generation", 0)),
            members=tuple(int(m) for m in d.get("members", ())),
            boundary=str(d.get("boundary", "start")),
            dead=tuple(int(m) for m in d.get("dead", ())),
            added=tuple(int(m) for m in d.get("added", ())),
            reason=str(d.get("reason", "")),
            ts=float(d.get("ts", 0.0) or 0.0),
            freed_host=str(d.get("freed_host", "")),
            granted_host=str(d.get("granted_host", "")),
        )


def elastic_dir(app_dir: str) -> str:
    return os.path.join(app_dir, "elastic")


def generation_path(app_dir: str) -> str:
    return os.path.join(elastic_dir(app_dir), GENERATION_FILE)


def history_path(app_dir: str) -> str:
    return os.path.join(elastic_dir(app_dir), HISTORY_FILE)


def write_generation(app_dir: str, rec: GenerationRecord) -> GenerationRecord:
    """The AM's membership broadcast: atomic latest + append-only history.

    The latest file is what survivors fence on; the history is the
    post-mortem record (``tony elastic``, the elastic chaos invariants).
    The history append lands BEFORE the latest-file replace, so a reader
    that observed generation G in the broadcast always finds G in the
    history too.
    """
    if not rec.ts:
        rec = GenerationRecord(**{**rec.to_dict(), "ts": time.time()})
    d = elastic_dir(app_dir)
    os.makedirs(d, exist_ok=True)
    with open(history_path(app_dir), "a", encoding="utf-8") as f:
        f.write(json.dumps(rec.to_dict(), sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    path = generation_path(app_dir)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec.to_dict(), f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return rec


def read_generation(app_dir: str) -> GenerationRecord | None:
    try:
        with open(generation_path(app_dir), encoding="utf-8") as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or "generation" not in d:
        return None
    return GenerationRecord.from_dict(d)


def read_history(app_dir: str) -> list[GenerationRecord]:
    """Every declared generation, journal order; torn tails skipped."""
    recs: list[GenerationRecord] = []
    try:
        with open(history_path(app_dir), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    recs.append(GenerationRecord.from_dict(json.loads(line)))
                except (ValueError, TypeError):
                    continue
    except OSError:
        pass
    return recs


# --- trainer-side journal -----------------------------------------------------


class ElasticJournal:
    """Append-only per-member evidence stream under ``<app_dir>/elastic/``.

    Written from the fit loop's thread only (no lock needed); each record
    is one JSON line. ``step`` records are pure host-side bookkeeping
    (membership per step — the no-data-loss evidence); ``loss`` records
    ride the log boundary's already-synced scalars; ``reshard`` records
    carry the exact skipped data ranges. Flushed at reshard boundaries and
    close so a chaos SIGKILL loses at most the buffered tail (the
    invariant checker skips torn lines).
    """

    def __init__(self, path: str, *, member: int, members: int,
                 tolerance: dict | None = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", encoding="utf-8", buffering=1 << 16)
        self._write({
            "type": "meta", "member": member, "members": members,
            "tolerance": dict(tolerance or DEFAULT_TOLERANCE), "ts": time.time(),
        })
        self._f.flush()

    def _write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")

    def step(self, step: int, generation: int, members: tuple[int, ...]) -> None:
        self._write({
            "type": "step", "step": step, "gen": generation,
            "members": list(members),
        })

    def loss(self, step: int, generation: int, loss: float,
             fingerprint: int | None = None) -> None:
        rec: dict[str, Any] = {
            "type": "loss", "step": step, "gen": generation, "loss": loss,
        }
        if fingerprint is not None:
            rec["fp"] = int(fingerprint)
        self._write(rec)

    def reshard(self, *, generation: int, at_step: int, boundary: str,
                members: tuple[int, ...], dead: tuple[int, ...] = (),
                added: tuple[int, ...] = (),
                skipped: dict[int, tuple[int, int]] | None = None,
                reshard_s: float = 0.0, lost_steps: int = 0) -> None:
        self._write({
            "type": "reshard", "gen": generation, "at_step": at_step,
            "boundary": boundary, "members": list(members),
            "dead": list(dead), "added": list(added),
            "skipped": {str(m): list(r) for m, r in (skipped or {}).items()},
            "reshard_s": round(reshard_s, 4), "lost_steps": lost_steps,
        })
        self.flush()

    def flush(self) -> None:
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        except OSError:
            pass


def journal_path(app_dir: str, member: int) -> str:
    return os.path.join(elastic_dir(app_dir), f"journal_m{member}.jsonl")


def read_journal(path: str) -> list[dict]:
    """One journal's records in order; torn/corrupt lines skipped."""
    recs: list[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    recs.append(rec)
    except OSError:
        pass
    return recs


def journal_files(app_dir: str) -> list[str]:
    d = elastic_dir(app_dir)
    try:
        return sorted(
            os.path.join(d, n) for n in os.listdir(d)
            if n.startswith("journal_m") and n.endswith(".jsonl")
        )
    except OSError:
        return []


# --- trainer-side controller --------------------------------------------------


@dataclass
class ElasticSettings:
    """Everything the trainer needs to arm elastic training."""

    members: int = 0                   # gang size at full strength (0 = off)
    member: int = 0                    # this process's member id
    app_dir: str = ""                  # broadcast + journal root ("" = none)
    poll_interval_s: float = 0.5
    shadow_interval_steps: int = 16

    @classmethod
    def from_env(cls) -> "ElasticSettings | None":
        if os.environ.get(ENV_ENABLED, "") != "1":
            return None
        try:
            members = int(os.environ.get(ENV_MEMBERS, "0"))
        except ValueError:
            members = 0
        if members < 2:
            return None

        def _f(key: str, default: float) -> float:
            try:
                return float(os.environ.get(key, "") or default)
            except ValueError:
                return default

        return cls(
            members=members,
            member=int(_f(ENV_MEMBER, 0)),
            app_dir=os.environ.get("TONY_APP_DIR", ""),
            poll_interval_s=_f(ENV_POLL, 0.5),
            shadow_interval_steps=int(_f(ENV_SHADOW, 16)),
        )


class ElasticController:
    """Per-trainer membership watcher + evidence journal.

    The fit loop calls :meth:`pending` at each step boundary (two
    attribute loads when nothing changed — the same armed-idle budget as
    the profile controller) and :meth:`applied` after it finished
    resharding. Tests and bench drive boundaries in-process through
    :meth:`trigger`, the exact twin of the AM's file broadcast.
    """

    def __init__(self, settings: ElasticSettings, *, watch: bool = True):
        self.settings = settings
        self.members: tuple[int, ...] = tuple(range(settings.members))
        self.generation = 0
        self._pending: GenerationRecord | None = None
        self._last_seen_gen = 0
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self.journal: ElasticJournal | None = None
        if settings.app_dir:
            self.journal = ElasticJournal(
                journal_path(settings.app_dir, settings.member),
                member=settings.member, members=settings.members,
            )
        if settings.app_dir and watch:
            # synchronous first check: a generation declared while the
            # trainer was still compiling is honoured at the first boundary
            self.check()
            self._thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="tony-elastic-watch"
            )
            self._thread.start()

    # --- broadcast watching ---------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._stop_evt.wait(self.settings.poll_interval_s):
            try:
                self.check()
            except Exception:
                log.debug("elastic generation check failed", exc_info=True)

    def check(self) -> None:
        rec = read_generation(self.settings.app_dir)
        if rec is None or rec.generation <= self._last_seen_gen:
            return
        self._last_seen_gen = rec.generation
        if rec.boundary == "start":
            # initial declaration: adopt the number, no boundary
            self.generation = max(self.generation, rec.generation)
            return
        # ALWAYS queue the newest record — never judge "no membership
        # change" here against self.members: that races with a reshard in
        # flight on the fit thread (a grow declared while the shrink is
        # still applying would compare against the PRE-shrink membership
        # and be swallowed as an echo). The fit loop adopts true no-ops
        # at the boundary, where membership is settled.
        self._pending = rec
        log.warning(
            "elastic generation %d pending (%s): members -> %s",
            rec.generation, rec.boundary, list(rec.members),
        )

    def trigger(self, rec: GenerationRecord) -> None:
        """Arm a membership change in-process (tests, bench) — the twin of
        the AM broadcast."""
        self._last_seen_gen = max(self._last_seen_gen, rec.generation)
        self._pending = rec

    # --- fit-loop side --------------------------------------------------------

    def pending(self) -> GenerationRecord | None:
        return self._pending

    def applied(self, rec: GenerationRecord) -> None:
        """The fit loop finished resharding onto ``rec``'s membership."""
        self.members = tuple(sorted(rec.members))
        self.generation = rec.generation
        if self._pending is rec:
            self._pending = None

    def close(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.journal is not None:
            self.journal.close()


# --- process-global arming (fit() entry) -------------------------------------

_controller: ElasticController | None = None


def active_controller() -> ElasticController | None:
    return _controller


def install(controller: ElasticController) -> ElasticController:
    global _controller
    if _controller is not None:
        _controller.close()
    _controller = controller
    return _controller


def uninstall() -> None:
    global _controller
    if _controller is not None:
        _controller.close()
    _controller = None


def install_from_env() -> ElasticController | None:
    """Arm this process from the TONY_ELASTIC* env the ElasticRuntime
    exported (idempotent; returns the active controller). No-op outside an
    elastic job."""
    if _controller is not None:
        return _controller
    settings = ElasticSettings.from_env()
    if settings is None:
        return None
    return install(ElasticController(settings))


__all__ = [
    "DEFAULT_TOLERANCE",
    "ENV_ENABLED",
    "ENV_MEMBER",
    "ENV_MEMBERS",
    "ENV_POLL",
    "ENV_SHADOW",
    "ElasticController",
    "ElasticJournal",
    "ElasticSettings",
    "GenerationRecord",
    "active_controller",
    "elastic_dir",
    "generation_path",
    "history_path",
    "install",
    "install_from_env",
    "journal_files",
    "journal_path",
    "read_generation",
    "read_history",
    "read_journal",
    "uninstall",
    "write_generation",
]
