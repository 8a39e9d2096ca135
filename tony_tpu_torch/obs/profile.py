"""Fleet-coordinated profiling: the broadcast capture window. The port's
counterpart of ``tony_tpu/obs/profile.py``.

A window is requested by writing ``<app_dir>/profile/request.json``
(:func:`write_request`, the reference's AM broadcast; in process
:meth:`ProfileController.trigger`). Each armed process's
:class:`ProfileController` picks the request up (a daemon watcher polls
the file; the check also runs synchronously at arm time, so a request
staged before launch is honoured exactly) and, at the next
``maybe_capture()`` step boundary, opens a ``torch.profiler`` capture
through the ONE capture primitive (obs/profiler.trace_window), brackets
each captured step with a ``record_function`` region named
:data:`STEP_ANNOTATION`, and records host boundary timings and per-step
input wait. After N steps (or T seconds) the controller stops the
capture, which lands as a Chrome trace in
``<app_dir>/profile/<proc>/<id>/trace.json``, and writes
``manifest.json`` beside it. PyTorch runs eagerly, so there is no compile
ledger to snapshot with it; the comms ledger's rows of the window
(``obs/comms.py``, what the collectives moved) land beside it as
``comms.json`` instead, which ``obs/anatomy.py`` reads.

:func:`maybe_capture` holds the disarmed-hook contract (the trace, hbm,
health and series twins): disarmed it is ONE global load + ``None``
compare; armed outside a window it is two attribute loads + compares.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process, next to TONY_TRACE_* /
# TONY_OBS_HBM* / TONY_OBS_HEALTH* / TONY_OBS_SERIES*)
ENV_ENABLED = "TONY_OBS_PROFILE"                 # "0" disables arming
ENV_POLL = "TONY_OBS_PROFILE_POLL_S"             # request-file poll cadence
ENV_MAX_STEPS = "TONY_OBS_PROFILE_MAX_STEPS"     # per-window step cap

REQUEST_FILE = "request.json"
MANIFEST_FILE = "manifest.json"
# device-timeline step bracket: the anatomy report aligns device events to
# step windows by these annotation spans (obs/anatomy.py reads the name)
STEP_ANNOTATION = "anatomy.step"

# a request older than this can never arm a capture: a worker relaunched
# hours later must not re-profile a long-forgotten window
DEFAULT_TTL_S = 600.0


@dataclass(frozen=True)
class ProfileRequest:
    """One broadcast capture window (the request.json payload)."""

    id: str
    steps: int = 0            # capture N steps (0 -> duration_s)
    duration_s: float = 0.0   # wall-clock window when steps == 0
    issued_ts: float = 0.0
    deadline_ts: float = 0.0  # watchers ignore the request past this

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileRequest":
        return cls(
            id=str(d.get("id", "")),
            steps=int(d.get("steps", 0) or 0),
            duration_s=float(d.get("duration_s", 0.0) or 0.0),
            issued_ts=float(d.get("issued_ts", 0.0) or 0.0),
            deadline_ts=float(d.get("deadline_ts", 0.0) or 0.0),
        )


def profile_dir(app_dir: str) -> str:
    return os.path.join(app_dir, "profile")


def request_path(app_dir: str) -> str:
    return os.path.join(profile_dir(app_dir), REQUEST_FILE)


def write_request(app_dir: str, *, steps: int = 0, duration_s: float = 0.0,
                  ttl_s: float = DEFAULT_TTL_S) -> ProfileRequest:
    """The AM's broadcast: atomically publish one capture window for every
    process of the job. The id is time-ordered and unique per request, so
    a repeated ``tony profile`` yields distinct artifact dirs."""
    now = time.time()
    req = ProfileRequest(
        id=f"p{int(now)}_{os.urandom(3).hex()}",
        steps=max(int(steps), 0),
        duration_s=max(float(duration_s), 0.0),
        issued_ts=now,
        deadline_ts=now + max(float(duration_s), 0.0) + max(ttl_s, 1.0),
    )
    path = request_path(app_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(req.to_dict(), f)
    os.replace(tmp, path)
    return req


def read_request(path: str) -> ProfileRequest | None:
    try:
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or not d.get("id"):
        return None
    return ProfileRequest.from_dict(d)


class ProfileController:
    """Per-process capture state machine driven from the step loop.

    ``maybe_capture()`` (the module seam) forwards to :meth:`step`:

    - no pending request and no active window: two attribute loads — the
      armed-but-idle cost, held to the same perf budget as the other
      observatory seams;
    - a pending request: the window OPENS at this boundary (device trace
      starts, the step annotation enters);
    - an active window: one boundary — host step time + input wait
      recorded, annotation re-entered; the window CLOSES here once the
      requested steps (or seconds, or the request deadline) are spent.

    The controller never raises into the step loop: a failing profiler
    (already tracing, unwritable disk) marks the request consumed and logs.
    """

    def __init__(self, out_root: str, proc: str, *,
                 request_path: str = "", poll_interval_s: float = 0.5,
                 max_steps: int = 64, watch: bool = True):
        self.out_root = out_root
        self.proc = proc
        self.max_steps = max(int(max_steps), 1)
        self._request_path = request_path
        self._poll_interval_s = max(float(poll_interval_s), 0.05)
        self._req: ProfileRequest | None = None   # active window
        self._pending: ProfileRequest | None = None
        self._last_id = ""
        self._last_mtime = 0.0
        self._window = None       # trace_window context manager
        self._handle = None       # CaptureHandle
        self._ann = None          # entered record_function region
        self._out_dir = ""
        self._t0_wall = 0.0
        self._t0 = 0.0
        self._boundaries: list[float] = []
        self._waits: list[float] = []
        self._comms_mark: dict = {}
        self._stop_evt = threading.Event()
        self._thread = None
        if request_path and watch:
            # synchronous first check: a request staged before this process
            # armed (the e2e path — tony profile issued while workers boot)
            # is picked up deterministically at the first step boundary
            self.check_request()
            self._thread = threading.Thread(
                target=self._watch_loop, daemon=True, name="tony-profile-watch"
            )
            self._thread.start()

    # --- request watching -----------------------------------------------------

    def _watch_loop(self) -> None:
        while not self._stop_evt.wait(self._poll_interval_s):
            try:
                self.check_request()
            except Exception:
                log.debug("profile request check failed", exc_info=True)

    def check_request(self) -> None:
        """Stat + parse the broadcast file; arm ``_pending`` on a new,
        unexpired request id. Runs on the watcher thread (and once at
        construction); the step loop only ever reads ``_pending``."""
        try:
            mtime = os.stat(self._request_path).st_mtime
        except OSError:
            return
        if mtime == self._last_mtime:
            return
        self._last_mtime = mtime
        req = read_request(self._request_path)
        if req is None or req.id == self._last_id:
            return
        if req.deadline_ts and time.time() > req.deadline_ts:
            self._last_id = req.id  # expired: consumed, never armed
            return
        self._last_id = req.id
        self._pending = req
        log.info("profile request %s armed (steps=%d duration_s=%.1f)",
                 req.id, req.steps, req.duration_s)

    def trigger(self, steps: int = 0, duration_s: float = 0.0,
                ttl_s: float = DEFAULT_TTL_S) -> ProfileRequest:
        """Arm a window directly (tests, bench) — the in-process twin of
        the AM broadcast."""
        now = time.time()
        req = ProfileRequest(
            id=f"p{int(now)}_{os.urandom(3).hex()}", steps=int(steps),
            duration_s=float(duration_s), issued_ts=now,
            deadline_ts=now + max(float(duration_s), 0.0) + max(ttl_s, 1.0),
        )
        self._last_id = req.id
        self._pending = req
        return req

    # --- step-loop side -------------------------------------------------------

    def step(self, fetch_s: float = 0.0, **args: Any) -> None:
        req = self._req
        if req is None:
            pending = self._pending
            if pending is None:
                return
            self._pending = None
            self._start(pending)
            return
        self._boundary(fetch_s)

    def _start(self, req: ProfileRequest) -> None:
        if req.deadline_ts and time.time() > req.deadline_ts:
            return
        steps = min(req.steps, self.max_steps) if req.steps else 0
        if req.steps and steps < req.steps:
            log.warning("profile %s: steps clamped %d -> %d "
                        "(obs.profile.max_steps)", req.id, req.steps, steps)
            req = ProfileRequest(
                id=req.id, steps=steps, duration_s=req.duration_s,
                issued_ts=req.issued_ts, deadline_ts=req.deadline_ts,
            )
        try:
            from tony_tpu_torch.obs.profiler import annotate, trace_window

            self._out_dir = os.path.join(self.out_root, self.proc, req.id)
            os.makedirs(self._out_dir, exist_ok=True)
            self._window = trace_window(self._out_dir)
            self._handle = self._window.__enter__()
            self._ann = annotate(STEP_ANNOTATION)
            self._ann.__enter__()
        except Exception:
            # a wedged profiler (already tracing, read-only dir) must never
            # cost a step; the request is consumed so it cannot retry-loop
            log.warning("profile %s: capture failed to start", req.id,
                        exc_info=True)
            self._abort_window()
            return
        from tony_tpu_torch.obs import comms

        self._comms_mark = comms.mark()
        self._req = req
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()
        self._boundaries = [self._t0]
        self._waits = []
        from tony_tpu_torch.obs import trace

        trace.instant("profile.capture_start", id=req.id, steps=req.steps)
        log.info("profile %s: capturing into %s", req.id, self._out_dir)

    def _boundary(self, fetch_s: float) -> None:
        req = self._req
        now = time.perf_counter()
        self._boundaries.append(now)
        self._waits.append(round(float(fetch_s), 6))
        done = False
        captured = len(self._boundaries) - 1
        if req.steps and captured >= req.steps:
            done = True
        elif captured >= self.max_steps:
            # duration-based windows honour the step cap too: a fast step
            # loop under `--seconds T` must not record an unbounded trace
            done = True
        elif req.duration_s and now - self._t0 >= req.duration_s:
            done = True
        elif req.deadline_ts and time.time() > req.deadline_ts:
            done = True
        if done:
            self._stop()
            return
        try:
            # re-enter the bracket so each captured step is one annotation
            # span on the timeline (the anatomy report's alignment)
            self._ann.__exit__(None, None, None)
            self._ann.__enter__()
        except Exception:
            self._ann = None

    def finish(self) -> None:
        """Close an open window (loop teardown, Engine.close): a capture
        interrupted mid-window still lands its manifest + partial trace."""
        if self._req is not None:
            self._stop()

    def _stop(self) -> None:
        req = self._req
        self._req = None
        try:
            if self._ann is not None:
                self._ann.__exit__(None, None, None)
        except Exception:
            pass
        self._ann = None
        artifact = ""
        try:
            if self._window is not None:
                self._window.__exit__(None, None, None)
                if self._handle is not None and self._handle.ok:
                    artifact = self._handle.path
        except Exception:
            log.warning("profile %s: capture failed to finalise", req.id,
                        exc_info=True)
        self._window = None
        self._handle = None
        from tony_tpu_torch.obs import comms

        comms.write_window(self._out_dir, self._comms_mark)
        steps = max(len(self._boundaries) - 1, 0)
        manifest = {
            "profile_id": req.id,
            "proc": self.proc,
            "steps": steps,
            "steps_requested": req.steps,
            "duration_s": req.duration_s,
            "t0_ts": round(self._t0_wall, 6),
            "ts": round(time.time(), 6),
            "step_time_s": [
                round(b - a, 6)
                for a, b in zip(self._boundaries, self._boundaries[1:])
            ],
            "input_wait_s": list(self._waits),
            "artifact": artifact,
            "out_dir": self._out_dir,
        }
        path = os.path.join(self._out_dir, MANIFEST_FILE)
        try:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
            os.replace(tmp, path)
        except OSError:
            log.warning("profile %s: manifest write failed", req.id,
                        exc_info=True)
        from tony_tpu_torch.obs import trace

        trace.instant("profile.capture_end", id=req.id, steps=steps)
        log.info("profile %s: captured %d step(s) -> %s",
                 req.id, steps, artifact or self._out_dir)

    def _abort_window(self) -> None:
        try:
            if self._window is not None:
                self._window.__exit__(None, None, None)
        except Exception:
            pass
        self._window = None
        self._handle = None
        self._ann = None

    def close(self) -> None:
        self._stop_evt.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self.finish()


# --- process-global arming (the trace/hbm/health/series pattern) --------------

_controller: ProfileController | None = None


def active_controller() -> ProfileController | None:
    return _controller


def install(controller: ProfileController) -> ProfileController:
    global _controller
    if _controller is not None and _controller is not controller:
        _controller.close()
    _controller = controller
    return controller


def uninstall() -> None:
    global _controller
    if _controller is not None:
        _controller.close()
        _controller = None


def maybe_capture(**args: Any) -> None:
    """The hot-path seam (train/serve step loops). Disarmed: one global
    load + ``None`` compare; armed outside a window: two attribute
    compares. Call sites must pass precomputed names only (graft-lint
    GL005 enforces this like the trace/chaos/hbm/health/series hooks)."""
    c = _controller
    if c is not None:
        c.step(**args)


def finish_capture() -> None:
    """Close an open window at loop teardown (fit finally, Engine.close)."""
    c = _controller
    if c is not None:
        c.finish()


def install_from_env(proc: str = "") -> ProfileController | None:
    """Arm this process from the ``TONY_OBS_PROFILE*`` env the AM exported.
    Needs a job app dir (the broadcast file and artifact root live there);
    idempotent; ``TONY_OBS_PROFILE=0`` disables."""
    if _controller is not None:
        return _controller
    if os.environ.get(ENV_ENABLED, "") == "0":
        return None
    app_dir = os.environ.get("TONY_APP_DIR", "")
    if not app_dir:
        return None

    def _env_float(key: str, default: float) -> float:
        try:
            return float(os.environ.get(key, "") or default)
        except ValueError:
            return default

    from tony_tpu_torch.obs import trace

    proc = trace.sanitize_proc(proc) if proc else trace.default_proc_name()
    return install(ProfileController(
        profile_dir(app_dir), proc,
        request_path=request_path(app_dir),
        poll_interval_s=_env_float(ENV_POLL, 0.5),
        max_steps=int(_env_float(ENV_MAX_STEPS, 64)),
    ))


# --- read paths (tony profile report, anatomy, tests) -------------------------


def read_manifests(app_dir: str,
                   profile_id: str = "") -> dict[str, dict]:
    """Every per-process capture manifest under ``<app_dir>/profile/``
    (proc -> manifest), optionally filtered to one profile id. When no id
    is given, the NEWEST id any process captured wins — the common read
    is "the capture I just asked for"."""
    root = profile_dir(app_dir)
    found: list[dict] = []
    try:
        procs = sorted(os.listdir(root))
    except OSError:
        return {}
    for proc in procs:
        pdir = os.path.join(root, proc)
        if not os.path.isdir(pdir):
            continue
        for cap_id in sorted(os.listdir(pdir)):
            path = os.path.join(pdir, cap_id, MANIFEST_FILE)
            try:
                with open(path, encoding="utf-8") as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(m, dict) and m.get("profile_id"):
                found.append(m)
    if not found:
        return {}
    if not profile_id:
        profile_id = max(found, key=lambda m: m.get("ts", 0.0))["profile_id"]
    return {
        m["proc"]: m for m in found if m["profile_id"] == profile_id
    }


def list_captures(app_dir: str) -> list[str]:
    """Distinct capture ids with at least one landed manifest (newest
    last) — the `tony trace` summary's pointer at available anatomies."""
    root = profile_dir(app_dir)
    ids: dict[str, float] = {}
    try:
        procs = sorted(os.listdir(root))
    except OSError:
        return []
    for proc in procs:
        pdir = os.path.join(root, proc)
        if not os.path.isdir(pdir):
            continue
        for cap_id in sorted(os.listdir(pdir)):
            path = os.path.join(pdir, cap_id, MANIFEST_FILE)
            try:
                ts = os.stat(path).st_mtime
            except OSError:
                continue
            ids[cap_id] = max(ids.get(cap_id, 0.0), ts)
    return [i for i, _ in sorted(ids.items(), key=lambda kv: kv[1])]


__all__ = [
    "ENV_ENABLED", "ENV_MAX_STEPS", "ENV_POLL", "MANIFEST_FILE",
    "ProfileController", "ProfileRequest", "REQUEST_FILE", "STEP_ANNOTATION",
    "active_controller", "finish_capture", "install", "install_from_env",
    "list_captures", "maybe_capture", "profile_dir", "read_manifests",
    "read_request", "request_path", "uninstall", "write_request",
]
