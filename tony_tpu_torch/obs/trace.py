"""Distributed trace spine: the cluster-wide flight recorder.

The repo's observability was a pile of uncorrelated per-component counters
(StepTimer, DecodeMetrics, TaskMonitor samples, ``.jhist`` events) that
cannot be lined up on one timeline — a chaos post-mortem or a TTFT
regression could not answer *where the time went across processes*. This
module is the Dapper-shaped (Sigelman et al., 2010) answer: a near-zero-
overhead process-local span recorder whose trace context propagates
AM→executor via env and through RPC metadata, journaling spans per process
as ``trace/*.jsonl`` under the app dir. ``tony trace <app_id>`` merges the
journals into one Chrome-trace JSON (obs/trace_tool.py).

The contract mirrors the chaos hooks (chaos/faults.py):

- ``span(name)`` / ``instant(name)`` are the ONLY hot-path surfaces. When
  no tracer is armed (the default) they are a single global-load + ``None``
  compare returning a shared no-op — safe to compile into train/serve
  steps (tests/test_perf_guard.py holds this to a few hundred ns).
- A tracer is armed explicitly per process (``install_from_env`` in
  fit() and the serve engine), never as an import side effect. The
  AM-side ``install_from_config`` of the reference waits for the port of
  the job's application master (ROADMAP queue 1, item 10).
- Timestamps are wall-anchored monotonic: ``t0_wall + (mono - t0_mono)``,
  so spans are strictly ordered within a process and line up across
  processes to wall-clock accuracy (same-host chaos runs: exact).
- Completed spans land in a bounded ring drained by a daemon thread; a
  wedged disk can cost trace events (counted in ``dropped``), never stall
  the instrumented path. The journal rotates at ``trace.max_journal_mb``
  (newest window kept, oldest dropped — flight-recorder retention) so an
  always-on long job cannot fill a disk.

This module is the port's copy of ``tony_tpu/obs/trace.py``, stdlib-only
like it. The device-timeline bridge (``torch.profiler.record_function``
with the same span names) lives at the call sites (train/loop.py).
"""

from __future__ import annotations

import atexit
import collections
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any

log = logging.getLogger(__name__)

# env contract (AM -> executor -> user process; see am/app_master.py and
# executor/task_executor.py)
ENV_DIR = "TONY_TRACE_DIR"          # journal directory (arms the process)
ENV_TRACE_ID = "TONY_TRACE_ID"      # shared per-application trace id
ENV_PROC = "TONY_TRACE_PROC"        # this process's journal/display name
ENV_PARENT = "TONY_TRACE_PARENT"    # span id to root this process under
ENV_SAMPLE = "TONY_TRACE_SAMPLE"    # step-sampling stride (train/serve)
ENV_RING = "TONY_TRACE_RING"        # in-memory span ring size
ENV_JOURNAL_MB = "TONY_TRACE_JOURNAL_MB"  # journal rotation size

# gRPC metadata key carrying "<trace_id>/<span_id>" (rpc/service.py)
RPC_METADATA_KEY = "tony-trace-ctx"


class _NoopSpan:
    """The disarmed span: shared, reentrant, attribute-free."""

    __slots__ = ()
    sid = ""

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args: Any) -> "_NoopSpan":
        return self

    def end(self, **args: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def _new_id() -> str:
    return os.urandom(8).hex()


class Span:
    """One recorded operation. Use as a context manager (nesting tracked
    per thread) or hold the handle and call :meth:`end` explicitly
    (cross-step spans like a serve request's decode lifetime)."""

    __slots__ = ("_tracer", "name", "sid", "psid", "args", "_t0", "_ended", "_entered")

    def __init__(self, tracer: "Tracer", name: str, sid: str, psid: str,
                 args: dict[str, Any], t0: float):
        self._tracer = tracer
        self.name = name
        self.sid = sid
        self.psid = psid
        self.args = args
        self._t0 = t0
        self._ended = False
        self._entered = False

    def set(self, **args: Any) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._entered = True
        self._tracer._push_ctx(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._pop_ctx(self)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.end()
        return False

    def end(self, **args: Any) -> None:
        if self._ended:
            return
        self._ended = True
        if args:
            self.args.update(args)
        self._tracer._finish(self)


class Tracer:
    """Process-local recorder journaling to one ``<proc>.jsonl`` file."""

    def __init__(self, path: str, proc: str, trace_id: str, *,
                 sample_steps: int = 16, ring: int = 4096,
                 default_parent: str = "", max_journal_mb: int = 64,
                 flush_interval_s: float = 0.25):
        self.proc = proc
        self.trace_id = trace_id
        self.sample_steps = max(int(sample_steps), 1)
        self.ring_size = max(int(ring), 16)
        self.max_journal_mb = int(max_journal_mb)
        self.default_parent = default_parent
        self.path = path
        self.dropped = 0          # ring overflow (writer slower than spans)
        self._t0_wall = time.time()
        self._t0_mono = time.perf_counter()
        self._ring: collections.deque = collections.deque(maxlen=max(ring, 16))
        self._open: dict[str, Span] = {}  # live spans, for emergency_flush
        self._sample_counts: dict[str, int] = {}  # sampled_span strides
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._tls = threading.local()
        self._max_bytes = max_journal_mb * 2**20
        self._written = 0
        self._closed = False
        self._flush_interval_s = flush_interval_s
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        # append-mode reopen (re-arm cycles, relaunch reusing a proc name):
        # count what's already there or the 2x-cap disk bound breaks
        self._written = self._f.tell()
        self._write_line({
            "ph": "M", "proc": proc, "pid": os.getpid(), "trace": trace_id,
            "t0_us": int(self._t0_wall * 1e6),
        })
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drain_loop, daemon=True, name="tony-trace-flush"
        )
        self._thread.start()

    # --- recording ------------------------------------------------------------

    def _now_us(self) -> int:
        return int((self._t0_wall + (time.perf_counter() - self._t0_mono)) * 1e6)

    def _ts_us(self, mono: float) -> int:
        return int((self._t0_wall + (mono - self._t0_mono)) * 1e6)

    def span(self, name: str, *, parent: str | None = None, **args: Any) -> Span:
        """Start a span NOW. Parent resolution: explicit ``parent`` >
        current thread's innermost entered span > the process default
        (``TONY_TRACE_PARENT``, i.e. the launcher's span)."""
        if parent is None:
            cur = self._current()
            parent = cur.sid if cur is not None else self.default_parent
        sp = Span(self, name, _new_id(), parent, dict(args), time.perf_counter())
        with self._lock:
            self._open[sp.sid] = sp
        return sp

    def sampled_span(self, name: str, *, parent: str | None = None,
                     **args: Any) -> "Span | _NoopSpan":
        """Every ``sample_steps``-th call per name starts a span carrying
        ``every=sample_steps``; the rest return the shared no-op. ONE owner
        for the stride counter and the ``every`` arg — the goodput roll-up
        multiplies span duration by ``every`` (obs/trace_tool.py), so a
        call site that re-implemented sampling and forgot the arg would
        silently undercount productive time by the stride. Callers can
        test ``is NOOP_SPAN`` to gate sampled-only work (e.g. the train
        loop's device sync)."""
        with self._lock:
            n = self._sample_counts[name] = self._sample_counts.get(name, 0) + 1
        if n % self.sample_steps:
            return NOOP_SPAN
        return self.span(name, parent=parent, every=self.sample_steps, **args)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker (chaos fault injections, aborts)."""
        self._enqueue({
            "ph": "i", "name": name, "ts": self._now_us(),
            "tid": threading.get_native_id(), "args": args,
        })

    def counter(self, name: str, **values: float) -> None:
        """A counter-track sample (Chrome ``ph: "C"``): each numeric kwarg
        becomes one series on the ``name`` track in the merged timeline
        (the HBM observatory emits per-device live/peak memory this way,
        obs/hbm.py)."""
        self._enqueue({
            "ph": "C", "name": name, "ts": self._now_us(), "args": values,
        })

    def _finish(self, span: Span) -> None:
        end = time.perf_counter()
        self._enqueue({
            "ph": "X", "name": span.name, "ts": self._ts_us(span._t0),
            "dur": max(int((end - span._t0) * 1e6), 0),
            "tid": threading.get_native_id(), "sid": span.sid,
            "psid": span.psid, "args": span.args,
        })

    def _enqueue(self, rec: dict) -> None:
        with self._lock:
            if rec.get("ph") == "X":
                self._open.pop(rec["sid"], None)
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)

    # --- thread-local nesting -------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _current(self) -> Span | None:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def _push_ctx(self, span: Span) -> None:
        self._stack().append(span)

    def _pop_ctx(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()

    def ctx(self) -> str:
        """Propagation context for the current thread: ``trace_id/span_id``."""
        cur = self._current()
        return f"{self.trace_id}/{cur.sid if cur is not None else self.default_parent}"

    # --- journaling -----------------------------------------------------------

    def _write_line(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        if self._written + len(line) > self._max_bytes:
            self._rotate()
        self._written += len(line)
        self._f.write(line)

    def _rotate(self) -> None:
        """Flight-recorder retention at the size cap: the current journal
        becomes ``<proc>.0.jsonl`` (replacing the previous rotated window)
        and a fresh file starts, so the NEWEST events survive — a post-
        mortem needs the crash window, not day one. Disk stays bounded at
        ~2x ``trace.max_journal_mb``; load_journals merges both windows."""
        try:
            self._f.close()
        except Exception:
            pass
        base, ext = os.path.splitext(self.path)
        os.replace(self.path, base + ".0" + ext)
        self._f = open(self.path, "w", encoding="utf-8")
        self._written = 0
        self._write_line({
            "ph": "M", "proc": self.proc, "pid": os.getpid(),
            "trace": self.trace_id, "rotated": True,
        })

    def flush(self) -> None:
        """Drain the ring to disk. Called by the flusher thread, at close,
        and by the chaos injector right before a SIGKILL fault so the
        fatal instant event outlives the process. A write error (ENOSPC,
        torn-down fs) costs the popped batch — counted in ``dropped``,
        never raised into the instrumented path."""
        with self._lock:
            if not self._ring:
                return
            recs = list(self._ring)
            self._ring.clear()
        # the io lock EXISTS to serialize journal writes (flusher thread vs
        # close vs pre-SIGKILL emergency flush); span producers never take
        # it — the ring decouples them — so holding it across file I/O is
        # the design, not a stall hazard
        with self._io_lock:
            if self._closed:
                # lost the race with close(): the popped batch can no longer
                # land, but the loss-accounting contract still holds
                with self._lock:
                    self.dropped += len(recs)
                return
            try:
                for r in recs:
                    self._write_line(r)  # graft-lint: disable=GL004
                self._f.flush()  # graft-lint: disable=GL004
            except OSError:
                with self._lock:
                    self.dropped += len(recs)  # upper bound: some may have landed

    def _open_records(self) -> list[dict]:
        """Snapshot the spans still OPEN as ``ph: "B"`` (begin-only)
        records. ``fts`` is the flush wall time — for a span that never
        ends (SIGKILL, unwound exception) it is the best available end
        proxy, which goodput uses to price relaunch dead time."""
        with self._lock:
            opens = list(self._open.values())
        fts = self._now_us()
        return [{
            "ph": "B", "name": sp.name, "ts": self._ts_us(sp._t0),
            "fts": fts, "sid": sp.sid, "psid": sp.psid, "args": sp.args,
        } for sp in opens]

    def emergency_flush(self) -> None:
        """flush() plus the spans still OPEN, journaled as begin-only
        records. Called by the chaos injector right before a SIGKILL: the
        spans the fault interrupts are exactly the ones the post-mortem
        needs, and they would otherwise die un-ended with the process
        (merge_chrome turns them into Chrome "B" events, which Perfetto
        renders as running until trace end)."""
        self.flush()
        recs = self._open_records()
        with self._io_lock:  # serializes journal I/O by design (see flush)
            if self._closed:
                return
            try:
                for r in recs:
                    self._write_line(r)  # graft-lint: disable=GL004
                self._f.flush()  # graft-lint: disable=GL004
            except OSError:
                with self._lock:
                    self.dropped += len(recs)

    def _drain_loop(self) -> None:
        # the thread outlives write errors: flush() swallows OSError (batch
        # counted as dropped) and a recovered disk resumes journaling
        while not self._stop.wait(self._flush_interval_s):
            try:
                self.flush()
            except Exception:
                pass

    def close(self, join_timeout_s: float = 2.0) -> None:
        """Stop the flusher, JOIN it (bounded), flush the residual ring,
        then journal still-open spans and close the file.

        The join is the shutdown contract for short-lived processes (CLI
        tools, chaos-killed children that catch the signal and exit): a
        daemon flusher abandoned mid-write at interpreter teardown would
        tear its current line AND make the subsequent residual flush race
        ``_closed`` — dropping the last window of spans, exactly the ones
        a post-mortem needs. Joining first means the drain loop has fully
        exited before the final flush drains what remains, so nothing is
        in flight. The timeout is bounded so a wedged disk (hard-mounted
        FS) can never hang process exit; whatever the wedged thread held
        is counted in ``dropped``, per the loss-accounting contract."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=max(join_timeout_s, 0.0))
            if thread.is_alive():
                # the flusher is wedged mid-write (hard-mounted FS) and may
                # hold _io_lock: touching the journal now would block
                # process exit on that lock — the very hang the bounded
                # join exists to prevent. Abandon the residual ring
                # (counted in ``dropped``) and leave the file to the OS.
                with self._lock:
                    self.dropped += len(self._ring)
                    self._ring.clear()
                # benign race: the wedged writer re-checks _closed under
                # _io_lock and drops its batch if it ever unwedges
                self._closed = True
                return
        try:
            self.flush()
        except Exception:
            pass
        # spans still open at shutdown (an exception unwound past their
        # holder, a Ctrl-C'd supervise loop) journal as begin-only records
        # — same rescue as a chaos SIGKILL, or the trace root (am.run,
        # executor.user_process) silently vanishes from the merge
        try:
            opens = self._open_records()
        except Exception:
            opens = []
        with self._io_lock:  # serializes journal I/O by design (see flush)
            if self._closed:
                return
            self._closed = True
            try:
                for r in opens:
                    self._write_line(r)  # graft-lint: disable=GL004
            except Exception:
                pass
            if self.dropped:
                try:
                    self._f.write(json.dumps(  # graft-lint: disable=GL004
                        {"ph": "M", "proc": self.proc, "dropped": self.dropped}
                    ) + "\n")
                except Exception:
                    pass
            try:
                self._f.close()
            except Exception:
                pass


# --- process-global arming ---------------------------------------------------

_tracer: Tracer | None = None


def active_tracer() -> Tracer | None:
    return _tracer


def span(name: str, **args: Any):
    """The instrumentation seam. Disarmed: one global load + ``None``
    compare, returns the shared no-op span."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return t.span(name, **args)


def instant(name: str, **args: Any) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)


def flush() -> None:
    t = _tracer
    if t is not None:
        t.flush()


def emergency_flush() -> None:
    """Pre-SIGKILL flush: completed AND still-open spans hit the journal."""
    t = _tracer
    if t is not None:
        t.emergency_flush()


def install(tracer: Tracer) -> Tracer:
    global _tracer
    if _tracer is not None and _tracer is not tracer:
        atexit.unregister(_tracer.close)  # arm/disarm cycles must not pile up
        _tracer.close()
    _tracer = tracer
    atexit.register(tracer.close)
    return tracer


def uninstall() -> None:
    """Disarm (tests). Closes and detaches the active tracer."""
    global _tracer
    if _tracer is not None:
        atexit.unregister(_tracer.close)
        _tracer.close()
        _tracer = None


def trace_id_for(app_id: str) -> str:
    """Deterministic per-application trace id: every process of the job
    derives the same id from TONY_APP_ID with no coordination."""
    return hashlib.md5(app_id.encode()).hexdigest()[:16]


def sanitize_proc(name: str) -> str:
    """Journal/snapshot-safe proc name — ONE shared rule, because the name
    keys the ``trace/<proc>.jsonl`` <-> ``metrics/<proc>.json`` correlation."""
    return name.replace(":", "_").replace("/", "_")


def default_proc_name(kind: str = "proc") -> str:
    """This process's journal/snapshot name: the AM-exported TONY_TRACE_PROC
    when present, else derived from the task identity env. The name is
    load-bearing — `tony trace` and the portal correlate ``trace/<proc>.jsonl``
    with ``metrics/<proc>.json`` by it — so every caller (install_from_env,
    fit(), the serve engine) must share ONE derivation."""
    proc = os.environ.get(ENV_PROC, "")
    if not proc:
        job = os.environ.get("TONY_JOB_NAME", kind)
        idx = os.environ.get("TONY_TASK_INDEX", "0")
        proc = f"{job}_{idx}_user"
    return sanitize_proc(proc)


def install_from_env(proc: str = "") -> Tracer | None:
    """Arm this process from the TONY_TRACE_* env the launcher exported.
    Idempotent; returns the active tracer, or None when tracing is off."""
    if _tracer is not None:
        return _tracer
    trace_dir = os.environ.get(ENV_DIR, "")
    if not trace_dir:
        return None
    proc = sanitize_proc(proc) if proc else default_proc_name()
    trace_id = os.environ.get(ENV_TRACE_ID, "") or trace_id_for(
        os.environ.get("TONY_APP_ID", "app")
    )
    def _env_int(key: str, default: int) -> int:
        try:
            return int(os.environ.get(key, "") or default)
        except ValueError:
            return default

    try:
        return install(Tracer(
            os.path.join(trace_dir, f"{proc}.jsonl"), proc, trace_id,
            sample_steps=_env_int(ENV_SAMPLE, 16),
            ring=_env_int(ENV_RING, 4096),
            max_journal_mb=_env_int(ENV_JOURNAL_MB, 64),
            default_parent=os.environ.get(ENV_PARENT, ""),
        ))
    except OSError:
        log.warning("could not open trace journal in %s", trace_dir, exc_info=True)
        return None


__all__ = [
    "ENV_DIR", "ENV_PARENT", "ENV_PROC", "ENV_SAMPLE", "ENV_TRACE_ID",
    "NOOP_SPAN", "RPC_METADATA_KEY", "Span", "Tracer", "active_tracer",
    "default_proc_name", "emergency_flush", "flush", "install",
    "install_from_env", "instant", "sanitize_proc",
    "span", "trace_id_for", "uninstall",
]
