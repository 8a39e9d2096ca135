"""Periodic stack traces out of hung or faulted jobs.

The port's counterpart of ``tony_tpu/obs/diagnostics.py``, under the same
env contract: a job opts in with ``TONY_TPU_DIAGNOSTICS`` (any non-empty
value), and ``TONY_TPU_DIAGNOSTICS_INTERVAL_S`` (default 60) sets the
period. The reference wraps ``cloud_tpu_diagnostics``, which is TPU-only;
here the stdlib ``faulthandler`` writes every thread's Python stack each
period (``dump_traceback_later(repeat=True)``), which is what a wedged
collective or a host stuck in a barrier needs. The traces append to
``<dir>/stack_traces_<pid>.txt``, ``<dir>`` being
``<TONY_APP_DIR>/diagnostics`` under a job, else ``debugging`` in the
temporary directory (the reference library's ``/tmp/debugging``).
"""

from __future__ import annotations

import contextlib
import faulthandler
import logging
import os
import tempfile

log = logging.getLogger(__name__)

ENV_ENABLED = "TONY_TPU_DIAGNOSTICS"
ENV_INTERVAL = "TONY_TPU_DIAGNOSTICS_INTERVAL_S"


def diagnostics_dir() -> str:
    app_dir = os.environ.get("TONY_APP_DIR", "")
    if app_dir:
        return os.path.join(app_dir, "diagnostics")
    return os.path.join(tempfile.gettempdir(), "debugging")


@contextlib.contextmanager
def _stack_dumps(interval: int):
    out_dir = diagnostics_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"stack_traces_{os.getpid()}.txt")
    with open(path, "a", encoding="utf-8") as f:
        faulthandler.dump_traceback_later(interval, repeat=True, file=f)
        log.info("stack-trace collection every %d s into %s", interval, path)
        try:
            yield path
        finally:
            faulthandler.cancel_dump_traceback_later()


def diagnostics_context():
    """Context manager wrapping a training run; nullcontext unless the job
    opted in (``TONY_TPU_DIAGNOSTICS``)."""
    if not os.environ.get(ENV_ENABLED):
        return contextlib.nullcontext()
    raw_interval = os.environ.get(ENV_INTERVAL, "60")
    try:
        interval = int(raw_interval)
    except ValueError:
        log.warning("%s=%r is not an integer; using 60", ENV_INTERVAL, raw_interval)
        interval = 60
    return _stack_dumps(max(interval, 1))


__all__ = ["ENV_ENABLED", "ENV_INTERVAL", "diagnostics_context", "diagnostics_dir"]
