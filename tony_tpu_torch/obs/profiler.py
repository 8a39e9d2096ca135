"""Profiler glue: ``torch.profiler`` behind one capture primitive.

The port's counterpart of ``tony_tpu/obs/profiler.py``.
:func:`trace_window` records everything inside its block, host ops and
(on a card) the CUDA kernels and copies, and writes it as one Chrome trace
(``trace.json``) into ``log_dir`` when the block exits:

    with trace_window("/tmp/trace", enabled=step == 10) as cap:
        state, metrics = step_fn(state, ...)
        float(metrics["loss"])
    print(cap.path)  # the trace file the capture landed in

``trace_window`` is the ONE capture primitive: the coordinated profiler
(obs/profile.py) drives it too. The reference's ``start_server`` (a TCP
endpoint for remote jax.profiler capture) has no counterpart here.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


class CaptureHandle:
    """Where a trace_window capture landed. ``path`` is the Chrome trace
    file written at exit; empty until the window finalises, and it stays
    empty when finalisation failed (the ``ok`` flag says which)."""

    __slots__ = ("log_dir", "path", "ok")

    def __init__(self, log_dir: str = ""):
        self.log_dir = log_dir
        self.path = ""
        self.ok = False


@contextlib.contextmanager
def trace_window(log_dir: str, enabled: bool = True):
    """Trace everything inside the block (host ops, and CUDA activity
    where there is a card) and write ``<log_dir>/trace.json``; yields a
    :class:`CaptureHandle` whose ``path`` is that file once the block
    exits. The device is synchronized before the profiler stops, so the
    block's kernels are in the trace. Finalisation is try/finally: an
    exception inside the traced block still stops the profiler and writes
    the partial trace."""
    handle = CaptureHandle(log_dir)
    if not enabled:
        yield handle
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield handle
    finally:
        # a stop/export failure is logged, never raised: raising here would
        # mask an in-flight exception from the traced block
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            path = os.path.join(log_dir, TRACE_FILE)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception:
            log.warning("profiler trace finalisation failed for %s", log_dir,
                        exc_info=True)
        else:
            handle.ok = True
            handle.path = path
            log.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named region in traces: ``with annotate('data-load'): ...``"""
    return torch.profiler.record_function(name)


__all__ = ["CaptureHandle", "TRACE_FILE", "annotate", "trace_window"]
