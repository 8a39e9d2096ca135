"""Bounded device prefetch for batch streams: make batch N+1 and copy it to
the device while the device runs step N.

The port's copy of ``tony_tpu/train/prefetch.py``'s
:class:`PrefetchIterator`: one background thread feeds a bounded FIFO
queue, so the consumer sees exactly the wrapped iterator's sequence, an
exception in the producer is re-raised from ``next()``, and ``close()``
stops and joins the thread.

Device placement (``device=`` a CUDA device) goes through pinned host
memory: the producer copies each batch with ``non_blocking=True`` on a
side stream of its own and records an event after the copy. The
consumer's ``next()`` makes its current stream wait on that event and
marks the tensors as used on that stream, so a step never reads a batch
still in flight and the allocator never hands its memory to the side
stream while the step may still read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

import torch

T = TypeVar("T")

_END = object()  # wrapped iterator exhausted


def to_device(batch: tuple[torch.Tensor, ...], device: torch.device
              ) -> tuple[torch.Tensor, ...]:
    """Copy a batch to ``device`` on the current stream (pinned host memory
    and ``non_blocking`` for CUDA, so later work on the stream is ordered
    after the copy)."""
    if device.type == "cuda":
        return tuple(t.pin_memory().to(device, non_blocking=True) for t in batch)
    return tuple(t.to(device) for t in batch)


class PrefetchIterator(Iterator[T]):
    """Wrap ``it`` so up to ``depth`` items are produced ahead of the
    consumer on a daemon thread, and placed on ``device`` when one is
    given. ``depth`` must be >= 1."""

    def __init__(self, it: Iterator[T], depth: int = 2, name: str = "tony-prefetch",
                 device: torch.device | str | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = it  # kept so close() can release the stream's resources
        self._device = None if device is None else torch.device(device)
        self._copy_stream = None
        if self._device is not None and self._device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self._device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(
            target=self._produce, args=(it,), name=name, daemon=True
        )
        self._thread.start()

    def _place(self, item):
        """(item on the device, the copy's event or None)."""
        if self._device is None:
            return item, None
        if self._copy_stream is None:
            return to_device(item, self._device), None
        with torch.cuda.stream(self._copy_stream):
            placed = to_device(item, self._device)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return placed, done

    def _produce(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                entry = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(entry, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as e:  # surfaced from next()
            self._err = e
        # unblock a consumer waiting on get() (exhaustion or error)
        while not self._stop.is_set():
            try:
                self._q.put(_END, timeout=0.1)
                break
            except queue.Full:
                continue

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        while True:
            try:
                entry = self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive():
                    # producer died without posting _END: never hang the loop
                    if self._err is not None:
                        raise self._err
                    raise StopIteration
                continue
            if entry is _END:
                self._q.put(_END)  # keep later next() calls terminal
                if self._err is not None:
                    raise self._err
                raise StopIteration
            item, done = entry
            if done is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(done)
                for t in item:
                    t.record_stream(stream)
            return item

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and join it; safe to call more than once."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        if not self._thread.is_alive():
            wrapped_close = getattr(self._it, "close", None)
            if callable(wrapped_close):
                try:
                    wrapped_close()
                except Exception:
                    pass

    def __enter__(self) -> "PrefetchIterator[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # last-resort cleanup for unclosed streams
        try:
            self.close(timeout=1.0)
        except Exception:
            pass


def close_batches(it) -> None:
    """Shut down a stream returned by ``make_batches`` if it owns a thread;
    plain generators are a no-op."""
    close = getattr(it, "close", None)
    if callable(close):
        close()


__all__ = ["PrefetchIterator", "close_batches", "to_device"]
