"""ctypes binding for the native token loader (``native/tonyloader.cpp``).

The port's counterpart of ``tony_tpu/train/native_loader.py``, over its
own copy of the C++ source. The loader prefetches shuffled (seq_len+1)-
token windows from a memory-mapped corpus on a native thread, off the
GIL, so the trainer's host step overlaps its input IO. It is built at
first use with ``g++`` (a plain C ABI, no Python headers) into
``csrc/build/libtonyloader-<hash>.so``, the hash over the source and the
flags, written under a temporary name and renamed, so rank processes
racing the first build each load a whole library.

``available()`` is False when there is no compiler or the build fails;
``train/data.py`` then falls back to sequential mmap windows in one
process and raises in a multi-process run, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent.parent / "native" / "tonyloader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libtonyloader-{digest}.so"


def _load() -> ctypes.CDLL | None:
    global _lib
    # the lock serializes the one-time build across threads racing the first
    # loader; after that it guards a cached-handle read
    with _lock:
        if _lib is not None:
            return _lib
        if not _SRC.exists():
            return None
        lib_path = library_path()
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.tmp{os.getpid()}")
            try:
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, lib_path)
            except (OSError, subprocess.SubprocessError) as e:
                log.warning("native loader build failed: %s", e)
                tmp.unlink(missing_ok=True)
                return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            log.warning("native loader load failed: %s", e)
            return None
        lib.tl_open.restype = ctypes.c_void_p
        lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                ctypes.c_long, ctypes.c_long, ctypes.c_ulonglong]
        lib.tl_next.restype = ctypes.c_long
        lib.tl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.tl_windows_per_epoch.restype = ctypes.c_long
        lib.tl_windows_per_epoch.argtypes = [ctypes.c_void_p]
        lib.tl_seek.restype = None
        lib.tl_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.tl_close.restype = None
        lib.tl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeTokenLoader:
    """Shuffled, prefetched batches from a flat int32 token file.

    Yields ``[batch, seq_len+1]`` int32 arrays; each epoch covers every
    window of this shard exactly once in a seeded order. ``seek(step)``
    positions the stream where step N would have read."""

    def __init__(self, path: str, seq_len: int, batch: int,
                 n_shards: int = 1, shard_id: int = 0, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++ or build failed)")
        self._lib = lib
        self._handle = lib.tl_open(path.encode(), seq_len, batch, n_shards, shard_id, seed)
        if not self._handle:
            raise ValueError(
                f"tl_open failed for {path!r} (missing file, too few windows "
                f"for batch={batch} x shards={n_shards}, or shard_id "
                f"{shard_id} outside [0, {n_shards}))")
        self.batch = batch
        self.window = seq_len + 1
        self._buf = np.empty((batch, self.window), np.int32)

    @property
    def steps_per_epoch(self) -> int:
        return self._lib.tl_windows_per_epoch(self._handle)

    def seek(self, step: int) -> None:
        self._lib.tl_seek(self._handle, step)

    def _fill(self) -> None:
        rc = self._lib.tl_next(self._handle,
                               self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError("native loader stopped")

    def next(self) -> np.ndarray:
        self._fill()
        return self._buf.copy()

    def next_into(self, inputs: np.ndarray, targets: np.ndarray) -> None:
        """Read the next window's pre-shifted (inputs, targets) pair into
        caller-owned contiguous buffers."""
        self._fill()
        np.copyto(inputs, self._buf[:, :-1])
        np.copyto(targets, self._buf[:, 1:])

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self) -> None:
        if self._handle:
            self._lib.tl_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeTokenLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["NativeTokenLoader", "available", "library_path"]
