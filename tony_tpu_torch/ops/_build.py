"""Build the package's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

(seconds per file, against minutes for an extension that includes
PyTorch's headers). The library's name carries a hash of the source, of
every header under ``csrc/`` (``sm90.cuh``, the Hopper helpers the
tensor-core kernels share) and of the flags, so an edited source or
header rebuilds and an unchanged one loads from ``csrc/build/`` (listed in
``.gitignore``).

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# the tensor-core entry points' own return codes (csrc/sm90.cuh kNoEncoder,
# kBadMap); other nonzero returns are cudaError_t
TMA_ERRORS = {-2: "libcuda has no cuTensorMapEncodeTiled",
              -3: "cuTensorMapEncodeTiled refused a tensor map "
                  "(base or stride not 16-byte aligned)"}
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    """One loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: Path
    seconds: float          # nvcc wall time (0.0 when loaded from the cache)
    log: str                # nvcc's output (-Xptxas -v: registers, smem, spills)


_loaded: dict[str, Built] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "package's CUDA kernels are built from csrc/ at first use"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built: its name hashes the
    source, every header under ``csrc/`` and the flags."""
    digest = hashlib.sha256(CSRC.joinpath(f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it.
    Raises RuntimeError with nvcc's output when the build fails."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        seconds, log = time.perf_counter() - t0, proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    _loaded[name] = Built(ctypes.CDLL(str(out)), out, seconds, log)
    return _loaded[name]


__all__ = ["BUILD_DIR", "Built", "TMA_ERRORS", "library_path", "load", "nvcc_path"]
