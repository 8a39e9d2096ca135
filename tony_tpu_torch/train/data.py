"""Input pipelines: the synthetic and memory-mapped token streams of
``tony_tpu/train/data.py``, on numpy and one process.

Both yield pre-shifted ``(inputs, targets)`` pairs ``[B, S]`` int32. The
synthetic stream draws the reference's exact tokens: batch n comes from
``np.random.default_rng((seed, n))`` through the same Zipf inverse-CDF
table, so a seed gives the same tokens in both packages. ``start_step``
resumes either stream where step N would have read.

:func:`make_batches` places each batch on the device: on CUDA through
pinned host memory, on a background thread when ``prefetch > 0``
(``train/prefetch.py``). Over a mesh of more than one rank every rank
draws the same global batch and keeps its rows, by the rules' spec of
``("batch", "seq")`` (``parallel/sharding.py``), as the reference places
the batch with that spec's ``NamedSharding``. The C++ prefetching loader the reference routes
token files through (``native=True``) is not ported yet: a token file with
``native=True`` raises, and the synthetic default never touches it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules, local_shape, shard, spec_for

Batch = tuple[torch.Tensor, torch.Tensor]  # (inputs [B, S], targets [B, S])


@dataclass(frozen=True)
class DataConfig:
    global_batch: int = 8
    seq_len: int = 2048
    vocab_size: int = 32000
    seed: int = 0
    path: str = ""  # empty -> synthetic
    # token files through the C++ loader (not ported: raises with a path);
    # False pins the numpy mmap path (sequential windows)
    native: bool = True
    # device-prefetch depth: batches N+1..N+prefetch are made and copied to
    # the device on a background thread while the device runs step N.
    # 0 is the synchronous path; the stream order is the same either way
    prefetch: int = 2


def _pair(tokens: np.ndarray) -> Batch:
    """Shift ``[B, S+1]`` tokens into freshly owned (inputs, targets)."""
    return (torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
            torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])))


def synthetic_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[Batch]:
    """Endless deterministic token stream with Zipf marginals (so the loss
    moves like text), on the CPU. ``start_step`` keys the generator per
    batch, so a resumed job continues the stream instead of replaying it."""
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    # inverse-CDF sampling over a table built once; the tail is pinned to
    # 1.0 so rounding can never index past vocab_size - 1
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    step = start_step
    while True:
        rng = np.random.default_rng((cfg.seed, step))
        draws = rng.random((cfg.global_batch, cfg.seq_len + 1))
        tokens = np.searchsorted(cum, draws, side="right").astype(np.int32)
        step += 1
        yield _pair(tokens)


def mmap_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[Batch]:
    """Sequential windows over a flat binary int32 token file (np.memmap),
    wrapping at EOF. ``start_step`` resumes at the window step N would
    have read."""
    data = np.memmap(cfg.path, dtype=np.int32, mode="r")
    window = cfg.seq_len + 1
    stride = cfg.global_batch * window
    n = len(data)
    if n < stride:
        raise ValueError(f"token file too small: {n} tokens < one global batch {stride}")
    steps_per_epoch = n // stride
    step = start_step
    while True:
        pos = (step % steps_per_epoch) * stride
        chunk = data[pos:pos + stride].reshape(cfg.global_batch, window)
        step += 1
        yield _pair(chunk)


def _make_batches_raw(cfg: DataConfig, start_step: int = 0) -> Iterator[Batch]:
    if cfg.path:
        if cfg.native:
            raise NotImplementedError(
                "the native token loader (train/native_loader) is not ported "
                "yet (ROADMAP); set DataConfig(native=False) for the mmap "
                "reader"
            )
        return mmap_batches(cfg, start_step)
    return synthetic_batches(cfg, start_step)


def make_batches(cfg: DataConfig, device: str | torch.device | None = None,
                 start_step: int = 0, *, mesh=None,
                 rules: Rules = DEFAULT_RULES) -> Iterator[Batch]:
    """The configured batch stream on ``device`` (``None`` means CUDA, and
    raises without it). With ``cfg.prefetch > 0`` it is a
    :class:`~tony_tpu_torch.train.prefetch.PrefetchIterator` (same order,
    batch making and host-to-device copies on a background thread), whose
    ``close()`` ``fit()`` calls on exit. Over a ``mesh`` of more than one
    rank each batch is this rank's block of the global one."""
    from tony_tpu_torch.train.prefetch import PrefetchIterator, to_device

    device = resolve_device(device)
    it = _make_batches_raw(cfg, start_step)
    if mesh is not None and mesh.size > 1:
        spec = spec_for(("batch", "seq"), rules)
        local_shape((cfg.global_batch, cfg.seq_len), spec, mesh)   # even blocks or raise
        it = ((shard(i, spec, mesh), shard(t, spec, mesh)) for i, t in it)
    if cfg.prefetch > 0:
        return PrefetchIterator(it, depth=cfg.prefetch, device=device)
    return (to_device(batch, device) for batch in it)


__all__ = [
    "Batch", "DataConfig", "make_batches", "mmap_batches", "synthetic_batches",
]
