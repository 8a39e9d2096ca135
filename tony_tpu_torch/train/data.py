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
the batch with that spec's ``NamedSharding``. pp is not a batch axis:
every pp rank of a (dp, fsdp, ep) block gets the same rows. With
pipeline microbatches (``microbatches=M``) a rank's rows are its block
of each global microbatch in turn, microbatch i being the global batch's
rows ``[i * B/M, (i + 1) * B/M)`` as the reference's ``microbatch``
reshapes them, each cut over the batch axes; not the i-th M-th of a
contiguous block of rows. A dense CE mean is the same either way; MoE's
per-microbatch router statistics are not.

A token file with ``native=True`` (the default) goes through the C++
prefetching loader (``train/native_loader.py``): each epoch visits every
window once in a seeded order, ``start_step`` resumes exactly. The
reference gives each process its own shard of windows; here every rank
reads the same global batch of windows and keeps its rows as above, so
the rows a rank trains on follow the mesh's row layout (which ranks share
rows under tp, sp and pp, and the microbatch order), never the global
rank. Where the loader cannot be built, one process falls back to the
mmap windows with a warning, and a run of more than one process raises,
as the reference does. :func:`loader_kind` says which stream a config
reads.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules, local_shape, shard, spec_for

log = logging.getLogger(__name__)

Batch = tuple[torch.Tensor, torch.Tensor]  # (inputs [B, S], targets [B, S])


@dataclass(frozen=True)
class DataConfig:
    global_batch: int = 8
    seq_len: int = 2048
    vocab_size: int = 32000
    seed: int = 0
    path: str = ""  # empty -> synthetic
    # token files through the C++ loader (shuffled prefetched windows);
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


def native_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[Batch]:
    """Shuffled prefetched windows of the global batch through the C++
    loader: the mmap contract (``[B, S+1]`` windows, ``start_step``
    resume-exact through ``seek``), but each epoch visits every window once
    in a seeded order, read on a native thread."""
    from tony_tpu_torch.train.native_loader import NativeTokenLoader

    loader = NativeTokenLoader(cfg.path, cfg.seq_len, cfg.global_batch, seed=cfg.seed)
    try:
        loader.seek(start_step)
        while True:
            # a fresh owned contiguous pair per batch, filled by the loader
            out = (np.empty((cfg.global_batch, cfg.seq_len), np.int32),
                   np.empty((cfg.global_batch, cfg.seq_len), np.int32))
            loader.next_into(*out)
            yield torch.from_numpy(out[0]), torch.from_numpy(out[1])
    finally:
        # generator close (PrefetchIterator.close, GC) frees the native
        # handle and its mmap deterministically
        loader.close()


def loader_kind(cfg: DataConfig) -> str:
    """Which stream ``cfg`` reads: 'synthetic' without a path, 'native'
    for a token file with ``native=True`` where the C++ loader builds,
    else 'mmap'."""
    if not cfg.path:
        return "synthetic"
    if cfg.native:
        from tony_tpu_torch.train import native_loader

        if native_loader.available():
            return "native"
    return "mmap"


def _make_batches_raw(cfg: DataConfig, start_step: int = 0,
                      multi_process: bool = False) -> Iterator[Batch]:
    kind = loader_kind(cfg)
    if kind == "native":
        return native_batches(cfg, start_step)
    if kind == "mmap":
        if cfg.native:
            if multi_process:
                # every rank must take the same branch: a rank whose build
                # failed must not mix sequential windows into the others'
                # shuffled ones
                raise RuntimeError(
                    "native token loader unavailable on this host but "
                    "data.native=True in a multi-process job: the ranks "
                    "would mix sampling schemes. Install g++ everywhere or "
                    "set DataConfig(native=False).")
            log.warning("native loader unavailable; falling back to sequential "
                        "mmap windows (different sampling + resume stream)")
        return mmap_batches(cfg, start_step)
    return synthetic_batches(cfg, start_step)


def rank_rows(t: torch.Tensor, mesh, rules: Rules = DEFAULT_RULES,
              microbatches: int = 0) -> torch.Tensor:
    """This rank's block of a global ``[B, S]`` batch tensor over ``mesh``:
    its rows by the rules' spec of ``("batch", "seq")``, with
    ``microbatches`` above 1 its block of each global microbatch in turn
    (see the module's docstring). Raises where the mesh does not split the
    batch evenly."""
    spec = spec_for(("batch", "seq"), rules)
    M = max(1, microbatches)
    B, S = t.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_microbatches={M}")
    shape = (M, B // M, S)
    mb_spec = (None, *spec)
    _, rows, seq = local_shape(shape, mb_spec, mesh)          # even blocks or raise
    return shard(t.reshape(shape), mb_spec, mesh).reshape(M * rows, seq)


def make_batches(cfg: DataConfig, device: str | torch.device | None = None,
                 start_step: int = 0, *, mesh=None, rules: Rules = DEFAULT_RULES,
                 microbatches: int = 0) -> Iterator[Batch]:
    """The configured batch stream on ``device`` (``None`` means CUDA, and
    raises without it). With ``cfg.prefetch > 0`` it is a
    :class:`~tony_tpu_torch.train.prefetch.PrefetchIterator` (same order,
    batch making and host-to-device copies on a background thread), whose
    ``close()`` ``fit()`` calls on exit. Over a ``mesh`` of more than one
    rank each batch is this rank's block of the global one; with
    ``microbatches`` above 1, its block of each of the global batch's
    pipeline microbatches in turn (see the module's docstring)."""
    from tony_tpu_torch.train.prefetch import PrefetchIterator, to_device

    device = resolve_device(device)
    multi = torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1
    it = _make_batches_raw(cfg, start_step, multi_process=multi)
    if mesh is not None and mesh.size > 1:
        rank_rows(torch.empty((cfg.global_batch, cfg.seq_len), dtype=torch.int32), mesh,
                  rules, microbatches)                   # even blocks or raise
        it = ((rank_rows(i, mesh, rules, microbatches),
               rank_rows(t, mesh, rules, microbatches)) for i, t in it)
    if cfg.prefetch > 0:
        return PrefetchIterator(it, depth=cfg.prefetch, device=device)
    return (to_device(batch, device) for batch in it)


__all__ = [
    "Batch", "DataConfig", "loader_kind", "make_batches", "mmap_batches",
    "native_batches", "rank_rows", "synthetic_batches",
]
