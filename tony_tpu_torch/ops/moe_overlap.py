"""The overlapped expert-parallel MoE combine.

The counterpart of ``tony_tpu/ops/moe_overlap.py``. The plain ep grouped
path (``parallel/moe.py``) runs the whole local expert FFN and then one
blocking reduce-scatter of the ``[T_ep, D]`` partial over ``ep``, so every
byte of the combine waits for the last expert matmul. Here the combine is
split on the token dim: this rank's own rows are cut into ``n_chunks``
static slices, and for each chunk the local grouped FFN runs over the
ep-gathered rows of that slice (every ep rank's slice ``c``), then the
chunk's reduce-scatter is issued (``parallel/dist.py``
:func:`~tony_tpu_torch.parallel.dist.start_reduce_scatter`) before the
next chunk's FFN, as ``ops/overlap.py`` issues each ring hop before its
chunk. The chunks are disjoint row slices, so the total traffic equals
the single combine's and each row's sum is the same sum.

:class:`_ChunkedCombine` is the autograd Function: its backward is the
matching per-chunk collective, an all-gather of each chunk's cotangent
slice (the reduce-scatter's transpose), all issued at once; each chunk's
FFN graph then takes its slice, as the reference's
``_overlapped_combine_bwd`` re-linearises each chunk against its psummed
cotangent.

The impl names the chunk FFN's grouped-matmul kernel, as in the
reference: ``'scan'`` the plain version, ``'pallas'`` kernels 11-13
(``ops/grouped_mm.py``). The schedule is the same for both.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tony_tpu_torch.parallel import dist as pdist

def overlap_chunks(t_local: int, chunk_tokens: int) -> int | None:
    """The chunk count for ``t_local`` per-shard token rows, or None where
    the decomposition does not apply (the caller keeps the single
    combine: the overlap is an optimisation, never a requirement).

    ``chunk_tokens > 0`` pins the chunk size; it must divide ``t_local``
    and leave at least 2 chunks, else decline (a ragged tail chunk would
    change the collective's shape per chunk). ``chunk_tokens == 0`` picks
    the largest clean split in {4, 3, 2}."""
    if t_local <= 1:
        return None
    if chunk_tokens > 0:
        if chunk_tokens >= t_local or t_local % chunk_tokens != 0:
            return None
        return t_local // chunk_tokens
    for n in (4, 3, 2):
        if t_local % n == 0:
            return n
    return None


def chunk_tokens_from_report(step_anatomy: dict[str, Any] | None, *,
                             dim: int, dtype_bytes: int = 2,
                             default_tokens: int = 2048) -> int:
    """The chunk size from a measured step-anatomy section: a chunk's
    combine hides when it finishes within one chunk's FFN window, so
    ``tokens x dim x dtype_bytes = achieved_gbps x window`` with ``window
    = compute_ms / 2``. Reads the top collective's measured bandwidth;
    ``default_tokens`` without one. Clamped to [256, 8192] and rounded
    down to a multiple of 256."""
    if not step_anatomy or dim <= 0:
        return default_tokens
    top = step_anatomy.get("top_collective") or {}
    gbps = float(top.get("achieved_gbps") or 0.0)
    compute_ms = float(step_anatomy.get("compute_ms") or 0.0)
    if gbps <= 0.0 or compute_ms <= 0.0:
        return default_tokens
    window_s = 0.5 * (compute_ms / 1e3)
    raw = int(gbps * 1e9 * window_s / (dim * dtype_bytes))
    clamped = max(256, min(raw, 8192))
    return (clamped // 256) * 256


class _ChunkedCombine(torch.autograd.Function):
    """Waits for the issued per-chunk reduce-scatters and joins this rank's
    rows; the backward all-gathers each chunk's cotangent slice over the
    axis, the gradient of that chunk's ``[ep * ct, D]`` partial."""

    @staticmethod
    def forward(ctx, pending, axis, *partials):
        ctx.axis, ctx.n = axis, len(partials)
        return torch.cat([p.wait() for p in pending], dim=0)

    @staticmethod
    def backward(ctx, g):
        issued = [pdist.start_all_gather(g_c, ctx.axis, 0) for g_c in g.chunk(ctx.n, dim=0)]
        return (None, None, *[p.wait() for p in issued])


def _chunk_view(t: torch.Tensor, n_ep: int, n_chunks: int, c: int) -> torch.Tensor:
    """Chunk ``c`` of every ep rank's rows of the rank-major gathered ``t``
    ``[n_ep * t_own, ...]``: ``[n_ep * t_own / n_chunks, ...]``, rank-major
    again, so its reduce-scatter hands each rank its own chunk."""
    per = t.shape[0] // n_ep
    parts = t.reshape(n_ep, n_chunks, per // n_chunks, *t.shape[1:])[:, c]
    return parts.reshape(-1, *t.shape[1:])


def overlapped_combine(ffn_fn: Callable[..., torch.Tensor], axis: pdist.Axis,
                       n_chunks: int, w1: torch.Tensor, w3: torch.Tensor,
                       w2: torch.Tensor, flat: torch.Tensor, sel: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """Chunked ep combine of this rank's rows: ``concat_c(reduce_scatter(
    ffn_fn(chunk_c)))``. ``flat [ep * t, D]``, ``sel``/``weight [ep * t,
    k]`` are the ep-gathered rows and routes in rank-major order (rank
    ``r``'s ``t`` rows at ``r * t``); ``ffn_fn(w1, w3, w2, flat_c, sel_c,
    weight_c) -> [ep * ct, D]`` is the rank-local chunk FFN, ownership
    masking included (``parallel/moe.py`` ``_chunk_ffn``). Returns this
    rank's ``[t, D]``: numerically the single combine, row by row."""
    n_ep = axis.size
    pending, partials = [], []
    for c in range(n_chunks):
        y_c = ffn_fn(w1, w3, w2, _chunk_view(flat, n_ep, n_chunks, c),
                     _chunk_view(sel, n_ep, n_chunks, c),
                     _chunk_view(weight, n_ep, n_chunks, c))
        # in flight while the next chunk's FFN runs
        pending.append(pdist.start_reduce_scatter(y_c, axis, 0))
        partials.append(y_c)
    return _ChunkedCombine.apply(pending, axis, *partials)


__all__ = ["chunk_tokens_from_report", "overlap_chunks", "overlapped_combine"]
