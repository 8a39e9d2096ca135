"""The process group, and the collectives a mesh axis runs over it.

The counterpart of the reference fit()'s distributed bootstrap
(``jax_tpu.initialize()``, ``tony_tpu/train/loop.py:472``): there a job's
processes join one JAX runtime; here they join one ``torch.distributed``
default group. :func:`initialize` reads the ``pytorch`` runtime's env
contract as ``tony_tpu/runtime/frameworks.py:52-63`` writes it
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) and picks NCCL for CUDA, gloo for the CPU. A default group
that already exists is used as it is: that is how a caller runs gloo on a
CUDA device (two ranks on one card, which NCCL refuses) without a knob.

This module is also the one place where a mesh axis's communication
happens: the ring hop (:func:`start_hop`, the reference's
``lax.ppermute`` to the next index) and the all-gather, reduce-scatter and
all-reduce over an axis, each blocking or issued (``start_*``, waited on
later), and each also under autograd (``*_ad``, the backward its
forward's transpose). On a gloo group a CUDA tensor goes through host
memory, explicitly: copied to the host, sent or reduced there, copied
back. That copy is never taken on an NCCL group, and its first use is
logged, so a time measured over gloo is not read as NCCL's.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# the pytorch runtime's env contract (tony_tpu/runtime/frameworks.py:52-63)
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

_staged_logged = False

# the payload bytes this rank hands to each kind of transfer (a tensor's
# size once per call, whatever the transport's algorithm moves on the wire)
BYTES: dict[str, int] = {"hop": 0, "all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}


def reset_bytes() -> None:
    for name in BYTES:
        BYTES[name] = 0


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, the global ranks along it in index order, and their process
    group (None at size 1, where nothing is communicated)."""

    name: str
    size: int = 1
    index: int = 0
    ranks: tuple[int, ...] = (0,)
    group: Any = None


def initialize(device: torch.device) -> bool:
    """Join the default process group; True when one is up.

    An existing default group is kept as it is. Otherwise, with
    ``WORLD_SIZE`` above 1 in the environment, the group comes up from the
    env contract (``init_method="env://"``), NCCL for a CUDA ``device``
    (``LOCAL_RANK`` its card) and gloo otherwise. Without ``WORLD_SIZE``
    (or at 1) this is a one-process run and nothing is brought up, as the
    reference's bootstrap is a no-op outside a job."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE={world} but the env contract lacks {missing}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=world)
    return True


def world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _staged(t: torch.Tensor, axis: Axis) -> bool:
    """Whether ``t`` crosses ``axis`` through host memory: a CUDA tensor on
    a gloo group."""
    global _staged_logged
    staged = t.is_cuda and dist.get_backend(axis.group) == "gloo"
    if staged and not _staged_logged:
        _staged_logged = True
        log.info("gloo group over CUDA tensors: hops and collectives are staged "
                 "through host memory (never on NCCL)")
    return staged


def transport(axis: Axis, device: torch.device) -> str:
    """How ``axis`` moves tensors of ``device``: ``"nccl"``, ``"gloo"``, or
    ``"gloo, host-staged"`` for CUDA tensors on a gloo group; ``"none"`` at
    size 1."""
    if axis.group is None:
        return "none"
    backend = str(dist.get_backend(axis.group))
    return f"{backend}, host-staged" if backend == "gloo" and device.type == "cuda" else backend


class Pending:
    """An issued transfer (a ring hop or a collective): ``wait()`` waits
    for it and returns its result on the caller's device."""

    def __init__(self, works: list, finish: Callable[[], torch.Tensor]):
        self._works, self._finish = works, finish

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._finish()


def _source(t: torch.Tensor, axis: Axis, kind: str, clone: bool = False) -> torch.Tensor:
    """``t`` as a transfer of ``kind`` reads it: detached and contiguous (a
    copy when ``clone``, for the collectives that write in place), on the
    host where the axis stages it; its bytes counted in :data:`BYTES`."""
    BYTES[kind] += t.numel() * t.element_size()
    src = t.detach()
    src = src.clone(memory_format=torch.contiguous_format) if clone else src.contiguous()
    return src.cpu() if _staged(src, axis) else src


def start_hop(t: torch.Tensor, axis: Axis) -> Pending:
    """Send ``t`` to the next index of ``axis`` and receive the previous
    index's tensor of the same shape and dtype (the reference's
    ``ppermute`` over ``[(i, (i + 1) % n)]``). Both transfers are in
    flight when this returns; the caller runs its chunk and then waits."""
    n = axis.size
    send = _source(t, axis, "hop")
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, axis.ranks[(axis.index + 1) % n], axis.group),
           dist.P2POp(dist.irecv, recv, axis.ranks[(axis.index - 1) % n], axis.group)]
    return Pending(dist.batch_isend_irecv(ops), lambda: recv.to(t.device))


def start_all_gather(t: torch.Tensor, axis: Axis, dim: int) -> Pending:
    """Issue the all-gather of :func:`all_gather`; in flight on return."""
    if axis.size == 1:
        return Pending([], lambda: t)
    src = _source(t, axis, "all_gather")
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    work = dist.all_gather(parts, src, group=axis.group, async_op=True)
    return Pending([work], lambda: torch.cat(parts, dim).to(t.device))


def start_reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> Pending:
    """Issue the reduce-scatter of :func:`reduce_scatter`; in flight on
    return. On gloo it is an all-reduce whose block is kept (gloo has no
    reduce-scatter on every torch line)."""
    if axis.size == 1:
        return Pending([], lambda: t)
    if dist.get_backend(axis.group) == "gloo":
        buf = _source(t, axis, "reduce_scatter", clone=True)
        work = dist.all_reduce(buf, group=axis.group, async_op=True)
        return Pending([work], lambda: buf.chunk(axis.size, dim)[axis.index]
                       .contiguous().to(t.device))
    BYTES["reduce_scatter"] += t.numel() * t.element_size()
    parts = [p.contiguous() for p in t.detach().chunk(axis.size, dim)]
    out = torch.empty_like(parts[axis.index])
    work = dist.reduce_scatter(out, parts, group=axis.group, async_op=True)
    return Pending([work], lambda: out)


def start_all_reduce(t: torch.Tensor, axis: Axis) -> Pending:
    """Issue the all-reduce of :func:`all_reduce`; in flight on return."""
    if axis.size == 1:
        return Pending([], lambda: t)
    buf = _source(t, axis, "all_reduce", clone=True)
    work = dist.all_reduce(buf, group=axis.group, async_op=True)
    return Pending([work], lambda: buf.to(t.device))


def all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis's tensors concatenated along ``dim`` in index order."""
    return start_all_gather(t, axis, dim).wait()


def reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This index's block along ``dim`` of the axis's elementwise sum."""
    return start_reduce_scatter(t, axis, dim).wait()


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis's elementwise sum of ``t``, as a new tensor."""
    return start_all_reduce(t, axis).wait()


# --- the collectives under autograd ---------------------------------------------
# Each backward is its forward's transpose, as the reference's AD transposes
# a shard_map's collectives: an all-gather's is a reduce-scatter, a
# reduce-scatter's an all-gather, an all-reduce's (a psum's) an all-reduce.
# Remat re-runs a forward's collective in the backward's recompute, so every
# rank must reach them in one order.


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        for axis in axes:
            t = all_reduce(t, axis)
        return t

    @staticmethod
    def backward(ctx, g):
        for axis in ctx.axes:
            g = all_reduce(g, axis)
        return g, None


def all_gather_ad(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """:func:`all_gather` whose gradient is reduce-scattered back."""
    return t if axis.size == 1 else _AllGather.apply(t, axis, dim)


def reduce_scatter_ad(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """:func:`reduce_scatter` whose gradient is all-gathered back."""
    return t if axis.size == 1 else _ReduceScatter.apply(t, axis, dim)


def all_reduce_ad(t: torch.Tensor, axes: list[Axis]) -> torch.Tensor:
    """The sum of ``t`` over every axis of ``axes`` (one all-reduce each);
    its gradient is summed the same way."""
    axes = [a for a in axes if a.size > 1]
    return _AllReduce.apply(t, axes) if axes else t


__all__ = ["BYTES", "ENV_KEYS", "Axis", "Pending", "all_gather", "all_gather_ad", "all_reduce",
           "all_reduce_ad", "initialize", "reduce_scatter", "reduce_scatter_ad", "reset_bytes",
           "start_all_gather", "start_all_reduce", "start_hop", "start_reduce_scatter",
           "transport", "world"]
