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
``lax.ppermute`` to the next index), the pipeline's one-way stage hop
(:func:`start_stage_hop`: a send to one neighbour and a receive from the
other, either side left out where a stage has nothing to pass), the
broadcast from one index (:func:`broadcast`) and the all-gather,
reduce-scatter, all-reduce and all-to-all over an axis, each blocking or
issued (``start_*``, waited on later), and each also under autograd
(``*_ad``, the backward its forward's transpose), and Megatron's tp pair
(:func:`copy_to_tp`, :func:`reduce_from_tp`) with the tp gather of a
whole table (:func:`gather_whole`), whose backwards do not sum what
every tp rank computed alike. On a gloo group a CUDA tensor goes through host
memory, explicitly: copied to the host, sent or reduced there, copied
back. That copy is never taken on an NCCL group, and its first use is
logged, so a time measured over gloo is not read as NCCL's. While a
profiler records, each staged copy is a ``comms.<kind>`` region, so the
step anatomy (``obs/anatomy.py``) counts it as the collective it serves.

Every collective's payload is counted where it is issued: into
:data:`BYTES`, and into the comms ledger (``obs/comms.py``) with its axis
and op name, so the ledger's totals by kind equal :data:`BYTES`.
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from tony_tpu_torch.obs import comms

log = logging.getLogger(__name__)

# the pytorch runtime's env contract (tony_tpu/runtime/frameworks.py:52-63)
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

_staged_logged = False

# the payload bytes this rank hands to each kind of transfer (a tensor's
# size once per call, whatever the transport's algorithm moves on the wire)
BYTES: dict[str, int] = {"hop": 0, "all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
                         "all_to_all": 0, "broadcast": 0}


def reset_bytes() -> None:
    """Zero :data:`BYTES` and the comms ledger with it."""
    for name in BYTES:
        BYTES[name] = 0
    comms.reset()


def _count(kind: str, t: torch.Tensor, axis: "Axis", op: str = "",
           runs_as: str = "") -> None:
    """``t``'s bytes as one transfer of ``kind`` over ``axis``: into
    :data:`BYTES` and the comms ledger."""
    nbytes = t.numel() * t.element_size()
    BYTES[kind] += nbytes
    comms.record(kind, nbytes, axis.name, axis.size, axis.ranks, op, runs_as)


def _region(kind: str):
    """A ``comms.<kind>`` profiler region while a profiler records (the
    host-staged copies' attribution in the step anatomy), else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(f"comms.{comms.KINDS[kind]}")
    return contextlib.nullcontext()


def _back(t: torch.Tensor, device: torch.device, kind: str) -> torch.Tensor:
    """A received tensor on ``device``: the copy back from the host where
    the transfer was staged."""
    if t.device == device:
        return t
    with _region(kind):
        return t.to(device)


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


def _source(t: torch.Tensor, axis: Axis, kind: str, clone: bool = False,
            op: str = "", runs_as: str = "") -> torch.Tensor:
    """``t`` as a transfer of ``kind`` reads it: detached and contiguous (a
    copy when ``clone``, for the collectives that write in place), on the
    host where the axis stages it; its bytes counted (:func:`_count`)."""
    _count(kind, t, axis, op, runs_as)
    src = t.detach()
    if _staged(src, axis):
        with _region(kind):
            return src.contiguous().cpu()     # a copy: in-place collectives may write it
    return src.clone(memory_format=torch.contiguous_format) if clone else src.contiguous()


def start_hop(t: torch.Tensor, axis: Axis, shift: int = 1, tag: int = 0,
              op: str = "") -> Pending:
    """Send ``t`` to the index ``shift`` places on along ``axis`` and
    receive the tensor of the same shape and dtype from the index
    ``shift`` places back (the reference's ``ppermute`` over ``[(i, (i +
    shift) % n)]``; ``shift=-1`` is its transpose). Both transfers are in
    flight when this returns; the caller runs its chunk and then waits.
    Hops in flight together on one axis carry distinct ``tag``s; ``op``
    names the ring in the comms ledger. At size 1 the hop is ``t``
    itself."""
    n = axis.size
    if n == 1:
        return Pending([], lambda: t)
    send = _source(t, axis, "hop", op=op)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, axis.ranks[(axis.index + shift) % n], axis.group,
                      tag),
           dist.P2POp(dist.irecv, recv, axis.ranks[(axis.index - shift) % n], axis.group,
                      tag)]
    return Pending(dist.batch_isend_irecv(ops), lambda: _back(recv, t.device, "hop"))


def start_stage_hop(send: torch.Tensor | None, recv_like: torch.Tensor | None, axis: Axis,
                    shift: int = 1, tag: int = 0) -> Pending:
    """The pipeline's hop between neighbouring stages: ``send`` (when not
    None) to the index ``shift`` places on along ``axis``, and (when
    ``recv_like`` is not None) a tensor of its shape and dtype from the
    index ``shift`` places back. The reference's ``ppermute`` over ``[(i,
    i + shift)]`` without the wrap-around edge, and with either side left
    out where its stage has nothing to pass or take at this tick, so the
    first stage never sends backward and the last never forward. Every
    send meets a receive with the same ``tag`` on its peer. ``wait()``
    gives the received tensor on ``recv_like``'s device, or None."""
    n = axis.size
    for step, side in ((shift, send), (-shift, recv_like)):
        if side is not None and not 0 <= axis.index + step < n:
            raise ValueError(f"stage hop past the end of {axis.name}={n} at index "
                             f"{axis.index}")
    ops, recv = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, _source(send, axis, "hop"),
                              axis.ranks[axis.index + shift], axis.group, tag))
    if recv_like is not None:
        recv = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                           device="cpu" if _staged(recv_like, axis) else recv_like.device)
        ops.append(dist.P2POp(dist.irecv, recv, axis.ranks[axis.index - shift], axis.group,
                              tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, lambda: None if recv is None
                   else _back(recv, recv_like.device, "hop"))


def broadcast(t: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    """Index ``src``'s ``t`` on every index of ``axis``: the reference's
    masked ``psum`` of a value one index holds. The other indices pass a
    tensor of its shape and dtype to receive into; only ``src`` counts
    bytes."""
    if axis.size == 1:
        return t
    if axis.index == src:
        buf = _source(t, axis, "broadcast", clone=True)
    else:
        buf = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if _staged(t, axis) else t.device)
    dist.broadcast(buf, axis.ranks[src], group=axis.group)
    return _back(buf, t.device, "broadcast")


def start_all_gather(t: torch.Tensor, axis: Axis, dim: int) -> Pending:
    """Issue the all-gather of :func:`all_gather`; in flight on return."""
    if axis.size == 1:
        return Pending([], lambda: t)
    src = _source(t, axis, "all_gather")
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    work = dist.all_gather(parts, src, group=axis.group, async_op=True)
    return Pending([work], lambda: _back(torch.cat(parts, dim), t.device, "all_gather"))


def start_reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> Pending:
    """Issue the reduce-scatter of :func:`reduce_scatter`; in flight on
    return. On gloo it is an all-reduce whose block is kept (gloo has no
    reduce-scatter on every torch line)."""
    if axis.size == 1:
        return Pending([], lambda: t)
    if dist.get_backend(axis.group) == "gloo":
        buf = _source(t, axis, "reduce_scatter", clone=True, runs_as="all_reduce")
        work = dist.all_reduce(buf, group=axis.group, async_op=True)
        return Pending([work], lambda: _back(buf.chunk(axis.size, dim)[axis.index]
                                             .contiguous(), t.device, "reduce_scatter"))
    _count("reduce_scatter", t, axis)
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
    return Pending([work], lambda: _back(buf, t.device, "all_reduce"))


def all_to_all(t: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all``: ``t`` cut into the axis's
    blocks along ``split_dim``, block i sent to index i, and the blocks
    received concatenated along ``concat_dim`` in index order. One
    ``all_to_all_single`` over the blocks stacked (gloo has no list form)."""
    if axis.size == 1:
        return t
    if t.shape[split_dim] % axis.size:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not split over "
                         f"{axis.name}={axis.size}")
    src = _source(torch.stack(t.chunk(axis.size, split_dim)), axis, "all_to_all")
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis.group)
    return torch.cat(_back(out, t.device, "all_to_all").unbind(0), concat_dim)


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


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        return all_to_all(t, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g, ctx.axis, concat_dim, split_dim), None, None, None


# Megatron's pair over tp (Shoeybi et al., 2019): every rank of the axis
# computes the same loss from the same rows, each through its own block of
# the wide dims. Their gradients are therefore not summed the way a batch
# axis's are.


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.axis.size, ctx.dim)[ctx.axis.index].contiguous(), None, None


class _Arrival(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sent, received, axis):
        ctx.axis = axis
        return received.view_as(received)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a hop to the next index: back to the previous one
        return start_hop(g, ctx.axis, shift=-1).wait(), None, None


def all_to_all_ad(t: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int
                  ) -> torch.Tensor:
    """:func:`all_to_all` whose gradient goes back by the inverse
    all-to-all (``concat_dim`` split, ``split_dim`` concatenated)."""
    return t if axis.size == 1 else _AllToAll.apply(t, axis, split_dim, concat_dim)


def copy_to_tp(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's f: the identity, whose gradient is all-reduced over
    ``axis``. It goes before a column-parallel projection, whose ranks each
    send back the part of the input's gradient their block gives."""
    return t if axis.size == 1 else _CopyTo.apply(t, axis)


def reduce_from_tp(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's g: the all-reduce over ``axis``, whose gradient passes
    through as it is. It goes after a row-parallel projection: each rank
    holds a partial product, and the sum's gradient is every rank's."""
    return t if axis.size == 1 else _ReduceFrom.apply(t, axis)


def gather_whole(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """:func:`all_gather` for a consumer that every rank of ``axis`` runs
    alike on the whole tensor (tok_emb and lm_head over tp): each rank's
    gradient is already the whole gradient, so the backward takes this
    rank's block without summing (a reduce-scatter would count it
    ``axis.size`` times)."""
    return t if axis.size == 1 else _GatherWhole.apply(t, axis, dim)


def hop_arrived(sent: torch.Tensor, received: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``received``, the tensor a hop of ``sent`` to the next index brought
    in (:func:`start_hop`), tied into autograd: its gradient goes to the
    previous index and becomes ``sent``'s there. The hop is issued and
    waited on by the caller, so a ring can run its chunk between."""
    return _Arrival.apply(sent, received, axis)


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
           "all_reduce_ad", "all_to_all", "all_to_all_ad", "broadcast", "copy_to_tp",
           "gather_whole", "hop_arrived", "initialize", "reduce_from_tp", "reduce_scatter",
           "reduce_scatter_ad", "reset_bytes", "start_all_gather", "start_all_reduce",
           "start_hop", "start_reduce_scatter", "start_stage_hop", "transport", "world"]
