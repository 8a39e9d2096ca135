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
all-reduce over an axis. On a gloo group a CUDA tensor goes through host
memory, explicitly: copied to the host, sent or reduced there, copied
back. That copy is never taken on an NCCL group, and its first use is
logged, so a time measured over gloo is not read as NCCL's.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# the pytorch runtime's env contract (tony_tpu/runtime/frameworks.py:52-63)
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")

_staged_logged = False


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


class Hop:
    """An issued ring hop: ``wait()`` returns what the previous index sent."""

    def __init__(self, works: list, recv: torch.Tensor, device: torch.device):
        self._works, self._recv, self._device = works, recv, device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        return self._recv.to(self._device)


def start_hop(t: torch.Tensor, axis: Axis) -> Hop:
    """Send ``t`` to the next index of ``axis`` and receive the previous
    index's tensor of the same shape and dtype (the reference's
    ``ppermute`` over ``[(i, (i + 1) % n)]``). Both transfers are in
    flight when this returns; the caller runs its chunk and then waits."""
    n = axis.size
    send = t.detach().contiguous()
    if _staged(send, axis):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, axis.ranks[(axis.index + 1) % n], axis.group),
           dist.P2POp(dist.irecv, recv, axis.ranks[(axis.index - 1) % n], axis.group)]
    return Hop(dist.batch_isend_irecv(ops), recv, t.device)


def all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The axis's tensors concatenated along ``dim`` in index order."""
    if axis.size == 1:
        return t
    src = t.detach().contiguous()
    staged = _staged(src, axis)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This index's block along ``dim`` of the axis's elementwise sum. On
    gloo it is the all-reduce's block (gloo has no reduce-scatter on every
    torch line)."""
    if axis.size == 1:
        return t
    if dist.get_backend(axis.group) == "gloo":
        return all_reduce(t, axis).chunk(axis.size, dim)[axis.index].contiguous()
    parts = [p.contiguous() for p in t.detach().chunk(axis.size, dim)]
    out = torch.empty_like(parts[axis.index])
    dist.reduce_scatter(out, parts, group=axis.group)
    return out


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis's elementwise sum of ``t``, as a new tensor."""
    if axis.size == 1:
        return t
    buf = t.detach().clone(memory_format=torch.contiguous_format)
    staged = _staged(buf, axis)
    if staged:
        buf = buf.cpu()
    dist.all_reduce(buf, group=axis.group)
    return buf.to(t.device)


__all__ = ["ENV_KEYS", "Axis", "Hop", "all_gather", "all_reduce", "initialize",
           "reduce_scatter", "start_hop", "transport", "world"]
