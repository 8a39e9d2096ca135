"""Paged block KV cache: a refcounted physical-block pool + per-slot
indirection tables.

The counterpart of ``tony_tpu/serve/cache.py`` (unquantized pools):

- buffers are ``[L, P, Hkv, block, hd]`` head-major: ``P`` physical blocks,
  each holding ``block`` token positions across all layers, so one
  allocation is one refcount covering every layer's K and V for that span;
- a per-slot block table maps logical block ``j`` of slot ``s`` to a
  physical block id, so one physical block can appear in many tables;
- physical block 0 is the scratch block: never allocated; dead slots'
  decode writes are steered into it, so a freed (and maybe reallocated)
  block is never written by a stale slot;
- :class:`BlockPool` keeps the host-side refcounts; a block returns to the
  free list only at refcount zero.

Unlike the reference, whose arrays are immutable and whose jitted steps
return donated copies, this module updates the pools **in place**:
:func:`scatter_block_kv` writes into the tensor it is given, and the
engine copies blocks and writes prompts into ``cache.k``/``cache.v``
directly. Only a change of the pool's size (:func:`grow_cache`,
:func:`shrink_cache`) allocates new tensors. Quantized pools are not
ported yet (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tony_tpu_torch._device import resolve_device

# physical block 0 is reserved: dead slots' writes land here, and table
# entries beyond a slot's allocation point at it
SCRATCH_BLOCK = 0


class PagedKVCache(NamedTuple):
    """k/v: ``[L, P, Hkv, block, hd]`` physical-block pools; lengths:
    ``[S]`` int32, each slot's written positions."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def n_blocks(self) -> int:
        """P: physical blocks currently backed (scratch included)."""
        return self.k.shape[1]


def create_cache(cfg, slots: int, n_blocks: int, block: int, dtype=None,
                 device: str | torch.device | None = None) -> PagedKVCache:
    """Fresh zeroed pool of ``n_blocks`` physical blocks (block 0 = scratch)
    on ``device`` (``None`` means CUDA, and raises without it)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block, cfg.head_dim)
    dt = dtype or cfg.dtype
    return PagedKVCache(
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros((slots,), dtype=torch.int32, device=device),
    )


def grow_cache(cache: PagedKVCache, n_blocks: int) -> PagedKVCache:
    """Extend the pool to ``n_blocks`` physical blocks (new ones zeroed)."""
    extra = n_blocks - cache.n_blocks
    if extra <= 0:
        return cache

    def pad(pool: torch.Tensor) -> torch.Tensor:
        shape = list(pool.shape)
        shape[1] = extra
        return torch.cat([pool, pool.new_zeros(shape)], dim=1)

    return PagedKVCache(pad(cache.k), pad(cache.v), cache.lengths)


def shrink_cache(cache: PagedKVCache, n_blocks: int) -> PagedKVCache:
    """Release physical blocks beyond ``n_blocks``. The caller guarantees
    every id >= ``n_blocks`` is free (``BlockPool.shrink_target``). The kept
    blocks are copied into new tensors, so the old storage is freed."""
    if n_blocks >= cache.n_blocks:
        return cache
    return PagedKVCache(
        cache.k[:, :n_blocks].clone(memory_format=torch.contiguous_format),
        cache.v[:, :n_blocks].clone(memory_format=torch.contiguous_format),
        cache.lengths,
    )


def blocks_for(length: int, block: int) -> int:
    """ceil(length / block), minimum 1."""
    return max(1, math.ceil(length / block))


def scatter_block_kv(pool: torch.Tensor, new: torch.Tensor, pids: torch.Tensor,
                     offs: torch.Tensor) -> torch.Tensor:
    """Paged KV write into ONE layer's ``[P, Hkv, block, hd]`` pool, in
    place; returns ``pool``.

    ``pids``/``offs`` name each entry's physical block and in-block offset.
    With 1-D ``[S]`` indices ``new`` is ``[S, Hkv, hd]``; with 2-D
    ``[S, G]`` indices it is ``[S, G, Hkv, hd]``. The advanced indices
    (``pids`` on axis 0, ``offs`` on axis 2) are not adjacent, so the
    indexed view moves the index dims to the front: exactly ``new``'s
    layout, as with the reference's ``.at[pids, :, offs, :]``. Entries that
    must land nowhere real are the caller's to steer to ``SCRATCH_BLOCK``;
    several such writes to one scratch position leave any one of them,
    which is fine: scratch content is garbage by contract."""
    pool[pids.long(), :, offs.long(), :] = new.to(pool.dtype)
    return pool


def block_bytes(cfg, block: int, dtype=None) -> int:
    """Device bytes one physical block costs (K + V across all layers)."""
    dt = dtype or cfg.dtype
    return 2 * cfg.n_layers * cfg.n_kv_heads * block * cfg.head_dim * dt.itemsize


class BlockPool:
    """Host-side refcounted allocator over physical block ids.

    Pure bookkeeping, no tensors and no locks (the engine's thread is the
    only mutator). A block id is live while its refcount is positive: live
    slots hold one reference per table entry, and the prefix store holds
    one per radix node. ``release`` returns a block to the free list only
    at refcount zero.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("pool needs the scratch block plus one")
        self._ref = [0] * n_blocks
        # LIFO free list (reuse-warm blocks first); scratch never enters
        self._free = list(range(n_blocks - 1, SCRATCH_BLOCK, -1))

    @property
    def n_blocks(self) -> int:
        return len(self._ref)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Blocks with a positive refcount (scratch excluded)."""
        return self.n_blocks - 1 - self.n_free

    def alloc(self) -> int | None:
        """Pop a free block with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def retain(self, pid: int) -> None:
        if pid == SCRATCH_BLOCK:
            raise ValueError("cannot retain the scratch block")
        if self._ref[pid] <= 0:
            raise ValueError(f"retain of free block {pid}")
        self._ref[pid] += 1

    def refcount(self, pid: int) -> int:
        return self._ref[pid]

    def release(self, pid: int) -> bool:
        """Drop one reference; True when the block returned to the free
        list (refcount hit zero)."""
        if pid == SCRATCH_BLOCK:
            raise ValueError("cannot release the scratch block")
        if self._ref[pid] <= 0:
            raise ValueError(f"release of free block {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            return True
        return False

    def grow(self, n_blocks: int) -> None:
        """Extend to ``n_blocks`` ids (mirrors :func:`grow_cache`)."""
        cur = self.n_blocks
        if n_blocks <= cur:
            return
        self._ref.extend([0] * (n_blocks - cur))
        self._free.extend(range(n_blocks - 1, cur - 1, -1))

    def shrink_target(self, floor: int = 2) -> int:
        """Lowest pool size every live block still fits in: one past the
        highest id with a positive refcount."""
        for pid in range(self.n_blocks - 1, SCRATCH_BLOCK, -1):
            if self._ref[pid] > 0:
                return max(pid + 1, floor)
        return floor

    def shrink(self, n_blocks: int) -> None:
        """Drop ids beyond ``n_blocks`` (all must be free)."""
        if n_blocks >= self.n_blocks:
            return
        if any(self._ref[pid] > 0 for pid in range(n_blocks, self.n_blocks)):
            raise ValueError("shrink below a live block")
        del self._ref[n_blocks:]
        self._free = [pid for pid in self._free if pid < n_blocks]


__all__ = [
    "SCRATCH_BLOCK", "BlockPool", "PagedKVCache", "block_bytes", "blocks_for",
    "create_cache", "grow_cache", "scatter_block_kv", "shrink_cache",
]
