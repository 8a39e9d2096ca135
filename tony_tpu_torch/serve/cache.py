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
:func:`shrink_cache`) allocates new tensors.

**Quantized pools** (``quant_kv`` 'int8' or 'fp8_e4m3'): the K/V pools
store int8 or ``float8_e4m3fn``, and parallel scale pools ``[L, P, Hkv]``
float32 carry one scale per physical block per kv head, so a shared block
carries its scales and a copy-on-write copy duplicates one scale row.
Writes quantize (:func:`scatter_block_kv` with ``scale``,
:func:`quant_scatter_span`): the written positions' amax folds into the
running block scale, and when the scale grows the block's stored entries
requantize by old/new (exactly a no-op when it does not: round(q * 1.0) is
q). A scale of zero marks a block with nothing real stored: requantizing
by 0/new zeroes whatever a reused block held, so the engine zeroes only
the scale row at allocation. Each write gathers the touched blocks and
their old scales before it scatters anything back, as the reference's
functional update does. One-byte payloads move through index ops as raw
bytes (a ``uint8`` view), so float8 pools need no float8 indexing kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tony_tpu_torch._device import resolve_device

# physical block 0 is reserved: dead slots' writes land here, and table
# entries beyond a slot's allocation point at it
SCRATCH_BLOCK = 0

# quant_kv knob values; kv_quant_spec maps each to (storage dtype, qmax)
KV_QUANT_DTYPES = ("int8", "fp8_e4m3")


def kv_quant_spec(kv_dtype: str) -> tuple[torch.dtype, float]:
    """Resolve a ``quant_kv`` value to (storage dtype, largest stored
    magnitude)."""
    if kv_dtype == "int8":
        return torch.int8, 127.0
    if kv_dtype == "fp8_e4m3":
        return torch.float8_e4m3fn, 448.0
    raise ValueError(
        f"unknown kv quant dtype {kv_dtype!r} (expected one of {KV_QUANT_DTYPES})"
    )


class PagedKVCache(NamedTuple):
    """k/v: ``[L, P, Hkv, block, hd]`` physical-block pools; lengths:
    ``[S]`` int32, each slot's written positions. Quantized pools also
    carry ``k_scale``/``v_scale`` ``[L, P, Hkv]`` float32 (None otherwise)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def n_blocks(self) -> int:
        """P: physical blocks currently backed (scratch included)."""
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def create_cache(cfg, slots: int, n_blocks: int, block: int, dtype=None,
                 device: str | torch.device | None = None,
                 quant_kv: str = "") -> PagedKVCache:
    """Fresh zeroed pool of ``n_blocks`` physical blocks (block 0 = scratch)
    on ``device`` (``None`` means CUDA, and raises without it). With
    ``quant_kv`` the pools store the quantized dtype, beside zeroed scale
    pools (scale 0: nothing real stored yet)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block, cfg.head_dim)
    dt = kv_quant_spec(quant_kv)[0] if quant_kv else dtype or cfg.dtype
    cache = PagedKVCache(
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros(shape, dtype=dt, device=device),
        torch.zeros((slots,), dtype=torch.int32, device=device),
    )
    if quant_kv:
        sc = shape[:3]
        cache = cache._replace(
            k_scale=torch.zeros(sc, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sc, dtype=torch.float32, device=device),
        )
    return cache


def _map_pools(cache: PagedKVCache, fn) -> PagedKVCache:
    """``fn`` over the payload pools, and the scale pools when quantized."""
    if cache.quantized:
        return PagedKVCache(fn(cache.k), fn(cache.v), cache.lengths,
                            fn(cache.k_scale), fn(cache.v_scale))
    return PagedKVCache(fn(cache.k), fn(cache.v), cache.lengths)


def grow_cache(cache: PagedKVCache, n_blocks: int) -> PagedKVCache:
    """Extend the pool to ``n_blocks`` physical blocks (new ones zeroed,
    scale rows included)."""
    extra = n_blocks - cache.n_blocks
    if extra <= 0:
        return cache

    def pad(pool: torch.Tensor) -> torch.Tensor:
        shape = list(pool.shape)
        shape[1] = extra
        return torch.cat([_raw(pool), _raw(pool).new_zeros(shape)], dim=1).view(pool.dtype)

    return _map_pools(cache, pad)


def shrink_cache(cache: PagedKVCache, n_blocks: int) -> PagedKVCache:
    """Release physical blocks beyond ``n_blocks``. The caller guarantees
    every id >= ``n_blocks`` is free (``BlockPool.shrink_target``). The kept
    blocks (and their scale rows) are copied into new tensors, so the old
    storage is freed."""
    if n_blocks >= cache.n_blocks:
        return cache
    return _map_pools(cache, lambda t: t[:, :n_blocks].clone(
        memory_format=torch.contiguous_format))


def blocks_for(length: int, block: int) -> int:
    """ceil(length / block), minimum 1."""
    return max(1, math.ceil(length / block))


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A one-byte float payload as its raw bytes (a ``uint8`` view), so
    index ops move float8 values without a float8 kernel; else ``t``."""
    if t.element_size() == 1 and t.is_floating_point():
        return t.view(torch.uint8)
    return t


def gather_blocks(pool: torch.Tensor, pids: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Whole physical blocks ``pids`` of ``pool`` along ``dim`` (a copy)."""
    return _raw(pool).index_select(dim, pids.long()).view(pool.dtype)


def quantize_values(vals: torch.Tensor, scale: torch.Tensor, qmax: float,
                    qdtype: torch.dtype) -> torch.Tensor:
    """``vals / scale`` clipped to the stored range, rounded half to even
    for integer storage (fp8 rounds in the cast). ``scale`` broadcasts
    against ``vals``; a zero scale maps everything to zero."""
    q = vals.float() / torch.clamp(scale, min=1e-30)
    q = torch.clamp(q, -qmax, qmax)
    if not qdtype.is_floating_point:
        q = torch.round(q)
    return q.to(qdtype)


def dequantize_values(q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Stored values back to real ones: ``q * scale`` (broadcast)."""
    return (q.float() * scale).to(out_dtype)


def _rescale_stored(q: torch.Tensor, factor: torch.Tensor, qmax: float) -> torch.Tensor:
    """Requantize stored values by ``factor = old_scale / new_scale``
    (broadcast). factor 1 is exact; factor 0 zeroes a block whose scale
    was 0, so a reused block's old content never survives its first write."""
    f = torch.clamp(q.float() * factor, -qmax, qmax)
    if not q.dtype.is_floating_point:
        f = torch.round(f)
    return f.to(q.dtype)


def _requant_factor(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """old / new where the new scale is positive, else 0."""
    return torch.where(new > 0, old / torch.clamp(new, min=1e-30), 0.0)


def _quant_write_rows(pool: torch.Tensor, scale: torch.Tensor, new: torch.Tensor,
                      pids: torch.Tensor, offs: torch.Tensor, qmax: float) -> None:
    """One quantized position per row, in place: ``new [S, Hkv, hd]`` lands
    at ``(pids[s], offs[s])``. Gather the touched blocks and their scales,
    fold the written amax into the running scale, requantize the stored
    entries by old/new, insert the quantized rows, scatter both back.
    Duplicate pids occur only for rows steered to the scratch block, whose
    content is garbage by contract: any one of them may win."""
    S = new.shape[0]
    pids = pids.long()
    blk = gather_blocks(pool, pids)                     # [S, Hkv, blk, hd]
    sc = scale.index_select(0, pids)                    # [S, Hkv]
    amax = new.abs().amax(dim=-1).float()               # [S, Hkv], exact in any dtype
    sc_new = torch.maximum(sc, amax / qmax)
    blk = _rescale_stored(blk, _requant_factor(sc, sc_new)[..., None, None], qmax)
    row = quantize_values(new, sc_new[..., None], qmax, pool.dtype)
    # advanced indices on dims 0 and 2 are not adjacent: the indexed view
    # is [S, Hkv, hd], row's layout
    _raw(blk)[torch.arange(S, device=blk.device), :, offs.long(), :] = _raw(row)
    _raw(pool)[pids] = _raw(blk)
    scale[pids] = sc_new


def scatter_block_kv(pool: torch.Tensor, new: torch.Tensor, pids: torch.Tensor,
                     offs: torch.Tensor, scale: torch.Tensor | None = None,
                     qmax: float = 127.0):
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
    which is fine: scratch content is garbage by contract.

    With ``scale`` (a quantized pool's ``[P, Hkv]`` scale rows for this
    layer) the write quantizes against the running block scale, updates
    ``scale`` in place too, and returns ``(pool, scale)``. The 2-D form
    applies the G positions as G single-position passes, so two writes
    into one block compound their scale updates."""
    if scale is None:
        pool[pids.long(), :, offs.long(), :] = new.to(pool.dtype)
        return pool
    if pids.dim() == 1:
        _quant_write_rows(pool, scale, new, pids, offs, qmax)
    else:
        for g in range(pids.shape[1]):
            _quant_write_rows(pool, scale, new[:, g], pids[:, g], offs[:, g], qmax)
    return pool, scale


def quant_scatter_span(pool: torch.Tensor, scale: torch.Tensor, new: torch.Tensor,
                       pids: torch.Tensor, offs: torch.Tensor, ub: torch.Tensor,
                       qmax: float):
    """Quantized prefill-span write into ONE layer's pool, in place:
    position ``i`` of ``new [Hkv, W, hd]`` lands at ``(pids[i], offs[i])``.
    ``ub`` holds the touched block ids (each once; the reference pads it
    with scratch), so each block requantizes once, not once per position.
    The scale update is a scatter-max, so many positions landing in one
    block fold their amaxes in one pass. Returns ``(pool, scale)``."""
    pids, ub = pids.long(), ub.long()
    needed = new.abs().amax(dim=-1).float() / qmax          # [Hkv, W]
    sc_new = scale.scatter_reduce(
        0, pids[:, None].expand(-1, scale.shape[1]), needed.T, "amax")  # [P, Hkv]
    factor = _requant_factor(scale.index_select(0, ub), sc_new.index_select(0, ub))
    blk = _rescale_stored(gather_blocks(pool, ub), factor[..., None, None], qmax)
    _raw(pool)[ub] = _raw(blk)
    row = quantize_values(new.permute(1, 0, 2), sc_new.index_select(0, pids)[..., None],
                          qmax, pool.dtype)                  # [W, Hkv, hd]
    _raw(pool)[pids, :, offs.long(), :] = _raw(row)
    scale.copy_(sc_new)
    return pool, scale


def copy_block(cache: PagedKVCache, src: int, dst: int) -> None:
    """Copy-on-write block copy, in place: physical block ``src`` (every
    layer's K and V) into ``dst``, scale rows included on a quantized
    pool, so the copy dequantizes to exactly what the source does."""
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    if cache.quantized:
        cache.k_scale[:, dst] = cache.k_scale[:, src]
        cache.v_scale[:, dst] = cache.v_scale[:, src]


def block_bytes(cfg, block: int, dtype=None, quant_kv: str = "") -> int:
    """Device bytes one physical block costs (K + V across all layers).
    With ``quant_kv`` the payload is priced at the stored dtype plus the
    block's two float32 scale rows (K and V, per layer per kv head)."""
    per = 2 * cfg.n_layers * cfg.n_kv_heads * block * cfg.head_dim
    if quant_kv:
        qdt = kv_quant_spec(quant_kv)[0]
        return per * qdt.itemsize + 2 * cfg.n_layers * cfg.n_kv_heads * 4
    dt = dtype or cfg.dtype
    return per * dt.itemsize


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
    "KV_QUANT_DTYPES", "SCRATCH_BLOCK", "BlockPool", "PagedKVCache", "block_bytes",
    "blocks_for", "copy_block", "create_cache", "dequantize_values", "gather_blocks",
    "grow_cache", "kv_quant_spec", "quant_scatter_span", "quantize_values",
    "scatter_block_kv", "shrink_cache",
]
