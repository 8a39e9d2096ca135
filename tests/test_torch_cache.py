"""The port's paged KV cache (tony_tpu_torch.serve.cache), prefix store copy
and serving counters against the JAX package's: refcount semantics case by
case, and the pool writes land exactly where the reference's do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.obs.metrics import DecodeMetrics as JDecodeMetrics
from tony_tpu.serve import cache as jcache
from tony_tpu.serve.prefix import PrefixStore as JPrefixStore
from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.obs.metrics import DecodeMetrics
from tony_tpu_torch.serve.cache import (
    SCRATCH_BLOCK, BlockPool, block_bytes, blocks_for, create_cache,
    grow_cache, scatter_block_kv, shrink_cache,
)
from tony_tpu_torch.serve.prefix import PrefixStore


@pytest.mark.parametrize("length,want", [
    (1, 1), (7, 1), (8, 1), (9, 2), (16, 2), (17, 3), (0, 1),
])
def test_blocks_for_matches_reference(length, want):
    assert blocks_for(length, 8) == want == jcache.blocks_for(length, 8)


def test_block_pool_refcount_lifecycle():
    pool = BlockPool(4)
    assert pool.n_free == 3            # scratch (id 0) never allocated
    a = pool.alloc()
    assert a != SCRATCH_BLOCK and pool.refcount(a) == 1
    pool.retain(a)
    assert pool.refcount(a) == 2
    assert pool.release(a) is False    # still referenced
    assert pool.release(a) is True     # refcount hit zero: back on free list
    assert pool.n_free == 3
    with pytest.raises(ValueError):
        pool.release(a)                # double free
    with pytest.raises(ValueError):
        pool.retain(a)                 # retain of a free block
    with pytest.raises(ValueError):
        pool.release(SCRATCH_BLOCK)
    with pytest.raises(ValueError):
        BlockPool(1)


def test_pool_grow_and_shrink_bounded_by_pinned_block():
    pool = BlockPool(8)
    pids = [pool.alloc() for _ in range(4)]          # LIFO: 7, 6, 5, 4
    assert pids == [1, 2, 3, 4]
    high = pids[-1]
    for pid in pids[:-1]:
        pool.release(pid)
    assert pool.shrink_target() == high + 1
    with pytest.raises(ValueError, match="live block"):
        pool.shrink(high)
    pool.shrink(high + 1)
    assert pool.n_blocks == high + 1
    pool.grow(8)
    assert pool.n_blocks == 8 and pool.n_free == 6
    pool.release(high)
    assert pool.shrink_target() == 2


def test_block_pool_matches_reference_on_a_random_trace():
    """Alloc/retain/release/grow/shrink in the same random order on both
    allocators give the same ids and the same refcounts at every step."""
    rng = np.random.default_rng(0)
    ours, ref = BlockPool(4), jcache.BlockPool(4)
    live: list[int] = []
    for _ in range(400):
        op = rng.integers(0, 5)
        if op == 0:
            a, b = ours.alloc(), ref.alloc()
            assert a == b
            if a is not None:
                live.append(a)
        elif op == 1 and live:
            pid = live[rng.integers(len(live))]
            ours.retain(pid), ref.retain(pid)
            live.append(pid)
        elif op == 2 and live:
            pid = live.pop(rng.integers(len(live)))
            assert ours.release(pid) == ref.release(pid)
        elif op == 3:
            n = int(rng.integers(2, 24))
            ours.grow(n), ref.grow(n)
        else:
            t = ours.shrink_target()
            assert t == ref.shrink_target()
            ours.shrink(t), ref.shrink(t)
        assert ours.n_blocks == ref.n_blocks and ours.n_free == ref.n_free
        assert [ours.refcount(i) for i in range(ours.n_blocks)] == \
            [ref.refcount(i) for i in range(ref.n_blocks)]


def test_cache_create_grow_shrink_keep_blocks():
    cfg = LlamaConfig.tiny()
    cache = create_cache(cfg, slots=2, n_blocks=3, block=8, device="cpu")
    assert cache.k.shape == (2, 3, 2, 8, 16) and cache.lengths.dtype == torch.int32
    cache.k[:, 2] = 7.0
    big = grow_cache(cache, 6)
    assert big.n_blocks == 6 and bool((big.k[:, 2] == 7.0).all())
    assert bool((big.k[:, 3:] == 0).all())
    small = shrink_cache(big, 3)
    assert small.n_blocks == 3 and bool((small.k[:, 2] == 7.0).all())
    assert small.k.is_contiguous()
    assert shrink_cache(small, 5) is small and grow_cache(small, 2) is small


def test_block_bytes_matches_reference():
    assert block_bytes(LlamaConfig.tiny(), 8) == \
        jcache.block_bytes(jl.LlamaConfig.tiny(), 8)
    big = block_bytes(LlamaConfig.llama3_8b(), 64)
    assert big == jcache.block_bytes(jl.LlamaConfig.llama3_8b(), 64) == 8 * 2**20


def _pool_and_writes(G: int | None):
    rng = np.random.default_rng(1 if G is None else G)
    P, Hkv, blk, hd, S = 6, 2, 8, 4, 3
    pool = rng.standard_normal((P, Hkv, blk, hd)).astype(np.float32)
    if G is None:
        pids = np.array([3, SCRATCH_BLOCK, 5], np.int32)   # slot 1 is dead
        offs = np.array([2, 0, 7], np.int32)
        new = rng.standard_normal((S, Hkv, hd)).astype(np.float32)
    else:
        pids = np.array([[3, 3, 4], [SCRATCH_BLOCK] * 3, [5, 1, 1]], np.int32)[:, :G]
        offs = np.array([[6, 7, 0], [0, 1, 2], [7, 0, 1]], np.int32)[:, :G]
        new = rng.standard_normal((S, G, Hkv, hd)).astype(np.float32)
    return pool, new, pids, offs


@pytest.mark.parametrize("G", [None, 2, 3])
def test_scatter_block_kv_matches_reference(G):
    """One layer's paged write, the one-token form (a dead slot steered to
    scratch) and the multi-position form: the same pool as the reference's
    ``.at[pids, :, offs, :].set``, scratch block included (each scratch
    position is written once here, so there is no race to win)."""
    pool, new, pids, offs = _pool_and_writes(G)
    want = np.asarray(jcache.scatter_block_kv(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pids), jnp.asarray(offs)))
    t = torch.from_numpy(pool.copy())
    out = scatter_block_kv(t, torch.from_numpy(new), torch.from_numpy(pids),
                           torch.from_numpy(offs))
    assert out is t                                    # in place
    np.testing.assert_array_equal(t.numpy(), want)


def test_scatter_duplicates_only_touch_scratch():
    """Two dead slots both steered at scratch position 0: every real block
    matches the reference, whichever write wins on scratch."""
    pool, new, _, _ = _pool_and_writes(None)
    pids = np.array([SCRATCH_BLOCK, 2, SCRATCH_BLOCK], np.int32)
    offs = np.array([0, 4, 0], np.int32)
    want = np.asarray(jcache.scatter_block_kv(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pids), jnp.asarray(offs)))
    t = torch.from_numpy(pool.copy())
    scatter_block_kv(t, torch.from_numpy(new), torch.from_numpy(pids),
                     torch.from_numpy(offs))
    np.testing.assert_array_equal(t.numpy()[1:], want[1:])


def test_prefix_store_copy_behaves_like_reference():
    """Random insert/match/evict traffic on the copy and the reference
    store gives the same matches, releases and stats."""
    rng = np.random.default_rng(2)
    ours = PrefixStore(block=4, block_bytes=100, budget_bytes=1200)
    ref = JPrefixStore(block=4, block_bytes=100, budget_bytes=1200)
    seqs = [rng.integers(0, 3, 16).tolist() for _ in range(6)]
    released: tuple[list, list] = ([], [])
    for step in range(60):
        seq = seqs[rng.integers(len(seqs))]
        n = int(rng.integers(1, 17))
        assert ours.match(seq, n) == ref.match(seq, n)
        if step % 3 == 0:
            phys = [int(x) for x in rng.integers(1, 99, 4)]
            cut = seq[:4 * int(rng.integers(1, 5))]
            assert ours.insert(cut, phys, lambda p: None) == \
                ref.insert(cut, phys, lambda p: None)
            ours.evict_to_budget(released[0].append)
            ref.evict_to_budget(released[1].append)
        assert ours.longest_extension(seq[:n], 5) == ref.longest_extension(seq[:n], 5)
    assert released[0] == released[1]
    assert ours.stats() == ref.stats()


def test_decode_metrics_copy_summarises_like_reference():
    ours, ref = DecodeMetrics(), JDecodeMetrics()
    for m in (ours, ref):
        m.kv_bytes_per_token = 128.0
        m.record_prompt(20, 8)
        m.record_prefill(0.5, 0.7)
        m.record_decode(0.1, 3, 3, 4)
        m.record_decode(0.2, 2, 2, 4)
        m.requests_finished += 1
    assert ours.summary() == ref.summary()
    assert ours.decode_tokens_per_sec == pytest.approx(5 / 0.3)
