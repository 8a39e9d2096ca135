"""Quantized serving in the port (tony_tpu_torch: ops/quant_mm.py, the
quantized pools of serve/cache.py, the quantized form of
ops/decode_attention.py, the engine's quant_kv / quant_weights) against the
JAX package's, on the same numpy inputs.

Everything here is float32 on the activation side: the reference's bf16
paths do not run on this jax's CPU backend ("Unsupported element type for
DotThunk::Execute: BF16 x BF16 = F32"), so bf16 is held on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py). Each test states its
tolerance and why."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from tony_tpu.ops.quant_mm import (
    quant_matmul as jax_quant_matmul, quantize_weights as jax_quantize_weights,
)
from tony_tpu.serve import (
    Engine as JEngine, Request as JRequest, ServeConfig as JServeConfig,
)
from tony_tpu.serve import cache as jcache
from tony_tpu.serve.engine import _copy_block_fn as jax_copy_block
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.ops.decode_attention import (
    LAUNCHES as ATTN_LAUNCHES, decode_attention, reset_launches as reset_attn,
)
from tony_tpu_torch.ops.quant_mm import (
    LAUNCHES as MM_LAUNCHES, WEIGHT_QMAX, quant_matmul, quant_matmul_plain, split_k,
    quantize_weights, reset_launches as reset_mm,
)
from tony_tpu_torch.serve import Engine, Request, ServeConfig
from tony_tpu_torch.serve import cache as pcache
from tony_tpu_torch.serve import engine as pengine

# float32 on both sides, only the order of the sums differs: the tolerance
# the reference holds its own float32 decode and matmul paths to
TOL = dict(atol=2e-6, rtol=1e-5)


def _t(a) -> torch.Tensor:
    """numpy or jax array -> torch tensor, float8 through its raw bytes."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bytes(t) -> np.ndarray:
    """A torch tensor or jax array as raw bytes, for bit-for-bit payloads."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


# --- weight-only int8 matmul ----------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 24), (3, 32, 48), (64, 40)])
def test_quantize_weights_bit_equal_to_reference(shape):
    """int8 values bit for bit (the same float32 division, round half to
    even and clip); scales within float32 rounding (both are amax / 127 in
    float32, so in practice equal). A zero column takes the 1e-30 floor."""
    w = np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape)
    w = w.astype(np.float32)
    w[..., 5] = 0.0                                   # an all-zero channel
    w[..., 0, 3] = 40.0                               # one large entry
    q, s = quantize_weights(torch.from_numpy(w))
    jq, js = jax_quantize_weights(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == w.shape[:-2] + w.shape[-1:]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    assert int(q.abs().max()) <= WEIGHT_QMAX
    assert not q[..., 5].any()


def _mm_case(seed=1, D=32, N=48, lead=(6,)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (D,)).astype(np.float32)
    w = (rng.standard_normal((D, N)) / np.sqrt(D)).astype(np.float32)
    jq, js = jax_quantize_weights(jnp.asarray(w))
    return x, np.asarray(jq), np.asarray(js)


@pytest.mark.parametrize("impl", ["pallas", "scan"])
@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_quant_matmul_plain_matches_reference(impl, lead):
    """The plain version against the reference's Pallas kernel (interpret
    mode) and its scan form, float32 x: the dequantized weights are the
    same float32 values, only the order of the sums differs."""
    x, wq, s = _mm_case(lead=lead)
    reset_mm()
    got = quant_matmul(_t(x), _t(wq), _t(s))
    assert MM_LAUNCHES == {"quant_mm": 0, "quant_mm_plain": 1}
    want = jax_quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                            impl=impl, block_n=16)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quant_matmul_plain_matches_reference_at_verify_rows():
    """A verify step's rows (8 slots of G 16: 128) through the plain
    version against the reference's Pallas kernel in interpret mode, with
    the tolerance of ``test_quant_matmul_plain_matches_reference``: each
    row is its own product there too."""
    x, wq, s = _mm_case(seed=6, D=40, N=48, lead=(8, 16))
    reset_mm()
    got = quant_matmul(_t(x), _t(wq), _t(s))
    assert MM_LAUNCHES == {"quant_mm": 0, "quant_mm_plain": 1}
    want = jax_quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                            impl="pallas", block_n=16)
    assert got.shape == (8, 16, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# an H100's 132 SMs and the clusters of 1 to 8 CTAs of the tensor-core
# instance it holds at once (``card_shape`` on "NVIDIA H100 80GB HBM3,
# 700.00 W"); the decode step's weight shapes (D, N): wq/wo, wk/wv, w1/w3,
# w2, lm_head, and the split each takes there
H100 = (132, {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15})
DECODE_SPLITS = [((4096, 4096), 6), ((4096, 1024), 8), ((4096, 14336), 2),
                 ((14336, 4096), 6), ((4096, 128256), 1)]


@pytest.mark.parametrize("shape,splits", DECODE_SPLITS)
def test_quant_mm_split_follows_shape_and_card_not_rows(shape, splits):
    """The tensor-core instance's split of D is a function of the weight's
    shape and the card alone (``split_k`` takes no row count), so a row's
    float32 sum runs in the same order alone, in 8 slots or in a verify
    step's 128 rows. At most a cluster of 8, every split holding a 64-deep
    slice, and a split call's CTAs in one wave: no more than the SMs, and
    its column tiles' clusters no more than the card holds at once (16
    tiles of wq/wo would take two waves in clusters of 8, of which the card
    holds 15)."""
    D, N = shape
    sms, clusters = H100
    assert "M" not in inspect.signature(split_k).parameters
    assert split_k(D, N, sms, clusters) == splits
    slices, tiles = -(-D // 64), -(-N // 256)
    assert (splits - 1) * -(-slices // splits) < slices
    assert splits == 1 or (tiles * splits <= sms and tiles <= clusters[splits])
    for cut in (1, 66, 114, 132):
        got = split_k(D, N, cut, clusters)
        assert 1 <= got <= 8 and (got == 1 or tiles * got <= cut)
    assert split_k(200, 1001, *H100) == 4 and split_k(14336, 256, *H100) == 8


def test_poisoned_scale_channel_stays_in_its_column():
    x, wq, s = _mm_case(seed=4, D=16, N=24, lead=(4,))
    s = s.copy()
    s[7] = np.nan
    got = quant_matmul_plain(_t(x), _t(wq), _t(s)).numpy()
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.asarray(s), impl="pallas", block_n=8))
    for y in (got, want):
        assert not np.isfinite(y[:, 7]).any()
        assert np.isfinite(np.delete(y, 7, axis=1)).all()
    np.testing.assert_allclose(np.delete(got, 7, axis=1), np.delete(want, 7, axis=1),
                               **TOL)


def test_quant_matmul_shape_checks():
    x = torch.zeros((2, 8))
    wq, s = quantize_weights(torch.ones((8, 8)))
    with pytest.raises(ValueError):
        quant_matmul(x, wq, s[:4])
    with pytest.raises(ValueError):
        quant_matmul(torch.zeros((2, 4)), wq, s)
    with pytest.raises(ValueError):
        quant_matmul(x, wq[None], s)


# --- pool helpers ---------------------------------------------------------------


def test_kv_quant_spec_matches_reference():
    for name, want in (("int8", torch.int8), ("fp8_e4m3", torch.float8_e4m3fn)):
        dt, qmax = pcache.kv_quant_spec(name)
        jdt, jqmax = jcache.kv_quant_spec(name)
        assert dt == want and str(dt) == f"torch.{jdt.name}" and qmax == jqmax
    for bad in ("int4", "bf16", ""):
        with pytest.raises(ValueError):
            pcache.kv_quant_spec(bad)
        with pytest.raises(ValueError):
            jcache.kv_quant_spec(bad)


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quantize_and_dequantize_values_match_reference(kv):
    """Stored values bit for bit (same division, clip and round half to
    even; fp8 rounds to nearest even in the cast on both sides), including
    a zero scale (the 1e-30 floor sends the values to the range's ends,
    which dequantize to zero) and values past the range (clipped);
    dequantized values exactly (one float32 product each)."""
    rng = np.random.default_rng(7)
    vals = (rng.standard_normal((4, 3, 16)) * 2).astype(np.float32)
    scale = (np.abs(vals).max(-1, keepdims=True) / 100).astype(np.float32)
    dt, qmax = pcache.kv_quant_spec(kv)
    jdt, _ = jcache.kv_quant_spec(kv)
    scale[1, 2] = 0.0
    scale[2, 0] = np.abs(vals[2, 0]).max() / (3 * qmax)   # 3x past the range: clipped
    q = pcache.quantize_values(torch.from_numpy(vals), torch.from_numpy(scale), qmax, dt)
    jq = jcache.quantize_values(jnp.asarray(vals), jnp.asarray(scale), qmax, jdt)
    np.testing.assert_array_equal(_bytes(q), _bytes(jq))
    assert float(q[2, 0].float().abs().max()) == qmax
    back = pcache.dequantize_values(q, torch.from_numpy(scale), torch.float32)
    jback = jcache.dequantize_values(jq, jnp.asarray(scale), jnp.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert not back[1, 2].any()


def test_block_bytes_prices_payload_plus_scale_rows():
    cfg, jcfg = LlamaConfig.tiny(), jl.LlamaConfig.tiny()
    for kv in ("", "int8", "fp8_e4m3"):
        assert pcache.block_bytes(cfg, 8, quant_kv=kv) == \
            jcache.block_bytes(jcfg, 8, quant_kv=kv)
    assert pcache.block_bytes(cfg, 8, quant_kv="int8") < 0.6 * pcache.block_bytes(cfg, 8)


def test_create_grow_shrink_carry_scale_rows():
    cfg = LlamaConfig.tiny()
    c = pcache.create_cache(cfg, 2, 4, 8, device="cpu", quant_kv="fp8_e4m3")
    assert c.quantized and c.k.dtype == torch.float8_e4m3fn
    assert c.k_scale.shape == (cfg.n_layers, 4, cfg.n_kv_heads)
    c.k_scale[:, 3] = 0.5
    c.k[:, 3] = torch.full(c.k.shape[2:], 2.0).to(torch.float8_e4m3fn)
    g = pcache.grow_cache(c, 8)
    assert g.k.shape[1] == g.k_scale.shape[1] == g.v_scale.shape[1] == 8
    assert float(g.k_scale[:, 3].min()) == 0.5 and not g.k_scale[:, 4:].any()
    assert float(g.k[:, 3].float().min()) == 2.0 and not g.k[:, 4:].float().any()
    s = pcache.shrink_cache(g, 4)
    assert s.k_scale.shape[1] == 4 and float(s.k_scale[:, 3].max()) == 0.5
    plain = pcache.create_cache(cfg, 2, 4, 8, device="cpu")
    assert not plain.quantized and plain.k_scale is None


# --- the quantized write paths --------------------------------------------------

P, HKV, BLK, HD = 6, 2, 8, 16


def _pool(kv, seed):
    """A quantized pool [P, Hkv, blk, hd] with real content in blocks 1..4
    (their scales the content's amax / qmax), block 5 fresh (scale 0,
    garbage payload), and scratch 0 with garbage; as numpy payload bytes
    for both frameworks, plus the scale rows."""
    rng = np.random.default_rng(seed)
    _, qmax = pcache.kv_quant_spec(kv)
    jdt, _ = jcache.kv_quant_spec(kv)
    vals = rng.standard_normal((P, HKV, BLK, HD)).astype(np.float32)
    scale = (np.abs(vals).max(axis=(2, 3)) / qmax).astype(np.float32)
    scale[5] = 0.0
    scale[0] = 0.37
    pool = np.asarray(jcache.quantize_values(
        jnp.asarray(vals), jnp.asarray(np.maximum(scale, 1e-3))[..., None, None],
        qmax, jdt))
    return pool, scale, qmax


def _both(pool, scale):
    return (_t(pool), torch.from_numpy(scale.copy())), (jnp.asarray(pool), jnp.asarray(scale))


def _assert_pools_equal(got, want, *, skip_scratch):
    (pool, scale), (jpool, jscale) = got, want
    a, b = _bytes(pool), _bytes(jpool)
    sa, sb = scale.numpy(), np.asarray(jscale)
    if skip_scratch:
        a, b, sa, sb = a[1:], b[1:], sa[1:], sb[1:]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_scatter_block_kv_quantized_rows_match_reference(kv):
    """One position per row into the running block scales: row 0 fits its
    block's scale (no requantization), row 1 is 4x larger (the scale grows
    and the block's stored entries requantize), row 2 lands in a fresh
    block (scale 0: its garbage is zeroed), rows 3 and 4 are dead slots
    steered to scratch (duplicate pids). Payload bytes and scales equal the
    reference's on every real block (exactly: the same float32 ops); the
    scratch block's content is garbage by contract (either duplicate may
    win), so it is left out."""
    pool, scale, qmax = _pool(kv, seed=11)
    rng = np.random.default_rng(12)
    new = (rng.standard_normal((5, HKV, HD)) * 0.5).astype(np.float32)
    new[1] *= 8.0
    pids = np.array([1, 2, 5, 0, 0], np.int32)
    offs = np.array([3, 7, 0, 1, 2], np.int32)
    (tp, ts), (jp, js) = _both(pool, scale)
    out = pcache.scatter_block_kv(tp, torch.from_numpy(new), torch.from_numpy(pids),
                                  torch.from_numpy(offs), scale=ts, qmax=qmax)
    assert out[0] is tp and out[1] is ts               # updated in place
    want = jcache.scatter_block_kv(jp, jnp.asarray(new), jnp.asarray(pids),
                                   jnp.asarray(offs), scale=js, qmax=qmax)
    _assert_pools_equal((tp, ts), want, skip_scratch=True)
    assert float(ts[2].min()) > scale[2].min()          # the scale grew
    # the fresh block holds only the written row
    assert not tp[5, :, 1:].float().any() and tp[5, :, 0].float().abs().sum() > 0


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_scatter_block_kv_quantized_g_positions_match_reference(kv):
    """The 2-D form: G=3 positions per row, two rows' positions sharing a
    block and growing its scale within one call (sequential passes
    compound), one row's padding steered to scratch."""
    pool, scale, qmax = _pool(kv, seed=21)
    rng = np.random.default_rng(22)
    new = (rng.standard_normal((2, 3, HKV, HD))).astype(np.float32)
    new[0, 2] *= 6.0
    pids = np.array([[3, 3, 3], [4, 5, 0]], np.int32)
    offs = np.array([[4, 5, 6], [7, 0, 0]], np.int32)
    (tp, ts), (jp, js) = _both(pool, scale)
    pcache.scatter_block_kv(tp, torch.from_numpy(new), torch.from_numpy(pids),
                            torch.from_numpy(offs), scale=ts, qmax=qmax)
    want = jcache.scatter_block_kv(jp, jnp.asarray(new), jnp.asarray(pids),
                                   jnp.asarray(offs), scale=js, qmax=qmax)
    _assert_pools_equal((tp, ts), want, skip_scratch=True)


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_scatter_span_matches_reference(kv):
    """A prefill span of 13 positions from offset 5 of block 2 through
    block 4 into fresh block 5: one scatter-max per block, each touched
    block requantized once; the touched-id set padded with scratch as the
    reference's engine pads it (its duplicates write identical values), so
    the whole pool, scratch included, must be equal."""
    pool, scale, qmax = _pool(kv, seed=31)
    rng = np.random.default_rng(32)
    W = 13
    new = (rng.standard_normal((HKV, W, HD)) * 3).astype(np.float32)
    pids = np.array([2] * 3 + [4] * 8 + [5] * 2, np.int32)
    offs = np.concatenate([np.arange(5, 8), np.arange(8), np.arange(2)]).astype(np.int32)
    ub = np.array([2, 4, 5, 0], np.int32)
    (tp, ts), (jp, js) = _both(pool, scale)
    out = pcache.quant_scatter_span(tp, ts, torch.from_numpy(new), torch.from_numpy(pids),
                                    torch.from_numpy(offs), torch.from_numpy(ub), qmax)
    assert out[0] is tp and out[1] is ts
    want = jcache.quant_scatter_span(jp, js, jnp.asarray(new), jnp.asarray(pids),
                                     jnp.asarray(offs), jnp.asarray(ub), qmax)
    _assert_pools_equal((tp, ts), want, skip_scratch=False)
    # old positions of block 2 requantized to the grown scale and still
    # within one step of their originals
    assert float(ts[2].min()) >= scale[2].min()


def test_running_scale_growth_keeps_old_positions_accurate():
    """The reference's own property, on the port: small rows, then 8x
    larger rows into the same block; the early rows still dequantize to
    their originals within one step of the final scale."""
    pool = torch.zeros((3, 2, 8, 4), dtype=torch.int8)
    scale = torch.zeros((3, 2))
    rng = np.random.default_rng(0)
    small = torch.from_numpy((rng.normal(size=(2, 4, 4)) * 0.25).astype(np.float32))
    big = torch.from_numpy((rng.normal(size=(2, 4, 4)) * 2.0).astype(np.float32))
    pids, ub = torch.full((4,), 1), torch.tensor([1, 0])
    pcache.quant_scatter_span(pool, scale, small, pids, torch.arange(4), ub, 127.0)
    sc_small = float(scale[1].max())
    pcache.quant_scatter_span(pool, scale, big, pids, 4 + torch.arange(4), ub, 127.0)
    assert float(scale[1].min()) > sc_small
    deq = pcache.dequantize_values(pool[1], scale[1][:, None, None], torch.float32)
    step = float(scale[1].max())
    assert float((deq[:, :4] - small).abs().max()) <= step
    assert float((deq[:, 4:8] - big).abs().max()) <= step
    assert float(scale[2].abs().max()) == 0.0


def test_cow_copy_carries_scale_rows():
    """copy_block (the engine's copy-on-write) against the reference's
    _copy_block_fn: payload and scale rows of every layer, exactly."""
    cfg, jcfg = LlamaConfig.tiny(), jl.LlamaConfig.tiny()
    c = pcache.create_cache(cfg, 2, 4, 8, device="cpu", quant_kv="int8")
    jc = jcache.create_cache(jcfg, 2, 4, 8, quant_kv="int8")
    rng = np.random.default_rng(1)
    k = rng.integers(-127, 128, c.k.shape).astype(np.int8)
    v = rng.integers(-127, 128, c.k.shape).astype(np.int8)
    ks = rng.random(c.k_scale.shape).astype(np.float32)
    vs = rng.random(c.k_scale.shape).astype(np.float32)
    for t, a in ((c.k, k), (c.v, v), (c.k_scale, ks), (c.v_scale, vs)):
        t.copy_(torch.from_numpy(a))
    jc = jc._replace(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=jnp.asarray(ks),
                     v_scale=jnp.asarray(vs))
    pcache.copy_block(c, 1, 2)
    jc = jax_copy_block(True)(jc, 1, 2)
    for got, want in ((c.k, jc.k), (c.v, jc.v), (c.k_scale, jc.k_scale),
                      (c.v_scale, jc.v_scale)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(c.k_scale[:, 2].numpy(), ks[:, 1])


# --- quantized paged decode attention -------------------------------------------

QB, QH, QHKV, QHD, QBLK, QM = 3, 4, 2, 16, 8, 3


def _attn_case(kv, seed, G=1, shared=False, short=False):
    """The reference's TestQuantKernel case (tests/test_quant.py) with
    float32 queries: pools quantized per block per kv head, full tables,
    or every row's first block shared, or mid-block lengths with scratch
    tails."""
    rng = np.random.default_rng(seed)
    Pn = 1 + QB * QM
    _, qmax = pcache.kv_quant_spec(kv)
    jdt, _ = jcache.kv_quant_spec(kv)
    q = rng.standard_normal((QB, G, QH, QHD)).astype(np.float32)

    def quant_pool():
        f = rng.standard_normal((Pn, QHKV, QBLK, QHD)).astype(np.float32)
        sc = (np.abs(f).max(axis=(2, 3)) / qmax).astype(np.float32)
        return np.asarray(jcache.quantize_values(
            jnp.asarray(f), jnp.asarray(sc)[..., None, None], qmax, jdt)), sc

    (kq, ks), (vq, vs) = quant_pool(), quant_pool()
    tables = (1 + np.arange(QB * QM).reshape(QB, QM)).astype(np.int32)
    if shared:
        tables[:, 0] = 1
    lengths = np.full((QB,), QM * QBLK, np.int32)
    if short:
        lengths = np.array([QBLK + 3, 2 * QBLK, QBLK - 1], np.int32)
        for b in range(QB):
            tables[b, -(-int(lengths[b]) // QBLK):] = 0
    return q, kq, vq, ks, vs, lengths, tables


def _port_attn(q, kq, vq, ks, vs, lengths, tables):
    return decode_attention(_t(q), _t(kq), _t(vq), _t(lengths), tables=_t(tables),
                            k_scale=_t(ks), v_scale=_t(vs)).numpy()


def _jax_attn(q, kq, vq, ks, vs, lengths, tables, impl="pallas"):
    return np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(lengths),
        tables=jnp.asarray(tables), impl=impl, block=QBLK, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("shared,short,G", [
    (False, False, 1), (True, False, 1), (False, True, 1), (False, False, 3),
    (True, True, 3),
])
def test_plain_quant_decode_matches_reference_kernel(kv, shared, short, G):
    """The plain quantized version against the reference's
    _paged_quant_kernel in interpret mode: the same float32 dequantized
    values, only the order of the sums differs (atol 2e-6, rtol 1e-5)."""
    case = _attn_case(kv, seed=10 + G, G=G, shared=shared, short=short)
    reset_attn()
    got = _port_attn(*case)
    assert ATTN_LAUNCHES["paged_decode_attention_quant_plain"] == 1
    assert ATTN_LAUNCHES["paged_decode_attention_plain"] == 0
    np.testing.assert_allclose(got, _jax_attn(*case), **TOL)


def test_poisoned_block_scale_hits_exactly_the_referencing_rows():
    """A NaN scale on row 0's second block: row 0 goes non-finite, rows 1
    and 2 (whose tables never name that block) stay finite and equal the
    reference's."""
    q, kq, vq, ks, vs, lengths, tables = _attn_case("int8", seed=20)
    ks = ks.copy()
    ks[tables[0, 1]] = np.nan
    got = _port_attn(q, kq, vq, ks, vs, lengths, tables)
    want = _jax_attn(q, kq, vq, ks, vs, lengths, tables)
    for out in (got, want):
        assert not np.isfinite(out[0]).all()
        assert np.isfinite(out[1:]).all()
    np.testing.assert_allclose(got[1:], want[1:], **TOL)


def test_quant_decode_args_are_validated():
    q, kq, vq, ks, vs, lengths, tables = (_t(a) for a in _attn_case("int8", seed=30))
    with pytest.raises(ValueError, match="together"):
        decode_attention(q, kq, vq, lengths, tables=tables, k_scale=ks)
    with pytest.raises(ValueError, match="paged"):
        decode_attention(q, kq, vq, lengths, k_scale=ks, v_scale=vs)


class _Routed(Exception):
    """Raised by a stand-in route once it has been asked."""


def test_quant_kernel_wrapper_checks_before_it_builds(monkeypatch):
    """The quantized CUDA wrapper's own checks, each reached before
    anything is built or launched (CPU tensors stand in for the card's):
    the payload and scale types and shapes, 16-byte pool starts, the shape
    rule; then it sizes the workspace its entry point now takes through
    the library's route asked with the quantized flag (here a stand-in
    that records the question), and on the tensor-core instance it also
    holds the queries to a 16-byte start."""
    import importlib

    module = importlib.import_module("tony_tpu_torch.ops.decode_attention")
    q = torch.zeros((2, 5, 8, 64), dtype=torch.bfloat16)
    kq = torch.zeros((3, 2, 16, 64), dtype=torch.int8)
    ks = torch.ones((3, 2), dtype=torch.float32)
    lengths = torch.tensor([3, 20], dtype=torch.int32)
    tables = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32)

    def run(q=q, k=kq, v=kq, k_scale=ks, v_scale=ks):
        module._paged_cuda(q, k, v, lengths, tables, scale=0.125, k_scale=k_scale,
                           v_scale=v_scale)

    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        run(k=kq.to(torch.float16), v=kq.to(torch.float16))
    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        run(v=kq.view(torch.float8_e4m3fn))
    with pytest.raises(ValueError, match="scales must be float32"):
        run(k_scale=ks.double())
    with pytest.raises(ValueError, match="scales must be float32"):
        run(v_scale=ks[:2])
    shifted = torch.zeros(kq.numel() + 1, dtype=torch.int8)[1:].view(kq.shape)
    with pytest.raises(ValueError, match="k must start on a 16-byte boundary"):
        run(k=shifted)
    with pytest.raises(ValueError, match="v must start on a 16-byte boundary"):
        run(v=shifted)
    with pytest.raises(ValueError, match="head_dim 8 must be a multiple of 16"):
        run(q=q[..., :8].contiguous(), k=kq[..., :8].contiguous(),
            v=kq[..., :8].contiguous())
    asked = []

    def route(quant, dtype_code, hd, R):
        asked.append((quant, dtype_code, hd, R))
        raise _Routed

    monkeypatch.setattr(module, "_route", route)
    with pytest.raises(_Routed):
        run()
    with pytest.raises(_Routed):
        run(q=q.float())
    assert asked == [(True, 1, 64, 20), (True, 0, 64, 20)]
    monkeypatch.setattr(module, "_route", lambda *args: 1)
    qs = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        run(q=qs)


# --- the engine -----------------------------------------------------------------

# slots=2 forces churn; the short bucket ladder keeps the reference from
# trimming the mid-block prefix match (its tail bucket must fit max_len)
SERVE = dict(slots=2, max_len=32, kv_block=8, prefill_buckets=(4, 8, 16, 32),
             quant_weights=True)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    cfg = LlamaConfig.tiny()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _traffic(seed=0):
    """Prompts of lengths 3/7/25/12/22/5; the 22-token prompt shares its
    first 19 tokens with the 25-token one: a match of two full blocks plus
    three tokens into the third, so admission copies that block (COW)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 25)
    shared = np.concatenate([base[:19], rng.integers(0, 256, 3)])
    prompts = [rng.integers(0, 256, 3), rng.integers(0, 256, 7), base,
               rng.integers(0, 256, 12), shared, rng.integers(0, 256, 5)]
    return prompts, [5, 6, 6, 6, 8, 4]


def _run_port(params, cfg, kv, prompts, budgets, eos=None, monkeypatch=None):
    """The port's quantized engine over the traffic (request 1 may stop at
    ``eos``); with ``monkeypatch``, also the top-2 logit margin of every
    token a live row sampled (prefill and decode; all rows are greedy)."""
    margins = []
    eng = Engine(params, cfg, ServeConfig(quant_kv=kv, **SERVE), device="cpu")
    if monkeypatch is not None:
        real = pengine.sample_tokens

        def recording(logits, *a, **kw):
            top = logits.topk(2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]).tolist()
            # a decode step samples every slot; only live slots emit
            live = [r is not None for r in eng._slot_rid] if len(gap) > 1 else [True]
            margins.extend(g for g, on in zip(gap, live) if on)
            return real(logits, *a, **kw)

        monkeypatch.setattr(pengine, "sample_tokens", recording)
    ids = [eng.submit(Request(prompt=p, max_new_tokens=m,
                              eos_id=eos if i == 1 else None))
           for i, (p, m) in enumerate(zip(prompts, budgets))]
    out = eng.run()
    return eng, [out[i] for i in ids], margins


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_engine_greedy_tokens_equal_jax_engine(setup, kv, monkeypatch):
    """quant_kv + quant_weights + prefix reuse, with slot churn, an EOS that
    frees a slot and a copy-on-write prefix match: the port's greedy tokens
    equal the JAX engine's (decode through its Pallas quant kernels in
    interpret mode). The two differ only in float32 summation order, so a
    K/V or weight value could land one int8 step apart and move a logit by
    a hair; every greedy top-2 margin along the run is asserted above 1e-4
    first, so a token flip would be diagnosed as a near-tie rather than
    tolerated. (On these seeds the smallest of the 31 margins is 1.18e-2
    for int8 and 1.20e-2 for fp8.)"""
    jcfg, jparams, cfg, params = setup
    prompts, budgets = _traffic()
    _, first, _ = _run_port(params, cfg, kv, prompts, budgets)
    eos = first[1].tokens[1]
    reset_attn()
    reset_mm()
    eng, ours, margins = _run_port(params, cfg, kv, prompts, budgets, eos=eos,
                                   monkeypatch=monkeypatch)
    steps = eng.metrics.decode_steps
    assert ATTN_LAUNCHES["paged_decode_attention_quant_plain"] == steps * cfg.n_layers > 0
    assert ATTN_LAUNCHES["paged_decode_attention_plain"] == 0
    assert MM_LAUNCHES["quant_mm_plain"] == steps * (7 * cfg.n_layers + 1)
    assert eng.cache.quantized and eng.cache.k.dtype == pcache.kv_quant_spec(kv)[0]

    jeng = JEngine(jparams, jcfg, JServeConfig(decode_impl="pallas", quant_kv=kv, **SERVE))
    jids = [jeng.submit(JRequest(prompt=p, max_new_tokens=m,
                                 eos_id=eos if i == 1 else None))
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    jout = jeng.run()
    assert len(margins) == sum(len(c.tokens) for c in ours)
    assert min(margins) > 1e-4, min(margins)
    for i, (c, jid) in enumerate(zip(ours, jids)):
        assert c.tokens == jout[jid].tokens, i
        assert c.finish_reason == jout[jid].finish_reason, i
    assert ours[1].finish_reason == "eos" and len(ours[1].tokens) == 2
    assert eng._cow_copies == jeng._cow_copies == 1
    assert eng.metrics.prefix_hit_tokens == jeng.metrics.prefix_hit_tokens == 19


def test_quant_engine_matches_generate_greedy_and_sampled(setup):
    """generate()'s ``serve`` override runs the identical quantized step,
    so engine-vs-generate parity is exact equality (at the same kv_block:
    the block is the unit of a scale); a sampled request draws the same
    tokens alone, in a busy 2-slot engine with prefix sharing, and through
    generate()."""
    _, _, cfg, params = setup
    sv = dict(quant_kv="int8", quant_weights=True, kv_block=SERVE["kv_block"])
    prompts, budgets = _traffic(seed=1)
    _, ours, _ = _run_port(params, cfg, "int8", prompts, budgets)
    for p, m, c in zip(prompts, budgets, ours):
        solo = generate(params, p[None], cfg, max_new_tokens=m, device="cpu", serve=sv)
        assert solo[0, len(p):].tolist() == c.tokens

    prompts, _ = _traffic(seed=2)
    kwargs = [dict(temperature=0.8, top_k=7), dict(temperature=1.2, top_p=0.9),
              dict(temperature=0.6, top_k=5, top_p=0.7), dict(temperature=1.0),
              dict(temperature=0.9, top_k=20), dict()]
    eng = Engine(params, cfg, ServeConfig(quant_kv="int8", **SERVE), device="cpu")
    ids = [eng.submit(Request(prompt=p, max_new_tokens=5, rng=40 + i, **kw))
           for i, (p, kw) in enumerate(zip(prompts, kwargs))]
    busy = eng.run()
    assert eng._cow_copies == 1
    for i, (p, kw) in enumerate(zip(prompts, kwargs)):
        solo = generate(params, p[None], cfg, max_new_tokens=5, rng=40 + i,
                        device="cpu", serve=sv, **kw)
        alone = Engine(params, cfg, ServeConfig(quant_kv="int8", **SERVE),
                       device="cpu").run([Request(prompt=p, max_new_tokens=5,
                                                  rng=40 + i, **kw)])
        assert busy[ids[i]].tokens == solo[0, len(p):].tolist() == alone[0].tokens, i


def test_quant_engine_stats_and_reused_block_scales(setup):
    """kv_bytes_per_token prices the quantized block, the snapshot carries
    quant_pool_resident_bytes (the bf16 engine's does not); after slot
    churn every free block's scale rows are either zero or queued for the
    zeroing flush, so no reused block inherits an old scale."""
    jcfg, _, cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(quant_kv="int8", **SERVE), device="cpu")
    prompts, budgets = _traffic(seed=3)
    eng.run([Request(prompt=p, max_new_tokens=m) for p, m in zip(prompts, budgets)])
    snap = eng.stats_snapshot()
    assert snap["kv_bytes_per_token"] == pytest.approx(
        jcache.block_bytes(jcfg, 8, quant_kv="int8") / 8)
    assert snap["quant_pool_resident_bytes"] == eng._pool.n_blocks * \
        pcache.block_bytes(cfg, 8, quant_kv="int8")
    bf = Engine(params, cfg, ServeConfig(slots=2, max_len=32, kv_block=8), device="cpu")
    assert "quant_pool_resident_bytes" not in bf.stats_snapshot()
    assert bf.stats_snapshot()["kv_bytes_per_token"] > snap["kv_bytes_per_token"]
    # a fresh allocation is queued, and the next write's flush zeroes it
    pid = eng._alloc_block()
    assert eng._fresh_scale == [pid]
    eng.cache.k_scale[:, pid] = 3.0
    eng._flush_fresh_scales()
    assert not eng._fresh_scale and not eng.cache.k_scale[:, pid].any()


def test_unknown_quant_kv_raises(setup):
    """As the reference: an unknown kv dtype is refused at build."""
    _, _, cfg, params = setup
    with pytest.raises(ValueError, match="int4"):
        Engine(params, cfg, ServeConfig(slots=1, max_len=16, kv_block=8,
                                        quant_kv="int4"), device="cpu")
