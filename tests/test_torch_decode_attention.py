"""The port's decode attention (tony_tpu_torch.ops.decode_attention),
paged and contiguous, against the JAX package's: the plain versions the
port runs for CPU tensors must match the reference's Pallas kernels
(interpret mode on the CPU), its scan form and its repeat-expanded oracle,
on the same numpy inputs.

Tolerance: atol=2e-6, rtol=1e-5, the one the reference holds its own decode
kernels to (tests/test_serve.py): float32 everywhere, only the order of the
sums differs."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    reference_decode_attention as jax_reference,
)
from tony_tpu_torch.ops.decode_attention import (
    LAUNCHES, decode_attention, decode_attention_plain, paged_decode_attention_plain,
    reference_decode_attention, reset_launches,
)

B, H, HKV, HD, BLK, M = 5, 4, 2, 16, 8, 6
# a length-1 row, an exact block boundary, a full row, two ragged rows
LENGTHS = [1, 8, 48, 13, 27]
TOL = dict(atol=2e-6, rtol=1e-5)


def _case(G: int, seed: int = 0, garbage: bool = False):
    """Pools, tables and queries from a numpy seed. Row 4 shares row 2's
    first two physical blocks; table entries past each row's length point
    at the scratch block 0. With ``garbage`` every pool position past its
    row's length (and the whole scratch block) holds +-1e3."""
    rng = np.random.default_rng(seed)
    lengths = np.array([max(n, G) for n in LENGTHS], np.int32)
    need = [math.ceil(n / BLK) for n in lengths]
    own = need.copy()
    own[4] -= 2                                   # row 4 reuses two of row 2's
    P = 1 + sum(own)
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, M), np.int32)
    at = 0
    for b in range(B):
        if b == 4:
            tables[b, :2] = tables[2, :2]
            tables[b, 2:need[b]] = ids[at:at + own[b]]
        else:
            tables[b, :need[b]] = ids[at:at + own[b]]
        at += own[b]
    q = rng.standard_normal((B, G, H, HD)).astype(np.float32)
    k = rng.standard_normal((P, HKV, BLK, HD)).astype(np.float32)
    v = rng.standard_normal((P, HKV, BLK, HD)).astype(np.float32)
    if garbage:
        k[0], v[0] = 1e3, -1e3
        for b in range(B):
            last = tables[b, need[b] - 1]
            tail = lengths[b] - (need[b] - 1) * BLK
            k[last, :, tail:], v[last, :, tail:] = 1e3, -1e3
    return q, k, v, lengths, tables


def _port(q, k, v, lengths, tables):
    return decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), tables=torch.from_numpy(tables),
    ).numpy()


def _contiguous(pool, tables):
    """Gather through the table: [B, Hkv, M*blk, hd] contiguous caches."""
    g = pool[tables]                                  # [B, M, Hkv, blk, hd]
    return g.transpose(0, 2, 1, 3, 4).reshape(B, HKV, M * BLK, HD)


@pytest.mark.parametrize("G", [1, 3])
def test_plain_matches_jax_pallas_and_reference(G):
    q, k, v, lengths, tables = _case(G)
    got = _port(q, k, v, lengths, tables)
    pallas = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        tables=jnp.asarray(tables), impl="pallas",
    )
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    kc, vc = _contiguous(k, tables), _contiguous(v, tables)
    ref = jax_reference(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    port_ref = reference_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lengths),
    ).numpy()
    np.testing.assert_allclose(port_ref, np.asarray(ref), **TOL)


@pytest.mark.parametrize("G", [1, 3])
def test_garbage_past_length_does_not_leak(G):
    """Stale cache content past a row's length (a previous tenant's K/V, or
    the scratch block's) must not reach the output: the length mask is all
    that stands between slot reuse and cross-request contamination."""
    clean = _port(*_case(G, seed=1))
    dirty = _port(*_case(G, seed=1, garbage=True))
    np.testing.assert_allclose(dirty, clean, atol=1e-6)
    assert np.isfinite(dirty).all()


def test_one_query_form_squeezes():
    q, k, v, lengths, tables = _case(1, seed=2)
    four = _port(q, k, v, lengths, tables)
    three = _port(q[:, 0], k, v, lengths, tables)
    assert three.shape == (B, H, HD)
    np.testing.assert_array_equal(three, four[:, 0])


def test_cpu_tensors_never_count_a_kernel_launch():
    reset_launches()
    _port(*_case(1, seed=3))
    _port(*_case(3, seed=3))
    assert LAUNCHES["paged_decode_attention"] == 0
    assert LAUNCHES["paged_decode_attention_plain"] == 2


def test_wrapper_rejects_what_it_cannot_run():
    q, k, v, lengths, tables = (torch.from_numpy(a) for a in _case(1, seed=4))
    # without tables the pools are read as contiguous [B, Hkv, T, hd] caches
    with pytest.raises(ValueError, match="shapes"):
        decode_attention(q, k, v, lengths)
    with pytest.raises(ValueError, match="shapes"):
        decode_attention(q, k[..., :8], v, lengths, tables=tables)
    with pytest.raises(ValueError, match="batch"):
        decode_attention(q, k, v, lengths, tables=tables[:2])
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(q[:, :, :3], k, v, lengths, tables=tables)


# --- contiguous form ------------------------------------------------------------

# ragged lengths: a length-1 row, an exact tile boundary, two ragged rows and
# one at the cache's end (each at least G, and at most T)
C_LENGTHS = [1, 16, 48, 13, 27]


def _contiguous_case(G: int, rep: int, T: int, seed: int = 0):
    rng = np.random.default_rng(seed + 10 * G + rep + T)
    hkv = 2
    lengths = np.array([min(max(n, G), T) for n in C_LENGTHS], np.int32)
    lengths[2] = T
    q = rng.standard_normal((B, G, hkv * rep, HD)).astype(np.float32)
    k = rng.standard_normal((B, hkv, T, HD)).astype(np.float32)
    v = rng.standard_normal((B, hkv, T, HD)).astype(np.float32)
    return q, k, v, lengths


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("rep", [1, 4])
# T = 48 in tiles of 16 (an exact multiple), and T = 24 under the default
# block of 128 (one tile of the whole cache)
@pytest.mark.parametrize("T,block", [(48, 16), (24, 128)])
def test_contiguous_plain_matches_jax_pallas_and_scan(G, rep, T, block):
    q, k, v, lengths = _contiguous_case(G, rep, T)
    reset_launches()
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lengths),
                           block=block).numpy()
    assert LAUNCHES["decode_attention_plain"] == 1
    assert LAUNCHES["decode_attention"] == 0
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    for impl in ("pallas", "scan"):
        want = jax_decode_attention(*jargs, impl=impl, block=block)
        np.testing.assert_allclose(got, np.asarray(want), **TOL, err_msg=impl)
    ref = jax_reference(*jargs)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    port_ref = reference_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(port_ref, np.asarray(ref), **TOL)


def test_contiguous_one_query_form_and_garbage_past_length():
    """The 3-D query form squeezes G; cache content past a row's length
    never reaches the output."""
    q, k, v, lengths = _contiguous_case(1, 4, 48, seed=5)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    four = decode_attention(t(q), t(k), t(v), t(lengths), block=16)
    three = decode_attention(t(q[:, 0]), t(k), t(v), t(lengths), block=16)
    np.testing.assert_array_equal(three.numpy(), four[:, 0].numpy())
    kd, vd = k.copy(), v.copy()
    for b, n in enumerate(lengths):
        kd[b, :, n:], vd[b, :, n:] = 1e3, -1e3
    dirty = decode_attention_plain(t(q), t(kd), t(vd), t(lengths), scale=HD ** -0.5)
    np.testing.assert_allclose(dirty.numpy(), four.numpy(), atol=1e-6)


def test_contiguous_form_keeps_the_reference_shape_rules():
    q, k, v, lengths = (torch.from_numpy(a) for a in _contiguous_case(1, 1, 48))
    with pytest.raises(ValueError, match="multiple of block 32"):
        decode_attention(q, k, v, lengths, block=32)
    with pytest.raises(ValueError, match="paged form"):
        decode_attention(q, k, v, lengths, k_scale=torch.ones(1), v_scale=torch.ones(1))
    with pytest.raises(ValueError, match="shapes"):
        decode_attention(q, k[:2], v[:2], lengths)
    with pytest.raises(ValueError, match="batch"):
        decode_attention(q, k, v, lengths[:2])
