"""The port's decode attention (tony_tpu_torch.ops.decode_attention),
paged and contiguous, against the JAX package's: the plain versions the
port runs for CPU tensors must match the reference's Pallas kernels
(interpret mode on the CPU), its scan form and its repeat-expanded oracle,
on the same numpy inputs.

Tolerance: atol=2e-6, rtol=1e-5, the one the reference holds its own decode
kernels to (tests/test_serve.py): float32 everywhere, only the order of the
sums differs."""

import importlib
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
    LAUNCHES, SPLIT, _contiguous_cuda, _paged_cuda, check_kernel_shape, decode_attention,
    decode_attention_plain, kernel_instance, paged_decode_attention_plain,
    reference_decode_attention, reset_launches, split_plan,
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
    # the kernel's own checks, reached before anything is built: pools that
    # do not start on a 16-byte boundary (both designs copy 16 bytes at a
    # time), in either form
    kb = torch.zeros((2, 2, 16, 16), dtype=torch.bfloat16)
    shifted = torch.zeros(kb.numel() + 1, dtype=torch.bfloat16)[1:].view(kb.shape)
    qb, one = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k must start on a 16-byte boundary"):
        _paged_cuda(qb, shifted, kb, one, one[:, None], scale=1.0)
    with pytest.raises(ValueError, match="v must start on a 16-byte boundary"):
        _paged_cuda(qb, kb, shifted, one, one[:, None], scale=1.0)
    with pytest.raises(ValueError, match="k must start on a 16-byte boundary"):
        _contiguous_cuda(qb, shifted[:1], kb[:1], one, block=16, scale=1.0)
    # kernel_instance: unknown kernels and dtypes, and shapes the rule refuses
    with pytest.raises(ValueError, match="no decode kernel"):
        kernel_instance("flash_fwd", torch.bfloat16, 128, 64, 1, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel_instance("decode_attention", torch.float16, 128, 64, 1, 4)


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


# --- the shape rule, the instance route and the split plan ------------------------


def _rule_before(G, H, Hkv, hd, blk, payload, q_item):
    """The shape rule as it stood before the tensor-core instance
    (check_kernel_shape then, frozen): True where it accepted the shape."""
    vec = max(8, 16 // payload)
    if hd > 256 or hd % vec or blk % 16 or not 16 <= blk <= 128:
        return False
    chunk = blk
    while 2 * chunk * hd * q_item > 64 * 1024 and chunk % 16 == 0:
        chunk //= 2
    R = G * (H // Hkv)
    return 2 * chunk * hd * q_item + 4 * (2 * R * hd + R * chunk + 3 * R) <= 232448


@pytest.mark.parametrize("payload,q_item", [(2, 2), (4, 4), (1, 2), (1, 4)],
                         ids=["bf16", "fp32", "quant", "quant-fp32"])
def test_shape_rule_keeps_every_shape_it_accepted(payload, q_item):
    """Over a grid of head_dim, block, G and rep, check_kernel_shape accepts
    exactly what it accepted before the tensor-core instance existed (no
    bf16 shape it took is refused now), and kernel_instance raises the same
    ValueError, before anything is built, where it refuses."""
    for hd in (8, 16, 24, 32, 48, 64, 96, 112, 128, 136, 192, 256, 264):
        for blk in (8, 16, 48, 64, 112, 128, 144):
            for G in (1, 2, 5, 16, 17, 40):
                for rep in (1, 2, 4, 8):
                    want = _rule_before(G, 2 * rep, 2, hd, blk, payload, q_item)
                    try:
                        check_kernel_shape(G, 2 * rep, 2, hd, blk, payload, q_item)
                        got = True
                    except ValueError as e:
                        got, msg = False, str(e)
                    assert got == want, (hd, blk, G, rep)
                    if not got:
                        name = ("paged_decode_attention_quant" if payload == 1
                                else "paged_decode_attention")
                        dtype = torch.float32 if q_item == 4 else torch.bfloat16
                        with pytest.raises(ValueError) as refused:
                            kernel_instance(name, dtype, hd, blk, G, rep)
                        assert str(refused.value) == msg


def test_kernel_instance_asks_the_library_route(monkeypatch):
    """kernel_instance hands the built library's decode_route (here a
    stand-in that records its arguments) the quantized flag, the dtype's
    code, head_dim and the R = G * rep query rows, and names what it
    answers; the route is the library's alone, so Python and CUDA cannot
    disagree."""
    calls = []

    def route(quant, dtype_code, hd, R):
        calls.append((quant, dtype_code, hd, R))
        return 1 if dtype_code == 1 and hd <= 128 else 0

    # the package exports a function of the module's name, so it is imported by name
    module = importlib.import_module("tony_tpu_torch.ops.decode_attention")
    monkeypatch.setattr(module, "_route", route)
    assert kernel_instance("paged_decode_attention", torch.bfloat16, 128, 64, 16, 4) == \
        "tensor cores"
    assert kernel_instance("decode_attention", torch.float32, 128, 128, 1, 4) == "scalar"
    assert kernel_instance("paged_decode_attention_quant", torch.bfloat16, 128, 64, 5,
                           4) == "tensor cores"
    assert kernel_instance("paged_decode_attention_quant", torch.float32, 128, 64, 5,
                           4) == "scalar"
    assert kernel_instance("paged_decode_attention_quant", torch.bfloat16, 256, 64, 1,
                           4) == "scalar"
    assert calls == [(False, 1, 128, 64), (False, 0, 128, 4), (True, 1, 128, 20),
                     (True, 0, 128, 20), (True, 1, 256, 4)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "quant"])
def test_workspace_asks_the_route_of_its_form(monkeypatch, quant):
    """The wrapper sizes the tensor-core instance's workspace from the
    library's route for its own form (the quantized flag for quantized
    pools): a stand-in route records the question; where it answers the
    tensor cores the workspace is split_plan's, per (row, kv head); where
    it answers scalar there is none."""
    module = importlib.import_module("tony_tpu_torch.ops.decode_attention")
    calls = []

    def route(q_flag, dtype_code, hd, R):
        calls.append((q_flag, dtype_code, hd, R))
        return 1 if dtype_code == 1 else 0

    monkeypatch.setattr(module, "_route", route)
    q = torch.zeros((3, 5, 8, 64), dtype=torch.bfloat16)
    ws = module._workspace(q, 2, 8, 64, quant)
    assert ws.dtype == torch.float32 and ws.numel() == 3 * 2 * split_plan(8, 64, 20, 64)[1]
    assert module._workspace(q, 2, 4, 64, quant) is None        # one split
    assert module._workspace(q.float(), 2, 8, 64, quant) is None  # the scalar body
    assert calls == [(quant, 1, 64, 20)] * 2 + [(quant, 0, 64, 20)]


@pytest.mark.parametrize("M,blk", [(1, 16), (16, 16), (17, 16), (32, 64), (8, 128),
                                   (144, 64), (3, 48)])
@pytest.mark.parametrize("R,hd", [(4, 128), (20, 128), (64, 128), (128, 64), (1, 16)])
def test_split_plan_is_a_function_of_the_shape_alone(M, blk, R, hd):
    """The tensor-core instance splits a row at fixed multiples of SPLIT
    positions, whatever the batch or the other rows: ceil(M * blk / SPLIT)
    splits, and with more than one, R * (hd + 2) float32 partials per split
    for each (row, kv head); one split needs no workspace."""
    splits, per = split_plan(M, blk, R, hd)
    assert SPLIT == 256
    assert splits == math.ceil(M * blk / SPLIT) and splits >= 1
    assert (splits - 1) * SPLIT < M * blk <= splits * SPLIT
    assert per == (0 if splits == 1 else splits * R * (hd + 2))
    assert split_plan(M, blk, R, hd) == (splits, per)
