"""The port's chunked CE head (tony_tpu_torch.ops.fused_ce) against the
JAX package's ``fused_ce_tokens(impl="scan")`` and its dense oracle
``reference_ce_tokens``: per-token losses and the (dh, dW) gradients, on
the same numpy inputs, with a vocabulary that is not a multiple of the
chunk (the tail step) and one that is. Then the pallas path's plain
versions (what the CPU runs for ``impl="pallas"``) against the
reference's ``_pallas_fwd`` / ``_pallas_bwd`` in interpret mode: padded
vocab tiles, ragged row blocks, and the nonfinite cases of
``tests/test_fused_ce.py`` with their masks held exactly.

Tolerance: atol=1e-5, rtol=1e-5, float32 on both sides (the online
logsumexp and the chunked dW sum in another order than the dense
oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import fused_ce as jce
from tony_tpu_torch.ops.fused_ce import (
    LAUNCHES, ce_bwd, ce_dh_plain, ce_dw_plain, ce_fwd, ce_fwd_plain, f32_matmul_route,
    fused_ce_tokens, fwd_splits, reference_ce_tokens, reset_launches,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((2, 12, 32)).astype(np.float32)
    w = (rng.standard_normal((32, V)) / np.sqrt(32)).astype(np.float32)
    t = rng.integers(0, V, (2, 12)).astype(np.int32)
    t[0, :3] = [0, V - 1, V - 2]              # first and tail columns
    g = rng.standard_normal((2, 12)).astype(np.float32)
    return h, w, t, g


@pytest.mark.parametrize("V,chunk", [(100, 32), (96, 32), (50, 64)],
                         ids=["tail", "exact", "one-chunk"])
def test_scan_matches_jax_scan_and_dense(V, chunk):
    h, w, t, g = _inputs(V)

    def jloss(h, w):
        return jnp.sum(jce.fused_ce_tokens(h, w, jnp.asarray(t), impl="scan",
                                           vocab_chunk=chunk) * g)

    jtok = jce.fused_ce_tokens(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                               impl="scan", vocab_chunk=chunk)
    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    jdense = jce.reference_ce_tokens(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t))

    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tok = fused_ce_tokens(th, tw, torch.from_numpy(t), vocab_chunk=chunk)
    dh, dw = torch.autograd.grad(tok, (th, tw), torch.from_numpy(g))
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(jtok), **TOL)
    np.testing.assert_allclose(tok.detach().numpy(), np.asarray(jdense), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL)
    dense = reference_ce_tokens(torch.from_numpy(h), torch.from_numpy(w),
                                torch.from_numpy(t))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    assert tok.dtype == torch.float32 and tok.shape == (2, 12)


def test_config_knobs_and_errors():
    """``cfg.ce_vocab_chunk`` is read; ``impl='pallas'`` runs (its plain
    versions here) and equals the scan head, with ``cfg``'s block knobs
    read; shape errors as in the reference."""
    h, w, t, _ = _inputs(100)
    h, w, t = map(torch.from_numpy, (h, w, t))

    class Cfg:
        ce_impl = "scan"
        ce_vocab_chunk = 7

    class PallasCfg:
        ce_impl = "pallas"
        ce_block_n = 16
        ce_block_v = 24

    torch.testing.assert_close(fused_ce_tokens(h, w, t, Cfg()),
                               fused_ce_tokens(h, w, t, vocab_chunk=100),
                               atol=1e-5, rtol=1e-5)
    reset_launches()
    torch.testing.assert_close(fused_ce_tokens(h, w, t, PallasCfg()),
                               fused_ce_tokens(h, w, t, vocab_chunk=100),
                               atol=1e-5, rtol=1e-5)
    assert LAUNCHES["ce_fwd_plain"] == 1 and LAUNCHES["ce_fwd"] == 0
    with pytest.raises(ValueError, match="unknown ce_impl"):
        fused_ce_tokens(h, w, t, impl="dense")
    with pytest.raises(ValueError, match="lm_head"):
        fused_ce_tokens(h, w[:8], t)
    with pytest.raises(ValueError, match="targets"):
        fused_ce_tokens(h, w, t[:1])
    assert f32_matmul_route("cpu", torch.float32) == "float32"
    assert f32_matmul_route("cpu", torch.bfloat16) == "upcast"


# --- the pallas path's plain versions against the reference's kernels ---------


def _jax_pallas(h, w, t, g, bn, bv):
    """The reference's pallas forward and backward (interpret mode) on
    ``[N, D]`` rows: lse, tl, dh, dW."""
    h2, w2, t2 = jnp.asarray(h), jnp.asarray(w), jnp.asarray(t)
    lse, tl = jce._pallas_fwd(h2, w2, t2, bn, bv)
    dh, dw = jce._pallas_bwd(h2, w2, t2, lse, jnp.asarray(g), bn, bv)
    return [np.asarray(x) for x in (lse, tl, dh, dw)]


def _port_plain(h, w, t, g, bn, bv):
    h, w, t, g = map(torch.from_numpy, (h, w, t, g))
    lse, tl = ce_fwd_plain(h, w, t.long(), bv)
    dh = ce_dh_plain(h, w, t.long(), lse, g, bv)
    dw = ce_dw_plain(h, w, t.long(), lse, g, bn, bv)
    return [x.numpy() for x in (lse, tl, dh, dw)]


def _hold(got, want, names=("lse", "tl", "dh", "dW")):
    """Nonfinite masks exactly equal, finite values within TOL."""
    for a, b, name in zip(got, want, names):
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=name)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], err_msg=name, **TOL)


def _rows(N, V, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, 32)).astype(np.float32)
    w = (rng.standard_normal((32, V)) / np.sqrt(32)).astype(np.float32)
    t = rng.integers(0, V, N).astype(np.int32)
    t[:3] = [0, V - 1, V - 2]                 # the first and the last columns
    g = (rng.standard_normal(N) / N).astype(np.float32)
    return h, w, t, g


@pytest.mark.parametrize("N,bn,bv", [(24, 32, 64), (24, 64, 128), (54, 32, 64),
                                     (54, 16, 24)],
                         ids=["32x64", "64x128", "ragged54-32x64", "ragged54-16x24"])
def test_pallas_plain_matches_jax_pallas_kernels(N, bn, bv):
    """lse, target logit, dh and dW of the plain versions against the
    reference's three kernels at V 100 (never a multiple of the vocab
    tile), with whole and ragged row blocks."""
    h, w, t, g = _rows(N, 100, seed=N + bn)
    _hold(_port_plain(h, w, t, g, bn, bv), _jax_pallas(h, w, t, g, bn, bv))


@pytest.mark.parametrize("bn,bv", [(32, 64), (64, 128)], ids=["32x64", "64x128"])
def test_pallas_losses_and_grads_match_jax_fused_ce_tokens(bn, bv):
    """``fused_ce_tokens(impl="pallas")`` end to end, value and both
    grads, against the reference's with the same knobs; the CPU ran each
    plain version once and no kernel."""
    h, w, t, g = _inputs(100)

    def jloss(h_, w_):
        return jnp.sum(jce.fused_ce_tokens(h_, w_, jnp.asarray(t), impl="pallas",
                                           block_n=bn, block_v=bv) * g)

    jtok = jce.fused_ce_tokens(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                               impl="pallas", block_n=bn, block_v=bv)
    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    reset_launches()
    tok = fused_ce_tokens(th, tw, torch.from_numpy(t), impl="pallas", block_n=bn,
                          block_v=bv)
    dh, dw = torch.autograd.grad(tok, (th, tw), torch.from_numpy(g))
    _hold([tok.detach().numpy(), dh.numpy(), dw.numpy()],
          [np.asarray(jtok), np.asarray(jdh), np.asarray(jdw)], ("loss", "dh", "dW"))
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ce_fwd_plain": 1, "ce_dh_plain": 1, "ce_dw_plain": 1}


@pytest.mark.parametrize("bn,bv", [(32, 64), (64, 128)], ids=["32x64", "64x128"])
def test_pallas_plain_poisoned_rows_match_the_reference(bn, bv):
    """A NaN row and an inf row: the same rows go nonfinite in lse, tl, dh
    and dW as in the reference's kernels, and the rest still match."""
    h, w, t, g = _rows(54, 100, seed=3)
    h[3] = np.nan
    h[40, 5] = np.inf
    want = _jax_pallas(h, w, t, g, bn, bv)
    assert not np.isfinite(want[0][3]) and not np.isfinite(want[0][40])
    _hold(_port_plain(h, w, t, g, bn, bv), want)


@pytest.mark.parametrize("bn,bv", [(32, 64), (64, 128)], ids=["32x64", "64x128"])
def test_pallas_plain_poisoned_weight_matches_the_reference(bn, bv):
    """A NaN in lm_head reaches every loss, dh and dW, as in the
    reference's kernels (masks equal, element for element)."""
    h, w, t, g = _rows(54, 100, seed=4)
    w[2, 9] = np.nan
    want = _jax_pallas(h, w, t, g, bn, bv)
    assert not np.isfinite(want[0]).any()
    got = _port_plain(h, w, t, g, bn, bv)
    _hold(got, want)
    assert not np.isfinite(got[2]).any() and not np.isfinite(got[3]).any()


def test_pallas_wrappers_take_the_plain_versions_on_the_cpu():
    """``ce_fwd``/``ce_bwd`` on CPU tensors are the plain versions, counted
    as such; ``dw=False`` runs the dh half alone."""
    h, w, t, g = map(torch.from_numpy, _rows(24, 100, seed=5))
    reset_launches()
    lse, tl = ce_fwd(h, w, t.long(), 64)
    dh, dw = ce_bwd(h, w, t.long(), lse, g, 32, 64)
    dh_only, none = ce_bwd(h, w, t.long(), lse, g, 32, 64, dw=False)
    assert none is None
    torch.testing.assert_close(dh_only, dh, atol=0, rtol=0)
    torch.testing.assert_close(dw, ce_dw_plain(h, w, t.long(), lse, g, 32, 64),
                               atol=0, rtol=0)
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ce_fwd_plain": 1, "ce_dh_plain": 2, "ce_dw_plain": 1}


@pytest.mark.parametrize("N,V,scalar", [(16384, 32000, 9), (16300, 31992, 9), (37, 1000, 8),
                                        (1100, 4104, 33)])
def test_fwd_workspace_is_sized_by_route(N, V, scalar):
    """ce_fwd's partials workspace ``[3, splits, N]`` follows the instance
    that runs: the tensor-core forward writes one partial per 256-column
    tile of the vocab whatever the rows and the card; the scalar one splits
    its 128-column tiles for about 8 CTAs of 128 rows per SM on an H100's
    132 SMs (``scalar``), every split holding a tile, and one split on a
    card of one SM with many row blocks."""
    for sms in (132, 114, 1):
        assert fwd_splits("tensor cores", N, V, sms) == -(-V // 256)
        splits, tiles = fwd_splits("scalar", N, V, sms), -(-V // 128)
        assert 1 <= splits <= tiles and (splits - 1) * -(-tiles // splits) < tiles
    assert fwd_splits("scalar", N, V, 132) == scalar
    assert fwd_splits("scalar", 16384, V, 1) == 1
