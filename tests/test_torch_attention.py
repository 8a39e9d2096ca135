"""The port's flash attention (tony_tpu_torch.ops.attention) against the
JAX package's: the plain versions the port runs for CPU tensors must give
what the reference's Pallas kernels give (interpret mode on the CPU), on
the same numpy inputs, for the forward (out, lse), dq and dk/dv, and the
autograd entry must give ``jax.grad``'s gradients.

Tolerance: atol=2e-5, rtol=1e-4, float32 everywhere. The reference walks
16 x 16 tiles with an online softmax, the port takes one softmax over the
sequence: the same sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.ops import attention as ja
from tony_tpu_torch.ops.attention import (
    LAUNCHES, _tma_aligned, _tma_ready, flash_attention, flash_dkv_pass, flash_dq_pass,
    flash_fwd_pass, reset_launches, sharded_flash_attention,
)

B, S, HD = 2, 64, 16
BLK = 16            # the reference's tiles: four per side at S = 64
TOL = dict(atol=2e-5, rtol=1e-4)
CASES = [(4, 2, True), (4, 4, True), (4, 2, False), (4, 4, False)]
IDS = ["gqa-causal", "mha-causal", "gqa-full", "mha-full"]


def _inputs(H, Hkv, seed=0):
    """Folded [B*H, S, hd] q/dO and [B*Hkv, S, hd] k/v, float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B * H, S, HD)).astype(np.float32)
    k = rng.standard_normal((B * Hkv, S, HD)).astype(np.float32)
    v = rng.standard_normal((B * Hkv, S, HD)).astype(np.float32)
    do = rng.standard_normal((B * H, S, HD)).astype(np.float32)
    return q, k, v, do


def _kw(H, Hkv, causal):
    return dict(scale=HD ** -0.5, blk_q=BLK, blk_k=BLK, causal=causal,
                heads=H, kv_heads=Hkv)


@pytest.mark.parametrize("H,Hkv,causal", CASES, ids=IDS)
def test_passes_match_jax_pallas(H, Hkv, causal):
    """flash_fwd_pass, flash_dq_pass and flash_dkv_pass against the
    reference's, with the reference's lse and delta fed to both backward
    passes (the explicit-residual contract)."""
    q, k, v, do = _inputs(H, Hkv)
    kw = _kw(H, Hkv, causal)
    jout, jlse = ja.flash_fwd_pass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    reset_launches()
    out, lse = flash_fwd_pass(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    assert lse.shape == (B * H, 1, S)

    jlse = np.array(jlse)            # a writable copy for torch.from_numpy
    delta = np.sum(do * np.asarray(jout), axis=-1)[:, None, :]
    args = (q, k, v, do, jlse, delta)
    jdq = ja.flash_dq_pass(*map(jnp.asarray, args), **kw)
    jdk, jdv = ja.flash_dkv_pass(*map(jnp.asarray, args), **kw)
    dq = flash_dq_pass(*map(torch.from_numpy, args), **kw)
    dk, dv = flash_dkv_pass(*map(torch.from_numpy, args), **kw)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **TOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **TOL)
    assert dk.shape == (B * Hkv, S, HD)
    assert LAUNCHES["flash_fwd_plain"] == LAUNCHES["flash_dq_plain"] == 1
    assert LAUNCHES["flash_dkv_plain"] == 1
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_dq"] == LAUNCHES["flash_dkv"] == 0


def _unfold(x, h):
    return x.reshape(B, h, S, HD).transpose(0, 2, 1, 3)    # -> [B, S, h, hd]


@pytest.mark.parametrize("H,Hkv,causal", CASES, ids=IDS)
def test_flash_attention_grad_matches_jax_grad(H, Hkv, causal):
    """The autograd entry ``[B, S, H, hd]``: output and the gradients of
    sum(out * dO) against the reference's ``flash_attention`` under
    ``jax.grad``."""
    q, k, v, do = (_unfold(x, h) for x, h in zip(_inputs(H, Hkv, seed=1),
                                                    (H, Hkv, Hkv, H)))

    def jloss(q, k, v):
        out = ja.flash_attention(q, k, v, causal=causal, block_q=BLK, block_k=BLK)
        return jnp.sum(out * do), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
          for x in (q, k, v)]
    out = flash_attention(*xs, causal=causal, block_q=BLK, block_k=BLK)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(np.ascontiguousarray(do)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_contract_errors_match_the_reference():
    """The reference's ValueErrors; a multi-device mesh is not ported."""
    q = torch.zeros(1, 64, 4, HD)
    with pytest.raises(ValueError, match="multiple of n_kv_heads"):
        flash_attention(q, torch.zeros(1, 64, 3, HD), torch.zeros(1, 64, 3, HD))
    with pytest.raises(ValueError, match="k/v shape mismatch"):
        flash_attention(q, torch.zeros(1, 64, 2, HD), torch.zeros(1, 64, 4, HD))
    with pytest.raises(ValueError, match="multiple of block sizes"):
        flash_attention(q, q, q, block_q=48)
    torch.testing.assert_close(sharded_flash_attention(q, q, q), flash_attention(q, q, q))

    class Mesh:
        size = 4

    with pytest.raises(NotImplementedError, match="mesh"):
        sharded_flash_attention(q, q, q, mesh=Mesh())


def test_tma_rule_copies_unaligned_inputs():
    """The host rule in front of the bf16 tensor-core kernels: TMA reads a
    tensor only from a 16-byte-aligned start with 16-byte strides. Aligned
    tensors pass as they are (strides of size-1 dimensions and the unit
    head_dim stride aside); a misaligned storage offset or an odd stride
    gets aligned contiguous copies of every tensor passed together (so k
    and v keep sharing strides), equal in value."""
    base = torch.arange(4 * 64 * 4 * 64 + 8, dtype=torch.float32).to(torch.bfloat16)
    shape = (4, 64, 4, 64)
    aligned = base[:-8].view(shape)
    assert _tma_aligned(aligned)
    assert _tma_ready(aligned)[0] is aligned
    # storage offset 3 elements = 6 bytes past an aligned start
    shifted = base[3:3 + aligned.numel()].view(shape)
    assert not _tma_aligned(shifted)
    # an odd head stride (65 elements = 130 bytes)
    odd = torch.as_strided(base, (1, 64, 4, 64), (64 * 4 * 65, 4 * 65, 65, 1))
    assert not _tma_aligned(odd)
    # a size-1 batch dimension with an odd stride needs no copy
    single = torch.as_strided(base, (1, 64, 4, 64), (7, 4 * 64, 64, 1))
    assert _tma_aligned(single)
    for bad in (shifted, odd):
        k, v = _tma_ready(bad, aligned[:bad.shape[0]])
        for got, want in ((k, bad), (v, aligned[:bad.shape[0]])):
            assert got is not want and _tma_aligned(got) and got.is_contiguous()
            torch.testing.assert_close(got, want, atol=0, rtol=0)
        assert k.stride() == v.stride()
