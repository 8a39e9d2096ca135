"""The port's chunked CE head (tony_tpu_torch.ops.fused_ce) against the
JAX package's ``fused_ce_tokens(impl="scan")`` and its dense oracle
``reference_ce_tokens``: per-token losses and the (dh, dW) gradients, on
the same numpy inputs, with a vocabulary that is not a multiple of the
chunk (the tail step) and one that is.

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
    f32_matmul_route, fused_ce_tokens, reference_ce_tokens,
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
    """``cfg.ce_vocab_chunk`` is read; ``impl='pallas'`` names the unported
    kernels; shape errors as in the reference."""
    h, w, t, _ = _inputs(100)
    h, w, t = map(torch.from_numpy, (h, w, t))

    class Cfg:
        ce_impl = "scan"
        ce_vocab_chunk = 7

    torch.testing.assert_close(fused_ce_tokens(h, w, t, Cfg()),
                               fused_ce_tokens(h, w, t, vocab_chunk=100),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="4-6"):
        fused_ce_tokens(h, w, t, impl="pallas")
    with pytest.raises(ValueError, match="unknown ce_impl"):
        fused_ce_tokens(h, w, t, impl="dense")
    with pytest.raises(ValueError, match="lm_head"):
        fused_ce_tokens(h, w[:8], t)
    with pytest.raises(ValueError, match="targets"):
        fused_ce_tokens(h, w, t[:1])
    assert f32_matmul_route("cpu", torch.float32) == "float32"
    assert f32_matmul_route("cpu", torch.bfloat16) == "upcast"
