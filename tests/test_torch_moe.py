"""The port's MoE FFN (tony_tpu_torch.parallel.moe) against the JAX
package's, on the same numpy inputs and parameters: top-k selection with
its tie rule, queue positions and aux loss; ``moe_block`` values and
gradients under every dispatch; the float32 router; ``routing_stats``.

Tolerance: atol=2e-5, rtol=1e-4, float32 (the same products summed in
another order); selections, positions and stats exactly. Top-k is
discrete, so each test first asserts that no two of a token's k + 1
largest router probabilities lie within 1e-5 of each other: a route that
flips between the frameworks fails that check, not the tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.parallel import moe as jm
from tony_tpu_torch.ops.grouped_mm import LAUNCHES, reset_launches
from tony_tpu_torch.parallel import moe as pm

TOL = dict(atol=2e-5, rtol=1e-4)
# LlamaConfig.tiny_moe()'s widths: dim 64, ffn 128, 4 experts, top-2
DIMS = dict(dim=64, ffn_dim=128, n_experts=4, top_k=2)


def _cfgs(**kw):
    return jm.MoEConfig(**DIMS, **kw), pm.MoEConfig(**DIMS, **kw)


def _margin(probs: np.ndarray, k: int) -> float:
    """Smallest gap between neighbours among each token's k + 1 largest
    probabilities (selection and round order both hang on them)."""
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


def _probs(T, E, seed):
    logits = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (8, 3)])
def test_top_k_select_matches_reference(E, k):
    """sel, gates and round-major pos exactly; aux within 1e-6, a few
    float32 ulps of a value near 1 (means over T taken in another order)."""
    probs = _probs(96, E, seed=E + k)
    jcfg = jm.MoEConfig(dim=8, ffn_dim=8, n_experts=E, top_k=k)
    want = jm._top_k_select(jnp.asarray(probs), jcfg)
    got = pm._top_k_select(torch.from_numpy(probs),
                           pm.MoEConfig(dim=8, ffn_dim=8, n_experts=E, top_k=k))
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == got[2].dtype == torch.int32
    assert got[1].dtype == got[3].dtype == torch.float32
    np.testing.assert_allclose(float(got[3]), float(want[3]), atol=1e-6, rtol=0)


def test_top_k_ties_go_to_the_lower_expert():
    """Exact ties pick the lower expert index first, as ``lax.top_k``
    does: all four equal, three equal behind a winner, a tie for second."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.4, 0.2, 0.2, 0.2],
                      [0.1, 0.3, 0.3, 0.3], [0.1, 0.35, 0.2, 0.35],
                      [0.3, 0.1, 0.3, 0.3]], np.float32)
    jcfg, cfg = _cfgs()
    want = jm._top_k_select(jnp.asarray(probs), jcfg)
    got = pm._top_k_select(torch.from_numpy(probs), cfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), [[0, 1], [0, 1], [1, 2], [1, 3], [0, 2]])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


DISPATCHES = [("grouped", "pallas"), ("grouped", "scan"), ("gather", "scan"),
              ("einsum", "scan")]


@pytest.mark.parametrize("dispatch,gmm_impl", DISPATCHES,
                         ids=[f"{d}-{i}" for d, i in DISPATCHES])
def test_moe_block_matches_reference_values_and_grads(dispatch, gmm_impl):
    """y, aux, and the grads of ``sum(y^2) + aux`` with respect to x and
    every parameter. capacity_factor 1.25 drops routes under gather and
    einsum, so the drop rule is held too; group_block 8 gives several
    tiles per expert."""
    kw = dict(dispatch=dispatch, gmm_impl=gmm_impl, group_block=8)
    jcfg, cfg = _cfgs(**kw)
    jparams = jm.init_moe_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    tree = {k: np.asarray(v) for k, v in jparams.items()}
    x = np.random.default_rng(1).standard_normal((2, 24, 64)).astype(np.float32)
    logits = x.reshape(-1, 64) @ tree["router"]
    assert _margin(np.asarray(jax.nn.softmax(logits, axis=-1)), 2) > 1e-5

    def jloss(p, xx):
        y, aux = jm.moe_block(p, xx, jcfg)
        return jnp.sum(y * y) + aux

    (jy, jaux) = jm.moe_block(jparams, jnp.asarray(x), jcfg)
    jgrads = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))

    params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in tree.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    reset_launches()
    y, aux = pm.moe_block(params, xt, cfg)
    names = sorted(params)
    grads = torch.autograd.grad((y * y).sum() + aux, [params[n] for n in names] + [xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[0][name]), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgrads[1]), **TOL)
    want_fwd = 3 if dispatch == "grouped" else 0
    assert LAUNCHES["gmm_fwd_plain"] == want_fwd
    assert LAUNCHES["gmm_dx_plain"] == (3 if gmm_impl == "pallas" and want_fwd else 0)


def test_router_is_float32_for_bf16_inputs():
    """bf16 activations and expert weights, float32 router: the aux loss
    and the router's grad are float32, and the aux loss is exactly the one
    float32 inputs of the same values give (the router upcasts)."""
    _, cfg = _cfgs(gmm_impl="pallas", group_block=8)
    gen = torch.Generator().manual_seed(0)
    p32 = pm.init_moe_params(cfg, gen, dtype=torch.float32, device="cpu")
    p16 = {k: (v if k == "router" else v.to(torch.bfloat16)).requires_grad_(True)
           for k, v in p32.items()}
    x = torch.randn((2, 16, 64), generator=gen).to(torch.bfloat16)
    y, aux = pm.moe_block(p16, x, cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    (g,) = torch.autograd.grad(aux + y.float().sum(), p16["router"])
    assert g.dtype == torch.float32 and p16["router"].dtype == torch.float32
    _, aux32 = pm.moe_block(p32, x.float(), cfg)
    assert float(aux) == float(aux32)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_routing_stats_match_reference(capacity_factor):
    probs = _probs(256, 4, seed=7)
    jcfg, cfg = _cfgs(capacity_factor=capacity_factor)
    assert pm.routing_stats(torch.from_numpy(probs), cfg) == jm.routing_stats(
        jnp.asarray(probs), jcfg)


def test_unported_and_unknown_options_raise():
    _, cfg = _cfgs()
    params = pm.init_moe_params(cfg, dtype=torch.float32, device="cpu")
    x = torch.zeros((1, 8, 64))
    with pytest.raises(NotImplementedError, match="item 8"):
        pm.moe_block(params, x, dataclasses.replace(cfg, overlap_impl="scan"))
    with pytest.raises(ValueError, match="overlap"):
        pm.moe_block(params, x, dataclasses.replace(cfg, overlap_impl="ring"))
    with pytest.raises(ValueError, match="dispatch"):
        pm.moe_block(params, x, dataclasses.replace(cfg, dispatch="sparse"))
    with pytest.raises(ValueError, match="gmm impl"):
        pm.moe_block(params, x, dataclasses.replace(cfg, gmm_impl="xla"))
