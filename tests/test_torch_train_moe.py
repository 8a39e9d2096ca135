"""The port's MoE training path against the JAX package's, on
``LlamaConfig.tiny_moe()`` (4 experts, top-2, float32) with the recipe
chip_smoke trains bench_moe with: grouped dispatch through the grouped
matmul's 'pallas' impl (its plain versions on CPU tensors; the reference's
Pallas kernels in interpret mode), flash attention, remat with
``save_attn_kernel``, the scan CE head, AdamW.

Parameters cross as numpy (``params_from_numpy``). Top-k routing is
discrete: the five-step test records every router call of the port's steps
and asserts that the second and third largest probabilities of every token
stay more than 1e-4 apart, so a route that flips between the frameworks
fails that check and is not hidden by the tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.parallel.mesh import MeshShape, build_mesh
from tony_tpu.train import data as jdata
from tony_tpu.train import trainer as jtrainer
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.llama import LlamaConfig, ce_tokens, loss_and_aux
from tony_tpu_torch.ops.attention import LAUNCHES as FLASH_LAUNCHES
from tony_tpu_torch.ops.attention import reset_launches as reset_flash
from tony_tpu_torch.ops.grouped_mm import LAUNCHES, reset_launches
from tony_tpu_torch.parallel import moe as pm
from tony_tpu_torch.train import DataConfig, FitConfig, fit
from tony_tpu_torch.train.data import synthetic_batches
from tony_tpu_torch.train.trainer import (
    default_optimizer, make_train_state, make_train_step, tree_leaves,
)

RECIPE = dict(moe_gmm_impl="pallas", attention_impl="flash", remat=True,
              remat_policy="save_attn_kernel", ce_impl="scan", flash_block_q=16,
              flash_block_k=16)
DATA = dict(global_batch=2, seq_len=32, vocab_size=256)


def test_five_moe_steps_match_jax_make_train_step(monkeypatch):
    """Per-step loss (with its aux term) and grad norm of the port's step
    against the JAX ``make_train_step`` on a one-device CPU mesh, five
    steps from the same params and batches, within 1e-4 relative: float32
    on both sides, sums in another order. Each layer and step runs the
    three grouped matmuls twice (forward, and again in the remat backward),
    their dx and dW once, and the flash forward once."""
    jcfg = jl.LlamaConfig.tiny_moe(**RECIPE)
    mesh = build_mesh(MeshShape(), devices=jax.devices()[:1])
    jopt = jtrainer.default_optimizer(lr=5e-3, warmup_steps=2, decay_steps=5)
    # seed 5: the smallest route margin over the five steps is 4.8e-4
    jstate = jtrainer.make_train_state(jax.random.key(5), jcfg, mesh, jopt)
    tree = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrainer.make_train_step(jcfg, mesh, jopt)

    cfg = LlamaConfig.tiny_moe(**RECIPE)
    opt = default_optimizer(lr=5e-3, warmup_steps=2, decay_steps=5)
    state = make_train_state(cfg, opt, params=params_from_numpy(tree, cfg, device="cpu"))
    step = make_train_step(cfg, opt)

    margins = []
    select = pm._top_k_select

    def recording(probs, mcfg):
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        margins.append(float((top[:, 1] - top[:, 2]).min()))
        return select(probs, mcfg)

    monkeypatch.setattr(pm, "_top_k_select", recording)
    jb = jdata.synthetic_batches(jdata.DataConfig(**DATA))
    pb = synthetic_batches(DataConfig(**DATA))
    for i in range(5):
        ji, jt = next(jb)
        jstate, jm = jstep(jstate, ji, jt)
        reset_launches()
        reset_flash()
        state, m = step(state, *next(pb))
        L = cfg.n_layers
        assert LAUNCHES["gmm_fwd_plain"] == 6 * L
        assert LAUNCHES["gmm_dx_plain"] == LAUNCHES["gmm_dw_plain"] == 3 * L
        assert FLASH_LAUNCHES["flash_fwd_plain"] == L
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                       atol=0, err_msg=f"step {i} {key}")
        assert m["step"] == int(jm["step"]) == i + 1
        assert 0.9 < float(m["aux"]) < 2.0       # E * sum(frac * prob), >= 1
    assert len(margins) == 2 * 5 * cfg.n_layers and min(margins) > 1e-4
    want = jax.tree.map(np.asarray, jstate.params)
    got = params_from_numpy(want, cfg, device="cpu")
    for a, b in zip(tree_leaves(state.params), tree_leaves(got)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-4, rtol=1e-3)


def test_moe_loss_adds_the_aux_term_like_the_reference():
    """The port's loss and every grad against ``jax.value_and_grad`` of the
    reference's ``loss_from_pairs`` at ``moe_aux_coef=1.0``, within 1e-5
    absolute / 1e-4 relative; and the loss is the CE head's mean plus
    ``moe_aux_coef * aux`` exactly."""
    jcfg = jl.LlamaConfig.tiny_moe(**RECIPE, moe_aux_coef=1.0)
    jparams = jl.init_params(jax.random.key(1), jcfg)
    inputs, targets = next(synthetic_batches(DataConfig(**DATA)))
    jloss, jgrads = jax.value_and_grad(jl.loss_from_pairs)(
        jparams, inputs.numpy(), targets.numpy(), jcfg)
    cfg = LlamaConfig.tiny_moe(**RECIPE, moe_aux_coef=1.0)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_and_aux(params, inputs, targets, cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    want = tree_leaves(params_from_numpy(jax.tree.map(np.asarray, jgrads), cfg,
                                         device="cpu"))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)
    from tony_tpu_torch.models.llama import hidden_states_with_aux

    with torch.no_grad():
        h, _ = hidden_states_with_aux(params, inputs, cfg)
        ce = ce_tokens(h, params["lm_head"], targets, cfg).mean()
    assert float(loss) == float(ce + cfg.moe_aux_coef * aux)
    assert 0.9 < float(aux) < 2.0


def test_params_from_numpy_carries_the_moe_tree():
    """The reference's bf16 MoE tree crosses with its keys, [L, E, ...]
    shapes and dtypes: bf16 experts, the float32 router, bit for bit."""
    jcfg = jl.LlamaConfig.tiny_moe(dtype=jax.numpy.bfloat16)
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.key(2), jcfg))
    cfg = LlamaConfig.tiny_moe(dtype=torch.bfloat16)
    params = params_from_numpy(tree, cfg, device="cpu")
    lay = params["layers"]
    assert lay["router"].dtype == torch.float32
    assert lay["w1"].dtype == lay["w2"].dtype == lay["w3"].dtype == torch.bfloat16
    assert tuple(lay["w1"].shape) == (2, 4, 64, 128)
    assert tuple(lay["w2"].shape) == (2, 4, 128, 64)
    for name in ("router", "w1", "w2", "w3"):
        want = tree["layers"][name]
        got = lay[name].float().numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32), err_msg=name)
    with pytest.raises(ValueError, match="router"):
        params_from_numpy(tree, LlamaConfig.tiny_moe(n_experts=8), device="cpu")


def test_fit_applies_the_moe_overrides(monkeypatch):
    """fit() on tiny_moe: the grouped dispatch runs the grouped matmul at
    the model's row tile or at ``moe_group_block``'s, the
    ``moe_dispatch='gather'`` override runs none; each step reports its aux
    loss; the expert-parallel overlap still raises."""
    blocks = []
    layout = pm.grouped_layout

    def recording(sizes, block, n_tiles):
        blocks.append(block)
        return layout(sizes, block, n_tiles)

    monkeypatch.setattr(pm, "grouped_layout", recording)
    base = FitConfig(model=LlamaConfig.tiny_moe(**RECIPE), data=DataConfig(**DATA),
                     steps=2, log_every=1, lr=5e-3, warmup_steps=1)
    for dispatch, block, want in (("", 0, {128}), ("gather", 0, set()),
                                  ("", 16, {16})):
        seen: list = []
        blocks.clear()
        reset_launches()
        final = fit(dataclasses.replace(base, moe_dispatch=dispatch,
                                        moe_group_block=block,
                                        on_metrics=seen.append), device="cpu")
        assert np.isfinite(final["final_loss"])
        assert set(blocks) == want
        assert (LAUNCHES["gmm_fwd_plain"] > 0) == bool(want)
        assert [m["step"] for m in seen] == [1, 2]
        assert all(0.9 < m["aux"] < 2.0 for m in seen)
    with pytest.raises(NotImplementedError, match="moe_overlap_chunk"):
        fit(dataclasses.replace(base, moe_overlap_chunk=64), device="cpu")
