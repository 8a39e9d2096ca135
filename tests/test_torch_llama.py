"""The port's model layer (tony_tpu_torch.models) against the JAX package's:
parameters cross as numpy, and the building blocks and the KV-cache
forward give the reference's numbers on the tiny float32 config.

Tolerance 1e-5 (absolute and relative): float32 on both sides, only the
order of the sums inside the matmuls differs."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tony_tpu.models.generate import (
    KVCache as JKVCache, forward_with_cache as j_forward_with_cache,
)
from tony_tpu.models import llama as jl
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.generate import KVCache, forward_with_cache
from tony_tpu_torch.models.llama import (
    LlamaConfig, apply_rope, init_params, param_shapes, rms_norm, rope_table,
)
from tony_tpu_torch.serve.cache import create_cache

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = LlamaConfig.tiny()
    return jcfg, jparams, tree, cfg, params_from_numpy(tree, cfg, device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_params_from_numpy_round_trips(setup):
    _, _, tree, cfg, params = setup
    back = {k: t.numpy() for k, t in _flat(params).items()}
    want = _flat(tree)
    assert back.keys() == want.keys()
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="layers.wq"):
        params_from_numpy(bad, cfg, device="cpu")


def test_bfloat16_trees_cross_bit_exact(setup):
    """A bf16 reference tree (numpy holds it through ml_dtypes) becomes
    torch.bfloat16 tensors with the same bits."""
    _, _, tree, _, _ = setup
    bf = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), tree)
    params = params_from_numpy(bf, LlamaConfig.tiny(dtype=torch.bfloat16),
                               device="cpu")
    got, want = _flat(params), _flat(bf)
    for name, arr in want.items():
        assert got[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                      arr.view(np.int16), err_msg=name)


def test_init_params_layout_matches_reference():
    """Same keys, shapes and dtypes as the reference's init (the numbers
    differ: torch.Generator is not jax.random)."""
    jcfg, cfg = jl.LlamaConfig.tiny(), LlamaConfig.tiny()
    want = _flat(jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                              jl.init_params(jax.random.key(1), jcfg)))
    got = _flat(init_params(cfg, torch.Generator().manual_seed(1), device="cpu"))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            (tuple(want[name][0]), want[name][1]), name
    assert _flat(param_shapes(cfg)).keys() == got.keys()
    assert cfg.n_params == jcfg.n_params
    big = LlamaConfig.llama3_8b()
    assert big.n_params == jl.LlamaConfig.llama3_8b().n_params == 8_030_261_248


@pytest.mark.parametrize("build", [
    lambda cfg, tree: init_params(cfg, torch.Generator().manual_seed(0)),
    lambda cfg, tree: params_from_numpy(tree, cfg),
    lambda cfg, tree: KVCache.create(cfg, 1, 16),
    lambda cfg, tree: create_cache(cfg, slots=1, n_blocks=2, block=8),
], ids=["init_params", "params_from_numpy", "KVCache.create", "create_cache"])
def test_builders_default_to_cuda_and_raise_without_it(setup, monkeypatch, build):
    """The tensor builders place on CUDA unless the caller asks for the CPU,
    as the engine does: without a card they raise, never fall back."""
    _, _, tree, cfg, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(cfg, tree)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **TOL)
    jcfg, cfg = jl.LlamaConfig.tiny(), LlamaConfig.tiny()
    jcos, jsin = jl.rope_table(jcfg, 5, offset=7)
    cos, sin = rope_table(cfg, 5, offset=7)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), cos, sin).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jcos, jsin)), **TOL)


def test_forward_with_cache_prefill_matches_reference(setup):
    jcfg, jparams, _, cfg, params = setup
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10))
    jlog, jcache = j_forward_with_cache(
        jparams, jnp.asarray(tokens, jnp.int32),
        JKVCache.create(jcfg, 2, 16), jnp.int32(0), jcfg)
    logits, cache = forward_with_cache(
        params, torch.from_numpy(tokens), KVCache.create(cfg, 2, 16, device="cpu"),
        0, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **TOL)


def test_forward_with_cache_tail_matches_reference(setup):
    """A tail prefill over a context cache (the prefix-reuse path): the
    first 6 tokens fill the cache, the next 4 attend it from position 6;
    only the last position is projected."""
    jcfg, jparams, _, cfg, params = setup
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 10))
    _, jctx = j_forward_with_cache(
        jparams, jnp.asarray(tokens[:, :6], jnp.int32),
        JKVCache.create(jcfg, 1, 16), jnp.int32(0), jcfg)
    jlog, _ = j_forward_with_cache(
        jparams, jnp.asarray(tokens[:, 6:], jnp.int32), jctx, jnp.int32(6),
        jcfg, last_only=True)
    _, ctx = forward_with_cache(params, torch.from_numpy(tokens[:, :6]),
                                KVCache.create(cfg, 1, 16, device="cpu"), 0, cfg)
    logits, _ = forward_with_cache(params, torch.from_numpy(tokens[:, 6:]), ctx,
                                   6, cfg, last_only=True)
    assert logits.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TOL)
    # and the tail's logits equal a full prefill's last position
    full, _ = forward_with_cache(params, torch.from_numpy(tokens),
                                 KVCache.create(cfg, 1, 16, device="cpu"), 0, cfg,
                                 last_only=True)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **TOL)
