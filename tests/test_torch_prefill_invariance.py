"""The engine's prefill is match-invariant: a prompt's K/V and its first
token's logits come from the same (start, rows, context length) calls of
``forward_with_cache`` whatever the prefix store held of it.

The serving engine (``tony_tpu_torch/serve/engine.py``), over a pool of
the model dtype, cuts every prefix match to its full blocks and prefills
the rest in pieces of one ``kv_block``, each attending a contiguous context
of ``blocks_for(piece_end) * kv_block`` positions (quantized pools keep the
reference's mid-block match: ``tests/test_torch_quant.py``). On the tiny config, in
float32 and bf16 on the CPU, a request served after a donor that shares
two full blocks of it and the same request served alone make the same
calls at and past the match, and give bit-equal first-token logits, pool
blocks and greedy tokens; a mid-block (copy-on-write) match is cut to its
full blocks; chunked prefill composes; greedy tokens stay the JAX
engine's."""

import jax
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.serve import (
    Engine as JEngine, Request as JRequest, ServeConfig as JServeConfig,
)
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.llama import LlamaConfig, init_params
from tony_tpu_torch.serve import ServeConfig
from torch_prefill import same_bits, serve_recorded

BLK = 8
SERVE = dict(slots=2, max_len=48, kv_block=BLK, prefill_buckets=(8, 16, 32, 48))


def _prompts(shared: int, seed: int = 0):
    """A 21-token donor and a 29-token request sharing its first ``shared``
    tokens (16: two full blocks; 19: two blocks and three tokens into the
    third, which the donor registers too when it is 24 long)."""
    rng = np.random.default_rng(seed)
    donor = rng.integers(0, 256, 24 if shared % BLK else 21)
    req = np.concatenate([donor[:shared], rng.integers(0, 256, 29 - shared)])
    return donor, req


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = getattr(torch, request.param)
    cfg = LlamaConfig.tiny(dtype=dtype)
    return cfg, init_params(cfg, torch.Generator().manual_seed(3), device="cpu")


@pytest.mark.parametrize("chunk", [0, 16], ids=["whole", "chunked"])
def test_hit_and_miss_make_the_same_calls_and_bits(model, chunk):
    cfg, params = model
    sv = ServeConfig(**SERVE, chunk_tokens=chunk)
    donor, req = _prompts(16)
    hit = serve_recorded(params, cfg, sv, [donor], req, 6, "cpu")
    miss = serve_recorded(params, cfg, sv, [], req, 6, "cpu")
    assert (hit["matched"], miss["matched"]) == (16, 0)
    # every piece block-aligned, one block of rows, a contiguous context of
    # its end's whole blocks
    assert miss["calls"] == [(s, min(BLK, 29 - s), -(-min(s + BLK, 29) // BLK) * BLK, True)
                             for s in range(0, 29, BLK)]
    assert hit["calls"] == [c for c in miss["calls"] if c[0] >= 16]
    assert same_bits(hit["logits"], miss["logits"])
    assert same_bits(hit["k"], miss["k"]) and same_bits(hit["v"], miss["v"])
    assert hit["tokens"] == miss["tokens"]


def test_a_mid_block_match_is_cut_to_its_full_blocks(model):
    cfg, params = model
    donor, req = _prompts(19)
    hit = serve_recorded(params, cfg, ServeConfig(**SERVE), [donor], req, 4, "cpu")
    miss = serve_recorded(params, cfg, ServeConfig(**SERVE), [], req, 4, "cpu")
    assert hit["matched"] == 16 and hit["cow_copies"] == 0
    assert hit["calls"] == [c for c in miss["calls"] if c[0] >= 16]
    assert same_bits(hit["logits"], miss["logits"]) and hit["tokens"] == miss["tokens"]


def test_greedy_tokens_after_a_donor_equal_the_jax_engines():
    """float32, the reference's weights: the request's greedy tokens after
    the donor and alone equal the JAX engine's after the same donor (which
    keeps its mid-block match and prefills the tail at one length)."""
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    cfg = LlamaConfig.tiny()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    donor, req = _prompts(19, seed=1)
    jeng = JEngine(jparams, jcfg, JServeConfig(decode_impl="pallas", **SERVE))
    jeng.run([JRequest(prompt=donor.astype(np.int32), max_new_tokens=2)])
    want = next(iter(jeng.run([JRequest(prompt=req.astype(np.int32),
                                        max_new_tokens=8)]).values())).tokens
    assert jeng._cow_copies == 1
    for donors in ([donor], []):
        got = serve_recorded(params, cfg, ServeConfig(**SERVE), donors, req, 8, "cpu")
        assert got["tokens"] == want, donors
