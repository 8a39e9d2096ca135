"""Serve one prompt on an engine, after donors or alone, and record what its
prefill did (the prefill-invariance tests of
``tests/test_torch_prefill_invariance.py`` and, on the card,
``tests/test_torch_kernels_cuda.py``). Imports neither jax nor tony_tpu.

:func:`serve_recorded` returns, for the prompt's admission alone: each
``forward_with_cache`` call as (start, rows, context length, contiguous),
the last call's logits (the first token's row), the prefix-hit tokens, the
K/V of the slot's blocks as they stand when the slot activates, and the
greedy tokens."""

from __future__ import annotations

from unittest import mock

import numpy as np
import torch

from tony_tpu_torch.serve import Engine, Request, ServeConfig
from tony_tpu_torch.serve import engine as engine_mod
from tony_tpu_torch.serve.cache import blocks_for


def serve_recorded(params, cfg, serve: ServeConfig, donors, prompt, new_tokens: int,
                   device) -> dict:
    eng = Engine(params, cfg, serve, device=device)
    for d in donors:
        eng.run([Request(prompt=np.asarray(d), max_new_tokens=2)])
    hit0 = eng.metrics.prefix_hit_tokens
    seen: dict = {"calls": []}
    real = engine_mod.forward_with_cache

    def spy(params, tokens, cache, start, cfg, **kw):
        logits, kv = real(params, tokens, cache, start, cfg, **kw)
        seen["calls"].append((int(start), int(tokens.shape[1]), int(cache.k.shape[2]),
                              cache.k.is_contiguous() and cache.v.is_contiguous()))
        seen["logits"] = logits.detach().clone()
        return logits, kv

    activate = eng._activate_slot

    def on_activate(slot, rid, req, p, tok, gen, t0):
        nb = blocks_for(len(p), serve.kv_block)
        ids = torch.as_tensor(eng._table[slot, :nb], dtype=torch.int64,
                              device=eng.cache.k.device)
        seen["k"] = eng.cache.k.index_select(1, ids).clone()
        seen["v"] = eng.cache.v.index_select(1, ids).clone()
        activate(slot, rid, req, p, tok, gen, t0)

    eng._activate_slot = on_activate
    with mock.patch.object(engine_mod, "forward_with_cache", spy):
        out = eng.run([Request(prompt=np.asarray(prompt), max_new_tokens=new_tokens)])
    return {**seen, "matched": eng.metrics.prefix_hit_tokens - hit0,
            "cow_copies": eng._cow_copies, "tokens": next(iter(out.values())).tokens}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (NaN-safe, -0.0 told from 0.0)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


__all__ = ["same_bits", "serve_recorded"]
