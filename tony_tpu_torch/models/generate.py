"""KV-cache forward, sampling and generation for the Llama family.

The counterpart of ``tony_tpu/models/generate.py``:

- :func:`forward_with_cache` is the prefill forward: it writes each
  layer's K/V into a contiguous ``[L, B, T, Hkv, hd]`` cache (in place) and
  attends by absolute position with plain tensor code (a matmul and a
  masked float32 softmax), as the reference does outside any kernel;
- :func:`sample_tokens` is the engine's per-row sampler: greedy rows take
  the argmax, others a temperature-scaled draw, optionally truncated to the
  top-k of a bounded slice and a nucleus over that sorted slice. Each row
  draws from its own ``torch.Generator``, so a request samples the same
  alone or in a busy engine;
- :func:`generate` is B requests into the serving engine
  (``serve/engine.py``), so the one-off API and the server share one decode
  step and their parity is a test.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.llama import (
    LlamaConfig, Params, apply_rope, rms_norm, rope_freqs,
)

# bounded top-k slice used for nucleus truncation when no top_k was given
DEFAULT_NUCLEUS_K = 64


class KVCache(NamedTuple):
    """Per-layer stacked K/V buffers ``[L, B, max_len, n_kv_heads, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, max_len: int = 0,
               device: str | torch.device | None = None) -> "KVCache":
        """Zeroed buffers on ``device`` (``None`` means CUDA, and raises
        without it)."""
        device = resolve_device(device)
        shape =(cfg.n_layers, batch, max_len or cfg.max_seq_len,
                 cfg.n_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


def _cached_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      q_pos: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """q ``[B, S, H, hd]``; caches ``[B, T, Hkv, hd]``; q_pos ``[S]`` absolute.
    Causal over absolute positions; scores and softmax in float32, the
    probabilities cast to q's dtype before P.V."""
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep > 1:
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    k_pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v_cache)


def forward_with_cache(params: Params, tokens: torch.Tensor, cache: KVCache,
                       start_pos: int, cfg: LlamaConfig, last_only: bool = False,
                       last_index: int | None = None
                       ) -> tuple[torch.Tensor, KVCache]:
    """tokens ``[B, S]`` starting at absolute position ``start_pos``.

    Returns (logits ``[B, S, vocab]`` float32, the cache). Each layer's new
    K/V is written into ``cache`` in place at ``[start_pos, start_pos+S)``
    before attending over the whole cache (positions later than a query are
    masked). ``last_only`` projects only the final position through
    ``lm_head`` (logits ``[B, 1, vocab]``); ``last_index`` picks another
    position."""
    B, S = tokens.shape
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dev = tokens.device
    x = params["tok_emb"][tokens]
    q_pos = start_pos + torch.arange(S, device=dev)
    angles = q_pos.float()[:, None] * rope_freqs(cfg, dev)[None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    layers = params["layers"]
    for l in range(cfg.n_layers):
        h = rms_norm(x, layers["attn_norm"][l], cfg.norm_eps)
        q = apply_rope((h @ layers["wq"][l]).view(B, S, H, hd), cos, sin)
        k = apply_rope((h @ layers["wk"][l]).view(B, S, Hkv, hd), cos, sin)
        v = (h @ layers["wv"][l]).view(B, S, Hkv, hd)
        cache.k[l, :, start_pos:start_pos + S] = k
        cache.v[l, :, start_pos:start_pos + S] = v
        attn = _cached_attention(q, cache.k[l], cache.v[l], q_pos, cfg)
        x = x + attn.reshape(B, S, H * hd) @ layers["wo"][l]
        h2 = rms_norm(x, layers["ffn_norm"][l], cfg.norm_eps)
        x = x + (F.silu(h2 @ layers["w1"][l]) * (h2 @ layers["w3"][l])) @ layers["w2"][l]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_index is not None:
        x = x[:, last_index:last_index + 1]
    elif last_only:
        x = x[:, -1:]
    return (x @ params["lm_head"]).float(), cache


def generate(params: Params, prompt, cfg: LlamaConfig, *, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             eos_id: int | None = None, rng: int | None = None, max_len: int = 0,
             max_top_k: int = 0, serve: dict | None = None,
             device: str | torch.device | None = None) -> torch.Tensor:
    """Autoregressive generation: prompt ``[B, P]`` -> ``[B, P +
    max_new_tokens]`` int64 on the CPU.

    temperature 0 is greedy; otherwise a softmax draw, optionally top-k
    and/or nucleus truncated. With ``eos_id`` a row that hits it pads with
    it. Implemented as B requests into the serving engine (one slot per
    row). Row i draws from a generator seeded with ``rng + i`` (``rng``
    defaults to 0), so the same request submitted to an engine with
    ``Request(rng=rng + i)`` samples identically. ``serve`` overrides
    ServeConfig fields of the engine. ``device=None`` means CUDA.
    """
    from tony_tpu_torch.serve.engine import Engine, Request, ServeConfig

    prompt_np = np.asarray(prompt.cpu() if isinstance(prompt, torch.Tensor)
                           else prompt, dtype=np.int64)
    B, P = prompt_np.shape
    if max_new_tokens <= 0:
        return torch.from_numpy(prompt_np)
    total = P + max_new_tokens
    seed = 0 if rng is None else int(rng)
    sv = dict(
        slots=B, max_len=max_len or max(total, 1), prefill_buckets=(P,),
        max_top_k=max(top_k, max_top_k, DEFAULT_NUCLEUS_K),
    )
    sv.update(serve or {})
    engine = Engine(params, cfg, ServeConfig(**sv), device=device)
    ids = [
        engine.submit(Request(
            prompt=prompt_np[i], max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
            rng=seed + i,
        ))
        for i in range(B)
    ]
    completions = engine.run()
    rows = []
    for i, rid in enumerate(ids):
        toks = list(completions[rid].tokens)
        if len(toks) < max_new_tokens:  # finished at EOS: stick at it
            toks += [eos_id] * (max_new_tokens - len(toks))
        rows.append(np.concatenate([prompt_np[i], np.asarray(toks, np.int64)]))
    return torch.from_numpy(np.stack(rows))


def draw_uniform(gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """The one uniform a sampling row draws from its generator per sampled
    token (the speculative step replays draws through this too)."""
    return torch.rand((), generator=gen, device=device)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  generators: Sequence[torch.Generator | None], *,
                  max_k: int = DEFAULT_NUCLEUS_K) -> torch.Tensor:
    """Per-row sampling: logits ``[N, V]``, per-row temperature/top_k/top_p
    ``[N]``, one generator per row (None for a row that does not sample)
    -> tokens ``[N]`` int64.

    Rows with temperature <= 0 are greedy and draw nothing. top_k clamps to
    the ``max_k`` slice (0 = no top-k: the slice bound still applies when
    the row sets top_p). A sampling row draws one uniform from its own
    generator and inverts the cumulative distribution of its truncated
    softmax."""
    N, V = logits.shape
    dev = logits.device
    greedy = logits.argmax(dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    k = min(max_k, V)
    vals, idx = torch.topk(scaled, k, dim=-1)              # [N, k] descending
    eff_k = torch.where(top_k > 0, torch.clamp(top_k, max=k),
                        torch.full_like(top_k, k))
    keep = torch.arange(k, device=dev)[None, :] < eff_k[:, None]
    vals = torch.where(keep, vals, float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    cum = probs.cumsum(dim=-1)
    keep_p = torch.where(top_p[:, None] > 0.0, (cum - probs) < top_p[:, None],
                         torch.ones_like(keep))
    vals = torch.where(keep & keep_p, vals, float("-inf"))
    truncate = (top_k > 0) | (top_p > 0.0)
    masked = torch.full_like(scaled, float("-inf")).scatter(1, idx, vals)
    masked = torch.where(truncate[:, None], masked, scaled)
    zero = torch.zeros((), device=dev)
    u = torch.stack([draw_uniform(g, dev) if g is not None else zero
                     for g in generators])
    dist = torch.softmax(masked.float(), dim=-1).cumsum(dim=-1)
    sampled = torch.searchsorted(dist, (u * dist[:, -1])[:, None], right=True)[:, 0]
    sampled = torch.clamp(sampled, max=V - 1)
    return torch.where(temperature <= 0.0, greedy, sampled)


__all__ = [
    "DEFAULT_NUCLEUS_K", "KVCache", "draw_uniform", "forward_with_cache",
    "generate", "sample_tokens",
]
