"""Speculative decoding: model-free drafts, one-step batched verification.

The counterpart of ``tony_tpu/serve/spec.py``. A decode step is
memory-bound, so scoring G positions of a row in one widened step costs
little more than scoring one. A draft proposes the next k tokens of each
slot on the host; the engine's verify step (``serve/engine.py``) feeds the
slot's last token and its drafts, G = k + 1 positions, through the model
in one forward, and the rejection rule below keeps exactly the prefix the
model itself would have produced, plus one token of its own.

The drafts come from no model, only from host-side lookups:

- **radix-store longest extension** (``serve/prefix.py``): if a slot's
  context (prompt + emitted tokens) follows a path the store has seen, the
  path's continuation is the draft; repeated or templated traffic drafts
  at near-full accept;
- **n-gram prompt lookup**: the longest trailing n-gram of the slot's own
  context that occurred earlier in it predicts the tokens that followed
  that occurrence.

Verification is exact. For a deterministic draft the accept/resample rule
reduces to: sample the target at every scored position, each with the
draw the one-token step would have made there, and emit the longest prefix
where the target's sample agrees with the draft, plus the first
disagreeing sample. In the port a sampling row draws one uniform per
sampled token from its request's ``torch.Generator``
(``models/generate.py``), so the verify step draws G times in position
order and, once the emitted count is on the host, leaves the generator
exactly that many draws past where it started (:func:`advance_generators`).
Every emitted token is the one the one-token engine samples: output is
draw-for-draw identical with speculation on and off, greedy and sampled.

Rollback costs nothing: position ``pos + j``'s K/V is written from fed
token j, and the cache length advances only by the emitted count, so the
rejected positions lie past the length, masked out of attention, until
later steps overwrite them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tony_tpu_torch.models.generate import draw_uniform, sample_tokens

DRAFT_SOURCES = ("auto", "prefix", "ngram")

# n-gram prompt-lookup window: the longest trailing n-gram is tried first
_NGRAM_MAX = 3
_NGRAM_MIN = 1


def ngram_propose(ctx: Sequence[int], max_k: int,
                  max_n: int = _NGRAM_MAX, min_n: int = _NGRAM_MIN) -> list[int]:
    """Prompt-lookup draft: find the most recent earlier occurrence of the
    context's trailing n-gram (longest n first) and propose the tokens
    that followed it."""
    L = len(ctx)
    if max_k <= 0 or L < min_n + 1:
        return []
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        suffix = list(ctx[L - n:])
        for start in range(L - n - 1, -1, -1):
            if list(ctx[start:start + n]) == suffix:
                lo = start + n
                return [int(t) for t in ctx[lo:min(lo + max_k, L)]]
    return []


def propose_drafts(ctx: Sequence[int], store, max_k: int,
                   source: str = "auto") -> list[int]:
    """Up to ``max_k`` draft tokens for a slot whose context is ``ctx``
    (prompt + every emitted token, the next input token last): the prefix
    store's ``longest_extension`` first, then the context's own n-gram
    lookup; ``source`` pins one of them."""
    if max_k <= 0:
        return []
    out: list[int] = []
    if source in ("auto", "prefix") and store is not None:
        out = store.longest_extension(ctx, max_k)
    if not out and source in ("auto", "ngram"):
        out = ngram_propose(ctx, max_k)
    return out[:max_k]


class SpecRows(NamedTuple):
    """What the rejection rule reads of each of the step's S rows."""

    temp: torch.Tensor       # [S] float32, <= 0 is greedy
    top_k: torch.Tensor      # [S] int64
    top_p: torch.Tensor      # [S] float32
    eos: torch.Tensor        # [S] int64, -1 = none
    done: torch.Tensor       # [S] bool, the row already emitted its EOS
    generators: Sequence[torch.Generator | None]  # None: the row draws nothing


def verify_and_accept(logits: torch.Tensor, drafts: torch.Tensor,
                      draft_len: torch.Tensor, rows: SpecRows, *, max_top_k: int):
    """The rejection rule on the device, with no host sync.

    ``logits [S, G, V]`` are the target's distributions at the G fed
    positions, ``drafts [S, G - 1]`` the proposed tokens (``draft_len
    [S]`` of them real per row). Samples the target at every position,
    each sampling row drawing G times from its generator in position
    order, then accepts the longest draft-agreeing prefix plus one
    correction or bonus token. EOS rules are the one-token step's: an
    emitted EOS ends the emission (inclusive) and marks the row done; a row
    already done sticks at EOS.

    Returns ``(toks [S, G], n_emit [S], n_acc [S], last_tok [S], rng_saved,
    done [S])``: the first ``n_emit`` of each row's ``toks`` are emitted,
    ``last_tok`` feeds the next step. The reference returns each row's key
    after exactly ``n_emit`` splits; the port returns ``rng_saved``, each
    generator's state before this step's draws (None for a row without
    one), which :func:`advance_generators` turns into that position once
    ``n_emit`` is on the host."""
    S, G, V = logits.shape
    dev = logits.device
    rng_saved = [g.get_state() if g is not None else None for g in rows.generators]
    # row-major flattening: row s's generator draws for positions 0..G-1
    # in turn, as G one-token steps would
    T = sample_tokens(
        logits.reshape(S * G, V), rows.temp.repeat_interleave(G),
        rows.top_k.repeat_interleave(G), rows.top_p.repeat_interleave(G),
        [g for g in rows.generators for _ in range(G)], max_k=max_top_k,
    ).view(S, G)
    has_eos = rows.eos >= 0
    T = torch.where((rows.done & has_eos)[:, None], rows.eos[:, None], T)
    if G > 1:
        gi = torch.arange(G - 1, device=dev)[None, :]
        agree = (T[:, :G - 1] == drafts) & (gi < draft_len[:, None])
        n_acc = agree.long().cumprod(dim=1).sum(dim=1)
    else:
        n_acc = torch.zeros(S, dtype=torch.int64, device=dev)
    n_emit = n_acc + 1                                  # accepted drafts + bonus
    # EOS truncation: emission stops AT the first emitted EOS, inclusive
    is_eos = has_eos[:, None] & (T == rows.eos[:, None])
    emitted = torch.arange(G, device=dev)[None, :] < n_emit[:, None]
    eos_hit = is_eos & emitted
    any_eos = eos_hit.any(dim=1)
    first_eos = eos_hit.long().argmax(dim=1)            # the first True
    n_emit = torch.where(any_eos, first_eos + 1, n_emit)
    n_acc = torch.minimum(n_acc, n_emit - 1)
    done = rows.done | any_eos
    last_tok = T.gather(1, (n_emit - 1)[:, None])[:, 0]
    return T, n_emit, n_acc, last_tok, rng_saved, done


def advance_generators(generators: Sequence[torch.Generator | None],
                       rng_saved: Sequence[torch.Tensor | None],
                       n_emit: Sequence[int]) -> None:
    """Leave each row's generator exactly ``n_emit[s]`` draws past its
    state before the verify step (``rng_saved``, from
    :func:`verify_and_accept`): the stream position of a request that
    emitted those tokens one step at a time. ``n_emit`` is on the host.
    The step drew G times from each; each is restored and replays
    ``n_emit[s]`` draws."""
    for g, state, n in zip(generators, rng_saved, n_emit):
        if g is None:
            continue
        g.set_state(state)
        for _ in range(int(n)):
            draw_uniform(g, g.device)


__all__ = [
    "DRAFT_SOURCES", "SpecRows", "advance_generators", "ngram_propose",
    "propose_drafts", "verify_and_accept",
]
