"""Speculative decoding in the port (tony_tpu_torch.serve.spec and the
engine's verify step) against the JAX package's, on the same numpy inputs
and the tiny float32 config with the reference's weights:

- the draft sources return the reference's token lists exactly;
- the rejection rule's greedy outputs equal the reference's exactly, and
  its sampled outputs equal the port's own unrolled one-token chain, draw
  for draw (jax.random draws cannot be reproduced in torch);
- the engine's greedy tokens with spec on equal the JAX engine's with spec
  on and the port's with spec off, over two rounds of the same prompts
  (the prefix store warm in the second), for float32, int8 and fp8 pools;
  its draft counts equal the JAX engine's; its sampled tokens equal spec
  off, draw for draw.

Token equality is exact. Where the two engines' logits can differ by float
summation order (and, on quantized pools, by a value one quantization step
apart), every greedy top-2 margin of the port's run is asserted above 1e-4
first, so a flip would be diagnosed as a near-tie rather than tolerated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.serve import (
    Engine as JEngine, Request as JRequest, ServeConfig as JServeConfig,
)
from tony_tpu.serve.engine import _SlotState as JSlotState
from tony_tpu.serve.prefix import PrefixStore as JPrefixStore
from tony_tpu.serve.spec import (
    ngram_propose as jax_ngram, propose_drafts as jax_propose,
    verify_and_accept as jax_verify,
)
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.generate import sample_tokens
from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.ops.decode_attention import (
    LAUNCHES, check_kernel_shape, reset_launches,
)
from tony_tpu_torch.serve import Engine, PrefixStore, Request, ServeConfig
from tony_tpu_torch.serve import engine as pengine
from tony_tpu_torch.serve.spec import (
    SpecRows, advance_generators, ngram_propose, propose_drafts, verify_and_accept,
)

# --- draft sources --------------------------------------------------------------


def _stores(block, seqs):
    """The port's and the reference's prefix stores with the same paths."""
    port, ref = PrefixStore(block=block, block_bytes=1), JPrefixStore(block=block,
                                                                      block_bytes=1)
    for i, seq in enumerate(seqs):
        phys = list(range(1 + 100 * i, 1 + 100 * i + len(seq) // block))
        port.insert(seq, phys, retain=lambda pid: None)
        ref.insert(seq, phys, retain=lambda pid: None)
    return port, ref


def test_ngram_propose_equals_reference_on_random_contexts():
    """Small vocabularies, so trailing n-grams recur at every length."""
    rng = np.random.default_rng(0)
    n_drafted = 0
    for trial in range(300):
        ctx = rng.integers(0, 2 + trial % 6, rng.integers(0, 30)).tolist()
        for k in (0, 1, 3, 8):
            got = ngram_propose(ctx, k)
            assert got == jax_ngram(ctx, k), (ctx, k)
            n_drafted += bool(got)
    assert n_drafted > 500


@pytest.mark.parametrize("source", ["auto", "prefix", "ngram"])
def test_propose_drafts_equals_reference_with_stored_paths(source):
    """Contexts on stored paths (ending on a block boundary, mid-block, at
    a branch, past the path) and off them, with self-repeats so the n-gram
    fallback fires; every source, with and without a store."""
    rng = np.random.default_rng(1)
    base = rng.integers(0, 50, 24).tolist()
    seqs = [base, base[:8] + rng.integers(0, 50, 16).tolist(),
            rng.integers(0, 50, 12).tolist()]
    port, ref = _stores(4, seqs)
    # hits steer longest_extension at the branch after base[:8]
    port.match(seqs[1], 16)
    ref.match(seqs[1], 16)
    ctxs = [base[:n] for n in (1, 4, 6, 8, 9, 16, 23, 24)]
    ctxs += [base + base[:3], seqs[1][:10], seqs[2][:5], [7, 8, 7, 8, 7],
             rng.integers(0, 5, 20).tolist(), []]
    drafted = 0
    for ctx in ctxs:
        for k in (1, 4, 15):
            got = propose_drafts(ctx, port, k, source)
            assert got == jax_propose(ctx, ref, k, source), (ctx, k)
            assert propose_drafts(ctx, None, k, source) == jax_propose(ctx, None, k, source)
            drafted += bool(got)
    assert drafted
    # pinning: prefix never falls back to n-gram, n-gram never reads the store
    if source == "prefix":
        assert propose_drafts([7, 8, 7, 8, 7], port, 2, source) == []
    if source == "ngram":
        assert propose_drafts(base[:6], port, 4, source) == ngram_propose(base[:6], 4)


# --- the rejection rule ---------------------------------------------------------

S, G, V = 6, 5, 32


def _rows(temp=0.0, eos=None, done=None, gens=None):
    eos = np.full(S, -1) if eos is None else np.asarray(eos)
    done = np.zeros(S, bool) if done is None else np.asarray(done)
    return SpecRows(torch.full((S,), temp), torch.zeros(S, dtype=torch.int64),
                    torch.zeros(S), torch.as_tensor(eos, dtype=torch.int64),
                    torch.as_tensor(done), gens or [None] * S)


def test_verify_and_accept_greedy_equals_reference():
    """Row 0 drafts agree everywhere, row 1 nowhere, row 2 disagrees at
    its third draft, row 3 has a 2-token draft, row 4 emits an EOS inside
    an agreeing draft, row 5 is already done (sticks at its EOS)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((S, G, V)) * 3).astype(np.float32)
    greedy = logits.argmax(-1)
    drafts = np.full((S, G - 1), V + 5, np.int64)
    drafts[0] = drafts[3] = drafts[4] = greedy[0, :G - 1]
    drafts[3], drafts[4] = greedy[3, :G - 1], greedy[4, :G - 1]
    drafts[2] = greedy[2, :G - 1]
    drafts[2, 2] = (greedy[2, 2] + 1) % V
    draft_len = np.array([G - 1, G - 1, G - 1, 2, G - 1, 0])
    eos = np.full(S, -1)
    eos[4], eos[5] = greedy[4, 1], 9
    done = np.zeros(S, bool)
    done[5] = True

    got = verify_and_accept(torch.from_numpy(logits), torch.from_numpy(drafts),
                            torch.from_numpy(draft_len), _rows(0.0, eos, done),
                            max_top_k=64)
    state = JSlotState(
        last_tok=jnp.zeros(S, jnp.int32), rng=jnp.ones((S, 2), jnp.uint32),
        temp=jnp.zeros(S), top_k=jnp.zeros(S, jnp.int32), top_p=jnp.zeros(S),
        eos=jnp.asarray(eos, jnp.int32), done=jnp.asarray(done),
        live=jnp.ones(S, bool))
    want = jax_verify(jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
                      jnp.asarray(draft_len, jnp.int32), state, max_top_k=64)
    for i in (0, 1, 2, 3, 5):             # toks, n_emit, n_acc, last_tok, done
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=i)
    assert got[1].tolist() == [G, 1, 3, 3, 2, 1]
    assert got[5].tolist() == [False] * 4 + [True, True]
    assert got[3][4] == eos[4] and got[3][5] == 9


def _one_token_chain(logits, drafts, draft_len, temp, seed, eos=-1):
    """Per-row autoregressive reference in the port: one sample_tokens call
    per position from a generator seeded ``seed``, stopping at the first
    draft disagreement or emitted EOS. Returns the emitted tokens and the
    generator after them."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for g in range(logits.shape[0]):
        t = int(sample_tokens(logits[g][None], torch.tensor([temp]),
                              torch.zeros(1, dtype=torch.int64), torch.zeros(1),
                              [gen], max_k=64)[0])
        out.append(t)
        if t == eos:
            break
        if drafts is None or not (g < G - 1 and g < draft_len and t == drafts[g]):
            if drafts is not None:
                break
    return out, gen


@pytest.mark.parametrize("temp", [0.7, 1.5])
def test_verify_and_accept_sampled_equals_one_token_chain(temp):
    """Sampled rows: each emitted token, and each generator's state after
    ``advance_generators``, equal G one-token steps' draw for draw."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((rng.standard_normal((S, G, V)) * 2).astype(np.float32))
    free = [_one_token_chain(logits[s], None, 0, temp, 10 + s)[0] for s in range(S)]
    drafts = torch.full((S, G - 1), V + 5, dtype=torch.int64)
    drafts[0] = torch.tensor(free[0][:G - 1])        # agrees everywhere
    drafts[2] = torch.tensor(free[2][:G - 1])
    drafts[2, 1] = (free[2][1] + 1) % V              # disagrees at position 1
    drafts[3] = torch.tensor(free[3][:G - 1])        # agrees, but 2 are real
    drafts[4] = torch.tensor(free[4][:G - 1])        # an EOS at position 2
    drafts[5] = torch.from_numpy(rng.integers(0, V, G - 1))
    draft_len = torch.tensor([G - 1, G - 1, G - 1, 2, G - 1, G - 1])
    eos = [-1, -1, -1, -1, free[4][2], -1]
    gens = [torch.Generator().manual_seed(10 + s) for s in range(S)]
    gens[1] = None                                    # a greedy row among them
    temps = torch.full((S,), temp)
    temps[1] = 0.0
    rows = _rows(temp, eos, None, gens)._replace(temp=temps)
    toks, n_emit, n_acc, last_tok, saved, done = verify_and_accept(
        logits, drafts, draft_len, rows, max_top_k=64)
    advance_generators(gens, saved, n_emit.tolist())
    for s in range(S):
        if s == 1:
            continue
        want, gen = _one_token_chain(logits[s], drafts[s].tolist(), int(draft_len[s]),
                                     temp, 10 + s, eos[s])
        n = int(n_emit[s])
        assert toks[s, :n].tolist() == want, s
        assert int(last_tok[s]) == want[-1] and int(n_acc[s]) == n - 1, s
        assert torch.equal(gens[s].get_state(), gen.get_state()), s
    assert int(n_emit[0]) == G and int(n_emit[2]) == 2 and int(n_emit[3]) == 3
    assert int(n_emit[4]) == 3 and bool(done[4]) and not bool(done[0])


# --- the engine -----------------------------------------------------------------

# slots=2 forces churn; one prefill bucket and no shrinking keep the JAX
# engine's compiles (one per bucket and per pool and table width) few
SERVE = dict(slots=2, max_len=64, kv_block=8, prefill_buckets=(16,), shrink=False)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    cfg = LlamaConfig.tiny()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _traffic(seed=0):
    """Four prompts and budgets long enough that the second round drafts
    along the first round's generated blocks."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, n) for n in (3, 9, 14, 5)]
    return prompts, [14, 12, 16, 10]


def _run_port(params, cfg, prompts, budgets, monkeypatch=None, **sv):
    """Two rounds of the same requests through one port engine; with
    ``monkeypatch``, also the top-2 logit margin of every token a live row
    sampled (meant for the spec-off run: prefill samples one row, a decode
    step every slot)."""
    eng = Engine(params, cfg, ServeConfig(**SERVE, **sv), device="cpu")
    margins = []
    if monkeypatch is not None:
        real = pengine.sample_tokens

        def recording(logits, *a, **kw):
            top = logits.topk(2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]).tolist()
            live = [r is not None for r in eng._slot_rid] if len(gap) > 1 else [True]
            margins.extend(g for g, on in zip(gap, live) if on)
            return real(logits, *a, **kw)

        monkeypatch.setattr(pengine, "sample_tokens", recording)
    rounds = []
    for _ in range(2):
        ids = [eng.submit(Request(prompt=p, max_new_tokens=m))
               for p, m in zip(prompts, budgets)]
        out = eng.run()
        rounds.append([out[i].tokens for i in ids])
    if monkeypatch is not None:
        monkeypatch.setattr(pengine, "sample_tokens", real)
        assert len(margins) == sum(len(t) for r in rounds for t in r)
    return eng, rounds, margins


def _run_jax(jparams, jcfg, prompts, budgets, **sv):
    eng = JEngine(jparams, jcfg, JServeConfig(**SERVE, **sv))
    rounds = []
    for _ in range(2):
        ids = [eng.submit(JRequest(prompt=p, max_new_tokens=m))
               for p, m in zip(prompts, budgets)]
        out = eng.run()
        rounds.append([[int(t) for t in out[i].tokens] for i in ids])
    return eng, rounds


@pytest.mark.parametrize("kv", ["", "int8", "fp8_e4m3"])
def test_spec_engine_greedy_equals_jax_and_spec_off(setup, kv, monkeypatch):
    """Greedy tokens with spec on equal the JAX engine's with spec on, in
    both rounds, and its draft counts; the second round drafts along the
    first round's generated blocks, and the paged plain version runs once
    per layer and step. The margins are the port's spec-off run's.

    Spec on equals spec off for float32 and int8 pools. Not for fp8 pools,
    in the reference as in the port: a verify step's rejected positions
    fold their amaxes into the block scales (reference engine.py :2019),
    so later K/V are stored at a coarser scale than without spec, and
    e4m3's 3-bit mantissa then moves a logit by more than this traffic's
    smallest margin; the JAX engine's fp8 spec-off tokens even differ
    between the two rounds of the same prompts (request 2, token 13)."""
    jcfg, jparams, cfg, params = setup
    prompts, budgets = _traffic()
    sv = dict(quant_kv=kv, quant_weights=bool(kv))
    _, off, margins = _run_port(params, cfg, prompts, budgets, monkeypatch, **sv)
    reset_launches()
    eng, on, _ = _run_port(params, cfg, prompts, budgets, spec=True,
                           spec_max_draft=4, **sv)
    plain = "paged_decode_attention" + ("_quant" if kv else "") + "_plain"
    assert LAUNCHES[plain] == eng.metrics.decode_steps * cfg.n_layers > 0
    jeng, jon = _run_jax(jparams, jcfg, prompts, budgets, spec=True,
                         spec_max_draft=4, **sv)
    assert min(margins) > 1e-4, min(margins)
    assert on == jon
    if kv != "fp8_e4m3":
        assert on == off
        assert on[0] == on[1]
    m, jm = eng.metrics, jeng.metrics
    assert (m.draft_proposed, m.draft_accepted) == (jm.draft_proposed, jm.draft_accepted)
    assert m.draft_accepted > 0 and m.tokens_per_step > 1.0
    assert m.decode_steps == jm.decode_steps


def test_spec_engine_sampled_equals_spec_off(setup):
    """Sampled requests (two rounds, every draft source) emit the same
    tokens with spec on as with spec off: the verify step leaves each
    request's generator exactly where the one-token steps would."""
    _, _, cfg, params = setup
    prompts, _ = _traffic(seed=1)
    kwargs = [dict(temperature=0.8, top_k=7), dict(temperature=1.2, top_p=0.9),
              dict(temperature=0.6, top_k=5, top_p=0.7), dict()]

    def run(**sv):
        eng = Engine(params, cfg, ServeConfig(**SERVE, **sv), device="cpu")
        out = []
        for _ in range(2):
            ids = [eng.submit(Request(prompt=p, max_new_tokens=10, rng=40 + i, **kw))
                   for i, (p, kw) in enumerate(zip(prompts, kwargs))]
            res = eng.run()
            out.append([res[i].tokens for i in ids])
        return out, eng.metrics

    off, _ = run()
    for source in ("auto", "prefix", "ngram"):
        on, m = run(spec=True, spec_max_draft=3, spec_draft_source=source)
        assert on == off, source
        assert m.draft_proposed > 0, source


def test_spec_engine_eos_inside_an_accepted_draft(setup):
    """An EOS inside an accepted multi-token span finishes the request at
    exactly the spec-off position."""
    _, _, cfg, params = setup
    p = np.random.default_rng(3).integers(0, 256, 8)
    solo = Engine(params, cfg, ServeConfig(**SERVE), device="cpu").run(
        [Request(prompt=p, max_new_tokens=12)])[0].tokens
    eos = solo[6]
    want = solo[:solo.index(eos) + 1]
    eng = Engine(params, cfg, ServeConfig(**SERVE, spec=True, spec_max_draft=4),
                 device="cpu")
    eng.run([Request(prompt=p, max_new_tokens=12)])         # the store learns the path
    res = eng.run([Request(prompt=p, max_new_tokens=12, eos_id=int(eos))])
    assert res[1].finish_reason == "eos" and res[1].tokens == want
    assert eng.metrics.draft_accepted > 0


@pytest.mark.parametrize("bad, match", [
    (dict(spec=True, spec_max_draft=0), "spec_max_draft"),
    (dict(spec=True, spec_draft_source="oracle"), "oracle"),
    (dict(spec_draft_source="trie"), "trie"),
])
def test_spec_knobs_are_validated_like_reference(setup, bad, match):
    jcfg, jparams, cfg, params = setup
    with pytest.raises(ValueError, match=match):
        Engine(params, cfg, ServeConfig(**SERVE, **bad), device="cpu")
    with pytest.raises(ValueError, match=match):
        JEngine(jparams, jcfg, JServeConfig(**SERVE, **bad))


def test_verify_width_meets_the_kernel_shape_rule_at_llama3_8b():
    """The engine checks the decode kernel's shape rule on the card at G =
    spec_max_draft + 1 at construction: at Llama-3-8B's heads (rep 4, hd
    128, bf16, kv_block 64) G 16 (the bench's draft 15) needs 115,456 B of
    shared memory and fits; G 40 does not, and raises before a request."""
    assert check_kernel_shape(16, 32, 8, 128, 64, 2, 2) == (64, 115456)
    with pytest.raises(ValueError, match="G=40 x rep=4"):
        check_kernel_shape(40, 32, 8, 128, 64, 2, 2)

