"""The port's serving engine (tony_tpu_torch.serve.engine) against the JAX
package's, on the tiny float32 config with the reference's weights:

- greedy tokens equal the JAX engine's (decode through its Pallas kernel in
  interpret mode) exactly, with slot churn, an EOS that frees a slot, and
  prefix reuse over a mid-block match (the reference copies the block on
  write, the port cuts the match to its full blocks);
- the port's engine equals the port's generate(), greedy and sampled, and a
  request samples the same alone and in a busy engine;
- chunked prefill serves as unchunked prefill does, the handoff refuses
  what it cannot adopt, the refusals that stand cite their ROADMAP items;
  the default device is CUDA."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.serve import (
    Engine as JEngine, Request as JRequest, ServeConfig as JServeConfig,
)
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.generate import generate
from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.ops.decode_attention import LAUNCHES, reset_launches
from tony_tpu_torch.serve import Engine, Request, ServeConfig

# slots=2 forces churn; the short bucket ladder keeps the reference from
# trimming the mid-block prefix match (its tail bucket must fit max_len)
SERVE = dict(slots=2, max_len=32, kv_block=8, prefill_buckets=(4, 8, 16, 32))


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    cfg = LlamaConfig.tiny()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _traffic(seed=0):
    """Prompts of lengths 3/7/25/12/22/5; the 22-token prompt shares its
    first 19 tokens with the 25-token one, which registers three full
    blocks: a match of two full blocks plus three tokens into the third,
    so the reference's admission copies that block (COW) and the port's
    cuts the match to the two full blocks."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 25)
    shared = np.concatenate([base[:19], rng.integers(0, 256, 3)])
    prompts = [rng.integers(0, 256, 3), rng.integers(0, 256, 7), base,
               rng.integers(0, 256, 12), shared, rng.integers(0, 256, 5)]
    return prompts, [5, 6, 6, 6, 8, 4]


def _run_port(params, cfg, prompts, budgets, eos=None, eos_row=1):
    eng = Engine(params, cfg, ServeConfig(**SERVE), device="cpu")
    ids = [eng.submit(Request(prompt=p, max_new_tokens=m,
                              eos_id=eos if i == eos_row else None))
           for i, (p, m) in enumerate(zip(prompts, budgets))]
    out = eng.run()
    return eng, [out[i] for i in ids]


def test_engine_greedy_tokens_equal_jax_engine(setup):
    jcfg, jparams, cfg, params = setup
    prompts, budgets = _traffic()
    # the EOS is request 1's second greedy token, so it finishes early and
    # frees its slot for the queue
    _, first = _run_port(params, cfg, prompts, budgets)
    eos = first[1].tokens[1]
    reset_launches()
    eng, ours = _run_port(params, cfg, prompts, budgets, eos=eos)
    assert LAUNCHES["paged_decode_attention"] == 0
    assert LAUNCHES["paged_decode_attention_plain"] == \
        eng.metrics.decode_steps * cfg.n_layers > 0

    jeng = JEngine(jparams, jcfg, JServeConfig(decode_impl="pallas", **SERVE))
    jids = [jeng.submit(JRequest(prompt=p, max_new_tokens=m,
                                 eos_id=eos if i == 1 else None))
            for i, (p, m) in enumerate(zip(prompts, budgets))]
    jout = jeng.run()
    for i, (c, jid) in enumerate(zip(ours, jids)):
        assert c.tokens == jout[jid].tokens, i
        assert c.finish_reason == jout[jid].finish_reason, i
    assert ours[1].finish_reason == "eos" and len(ours[1].tokens) == 2
    # over a float32 pool the port cuts the mid-block match to its full
    # blocks (its prefill runs block-aligned pieces); the reference keeps it
    assert (eng._cow_copies, jeng._cow_copies) == (0, 1)
    assert (eng.metrics.prefix_hit_tokens, jeng.metrics.prefix_hit_tokens) == (16, 19)


def test_engine_matches_generate_greedy(setup):
    _, _, cfg, params = setup
    prompts, budgets = _traffic(seed=1)
    _, ours = _run_port(params, cfg, prompts, budgets)
    for p, m, c in zip(prompts, budgets, ours):
        solo = generate(params, p[None], cfg, max_new_tokens=m, device="cpu")
        assert solo.shape == (1, len(p) + m)
        assert solo[0, len(p):].tolist() == c.tokens


def test_sampled_requests_match_generate_alone_and_busy(setup):
    """A request's draws come from its own generator: the same tokens from
    generate(), from a busy 2-slot engine with prefix sharing, and alone."""
    _, _, cfg, params = setup
    prompts, _ = _traffic(seed=2)
    kwargs = [dict(temperature=0.8, top_k=7), dict(temperature=1.2, top_p=0.9),
              dict(temperature=0.6, top_k=5, top_p=0.7), dict(temperature=1.0),
              dict(temperature=0.9, top_k=20), dict()]
    eng = Engine(params, cfg, ServeConfig(**SERVE), device="cpu")
    ids = [eng.submit(Request(prompt=p, max_new_tokens=5, rng=40 + i, **kw))
           for i, (p, kw) in enumerate(zip(prompts, kwargs))]
    busy = eng.run()
    for i, (p, kw) in enumerate(zip(prompts, kwargs)):
        solo = generate(params, p[None], cfg, max_new_tokens=5, rng=40 + i,
                        device="cpu", **kw)
        alone = Engine(params, cfg, ServeConfig(**SERVE), device="cpu").run(
            [Request(prompt=p, max_new_tokens=5, rng=40 + i, **kw)])
        assert busy[ids[i]].tokens == solo[0, len(p):].tolist() == alone[0].tokens, i
    # different seeds draw differently (the sampler is not silently greedy)
    again = Engine(params, cfg, ServeConfig(**SERVE), device="cpu").run(
        [Request(prompt=prompts[3], max_new_tokens=5, rng=s, temperature=1.0)
         for s in range(4)])
    assert len({tuple(c.tokens) for c in again.values()}) > 1


def test_freed_slots_return_blocks_and_table_shrinks(setup):
    _, _, cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=8),
                 device="cpu")
    rng = np.random.default_rng(4)
    first = eng.run([Request(prompt=rng.integers(0, 256, 20), max_new_tokens=8)])
    assert first[0].finish_reason == "length" and len(first[0].tokens) == 8
    second = eng.run([Request(prompt=rng.integers(0, 256, 3), max_new_tokens=2)])
    assert eng.attended_positions <= 16
    assert eng._pool.n_used <= eng._store.n_nodes
    assert list(second) == [1] and not eng._completions
    assert int(eng.cache.lengths.sum()) == 0


# chunked prefill serves alone and beside speculative decoding
# (tests/test_torch_serve_chunked.py holds it to the JAX engine)
@pytest.mark.parametrize("knob", [dict(chunk_tokens=8), dict(spec=True, chunk_tokens=8)])
def test_unported_knobs_raise(setup, knob):
    """The knobs this test once found refused now serve: the traffic's
    greedy tokens with ``chunk_tokens`` equal the unchunked engine's, the
    long prompts prefilled in chunks; only a chunk that is not a multiple
    of ``kv_block`` raises, with the reference's message."""
    _, _, cfg, params = setup
    prompts, budgets = _traffic(seed=5)
    _, plain = _run_port(params, cfg, prompts, budgets)
    eng = Engine(params, cfg, ServeConfig(**SERVE, **knob), device="cpu")
    ids = [eng.submit(Request(prompt=p, max_new_tokens=m)) for p, m in zip(prompts, budgets)]
    out = eng.run()
    assert [out[i].tokens for i in ids] == [c.tokens for c in plain]
    # the 25- and 12-token prompts chunk (4 + 2 chunks); the 22-token one's
    # 3-token tail past its 19-token match does not
    assert eng.prefill_chunks == 6
    with pytest.raises(ValueError, match="multiple of kv_block"):
        Engine(params, cfg, ServeConfig(**SERVE, **{**knob, "chunk_tokens": 12}), device="cpu")


def test_pool_handoff_raises(setup):
    """The handoff serves (tests/test_torch_serve_chunked.py); what it
    refuses raises ValueError, as the reference's does: a payload this
    pool cannot adopt, and a token count that is not the payload's."""
    _, _, cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(**SERVE), device="cpu")
    prompt = np.random.default_rng(3).integers(0, 256, 17)
    eng.run([Request(prompt=prompt, max_new_tokens=1)])
    covered, payload = eng.export_prefix_blocks(prompt.tolist())
    assert len(covered) == 16 and payload.n_blocks == 2
    int8 = Engine(params, cfg, ServeConfig(**SERVE, quant_kv="int8"), device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        int8.adopt_blocks(covered, payload)
    with pytest.raises(ValueError, match="tokens were named"):
        eng.adopt_blocks(covered[:8], payload)
    assert eng.export_prefix_blocks(prompt[:7].tolist()) is None
    with pytest.raises(TypeError):
        ServeConfig(decode_impl="pallas")


def test_roadmap_items_the_port_cites_name_their_headings(setup):
    """The port points at ROADMAP.md's queue 1 by item number: every
    ``queue 1, item N`` in the package's source is a heading, and no code
    cites an item that is done. The last refusal, elastic's (item 9), is
    gone: elastic fit() trains."""
    from tony_tpu_torch.train import FitConfig, fit

    root = Path(__file__).resolve().parent.parent
    text = (root / "ROADMAP.md").read_text()
    queue1 = text[text.index("### Queue 1"):text.index("### Queue 2")]
    headings = {int(n): h.lower()
                for n, h in re.findall(r"^(\d+)\. \*\*(.+?)\*\*", queue1, re.M)}
    # elastic (item 9) is ported: it no longer refuses, and in one process
    # it asks for the process group its ranks run over
    assert "elastic" in headings[9]
    with pytest.raises(RuntimeError, match="one process per rank"):
        fit(FitConfig(elastic_members=2), device="cpu")
    cited = [(path.name, int(n)) for path in (root / "tony_tpu_torch").rglob("*.py")
             for n in re.findall(r"queue 1,?\s+item (\d+)", path.read_text())]
    assert len(cited) >= 3
    assert all(n in headings for _, n in cited), (cited, sorted(headings))
    # chunked prefill, the handoff and the rest of item 8 serve now, items
    # 2 and 7 are done, and so are the obs package (item 6) and elastic (9)
    assert not [c for c in cited if c[1] in (2, 4, 6, 7, 8, 9)], cited


def test_default_device_is_cuda_and_raises_without_it(setup, monkeypatch):
    _, _, cfg, params = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, cfg, ServeConfig(**SERVE))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(params, np.zeros((1, 3), np.int64), cfg, max_new_tokens=2)


def test_submit_validates_like_reference(setup):
    _, _, cfg, params = setup
    eng = Engine(params, cfg, ServeConfig(**SERVE, max_queue=1), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(prompt=[]))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(prompt=list(range(32))))
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(prompt=list(range(20)), max_new_tokens=20))
    eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
    from tony_tpu_torch.serve import AdmissionRejected

    with pytest.raises(AdmissionRejected):
        eng.submit(Request(prompt=[1, 2], max_new_tokens=2))
    assert eng.run()[0].tokens and eng.close()["requests_finished"] == 1
    snap = eng.stats_snapshot()
    assert snap["requests_finished"] == 1 and snap["live_slots"] == 0


@pytest.mark.parametrize("blk,hd,payload", [(8, 128, 2), (24, 128, 2), (144, 128, 2),
                                            (256, 128, 2), (64, 12, 2), (64, 24, 1),
                                            (16, 128, 2), (128, 128, 1), (64, 16, 4)])
def test_engine_and_kernel_share_the_block_rule(blk, hd, payload):
    """The engine checks the decode kernel's shape rule at construction
    through ``check_kernel_shape``; the kernel's wrapper refuses exactly
    what that function refuses, with the same message, before it would
    build or launch anything."""
    from tony_tpu_torch.ops.decode_attention import _paged_cuda, check_kernel_shape

    dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[payload]
    qdt = torch.bfloat16 if payload == 1 else dtype
    q = torch.zeros((1, 1, 4, hd), dtype=qdt)
    k = torch.zeros((2, 2, blk, hd), dtype=dtype)
    scales = dict(k_scale=torch.ones(2, 2), v_scale=torch.ones(2, 2)) if payload == 1 else {}
    lengths, tables = torch.ones(1, dtype=torch.int32), torch.ones((1, 1), dtype=torch.int32)
    try:
        check_kernel_shape(1, 4, 2, hd, blk, payload, q.element_size())
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            _paged_cuda(q, k, k.clone(), lengths, tables, scale=1.0, **scales)
        assert str(got.value) == str(e)
        assert blk % 16 or not 16 <= blk <= 128 or hd % max(8, 16 // payload)
    else:
        assert blk % 16 == 0 and 16 <= blk <= 128 and hd % max(8, 16 // payload) == 0
