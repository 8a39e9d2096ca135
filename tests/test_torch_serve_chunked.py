"""Chunked prefill and the blockwise KV handoff between engines
(tony_tpu_torch.serve.engine, serve/cache.py) against the JAX package's,
on the tiny float32 config with the reference's weights; the cases of
the reference's ``tests/test_serve_gang.py`` (chunking, the payload's
wire form, adoption's refcounts, a handoff racing a slot's release).

- ``chunk_tokens`` that is not a multiple of ``kv_block`` raises the
  reference's error.
- Chunked greedy tokens equal the JAX engine's, chunked the same way, with
  every slot live (the chunks interleave with decode steps), with
  speculative decoding on, and across a copy-on-write match that chunking
  cuts back to its full blocks (the prefix hits equal too); the chunks
  a step are the reference's.
- Sampled tokens with ``chunk_tokens`` equal the unchunked engine's draw
  for draw: only a prompt's last chunk draws.
- A payload round-trips bit-exact through ``pack_payload`` /
  ``unpack_payload`` over float32, int8 and fp8 pools, and across the
  packages: the port unpacks the reference's wire form to its bytes and
  the reference unpacks the port's.
- Export and adopt: ``(adopted, freed)`` and the pool's refcounts are the
  reference's on the same calls, scratch is never adopted, the adopted
  blocks and scale rows read back byte-equal, and the adopter's greedy
  tokens on a prompt that extends the prefix equal the exporter's served
  from its own store (and the JAX adopter's).
- A handoff landing while a slot decodes, or after it is freed, touches
  only refcount-zero blocks: the live stream's tokens are unchanged.
- A payload this pool cannot adopt raises ValueError, as in the reference.
"""

import jax
import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.serve import (
    Engine as JEngine, Request as JRequest, ServeConfig as JServeConfig,
)
from tony_tpu.serve import cache as jcache
from tony_tpu_torch.models.convert import params_from_numpy
from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.serve import Engine, Request, ServeConfig
from tony_tpu_torch.serve import cache as pcache

QUANTS = ("", "int8", "fp8_e4m3")


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.key(0), jcfg)
    cfg = LlamaConfig.tiny()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, n).astype(np.int64)


def _pair(setup, **sv):
    """The port's and the reference's engine under one ServeConfig."""
    jcfg, jparams, cfg, params = setup
    return (Engine(params, cfg, ServeConfig(**sv), device="cpu"),
            JEngine(jparams, jcfg, JServeConfig(**sv)))


def _serve(eng, req_cls, prompts, new, **kw):
    ids = [eng.submit(req_cls(prompt=p, max_new_tokens=new, **kw)) for p in prompts]
    out = eng.run()
    return [out[i].tokens for i in ids]


def test_chunk_tokens_must_be_block_aligned(setup):
    jcfg, jparams, cfg, params = setup
    sv = dict(slots=1, max_len=64, kv_block=8, chunk_tokens=12)
    with pytest.raises(ValueError, match="multiple of kv_block") as ours:
        Engine(params, cfg, ServeConfig(**sv), device="cpu")
    with pytest.raises(ValueError, match="multiple of kv_block") as theirs:
        JEngine(jparams, jcfg, JServeConfig(**sv))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", [False, True])
def test_chunked_greedy_tokens_equal_the_jax_engine(setup, spec):
    """Three 40-token prompts sharing 16 tokens, every slot live, chunks of
    16: the first step admits all three and runs one chunk of each, the
    next steps one chunk each beside the decode steps of the slots already
    decoding; tokens equal the JAX engine's, with speculation on too."""
    sv = dict(slots=3, max_len=52, kv_block=8, chunk_tokens=16, prefix=True,
              spec=spec, spec_max_draft=3)
    ours, theirs = _pair(setup, **sv)
    shared = _prompt(16, seed=11)
    prompts = [np.concatenate([shared, _prompt(24, seed=20 + i)]) for i in range(3)]
    for i, p in enumerate(prompts):
        ours.submit(Request(prompt=p, max_new_tokens=6))
        theirs.submit(JRequest(prompt=p.astype(np.int32), max_new_tokens=6))
    ours.step()
    theirs.step()
    assert sorted(ours._chunking) == sorted(theirs._chunking) == [0, 1, 2]
    assert ours.stats_snapshot()["chunking_slots"] == 3
    assert ours.n_live == 3 and ours.n_decoding == 0
    got, want = ours.run(), theirs.run()
    assert [got[i].tokens for i in range(3)] == [want[i].tokens for i in range(3)]
    assert ours.prefill_chunks == 9 and not ours._chunking


def test_chunking_cuts_a_cow_match_back_as_the_reference_does(setup):
    """A 24-token prompt registers three blocks; a 40-token prompt sharing
    its first 19 tokens matches two blocks and three tokens into the
    third, and, its tail longer than a chunk, is cut back to the two full
    blocks (no copy-on-write) and chunked from position 16: tokens, prefix
    hits and copies equal the JAX engine's. Unchunked, the port cuts it
    too (its prefill runs block-aligned pieces), where the reference keeps
    it."""
    sv = dict(slots=2, max_len=64, kv_block=8, chunk_tokens=8, prefix=True)
    ours, theirs = _pair(setup, **sv)
    first = _prompt(24, seed=5)
    second = np.concatenate([first[:19], _prompt(21, seed=6)])
    for p in (first, second):
        a = _serve(ours, Request, [p], 5)
        b = _serve(theirs, JRequest, [p.astype(np.int32)], 5)
        assert a == b
    assert ours.metrics.prefix_hit_tokens == theirs.metrics.prefix_hit_tokens == 16
    assert ours._cow_copies == theirs._cow_copies == 0
    plain = Engine(setup[3], setup[2], ServeConfig(**{**sv, "chunk_tokens": 0}),
                   device="cpu")
    for p in (first, second):
        _serve(plain, Request, [p], 5)
    assert plain.metrics.prefix_hit_tokens == 16 and plain._cow_copies == 0


def test_sampled_tokens_are_the_unchunked_engines_draw_for_draw(setup):
    """A request's generator draws only at its last chunk: sampled tokens
    with chunk_tokens equal the unchunked engine's, in a busy engine."""
    _, _, cfg, params = setup
    prompts = [_prompt(n, seed=30 + n) for n in (37, 9, 26, 44)]
    kw = [dict(temperature=0.9, top_k=20), dict(temperature=1.1),
          dict(temperature=0.7, top_p=0.8), dict(temperature=1.0, top_k=5)]
    out = []
    for chunk in (0, 8):
        eng = Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=8,
                                              chunk_tokens=chunk), device="cpu")
        ids = [eng.submit(Request(prompt=p, max_new_tokens=6, rng=50 + i, **k))
               for i, (p, k) in enumerate(zip(prompts, kw))]
        res = eng.run()
        out.append([res[i].tokens for i in ids])
    assert out[0] == out[1]


# --- the blockwise handoff -------------------------------------------------------


def _handoff(**kw):
    return dict(slots=2, max_len=64, kv_block=8, prefix=True, **kw)


def _exported(setup, quant, seed=21):
    """A 32-token prompt served by each package's engine over a ``quant``
    pool, then its four blocks exported."""
    ours, theirs = _pair(setup, **_handoff(quant_kv=quant))
    p = _prompt(32, seed=seed)
    _serve(ours, Request, [p], 1)
    _serve(theirs, JRequest, [p.astype(np.int32)], 1)
    return p, ours.export_prefix_blocks(p.tolist()), theirs.export_prefix_blocks(p.tolist())


def _np_bytes(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _t_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("quant", QUANTS)
def test_payload_roundtrip_is_bit_exact_across_packages(setup, quant):
    """Each package's payload packs and unpacks to its own bytes, the port
    unpacks the reference's wire form to the reference's bytes and the
    reference the port's; a quantized payload's scale rows travel too, and
    malformed bodies raise."""
    p, (covered, ours), (jcovered, theirs) = _exported(setup, quant)
    assert covered == jcovered == p.tolist() and ours.n_blocks == theirs.n_blocks == 4
    mine = pcache.pack_payload(ours)
    wire = jcache.pack_payload(theirs)
    assert mine["dtype"] == wire["dtype"] and mine["shape"] == wire["shape"]
    assert set(mine) == set(wire)
    back = pcache.unpack_payload(mine["k"], mine["v"], mine["shape"], mine["dtype"],
                                 k_scale=mine.get("k_scale", b""),
                                 v_scale=mine.get("v_scale", b""))
    from_ref = pcache.unpack_payload(wire["k"], wire["v"], wire["shape"], wire["dtype"],
                                     k_scale=wire.get("k_scale", b""),
                                     v_scale=wire.get("v_scale", b""))
    to_ref = jcache.unpack_payload(mine["k"], mine["v"], mine["shape"], mine["dtype"],
                                   k_scale=mine.get("k_scale", b""),
                                   v_scale=mine.get("v_scale", b""))
    parts = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for name in parts:
        assert _t_bytes(getattr(back, name)) == _t_bytes(getattr(ours, name)), name
        assert _t_bytes(getattr(from_ref, name)) == _np_bytes(getattr(theirs, name)), name
        assert _np_bytes(getattr(to_ref, name)) == _t_bytes(getattr(ours, name)), name
        assert getattr(back, name).dtype == getattr(ours, name).dtype
    if not quant:
        assert back.k_scale is None and from_ref.k_scale is None
    assert back.nbytes == ours.nbytes == theirs.nbytes
    with pytest.raises(ValueError):
        pcache.unpack_payload(mine["k"][:-3], mine["v"], mine["shape"], mine["dtype"])
    with pytest.raises(ValueError):
        pcache.unpack_payload(mine["k"], mine["v"], [1, 2], mine["dtype"])
    with pytest.raises(ValueError):
        pcache.unpack_payload(mine["k"], mine["v"], mine["shape"], "no_such_dtype")


@pytest.mark.parametrize("quant", QUANTS)
def test_export_adopt_refcounts_and_tokens_match_the_reference(setup, quant):
    """The reference's sequence of calls on both packages: the first adopt
    takes every block, a second frees them all; each adopted block holds
    one reference (the store's), none is scratch; the blocks and scale
    rows read back byte-equal to the payload; a prompt extending the
    prefix decodes on the adopter as on the exporter from its own store,
    and as on the JAX adopter."""
    p, (covered, ours), (_, theirs) = _exported(setup, quant, seed=22)
    src, _ = _pair(setup, **_handoff(quant_kv=quant))
    _serve(src, Request, [p], 1)
    dst, jdst = _pair(setup, **_handoff(quant_kv=quant))
    assert dst.adopt_blocks(covered, ours) == jdst.adopt_blocks(covered, theirs) == (4, 0)
    assert dst.adopt_blocks(covered, ours) == jdst.adopt_blocks(covered, theirs) == (0, 4)
    m, jm = dst._store.match(covered, 32), jdst._store.match(covered, 32)
    assert len(m.full) == len(jm.full) == 4 and 0 not in m.full
    assert [dst._pool.refcount(pid) for pid in m.full] == \
        [jdst._pool._ref[pid] for pid in jm.full] == [1] * 4
    again = pcache.export_blocks(dst.cache, list(m.full))
    for name in ("k", "v", "k_scale", "v_scale") if quant else ("k", "v"):
        assert _t_bytes(getattr(again, name)) == _t_bytes(getattr(ours, name)), name
    longer = np.concatenate([p, _prompt(5, seed=23)])
    got = _serve(dst, Request, [longer], 6)
    assert got == _serve(src, Request, [longer], 6)
    assert got == _serve(jdst, JRequest, [longer.astype(np.int32)], 6)
    assert dst.metrics.prefix_hit_tokens == jdst.metrics.prefix_hit_tokens == 32


def test_a_handoff_racing_a_slot_free_never_corrupts(setup):
    """A handoff landing while a slot decodes allocates only refcount-zero
    blocks: the live slot's blocks stay untouched and its tokens are those
    it decodes alone; after the slot is freed and the store emptied, a
    stale re-ship is adopted whole and the books balance."""
    _, _, cfg, params = setup
    p, (covered, payload), _ = _exported(setup, "", seed=23)
    dst = Engine(params, cfg, ServeConfig(**_handoff()), device="cpu")
    q = _prompt(24, seed=24)
    rid = dst.submit(Request(prompt=q, max_new_tokens=6))
    for _ in range(3):
        dst.step()
    slot = next(s for s, r in enumerate(dst._slot_rid) if r == rid)
    live = set(dst._table[slot, :dst._slot_blocks[slot]].tolist())
    assert dst.adopt_blocks(covered, payload) == (4, 0)
    adopted = set(dst._store.match(covered, 32).full)
    assert not adopted & live
    out = dst.run()
    alone = Engine(params, cfg, ServeConfig(**_handoff()), device="cpu")
    assert out[rid].tokens == _serve(alone, Request, [q], 6)[0]
    while dst._store.evict_lru(dst._pool.release) is not None:
        pass
    assert dst.adopt_blocks(covered, payload) == (4, 0)
    owned = dst._store.match(covered, 32).full
    assert all(dst._pool.refcount(pid) == 1 for pid in owned)
    assert dst._pool.n_used == dst._store.n_nodes


@pytest.mark.parametrize("src,dst", [("int8", ""), ("", "int8"), ("fp8_e4m3", "int8")])
def test_an_incompatible_payload_raises_as_in_the_reference(setup, src, dst):
    """A pool adopts only its own storage dtype and geometry, with scale
    rows exactly where it is quantized; the refusal is the reference's."""
    p, (covered, ours), (_, theirs) = _exported(setup, src, seed=25)
    eng, jeng = _pair(setup, **_handoff(quant_kv=dst))
    with pytest.raises(ValueError, match="incompatible") as err:
        eng.adopt_blocks(covered, ours)
    with pytest.raises(ValueError, match="incompatible") as jerr:
        jeng.adopt_blocks(covered, theirs)
    assert str(err.value) == str(jerr.value)
    assert eng._pool.n_used == 0
