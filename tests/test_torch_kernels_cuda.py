"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports neither jax nor tony_tpu, so it runs where the card is
and JAX is not::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the reference's
tests.) Every test is marked ``cuda`` and skips without a CUDA device.
Inputs come from a numpy seed. Tolerances, and why, are in each test."""

import math

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in true fp32
    return torch.device("cuda")


# --- paged decode attention ------------------------------------------------------

# the kernel takes blocks of 16..128 positions: a length-1 row, an exact
# block boundary, a full row, two ragged rows
B, H, HKV, HD, BLK, M = 5, 4, 2, 16, 16, 4
LENGTHS = [1, 16, 64, 13, 45]


def _decode_case(G: int, seed: int):
    """Pools, tables and queries from a numpy seed; row 4 shares row 2's
    first two physical blocks, entries past a length point at block 0."""
    rng = np.random.default_rng(seed)
    lengths = np.array([max(n, G) for n in LENGTHS], np.int32)
    need = [math.ceil(n / BLK) for n in lengths]
    own = need.copy()
    own[4] -= 2
    P = 1 + sum(own)
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, M), np.int32)
    at = 0
    for b in range(B):
        if b == 4:
            tables[b, :2] = tables[2, :2]
            tables[b, 2:need[b]] = ids[at:at + own[b]]
        else:
            tables[b, :need[b]] = ids[at:at + own[b]]
        at += own[b]
    q = rng.standard_normal((B, G, H, HD)).astype(np.float32)
    k = rng.standard_normal((P, HKV, BLK, HD)).astype(np.float32)
    v = rng.standard_normal((P, HKV, BLK, HD)).astype(np.float32)
    return q, k, v, lengths, tables


@pytest.mark.cuda
def test_decode_kernel_matches_plain_on_card(cuda):
    """The CUDA kernel against its plain version on the card, both dtypes
    (bf16: a few ulps of 2^-8, the output and p are rounded to bf16)."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, decode_attention, paged_decode_attention_plain, reset_launches,
    )

    for G in (1, 3):
        q, k, v, lengths, tables = (torch.from_numpy(a).to(cuda)
                                    for a in _decode_case(G, seed=5))
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2**-7)):
            reset_launches()
            out = decode_attention(q.to(dtype), k.to(dtype), v.to(dtype),
                                   lengths, tables=tables)
            torch.cuda.synchronize()
            assert LAUNCHES["paged_decode_attention"] == 1
            ref = paged_decode_attention_plain(
                q.to(dtype).float(), k.to(dtype).float(), v.to(dtype).float(),
                lengths, tables, scale=1.0 / math.sqrt(HD))
            torch.testing.assert_close(out.float(), ref, atol=atol, rtol=atol)


@pytest.mark.cuda
def test_decode_kernel_stages_large_blocks_in_chunks_on_card(cuda):
    """float32 at block 128, head_dim 128: a block's K+V exceed the kernel's
    64 KB staging budget, so it stages each block in two chunks. Lengths end
    inside a first chunk, on a chunk boundary, and inside a second chunk."""
    from tony_tpu_torch.ops.decode_attention import (
        _chunk, decode_attention, paged_decode_attention_plain,
    )

    blk, hd, lengths = 128, 128, np.array([1, 64, 128, 200, 300], np.int32)
    assert _chunk(blk, hd, 4) < blk
    rng = np.random.default_rng(6)
    need = [math.ceil(n / blk) for n in lengths]
    P = 1 + sum(need)
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((len(lengths), max(need)), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[at:at + n]
        at += n
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
               for s in ((len(lengths), 1, H, hd), (P, HKV, blk, hd),
                         (P, HKV, blk, hd)))
    lengths, tables = torch.from_numpy(lengths).to(cuda), torch.from_numpy(tables).to(cuda)
    out = decode_attention(q, k, v, lengths, tables=tables)
    ref = paged_decode_attention_plain(q, k, v, lengths, tables,
                                       scale=1.0 / math.sqrt(hd))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_block", [8, 256])
def test_engine_refuses_a_block_the_kernel_refuses_on_card(cuda, kv_block):
    """The decode kernel takes blocks that are multiples of 16 in [16, 128]:
    an engine on the card with block 8 or 256 raises at construction,
    before it admits a request; one with block 16 serves."""
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.serve import Engine, Request, ServeConfig

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device=cuda)
    with pytest.raises(ValueError, match=f"block {kv_block} must be"):
        Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=kv_block),
               device=cuda)
    engine = Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=16), device=cuda)
    out = engine.run([Request(prompt=np.arange(5), max_new_tokens=3)])
    assert [len(c.tokens) for c in out.values()] == [3]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_contiguous_decode_kernel_matches_plain_on_card(cuda, G, dtype):
    """Kernel 7 (the contiguous form) against its plain version: rep 4, T
    160 in tiles of 32 (a whole number of tiles), ragged lengths with a
    short row, one on a tile boundary and one at the end; and T 48 under
    the default block (one tile). Positions past each row's length hold
    1e3, which must not reach the output. Tolerance as the paged kernel's."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, decode_attention, decode_attention_plain, reset_launches,
    )

    rng = np.random.default_rng(20 + G)
    atol = 1e-5 if dtype == torch.float32 else 2**-7
    for T, block in ((160, 32), (48, 128)):
        lengths = np.array([max(n, G) for n in (1, 32, T, 77, 45)], np.int32)
        q = rng.standard_normal((5, G, 8, 64)).astype(np.float32)
        k, v = (rng.standard_normal((5, 2, T, 64)).astype(np.float32) for _ in range(2))
        for b, n in enumerate(lengths):
            k[b, :, n:], v[b, :, n:] = 1e3, -1e3
        q, k, v = (torch.from_numpy(a).to(cuda).to(dtype) for a in (q, k, v))
        lengths = torch.from_numpy(lengths).to(cuda)
        reset_launches()
        out = decode_attention(q, k, v, lengths, block=block)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == 1 and LAUNCHES["decode_attention_plain"] == 0
        ref = decode_attention_plain(q.float(), k.float(), v.float(), lengths,
                                     scale=1.0 / math.sqrt(64))
        torch.testing.assert_close(out.float(), ref, atol=atol, rtol=atol)


@pytest.mark.cuda
def test_engine_refuses_a_draft_width_the_kernel_refuses_on_card(cuda):
    """With spec on, the engine checks the decode kernel's shape rule at the
    verify step's G = spec_max_draft + 1 at construction: a width whose
    query rows overflow the kernel's shared memory raises there, before a
    request is admitted (tiny config: 2 rows per kv head, hd 16)."""
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.serve import Engine, ServeConfig

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=16, spec=True,
                                        spec_max_draft=600), device=cuda)
    Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=16, spec=True,
                                    spec_max_draft=15), device=cuda)


@pytest.mark.cuda
def test_spec_engine_tokens_equal_spec_off_on_card(cuda):
    """The speculative engine on the card (the paged kernel at G = 5):
    greedy and sampled requests, two rounds so the second drafts along the
    first's generated blocks, emit the same tokens with spec on as off, in
    float32 (bf16 would let the verify step's wider matmuls round a logit
    differently from the one-token step's)."""
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.ops.decode_attention import LAUNCHES, reset_launches
    from tony_tpu_torch.serve import Engine, Request, ServeConfig

    cfg = LlamaConfig.tiny()                          # float32
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device=cuda)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 20, 33)]
    kwargs = [dict(), dict(temperature=0.9, top_k=20), dict()]

    def run(**sv):
        eng = Engine(params, cfg, ServeConfig(slots=2, max_len=64, kv_block=16, **sv),
                     device=cuda)
        out = []
        for _ in range(2):
            ids = [eng.submit(Request(prompt=p, max_new_tokens=30, rng=3 + i, **kw))
                   for i, (p, kw) in enumerate(zip(prompts, kwargs))]
            res = eng.run()
            out.append([res[i].tokens for i in ids])
        return out, eng.metrics

    off, _ = run()
    reset_launches()
    on, m = run(spec=True, spec_max_draft=4)
    assert on == off
    assert m.draft_accepted > 0
    assert LAUNCHES["paged_decode_attention"] == m.decode_steps * cfg.n_layers
    assert LAUNCHES["paged_decode_attention_plain"] == 0


# --- the bf16 tensor-core instance of decode attention (kernels 7 and 8) ----------

# bf16: the output and p are rounded to bf16, and p at the split's running
# max where the plain version rounds it at the row's max: a couple of ulps
# of 2^-8 (the decode cases' tolerance)
DECODE_BF16_TOL = 2**-7


def _tc_paged_case(G: int, hd: int, blk: int, rep: int, seed: int, split: int):
    """Rows written to 1, S-1, S, S+1, 2S+1 and M * blk positions (S the
    split), whose lengths run G - 1 past their written positions for a
    verify step (the last row past the table's M blocks, as VERIFY_PAST
    in chip_smoke.py), so every row's first query sees at least one
    position; row 5 shares row 4's first two physical blocks; entries past
    a row's written blocks name scratch block 0, which holds values of its
    own. Pools of 2 kv heads, bf16, from a numpy seed."""
    M = math.ceil((2 * split + 1) / blk) + 1
    written = np.array([1, split - 1, split, split + 1, 2 * split + 1, M * blk], np.int32)
    lengths = written + (G - 1)
    need = [math.ceil(n / blk) for n in written]
    own = need.copy()
    own[5] -= 2
    rng = np.random.default_rng(seed)
    P = 1 + sum(own)
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((len(written), M), np.int32)
    at = 0
    for b, n in enumerate(need):
        if b == 5:
            tables[b, :2] = tables[4, :2]
            tables[b, 2:n] = ids[at:at + own[b]]
        else:
            tables[b, :n] = ids[at:at + n]
        at += own[b]
    q = rng.standard_normal((len(written), G, 2 * rep, hd)).astype(np.float32)
    k, v = (rng.standard_normal((P, 2, blk, hd)).astype(np.float32) for _ in range(2))
    return (*(torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)),
            torch.from_numpy(lengths).cuda(), torch.from_numpy(tables).cuda())


@pytest.mark.cuda
def test_decode_kernel_instances_on_card(cuda):
    """``kernel_instance`` names the design the built library dispatches:
    the tensor cores for bf16 queries at the serving shapes (hd 128, blk
    64, rep 4, G 1, 5 and 16), over bf16 or quantized pools, and at kernel
    7's bench case (blk 128), scalar for float32 queries and for bf16 past
    head_dim 128; a shape the shape rule refuses raises its ValueError."""
    from tony_tpu_torch.ops.decode_attention import kernel_instance

    tc = "tensor cores"
    for G in (1, 5, 16):
        assert kernel_instance("paged_decode_attention", torch.bfloat16, 128, 64, G, 4) == tc
        assert kernel_instance("paged_decode_attention", torch.float32, 128, 64, G, 4) == "scalar"
        assert kernel_instance("paged_decode_attention_quant", torch.bfloat16, 128, 64, G,
                               4) == tc
        assert kernel_instance("paged_decode_attention_quant", torch.float32, 128, 64, G,
                               4) == "scalar"
    assert kernel_instance("paged_decode_attention_quant", torch.bfloat16, 256, 64, 1,
                           4) == "scalar"
    assert kernel_instance("decode_attention", torch.bfloat16, 128, 128, 1, 4) == tc
    assert kernel_instance("decode_attention", torch.float32, 128, 128, 1, 4) == "scalar"
    # bf16 shapes past the tensor-core instance keep the scalar body
    assert kernel_instance("paged_decode_attention", torch.bfloat16, 256, 64, 1, 4) == "scalar"
    assert kernel_instance("paged_decode_attention", torch.bfloat16, 24, 64, 1, 4) == "scalar"
    assert kernel_instance("paged_decode_attention", torch.bfloat16, 64, 64, 40, 4) == "scalar"
    with pytest.raises(ValueError, match="G=40 x rep=4"):
        kernel_instance("paged_decode_attention", torch.bfloat16, 128, 64, 40, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("blk", [16, 64, 128])
def test_tc_paged_decode_matches_plain_on_card(cuda, hd, blk):
    """The tensor-core instance of kernel 8 against its plain version at G
    1, 5 and 16 and rep 1, 4 and 8 (rows of 1, S-1, S, S+1, 2S+1 and M *
    blk positions, verify rows past the table, shared blocks), bf16. G 16
    at rep 8 and hd 128 overflows the shape rule and raises there."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, SPLIT, check_kernel_shape, decode_attention, kernel_instance,
        paged_decode_attention_plain, reset_launches,
    )

    for G in (1, 5, 16):
        for rep in (1, 4, 8):
            q, k, v, lengths, tables = _tc_paged_case(G, hd, blk, rep, 31 * G + rep, SPLIT)
            try:
                check_kernel_shape(G, 2 * rep, 2, hd, blk, 2, 2)
            except ValueError:
                with pytest.raises(ValueError, match="shared memory"):
                    decode_attention(q, k, v, lengths, tables=tables)
                continue
            assert kernel_instance("paged_decode_attention", torch.bfloat16, hd, blk, G,
                                   rep) == "tensor cores"
            reset_launches()
            out = decode_attention(q, k, v, lengths, tables=tables)
            torch.cuda.synchronize()
            assert LAUNCHES["paged_decode_attention"] == 1
            ref = paged_decode_attention_plain(q.float(), k.float(), v.float(), lengths,
                                               tables, scale=1.0 / math.sqrt(hd))
            torch.testing.assert_close(out.float(), ref, atol=DECODE_BF16_TOL,
                                       rtol=DECODE_BF16_TOL, msg=f"G={G} rep={rep}")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("T,block", [(640, 64), (1024, 128), (48, 16)])
def test_tc_contiguous_decode_matches_plain_on_card(cuda, hd, T, block):
    """The tensor-core instance of kernel 7 against its plain version at G
    1, 5 and 16 and rep 1, 4 and 8, lengths 1, S-1, S, S+1 and T (clipped
    to T, at least G): positions past each row's length hold NaN, which
    must not be read; the plain version gets zeros there."""
    from tony_tpu_torch.ops.decode_attention import (
        SPLIT, check_kernel_shape, decode_attention, decode_attention_plain, kernel_instance,
    )

    for G in (1, 5, 16):
        for rep in (1, 4, 8):
            try:
                check_kernel_shape(G, 2 * rep, 2, hd, min(block, T), 2, 2)
            except ValueError:
                continue
            assert kernel_instance("decode_attention", torch.bfloat16, hd, min(block, T), G,
                                   rep) == "tensor cores"
            rng = np.random.default_rng(hd + T + 7 * G + rep)
            lens = np.array([min(max(n, G), T) for n in (1, SPLIT - 1, SPLIT, SPLIT + 1, T)],
                            np.int32)
            q = rng.standard_normal((len(lens), G, 2 * rep, hd)).astype(np.float32)
            k, v = (rng.standard_normal((len(lens), 2, T, hd)).astype(np.float32)
                    for _ in range(2))
            kz, vz = k.copy(), v.copy()
            for b, n in enumerate(lens):
                k[b, :, n:], v[b, :, n:] = np.nan, np.nan
                kz[b, :, n:], vz[b, :, n:] = 0.0, 0.0
            q, k, v, kz, vz = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                               for a in (q, k, v, kz, vz))
            lengths = torch.from_numpy(lens).cuda()
            out = decode_attention(q, k, v, lengths, block=block)
            torch.cuda.synchronize()
            ref = decode_attention_plain(q.float(), kz.float(), vz.float(), lengths,
                                         scale=1.0 / math.sqrt(hd))
            torch.testing.assert_close(out.float(), ref, atol=DECODE_BF16_TOL,
                                       rtol=DECODE_BF16_TOL, msg=f"G={G} rep={rep}")


@pytest.mark.cuda
def test_tc_decode_long_row_takes_many_splits_on_card(cuda):
    """One row of 9000 positions (36 splits of 256) beside a short one, at
    the serving shape (rep 4, hd 128, blk 64), G 1 and 16, paged and
    contiguous: the merge over many splits against the plain versions."""
    from tony_tpu_torch.ops.decode_attention import (
        SPLIT, decode_attention, decode_attention_plain, paged_decode_attention_plain,
        split_plan,
    )

    blk, hd, M = 64, 128, 144
    assert split_plan(M, blk, 4, hd)[0] == 36 and 9000 > 35 * SPLIT
    rng = np.random.default_rng(90)
    for G in (1, 16):
        lengths = torch.tensor([9000, 70], dtype=torch.int32).cuda()
        tables = torch.from_numpy(
            rng.permutation(np.arange(1, 1 + 2 * M)).reshape(2, M).astype(np.int32)).cuda()
        q = torch.from_numpy(rng.standard_normal((2, G, 8, hd)).astype(np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((1 + 2 * M, 2, blk, hd)).astype(np.float32))
                for _ in range(2))
        q, k, v = (t.cuda().to(torch.bfloat16) for t in (q, k, v))
        out = decode_attention(q, k, v, lengths, tables=tables)
        ref = paged_decode_attention_plain(q.float(), k.float(), v.float(), lengths, tables,
                                           scale=hd ** -0.5)
        torch.testing.assert_close(out.float(), ref, atol=DECODE_BF16_TOL,
                                   rtol=DECODE_BF16_TOL)
        kc = k[tables.long()].permute(0, 2, 1, 3, 4).reshape(2, 2, M * blk, hd).contiguous()
        vc = v[tables.long()].permute(0, 2, 1, 3, 4).reshape(2, 2, M * blk, hd).contiguous()
        out_c = decode_attention(q, kc, vc, lengths, block=128)
        ref_c = decode_attention_plain(q.float(), kc.float(), vc.float(), lengths,
                                       scale=hd ** -0.5)
        torch.testing.assert_close(out_c.float(), ref_c, atol=DECODE_BF16_TOL,
                                   rtol=DECODE_BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["paged", "contiguous", "int8", "fp8_e4m3"])
def test_tc_decode_is_invariant_on_card(cuda, form):
    """Bit for bit, on the tensor-core instance: row b of a batch of 8
    equals the row computed alone (B = 1, its own table row); query G - 1
    of a G 16 call equals a G 1 call at the same length; two launches are
    equal. Llama-3-8B's decode shape (rep 4, hd 128, blk 64), the serving
    case's lengths, two rows sharing blocks; paged, contiguous, and paged
    over int8 and fp8 pools (kernel 9)."""
    from tony_tpu_torch.ops.decode_attention import decode_attention, kernel_instance

    G, blk, hd, M = 16, 64, 128, 32
    rng = np.random.default_rng(11)
    lens = torch.tensor([2048, 5, 64, 1000, 1537, 700, 133, 1999], dtype=torch.int32).cuda()
    tables = rng.permutation(np.arange(1, 1 + 8 * M)).reshape(8, M).astype(np.int32)
    tables[7, :8] = tables[0, :8]
    tables = torch.from_numpy(tables).cuda()
    q = torch.from_numpy(rng.standard_normal((8, G, 32, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1 + 8 * M, 8, blk, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.cuda().to(torch.bfloat16) for t in (q, k, v))
    scales = {}
    if form == "contiguous":
        k = k[tables.long()].permute(0, 2, 1, 3, 4).reshape(8, 8, M * blk, hd).contiguous()
        v = v[tables.long()].permute(0, 2, 1, 3, 4).reshape(8, 8, M * blk, hd).contiguous()
    elif form != "paged":
        (k, ks), (v, vs) = _quantize_pool(k, form), _quantize_pool(v, form)
        scales = dict(k_scale=ks, v_scale=vs)
        assert kernel_instance("paged_decode_attention_quant", torch.bfloat16, hd, blk, G,
                               4) == "tensor cores"

    def run(q, rows=slice(None)):
        if form == "contiguous":
            return decode_attention(q, k[rows], v[rows], lens[rows], block=128)
        return decode_attention(q, k, v, lens[rows], tables=tables[rows], **scales)

    out = run(q)
    assert torch.equal(out, run(q))
    for b in range(8):
        assert torch.equal(run(q[b:b + 1], slice(b, b + 1)), out[b:b + 1]), f"row {b}"
    last = run(q[:, G - 1:].contiguous())
    assert torch.equal(last[:, 0], out[:, G - 1])


# --- flash attention ---------------------------------------------------------------

# bf16: outputs are rounded to bf16 (2^-8 relative) and the forward rounds p
# to bf16 at another running max than the one-pass plain version, so a few
# ulps; fp32: only the order of the sums differs
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}


def _flash_case(dev, dtype, B, S, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, hd)).astype(np.float32))
            for _ in range(2))
    return tuple(t.to(dev).to(dtype) for t in (q, k, v, do))


def _close(got, want, dtype, what):
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{what}: {m}")


def _flash_against_plain(q, k, v, do, causal):
    """flash_fwd, flash_dq and flash_dkv on ``[B, S, H, hd]`` views against
    their plain versions on the same inputs; each kernel launched once, no
    plain version run, and each bf16 kernel through its tensor-core
    instance."""
    from tony_tpu_torch.ops.attention import (
        LAUNCHES, _dkv, _dq, _delta, _fwd, flash_dkv_plain, flash_dq_plain,
        flash_fwd_plain, kernel_instance, reset_launches,
    )

    dtype, hd = q.dtype, q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    reset_launches()
    out, lse = _fwd(q, k, v, scale, causal)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    _close(out, ref_out, dtype, "out")
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    delta = _delta(do, ref_out)
    dq = _dq(q, k, v, do, ref_lse, delta, scale, causal)
    dk, dv = _dkv(q, k, v, do, ref_lse, delta, scale, causal)
    torch.cuda.synchronize()
    _close(dq, flash_dq_plain(q, k, v, do, ref_lse, delta, scale=scale,
                              causal=causal), dtype, "dq")
    ref_dk, ref_dv = flash_dkv_plain(q, k, v, do, ref_lse, delta, scale=scale,
                                     causal=causal)
    _close(dk, ref_dk, dtype, "dk")
    _close(dv, ref_dv, dtype, "dv")
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_dq"] == LAUNCHES["flash_dkv"] == 1
    assert LAUNCHES["flash_fwd_plain"] == LAUNCHES["flash_dq_plain"] == 0
    assert LAUNCHES["flash_dkv_plain"] == 0
    want = "tensor cores" if dtype == torch.bfloat16 else "scalar"
    assert kernel_instance("flash_fwd", dtype, hd) == want
    assert kernel_instance("flash_dkv", dtype, hd) == want
    assert kernel_instance("flash_dq", dtype, hd) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("H,Hkv,hd,S", [(4, 2, 64, 200), (4, 4, 128, 192),
                                        (8, 2, 128, 130), (4, 2, 64, 40),
                                        (2, 2, 128, 2048), (16, 4, 128, 320)])
def test_flash_kernels_match_plain_on_card(cuda, dtype, causal, H, Hkv, hd, S):
    """flash_fwd, flash_dq and flash_dkv against their plain versions on the
    same inputs: GQA (rep 2 and 4) and MHA, sequences shorter than one
    tile, ending inside a 64- or 128-row tile and an exact multiple of 128
    (S 2048), causal and not."""
    q, k, v, do = _flash_case(cuda, dtype, 2, S, H, Hkv, hd, seed=S + hd)
    _flash_against_plain(q, k, v, do, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_kernels_follow_permuted_layout_on_card(cuda, dtype):
    """Dense ``[B, H, S, hd]`` storage seen as ``[B, S, H, hd]`` views
    (head stride S * hd, position stride hd): the kernels, and the bf16
    instances' tensor maps, follow the caller's strides without a copy."""
    from tony_tpu_torch.ops.attention import _dense, _tma_ready

    q, k, v, do = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _flash_case(cuda, dtype, 2, 320, 8, 2, 128, seed=3))
    assert q.stride() == (8 * 320 * 128, 128, 320 * 128, 1)
    assert _dense(q) is q and _tma_ready(q, do)[0] is q
    _flash_against_plain(q, k, v, do, causal=True)


@pytest.mark.cuda
def test_flash_attention_grad_and_folded_layout_on_card(cuda):
    """The autograd entry on the card (kernels) against the same entry on
    the CPU (plain versions) in float32 within 1e-4, and the
    explicit-residual passes in the folded [B*H, S, hd] layout against the
    [B, S, H, hd] kernels (the same kernel on strided views: exact)."""
    from tony_tpu_torch.ops.attention import (
        LAUNCHES, flash_attention, flash_dkv_pass, flash_dq_pass,
        flash_fwd_pass, reset_launches,
    )

    q, k, v, do = _flash_case("cpu", torch.float32, 2, 128, 4, 2, 64, seed=1)
    grads = {}
    for dev in ("cpu", cuda):
        xs = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*xs)
        grads[str(dev)] = (out, *torch.autograd.grad(out, xs, do.to(dev)))
    for a, b in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=1e-4, rtol=1e-4)

    qc, kc, vc, doc = (t.to(cuda) for t in (q, k, v, do))
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])  # noqa: E731
    kw = dict(scale=0.125, causal=True, heads=4, kv_heads=2)
    reset_launches()
    out, lse = flash_fwd_pass(fold(qc), fold(kc), fold(vc), **kw)
    torch.testing.assert_close(out, fold(grads["cuda"][0].detach()), atol=0, rtol=0)
    delta = (doc.float() * grads["cuda"][0].float()).sum(-1).transpose(1, 2)
    delta = delta.reshape(-1, 1, q.shape[1])
    dq = flash_dq_pass(fold(qc), fold(kc), fold(vc), fold(doc), lse, delta, **kw)
    dk, dv = flash_dkv_pass(fold(qc), fold(kc), fold(vc), fold(doc), lse, delta, **kw)
    for got, want in zip((dq, dk, dv), grads["cuda"][1:]):
        torch.testing.assert_close(got, fold(want), atol=1e-6, rtol=1e-6)
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_dq"] == LAUNCHES["flash_dkv"] == 1


# --- grouped matmul ----------------------------------------------------------------

# bf16: y and dx are rounded to bf16 (2^-8 relative) from float32 sums taken
# in another order, so up to an ulp or two; fp32, and dW (float32 out of
# either input type): only the order of the float32 sums differs
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}


def _gmm_case(dev, dtype, sizes, D, F, block, seed):
    """x [N, D] laid out by grouped_layout (group rows normal, padding rows
    zero), w [G, D, F] and dy [N, F] normal, from a numpy seed."""
    from tony_tpu_torch.ops.grouped_mm import grouped_layout

    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    n_tiles = -(-int(sizes.sum()) // block) + len(sizes)
    starts, tg = grouped_layout(torch.from_numpy(sizes), block, n_tiles)
    x = np.zeros((n_tiles * block, D), np.float32)
    for s, n in zip(starts.tolist(), sizes):
        x[s:s + n] = rng.standard_normal((n, D))
    w = rng.standard_normal((len(sizes), D, F)).astype(np.float32) / np.sqrt(D)
    dy = rng.standard_normal((n_tiles * block, F)).astype(np.float32)
    x, w, dy = (torch.from_numpy(a).to(dev).to(dtype) for a in (x, w, dy))
    return x, w, tg.to(dev), dy


# (sizes, D, F, block): a width crossing the 128-column tile with ragged
# edges on both dims and an empty expert; the 16-row tiles of the tests'
# configs with two empty experts at the end; a row tile of 160 (two row
# slices per tile, the second partial) with a width below one column tile;
# row tiles of 128 and 256 (the bf16 wgmma instances: one and two 128-row
# slices per tile) with contraction tails (72, 136, 200, 328 are not
# multiples of their 64-deep slices), output widths that end inside a
# 64-column half, below one 256-column tile, or leave whole halves of it
# unloaded, and empty experts in the middle and at the end; a row tile of
# 64 (mma.sync, as are 16 and 160); and at row tile 128 a group over eight
# tiles beside a group of one, so dW's contraction must stop at each
# group's end
GMM_CASES = [([130, 0, 77, 300], 136, 200, 128), ([5, 40, 0, 9, 0], 64, 72, 16),
             ([200, 0, 3], 40, 256, 160), ([260, 0, 7, 129, 0], 72, 328, 128),
             ([300, 0, 513], 136, 200, 256), ([70, 0, 5, 64], 72, 136, 64),
             ([1000, 60, 0, 200], 136, 328, 128)]
GMM_IDS = ["ragged", "block16", "block160", "block128-tail", "block256", "block64",
           "block128-long"]
# the instance each dtype runs (csrc/grouped_mm.cu gmm_route), but for bf16
# at row tiles of a multiple of 128: wgmma + TMA
GMM_INSTANCE = {torch.float32: "scalar", torch.bfloat16: "mma.sync"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sizes,D,F,block", GMM_CASES, ids=GMM_IDS)
def test_gmm_kernels_match_plain_on_card(cuda, dtype, sizes, D, F, block):
    """gmm_fwd, gmm_dx and gmm_dw against their plain versions on the same
    inputs, both directions of the SwiGLU (D -> F as w1/w3, F -> D as w2);
    an empty expert's dW is exactly 0 and the forward's padding rows are
    exactly 0. Each case runs the instance gmm_route names: bf16 on wgmma +
    TMA at row tiles of a multiple of 128, else mma.sync; float32 scalar."""
    from tony_tpu_torch.ops.grouped_mm import (
        LAUNCHES, gmm_dw, gmm_dw_plain, gmm_dx, gmm_dx_plain, gmm_fwd, gmm_fwd_plain,
        kernel_instance, reset_launches,
    )

    tc = dtype == torch.bfloat16 and block % 128 == 0
    for name in ("gmm_fwd", "gmm_dx", "gmm_dw"):
        assert kernel_instance(name, dtype, block) == (
            "tensor cores" if tc else GMM_INSTANCE[dtype])
    tol = GMM_TOL[dtype]
    for d_in, d_out in ((D, F), (F, D)):
        x, w, tg, dy = _gmm_case(cuda, dtype, sizes, d_in, d_out, block, seed=d_in)
        G = w.shape[0]
        reset_launches()
        y, dx, dw = gmm_fwd(x, w, tg), gmm_dx(dy, w, tg), gmm_dw(x, dy, tg, G)
        torch.cuda.synchronize()
        assert LAUNCHES["gmm_fwd"] == LAUNCHES["gmm_dx"] == LAUNCHES["gmm_dw"] == 1
        assert LAUNCHES["gmm_fwd_plain"] == LAUNCHES["gmm_dw_plain"] == 0
        assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
        torch.testing.assert_close(y.float(), gmm_fwd_plain(x, w, tg).float(),
                                   atol=tol, rtol=tol)
        padding = (x == 0).all(dim=1)
        assert int(padding.sum()) == x.shape[0] - sum(sizes)
        assert torch.count_nonzero(y[padding]) == 0
        torch.testing.assert_close(dx.float(), gmm_dx_plain(dy, w, tg).float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(dw, gmm_dw_plain(x, dy, tg, G), atol=1e-4, rtol=1e-4)
        for g, n in enumerate(sizes):
            if n == 0:
                assert torch.count_nonzero(dw[g]) == 0


# an ep rank's layout at bench_moe's ep 2 (chip_smoke phase 8): its 4 local
# experts over the 16,384 gathered rows' 32,768 routes, the routes to the
# other rank's experts riding along in local group 0 at weight 0
EP_RANK_SIZES = [20480, 4096, 4096, 4096]


@pytest.mark.cuda
def test_gmm_kernels_at_an_ep_ranks_layout(cuda):
    """gmm_fwd, gmm_dx and gmm_dw in bf16 at row tile 128 on an ep rank's
    local-expert layout (bench_moe's D 1024 and F 2816, both directions)
    against their plain versions, on their tensor-core instances. dW sums
    over 20,480 rows in group 0, so its absolute tolerance is chip_smoke's
    for bench_moe's groups (1e-2, rtol 1e-4); y and dx at the bf16
    tolerance."""
    from tony_tpu_torch.ops.grouped_mm import (
        LAUNCHES, gmm_dw, gmm_dw_plain, gmm_dx, gmm_dx_plain, gmm_fwd, gmm_fwd_plain,
        kernel_instance, reset_launches,
    )

    for name in ("gmm_fwd", "gmm_dx", "gmm_dw"):
        assert kernel_instance(name, torch.bfloat16, 128) == "tensor cores"
    tol = GMM_TOL[torch.bfloat16]
    for d_in, d_out in ((1024, 2816), (2816, 1024)):
        x, w, tg, dy = _gmm_case(cuda, torch.bfloat16, EP_RANK_SIZES, d_in, d_out, 128,
                                 seed=d_out)
        reset_launches()
        y, dx, dw = gmm_fwd(x, w, tg), gmm_dx(dy, w, tg), gmm_dw(x, dy, tg, 4)
        torch.cuda.synchronize()
        assert LAUNCHES["gmm_fwd"] == LAUNCHES["gmm_dx"] == LAUNCHES["gmm_dw"] == 1
        torch.testing.assert_close(y.float(), gmm_fwd_plain(x, w, tg).float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(dx.float(), gmm_dx_plain(dy, w, tg).float(),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(dw, gmm_dw_plain(x, dy, tg, 4), atol=1e-2, rtol=1e-4)


@pytest.mark.cuda
def test_gmm_dw_is_deterministic_on_card(cuda):
    """Two bf16 gmm_dw launches on the same inputs, at row tile 128 (the
    wgmma instance: one CTA sums each dW tile in a fixed order, no
    atomics), give bit-equal dW in both directions."""
    from tony_tpu_torch.ops.grouped_mm import gmm_dw, kernel_instance

    assert kernel_instance("gmm_dw", torch.bfloat16, 128) == "tensor cores"
    for d_in, d_out in ((136, 328), (328, 136)):
        x, w, tg, dy = _gmm_case(cuda, torch.bfloat16, [1000, 60, 0, 200], d_in, d_out,
                                 128, seed=d_out)
        first, second = gmm_dw(x, dy, tg, w.shape[0]), gmm_dw(x, dy, tg, w.shape[0])
        torch.cuda.synchronize()
        assert torch.count_nonzero(first) > 0
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_grouped_matmul_autograd_on_card(cuda):
    """grouped_matmul(impl='pallas') through the custom ops on the card
    against the same entry on the CPU (plain versions), float32, within
    1e-4: value, dx and dW, one launch of each kernel."""
    from tony_tpu_torch.ops.grouped_mm import LAUNCHES, grouped_matmul, reset_launches

    x, w, tg, dy = _gmm_case("cpu", torch.float32, [60, 0, 33, 100], 96, 160, 32, seed=9)
    got = {}
    for dev in ("cpu", cuda):
        xs, ws = (t.to(dev).requires_grad_(True) for t in (x, w))
        reset_launches()
        y = grouped_matmul(xs, ws, tg.to(dev), impl="pallas")
        got[str(dev)] = (y, *torch.autograd.grad(y, (xs, ws), dy.to(dev)))
    assert LAUNCHES["gmm_fwd"] == LAUNCHES["gmm_dx"] == LAUNCHES["gmm_dw"] == 1
    for a, b in zip(got["cpu"], got["cuda"]):
        torch.testing.assert_close(b.detach().cpu(), a.detach(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_moe_block_step_has_no_host_sync_on_card(cuda):
    """One bf16 moe_block forward and backward through the kernels under
    ``torch.cuda.set_sync_debug_mode('error')``: any op that waits for the
    device (``.item()``, ``nonzero``, a data-dependent shape) raises."""
    from tony_tpu_torch.ops.grouped_mm import LAUNCHES, reset_launches
    from tony_tpu_torch.parallel.moe import MoEConfig, init_moe_params, moe_block

    cfg = MoEConfig(dim=128, ffn_dim=256, n_experts=8, gmm_impl="pallas")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_moe_params(cfg, gen, dtype=torch.bfloat16, device=cuda)
    leaves = [p.requires_grad_(True) for p in params.values()]
    x = torch.randn((4, 256, 128), generator=gen, device=cuda).to(torch.bfloat16)
    moe_block(params, x, cfg)                   # builds and loads the kernels
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_block(params, x, cfg)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux, leaves)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert LAUNCHES["gmm_fwd"] == LAUNCHES["gmm_dx"] == LAUNCHES["gmm_dw"] == 3
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert grads[0].dtype == torch.float32               # the router


# --- quantized paged decode attention and the int8 dequant-matmul -------------------


def _quantize_pool(pool: torch.Tensor, kv: str):
    """[P, Hkv, blk, hd] float -> (payload pool, [P, Hkv] float32 scales),
    one scale per block per kv head (the amax over the block / qmax)."""
    from tony_tpu_torch.serve.cache import kv_quant_spec, quantize_values

    dt, qmax = kv_quant_spec(kv)
    scale = pool.float().abs().amax(dim=(2, 3)) / qmax
    return quantize_values(pool, scale[..., None, None], qmax, dt), scale


def _dequantized(pool: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A quantized pool dequantized beforehand, as the plain version does:
    (float(payload) * its block's scale) rounded to bf16."""
    return (pool.float() * scale[..., None, None]).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("blk", [16, 64, 128])
def test_tc_quant_decode_matches_plain_on_card(cuda, kv, hd, blk):
    """Kernel 9's tensor-core instance (bf16 queries over int8 and fp8
    pools) against its plain version at G 1, 5 and 16 and rep 1, 4 and 8:
    rows of 1, S-1, S, S+1, 2S+1 and M * blk positions (S the split),
    verify rows running past the table, shared blocks, entries past a row
    naming scratch block 0. Both dequantize to the same bf16 values, so the
    tolerance is kernel 8's (DECODE_BF16_TOL). And bit for bit
    (torch.equal) kernel 8's tensor-core instance over the pools
    dequantized beforehand: the quantized instance dequantizes each tile
    into the layout kernel 8 reads and runs its math. A shape the shape
    rule refuses (G 16 at rep 8, hd 128, blk 128) raises there."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, SPLIT, check_kernel_shape, decode_attention, kernel_instance,
        paged_decode_attention_plain, reset_launches,
    )

    for G in (1, 5, 16):
        for rep in (1, 4, 8):
            q, k, v, lengths, tables = _tc_paged_case(G, hd, blk, rep, 37 * G + rep, SPLIT)
            (kq, ks), (vq, vs) = _quantize_pool(k, kv), _quantize_pool(v, kv)
            try:
                check_kernel_shape(G, 2 * rep, 2, hd, blk, 1, 2)
            except ValueError:
                with pytest.raises(ValueError, match="shared memory"):
                    decode_attention(q, kq, vq, lengths, tables=tables, k_scale=ks,
                                     v_scale=vs)
                continue
            assert kernel_instance("paged_decode_attention_quant", torch.bfloat16, hd, blk,
                                   G, rep) == "tensor cores"
            reset_launches()
            out = decode_attention(q, kq, vq, lengths, tables=tables, k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            assert LAUNCHES["paged_decode_attention_quant"] == 1
            assert LAUNCHES["paged_decode_attention"] == 0
            ref = paged_decode_attention_plain(q, kq, vq, lengths, tables,
                                               scale=1.0 / math.sqrt(hd), k_scale=ks,
                                               v_scale=vs)
            torch.testing.assert_close(out.float(), ref.float(), atol=DECODE_BF16_TOL,
                                       rtol=DECODE_BF16_TOL, msg=f"G={G} rep={rep}")
            k8 = decode_attention(q, _dequantized(kq, ks), _dequantized(vq, vs), lengths,
                                  tables=tables)
            assert torch.equal(out, k8), f"G={G} rep={rep}: differs from kernel 8"


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_tc_quant_decode_nan_scale_reaches_only_its_rows_on_card(cuda, kv):
    """A NaN K scale on the tensor-core instance (bf16 queries, the serving
    shape: rep 4, hd 128, blk 64, G 1 and the verify step's G 16): the
    block is named below row 0's length and past row 2's (its table
    entries past the length are never read, so neither is the block's
    scale). Row 0 goes non-finite; every other row equals a clean run."""
    from tony_tpu_torch.ops.decode_attention import decode_attention

    blk, hd, M = 64, 128, 8
    rng = np.random.default_rng(12)
    for G in (1, 16):
        written = np.array([300, 64, 70, 500], np.int32)
        lengths = torch.from_numpy(written + (G - 1)).cuda()
        tables = rng.permutation(np.arange(1, 1 + 4 * M)).reshape(4, M).astype(np.int32)
        bad = int(tables[0, 2])                       # row 0's positions 128..191
        reads = -(-(written + G - 1) // blk)
        tables[2, reads[2]:] = bad                    # past row 2's length only
        assert bad not in tables[1] and bad not in tables[3]
        tables = torch.from_numpy(tables).cuda()
        q = torch.from_numpy(rng.standard_normal((4, G, 32, hd)).astype(np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((1 + 4 * M, 8, blk, hd))
                                 .astype(np.float32)) for _ in range(2))
        q, k, v = (t.cuda().to(torch.bfloat16) for t in (q, k, v))
        (kq, ks), (vq, vs) = _quantize_pool(k, kv), _quantize_pool(v, kv)
        clean = decode_attention(q, kq, vq, lengths, tables=tables, k_scale=ks, v_scale=vs)
        ks[bad] = float("nan")
        out = decode_attention(q, kq, vq, lengths, tables=tables, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert not bool(torch.isfinite(out[0]).all()), f"G={G}"
        assert torch.equal(out[1:], clean[1:]), f"G={G}"


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_decode_kernel_matches_plain_on_card(cuda, kv):
    """The quantized form against its plain version on the same payloads
    and scales, G in {1, 5}, bf16 and fp32 queries. Both dequantize to the
    same values of q's dtype, so the tolerance is the unquantized kernel's
    (bf16: a few ulps of 2^-8, the output and p are rounded to bf16)."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, decode_attention, paged_decode_attention_plain, reset_launches,
    )

    for G in (1, 5):
        q, k, v, lengths, tables = (torch.from_numpy(a).to(cuda)
                                    for a in _decode_case(G, seed=7 + G))
        (kq, ks), (vq, vs) = _quantize_pool(k, kv), _quantize_pool(v, kv)
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2**-7)):
            reset_launches()
            out = decode_attention(q.to(dtype), kq, vq, lengths, tables=tables,
                                   k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            assert LAUNCHES["paged_decode_attention_quant"] == 1
            assert LAUNCHES["paged_decode_attention"] == 0
            ref = paged_decode_attention_plain(
                q.to(dtype), kq, vq, lengths, tables, scale=1.0 / math.sqrt(HD),
                k_scale=ks, v_scale=vs)
            torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["", "int8", "fp8_e4m3"], ids=["bf16", "int8", "fp8"])
def test_decode_kernel_verify_rows_on_card(cuda, kv):
    """A verify step's rows at G 16 (kernel 9 over quantized pools): each
    row's length runs up to G - 1 positions past its last written one, the
    padding of a draft shorter than G - 1. Those positions' table entries
    name scratch block 0, which holds values of its own, and row 2, written
    to the table's end, runs 15 positions past its M blocks. Every row's
    first query sees at least one position, as in the engine. Against the
    plain version on the same inputs, bf16 queries, the G 1/3 tolerance."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, decode_attention, paged_decode_attention_plain, reset_launches,
    )

    G = 16
    rng = np.random.default_rng(16)
    written = np.array([1, 16, M * BLK, 13, 45], np.int32)
    lengths = written + np.array([15, 9, 15, 3, 0], np.int32)
    need = [math.ceil(n / BLK) for n in written]
    P = 1 + sum(need)
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, M), np.int32)
    at = 0
    for b in range(B):
        tables[b, :need[b]] = ids[at:at + need[b]]
        at += need[b]
    q = rng.standard_normal((B, G, H, HD)).astype(np.float32)
    k, v = (rng.standard_normal((P, HKV, BLK, HD)).astype(np.float32) for _ in range(2))
    q, k, v, lengths, tables = (torch.from_numpy(a).to(cuda)
                                for a in (q, k, v, lengths, tables))
    q = q.to(torch.bfloat16)
    if kv:
        (k, ks), (v, vs) = _quantize_pool(k, kv), _quantize_pool(v, kv)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    reset_launches()
    out = decode_attention(q, k, v, lengths, tables=tables, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention_quant" if kv else "paged_decode_attention"] == 1
    ref = paged_decode_attention_plain(q, k, v, lengths, tables, scale=1.0 / math.sqrt(HD),
                                       k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), atol=2**-7, rtol=2**-7)


@pytest.mark.cuda
def test_quant_decode_kernel_stages_chunks_and_poisons_only_its_rows_on_card(cuda):
    """int8 pools, float32 queries at block 128, head_dim 128: the
    dequantized K+V of a block exceed the 64 KB staging budget, so blocks
    stage in two chunks. Then a NaN scale on row 0's second block: row 0
    goes non-finite, every other row stays finite and equal to before."""
    from tony_tpu_torch.ops.decode_attention import (
        _chunk, decode_attention, paged_decode_attention_plain,
    )

    blk, hd, lengths = 128, 128, np.array([200, 64, 128, 1, 300], np.int32)
    assert _chunk(blk, hd, 4) < blk
    rng = np.random.default_rng(8)
    need = [math.ceil(n / blk) for n in lengths]
    P = 1 + sum(need)
    ids = rng.permutation(np.arange(1, P))
    tables = np.zeros((len(lengths), max(need)), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[at:at + n]
        at += n
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
               for s in ((len(lengths), 1, H, hd), (P, HKV, blk, hd),
                         (P, HKV, blk, hd)))
    (kq, ks), (vq, vs) = _quantize_pool(k, "int8"), _quantize_pool(v, "int8")
    lengths_t, tables_t = (torch.from_numpy(a).to(cuda) for a in (lengths, tables))
    out = decode_attention(q, kq, vq, lengths_t, tables=tables_t, k_scale=ks, v_scale=vs)
    ref = paged_decode_attention_plain(q, kq, vq, lengths_t, tables_t,
                                       scale=1.0 / math.sqrt(hd), k_scale=ks,
                                       v_scale=vs)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    ks[int(tables[0, 1])] = float("nan")
    bad = decode_attention(q, kq, vq, lengths_t, tables=tables_t, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(bad[0]).all())
    assert bool(torch.isfinite(bad[1:]).all())
    torch.testing.assert_close(bad[1:], out[1:], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,N", [
    (8, 512, 1024),     # the decode batch, N a multiple of the CTA's 32 columns
    (8, 4096, 1000),    # ragged N: not a multiple of 16, byte-wise loads
    (11, 5000, 80),     # two slot tiles, two staged chunks of D
    (1, 64, 48),
])
def test_quant_mm_kernel_matches_plain_on_card(cuda, M, D, N):
    """The int8 dequant-matmul against its plain version, bf16 and fp32 x.
    Both round each dequantized weight to x's dtype and sum in float32 in
    another order, outputs of about unit size: fp32 within 1e-4, bf16
    within one bf16 ulp (2^-8 relative) plus the sums' difference."""
    from tony_tpu_torch.ops.quant_mm import (
        LAUNCHES, quant_matmul, quant_matmul_plain, quantize_weights, reset_launches,
    )

    rng = np.random.default_rng(M + D + N)
    x = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((D, N)) / np.sqrt(D)).astype(np.float32))
    wq, s = (t.to(cuda) for t in quantize_weights(w))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2**-7)):
        reset_launches()
        out = quant_matmul(x.to(dtype), wq, s)
        torch.cuda.synchronize()
        assert LAUNCHES == {"quant_mm": 1, "quant_mm_plain": 0}
        assert out.dtype == dtype and out.shape == (M, N)
        ref = quant_matmul_plain(x.to(dtype), wq, s)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    s[7] = float("nan")
    bad = quant_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(bad[:, 7]).any())
    assert bool(torch.isfinite(torch.cat([bad[:, :7], bad[:, 8:]], dim=1)).all())


def _qmm_case(dev, M, D, N, seed):
    from tony_tpu_torch.ops.quant_mm import quantize_weights

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((D, N)) / np.sqrt(D)).astype(np.float32))
    wq, s = (t.to(dev) for t in quantize_weights(w))
    return x.to(torch.bfloat16), wq, s


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 128, 130])
@pytest.mark.parametrize("D,N", [(4096, 1024), (200, 1001), (14336, 256), (512, 4104)],
                         ids=["split-k", "ragged", "deep", "tail-tile"])
def test_quant_mm_tensor_cores_match_plain_on_card(cuda, M, D, N):
    """The bf16 instance on the tensor cores at a single row, the decode
    step's 8 slots, 16 rows, a verify step's 128 and past them (130: a
    second row tile), over a split D (N 1024), an odd N read byte by byte
    with D off the 64-deep slice, w2's depth and a tail column tile;
    against the plain version within one bf16 ulp (2^-8 relative) plus the
    sums' order, as ``test_quant_mm_kernel_matches_plain_on_card``. A NaN
    scale stays in its column, through the split partials too."""
    from tony_tpu_torch.ops.quant_mm import (
        LAUNCHES, kernel_instance, quant_matmul, quant_matmul_plain, reset_launches,
    )

    assert kernel_instance(torch.bfloat16) == "tensor cores"
    x, wq, s = _qmm_case(cuda, M, D, N, seed=M + D + N)
    reset_launches()
    out = quant_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert LAUNCHES == {"quant_mm": 1, "quant_mm_plain": 0}
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    ref = quant_matmul_plain(x, wq, s)
    torch.testing.assert_close(out.float(), ref.float(), atol=2**-7, rtol=2**-7)
    s[7] = float("nan")
    bad = quant_matmul(x, wq, s)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(bad[:, 7]).any())
    assert bool(torch.isfinite(torch.cat([bad[:, :7], bad[:, 8:]], dim=1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D,N", [(4096, 1024), (4096, 4096), (1024, 34048)],
                         ids=["split-32", "split-8", "no-split"])
def test_quant_mm_rows_do_not_depend_on_the_batch_on_card(cuda, D, N):
    """A row's result is the same bits decoded alone, in 8 slots or in a
    verify step's 128 rows (the split of D comes from the shape and the
    card, never from M), and two launches are bit-equal."""
    from tony_tpu_torch.ops.quant_mm import quant_matmul

    x, wq, s = _qmm_case(cuda, 128, D, N, seed=D + N)
    full = quant_matmul(x, wq, s)
    again = quant_matmul(x, wq, s)
    slots = quant_matmul(x[:8].contiguous(), wq, s)
    sixteen = quant_matmul(x[8:24].contiguous(), wq, s)
    alone = quant_matmul(x[5:6].contiguous(), wq, s)
    last = quant_matmul(x[127:].contiguous(), wq, s)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    assert torch.equal(full[:8], slots)
    assert torch.equal(full[8:24], sixteen)
    assert torch.equal(full[5:6], alone)
    assert torch.equal(full[127:], last)


@pytest.mark.cuda
def test_quant_mm_kernel_instances_on_card(cuda):
    """bf16 x on the tensor cores, float32 x on the scalar body."""
    from tony_tpu_torch.ops.quant_mm import kernel_instance

    assert kernel_instance(torch.bfloat16) == "tensor cores"
    assert kernel_instance(torch.float32) == "scalar"


# --- fused cross-entropy head -------------------------------------------------------

# (N, D, V): rows not a multiple of the 128-row tile and a vocab not a
# multiple of the 128-column tile; then a vocab of three backward chunks
# (4096 columns each, the last ragged)
CE_SHAPES = [(300, 64, 1000), (200, 128, 8200)]


def _ce_case(dev, dtype, N, D, V, seed, poison=""):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    t = rng.integers(0, V, N)
    t[:3] = [0, V - 1, V - 2]
    g = rng.standard_normal(N).astype(np.float32)
    if poison == "rows":
        h[5] = np.nan
        h[N - 1, 3] = np.inf
    elif poison == "weight":
        w[2, 9] = np.nan
    h, w = (torch.from_numpy(a).to(dev).to(dtype) for a in (h, w))
    return h, w, torch.from_numpy(t).to(dev), torch.from_numpy(g).to(dev)


def _ce_close(got, want, dtype, what):
    """Nonfinite masks equal; finite values within tolerance. lse and tl
    are float32 sums of exact products (bf16 inputs too) in another order:
    1e-5 relative. dh and dW: float32, the same sums in another order; bf16,
    both round dlogits to bf16 at the same place and the result once, so a
    couple of bf16 ulps (2^-8) of the value or of the tensor's largest."""
    assert torch.equal(torch.isfinite(got), torch.isfinite(want)), what
    fin = torch.isfinite(want)
    got, want = got[fin].float(), want[fin].float()
    if what in ("lse", "tl"):
        atol, rtol = 1e-4, 1e-5
    else:
        scale = float(want.abs().max()) if want.numel() else 0.0
        rel = 2**-7 if dtype == torch.bfloat16 else 1e-4
        atol, rtol = rel * scale / 2, rel
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N,D,V", CE_SHAPES, ids=["ragged", "three-chunks"])
@pytest.mark.parametrize("poison", ["", "rows", "weight"])
def test_ce_kernels_match_plain_on_card(cuda, dtype, N, D, V, poison):
    """ce_fwd, ce_dh and ce_dw against their plain versions on the same
    inputs: ragged rows and vocab, a NaN and an inf row (only those rows go
    nonfinite), a NaN weight (every loss, dh and dW goes nonfinite)."""
    from tony_tpu_torch.ops.fused_ce import (
        LAUNCHES, ce_bwd, ce_dh_plain, ce_dw_plain, ce_fwd, ce_fwd_plain,
        dlogits_chunks, reset_launches,
    )

    h, w, t, g = _ce_case(cuda, dtype, N, D, V, seed=N + V, poison=poison)
    reset_launches()
    lse, tl = ce_fwd(h, w, t)
    dh, dw = ce_bwd(h, w, t, lse, g)
    torch.cuda.synchronize()
    chunks = len(dlogits_chunks(V))
    assert {k: v for k, v in LAUNCHES.items() if v} == {
        "ce_fwd": 1, "ce_dh": chunks, "ce_dw": chunks}
    ref_lse, ref_tl = ce_fwd_plain(h, w, t)
    _ce_close(lse, ref_lse, dtype, "lse")
    _ce_close(tl, ref_tl, dtype, "tl")
    # the backward from the plain lse, so each kernel is held on its own
    dh, dw = ce_bwd(h, w, t, ref_lse, g)
    _ce_close(dh, ce_dh_plain(h, w, t, ref_lse, g), dtype, "dh")
    _ce_close(dw, ce_dw_plain(h, w, t, ref_lse, g), dtype, "dW")
    assert dh.dtype == h.dtype and dw.dtype == w.dtype
    if poison == "rows":
        assert torch.isfinite(lse).sum() == N - 2
    elif poison == "weight":
        assert not torch.isfinite(lse).any() and not torch.isfinite(dw).any()


@pytest.mark.cuda
def test_fused_ce_pallas_autograd_on_card(cuda):
    """``fused_ce_tokens(impl="pallas")`` through autograd on the card: the
    kernels only (no plain version), and the losses and grads of the scan
    head within bf16 tolerance (the scan head's logits come from cuBLAS)."""
    from tony_tpu_torch.ops.fused_ce import LAUNCHES, fused_ce_tokens, reset_launches

    h, w, t, _ = _ce_case(cuda, torch.bfloat16, 256, 64, 5000, seed=9)
    h, t = h.reshape(2, 128, 64), t.reshape(2, 128)
    grads = {}
    for impl in ("pallas", "scan"):
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        reset_launches()
        loss = fused_ce_tokens(hh, ww, t, impl=impl)
        grads[impl] = (loss.detach(), *torch.autograd.grad(loss.mean(), (hh, ww)))
        if impl == "pallas":
            assert {k: v for k, v in LAUNCHES.items() if v} == {
                "ce_fwd": 1, "ce_dh": 2, "ce_dw": 2}
    for a, b, what in zip(grads["pallas"], grads["scan"], ("loss", "dh", "dW")):
        _ce_close(a, b, torch.bfloat16, what if what != "loss" else "lse")


@pytest.mark.cuda
def test_ce_kernel_instances_on_card(cuda):
    """The instance each CE kernel runs, as the built library's ce_route
    dispatches it: bf16 ce_fwd, ce_dh and ce_dw on wgmma + TMA, float32
    scalar."""
    from tony_tpu_torch.ops.fused_ce import kernel_instance

    assert kernel_instance("ce_dh", torch.bfloat16) == "tensor cores"
    assert kernel_instance("ce_dw", torch.bfloat16) == "tensor cores"
    assert kernel_instance("ce_fwd", torch.bfloat16) == "tensor cores"
    for name in ("ce_fwd", "ce_dh", "ce_dw"):
        assert kernel_instance(name, torch.float32) == "scalar"


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(300, 128, 1000), (1100, 64, 4104)],
                         ids=["ragged-tile", "two-column-groups"])
def test_ce_fwd_tensor_cores_on_card(cuda, N, D, V):
    """The bf16 forward on wgmma: a target in the ragged last 256-column
    tile, targets outside [0, V) (tl 0, lse unmoved), against the plain
    version (tolerance as ``_ce_close``); two launches bit-equal. The second
    shape has more tiles than the card has SMs, over two column groups of
    the forward's tile order (the last one tile wide)."""
    from tony_tpu_torch.ops.fused_ce import LAUNCHES, ce_fwd, ce_fwd_plain, reset_launches

    h, w, t, _ = _ce_case(cuda, torch.bfloat16, N, D, V, seed=N + V)
    t[3] = V - 5
    t[4], t[5], t[6] = -1, V, V + 300
    reset_launches()
    lse, tl = ce_fwd(h, w, t)
    lse2, tl2 = ce_fwd(h, w, t)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {"ce_fwd": 2}
    assert torch.equal(lse, lse2) and torch.equal(tl, tl2)
    ref_lse, ref_tl = ce_fwd_plain(h, w, t)
    _ce_close(lse, ref_lse, torch.bfloat16, "lse")
    _ce_close(tl, ref_tl, torch.bfloat16, "tl")
    assert tl[3] != 0 and bool((tl[4:7] == 0).all())


@pytest.mark.cuda
def test_ce_bwd_is_deterministic_on_card(cuda):
    """Two bf16 ce_bwd launches on the same inputs (three vocab chunks, the
    last ragged; rows off the 128-row tile) give bit-equal dh and dW: every
    output element is summed by one thread in a fixed order."""
    from tony_tpu_torch.ops.fused_ce import ce_bwd, ce_fwd_plain

    h, w, t, g = _ce_case(cuda, torch.bfloat16, 300, 200, 8200, seed=3)
    lse, _ = ce_fwd_plain(h, w, t)
    first, second = ce_bwd(h, w, t, lse, g), ce_bwd(h, w, t, lse, g)
    torch.cuda.synchronize()
    assert torch.count_nonzero(first[0]) > 0 and torch.count_nonzero(first[1]) > 0
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_ce_tail_chunk_ignores_stale_scratch_on_card(cuda, monkeypatch):
    """The dlogits scratch is as wide as a full chunk; the tail chunk (1000
    of its 4096 columns) leaves the rest holding the chunk before. Here
    that rest is NaN before the tail chunk's ce_dh launch: a dh or dW
    product that read past the chunk's width would turn NaN. Rows (333)
    off the tile."""
    from tony_tpu_torch.ops import fused_ce

    N, D, V = 333, 136, 4096 + 1000
    h, w, t, g = _ce_case(cuda, torch.bfloat16, N, D, V, seed=7)
    lse, _ = fused_ce.ce_fwd_plain(h, w, t)
    chunks = fused_ce.dlogits_chunks(V)
    assert chunks[-1] == (4096, V)
    dw_chunk = fused_ce.ce_dw_chunk
    poisoned = []

    def poison_after(h_, dl, dw_, start, stop):
        dw_chunk(h_, dl, dw_, start, stop)
        if stop < V:                  # the scratch the tail chunk inherits
            dl.fill_(float("nan"))
            poisoned.append(start)

    monkeypatch.setattr(fused_ce, "ce_dw_chunk", poison_after)
    dh, dw = fused_ce.ce_bwd(h, w, t, lse, g)
    torch.cuda.synchronize()
    assert poisoned == [0]
    assert bool(torch.isfinite(dh).all()) and bool(torch.isfinite(dw).all())
    _ce_close(dh, fused_ce.ce_dh_plain(h, w, t, lse, g), torch.bfloat16, "dh")
    _ce_close(dw, fused_ce.ce_dw_plain(h, w, t, lse, g), torch.bfloat16, "dW")


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V", [(37, 200, 4096 + 264), (129, 200, 1000), (128, 64, 4104)],
                         ids=["under-a-tile", "just-over-a-tile", "one-tile"])
def test_ce_bwd_tensor_cores_match_plain_on_card(cuda, N, D, V):
    """The bf16 backward's wgmma instances at rows under, at and just over
    the 128-row tile, D off the 64-column box and V off the 256-column
    tile, against the plain versions (tolerance as ``_ce_close``); one
    ce_dh and one ce_dw launch per vocab chunk."""
    from tony_tpu_torch.ops.fused_ce import (
        LAUNCHES, ce_bwd, ce_dh_plain, ce_dw_plain, ce_fwd_plain, dlogits_chunks,
        reset_launches,
    )

    h, w, t, g = _ce_case(cuda, torch.bfloat16, N, D, V, seed=N + D)
    lse, _ = ce_fwd_plain(h, w, t)
    reset_launches()
    dh, dw = ce_bwd(h, w, t, lse, g)
    torch.cuda.synchronize()
    chunks = len(dlogits_chunks(V))
    assert {k: v for k, v in LAUNCHES.items() if v} == {"ce_dh": chunks, "ce_dw": chunks}
    _ce_close(dh, ce_dh_plain(h, w, t, lse, g), torch.bfloat16, "dh")
    _ce_close(dw, ce_dw_plain(h, w, t, lse, g), torch.bfloat16, "dW")


# --- ring chunk matmul (kernel 14) -------------------------------------------------

# bench_1b4's ring chunks at fsdp 2 and global batch 8 x 2048 (8192 local
# rows): (label, M, K, N, a's view, b's view). Forward: gather dim 0 reads a
# column slice of x (row stride D 2048) against a row shard of wq/w1;
# gather dim 1 x (or the gate) against a column shard of wo/w2. Backward:
# dx reads the shard transposed (b K-major), dW reads the activations'
# slice transposed (a MN-major). The ragged case's N is no multiple of the
# 256-column tile (_pick_block cuts it into tiles of 8).
K14_SHAPES = [("wq", 8192, 1024, 2048, "slice", "row"), ("w1", 8192, 1024, 5504, "slice", "row"),
              ("wo", 8192, 2048, 1024, "dense", "row"), ("w2", 8192, 5504, 1024, "dense", "row"),
              ("w1-dx", 8192, 5504, 1024, "dense", "transposed"),
              ("w1-dw", 1024, 8192, 5504, "transposed", "row"),
              ("ragged", 8192, 1024, 1000, "slice", "sliced")]


def _k14_operands(M, K, N, a_view, b_view, dtype, seed):
    """a [M, K] and b [K, N] as the views the ring hands the kernel."""
    rng = np.random.default_rng(seed)
    dev = "cuda"
    if a_view == "slice":            # columns [K, 2K) of a [M, 2K] activation
        a = torch.from_numpy(rng.standard_normal((M, 2 * K), np.float32)).to(dev, dtype)[:, K:]
    elif a_view == "transposed":     # a column slice of [K, 2M], transposed
        a = torch.from_numpy(rng.standard_normal((K, 2 * M), np.float32)).to(dev, dtype)[:, :M].T
    else:
        a = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(dev, dtype)
    w = rng.standard_normal((K, N + 8), np.float32) / math.sqrt(K)
    if b_view == "transposed":       # a weight shard [N, K] read as its transpose
        b = torch.from_numpy(np.ascontiguousarray(w[:, :N].T)).to(dev, dtype).T
    elif b_view == "sliced":         # the first N columns of a wider shard
        b = torch.from_numpy(w).to(dev, dtype)[:, :N]
    else:
        b = torch.from_numpy(np.ascontiguousarray(w[:, :N])).to(dev, dtype)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("label,M,K,N,a_view,b_view", K14_SHAPES,
                         ids=[s[0] for s in K14_SHAPES])
def test_chunk_mm_matches_plain_on_card(cuda, dtype, label, M, K, N, a_view, b_view):
    """Kernel 14 against its plain version on the same views: the products
    of either input type are exact in float32 and only the order of the
    float32 sums differs (over up to 8192 terms), so within 1e-4 of the
    largest output; each launch counted once, on the instance its dtype
    routes to (bf16 on the tensor cores, fp32 scalar), and two launches
    bit-equal (no atomics, one fixed order per element)."""
    from tony_tpu_torch.ops import overlap as ov

    a, b = _k14_operands(M, K, N, a_view, b_view, dtype, seed=M + K + N)
    ov.reset_launches()
    got = ov.chunk_mm(a, b)
    again = ov.chunk_mm(a, b)
    want = ov.chunk_mm_plain(a, b)
    torch.cuda.synchronize()
    assert ov.LAUNCHES == {"chunk_mm": 2, "chunk_mm_plain": 0}
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, again)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), (label, err)
    assert ov.kernel_instance(dtype) == ("tensor cores" if dtype == torch.bfloat16
                                         else "scalar")


@pytest.mark.cuda
@pytest.mark.parametrize("gather_dim", [0, 1])
def test_ring_on_one_rank_launches_kernel_14_on_card(cuda, gather_dim):
    """The ring's autograd function on a one-rank mesh (no hops): the
    forward, dx and dW each launch kernel 14 once, through the views the
    ring reads (the backward's transposes), and match the float32
    products of the same bf16 operands within bf16 rounding of the
    outputs (2^-7 of the largest)."""
    from tony_tpu_torch.ops import overlap as ov
    from tony_tpu_torch.parallel.mesh import MeshShape, build_mesh

    rng = np.random.default_rng(gather_dim)
    x = torch.from_numpy(rng.standard_normal((2, 128, 256), np.float32)).cuda().bfloat16()
    w = torch.from_numpy(rng.standard_normal((256, 384), np.float32) / 16).cuda().bfloat16()
    dy = torch.from_numpy(rng.standard_normal((2, 128, 384), np.float32)).cuda().bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    ov.reset_launches()
    y = ov.all_gather_matmul_local(x, w, "fsdp", gather_dim, "pallas",
                                   mesh=build_mesh(MeshShape()))
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    torch.cuda.synchronize()
    assert ov.LAUNCHES == {"chunk_mm": 3, "chunk_mm_plain": 0}
    x2, dy2 = x.detach().float().reshape(-1, 256), dy.float().reshape(-1, 384)
    for got, want in ((y.reshape(-1, 384), x2 @ w.detach().float()),
                      (dx.reshape(-1, 256), dy2 @ w.detach().float().T),
                      (dw, x2.T @ dy2)):
        err = (got.float() - want).abs().max().item()
        assert err <= 2**-7 * want.abs().max().item()
