#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tony_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. card: name and power limit, torch/CUDA versions, TF32 settings (matmul
   TF32 is turned off);
2. build: every kernel source under ``csrc/``, one nvcc each, all started
   together, with nvcc's ``-Xptxas -v`` lines;
3. kernels: the paged decode kernel against its plain PyTorch version at
   Llama-3-8B decode shapes and at block and head sizes where it stages
   each block in chunks; then the flash-attention forward, dq and dk/dv
   kernels against theirs at bench_1b4's training shape, bench_moe's
   (head_dim 64), a Llama-3-8B GQA shape and one non-causal shape, in bf16
   and fp32; then (3c) the grouped-matmul forward, dx and dW kernels
   against theirs at bench_moe's shapes (33,792 buffer rows from a real
   router draw with one expert forced empty, D 1024, F 2816, 8 experts),
   in both directions of the SwiGLU and in bf16 and fp32, and one bench_moe
   MoE block forward and backward under ``set_sync_debug_mode("error")``.
   Each kernel with its time beside its bound, the plain version's time
   and one PyTorch library call's time;
4. serving: Llama-3-8B at full width (32 layers, random weights from a
   seed) through the engine, 16 requests with prefix sharing; the kernel's
   launch count must equal decode steps x layers. Then a few decode steps
   under torch.profiler: the device's busy share and the kernel's share of
   device time;
5. training: ``fit()`` on bench_1b4 at full width and depth (24 layers,
   batch 8 x 2048, the production recipe: flash attention, remat
   ``save_attn_kernel``, scan CE, bf16 Adam first moment), 10 steps from
   random weights; every loss finite and the last below the first, and
   each flash kernel launched exactly 24 x 10 times (twice as many forward
   launches would mean remat re-ran the forward kernel). Then one step
   under torch.profiler, and a 2-layer cross-check of one train step with
   the kernels against plain attention;
6. MoE training: ``fit()`` on bench_moe at full width and depth (24
   layers, 8 experts top-2, batch 8 x 2048, the same recipe with the
   grouped dispatch through the grouped-matmul kernels), 10 steps from
   random weights; every loss finite and the last below the first, each
   grouped-matmul kernel launched as often as remat implies (per layer and
   step: forward 6, dx 3, dW 3) and each flash kernel once per layer and
   step, no plain version on the card. Then one step under torch.profiler,
   and a 2-layer cross-check of one train step with the kernels against
   the plain grouped matmul.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM data sheet: HBM3 bandwidth, dense peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# bf16: the output is rounded to bf16 and the kernel rounds p to bf16
# before P.V, so it cannot be held closer than a couple of bf16 ulps (2^-8
# relative); fp32: only the order of the sums differs
TOLERANCE = {torch.bfloat16: (2**-7, 2**-7), torch.float32: (1e-5, 1e-4)}
# flash kernels against their plain versions on the same inputs. bf16: both
# round their outputs to bf16, and the forward rounds p at its running max
# where the plain version rounds it at the row's max, so a few ulps of 2^-8;
# fp32: the same float32 sums in another order over up to 2048 positions
FLASH_TOLERANCE = {torch.bfloat16: (2**-6, 2**-6), torch.float32: (1e-4, 1e-4)}
# grouped matmul against its plain version on the same inputs. y and dx,
# bf16: both round float32 sums to bf16 (2^-8 relative) and the sums run in
# another order, so an ulp or two; fp32: the same float32 sums over up to
# 2816 terms in another order. dW is float32 from either input type, sums
# of up to a group's ~5,000 row products that reach a few hundred, so its
# absolute tolerance is larger
GMM_TOLERANCE = {torch.bfloat16: (2**-6, 2**-6), torch.float32: (1e-4, 1e-4)}
GMM_DW_TOLERANCE = (1e-2, 1e-4)
KERNEL_SOURCES = ("paged_decode_attention", "flash_attention", "grouped_mm")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median device time of one call, each run after the L2 cache is
    flushed (the engine calls the kernel once per layer, so it finds the
    pools cold), timed with CUDA events."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


# --- phase 3: kernels against their plain versions ----------------------------


def decode_case(G: int, dtype: torch.dtype, flush: torch.Tensor, *,
                blk: int = 64, hd: int = 128) -> dict:
    from tony_tpu_torch.ops.decode_attention import (
        _chunk, decode_attention, paged_decode_attention_plain,
    )

    B, H, Hkv = 8, 32, 8
    dev = "cuda"
    rng = np.random.default_rng(100 + G)
    lengths_np = np.array([2048, 5, 64, 1000, 1537, 700, 133, 1999], np.int32)
    M = 2048 // blk
    need = [math.ceil(n / blk) for n in lengths_np]
    P = 1 + sum(need)
    perm = rng.permutation(np.arange(1, P))
    tables_np = np.zeros((B, M), np.int32)          # past the length: scratch
    at = 0
    for b in range(B):
        tables_np[b, :need[b]] = perm[at:at + need[b]]
        at += need[b]
    tables_np[7, :8] = tables_np[0, :8]             # rows 0 and 7 share blocks
    gen = torch.Generator(device=dev).manual_seed(G)
    q = torch.randn((B, G, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((P, Hkv, blk, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((P, Hkv, blk, hd), generator=gen, device=dev).to(dtype)
    lengths = torch.as_tensor(lengths_np, device=dev)
    tables = torch.as_tensor(tables_np, device=dev)
    scale = 1.0 / math.sqrt(hd)

    out = decode_attention(q, k, v, lengths, tables=tables)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q.float(), k.float(), v.float(), lengths,
                                       tables, scale=scale)
    err = (out.float() - ref).abs()
    atol, rtol = TOLERANCE[dtype]
    if not torch.isfinite(out).all() or bool((err > atol + rtol * ref.abs()).any()):
        raise AssertionError(
            f"paged_decode_attention G={G} {dtype}: max |err| "
            f"{err.max().item():.3e} over atol={atol} rtol={rtol}"
        )

    # library yardstick: SDPA on the gathered, repeat-expanded K/V (the
    # gather is not timed; the port never calls SDPA)
    T = M * blk
    kg = k[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, hd)
    vg = v[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, hd)
    kg = kg.repeat_interleave(H // Hkv, dim=1)
    vg = vg.repeat_interleave(H // Hkv, dim=1)
    qs = q.permute(0, 2, 1, 3).contiguous()                  # [B, H, G, hd]
    lim = lengths.long()[:, None] - (G - 1) + torch.arange(G, device=dev)
    mask = (torch.arange(T, device=dev)[None, None, :] < lim[:, :, None])[:, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, kg, vg, attn_mask=mask)
    lib_err = (sdpa().permute(0, 2, 1, 3).float() - ref).abs().max().item()

    ms = time_ms(lambda: decode_attention(q, k, v, lengths, tables=tables), flush)
    plain_ms = time_ms(lambda: paged_decode_attention_plain(
        q, k, v, lengths, tables, scale=scale), flush)
    library_ms = time_ms(sdpa, flush)

    itemsize = q.element_size()
    # K/V bytes: each physical block's positions that some row needs, once
    # (rows 0 and 7 share blocks: their positions are read once, not twice)
    used: dict[int, int] = {}
    for b in range(B):
        for j in range(need[b]):
            pid = int(tables_np[b, j])
            used[pid] = max(used.get(pid, 0), min(blk, int(lengths_np[b]) - j * blk))
    kv_bytes = 2 * sum(used.values()) * Hkv * hd * itemsize
    io_bytes = 2 * q.numel() * itemsize + lengths.numel() * 4 + sum(need) * 4
    # QK^T and P.V, 2 operations each per (query, head, position, dim);
    # query g of row b attends len_b - (G - 1) + g positions
    attended = sum(int(n) - (G - 1) + g for n in lengths_np for g in range(G))
    ops = 4 * attended * H * hd
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "G": G, "dtype": str(dtype).replace("torch.", ""), "blk": blk, "hd": hd,
        "chunk": _chunk(blk, hd, itemsize),
        "max_abs_err": err.max().item(), "sdpa_max_abs_err": lib_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": kv_bytes + io_bytes,
    }


# --- phase 4: serving at full width -------------------------------------------


def serve_phase() -> dict:
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.ops.decode_attention import LAUNCHES, reset_launches
    from tony_tpu_torch.serve import Engine, Request, ServeConfig

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"serve: Llama-3-8B {cfg.n_params:,} params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    sv = dict(slots=8, max_len=2048, kv_block=64, prefix=True)
    engine = Engine(params, cfg, ServeConfig(**sv), device="cuda")

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, 16)
    lens[6:8] = np.maximum(lens[6:8], 300)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    # requests 6 and 7 share a 256-token prefix; they are admitted back to
    # back, because the default 64 MB store budget holds only 8 blocks of
    # 8 MiB at this width and older prompts' blocks are evicted
    shared = rng.integers(0, cfg.vocab_size, 256)
    prompts[6][:256] = shared
    prompts[7][:256] = shared
    reqs = [
        Request(prompt=p, max_new_tokens=64) if i % 2 == 0 else
        Request(prompt=p, max_new_tokens=64, temperature=0.8, top_k=50, rng=1000 + i)
        for i, p in enumerate(prompts)
    ]

    # warm-up (cuBLAS handles, allocator), then counters to zero
    engine.run([Request(prompt=rng.integers(0, cfg.vocab_size, 32), max_new_tokens=4)])
    engine.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids = [engine.submit(r) for r in reqs]
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    m = engine.metrics

    if len(out) != len(reqs):
        raise AssertionError(f"{len(out)} of {len(reqs)} requests completed")
    for rid, c in out.items():
        if len(c.tokens) != 64 or c.finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(c.tokens)} tokens, "
                                 f"{c.finish_reason!r}")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: token outside the vocabulary")
    want = m.decode_steps * cfg.n_layers
    if launches["paged_decode_attention"] != want or want == 0:
        raise AssertionError(f"kernel launches {launches} != decode steps "
                             f"{m.decode_steps} x {cfg.n_layers} layers")
    if launches["paged_decode_attention_plain"] != 0:
        raise AssertionError("the plain decode attention ran on the card")
    if m.prefix_hit_tokens < 256:
        raise AssertionError(f"prefix reuse did not fire ({m.prefix_hit_tokens})")
    peak = torch.cuda.max_memory_allocated()

    solo = generate(params, prompts[0][None], cfg, max_new_tokens=64,
                    device="cuda", serve=sv)
    if solo[0, len(prompts[0]):].tolist() != out[ids[0]].tokens:
        raise AssertionError("generate() differs from the engine on request 0")
    result = {
        "requests": len(out), "decode_steps": m.decode_steps,
        "launches": launches["paged_decode_attention"],
        "decode_tokens_per_s": m.decode_tokens_per_sec,
        "mean_ttft_s": m.ttft_avg_s,
        "mean_decode_step_ms": m.decode_s / m.decode_steps * 1e3,
        "prefix_hit_tokens": m.prefix_hit_tokens,
        "wall_s": wall, "peak_allocated_gb": peak / 1e9,
    }
    return {**result, **decode_breakdown(engine, cfg, rng)}


def decode_breakdown(engine, cfg, rng, steps: int = 8) -> dict:
    """Where a full decode step's time goes, at 8 live slots of ~512
    positions: ``steps`` steps timed on the host clock, then ``steps`` more
    under torch.profiler for the device time by kernel. The busy share is
    device time per step over the unprofiled step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.serve import Request

    for _ in range(engine.serve.slots):
        engine.submit(Request(prompt=rng.integers(0, cfg.vocab_size, 512),
                              max_new_tokens=2 * steps + 2))
    engine.step()                                 # admit all, first decode step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    engine.run()
    # device-side entries only: a CPU op's entry repeats its kernels' time
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in dev) / steps
    attn_us = sum(e.self_device_time_total for e in dev
                  if "paged_decode_kernel" in e.key) / steps
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  profile: {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    if device_us == 0:
        raise AssertionError("torch.profiler recorded no device time")
    return {
        "profile_step_ms": step_s * 1e3,
        "profile_device_ms": device_us / 1e3,
        "profile_device_busy": device_us / 1e6 / step_s,
        "profile_attention_ms": attn_us / 1e3,
        "profile_attention_share": attn_us / device_us,
    }


# --- phase 3b: flash attention kernels against their plain versions -----------

# (label, B, S, H, Hkv, hd, causal)
FLASH_SHAPES = (
    ("bench_1b4", 8, 2048, 16, 16, 128, True),
    ("bench_moe", 8, 2048, 16, 16, 64, True),
    ("llama3_8b_gqa", 2, 2048, 32, 8, 128, True),
    ("full", 2, 2048, 16, 16, 128, False),
)


def _pairs(B: int, S: int, H: int, causal: bool) -> int:
    """(query, key) pairs attended, over every batch row and head."""
    return B * H * (S * (S + 1) // 2 if causal else S * S)


def flash_cases(dtype: torch.dtype, flush: torch.Tensor, label: str, B: int,
                S: int, H: int, Hkv: int, hd: int, causal: bool) -> list[dict]:
    """flash_fwd, flash_dq and flash_dkv at one shape: each against its
    plain version on the same inputs, its time, its bound, the plain
    version's time, and SDPA's forward / backward time as the library
    yardstick (the port never calls SDPA)."""
    from tony_tpu_torch.ops.attention import (
        _delta, _dkv, _dq, _fwd, flash_dkv_plain, flash_dq_plain, flash_fwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(S + H + Hkv)
    q, do = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = 1.0 / math.sqrt(hd)
    out, lse = _fwd(q, k, v, scale, causal)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    delta = _delta(do, ref_out)
    got = {
        "flash_fwd": (out, lse),
        "flash_dq": (_dq(q, k, v, do, ref_lse, delta, scale, causal),),
        "flash_dkv": _dkv(q, k, v, do, ref_lse, delta, scale, causal),
    }
    torch.cuda.synchronize()
    want = {
        "flash_fwd": (ref_out, ref_lse),
        "flash_dq": (flash_dq_plain(q, k, v, do, ref_lse, delta, scale=scale,
                                    causal=causal),),
        "flash_dkv": flash_dkv_plain(q, k, v, do, ref_lse, delta, scale=scale,
                                     causal=causal),
    }
    runs = {
        "flash_fwd": (lambda: _fwd(q, k, v, scale, causal),
                      lambda: flash_fwd_plain(q, k, v, scale=scale, causal=causal)),
        "flash_dq": (lambda: _dq(q, k, v, do, ref_lse, delta, scale, causal),
                     lambda: flash_dq_plain(q, k, v, do, ref_lse, delta, scale=scale,
                                            causal=causal)),
        "flash_dkv": (lambda: _dkv(q, k, v, do, ref_lse, delta, scale, causal),
                      lambda: flash_dkv_plain(q, k, v, do, ref_lse, delta,
                                              scale=scale, causal=causal)),
    }
    # library yardstick: SDPA on [B, H, S, hd] views, forward and backward
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, ks, vs, is_causal=causal, scale=scale, enable_gqa=Hkv != H)
    sdpa_out = sdpa()
    dos = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qs, ks, vs), dos, retain_graph=True)
    library = {"flash_fwd": time_ms(sdpa, flush, reps=10)}
    library["flash_dq"] = library["flash_dkv"] = time_ms(sdpa_bwd, flush, reps=10)

    item = q.element_size()
    qb, kb = q.numel() * item, k.numel() * item
    rows = B * H * S * 4                       # one float32 per (row, head)
    pairs = _pairs(B, S, H, causal)
    # matmuls over the attended pairs, 2 * hd operations each: fwd QK^T and
    # P.V; dq QK^T, dO.V^T, dS.K; dk/dv QK^T, dO.V^T, P^T.dO, dS^T.Q
    work = {
        "flash_fwd": (4 * hd * pairs, 2 * qb + 2 * kb + rows),
        "flash_dq": (6 * hd * pairs, 2 * qb + 2 * kb + 2 * rows + qb),
        "flash_dkv": (8 * hd * pairs, 2 * qb + 2 * kb + 2 * rows + 2 * kb),
    }
    atol, rtol = FLASH_TOLERANCE[dtype]
    cases = []
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        errs, bad = [], False
        for g, w in zip(got[name], want[name]):
            e = (g.float() - w.float()).abs()
            errs.append(e.max().item())
            bad |= not bool(torch.isfinite(g).all()) or bool(
                (e > atol + rtol * w.float().abs()).any())
        ops, nbytes = work[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
        kernel, plain = runs[name]
        cases.append({
            "name": name, "shape": label, "dtype": str(dtype).replace("torch.", ""),
            "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd, "causal": causal,
            "max_abs_err": max(errs), "ok": not bad, "atol": atol, "rtol": rtol,
            "ms": time_ms(kernel, flush, reps=10),
            "plain_ms": time_ms(plain, flush, reps=5),
            "library_ms": library[name],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops": ops, "bytes": nbytes,
        })
    return cases


# --- phase 3c: grouped matmul kernels against their plain versions ------------

# bench_moe's MoE layer: 8 x 2048 tokens, top-2 of 8 experts, row tile 128
MOE_T, MOE_D, MOE_F, MOE_E, MOE_K, MOE_BLOCK = 16384, 1024, 2816, 8, 2, 128


def gmm_inputs() -> dict:
    """bench_moe's grouped-matmul operands, float32 on the card: a real
    router draw (normal activations, a float32 router scaled as
    ``init_moe_params`` scales it) with expert 7 forced empty, its top-2
    routes laid out as the MoE block lays them out (``route_rows``), the
    buffer's routed rows normal and its padding rows zero; the weights and
    the output grads of both SwiGLU directions (w1/w3: D -> F, w2: F -> D)."""
    from tony_tpu_torch.parallel.moe import (
        MoEConfig, _route_tokens, _top_k_select, route_rows,
    )

    T, D, F, E = MOE_T, MOE_D, MOE_F, MOE_E
    gen = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    flat = randn(T, D)
    logits = flat @ (randn(D, E) / math.sqrt(D))
    logits[:, E - 1] = -1e9                     # expert 7 receives no route
    sel = _top_k_select(torch.softmax(logits, dim=-1),
                        MoEConfig(dim=D, ffn_dim=F, n_experts=E, top_k=MOE_K))[0]
    dst, sizes, tile_group = route_rows(sel.reshape(-1), E, MOE_BLOCK)
    N, R = tile_group.shape[0] * MOE_BLOCK, dst.shape[0]

    def rows(src: torch.Tensor) -> torch.Tensor:
        return src.new_zeros((N, src.shape[1])).index_copy(0, dst, src)

    groups = torch.arange(E, dtype=torch.int32, device="cuda")
    ends = torch.searchsorted(tile_group, groups, right=True) * MOE_BLOCK
    return {
        "sizes": sizes.tolist(), "tile_group": tile_group, "rows": N, "routes": R,
        # group g ends at offs[g] in the buffer (torch._grouped_mm's offsets)
        "offs": ends.to(torch.int32),
        "w1": (rows(flat.index_select(0, _route_tokens(T, MOE_K, "cuda"))),
               randn(E, D, F) / math.sqrt(D), rows(randn(R, F))),
        "w2": (rows(randn(R, F)), randn(E, F, D) / math.sqrt(F), rows(randn(R, D))),
    }


def grouped_library(name: str, a, w, dy, offs):
    """``torch._grouped_mm`` computing the same function as ``name`` (the
    yardstick; the port never calls it), or None and the reason."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no torch._grouped_mm"
    fn = {"gmm_fwd": lambda: torch._grouped_mm(a, w, offs),
          "gmm_dx": lambda: torch._grouped_mm(dy, w.transpose(-2, -1), offs),
          "gmm_dw": lambda: torch._grouped_mm(a.t(), dy, offs)}[name]
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
        return None, f"torch._grouped_mm refused: {str(e).strip().splitlines()[0][:100]}"
    return fn, ""


def gmm_cases(dtype: torch.dtype, flush: torch.Tensor, inputs: dict) -> list[dict]:
    """gmm_fwd, gmm_dx and gmm_dw in both SwiGLU directions at one dtype:
    each against its plain version on the same inputs, its time, its
    bound, the plain version's time and torch._grouped_mm's."""
    from tony_tpu_torch.ops.grouped_mm import (
        gmm_dw, gmm_dw_plain, gmm_dx, gmm_dx_plain, gmm_fwd, gmm_fwd_plain,
    )

    tg, offs, N, R = inputs["tile_group"], inputs["offs"], inputs["rows"], inputs["routes"]
    empty = [g for g, n in enumerate(inputs["sizes"]) if n == 0]
    if not empty:
        raise AssertionError(f"no empty expert in the draw: {inputs['sizes']}")
    cases = []
    for label in ("w1", "w2"):
        a, w, dy = (t.to(dtype) for t in inputs[label])
        E, d_in, d_out = w.shape
        runs = {
            "gmm_fwd": (lambda: gmm_fwd(a, w, tg), lambda: gmm_fwd_plain(a, w, tg)),
            "gmm_dx": (lambda: gmm_dx(dy, w, tg), lambda: gmm_dx_plain(dy, w, tg)),
            "gmm_dw": (lambda: gmm_dw(a, dy, tg, E),
                       lambda: gmm_dw_plain(a, dy, tg, E)),
        }
        item = a.element_size()
        # the routed rows' products, 2 operations each (padding rows are
        # zero and need none); each input read once, each output written once
        ops = 2 * R * d_in * d_out
        weights = E * d_in * d_out * item
        nbytes = {"gmm_fwd": N * d_in * item + weights + N * d_out * item,
                  "gmm_dx": N * d_out * item + weights + N * d_in * item,
                  "gmm_dw": (N * d_in + N * d_out) * item + E * d_in * d_out * 4}
        for name, (kernel, plain) in runs.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            atol, rtol = GMM_DW_TOLERANCE if name == "gmm_dw" else GMM_TOLERANCE[dtype]
            err = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got).all()) and not bool(
                (err > atol + rtol * want.float().abs()).any())
            if name == "gmm_dw":            # a zero-load expert's dW is 0
                ok &= int(torch.count_nonzero(got[empty])) == 0
            lib, lib_note = grouped_library(name, a, w, dy, offs)
            lib_err = None
            if lib is not None:
                lib_err = (lib().float() - want.float()).abs().max().item()
            max_err = err.max().item()
            del got, want, err
            bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
            cases.append({
                "name": name, "direction": label, "dtype": str(dtype).replace("torch.", ""),
                "rows": N, "routes": R, "d_in": d_in, "d_out": d_out, "experts": E,
                "max_abs_err": max_err, "ok": ok, "atol": atol, "rtol": rtol,
                "ms": time_ms(kernel, flush, reps=10),
                "plain_ms": time_ms(plain, flush, reps=3),
                "library_ms": time_ms(lib, flush, reps=10) if lib else None,
                "library_max_abs_err": lib_err, "library_note": lib_note,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "ops": ops, "bytes": nbytes[name],
            })
    return cases


def moe_sync_check() -> dict:
    """One bench_moe MoE block (16,384 tokens, bf16) forward and backward
    through the kernels under ``set_sync_debug_mode("error")``: any op on
    the path that waits for the device raises."""
    from tony_tpu_torch.ops.grouped_mm import LAUNCHES, reset_launches
    from tony_tpu_torch.parallel.moe import MoEConfig, init_moe_params, moe_block

    cfg = MoEConfig(dim=MOE_D, ffn_dim=MOE_F, n_experts=MOE_E, top_k=MOE_K,
                    group_block=MOE_BLOCK, gmm_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_moe_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    leaves = [p.requires_grad_(True) for p in params.values()]
    x = torch.randn((8, MOE_T // 8, MOE_D), generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe_block(params, x, cfg)
        grads = torch.autograd.grad((y.float() ** 2).mean() + aux, leaves)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    if launches != {"gmm_fwd": 3, "gmm_dx": 3, "gmm_dw": 3}:
        raise AssertionError(f"moe_block launches {launches}")
    aux = float(aux.detach())
    if not all(bool(torch.isfinite(g).all()) for g in grads) or not math.isfinite(aux):
        raise AssertionError("non-finite moe_block grads or aux")
    return {"aux": aux, "launches": launches}


# --- phase 5: training at full width --------------------------------------------

TRAIN_STEPS = 10


def dense_train_config():
    from tony_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.bench_1b4(attention_impl="flash", remat=True,
                                 remat_policy="save_attn_kernel", ce_impl="scan")


def train_phase(card: str) -> dict:
    """fit() on bench_1b4 with the production recipe; each step's metrics
    through ``on_metrics``; the flash kernels' launches over the run."""
    from tony_tpu_torch.models.llama import train_flops_per_token
    from tony_tpu_torch.ops.attention import LAUNCHES, reset_launches
    from tony_tpu_torch.ops.fused_ce import f32_matmul_route
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = dense_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    steps: list[dict] = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final = fit(FitConfig(model=cfg, data=data, steps=TRAIN_STEPS, log_every=1,
                          lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
                          on_metrics=steps.append), device="cuda")
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    losses = [m["loss"] for m in steps]
    for m in steps:
        log(f"train step {m['step']:2d}: loss {m['loss']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms  [{card}]")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    want = cfg.n_layers * TRAIN_STEPS
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, not "
                                 f"{cfg.n_layers} layers x {TRAIN_STEPS} steps")
    if any(launches[f"{n}_plain"] for n in ("flash_fwd", "flash_dq", "flash_dkv")):
        raise AssertionError(f"a plain flash version ran on the card: {launches}")
    timed = [m["step_time_s"] for m in steps[2:]]      # 2 warm-up steps
    step_s = sum(timed) / len(timed)
    tokens = data.global_batch * data.seq_len
    flops = train_flops_per_token(cfg, data.seq_len)
    return {
        "losses": losses, "launches": launches, "wall_s": wall, "final": final,
        "mean_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": tokens / step_s * flops / 989e12, "flops_per_token": flops,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ce_matmul": f32_matmul_route("cuda", cfg.dtype),
        **train_profile(cfg, data, FLASH_KERNELS),
    }


def train_profile(cfg, data, kernels: tuple[str, ...]) -> dict:
    """One train step on the host clock, then one under torch.profiler:
    the device's busy share (device time over the unprofiled step's wall
    time) and each named kernel's share of device time."""
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.train.data import make_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    opt = default_optimizer(lr=3e-4, warmup_steps=2, decay_steps=10,
                            mu_dtype="bfloat16")
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    step = make_train_step(cfg, opt)
    batches = make_batches(dataclasses.replace(data, prefetch=0), device="cuda")
    for _ in range(2):
        state, m = step(state, *next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, *next(batches))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, *next(batches))
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in dev)
    if device_us == 0:
        raise AssertionError("torch.profiler recorded no device time")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  profile: {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
            f"{e.key[:90]}")
    share = {}
    for name in kernels:
        us = sum(e.self_device_time_total for e in dev if f"{name}_kernel" in e.key)
        share[name] = us / device_us
    return {
        "profile_step_ms": step_s * 1e3, "profile_device_ms": device_us / 1e3,
        "profile_device_busy": device_us / 1e6 / step_s, "profile_share": share,
    }


def model_crosscheck(card: str, cfg, field: str, kernel: str, plain: str) -> dict:
    """``cfg`` at 2 layers: one train step with ``field=kernel`` (the CUDA
    kernels) against one with ``field=plain``, from the same params and
    batch. Loss and grad norm agree within bf16 tolerance: both run bf16
    activations, and the two round at other places."""
    from tony_tpu_torch.models.llama import init_params
    from tony_tpu_torch.train.data import DataConfig, synthetic_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step, tree_map,
    )

    cfg = dataclasses.replace(cfg, n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    inputs, targets = (t.cuda() for t in next(synthetic_batches(
        DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size))))
    out = {}
    for impl in (kernel, plain):
        c = dataclasses.replace(cfg, **{field: impl})
        opt = default_optimizer(mu_dtype="bfloat16")
        state = make_train_state(c, opt, params=tree_map(lambda p: p.detach().clone(),
                                                        params))
        _, m = make_train_step(c, opt)(state, inputs, targets)
        out[impl] = (float(m["loss"]), float(m["grad_norm"]))
        del state
    (lk, gk), (lp, gp) = out[kernel], out[plain]
    log(f"crosscheck 2 layers, {field}: loss {kernel} {lk:.5f} {plain} {lp:.5f}; "
        f"grad_norm {kernel} {gk:.5f} {plain} {gp:.5f}  [{card}]")
    # bf16 activations: a few ulps of 2^-8 on the loss, 2% on the grad norm
    if abs(lk - lp) > 2e-2 or abs(gk - gp) > 2e-2 * abs(gp):
        raise AssertionError(f"{kernel} and {plain} disagree: {out}")
    return {"loss_kernel": lk, "loss_plain": lp, "grad_norm_kernel": gk,
            "grad_norm_plain": gp}


# --- phase 6: MoE training at full width ----------------------------------------

MOE_TRAIN_STEPS = 10
GMM_KERNELS = ("gmm_fwd", "gmm_dx", "gmm_dw")
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# launches per layer and step under remat save_attn_kernel: the three
# grouped matmuls run in the forward and again in the backward's
# recompute, their dx and dW once; the flash forward's residuals are saved
MOE_LAUNCHES_PER_LAYER_STEP = {"gmm_fwd": 6, "gmm_dx": 3, "gmm_dw": 3,
                               "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


def moe_train_config():
    from tony_tpu_torch.models.llama import LlamaConfig

    # bench.py's moe_bench 'grouped_pallas' variant with the preset's own 8
    # experts: flash attention, remat save_attn_kernel, scan CE
    return LlamaConfig.bench_moe(
        attention_impl="flash", remat=True, remat_policy="save_attn_kernel",
        ce_impl="scan", moe_dispatch="grouped", moe_gmm_impl="pallas",
        moe_group_block=128, moe_aux_coef=0.01)


def train_moe_phase(card: str) -> dict:
    """fit() on bench_moe through the grouped-matmul and flash kernels;
    each step's metrics through ``on_metrics``; the kernels' launches."""
    from tony_tpu_torch.models.llama import train_flops_per_token
    from tony_tpu_torch.ops import attention, grouped_mm
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = moe_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    steps: list[dict] = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launches()
    grouped_mm.reset_launches()
    t0 = time.perf_counter()
    final = fit(FitConfig(model=cfg, data=data, steps=MOE_TRAIN_STEPS, log_every=1,
                          lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
                          on_metrics=steps.append), device="cuda")
    wall = time.perf_counter() - t0
    launches = {**attention.LAUNCHES, **grouped_mm.LAUNCHES}
    losses = [m["loss"] for m in steps]
    for m in steps:
        log(f"moe step {m['step']:2d}: loss {m['loss']:.4f} aux {m['aux']:.5f} "
            f"grad_norm {m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms  [{card}]")
    if len(losses) != MOE_TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    for name, per in MOE_LAUNCHES_PER_LAYER_STEP.items():
        want = per * cfg.n_layers * MOE_TRAIN_STEPS
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, not {per} x "
                                 f"{cfg.n_layers} layers x {MOE_TRAIN_STEPS} steps")
    if any(launches[f"{n}_plain"] for n in MOE_LAUNCHES_PER_LAYER_STEP):
        raise AssertionError(f"a plain version ran on the card: {launches}")
    timed = [m["step_time_s"] for m in steps[2:]]      # 2 warm-up steps
    step_s = sum(timed) / len(timed)
    tokens = data.global_batch * data.seq_len
    flops = train_flops_per_token(cfg, data.seq_len)
    return {
        "losses": losses, "aux": [m["aux"] for m in steps], "launches": launches,
        "wall_s": wall, "final": final, "mean_step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "mfu": tokens / step_s * flops / 989e12,
        "flops_per_token": flops, "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        **train_profile(cfg, data, FLASH_KERNELS + GMM_KERNELS),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from tony_tpu_torch.ops._build import load

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; matmul TF32 set off")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = list(pool.map(load, KERNEL_SOURCES))
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(builds)} sources in "
        "parallel")
    for name, built in zip(KERNEL_SOURCES, builds):
        log(f"  {name}.cu: nvcc {built.seconds:.1f} s -> {built.path.name}")
        for line in built.log.strip().splitlines():
            if "Compile time" not in line:
                log(f"    {line}")

    flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device="cuda")
    cases = []
    # the serving shapes (blk 64, hd 128: each block staged whole), then two
    # whose K+V per block exceed the 64 KB staging budget, so the kernel
    # stages each block in chunks
    shapes = [(torch.bfloat16, 1, 64, 128), (torch.bfloat16, 5, 64, 128),
              (torch.float32, 1, 64, 128), (torch.float32, 5, 64, 128),
              (torch.float32, 1, 128, 128), (torch.float32, 5, 128, 256)]
    for dtype, G, blk, hd in shapes:
        c = decode_case(G, dtype, flush, blk=blk, hd=hd)
        cases.append(c)
        log(f"kernel paged_decode_attention G={G} {c['dtype']} blk={blk} hd={hd} "
            f"chunk={c['chunk']}: max|err| {c['max_abs_err']:.3e}  "
            f"{c['ms'] * 1e3:.1f} us  (bound {c['bound_ms'] * 1e3:.1f} us by "
            f"{c['bound_by']}, {c['bytes'] / 1e6:.2f} MB)  plain "
            f"{c['plain_ms'] * 1e3:.1f} us  sdpa {c['library_ms'] * 1e3:.1f} us "
            f"(max|err| {c['sdpa_max_abs_err']:.3e})  [{card}]")
    if not any(c["chunk"] < c["blk"] for c in cases):
        raise AssertionError("no case staged a block in chunks")

    flash = []
    for label, B, S, H, Hkv, hd, causal in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for c in flash_cases(dtype, flush, label, B, S, H, Hkv, hd, causal):
                flash.append(c)
                log(f"kernel {c['name']} {label} {c['dtype']} B={B} S={S} H={H} "
                    f"Hkv={Hkv} hd={hd} causal={causal}: max|err| "
                    f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} "
                    f"atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms']:.3f} ms  "
                    f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: "
                    f"{c['ops']:.4g} ops, {c['bytes'] / 1e6:.1f} MB)  plain "
                    f"{c['plain_ms']:.3f} ms  sdpa {c['library_ms']:.3f} ms  [{card}]")
    bad = [c for c in flash if not c["ok"]]
    if bad:
        raise AssertionError(f"flash kernels over tolerance: "
                             f"{[(c['name'], c['shape'], c['dtype']) for c in bad]}")

    inputs = gmm_inputs()
    log(f"grouped matmul inputs: {MOE_T} tokens x top-{MOE_K} = {inputs['routes']} "
        f"routes in {inputs['rows']} buffer rows; routes per expert {inputs['sizes']}")
    gmm = []
    for dtype in (torch.bfloat16, torch.float32):
        for c in gmm_cases(dtype, flush, inputs):
            gmm.append(c)
            lib = (f"{c['library_ms']:.3f} ms (max|err| {c['library_max_abs_err']:.3e})"
                   if c["library_ms"] is not None else f"- ({c['library_note']})")
            log(f"kernel {c['name']} {c['direction']} {c['dtype']} rows={c['rows']} "
                f"{c['d_in']}->{c['d_out']} E={c['experts']}: max|err| "
                f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} "
                f"atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms']:.3f} ms  "
                f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: {c['ops']:.4g} "
                f"ops, {c['bytes'] / 1e6:.1f} MB)  plain {c['plain_ms']:.3f} ms  "
                f"torch._grouped_mm {lib}  [{card}]")
    bad = [c for c in gmm if not c["ok"]]
    if bad:
        raise AssertionError(f"grouped matmul kernels over tolerance: "
                             f"{[(c['name'], c['direction'], c['dtype']) for c in bad]}")
    del inputs, flush
    torch.cuda.empty_cache()
    sync = moe_sync_check()
    log(f"moe_block at bench_moe's shape under set_sync_debug_mode('error'): no "
        f"host sync; launches {sync['launches']}, aux {sync['aux']:.5f}  [{card}]")

    s = serve_phase()
    log(f"serve: {s['requests']} requests, {s['decode_steps']} decode steps, "
        f"{s['launches']} kernel launches; decode {s['decode_tokens_per_s']:.1f} "
        f"tok/s, mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, mean decode step "
        f"{s['mean_decode_step_ms']:.2f} ms, prefix hit {s['prefix_hit_tokens']} "
        f"tokens, peak allocated {s['peak_allocated_gb']:.2f} GB, wall "
        f"{s['wall_s']:.1f} s  [{card}]")
    log(f"decode step (8 slots, ~512 positions): {s['profile_step_ms']:.2f} ms "
        f"wall, {s['profile_device_ms']:.2f} ms device (busy "
        f"{s['profile_device_busy']:.1%}), decode attention "
        f"{s['profile_attention_ms']:.2f} ms = "
        f"{s['profile_attention_share']:.1%} of device time  [{card}]")
    torch.cuda.empty_cache()

    t = train_phase(card)
    log(f"train bench_1b4 (24 layers, 8 x 2048, flash + save_attn_kernel + scan "
        f"CE, mu bf16): {TRAIN_STEPS} steps, loss {t['losses'][0]:.4f} -> "
        f"{t['losses'][-1]:.4f}; mean step {t['mean_step_ms']:.1f} ms over steps "
        f"3-{TRAIN_STEPS} (host clock), {t['tokens_per_s']:.0f} tok/s, MFU "
        f"{t['mfu']:.2%} ({t['flops_per_token']:.4g} FLOPs/token over 989e12); "
        f"fit(): {t['final']['tokens_per_sec_per_chip']:.0f} tok/s, p50 "
        f"{t['final']['step_time_p50_s'] * 1e3:.1f} ms, p99 "
        f"{t['final']['step_time_p99_s'] * 1e3:.1f} ms; peak allocated "
        f"{t['peak_allocated_gb']:.2f} GB; launches fwd "
        f"{t['launches']['flash_fwd']} dq {t['launches']['flash_dq']} dkv "
        f"{t['launches']['flash_dkv']}; CE matmuls: {t['ce_matmul']}  [{card}]")
    log(f"train step under torch.profiler: {t['profile_step_ms']:.1f} ms wall, "
        f"{t['profile_device_ms']:.1f} ms device (busy "
        f"{t['profile_device_busy']:.1%}); share of device time: "
        + ", ".join(f"{k} {v:.1%}" for k, v in t["profile_share"].items())
        + f"  [{card}]")
    model_crosscheck(card, dense_train_config(), "attention_impl", "flash", "dot")
    torch.cuda.empty_cache()

    m = train_moe_phase(card)
    log(f"train bench_moe ({m['n_params']:,} params, {m['n_active_params']:,} active; "
        f"24 layers, 8 experts top-2, 8 x 2048, grouped dispatch + flash + "
        f"save_attn_kernel + scan CE, mu bf16): {MOE_TRAIN_STEPS} steps, loss "
        f"{m['losses'][0]:.4f} -> {m['losses'][-1]:.4f}; mean step "
        f"{m['mean_step_ms']:.1f} ms over steps 3-{MOE_TRAIN_STEPS} (host clock), "
        f"{m['tokens_per_s']:.0f} tok/s, MFU {m['mfu']:.2%} ({m['flops_per_token']:.4g} "
        f"FLOPs/token from active params, over 989e12); fit(): "
        f"{m['final']['tokens_per_sec_per_chip']:.0f} tok/s, p50 "
        f"{m['final']['step_time_p50_s'] * 1e3:.1f} ms, p99 "
        f"{m['final']['step_time_p99_s'] * 1e3:.1f} ms; peak allocated "
        f"{m['peak_allocated_gb']:.2f} GB; aux per step "
        + ", ".join(f"{a:.5f}" for a in m["aux"]) + "; launches "
        + ", ".join(f"{k} {m['launches'][k]}" for k in MOE_LAUNCHES_PER_LAYER_STEP)
        + f"  [{card}]")
    log(f"moe train step under torch.profiler: {m['profile_step_ms']:.1f} ms wall, "
        f"{m['profile_device_ms']:.1f} ms device (busy "
        f"{m['profile_device_busy']:.1%}); share of device time: "
        + ", ".join(f"{k} {v:.1%}" for k, v in m["profile_share"].items())
        + f"  [{card}]")
    model_crosscheck(card, moe_train_config(), "moe_gmm_impl", "pallas", "scan")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    main_case = cases[0]                            # G=1 bf16 at the serving shapes
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "tony_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "tony_tpu/ops/decode_attention.py:346",
        "launches": s["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    replaces = {"flash_fwd": 44, "flash_dq": 138, "flash_dkv": 177}
    for name, line in replaces.items():
        # the training path's shape and dtype: bench_1b4, bf16
        c = next(c for c in flash if c["name"] == name and c["shape"] == "bench_1b4"
                 and c["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tony_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"tony_tpu/ops/attention.py:{line}",
            "launches": t["launches"][name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    replaces = {"gmm_fwd": 107, "gmm_dx": 141, "gmm_dw": 189}
    for name, line in replaces.items():
        # the training path's dtype, bf16, in the w1/w3 direction (D -> F)
        c = next(c for c in gmm if c["name"] == name and c["direction"] == "w1"
                 and c["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tony_tpu_torch/csrc/grouped_mm.cu",
            "replaces": f"tony_tpu/ops/grouped_mm.py:{line}",
            "launches": m["launches"][name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
