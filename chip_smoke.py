#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tony_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository::

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. card: name and power limit, torch/CUDA versions, TF32 settings (matmul
   TF32 is turned off);
2. build: every kernel of the serving path, compiled from ``csrc/`` with
   nvcc;
3. kernels: each kernel against its plain PyTorch version on the card at
   Llama-3-8B decode shapes, with its time beside the bytes bound, the plain
   version's time and one PyTorch library call's time; then at block and
   head sizes large enough that the kernel stages each block in chunks;
4. serving: Llama-3-8B at full width (32 layers, random weights from a
   seed) through the engine, 16 requests with prefix sharing; the kernel's
   launch count must equal decode steps x layers. Then a few decode steps
   under torch.profiler: the device's busy share and the kernel's share of
   device time.

The last three lines are the ``kernels`` JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet: HBM3 bandwidth, dense peak rates by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# bf16: the output is rounded to bf16 and the kernel rounds p to bf16
# before P.V, so it cannot be held closer than a couple of bf16 ulps (2^-8
# relative); fp32: only the order of the sums differs
TOLERANCE = {torch.bfloat16: (2**-7, 2**-7), torch.float32: (1e-5, 1e-4)}


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
    built = load("paged_decode_attention")
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {built.seconds:.1f} s "
        f"-> {built.path.name})")
    for line in built.log.strip().splitlines():
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
    del flush

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
