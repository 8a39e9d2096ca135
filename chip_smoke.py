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
   Llama-3-8B decode shapes (G 1 and 5, and the verify step's G 16 with
   rows whose lengths run past their written positions and past the
   table) and at block and head sizes where it stages
   each block in chunks, each case with the instance that ran (every bf16
   case on the tensor cores, mma.sync with a split over the sequence; fp32
   scalar), and the seventeen tensor-core instances' registers and spills
   (kernels 7, 8 and the merge, and kernel 9's over int8 and fp8); then
   the flash-attention forward, dq and dk/dv
   kernels against theirs at bench_1b4's training shape, bench_moe's
   (head_dim 64), a Llama-3-8B GQA shape and one non-causal shape, in bf16
   and fp32, each case logged with the instance that ran (every bf16
   kernel on the tensor cores, wgmma with TMA staging; fp32 scalar), and
   the six tensor-core instances' registers and spills from the build log;
   then (3c) the grouped-matmul forward, dx and dW kernels against theirs
   at bench_moe's shapes (33,792 buffer rows from a real router draw with
   one expert forced empty, D 1024, F 2816, 8 experts, row tile 128), in
   both directions of the SwiGLU and in bf16 and fp32, each with its
   instance (all three in bf16 on wgmma with TMA staging, with their
   registers and spills; fp32 scalar), the forward's padding rows and the
   empty expert's dW exactly 0, and torch._grouped_mm's time beside each
   (dW's with a float32 output where this torch computes one), and one bench_moe
   MoE block forward and backward under ``set_sync_debug_mode("error")``;
   then (3d) the quantized decode-attention kernel against its plain
   version at Llama-3-8B decode shapes (8 rows of about 512 positions) over
   int8 and fp8 e4m3 pools, G 1 and 5 and the verify step's G 16 (rows
   whose lengths run past their written positions and past the table),
   bf16 queries, plus a float32-query
   case, a case that stages blocks in chunks and a NaN-scale case (the
   block named below one row's length and past another's), each case
   with the instance that ran (every bf16 case on the tensor cores, the
   split body of kernel 8 over one-byte tiles; fp32 scalar); and the
   int8 dequant-matmul kernel at each of the decode step's five weight
   shapes, bf16 at 8 rows (the decode step) and 16 and 128 (verify steps),
   fp32 at 8, each with its instance (bf16 on the tensor cores, fp32
   scalar) and, in bf16, its rows bit-equal to calls of 8 rows and of one,
   the five tensor-core instances' registers and spills, and the cases
   summed per step at each M; then (3e) the fused cross-entropy
   kernels (ce_fwd, ce_dh, ce_dw) against theirs at bench_1b4's loss head
   (16,384 rows, D 2048, V 32,000) in bf16 and fp32, and at a ragged shape
   (rows and vocab off the tiles) finite, with a NaN and an inf row and
   with a NaN weight, each case with the instance that ran (bf16 on wgmma
   with TMA staging, fp32 scalar), the backward launched twice and held
   bit-equal, and the four tensor-core instances' registers and spills;
   then (3f) the
   contiguous-cache decode kernel (kernel 7) against its plain version at the reference bench's decode
   case (bench_1b4 with 4 kv heads: 8 rows of a full 1024-position cache,
   block 128) in bf16 and fp32 and at Llama-3-8B's shape (T 2048) at G 1
   and at G 5 with ragged rows, each with its instance (bf16 on the
   tensor cores, fp32 scalar), beside the repeat-expanded
   ``reference_decode_attention``; and the bench's layer-scanned loop (24
   calls, each output the next query), whose 24 launches are the kernel's
   path; then (3g) the fsdp ring's chunk matmul (kernel 14) against its
   plain version at bench_1b4's ring chunks at fsdp 2 (8192 local rows:
   the four forward projections' shapes, w1's dx with the shard read
   transposed and its dW with the activations read transposed, and a
   ragged N), in bf16 and fp32, each with its instance (bf16 on wgmma with
   TMA staging, fp32 scalar), two launches held bit-equal, torch.matmul
   beside it (bf16 output for bf16 inputs), and the four tensor-core
   instances' registers and spills. Each kernel with its time beside its
   bound, the plain version's time and one PyTorch library call's time
   (the scan CE head's cuBLAS passes for the CE kernels, SDPA over the
   repeat-expanded cache for the decode kernels);
4. serving: Llama-3-8B at full width (32 layers, random weights from a
   seed) through the engine, 16 requests with prefix sharing; the kernel's
   launch count must equal decode steps x layers. Then a few decode steps
   under torch.profiler: the device's busy share, the kernel's share of
   device time, the kernel launches a step enqueues and the host ops that
   take the most CPU time. Then (4b) the same weights and requests through the
   quantized engine (int8 KV pools, int8 decode weights): each quantized
   kernel's launches must equal decode steps x 32 (attention) and x 225
   (7 matmuls x 32 layers + lm_head), no plain version and no bf16 decode
   attention on the card, generate() equal to the engine; its profile
   beside phase 4's. Then (4c) bench.py's speculative trace: a 64-token
   prompt, 769 new tokens, 15 drafts a step, greedy, prefix store on, at
   batch 1 and at batch 8 (one prompt for every row), spec off and then
   on, the spec-on engine's store seeded with the whole repeat (one
   prefill of the prompt and spec off's tokens) before its timed pass;
   then the quantized engine at batch 8 over 193 new tokens. The decode
   kernel (its quantized form when quantized) must run once per layer and
   step and the dequant-matmul 225 times a step, with no plain version;
   every run's emitted tokens are fed back through a plain float32
   forward, and each must be within a limit of that reference's top logit
   (the limit from the bf16 noise and the spec-off run's own trail,
   ``spec_serve_phase``); tokens/s per slot, tokens per step, accept rate
   and the on/off ratio are printed, and the batch-8 verify step's
   breakdown, bf16 and quantized (the dequant-matmul's ms a step). Then a
   2-layer
   cross-check of the quantized engine on the card against the same
   engine on the CPU (plain versions);
5. training: ``fit()`` on bench_1b4 at full width and depth (24 layers,
   batch 8 x 2048, the production recipe: flash attention, remat
   ``save_attn_kernel``, scan CE, bf16 Adam first moment), 10 steps from
   random weights; every loss finite and the last below the first, and
   each flash kernel launched exactly 24 x 10 times (twice as many forward
   launches would mean remat re-ran the forward kernel), on its
   tensor-core instance. Then one step
   under torch.profiler, and a 2-layer cross-check of one train step with
   the kernels against plain attention. Then (5b) the same fit() with
   ``ce_impl="pallas"``: step 1 within 2e-2 of phase 5's, ce_fwd once a
   step and ce_dh / ce_dw once per vocab chunk a step, all three on
   their tensor-core instances, no plain version; its profile, and a 2-layer
   cross-check against the scan head;
6. MoE training: ``fit()`` on bench_moe at full width and depth (24
   layers, 8 experts top-2, batch 8 x 2048, the same recipe with the
   grouped dispatch through the grouped-matmul kernels), 10 steps from
   random weights; every loss finite and the last below the first, each
   grouped-matmul kernel launched as often as remat implies (per layer and
   step: forward 6, dx 3, dW 3) and each flash kernel once per layer and
   step, no plain version on the card, the grouped-matmul and flash
   kernels on their tensor-core instances. Then one step under torch.profiler,
   and a 2-layer cross-check of one train step with the kernels against
   the plain grouped matmul;
7. fsdp training: two rank processes on this one card (``--fsdp-rank``),
   each bringing up a gloo group over tcp://localhost and calling the
   port's own ``fit()`` on bench_1b4 at full width and depth with
   ``mesh_shape=MeshShape(fsdp=2)`` and ``overlap_impl="pallas"``, phase
   5's recipe, data (global batch 8 x 2048, 4 x 2048 a rank) and initial
   parameters (each rank its blocks), 4 steps: each loss within 2e-2 of
   phase 5's at the same step; on each rank kernel 14 launched exactly
   24 layers x 7 projections x 4 x 2 times a step (the ring's forward, its
   recompute under remat, dx and dW, two chunks each) on its tensor-core
   instance, its plain version never, and each flash kernel once per
   layer and step. The step time is printed beside the transport (gloo,
   host-staged): two ranks on one card, not an NCCL time.

Every profile traces one warm-up step first; a window holding fewer
events of a kernel than the launch counters say it launched is traced
again, and the script raises after three such windows. The flash,
grouped-matmul, decode, dequant-matmul and CE kernels' launches are
matched by their tensor-core kernels' names (``tc::``), so a window in
which one ran another instance is short of events; a decode breakdown's attention share
counts the merge of a row's splits (``tc::decode_merge_kernel``) too.

The last three lines are the ``kernels`` JSON (fourteen kernels; quant_mm's
times are one decode step's 225 launches at their five shapes, summed;
chunk_mm's are the w1/w3 forward chunk's, its launches rank 0's in phase 7),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
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
# int8 dequant-matmul against its plain version on the same inputs (outputs
# of about unit size): both round each weight to x's dtype and sum in
# float32 in another order over up to 14,336 terms. bf16: one ulp of the
# rounded output (2^-8 relative) plus the sums' difference; fp32: the
# sums' order alone
QUANT_MM_TOLERANCE = {torch.bfloat16: (1e-2, 2**-7), torch.float32: (1e-4, 1e-4)}
KERNEL_SOURCES = ("paged_decode_attention", "flash_attention", "grouped_mm",
                  "quant_mm", "fused_ce", "overlap")
# the bf16 paged decode kernel's tensor-core instance, whose device time a
# breakdown counts: the split kernel, and the merge of a row's splits,
# launched when the table spans more than one split (the engine sizes its
# table to the live rows, so not at every step)
PAGED_TC_EVENTS = ("tc::paged_decode_kernel", "tc::decode_merge_kernel")
# the same for the quantized pools' tensor-core instance (kernel 9)
QUANT_TC_EVENTS = ("tc::paged_quant_decode_kernel", "tc::decode_merge_kernel")
# each launch counter's CUDA kernels: one counted launch enqueues one of each
# (a profile must hold at least that many events of each). The profiles run
# bf16 in training and serving, so the flash, grouped-matmul, decode,
# dequant-matmul and CE kernels (ce_impl="pallas") are named by their
# tensor-core instances (namespace tc): a launch on the scalar body, whose
# names no tc:: name matches, falls short.
KERNEL_EVENTS = {
    "decode_attention": ("tc::decode_kernel",),
    "paged_decode_attention": ("tc::paged_decode_kernel",),
    "paged_decode_attention_quant": ("tc::paged_quant_decode_kernel",),
    "quant_mm": ("tc::quant_mm_kernel",),
    "flash_fwd": ("tc::flash_fwd_kernel",), "flash_dq": ("tc::flash_dq_kernel",),
    "flash_dkv": ("tc::flash_dkv_kernel",),
    "gmm_fwd": ("tc::gmm_fwd_kernel",), "gmm_dx": ("tc::gmm_dx_kernel",),
    "gmm_dw": ("tc::gmm_dw_kernel",),
    "ce_fwd": ("tc::ce_fwd_kernel", "ce_fwd_merge_kernel"),
    "ce_dh": ("tc::ce_dlogits_kernel", "tc::ce_dh_kernel"), "ce_dw": ("tc::ce_dw_kernel",),
    "chunk_mm": ("tc::chunk_mm_kernel",),
}
# the CE head's profiler ranges (ops/fused_ce.py), one per pass
CE_RANGES = ("fused_ce.fwd", "fused_ce.bwd")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# the buffer time_ms zero-fills before each timed call: it flushes the 50 MB
# L2, and at 1 GiB (about 0.4 ms of device time) it keeps the device busy
# until the host has enqueued the call, so a slow host does not add its own
# time to the kernel's (a 256 MB fill left some medians twice the kernel's
# time on a shared host)
FLUSH_BYTES = 2**30


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median device time of one call, each run after the L2 cache is
    flushed (the engine calls the kernel once per layer, so it finds the
    pools cold; ``flush``: FLUSH_BYTES on the card), timed with CUDA
    events."""
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


def verify_lengths(written: np.ndarray, past: tuple[int, ...], M: int, blk: int
                   ) -> tuple[np.ndarray, list[int], list[int]]:
    """Row lengths as a verify step passes them: row b has written
    ``written[b]`` positions and its length runs ``past[b]`` (< G) beyond
    them, the padding positions of a draft shorter than G - 1 (no
    ``past``: the lengths are the written counts). Returns the lengths, the
    blocks each row's written positions fill (its table entries; later
    entries name scratch block 0) and the blocks the kernel reads for it,
    ``min(ceil(length / blk), M)``."""
    lengths = written + np.array(past or [0] * len(written), np.int32)
    need = [math.ceil(n / blk) for n in written]
    read = [min(math.ceil(n / blk), M) for n in lengths]
    return lengths, need, read


def decode_bound(lengths: np.ndarray, tables: np.ndarray, read: list[int], G: int,
                 H: int, Hkv: int, hd: int, blk: int, kv_itemsize: int) -> tuple[int, int]:
    """(K/V bytes, operations) of one decode call: each physical block's
    positions that some row reads, once (rows 0 and 7 share blocks: their
    positions are read once, not twice), none past a row's length or the
    table's width; QK^T and P.V, 2 operations each per (query, head,
    position, dim), query g of row b attending ``len_b - (G - 1) + g``
    positions, at most the table's width."""
    T = tables.shape[1] * blk
    used: dict[int, int] = {}
    for b, n in enumerate(lengths):
        for j in range(read[b]):
            pid = int(tables[b, j])
            used[pid] = max(used.get(pid, 0), min(blk, min(int(n), T) - j * blk))
    kv_bytes = 2 * sum(used.values()) * Hkv * hd * kv_itemsize
    attended = sum(min(max(int(n) - (G - 1) + g, 0), T) for n in lengths for g in range(G))
    return kv_bytes, 4 * attended * H * hd


# a verify step's rows at G 16: how far each row's length runs past its
# last written position (row 0, written to the table's end, then runs past
# the table's M blocks; every row's first query still sees at least one
# position, as in the engine, where it sees ``pos + 1``)
VERIFY_PAST = (15, 15, 8, 0, 3, 15, 1, 12)
QUANT_VERIFY_PAST = (3, 0, 9, 15, 15, 15, 7, 12)


def decode_case(G: int, dtype: torch.dtype, flush: torch.Tensor, *,
                blk: int = 64, hd: int = 128, past: tuple[int, ...] = ()) -> dict:
    """The paged decode kernel at Llama-3-8B decode shapes (32/8 heads, 8
    rows up to 2048 positions): against its plain version on the same
    inputs, its time, its bound and SDPA's. With ``past``, the rows of a
    verify step (``verify_lengths``)."""
    from tony_tpu_torch.ops.decode_attention import (
        _chunk, decode_attention, kernel_instance, paged_decode_attention_plain,
    )

    B, H, Hkv = 8, 32, 8
    dev = "cuda"
    rng = np.random.default_rng(100 + G)
    M = 2048 // blk
    lengths_np, need, read = verify_lengths(
        np.array([2048, 5, 64, 1000, 1537, 700, 133, 1999], np.int32), past, M, blk)
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
    kv_bytes, ops = decode_bound(lengths_np, tables_np, read, G, H, Hkv, hd, blk,
                                 itemsize)
    io_bytes = 2 * q.numel() * itemsize + lengths.numel() * 4 + sum(read) * 4
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "G": G, "dtype": str(dtype).replace("torch.", ""), "blk": blk, "hd": hd,
        "past": past, "chunk": _chunk(blk, hd, itemsize),
        "instance": kernel_instance("paged_decode_attention", dtype, hd, blk, G, H // Hkv),
        "max_abs_err": err.max().item(), "sdpa_max_abs_err": lib_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": kv_bytes + io_bytes,
    }


# --- phase 3d: quantized serving kernels against their plain versions ---------

# 8 rows of about 512 positions (one short row); rows 0 and 7 share their
# first 4 blocks, as a prefix match shares them
QUANT_LENGTHS = (512, 448, 577, 5, 390, 640, 129, 520)


def quant_decode_case(kv: str, G: int, dtype: torch.dtype, flush: torch.Tensor, *,
                      blk: int = 64, hd: int = 128, poison: bool = False,
                      past: tuple[int, ...] = ()) -> dict:
    """The quantized paged decode kernel at Llama-3-8B decode shapes (32/8
    heads) over ``kv`` pools quantized per block per kv head: against its
    plain version on the same inputs, its time, its bound, SDPA over the
    dequantized, gathered K/V (the dequant and gather not timed), and the
    unquantized kernel (kernel 8) over the pools dequantized beforehand,
    which the tensor-core instance must equal bit for bit (its math is
    kernel 8's) in about twice kernel 9's bytes. With
    ``poison`` only the NaN-scale check runs: row 0's sixth block gets a
    NaN K scale, and row 3 (5 positions) names it past its length, where
    its table is never read; exactly the rows whose tables name it below
    their length must go non-finite. With ``past``, the rows of a verify
    step (``verify_lengths``)."""
    from tony_tpu_torch.ops.decode_attention import (
        _chunk, decode_attention, kernel_instance, paged_decode_attention_plain,
    )
    from tony_tpu_torch.serve.cache import kv_quant_spec, quantize_values

    B, H, Hkv = 8, 32, 8
    dev = "cuda"
    rng = np.random.default_rng(300 + G)
    written = np.array(QUANT_LENGTHS, np.int32)
    M = max(math.ceil(n / blk) for n in written)
    lengths_np, need, read = verify_lengths(written, past, M, blk)
    P = 1 + sum(need)
    perm = rng.permutation(np.arange(1, P))
    tables_np = np.zeros((B, M), np.int32)          # past the length: scratch
    at = 0
    for b in range(B):
        tables_np[b, :need[b]] = perm[at:at + need[b]]
        at += need[b]
    shared = 256 // blk
    tables_np[7, :shared] = tables_np[0, :shared]
    gen = torch.Generator(device=dev).manual_seed(G + blk + hd)
    q = torch.randn((B, G, H, hd), generator=gen, device=dev).to(dtype)
    qdt, qmax = kv_quant_spec(kv)

    def pool():
        f = torch.randn((P, Hkv, blk, hd), generator=gen, device=dev)
        sc = f.abs().amax(dim=(2, 3)) / qmax
        return quantize_values(f, sc[..., None, None], qmax, qdt), sc

    (kq, ks), (vq, vs) = pool(), pool()
    lengths = torch.as_tensor(lengths_np, device=dev)
    tables = torch.as_tensor(tables_np, device=dev)
    scale = 1.0 / math.sqrt(hd)
    run = lambda: decode_attention(q, kq, vq, lengths, tables=tables,  # noqa: E731
                                   k_scale=ks, v_scale=vs)
    if poison:
        bad = int(tables_np[0, 5])
        tables_np[3, need[3]:] = bad
        tables.copy_(torch.as_tensor(tables_np, device=dev))
        ks[bad] = float("nan")
        out = run()
        torch.cuda.synchronize()
        hit = [bad in tables_np[b, :need[b]] for b in range(B)]
        finite = [bool(torch.isfinite(out[b]).all()) for b in range(B)]
        if finite != [not h for h in hit]:
            raise AssertionError(f"NaN scale of block {bad}: rows finite {finite}, "
                                 f"rows naming it {hit}")
        return {"kv": kv, "poisoned_block": bad, "rows_hit": hit,
                "rows_naming_it": [b for b in range(B) if bad in tables_np[b]]}

    out = run()
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(q, kq, vq, lengths, tables, scale=scale,
                                       k_scale=ks, v_scale=vs)
    err = (out.float() - ref.float()).abs()
    atol, rtol = TOLERANCE[dtype]
    if not torch.isfinite(out).all() or bool((err > atol + rtol * ref.float().abs()).any()):
        raise AssertionError(
            f"paged_decode_attention_quant {kv} G={G} {dtype}: max |err| "
            f"{err.max().item():.3e} over atol={atol} rtol={rtol}")
    instance = kernel_instance("paged_decode_attention_quant", dtype, hd, blk, G, H // Hkv)
    kd, vd = ((pq.float() * sc[..., None, None]).to(dtype) for pq, sc in ((kq, ks), (vq, vs)))
    kernel8 = lambda: decode_attention(q, kd, vd, lengths, tables=tables)  # noqa: E731
    if instance == "tensor cores" and not torch.equal(out, kernel8()):
        raise AssertionError(f"paged_decode_attention_quant {kv} G={G}: differs from "
                             f"kernel 8 over the pools dequantized beforehand")

    # library yardstick: SDPA over the dequantized, gathered, repeat-expanded
    # K/V in q's dtype (the port never calls SDPA)
    T = M * blk

    def gathered(pq, sc):
        d = (pq.float() * sc[..., None, None]).to(dtype)
        g = d[tables.long()].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, hd)
        return g.repeat_interleave(H // Hkv, dim=1)

    kg, vg = gathered(kq, ks), gathered(vq, vs)
    qs = q.permute(0, 2, 1, 3).contiguous()
    lim = lengths.long()[:, None] - (G - 1) + torch.arange(G, device=dev)
    mask = (torch.arange(T, device=dev)[None, None, :] < lim[:, :, None])[:, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, kg, vg, attn_mask=mask)
    lib_err = (sdpa().permute(0, 2, 1, 3).float() - ref.float()).abs().max().item()

    ms = time_ms(run, flush)
    plain_ms = time_ms(lambda: paged_decode_attention_plain(
        q, kq, vq, lengths, tables, scale=scale, k_scale=ks, v_scale=vs), flush)
    library_ms = time_ms(sdpa, flush)
    kernel8_ms = time_ms(kernel8, flush)

    # payload bytes: one byte per element; two float32 scales per (block,
    # kv head) read
    kv_bytes, ops = decode_bound(lengths_np, tables_np, read, G, H, Hkv, hd, blk,
                                 kq.element_size())
    blocks = len({int(tables_np[b, j]) for b in range(B) for j in range(read[b])})
    scale_bytes = 2 * blocks * Hkv * 4
    io_bytes = 2 * q.numel() * q.element_size() + lengths.numel() * 4 + sum(read) * 4
    nbytes = kv_bytes + scale_bytes + io_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "kv": kv, "G": G, "dtype": str(dtype).replace("torch.", ""), "blk": blk,
        "hd": hd, "past": past, "chunk": _chunk(blk, hd, q.element_size()),
        "instance": instance,
        "max_abs_err": err.max().item(), "sdpa_max_abs_err": lib_err,
        "atol": atol, "rtol": rtol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "kernel8_ms": kernel8_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
    }


# the decode step's weight shapes (D, N) and how many of each a layer runs:
# wq and wo 4096 -> 4096, wk and wv 4096 -> 1024, w1 and w3 4096 -> 14336,
# w2 14336 -> 4096; lm_head 4096 -> 128256 once per step
QUANT_MM_SHAPES = (("wq/wo", 4096, 4096, 2), ("wk/wv", 4096, 1024, 2),
                   ("w1/w3", 4096, 14336, 2), ("w2", 14336, 4096, 1),
                   ("lm_head", 4096, 128256, 0))


def quant_mm_library(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor):
    """One PyTorch call computing the same product (the yardstick; the port
    never calls it): ``torch._weight_int8pack_mm`` where this torch runs it
    on CUDA for x's dtype, else ``torch.matmul`` against the weight
    dequantized beforehand (not timed). Returns (fn, its name)."""
    if hasattr(torch, "_weight_int8pack_mm"):
        wt, sx = wq.t().contiguous(), s.to(x.dtype)
        fn = lambda: torch._weight_int8pack_mm(x, wt, sx)  # noqa: E731
        try:
            fn()
            torch.cuda.synchronize()
            return fn, "torch._weight_int8pack_mm"
        except (RuntimeError, NotImplementedError, TypeError):
            pass
    wd = (wq.float() * s).to(x.dtype)
    return (lambda: torch.matmul(x, wd)), "torch.matmul on the dequantized weight"


def quant_mm_case(label: str, D: int, N: int, dtype: torch.dtype,
                  flush: torch.Tensor, M: int = 8) -> dict:
    """The int8 dequant-matmul kernel at one decode weight shape and M rows
    (8: the decode step's slots; 16 and 128: verify steps of G 16 at batch
    1 and 8): against its plain version on the same inputs, the instance
    that ran, its time, its bound, the plain version's time and one library
    call's (named). In bf16 ``rows_equal`` says whether the first 8 rows
    (and the first row) came out the same bits from calls of 8 rows and of
    one, as a slot decodes alone or in a batch."""
    from tony_tpu_torch.ops.quant_mm import (
        kernel_instance, quant_matmul, quant_matmul_plain, quantize_weights,
    )

    gen = torch.Generator(device="cuda").manual_seed(D + N)
    x = torch.randn((M, D), generator=gen, device="cuda").to(dtype)
    w = torch.randn((D, N), generator=gen, device="cuda") / math.sqrt(D)
    wq, s = quantize_weights(w)
    del w
    out = quant_matmul(x, wq, s)
    rows_equal = None
    if dtype == torch.bfloat16:
        rows_equal = (torch.equal(out[:1], quant_matmul(x[:1].contiguous(), wq, s))
                      and torch.equal(out[:8], quant_matmul(x[:8].contiguous(), wq, s)))
    torch.cuda.synchronize()
    ref = quant_matmul_plain(x, wq, s)
    err = (out.float() - ref.float()).abs()
    atol, rtol = QUANT_MM_TOLERANCE[dtype]
    ok = bool(torch.isfinite(out).all()) and not bool(
        (err > atol + rtol * ref.float().abs()).any())
    lib, lib_name = quant_mm_library(x, wq, s)
    lib_err = (lib().float() - ref.float()).abs().max().item()
    max_err = err.max().item()
    del out, ref, err
    nbytes = D * N + N * 4 + M * D * x.element_size() + M * N * x.element_size()
    ops = 2 * M * D * N
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "label": label, "D": D, "N": N, "M": M, "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": max_err, "ok": ok and rows_equal is not False, "atol": atol,
        "rtol": rtol, "rows_equal": rows_equal, "instance": kernel_instance(dtype),
        "ms": time_ms(lambda: quant_matmul(x, wq, s), flush),
        # the plain version is a row at a time: 3 repeats at 128 rows
        "plain_ms": time_ms(lambda: quant_matmul_plain(x, wq, s), flush,
                            reps=10 if M <= 16 else 3),
        "library_ms": time_ms(lib, flush), "library": lib_name,
        "library_max_abs_err": lib_err,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
    }


def quant_mm_step(cases: list[dict], M: int = 8, n_layers: int = 32) -> dict:
    """The bf16 cases of M rows summed as one step runs them: each layer
    shape times its count per layer times the layers, lm_head once."""
    per = {label: count for label, _, _, count in QUANT_MM_SHAPES}
    bf = [c for c in cases if c["dtype"] == "bfloat16" and c["M"] == M]
    weight = {c["label"]: (per[c["label"]] * n_layers or 1) for c in bf}
    total = {k: sum(c[k] * weight[c["label"]] for c in bf)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")}
    total["launches"] = sum(weight.values())
    total["max_abs_err"] = max(c["max_abs_err"] for c in bf)
    total["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes" for c in bf)
                         else "operations")
    return total


# --- phase 4: serving at full width -------------------------------------------


def llama_params():
    """Llama-3-8B at full width, random bf16 weights from seed 0."""
    from tony_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"serve: Llama-3-8B {cfg.n_params:,} params bf16 initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def serve_requests(cfg):
    """The 16 serving requests (the same draws in phases 4 and 4b), half
    greedy and half sampled, and the generator that goes on to draw the
    warm-up and profile prompts."""
    from tony_tpu_torch.serve import Request

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
    return prompts, reqs, rng


def serve_run(engine, cfg, reqs, rng) -> tuple[dict, dict, dict]:
    """Warm up, zero every kernel count, serve ``reqs``, read the counts:
    (completions by request index, counts, figures). Every request must
    complete with 64 in-vocabulary tokens, and prefix reuse must fire."""
    from tony_tpu_torch.ops.decode_attention import LAUNCHES as ATTN_LAUNCHES
    from tony_tpu_torch.ops.decode_attention import reset_launches as reset_attn
    from tony_tpu_torch.ops.quant_mm import LAUNCHES as MM_LAUNCHES
    from tony_tpu_torch.ops.quant_mm import reset_launches as reset_mm
    from tony_tpu_torch.serve import Request

    # warm-up (cuBLAS handles, allocator), then counters to zero
    engine.run([Request(prompt=rng.integers(0, cfg.vocab_size, 32), max_new_tokens=4)])
    engine.reset_metrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attn()
    reset_mm()
    t0 = time.perf_counter()
    ids = [engine.submit(r) for r in reqs]
    out = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ATTN_LAUNCHES, **MM_LAUNCHES}
    m = engine.metrics
    if len(out) != len(reqs):
        raise AssertionError(f"{len(out)} of {len(reqs)} requests completed")
    for rid, c in out.items():
        if len(c.tokens) != 64 or c.finish_reason != "length":
            raise AssertionError(f"request {rid}: {len(c.tokens)} tokens, "
                                 f"{c.finish_reason!r}")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {rid}: token outside the vocabulary")
    if m.prefix_hit_tokens < 256:
        raise AssertionError(f"prefix reuse did not fire ({m.prefix_hit_tokens})")
    figures = {
        "requests": len(out), "decode_steps": m.decode_steps,
        "decode_tokens_per_s": m.decode_tokens_per_sec,
        "mean_ttft_s": m.ttft_avg_s,
        "mean_decode_step_ms": m.decode_s / m.decode_steps * 1e3,
        "prefix_hit_tokens": m.prefix_hit_tokens,
        "kv_bytes_per_token": m.kv_bytes_per_token,
        "wall_s": wall, "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return {i: out[rid] for i, rid in enumerate(ids)}, launches, figures


def serve_phase(cfg, params) -> dict:
    """Phase 4: the bf16 engine, 16 requests; the paged decode kernel once
    per layer and decode step, no plain version; generate() equal to the
    engine on request 0; then the decode-step breakdown."""
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.serve import Engine, ServeConfig

    sv = dict(slots=8, max_len=2048, kv_block=64, prefix=True)
    engine = Engine(params, cfg, ServeConfig(**sv), device="cuda")
    prompts, reqs, rng = serve_requests(cfg)
    out, launches, figures = serve_run(engine, cfg, reqs, rng)
    want = figures["decode_steps"] * cfg.n_layers
    if launches["paged_decode_attention"] != want or want == 0:
        raise AssertionError(f"kernel launches {launches} != decode steps "
                             f"{figures['decode_steps']} x {cfg.n_layers} layers")
    if launches["paged_decode_attention_plain"] != 0:
        raise AssertionError("the plain decode attention ran on the card")
    breakdown = decode_breakdown(engine, cfg, rng, {"attention": PAGED_TC_EVENTS})
    del engine
    solo = generate(params, prompts[0][None], cfg, max_new_tokens=64,
                    device="cuda", serve=sv)
    if solo[0, len(prompts[0]):].tolist() != out[0].tokens:
        raise AssertionError("generate() differs from the engine on request 0")
    return {**figures, **breakdown, "launches": launches["paged_decode_attention"],
            "tokens": [c.tokens for c in out.values()]}


def quant_serve_phase(cfg, params, bf16: dict) -> dict:
    """Phase 4b: the same weights and requests through the quantized engine
    (int8 KV pools, int8 decode weights). Per decode step the quantized
    attention runs once per layer and the dequant-matmul 7 x 32 + 1 times;
    no plain version and no bf16 decode attention on the card; generate()
    equal to the engine on request 0; the breakdown; and, reported only,
    the share of greedy tokens equal to phase 4's."""
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.serve import Engine, ServeConfig

    sv = dict(slots=8, max_len=2048, kv_block=64, prefix=True, quant_kv="int8",
              quant_weights=True)
    t0 = time.perf_counter()
    engine = Engine(params, cfg, ServeConfig(**sv), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts, reqs, rng = serve_requests(cfg)
    out, launches, figures = serve_run(engine, cfg, reqs, rng)
    steps = figures["decode_steps"]
    want = {"paged_decode_attention_quant": steps * cfg.n_layers,
            "quant_mm": steps * (7 * cfg.n_layers + 1),
            "paged_decode_attention": 0, "paged_decode_attention_plain": 0,
            "paged_decode_attention_quant_plain": 0, "quant_mm_plain": 0}
    if steps == 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"quantized launches {launches} != {want} "
                             f"({steps} decode steps)")
    breakdown = decode_breakdown(engine, cfg, rng, {
        "attention": QUANT_TC_EVENTS, "quant_mm": KERNEL_EVENTS["quant_mm"]})
    del engine
    torch.cuda.empty_cache()
    solo = generate(params, prompts[0][None], cfg, max_new_tokens=64,
                    device="cuda", serve=sv)
    if solo[0, len(prompts[0]):].tolist() != out[0].tokens:
        raise AssertionError("generate() differs from the quantized engine on "
                             "request 0")
    greedy = [i for i in range(len(reqs)) if i % 2 == 0]
    same = sum(a == b for i in greedy
               for a, b in zip(out[i].tokens, bf16["tokens"][i]))
    return {**figures, **breakdown, "build_s": build_s, "launches": launches,
            "greedy_equal_share": same / (64 * len(greedy)),
            "greedy_equal_requests": sum(out[i].tokens == bf16["tokens"][i]
                                         for i in greedy)}


def quant_crosscheck(card: str) -> dict:
    """Llama-3-8B's width at 2 layers: the same 4 greedy requests through
    the quantized engine (int8 KV, int8 weights, prefix reuse) on the card
    (kernels) and on the CPU (plain versions), from the same weights.
    Compared: each prefill's logits (bf16 masters on both), then the first
    decode step's logits (both quantized kernels) for the rows whose first
    token agreed, and the greedy tokens.

    Tolerances. Logits: 5% of the card's largest |logit|. Both sides run
    bf16 activations and round at the same ops, but cuBLAS, the kernels and
    the CPU's matmuls sum in other orders, so any of the ~12 bf16 roundings
    on a token's path (2^-9 relative each) can land one ulp apart, and a
    K/V value that sits on an int8 rounding boundary can be stored one step
    apart. Tokens: a greedy token may differ only where its logits' top-2
    margin is under twice the measured max |diff| (a flip needs the two
    logits to move by the margin together); everything after a flip is
    reported, not held."""
    from tony_tpu_torch.models.llama import LlamaConfig, init_params
    from tony_tpu_torch.serve import Engine, Request, ServeConfig
    from tony_tpu_torch.serve import engine as engine_mod

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 128)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (72, 2, 40)] + [rng.integers(0, cfg.vocab_size, 100)]
    sv = dict(slots=4, max_len=256, kv_block=64, prefix=True, quant_kv="int8",
              quant_weights=True)
    runs = {}
    real = engine_mod.sample_tokens
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else {
            k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in params.items()}
        calls = []

        def recording(logits, *a, **kw):
            calls.append(logits.float().cpu())
            return real(logits, *a, **kw)

        engine_mod.sample_tokens = recording
        try:
            t0 = time.perf_counter()
            eng = Engine(p, cfg, ServeConfig(**sv), device=dev)
            out = eng.run([Request(prompt=q, max_new_tokens=4) for q in prompts])
            secs = time.perf_counter() - t0
        finally:
            engine_mod.sample_tokens = real
        # prefill calls sample one row each, in admission order; the first
        # decode step samples every slot
        prefill = [c[0] for c in calls if c.shape[0] == 1][:len(prompts)]
        first_step = next(c for c in calls if c.shape[0] == sv["slots"])
        runs[dev] = (prefill, first_step, [out[i].tokens for i in range(len(prompts))],
                     eng.metrics.prefix_hit_tokens, secs)
        del eng
    (pc, dc, tc, hc, sc), (pp, dp, tp, hp, sp) = runs["cuda"], runs["cpu"]
    scale = max(float(x.abs().max()) for x in pc)
    pre_diff = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    agree = [tc[i][0] == tp[i][0] for i in range(len(prompts))]
    rows = [i for i in range(len(prompts)) if agree[i]]
    step_diff = max(float((dc[i] - dp[i]).abs().max()) for i in rows) if rows else 0.0
    diff = max(pre_diff, step_diff)

    def margin(x):
        top = x.topk(2).values
        return float(top[0] - top[1])

    flips = [i for i in range(len(prompts)) if not agree[i] and margin(pc[i]) > 2 * diff]
    flips += [i for i in rows if tc[i][1] != tp[i][1] and margin(dc[i]) > 2 * diff]
    same = sum(a == b for x, y in zip(tc, tp) for a, b in zip(x, y))
    log(f"quant crosscheck 2 layers at Llama-3-8B width (int8 KV + int8 weights): "
        f"prefill logits max|diff| {pre_diff:.4e}, first decode step {step_diff:.4e} "
        f"over {len(rows)} rows, limit {0.05 * scale:.4e} (5% of max|logit| "
        f"{scale:.3f}); greedy tokens equal {same}/{4 * len(prompts)}; prefix hit "
        f"{hc} card / {hp} cpu tokens; card {sc:.1f} s, cpu {sp:.1f} s  [{card}]")
    if hc < 128 or hc != hp:
        raise AssertionError(f"prefix reuse: card {hc}, cpu {hp} tokens")
    if diff > 0.05 * scale:
        raise AssertionError(f"card and CPU logits differ by {diff:.4e}")
    if flips:
        raise AssertionError(f"greedy tokens of rows {flips} differ beyond a near-tie")
    return {"prefill_max_abs_diff": pre_diff, "first_step_max_abs_diff": step_diff,
            "logit_scale": scale, "tokens_equal": same, "tokens": 4 * len(prompts)}


# --- phase 4c: speculative serving at full width --------------------------------

# bench.py's speculative trace (:778-836): a prompt of one kv block of seeded
# tokens, 12 blocks + 1 new tokens (so the generation's K/V fills whole
# blocks and the store holds the entire repeat), 15 draft tokens a step
SPEC_BLOCK = 64
SPEC_DRAFT = 15
SPEC_NEW = 12 * SPEC_BLOCK + 1
# the store's budget: the repeat's 13 blocks of 8 MiB at this width (the
# default 64 MB holds 8, so the path would end 448 tokens in)
SPEC_STORE_MB = 128.0


class Layerwise:
    """A stacked ``[L, ...]`` weight that hands out layer ``l`` through
    ``fn`` when indexed: a float32 forward reads float32 weights one layer
    at a time, with no float32 copy of the model."""

    def __init__(self, stacked: torch.Tensor, fn):
        self.stacked, self.fn = stacked, fn

    def __getitem__(self, l: int) -> torch.Tensor:
        return self.fn(self.stacked[l])


def reference_weights(params, quant: bool) -> tuple[dict, dict]:
    """(prompt weights, decode weights) of the float32 teacher-forced
    forward: the masters in float32 for the prompt, which the engine's
    prefill runs through the masters; for the emitted tokens the masters
    again, or with ``quant`` the int8 copy that the quantized engine's
    decode step runs (``quantize_weights`` per layer matrix and on
    lm_head, as the engine builds it), dequantized in float32."""
    from tony_tpu_torch.ops.quant_mm import quantize_weights

    def deq(w):
        wq, s = quantize_weights(w)
        return wq.float() * s

    def f32(w):
        return w.float()

    shared = {"tok_emb": params["tok_emb"].float(),
              "final_norm": params["final_norm"].float()}
    master = {**shared, "lm_head": params["lm_head"].float(),
              "layers": {k: Layerwise(t, f32) for k, t in params["layers"].items()}}
    if not quant:
        return master, master
    # the layer matrices are [L, D, N]; the norms [L, D] stay masters
    return master, {**shared, "lm_head": deq(params["lm_head"]), "layers": {
        k: Layerwise(t, deq if t.dim() == 3 else f32) for k, t in params["layers"].items()}}


def teacher_forced(params, cfg, prompt: np.ndarray, seqs: list[list[int]],
                   quant: bool) -> tuple[list[np.ndarray], float]:
    """Each distinct emitted sequence fed back through the plain float32
    forward of ``models/generate.py`` (``forward_with_cache``, no kernel):
    the prompt through the prompt weights, the emitted tokens after it
    through the decode weights (``reference_weights``). Returns, per
    sequence and emitted token, the reference's top logit less that
    token's logit (0 where the token is the reference's argmax); and,
    without ``quant``, the noise of one bf16 path: the same forward in
    bf16 through the masters as they are, its largest difference from the
    float32 logits over their top 8 at any emitted position."""
    from tony_tpu_torch.models.generate import KVCache, forward_with_cache

    dev = params["lm_head"].device
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    first, rest = reference_weights(params, quant)
    runs = [(cfg32, first, rest)] + ([] if quant else [(cfg, params, params)])
    P = len(prompt)
    gaps, noise = {}, 0.0
    for seq in {tuple(s) for s in seqs}:
        toks = torch.as_tensor(np.concatenate([prompt, seq[:-1]]), device=dev)[None]
        logits = []
        for c, head_w, tail_w in runs:
            cache = KVCache.create(c, 1, toks.shape[1], device=dev)
            head, _ = forward_with_cache(head_w, toks[:, :P], cache, 0, c, last_only=True)
            tail, _ = forward_with_cache(tail_w, toks[:, P:], cache, P, c)
            logits.append(torch.cat([head, tail], dim=1)[0])       # [N, V]
            del cache, head, tail
        ref = logits[0]
        t = torch.as_tensor(seq, device=dev)[:, None]
        gaps[seq] = (ref.amax(-1) - ref.gather(1, t)[:, 0]).cpu().numpy()
        if not quant:
            top = ref.topk(8, dim=-1).indices
            noise = max(noise, float((logits[1].gather(1, top) - ref.gather(1, top))
                                     .abs().max()))
        del logits, ref
    return [gaps[tuple(s)] for s in seqs], noise


def spec_mode(cfg, params, prompt: np.ndarray, on: bool, batch: int, new: int,
              seed: list[int] | None = None, profile: bool = False, **quant) -> dict:
    """One engine with spec on or off, ``batch`` slots, greedy, prefix store
    on: a warm-up, then the timed pass of the requests, with every launch
    counter zeroed just before it and read just after. Spec off warms with
    4 tokens a row. Spec on seeds its store with ``seed``, the spec-off
    run's tokens: one request whose prompt is the prompt and the first
    ``new - 1`` of them registers the whole repeat at admission (the path
    a first pass would register at finish). bench.py seeds with a whole
    spec-on pass and warms again to pay XLA's compiles; eager PyTorch has
    none, and a pass of 769 tokens would cost as much as the timed one.
    With ``profile``, then the breakdown of a few verify steps of the same
    requests, cut to as many tokens as those steps may emit."""
    from tony_tpu_torch.serve import Engine, Request, ServeConfig

    sv = dict(slots=batch, max_len=1024, kv_block=SPEC_BLOCK, prefix=True, spec=on,
              spec_max_draft=SPEC_DRAFT, prefix_budget_mb=SPEC_STORE_MB, **quant)
    engine = Engine(params, cfg, ServeConfig(**sv), device="cuda")

    def reqs(n=new):
        return [Request(prompt=prompt, max_new_tokens=n, rng=i) for i in range(batch)]

    if on:
        path = np.concatenate([prompt, np.asarray(seed[:new - 1])])
        engine.run([Request(prompt=path, max_new_tokens=1)])
    else:
        engine.run(reqs(4))
    engine.reset_metrics()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = engine.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    m = engine.metrics
    tokens = [out[rid].tokens for rid in sorted(out)]
    for t, rid in zip(tokens, sorted(out)):
        if len(t) != new or out[rid].finish_reason != "length":
            raise AssertionError(f"spec={on} batch {batch}: {len(t)} tokens, "
                                 f"{out[rid].finish_reason!r}")
        if not all(0 <= x < cfg.vocab_size for x in t):
            raise AssertionError(f"spec={on} batch {batch}: token outside the vocabulary")
    r = {"tokens": tokens, "steps": m.decode_steps,
         "launches": launches, "tok_s_slot": m.tokens_per_sec_per_chip / batch,
         "tokens_per_step": m.tokens_per_step, "accept_rate": m.draft_accept_rate,
         "proposed": m.draft_proposed, "accepted": m.draft_accepted, "wall_s": wall,
         "mean_step_ms": m.decode_s / max(m.decode_steps, 1) * 1e3}
    if profile:
        # 1 + k timed steps, then 1 + k a traced window, each up to G tokens
        k = VERIFY_PROFILE_STEPS
        n = ((PROFILE_ATTEMPTS + 1) * (k + 1) + 1) * (SPEC_DRAFT + 1)
        kernels = {"attention": QUANT_TC_EVENTS if quant else PAGED_TC_EVENTS}
        if quant:
            kernels["quant_mm"] = KERNEL_EVENTS["quant_mm"]
        r.update(decode_breakdown(engine, cfg, None, kernels, steps=k, requests=reqs(n)))
    del engine
    torch.cuda.empty_cache()
    return r


def spec_serve_phase(cfg, params, card: str) -> dict:
    """Phase 4c: bench.py's speculative trace on Llama-3-8B at full width,
    batch 1 and batch 8 (every row the same prompt), spec on and off; then
    the quantized engine (int8 KV, int8 weights) at batch 8 over 3 blocks +
    1 new tokens. Held: the paged kernel (kernel 9 when quantized) launched
    once per layer and decode step, the dequant-matmul 7 x 32 + 1 times a
    step, no plain version; and every emitted token, teacher-forced
    (``teacher_forced``), within the limit of the plain float32 reference's
    top logit.

    The limit. Spec-on and spec-off tokens are not held equal: the verify
    step's matmuls run G rows a slot where the one-token step runs one, so
    cuBLAS sums them in another order, the random model's bf16 logits tie
    within a rounding step often, and the first such tie that flips makes
    the two runs' contexts differ from there on. A correct bf16 path's
    emitted token can trail the reference's top logit by at most twice its
    own logit error, which the bf16 forward's largest difference from the
    float32 one measures (``noise``, over the bf16 modes' sequences); the
    spec-off run of the same mode, the one-token step phases 4 and 4b
    hold, shows how far its path's tokens trail (``off``: for the
    quantized mode its int8 KV and weights add their rounding). The limit
    is twice the larger of 2 x noise and off, so a correct verify step
    sits at half of it or below, and a wrong one, whose tokens are the
    argmax of other logits, trails by whole units of the logits' spread.

    Reported: tokens/s per slot, tokens per step, accept rate, the on/off
    ratio, tokens equal on/off, the share of emitted tokens that are the
    reference's argmax, the largest trail on and off, and the batch-8
    verify step's breakdown, bf16 and quantized."""
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, SPEC_BLOCK)
    L = cfg.n_layers
    res = {}
    modes = [(f"b{b}", b, SPEC_NEW, {}) for b in (1, 8)]
    modes.append(("b8_int8", 8, 3 * SPEC_BLOCK + 1,
                  dict(quant_kv="int8", quant_weights=True)))
    for label, batch, new, quant in modes:
        off = spec_mode(cfg, params, prompt, False, batch, new, **quant)
        on = spec_mode(cfg, params, prompt, True, batch, new, seed=off["tokens"][0],
                       profile=label in ("b8", "b8_int8"), **quant)
        for r in (on, off):
            la, steps = r["launches"], r["steps"]
            if quant:
                want = {"paged_decode_attention_quant": steps * L,
                        "quant_mm": steps * (7 * L + 1), "paged_decode_attention": 0}
            else:
                want = {"paged_decode_attention": steps * L,
                        "paged_decode_attention_quant": 0, "quant_mm": 0}
            want.update({k: 0 for k in la if k.endswith("_plain")})
            if steps == 0 or any(la[k] != v for k, v in want.items()):
                raise AssertionError(f"spec {label}: launches {la} != {want} "
                                     f"({steps} decode steps)")
        if on["accepted"] == 0:
            raise AssertionError(f"spec {label}: no draft was accepted")
        res[label] = {"on": on, "off": off, "quant": bool(quant), "new": new,
                      "batch": batch}
    t0 = time.perf_counter()
    noise = 0.0
    for r in res.values():
        seqs = r["on"]["tokens"] + r["off"]["tokens"]
        gaps, n = teacher_forced(params, cfg, prompt, seqs, r["quant"])
        r["gaps_on"], r["gaps_off"] = gaps[:r["batch"]], gaps[r["batch"]:]
        noise = max(noise, n)
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    for label, r in res.items():
        on, off, batch, new = r["on"], r["off"], r["batch"], r["new"]
        trail_on = max(float(g.max()) for g in r["gaps_on"])
        trail_off = max(float(g.max()) for g in r["gaps_off"])
        limit = 2 * max(2 * noise, trail_off)
        top_on = sum(int((g == 0).sum()) for g in r["gaps_on"])
        top_off = sum(int((g == 0).sum()) for g in r["gaps_off"])
        same = sum(a == b for x, y in zip(on["tokens"], off["tokens"])
                   for a, b in zip(x, y))
        log(f"serve spec {label} (Llama-3-8B, {new} new tokens, draft {SPEC_DRAFT}): "
            f"on {on['tok_s_slot']:.1f} tok/s/slot, {on['tokens_per_step']:.3f} "
            f"tokens/step, accept {on['accept_rate']:.4f} ({on['accepted']}/"
            f"{on['proposed']}), {on['steps']} steps of {on['mean_step_ms']:.2f} ms; "
            f"off {off['tok_s_slot']:.1f} tok/s/slot, {off['steps']} steps of "
            f"{off['mean_step_ms']:.2f} ms; on/off {on['tok_s_slot'] / off['tok_s_slot']:.3f}; "
            f"tokens equal on/off {same}/{batch * new}  [{card}]")
        log(f"serve spec {label} teacher-forced (float32 plain forward over each run's "
            f"tokens): the reference's argmax at {top_on}/{batch * new} positions on, "
            f"{top_off}/{batch * new} off; largest trail on {trail_on:.4e}, off "
            f"{trail_off:.4e}; bf16 noise {noise:.4e}; limit {limit:.4e} = 2 x max(2 x "
            f"noise, off)  [{card}]")
        if not trail_on <= limit:
            raise AssertionError(f"spec {label}: an emitted token trails the reference's "
                                 f"top logit by {trail_on:.4e}, over the limit {limit:.4e}")
        r.update(trail_on=trail_on, trail_off=trail_off, limit=limit, noise=noise)
    log(f"teacher-forced references: {ref_s:.1f} s")
    for label in ("b8", "b8_int8"):
        r = res[label]["on"]
        qmm = (f", quant_mm {r['profile_quant_mm_ms']:.2f} ms = "
               f"{r['profile_quant_mm_share']:.1%}" if "profile_quant_mm_ms" in r else "")
        log(f"verify step {label} (batch 8, G {SPEC_DRAFT + 1}, store warm): "
            f"{r['profile_step_ms']:.2f} ms wall, {r['profile_device_ms']:.2f} ms device "
            f"(busy {r['profile_device_busy']:.1%}), {r['profile_launches_per_step']:.0f} "
            f"kernel launches; decode attention {r['profile_attention_ms']:.2f} ms = "
            f"{r['profile_attention_share']:.1%}{qmm} of device time  [{card}]")
    return res


def kernel_modules() -> list:
    """Every module of ``tony_tpu_torch.ops`` that holds a kernel wrapper
    (the package exports a function named decode_attention, so the modules
    are imported by name)."""
    import importlib

    return [importlib.import_module(f"tony_tpu_torch.ops.{m}") for m in
            ("attention", "decode_attention", "fused_ce", "grouped_mm", "quant_mm",
             "overlap")]


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by name."""
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def reset_counts() -> None:
    """Every kernel wrapper's launch counter to 0."""
    for mod in kernel_modules():
        mod.reset_launches()


def has_kernel(key: str, kernel: str) -> bool:
    """Whether a profiler event's name is ``kernel`` (a whole word of it:
    ``ce_dh_kernel`` is not ``ce_dlogits_kernel``; ``tc::flash_dq_kernel``
    is the tensor-core instance only)."""
    return re.search(rf"\b{re.escape(kernel)}\b", key) is not None


# traced windows a profile may take: CUPTI drops an event now and then (2
# of 1800 quant_mm events once), and a window short of any is traced again
# rather than read
PROFILE_ATTEMPTS = 3
# verify steps a phase-4c window traces after its warm-up step. A quantized
# verify step enqueues about 16,800 kernels; with 1 + 4 steps a window (about
# 84,000 kernel events) a run on a slow host lost 3-10 of 900 quant_mm events
# in each of three windows, so a window traces 1 + 2
VERIFY_PROFILE_STEPS = 2


def profile_window(run, steps: int) -> dict:
    """``run()`` once under torch.profiler as its warm-up step (traced and
    discarded: the events right after the profiler starts can be lost),
    then ``steps`` times as the one active step. Returns the active
    window's kernel events (device side; profiler ranges excluded), host
    events, and each launch counter's delta over the window. A window
    whose trace holds fewer events of a kernel than the counters say were
    launched in it (``KERNEL_EVENTS``) is traced again, ``run()`` 1 +
    ``steps`` more times; after ``PROFILE_ATTEMPTS`` such windows it
    raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        ready = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: ready.append(p.key_averages())) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            before = launch_counts()
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
            after = launch_counts()
            prof.step()
        if not ready:
            raise AssertionError("torch.profiler delivered no trace")
        avg = ready[0]
        cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
        dev = [e for e in avg if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("ProfilerStep") and e.key not in CE_RANGES]
        host = [e for e in avg if e.device_type == cpu]
        delta = {k: after[k] - before[k] for k in after}
        want: dict[str, int] = {}
        for counter, names in KERNEL_EVENTS.items():
            for name in names:
                want[name] = want.get(name, 0) + delta.get(counter, 0)
        got = {name: sum(e.count for e in dev if has_kernel(e.key, name)) for name in want}
        counted = {name: (got[name], n) for name, n in want.items() if n}
        log(f"  profile events / launches in window {attempt}: "
            + ", ".join(f"{k} {a}/{b}" for k, (a, b) in counted.items()))
        short = {k: v for k, v in counted.items() if v[0] < v[1]}
        if not short:
            return {"dev": dev, "host": host, "launches": delta}
    raise AssertionError(f"profiler events short of the launch counters in "
                         f"{PROFILE_ATTEMPTS} windows (events, launches): {short}")


def decode_breakdown(engine, cfg, rng, kernels: dict[str, tuple[str, ...]],
                     steps: int = 8, requests=None) -> dict:
    """Where a full decode step's time goes, at 8 live slots of ~512
    positions (or over ``requests``, which must outlast every window
    ``profile_window`` may trace): ``steps`` steps timed on the host
    clock, then ``steps`` more under torch.profiler (after one warm-up
    step) for the device time by kernel. The busy share is device time per
    step over the unprofiled step's wall time; each entry of ``kernels``
    (label: the kernels' names, a split kernel and its merge say) gets
    their device ms per step and their share of device time."""
    from tony_tpu_torch.serve import Request

    if requests is None:
        requests = [Request(prompt=rng.integers(0, cfg.vocab_size, 512),
                            max_new_tokens=(PROFILE_ATTEMPTS + 1) * (steps + 1) + 4)
                    for _ in range(engine.serve.slots)]
    for r in requests:
        engine.submit(r)
    engine.step()                                 # admit all, first decode step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    window = profile_window(engine.step, steps)
    engine.run()
    dev, host = window["dev"], window["host"]
    device_us = sum(e.self_device_time_total for e in dev) / steps
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  profile: {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    if device_us == 0:
        raise AssertionError("torch.profiler recorded no device time")
    # the host side: CPU self time by op (under the profiler, so inflated),
    # and the kernel launches one step enqueues
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]:
        log(f"  host: {e.self_cpu_time_total / steps / 1e3:8.3f} ms/step "
            f"x{e.count // steps:<5d} {e.key[:60]}")
    launches = sum(e.count for e in host
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                                 "cuLaunchKernelEx"))
    out = {
        "profile_step_ms": step_s * 1e3,
        "profile_device_ms": device_us / 1e3,
        "profile_device_busy": device_us / 1e6 / step_s,
        "profile_launches_per_step": launches / steps,
    }
    for label, names in kernels.items():
        us = sum(e.self_device_time_total for e in dev
                 if any(has_kernel(e.key, k) for k in names)) / steps
        out[f"profile_{label}_ms"] = us / 1e3
        out[f"profile_{label}_share"] = us / device_us
    return out


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


def tensor_core_resources(log: str) -> list[dict]:
    """Registers, stack and spills of each tensor-core instance (namespace
    ``tc``, e.g. ``flash_fwd_kernel<128>``, ``gmm_fwd_kernel``,
    ``paged_quant_decode_kernel<1, int8>``, ``chunk_mm_kernel<0, 1>``) from
    nvcc's ``-Xptxas -v`` lines."""
    payloads = {"a": "int8", "13__nv_fp8_e4m3": "fp8_e4m3"}
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"2tc\d+(\w+?_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?"
                          r"(a|13__nv_fp8_e4m3)?)?", m.group(1))
            cur = None
            if k:
                args = [a for a in (k.group(2), k.group(3), payloads.get(k.group(4))) if a]
                cur = {"kernel": k.group(1) + (f"<{', '.join(args)}>" if args else "")}
            if cur:
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def log_resources(builds: list, source: str, expected: int) -> list[dict]:
    """Log the registers and spills of the tensor-core instances of
    ``source`` from this run's build log; raises unless there are
    ``expected`` of them (a library loaded from csrc/build/ has no log)."""
    built = builds[KERNEL_SOURCES.index(source)]
    resources = tensor_core_resources(built.log)
    if not built.seconds:
        log(f"{source} tensor-core instances: loaded from csrc/build/, no build log this run")
    elif len(resources) != expected:
        raise AssertionError(f"expected {expected} tensor-core instances of {source} in "
                             f"the build log, found {resources}")
    for r in resources:
        spill = r["spill_stores"] + r["spill_loads"]
        log(f"{source} tensor-core instance {r['kernel']}: {r['registers']} registers, "
            f"{r['stack']} bytes stack, {'SPILLS ' if spill else ''}{r['spill_stores']} / "
            f"{r['spill_loads']} bytes spill stores / loads")
    return resources


def flash_cases(dtype: torch.dtype, flush: torch.Tensor, label: str, B: int,
                S: int, H: int, Hkv: int, hd: int, causal: bool) -> list[dict]:
    """flash_fwd, flash_dq and flash_dkv at one shape: each against its
    plain version on the same inputs, its time, its bound, the plain
    version's time, and SDPA's forward / backward time as the library
    yardstick (the port never calls SDPA)."""
    from tony_tpu_torch.ops.attention import (
        _delta, _dkv, _dq, _fwd, flash_dkv_plain, flash_dq_plain, flash_fwd_plain,
        kernel_instance,
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
            "instance": kernel_instance(name, dtype, hd),
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
    yardstick; the port never calls it) and a note, or None and the
    reason. dW is float32, so its call asks for a float32 output; where
    this torch refuses that, the call with the inputs' output dtype stands
    in, and the note says so and why."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no torch._grouped_mm"
    tries = {"gmm_fwd": [lambda: torch._grouped_mm(a, w, offs)],
             "gmm_dx": [lambda: torch._grouped_mm(dy, w.transpose(-2, -1), offs)],
             "gmm_dw": [lambda: torch._grouped_mm(a.t(), dy, offs, out_dtype=torch.float32),
                        lambda: torch._grouped_mm(a.t(), dy, offs)]}[name]
    refused = []
    for fn in tries:
        try:
            out = fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
            refused.append(f"torch._grouped_mm refused: {str(e).strip().splitlines()[0][:100]}")
            continue
        if name == "gmm_dw":
            refused.append(f"{str(out.dtype).replace('torch.', '')} output")
        return fn, "; ".join(refused)
    return None, "; ".join(refused)


def gmm_cases(dtype: torch.dtype, flush: torch.Tensor, inputs: dict) -> list[dict]:
    """gmm_fwd, gmm_dx and gmm_dw in both SwiGLU directions at one dtype:
    each against its plain version on the same inputs, its time, its
    bound, the plain version's time and torch._grouped_mm's."""
    from tony_tpu_torch.ops.grouped_mm import (
        gmm_dw, gmm_dw_plain, gmm_dx, gmm_dx_plain, gmm_fwd, gmm_fwd_plain,
        kernel_instance,
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
            if name == "gmm_fwd":           # padding rows (zero x) give y exactly 0
                padding = (a == 0).all(dim=1)
                ok &= int(padding.sum()) == N - R
                ok &= int(torch.count_nonzero(got[padding])) == 0
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
                "instance": kernel_instance(name, dtype, MOE_BLOCK),
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


# --- phase 3e: the fused CE kernels against their plain versions --------------

# bench_1b4's loss head: 8 x 2048 rows, dim 2048, vocab 32,000; the ragged
# shape cuts rows and vocab off the 128-row and 128-column tiles
CE_SHAPE = (16384, 2048, 32000)
CE_RAGGED = (16300, 2048, 31992)
CE_KERNELS = ("ce_fwd", "ce_dh", "ce_dw")
# every CUDA kernel the CE launches enqueue (profile shares)
CE_CUDA_KERNELS = ("ce_fwd", "ce_fwd_merge", "ce_dlogits", "ce_dh", "ce_dw")


def ce_inputs(N: int, D: int, V: int, dtype: torch.dtype, poison: str = ""):
    """h ~ N(0, 1) (post-norm scale), W ~ N(0, 1/D) (init_params' scale),
    uniform targets with the first and last two columns pinned, and the
    mean's cotangent g = 1/N, as the train step hands it back. ``poison``:
    "rows" puts a NaN in row 5 and an inf in the last row of h, "weight"
    a NaN in W[2, 9]."""
    gen = torch.Generator(device="cuda").manual_seed(N + V)
    h = torch.randn((N, D), generator=gen, device="cuda")
    w = torch.randn((D, V), generator=gen, device="cuda") / math.sqrt(D)
    tgt = torch.randint(0, V, (N,), generator=gen, device="cuda")
    tgt[:3] = torch.tensor([0, V - 1, V - 2], device="cuda")
    if poison == "rows":
        h[5] = float("nan")
        h[N - 1, 3] = float("inf")
    elif poison == "weight":
        w[2, 9] = float("nan")
    g = torch.full((N,), 1.0 / N, device="cuda")
    return h.to(dtype), w.to(dtype), tgt, g


def ce_close(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
             what: str) -> tuple[bool, float, float, float]:
    """(ok, max |err| over finite entries, atol, rtol). The nonfinite masks
    must be equal. lse and tl are float32 sums of exact products (bf16
    inputs too) in another order, over 2048 terms per logit and 32,000
    logits per row: 1e-3 absolute on values near 10. dh and dW: float32,
    the same sums in another order (1e-4 relative); bf16, the kernel and
    the plain version round dlogits to bf16 at the same place and the
    result once, so an ulp or two of 2^-8, of the value or of the tensor's
    largest entry."""
    same_mask = torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want) & torch.isfinite(got)
    a, b = got[fin].float(), want[fin].float()
    if what in ("lse", "tl"):
        atol, rtol = 1e-3, 1e-5
    else:
        rtol = 2**-7 if dtype == torch.bfloat16 else 1e-4
        atol = rtol * (float(b.abs().max()) if b.numel() else 0.0) / 2
    err = (a - b).abs()
    ok = same_mask and not bool((err > atol + rtol * b.abs()).any())
    return ok, (err.max().item() if err.numel() else 0.0), atol, rtol


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits (a NaN equals a NaN of the
    same payload, which ``torch.equal`` denies)."""
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def ce_cases(dtype: torch.dtype, flush: torch.Tensor, shape=CE_SHAPE,
             poison: str = "", timed: bool = True) -> list[dict]:
    """ce_fwd, ce_dh and ce_dw against their plain versions on the same
    inputs (the backward from the plain lse, so each kernel is held on its
    own), each with the instance that ran; the backward launched twice,
    and its dh and dW must be bit-equal (``ok`` is false otherwise).
    ``timed``: each kernel's time beside its bound, its plain
    version's time and the scan head's (cuBLAS) time as the library
    yardstick: ``_scan_fwd`` for ce_fwd, the whole ``_scan_bwd`` for ce_dh
    and ce_dw. ce_dh's time is the backward's dh half (its launches alone);
    ce_dw's is its launches over every chunk from one chunk's real dlogits."""
    from tony_tpu_torch.ops import fused_ce as ce

    N, D, V = shape
    h, w, tgt, g = ce_inputs(N, D, V, dtype, poison)
    lse, tl = ce.ce_fwd(h, w, tgt)
    ref_lse, ref_tl = ce.ce_fwd_plain(h, w, tgt)
    dh, dw = ce.ce_bwd(h, w, tgt, ref_lse, g)
    # a second launch on the same inputs: no atomics, a fixed order
    dh2, dw2 = ce.ce_bwd(h, w, tgt, ref_lse, g)
    torch.cuda.synchronize()
    bit_equal = bits_equal(dh, dh2) and bits_equal(dw, dw2)
    del dh2, dw2
    held = {"ce_fwd": [("lse", lse, ref_lse), ("tl", tl, ref_tl)],
            "ce_dh": [("dh", dh, ce.ce_dh_plain(h, w, tgt, ref_lse, g))],
            "ce_dw": [("dW", dw, ce.ce_dw_plain(h, w, tgt, ref_lse, g))]}
    poisoned = None
    if poison == "rows":       # exactly the two poisoned rows' losses
        poisoned = (~torch.isfinite(lse - tl)).nonzero().flatten().tolist() == [5, N - 1]
    elif poison == "weight":   # every loss, dh and dW entry
        poisoned = not bool(torch.isfinite(lse - tl).any() or torch.isfinite(dh).any()
                            or torch.isfinite(dw).any())
    cases = []
    for name, pairs in held.items():
        checks = [ce_close(a, b, dtype, what) for what, a, b in pairs]
        cases.append({
            "name": name, "dtype": str(dtype).replace("torch.", ""), "N": N, "D": D,
            "V": V, "poison": poison, "ok": all(c[0] for c in checks) and poisoned
            is not False and (name == "ce_fwd" or bit_equal),
            "max_abs_err": max(c[1] for c in checks), "bit_equal": bit_equal,
            "atol": max(c[2] for c in checks), "rtol": max(c[3] for c in checks),
            "instance": ce.kernel_instance(name, dtype),
        })
    del dh, dw, held
    if not timed:
        return cases
    chunks = ce.dlogits_chunks(V)
    s0, s1 = chunks[0]
    dl = ce._dlogits(h.float() @ w[:, s0:s1].float(), ref_lse, tgt, g, s0,
                     h.dtype).to(h.dtype)
    dw_buf = torch.empty_like(w)

    def dw_pass():
        for a, b in chunks:
            ce.ce_dw_chunk(h, dl, dw_buf, a, b)

    runs = {
        "ce_fwd": (lambda: ce.ce_fwd(h, w, tgt), lambda: ce.ce_fwd_plain(h, w, tgt)),
        "ce_dh": (lambda: ce.ce_bwd(h, w, tgt, ref_lse, g, dw=False),
                  lambda: ce.ce_dh_plain(h, w, tgt, ref_lse, g)),
        "ce_dw": (dw_pass, lambda: ce.ce_dw_plain(h, w, tgt, ref_lse, g)),
    }
    scan_fwd = time_ms(lambda: ce._scan_fwd(h, w, tgt, 4096), flush, reps=5)
    scan_bwd = time_ms(lambda: ce._scan_bwd(h, w, tgt, ref_lse, g, 4096), flush, reps=5)
    whole_bwd = time_ms(lambda: ce.ce_bwd(h, w, tgt, ref_lse, g), flush, reps=5)
    item, ndv = h.element_size(), N * D * V
    hb, wb = N * D * item, D * V * item
    work = {"ce_fwd": (2 * ndv, hb + wb + 4 * N + 8 * N),
            "ce_dh": (4 * ndv, hb + wb + 12 * N + hb),
            "ce_dw": (2 * ndv, hb + N * V * item + wb)}
    for c in cases:
        kernel, plain = runs[c["name"]]
        ops, nbytes = work[c["name"]]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
        c.update({
            "ms": time_ms(kernel, flush, reps=5),
            "plain_ms": time_ms(plain, flush, reps=2),
            "library_ms": scan_fwd if c["name"] == "ce_fwd" else scan_bwd,
            "whole_bwd_ms": whole_bwd, "chunks": len(chunks),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops": ops, "bytes": nbytes,
        })
    return cases


# --- phase 3f: contiguous-cache decode attention (kernel 7) ---------------------

# bench.py's decode-kernel section: bench_1b4 with n_kv_heads 4 (H 16, Hkv 4,
# hd 128), 8 rows of a full 1024-position cache, block 128, as many layers
# as bench_1b4 has; then Llama-3-8B's shape (H 32, Hkv 8, hd 128, T 2048)
BENCH_KERN = dict(B=8, H=16, Hkv=4, hd=128, T=1024, block=128, layers=24)
LLAMA_LENGTHS = (2048, 5, 64, 1000, 1537, 700, 133, 1999)


def contiguous_case(label: str, B: int, H: int, Hkv: int, hd: int, T: int, G: int,
                    lengths_np: np.ndarray, dtype: torch.dtype, flush: torch.Tensor,
                    block: int = 128) -> dict:
    """Kernel 7 against its plain version on the same inputs (held to
    ``TOLERANCE``), beside the repeat-expanded ``reference_decode_attention``
    and SDPA over the repeat-expanded cache (both timed and compared only;
    the port calls neither), with its bound."""
    from tony_tpu_torch.ops.decode_attention import (
        _chunk, decode_attention, decode_attention_plain, kernel_instance,
        reference_decode_attention,
    )

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(700 + G + T + H)
    q = torch.randn((B, G, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, T, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, T, hd), generator=gen, device=dev).to(dtype)
    lengths = torch.as_tensor(lengths_np, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(hd)
    run = lambda: decode_attention(q, k, v, lengths, block=block)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    ref = decode_attention_plain(q.float(), k.float(), v.float(), lengths, scale=scale)
    err = (out.float() - ref).abs()
    atol, rtol = TOLERANCE[dtype]
    if not torch.isfinite(out).all() or bool((err > atol + rtol * ref.abs()).any()):
        raise AssertionError(f"decode_attention {label} G={G} {dtype}: max |err| "
                             f"{err.max().item():.3e} over atol={atol} rtol={rtol}")
    oracle = lambda: reference_decode_attention(q, k, v, lengths)  # noqa: E731
    oracle_err = (oracle().float() - ref).abs().max().item()
    rep = H // Hkv
    ke, ve = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    qs = q.permute(0, 2, 1, 3).contiguous()                  # [B, H, G, hd]
    lim = lengths.long()[:, None] - (G - 1) + torch.arange(G, device=dev)
    mask = (torch.arange(T, device=dev)[None, None, :] < lim[:, :, None])[:, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qs, ke, ve, attn_mask=mask)
    lib_err = (sdpa().permute(0, 2, 1, 3).float() - ref).abs().max().item()
    ms = time_ms(run, flush)
    plain_ms = time_ms(lambda: decode_attention_plain(q, k, v, lengths, scale=scale),
                       flush)
    oracle_ms = time_ms(oracle, flush)
    library_ms = time_ms(sdpa, flush)
    itemsize = q.element_size()
    # K/V up to each row's length, q, out and the lengths, each once
    kv_bytes = 2 * int(lengths_np.sum()) * Hkv * hd * itemsize
    io_bytes = 2 * q.numel() * itemsize + B * 4
    attended = sum(int(n) - (G - 1) + g for n in lengths_np for g in range(G))
    ops = 4 * attended * H * hd
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "label": label, "G": G, "dtype": str(dtype).replace("torch.", ""), "T": T,
        "block": min(block, T), "chunk": _chunk(min(block, T), hd, itemsize),
        "instance": kernel_instance("decode_attention", dtype, hd, min(block, T), G, rep),
        "max_abs_err": err.max().item(), "oracle_max_abs_err": oracle_err,
        "sdpa_max_abs_err": lib_err, "ms": ms, "plain_ms": plain_ms,
        "oracle_ms": oracle_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": kv_bytes + io_bytes,
    }


def contiguous_bench_loop(flush: torch.Tensor) -> dict:
    """bench.py's layer-scanned decode-kernel loop (:1046-1057) at its
    case in bf16: ``layers`` calls, each output the next call's query.
    The launch counters are zeroed just before one pass and read just
    after it (the path's launches); then the pass is timed, and the same
    loop through the plain version and through the repeat-expanded
    reference beside it."""
    from tony_tpu_torch.ops.decode_attention import (
        LAUNCHES, decode_attention, decode_attention_plain, reference_decode_attention,
        reset_launches,
    )

    c = BENCH_KERN
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((c["B"], c["H"], c["hd"]), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((c["B"], c["Hkv"], c["T"], c["hd"]), generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn(k.shape, generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.full((c["B"],), c["T"], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(c["hd"])

    def loop(fn):
        def run():
            o = q
            for _ in range(c["layers"]):
                o = fn(o)
            return o
        return run

    kernel = loop(lambda a: decode_attention(a, k, v, lengths, block=c["block"]))
    plain = loop(lambda a: decode_attention_plain(a[:, None], k, v, lengths,
                                                  scale=scale)[:, 0])
    oracle = loop(lambda a: reference_decode_attention(a, k, v, lengths))
    reset_launches()
    out = kernel()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["decode_attention"] != c["layers"] or launches["decode_attention_plain"]:
        raise AssertionError(f"bench loop launches {launches}, want {c['layers']} "
                             "kernel launches and no plain one")
    # each call rounds its output to bf16 and feeds it on, so the two loops
    # are held to one call's tolerance: the outputs, means of ~1e3 values
    # of v, are small, and a q that moved by an ulp moves the scores less
    want = plain().float()
    diff = (out.float() - want).abs()
    err = diff.max().item()
    atol, rtol = TOLERANCE[torch.bfloat16]
    if not torch.isfinite(out).all() or bool((diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"bench loop output differs from the plain loop's by {err}")
    return {"launches": launches["decode_attention"], "max_abs_err": err,
            "ms": time_ms(kernel, flush, reps=10), "plain_ms": time_ms(plain, flush, reps=10),
            "oracle_ms": time_ms(oracle, flush, reps=10)}


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
    instances = check_tensor_core_path(cfg)
    timed = [m["step_time_s"] for m in steps[2:]]      # 2 warm-up steps
    step_s = sum(timed) / len(timed)
    tokens = data.global_batch * data.seq_len
    flops = train_flops_per_token(cfg, data.seq_len)
    return {
        "losses": losses, "launches": launches, "wall_s": wall, "final": final,
        "instances": instances,
        "mean_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": tokens / step_s * flops / 989e12, "flops_per_token": flops,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ce_matmul": f32_matmul_route("cuda", cfg.dtype),
        **train_profile(cfg, data, FLASH_KERNELS),
    }


def train_ce_phase(card: str, scan: dict) -> dict:
    """Phase 5b: phase 5's fit() changed only by ``FitConfig(ce_impl=
    "pallas")``: the same weights, batches and schedule through the CE
    kernels. Every loss finite and the last below the first, step 1 within
    2e-2 of phase 5's (the same bf16 model and batch; only the head's
    sums differ), ce_fwd once a step and ce_dh / ce_dw once per vocab chunk
    a step, no plain version, the flash kernels as in phase 5."""
    from tony_tpu_torch.ops import attention, fused_ce
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = dense_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    steps: list[dict] = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launches()
    fused_ce.reset_launches()
    t0 = time.perf_counter()
    final = fit(FitConfig(model=cfg, data=data, steps=TRAIN_STEPS, log_every=1,
                          lr=3e-4, warmup_steps=2, mu_dtype="bfloat16", ce_impl="pallas",
                          on_metrics=steps.append), device="cuda")
    wall = time.perf_counter() - t0
    launches = {**attention.LAUNCHES, **fused_ce.LAUNCHES}
    losses = [m["loss"] for m in steps]
    for m in steps:
        log(f"train ce=pallas step {m['step']:2d}: loss {m['loss']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms  [{card}]")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    if abs(losses[0] - scan["losses"][0]) > 2e-2:
        raise AssertionError(f"step 1 loss {losses[0]} against the scan head's "
                             f"{scan['losses'][0]}")
    chunks = len(fused_ce.dlogits_chunks(cfg.vocab_size))
    want = {"ce_fwd": TRAIN_STEPS, "ce_dh": TRAIN_STEPS * chunks,
            "ce_dw": TRAIN_STEPS * chunks,
            **{n: cfg.n_layers * TRAIN_STEPS for n in FLASH_KERNELS}}
    want.update({f"{n}_plain": 0 for n in list(want)})
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launches {launches} != {want}")
    instances = check_tensor_core_path(dataclasses.replace(cfg, ce_impl="pallas"))
    timed = [m["step_time_s"] for m in steps[2:]]      # 2 warm-up steps
    step_s = sum(timed) / len(timed)
    tokens = data.global_batch * data.seq_len
    return {
        "losses": losses, "launches": launches, "wall_s": wall, "final": final,
        "chunks": chunks, "instances": instances, "mean_step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        **train_profile(dataclasses.replace(cfg, ce_impl="pallas"), data,
                        FLASH_KERNELS + CE_CUDA_KERNELS),
    }


def check_tensor_core_path(cfg) -> dict[str, str]:
    """The instance each flash kernel (and, for a MoE config, each
    grouped-matmul kernel; with ``ce_impl="pallas"``, each CE kernel)
    runs at ``cfg``'s dtype, head_dim and row tile, as the built libraries
    dispatch it; raises unless each is the tensor-core one (wgmma + TMA).
    The profiles then find every counted launch of these kernels among
    ``tc::`` events (``KERNEL_EVENTS``)."""
    from tony_tpu_torch.ops import attention, fused_ce, grouped_mm

    got = {n: attention.kernel_instance(n, cfg.dtype, cfg.head_dim) for n in FLASH_KERNELS}
    if cfg.n_experts:
        got.update({n: grouped_mm.kernel_instance(n, cfg.dtype, cfg.moe_group_block)
                    for n in GMM_KERNELS})
    if cfg.ce_impl == "pallas":
        got.update({n: fused_ce.kernel_instance(n, cfg.dtype) for n in CE_KERNELS})
    if any(v != "tensor cores" for v in got.values()):
        raise AssertionError(f"the training path is off its tensor-core instances: {got}")
    return got


def train_profile(cfg, data, kernels: tuple[str, ...]) -> dict:
    """One train step on the host clock, then one under torch.profiler
    (after a warm-up step): the device's busy share (device time over the
    unprofiled step's wall time), each named kernel's share of device time
    (``name`` matches ``name_kernel``), and the CE head's device time from
    its profiler ranges and its CUDA kernels."""
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

    def run():
        nonlocal state
        state, _ = step(state, *next(batches))

    window = profile_window(run, 1)
    dev, host = window["dev"], window["host"]
    device_us = sum(e.self_device_time_total for e in dev)
    if device_us == 0:
        raise AssertionError("torch.profiler recorded no device time")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  profile: {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
            f"{e.key[:90]}")
    share = {}
    for name in kernels:
        us = sum(e.self_device_time_total for e in dev if has_kernel(e.key, f"{name}_kernel"))
        share[name] = us / device_us
    # the CE head: the device time its ranges relate to the PyTorch ops
    # inside them, plus its CUDA kernels' (a ctypes launch is no PyTorch
    # op, so no range sees it)
    ce_us = sum(getattr(e, "device_time_total", 0) for e in host if e.key in CE_RANGES)
    ce_us += sum(e.self_device_time_total for e in dev
                 if any(has_kernel(e.key, f"{n}_kernel") for n in CE_CUDA_KERNELS))
    return {
        "profile_step_ms": step_s * 1e3, "profile_device_ms": device_us / 1e3,
        "profile_device_busy": device_us / 1e6 / step_s, "profile_share": share,
        "profile_ce_head_ms": ce_us / 1e3, "profile_ce_head_share": ce_us / device_us,
        "profile_launches": {k: v for k, v in window["launches"].items() if v},
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
    instances = check_tensor_core_path(cfg)
    timed = [m["step_time_s"] for m in steps[2:]]      # 2 warm-up steps
    step_s = sum(timed) / len(timed)
    tokens = data.global_batch * data.seq_len
    flops = train_flops_per_token(cfg, data.seq_len)
    return {
        "losses": losses, "aux": [m["aux"] for m in steps], "launches": launches,
        "instances": instances,
        "wall_s": wall, "final": final, "mean_step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "mfu": tokens / step_s * flops / 989e12,
        "flops_per_token": flops, "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        **train_profile(cfg, data, FLASH_KERNELS + GMM_KERNELS),
    }


# --- phase 3g: the ring's chunk matmul (kernel 14) ----------------------------------

# bench_1b4's ring chunks at fsdp 2 and global batch 8 x 2048 (8192 local
# rows): (label, M, K, N, a's view, b's view). Forward, gather dim 0: a
# column slice of x (row stride D 2048) against a row shard of wq/wk/wv or
# w1/w3; gather dim 1: x or the gate against a column shard of wo or w2.
# Backward at w1: dx reads the shard transposed (b K-major), dW the
# activations' slice transposed (a MN-major). The ragged N is no multiple
# of the 256-column tile (_pick_block cuts it into tiles of 8).
CHUNK_SHAPES = (("wq/wk/wv", 8192, 1024, 2048, "slice", "row"),
                ("w1/w3", 8192, 1024, 5504, "slice", "row"),
                ("wo", 8192, 2048, 1024, "dense", "row"),
                ("w2", 8192, 5504, 1024, "dense", "row"),
                ("w1 dx", 8192, 5504, 1024, "dense", "transposed"),
                ("w1 dW", 1024, 8192, 5504, "transposed", "row"),
                ("ragged N", 8192, 1024, 1000, "slice", "sliced"))
# kernel 14 against its plain version on the same views: products of either
# input type are exact in float32 and only the order of the float32 sums
# differs (up to 8192 terms), so within 1e-4 of the largest output
CHUNK_RTOL = 1e-4


def chunk_operands(M: int, K: int, N: int, a_view: str, b_view: str, dtype: torch.dtype):
    """a [M, K] and b [K, N] from a seed, as the views the ring hands the
    kernel (activations ~ N(0, 1), weights ~ N(0, 1/K))."""
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    if a_view == "slice":            # columns [K, 2K) of a [M, 2K] activation
        a = torch.randn((M, 2 * K), generator=gen, device="cuda").to(dtype)[:, K:]
    elif a_view == "transposed":     # a column slice of [K, 2M], transposed
        a = torch.randn((K, 2 * M), generator=gen, device="cuda").to(dtype)[:, :M].T
    else:
        a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w = torch.randn((K, N + 8), generator=gen, device="cuda") / math.sqrt(K)
    if b_view == "transposed":       # a [N, K] shard read as its transpose
        b = w[:, :N].T.contiguous().to(dtype).T
    elif b_view == "sliced":         # the first N columns of a wider shard
        b = w.to(dtype)[:, :N]
    else:
        b = w[:, :N].contiguous().to(dtype)
    return a, b


def chunk_cases(dtype: torch.dtype, flush: torch.Tensor) -> list[dict]:
    """Kernel 14 at each ring chunk: against its plain version, two
    launches bit-equal, the instance that ran, its time beside its bound,
    the plain version's and torch.matmul's (bf16 in, bf16 out: marked)."""
    from tony_tpu_torch.ops import overlap as ov

    cases = []
    for label, M, K, N, a_view, b_view in CHUNK_SHAPES:
        a, b = chunk_operands(M, K, N, a_view, b_view, dtype)
        got = ov.chunk_mm(a, b)
        # a second launch on the same inputs: no atomics, a fixed order
        bit_equal = bits_equal(got, ov.chunk_mm(a, b))
        want = ov.chunk_mm_plain(a, b)
        lib = torch.matmul(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        limit = CHUNK_RTOL * want.abs().max().item()
        lib_err = (lib.float() - want).abs().max().item()
        item = a.element_size()
        ops, nbytes = 2 * M * K * N, (M * K + K * N) * item + M * N * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
        cases.append({
            "label": label, "dtype": str(dtype).replace("torch.", ""), "M": M, "K": K,
            "N": N, "a": a_view, "b": b_view, "max_abs_err": err, "limit": limit,
            "bit_equal": bit_equal, "ok": err <= limit and bit_equal,
            "instance": ov.kernel_instance(dtype),
            "ms": time_ms(lambda: ov.chunk_mm(a, b), flush),
            "plain_ms": time_ms(lambda: ov.chunk_mm_plain(a, b), flush, reps=2),
            "library_ms": time_ms(lambda: torch.matmul(a, b), flush),
            "library_out": str(lib.dtype).replace("torch.", ""), "library_max_abs_err": lib_err,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops": ops, "bytes": nbytes,
        })
        del a, b, got, want, lib
    return cases


# --- phase 7: fit() at fsdp 2, two ranks on one card ------------------------------

FSDP = 2
FSDP_STEPS = 4
# the trunk projections the fsdp ring takes (models/llama.py _proj)
RING_PROJECTIONS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
FSDP_TIMEOUT_S = 420


def fsdp_rank(rank: int, port: int, out: str) -> int:
    """One rank of phase 7: bring up a gloo group over tcp://localhost on
    this card, then the port's own fit() at fsdp 2 with the ring's pallas
    form; write what it saw to ``out``."""
    import torch.distributed as dist

    from tony_tpu_torch.ops import attention, overlap
    from tony_tpu_torch.parallel.dist import transport
    from tony_tpu_torch.parallel.mesh import MeshShape, get_default_mesh
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=FSDP)
    cfg = dense_train_config()
    steps: list[dict] = []
    overlap.reset_launches()
    attention.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = fit(FitConfig(model=cfg, data=DataConfig(global_batch=8, seq_len=2048,
                                                     vocab_size=cfg.vocab_size),
                          mesh_shape=MeshShape(fsdp=FSDP), overlap_impl="pallas",
                          steps=FSDP_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                          mu_dtype="bfloat16", on_metrics=steps.append), device="cuda")
    wall = time.perf_counter() - t0
    mesh = get_default_mesh()
    res = {"rank": rank, "metrics": steps, "final": final, "wall_s": wall,
           "launches": {**overlap.LAUNCHES, **attention.LAUNCHES},
           "instance": overlap.kernel_instance(cfg.dtype),
           "transport": transport(mesh.axis("fsdp"), torch.device("cuda")),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def fsdp_phase(card: str, dense: dict) -> dict:
    """Phase 7: two rank processes on this card, each bringing up its gloo
    group and calling fit() on bench_1b4 at fsdp 2 with overlap_impl=
    "pallas", phase 5's recipe, data and initial parameters (each rank its
    blocks). Each step's loss within 2e-2 of phase 5's (the same bf16
    model and batches; the ring sums each projection's partial products
    in another order, and the schedule matches phase 5's up to step
    FSDP_STEPS); on each rank kernel 14 launched exactly the count the
    ring implies and its plain version never."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="fsdp-")
    outs = [f"{tmp}/rank{r}.json" for r in range(FSDP)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--fsdp-rank", str(r), str(port),
                               outs[r]]) for r in range(FSDP)]
    try:
        codes = [p.wait(timeout=max(1.0, FSDP_TIMEOUT_S - (time.perf_counter() - t0)))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"fsdp ranks exited {codes}")
    wall = time.perf_counter() - t0
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    cfg = dense_train_config()
    # kernel 14 a step: each trunk projection's ring runs n chunks in the
    # forward, n again in the backward's recompute (remat re-runs the
    # layer's projections; save_attn_kernel keeps q/k/v after RoPE but not
    # the matmuls that made them), n in dx's mirrored ring and n in dW's
    # reduce-scatter ring
    per_step = cfg.n_layers * len(RING_PROJECTIONS) * 4 * FSDP
    for r in ranks:
        want = {"chunk_mm": per_step * FSDP_STEPS, "chunk_mm_plain": 0,
                **{n: cfg.n_layers * FSDP_STEPS for n in FLASH_KERNELS},
                **{f"{n}_plain": 0 for n in FLASH_KERNELS}}
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"rank {r['rank']} launches {got} != {want}")
        if r["instance"] != "tensor cores":
            raise AssertionError(f"kernel 14 ran {r['instance']} in bf16")
    metrics = ranks[0]["metrics"]
    losses = [m["loss"] for m in metrics]
    if len(losses) != FSDP_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fsdp losses {losses}")
    if ranks[1]["metrics"]:
        raise AssertionError("rank 1 reported metrics: rank 0 alone reports")
    diffs = [abs(a - b) for a, b in zip(losses, dense["losses"])]
    if max(diffs) > 2e-2:
        raise AssertionError(f"fsdp losses {losses} against phase 5's "
                             f"{dense['losses'][:FSDP_STEPS]}")
    for m, ref in zip(metrics, dense["losses"]):
        log(f"train fsdp={FSDP} step {m['step']}: loss {m['loss']:.4f} (phase 5 "
            f"{ref:.4f}) grad_norm {m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms "
            f"over {ranks[0]['transport']}  [{card}]")
    timed = [m["step_time_s"] for m in metrics[2:]]     # 2 warm-up steps
    return {"ranks": ranks, "losses": losses, "loss_diffs": diffs, "wall_s": wall,
            "per_step": per_step, "mean_step_ms": sum(timed) / len(timed) * 1e3,
            "transport": ranks[0]["transport"]}


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

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    cases = []
    # the serving shapes (blk 64, hd 128: each block staged whole), the
    # verify step's (G 16, rows running past their written positions and
    # past the table), then two whose K+V per block exceed the 64 KB staging
    # budget, so the kernel stages each block in chunks
    shapes = [(torch.bfloat16, 1, 64, 128, ()), (torch.bfloat16, 5, 64, 128, ()),
              (torch.bfloat16, SPEC_DRAFT + 1, 64, 128, VERIFY_PAST),
              (torch.float32, 1, 64, 128, ()), (torch.float32, 5, 64, 128, ()),
              (torch.float32, 1, 128, 128, ()), (torch.float32, 5, 128, 256, ())]
    for dtype, G, blk, hd, past in shapes:
        c = decode_case(G, dtype, flush, blk=blk, hd=hd, past=past)
        cases.append(c)
        log(f"kernel paged_decode_attention G={G} {c['dtype']} ({c['instance']}) blk={blk} "
            f"hd={hd} chunk={c['chunk']}{f' past={past}' if past else ''}: max|err| "
            f"{c['max_abs_err']:.3e}  "
            f"{c['ms'] * 1e3:.1f} us  (bound {c['bound_ms'] * 1e3:.1f} us by "
            f"{c['bound_by']}, {c['bytes'] / 1e6:.2f} MB)  plain "
            f"{c['plain_ms'] * 1e3:.1f} us  sdpa {c['library_ms'] * 1e3:.1f} us "
            f"(max|err| {c['sdpa_max_abs_err']:.3e})  [{card}]")
    if not any(c["chunk"] < c["blk"] for c in cases):
        raise AssertionError("no case staged a block in chunks")
    # every bf16 case runs on the tensor cores, every fp32 case scalar
    wrong = [(c["G"], c["dtype"], c["instance"]) for c in cases
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"paged decode cases on an unexpected instance: {wrong}")
    log_resources(builds, "paged_decode_attention", 17)

    flash = []
    for label, B, S, H, Hkv, hd, causal in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for c in flash_cases(dtype, flush, label, B, S, H, Hkv, hd, causal):
                flash.append(c)
                log(f"kernel {c['name']} {label} {c['dtype']} ({c['instance']}) B={B} "
                    f"S={S} H={H} Hkv={Hkv} hd={hd} causal={causal}: max|err| "
                    f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} "
                    f"atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms']:.3f} ms  "
                    f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: "
                    f"{c['ops']:.4g} ops, {c['bytes'] / 1e6:.1f} MB)  plain "
                    f"{c['plain_ms']:.3f} ms  sdpa {c['library_ms']:.3f} ms  [{card}]")
    bad = [c for c in flash if not c["ok"]]
    if bad:
        raise AssertionError(f"flash kernels over tolerance: "
                             f"{[(c['name'], c['shape'], c['dtype']) for c in bad]}")
    # every bf16 kernel runs on the tensor cores, fp32 scalar
    wrong = [(c["name"], c["dtype"], c["instance"]) for c in flash
             if (c["instance"] == "tensor cores") != (c["dtype"] == "bfloat16")]
    if wrong:
        raise AssertionError(f"flash cases on an unexpected instance: {wrong}")
    log_resources(builds, "flash_attention", 6)

    inputs = gmm_inputs()
    log(f"grouped matmul inputs: {MOE_T} tokens x top-{MOE_K} = {inputs['routes']} "
        f"routes in {inputs['rows']} buffer rows; routes per expert {inputs['sizes']}")
    gmm = []
    for dtype in (torch.bfloat16, torch.float32):
        for c in gmm_cases(dtype, flush, inputs):
            gmm.append(c)
            lib = (f"{c['library_ms']:.3f} ms (max|err| {c['library_max_abs_err']:.3e}"
                   f"{'; ' + c['library_note'] if c['library_note'] else ''})"
                   if c["library_ms"] is not None else f"- ({c['library_note']})")
            log(f"kernel {c['name']} {c['direction']} {c['dtype']} ({c['instance']}) "
                f"rows={c['rows']} {c['d_in']}->{c['d_out']} E={c['experts']}: max|err| "
                f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} "
                f"atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms']:.3f} ms  "
                f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: {c['ops']:.4g} "
                f"ops, {c['bytes'] / 1e6:.1f} MB)  plain {c['plain_ms']:.3f} ms  "
                f"torch._grouped_mm {lib}  [{card}]")
    bad = [c for c in gmm if not c["ok"]]
    if bad:
        raise AssertionError(f"grouped matmul kernels over tolerance: "
                             f"{[(c['name'], c['direction'], c['dtype']) for c in bad]}")
    # every bf16 kernel at row tile 128 runs on wgmma + TMA, fp32 scalar
    wrong = [(c["name"], c["dtype"], c["instance"]) for c in gmm
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"grouped matmul cases on an unexpected instance: {wrong}")
    log_resources(builds, "grouped_mm", 3)
    del inputs

    # 3d: the quantized serving kernels. Decode attention over int8 and fp8
    # pools at the serving shapes, then float32 queries, then block 128 with
    # float32 queries (its dequantized K+V exceed the staging budget: two
    # chunks per block), then the NaN-scale rows
    qcases = []
    G16, vp = SPEC_DRAFT + 1, QUANT_VERIFY_PAST
    for kv, G, dtype, blk, past in (
            ("int8", 1, torch.bfloat16, 64, ()), ("int8", 5, torch.bfloat16, 64, ()),
            ("int8", G16, torch.bfloat16, 64, vp), ("fp8_e4m3", 1, torch.bfloat16, 64, ()),
            ("fp8_e4m3", 5, torch.bfloat16, 64, ()), ("fp8_e4m3", G16, torch.bfloat16, 64, vp),
            ("int8", 1, torch.float32, 64, ()), ("int8", 1, torch.float32, 128, ())):
        c = quant_decode_case(kv, G, dtype, flush, blk=blk, past=past)
        qcases.append(c)
        equal = " (bit-equal)" if c["instance"] == "tensor cores" else ""
        log(f"kernel paged_decode_attention_quant {kv} G={G} {c['dtype']} ({c['instance']}) "
            f"blk={blk} hd={c['hd']} chunk={c['chunk']}{f' past={past}' if past else ''}: "
            f"max|err| {c['max_abs_err']:.3e} "
            f"(atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms'] * 1e3:.1f} us  "
            f"(bound {c['bound_ms'] * 1e3:.1f} us by {c['bound_by']}, "
            f"{c['bytes'] / 1e6:.2f} MB)  plain {c['plain_ms'] * 1e3:.1f} us  sdpa on "
            f"dequantized K/V {c['library_ms'] * 1e3:.1f} us (max|err| "
            f"{c['sdpa_max_abs_err']:.3e})  kernel 8 on the dequantized pools "
            f"{c['kernel8_ms'] * 1e3:.1f} us{equal}  [{card}]")
    # the chunks are the scalar body's: a float32 case
    if not any(c["chunk"] < c["blk"] for c in qcases if c["instance"] == "scalar"):
        raise AssertionError("no quantized case staged a block in chunks")
    # every bf16 case runs on the tensor cores, every fp32 case scalar
    wrong = [(c["kv"], c["G"], c["dtype"], c["instance"]) for c in qcases
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"quantized decode cases on an unexpected instance: {wrong}")
    for kv in ("int8", "fp8_e4m3"):
        c = quant_decode_case(kv, 1, torch.bfloat16, flush, poison=True)
        log(f"kernel paged_decode_attention_quant {kv} (tensor cores): NaN scale on block "
            f"{c['poisoned_block']}, named by rows {c['rows_naming_it']}, reaches exactly "
            f"the rows naming it below their length, "
            f"{[b for b, h in enumerate(c['rows_hit']) if h]}  [{card}]")
    # the dequant-matmul at the decode step's 8 rows and a verify step's 16
    # (batch 1) and 128 (batch 8) in bf16, 8 in fp32
    mm = []
    for dtype, M in ((torch.bfloat16, 8), (torch.bfloat16, 16), (torch.bfloat16, 128),
                     (torch.float32, 8)):
        for label, D, N, _ in QUANT_MM_SHAPES:
            c = quant_mm_case(label, D, N, dtype, flush, M)
            mm.append(c)
            same = {True: " (rows bit-equal at M 1 and 8)", False: " (ROWS DIFFER)",
                    None: ""}[c["rows_equal"]]
            log(f"kernel quant_mm {label} {D}->{N} M={c['M']} {c['dtype']} ({c['instance']})"
                f"{same}: max|err| "
                f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} "
                f"atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms'] * 1e3:.1f} us  "
                f"(bound {c['bound_ms'] * 1e3:.1f} us by {c['bound_by']}, "
                f"{c['bytes'] / 1e6:.2f} MB)  plain {c['plain_ms'] * 1e3:.1f} us  "
                f"{c['library']} {c['library_ms'] * 1e3:.1f} us (max|err| "
                f"{c['library_max_abs_err']:.3e})  [{card}]")
    bad = [c for c in mm if not c["ok"]]
    if bad:
        raise AssertionError(f"quant_mm over tolerance or rows not bit-equal across M: "
                             f"{[(c['label'], c['M'], c['dtype']) for c in bad]}")
    # bf16 on the tensor cores, fp32 scalar
    wrong = [(c["label"], c["M"], c["dtype"], c["instance"]) for c in mm
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"quant_mm cases on an unexpected instance: {wrong}")
    log_resources(builds, "quant_mm", 5)
    from tony_tpu_torch.ops.quant_mm import card_shape, split_k

    sms, clusters = card_shape(torch.cuda.current_device())
    log(f"quant_mm split of D (from the shape and the card: {sms} SMs, clusters of 1-8 "
        f"CTAs held at once {clusters}): "
        + ", ".join(f"{label} {split_k(D, N, sms, clusters)}"
                    for label, D, N, _ in QUANT_MM_SHAPES) + f"  [{card}]")
    for M, what in ((8, "decode step, 8 slots"), (16, "verify step, batch 1, G 16"),
                    (128, "verify step, batch 8, G 16")):
        st = quant_mm_step(mm, M)
        log(f"quant_mm over one Llama-3-8B {what} ({st['launches']} launches, bf16, "
            f"M {M}): {st['ms']:.3f} ms (bound {st['bound_ms']:.3f} ms, "
            f"{st['bytes'] / 1e9:.3f} GB)  plain {st['plain_ms']:.3f} ms  "
            f"library {st['library_ms']:.3f} ms  [{card}]")
    step_mm = quant_mm_step(mm)
    # 3e: the fused CE kernels at bench_1b4's loss head, bf16 then fp32,
    # then the ragged shape and its NaN-row and NaN-weight cases (bf16)
    ce = []
    for dtype in (torch.bfloat16, torch.float32):
        for c in ce_cases(dtype, flush):
            ce.append(c)
            lib = "_scan_fwd" if c["name"] == "ce_fwd" else "whole _scan_bwd"
            log(f"kernel {c['name']} {c['dtype']} ({c['instance']}) N={c['N']} D={c['D']} "
                f"V={c['V']}{' (two launches bit-equal)' if c['bit_equal'] else ''}: "
                f"max|err| {c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} "
                f"atol={c['atol']:.3g} rtol={c['rtol']:.3g})  {c['ms']:.3f} ms "
                f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: {c['ops']:.4g} ops, "
                f"{c['bytes'] / 1e6:.1f} MB)  plain {c['plain_ms']:.3f} ms  {lib} "
                f"{c['library_ms']:.3f} ms; whole kernel bwd ({c['chunks']} chunks) "
                f"{c['whole_bwd_ms']:.3f} ms  [{card}]")
        torch.cuda.empty_cache()
    for poison in ("", "rows", "weight"):
        for c in ce_cases(torch.bfloat16, flush, CE_RAGGED, poison, timed=False):
            ce.append(c)
            log(f"kernel {c['name']} bf16 ({c['instance']}) ragged N={c['N']} V={c['V']} "
                f"{poison or 'finite'}: max|err| {c['max_abs_err']:.3e} "
                f"({'ok' if c['ok'] else 'OVER'} atol={c['atol']:.3g} "
                f"rtol={c['rtol']:.3g})  [{card}]")
    bad = [c for c in ce if not c["ok"]]
    if bad:
        raise AssertionError(f"CE kernels over tolerance, masks or bit-equality: "
                             f"{[(c['name'], c['dtype'], c['N'], c['poison']) for c in bad]}")
    # bf16 fwd, dh and dW on wgmma + TMA, fp32 scalar
    wrong = [(c["name"], c["dtype"], c["instance"]) for c in ce
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"CE cases on an unexpected instance: {wrong}")
    log_resources(builds, "fused_ce", 4)
    # 3f: kernel 7 at the reference bench's case (bf16 and fp32), its
    # layer-scanned loop, then Llama-3-8B's shape at G 1 (full rows) and
    # G 5 (ragged rows)
    bk = BENCH_KERN
    full = np.full(bk["B"], bk["T"], np.int32)
    contig = [contiguous_case("bench_1b4_kv4", bk["B"], bk["H"], bk["Hkv"], bk["hd"],
                              bk["T"], 1, full, dtype, flush, bk["block"])
              for dtype in (torch.bfloat16, torch.float32)]
    contig += [contiguous_case("llama3_8b", 8, 32, 8, 128, 2048, G, lens,
                               torch.bfloat16, flush)
               for G, lens in ((1, np.full(8, 2048, np.int32)),
                               (5, np.array(LLAMA_LENGTHS, np.int32)))]
    for c in contig:
        log(f"kernel decode_attention {c['label']} G={c['G']} {c['dtype']} ({c['instance']}) "
            f"T={c['T']} block={c['block']} chunk={c['chunk']}: max|err| "
            f"{c['max_abs_err']:.3e}  "
            f"{c['ms'] * 1e3:.1f} us  (bound {c['bound_ms'] * 1e3:.1f} us by "
            f"{c['bound_by']}, {c['bytes'] / 1e6:.2f} MB)  plain {c['plain_ms'] * 1e3:.1f} "
            f"us  reference_decode_attention {c['oracle_ms'] * 1e3:.1f} us (max|err| "
            f"{c['oracle_max_abs_err']:.3e})  sdpa {c['library_ms'] * 1e3:.1f} us "
            f"(max|err| {c['sdpa_max_abs_err']:.3e})  [{card}]")
    wrong = [(c["label"], c["G"], c["dtype"], c["instance"]) for c in contig
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"contiguous decode cases on an unexpected instance: {wrong}")
    loop = contiguous_bench_loop(flush)
    log(f"decode_attention bench loop ({bk['layers']} layers, each output the next "
        f"query, bf16): {loop['launches']} launches; {loop['ms']:.3f} ms  plain "
        f"{loop['plain_ms']:.3f} ms  reference_decode_attention {loop['oracle_ms']:.3f} "
        f"ms; max|err| against the plain loop {loop['max_abs_err']:.3e}  [{card}]")
    # 3g: kernel 14 at the ring's chunks, bf16 then fp32
    chunks = []
    for dtype in (torch.bfloat16, torch.float32):
        for c in chunk_cases(dtype, flush):
            chunks.append(c)
            log(f"kernel chunk_mm {c['label']} {c['dtype']} ({c['instance']}) M={c['M']} "
                f"K={c['K']} N={c['N']} a {c['a']} b {c['b']}"
                f"{' (two launches bit-equal)' if c['bit_equal'] else ' (LAUNCHES DIFFER)'}: "
                f"max|err| {c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'} limit "
                f"{c['limit']:.3g})  {c['ms']:.3f} ms  (bound {c['bound_ms']:.3f} ms by "
                f"{c['bound_by']}: {c['ops']:.4g} ops, {c['bytes'] / 1e6:.1f} MB)  plain "
                f"{c['plain_ms']:.3f} ms  torch.matmul {c['library_ms']:.3f} ms "
                f"({c['library_out']} output, max|err| {c['library_max_abs_err']:.3e})  "
                f"[{card}]")
        torch.cuda.empty_cache()
    bad = [(c["label"], c["dtype"]) for c in chunks if not c["ok"]]
    if bad:
        raise AssertionError(f"chunk_mm over tolerance or launches not bit-equal: {bad}")
    wrong = [(c["label"], c["dtype"], c["instance"]) for c in chunks
             if c["instance"] != ("tensor cores" if c["dtype"] == "bfloat16" else "scalar")]
    if wrong:
        raise AssertionError(f"chunk_mm cases on an unexpected instance: {wrong}")
    log_resources(builds, "overlap", 4)
    del flush
    torch.cuda.empty_cache()
    sync = moe_sync_check()
    log(f"moe_block at bench_moe's shape under set_sync_debug_mode('error'): no "
        f"host sync; launches {sync['launches']}, aux {sync['aux']:.5f}  [{card}]")

    cfg, params = llama_params()
    s = serve_phase(cfg, params)
    log(f"serve: {s['requests']} requests, {s['decode_steps']} decode steps, "
        f"{s['launches']} kernel launches; decode {s['decode_tokens_per_s']:.1f} "
        f"tok/s, mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, mean decode step "
        f"{s['mean_decode_step_ms']:.2f} ms, prefix hit {s['prefix_hit_tokens']} "
        f"tokens, {s['kv_bytes_per_token']:.0f} KV bytes/token, peak allocated "
        f"{s['peak_allocated_gb']:.2f} GB, wall {s['wall_s']:.1f} s  [{card}]")
    log(f"decode step (8 slots, ~512 positions): {s['profile_step_ms']:.2f} ms "
        f"wall, {s['profile_device_ms']:.2f} ms device (busy "
        f"{s['profile_device_busy']:.1%}), {s['profile_launches_per_step']:.0f} kernel "
        f"launches; decode attention {s['profile_attention_ms']:.2f} ms = "
        f"{s['profile_attention_share']:.1%} of device time  [{card}]")
    torch.cuda.empty_cache()

    qs = quant_serve_phase(cfg, params, s)
    ql = qs["launches"]
    log(f"serve quantized (int8 KV + int8 weights; phase 4 bf16 beside it): "
        f"{qs['requests']} requests, {qs['decode_steps']} decode steps "
        f"({s['decode_steps']}); launches paged_decode_attention_quant "
        f"{ql['paged_decode_attention_quant']}, quant_mm {ql['quant_mm']}; decode "
        f"{qs['decode_tokens_per_s']:.1f} tok/s ({s['decode_tokens_per_s']:.1f}), "
        f"mean TTFT {qs['mean_ttft_s'] * 1e3:.1f} ms ({s['mean_ttft_s'] * 1e3:.1f}), "
        f"mean decode step {qs['mean_decode_step_ms']:.2f} ms "
        f"({s['mean_decode_step_ms']:.2f}), {qs['kv_bytes_per_token']:.0f} KV "
        f"bytes/token ({s['kv_bytes_per_token']:.0f}), peak allocated "
        f"{qs['peak_allocated_gb']:.2f} GB ({s['peak_allocated_gb']:.2f}), prefix hit "
        f"{qs['prefix_hit_tokens']} tokens, int8 copy built in {qs['build_s']:.1f} s; "
        f"greedy tokens equal to phase 4's: {qs['greedy_equal_share']:.1%} "
        f"({qs['greedy_equal_requests']} of 8 requests whole)  [{card}]")
    log(f"quantized decode step (8 slots, ~512 positions): {qs['profile_step_ms']:.2f} "
        f"ms wall ({s['profile_step_ms']:.2f}), {qs['profile_device_ms']:.2f} ms device "
        f"({s['profile_device_ms']:.2f}), busy {qs['profile_device_busy']:.1%} "
        f"({s['profile_device_busy']:.1%}), {qs['profile_launches_per_step']:.0f} "
        f"kernel launches ({s['profile_launches_per_step']:.0f}); decode attention "
        f"{qs['profile_attention_ms']:.2f} ms = {qs['profile_attention_share']:.1%}, "
        f"quant_mm {qs['profile_quant_mm_ms']:.2f} ms = "
        f"{qs['profile_quant_mm_share']:.1%} of device time  [{card}]")
    spec_serve_phase(cfg, params, card)
    del params
    torch.cuda.empty_cache()
    quant_crosscheck(card)
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
        f"{t['launches']['flash_dkv']} (instances {t['instances']}); CE matmuls: "
        f"{t['ce_matmul']}  [{card}]")
    log(f"train step under torch.profiler: {t['profile_step_ms']:.1f} ms wall, "
        f"{t['profile_device_ms']:.1f} ms device (busy "
        f"{t['profile_device_busy']:.1%}); share of device time: "
        + ", ".join(f"{k} {v:.1%}" for k, v in t["profile_share"].items())
        + f"; scan CE head {t['profile_ce_head_ms']:.2f} ms = "
        f"{t['profile_ce_head_share']:.1%}  [{card}]")
    model_crosscheck(card, dense_train_config(), "attention_impl", "flash", "dot")
    torch.cuda.empty_cache()

    tc = train_ce_phase(card, t)
    lc = tc["launches"]
    log(f"train bench_1b4 with ce_impl=pallas (phase 5 beside it): {TRAIN_STEPS} steps, "
        f"loss {tc['losses'][0]:.4f} -> {tc['losses'][-1]:.4f} ({t['losses'][0]:.4f} -> "
        f"{t['losses'][-1]:.4f}); mean step {tc['mean_step_ms']:.1f} ms "
        f"({t['mean_step_ms']:.1f}), {tc['tokens_per_s']:.0f} tok/s "
        f"({t['tokens_per_s']:.0f}); peak allocated {tc['peak_allocated_gb']:.2f} GB "
        f"({t['peak_allocated_gb']:.2f}); launches ce_fwd {lc['ce_fwd']}, ce_dh "
        f"{lc['ce_dh']}, ce_dw {lc['ce_dw']} ({tc['chunks']} vocab chunks a step), "
        f"flash {lc['flash_fwd']}/{lc['flash_dq']}/{lc['flash_dkv']} (instances "
        f"{tc['instances']})  [{card}]")
    log(f"train step ce=pallas under torch.profiler: {tc['profile_step_ms']:.1f} ms "
        f"wall, {tc['profile_device_ms']:.1f} ms device (busy "
        f"{tc['profile_device_busy']:.1%}); share of device time (ms): "
        + ", ".join(f"{k} {v:.1%} ({v * tc['profile_device_ms']:.2f})"
                    for k, v in tc["profile_share"].items())
        + f"; CE head {tc['profile_ce_head_ms']:.2f} ms = "
        f"{tc['profile_ce_head_share']:.1%} (phase 5's scan head "
        f"{t['profile_ce_head_ms']:.2f} ms = {t['profile_ce_head_share']:.1%})  [{card}]")
    model_crosscheck(card, dense_train_config(), "ce_impl", "pallas", "scan")
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
        + f" (instances {m['instances']})  [{card}]")
    log(f"moe train step under torch.profiler: {m['profile_step_ms']:.1f} ms wall, "
        f"{m['profile_device_ms']:.1f} ms device (busy "
        f"{m['profile_device_busy']:.1%}); share of device time: "
        + ", ".join(f"{k} {v:.1%}" for k, v in m["profile_share"].items())
        + f"  [{card}]")
    model_crosscheck(card, moe_train_config(), "moe_gmm_impl", "pallas", "scan")
    torch.cuda.empty_cache()

    f = fsdp_phase(card, t)
    r0 = f["ranks"][0]
    log(f"train bench_1b4 at fsdp={FSDP} through fit() (two rank processes on this one "
        f"card, overlap_impl=pallas, phase 5's recipe, data and initial parameters): "
        f"{FSDP_STEPS} steps, loss {f['losses'][0]:.4f} -> {f['losses'][-1]:.4f}, max "
        f"|loss - phase 5's| {max(f['loss_diffs']):.3e}; mean step {f['mean_step_ms']:.1f} "
        f"ms over steps 3-{FSDP_STEPS} with the fsdp ring over {f['transport']} (two ranks "
        f"share the card and the ring's hops go through host memory: not an NCCL time); "
        f"kernel 14 launches per rank {r0['launches']['chunk_mm']} = {f['per_step']} a "
        f"step ({r0['instance']}), plain 0; peak allocated per rank "
        + ", ".join(f"{r['peak_allocated_gb']:.2f}" for r in f["ranks"])
        + f" GB; phase wall {f['wall_s']:.1f} s  [{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    main_case = cases[0]                            # G=1 bf16 at the serving shapes
    c7 = contig[0]                                  # the bench case, bf16
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "tony_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "tony_tpu/ops/decode_attention.py:214",
        "launches": loop["launches"], "max_abs_err": c7["max_abs_err"],
        "ms": c7["ms"], "plain_ms": c7["plain_ms"], "bound_ms": c7["bound_ms"],
        "bound_by": c7["bound_by"], "library_ms": c7["library_ms"],
    }, {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "tony_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "tony_tpu/ops/decode_attention.py:346",
        "launches": s["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    qmain = qcases[0]                               # int8 G=1 bf16 at the serving shapes
    kernels.append({
        "name": "paged_decode_attention_quant", "route": "cuda",
        "source": "tony_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "tony_tpu/ops/decode_attention.py:358",
        "launches": ql["paged_decode_attention_quant"],
        "max_abs_err": qmain["max_abs_err"], "ms": qmain["ms"],
        "plain_ms": qmain["plain_ms"], "bound_ms": qmain["bound_ms"],
        "bound_by": qmain["bound_by"], "library_ms": qmain["library_ms"],
    })
    # one decode step's 225 launches at their five shapes, bf16, summed
    kernels.append({
        "name": "quant_mm", "route": "cuda", "source": "tony_tpu_torch/csrc/quant_mm.cu",
        "replaces": "tony_tpu/ops/quant_mm.py:84", "launches": ql["quant_mm"],
        "max_abs_err": step_mm["max_abs_err"], "ms": step_mm["ms"],
        "plain_ms": step_mm["plain_ms"], "bound_ms": step_mm["bound_ms"],
        "bound_by": step_mm["bound_by"], "library_ms": step_mm["library_ms"],
    })
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
    replaces = {"ce_fwd": 164, "ce_dh": 204, "ce_dw": 236}
    for name, line in replaces.items():
        # the training path's shape and dtype: bench_1b4's head, bf16
        c = next(c for c in ce if c["name"] == name and c["dtype"] == "bfloat16"
                 and "ms" in c)
        kernels.append({
            "name": name, "route": "cuda", "source": "tony_tpu_torch/csrc/fused_ce.cu",
            "replaces": f"tony_tpu/ops/fused_ce.py:{line}",
            "launches": tc["launches"][name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    # kernel 14 at the largest forward chunk (w1/w3), bf16; launches: rank 0's
    # over phase 7's fit()
    c = next(c for c in chunks if c["label"] == "w1/w3" and c["dtype"] == "bfloat16")
    kernels.append({
        "name": "chunk_mm", "route": "cuda", "source": "tony_tpu_torch/csrc/overlap.cu",
        "replaces": "tony_tpu/ops/overlap.py:75", "launches": r0["launches"]["chunk_mm"],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fsdp-rank"]:      # one rank of phase 7, started by main()
        sys.exit(fsdp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
