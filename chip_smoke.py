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
   (head_dim 64), a Llama-3-8B GQA shape, one non-causal shape and phase
   9's three (a tp 2 rank's 8 heads; ring_flash's 1024-row chunk pairs at
   sp 2, causal and full, through the ring's per-pair entries on K/V views
   of one stacked buffer), in bf16 and fp32, each case logged with the
   instance that ran (every bf16 kernel on the tensor cores, wgmma with
   TMA staging; fp32 scalar), and the six tensor-core instances'
   registers and spills from the build log;
   then (3c) the grouped-matmul forward, dx and dW kernels against theirs
   at bench_moe's shapes (33,792 buffer rows from a real router draw with
   one expert forced empty, D 1024, F 2816, 8 experts, row tile 128), in
   both directions of the SwiGLU and in bf16 and fp32, each with its
   instance (all three in bf16 on wgmma with TMA staging, with their
   registers and spills; fp32 scalar), the forward's padding rows and the
   empty expert's dW exactly 0, and torch._grouped_mm's time beside each
   (dW's with a float32 output where this torch computes one), then the
   three again in bf16 at phase 8's layout (ep rank 0's 4 local experts
   over every token's routes, the other rank's riding in group 0) and at
   phase 11's (a tp 2 rank's 1408 of 2816 ffn columns of every expert: a
   128-column tail past the 256-column tiles), and one
   bench_moe MoE block forward and backward under
   ``set_sync_debug_mode("error")``;
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
   launch count must equal decode steps x layers. The prefill is
   match-invariant (fault F6, closed): request 7 served alone gives the
   busy engine's tokens exactly (there 256 of its tokens came from request
   6's blocks), and its first-token logits are bit-equal whether request 6
   was served before it or not. Then a few decode steps
   under torch.profiler: the device's busy share, the kernel's share of
   device time, the kernel launches a step enqueues and the host ops that
   take the most CPU time. Then (4b) the same weights and requests through the
   quantized engine (int8 KV pools, int8 decode weights): each quantized
   kernel's launches must equal decode steps x 32 (attention) and x 225
   (7 matmuls x 32 layers + lm_head), no plain version and no bf16 decode
   attention on the card, generate() equal to the engine; its profile
   beside phase 4's; then the same with fp8 e4m3 KV pools (held alike,
   without the profile). Then (4c) bench.py's speculative trace cut to
   a sixth of its length (769 new tokens; half until phase 16, a third
   until phase 17), to keep the script inside its time limit: a 64-token
   prompt, 129 new tokens, 15 drafts a step, greedy,
   prefix store on, at
   batch 1 and at batch 8 (one prompt for every row), spec off and then
   on, the spec-on engine's store seeded with the whole repeat (one
   prefill of the prompt and spec off's tokens) before its timed pass;
   then the quantized engine at batch 8 over 65 new tokens. The decode
   kernel (its quantized form when quantized) must run once per layer and
   step and the dequant-matmul 225 times a step, with no plain version;
   every run's emitted tokens are fed back through a plain float32
   forward, and each must be within a limit of that reference's top logit
   (the limit from the bf16 noise and the spec-off run's own trail,
   ``spec_serve_phase``); tokens/s per slot, tokens per step, accept rate
   and the on/off ratio are printed, and the bf16 batch-8 verify step's
   breakdown (the quantized one's was profiled until phase 17). Then a
   2-layer
   cross-check of the quantized engine on the card against the same
   engine on the CPU (plain versions). Then (4d) phase 4's engine and 16
   requests with ``chunk_tokens=256``: the decode kernel once per layer
   and decode step, the chunks the prompts imply, each greedy request's
   tokens teacher-forced as 4c holds them (the limit from phase 4's own
   trail), TTFT of the long prompts and the step times with and without
   a chunk beside phase 4's; and (4e) the KV handoff: a bf16 and an int8
   engine of phase 4's config export the shared 256-token prefix's
   blocks, which cross the wire form into a fresh engine: adopted (4, 0)
   then (0, 4), read back byte-equal, and the adopter's greedy tokens on
   a prompt extending the prefix equal the exporter's; (4f) the slot
   budget: ``derive_slot_budget`` for phase 4's Llama-3-8B config (max_len
   2048, kv_block 64) from probe decode steps at 1 and 2 slots on its
   weights, with int8 and fp8 pools and a 256-token shared prefix, every
   component printed, the prediction for 8 slots beside phase 4's peak;
   then phase 13 (below), while the Llama-3-8B weights are resident;
5. training: ``fit()`` on bench_1b4 at full width and depth (24 layers,
   batch 8 x 2048, the production recipe: flash attention, remat
   ``save_attn_kernel``, scan CE, bf16 Adam first moment), 10 steps from
   random weights; every loss finite and the last below the first, and
   each flash kernel launched exactly 24 x 10 times (twice as many forward
   launches would mean remat re-ran the forward kernel), on its
   tensor-core instance; every push carries the device memory keys
   (``hbm_mb``, ``hbm_peak_mb``, ``hbm_limit_mb``). Then one step
   under torch.profiler, and a 2-layer cross-check of one train step with
   the kernels against plain attention. Then (5b) the same fit() with
   ``ce_impl="pallas"``: step 1 within 2e-2 of phase 5's, ce_fwd once a
   step and ce_dh / ce_dw once per vocab chunk a step, all three on
   their tensor-core instances, no plain version; its profile, and a 2-layer
   cross-check against the scan head. (5c) phase 5's fit() for 2 steps
   under each of ``remat_policy="dots"`` and ``"checkpoint_dots"``: step 1
   within 1e-3 of phase 5's, the flash forward recomputed in the backward
   (2 launches a layer and step), peak memory and step time beside phase
   5's;
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
7. fsdp training: two rank processes on this one card (``--rank``; phases
   7-12 and 14 share them, one process start and one warm-up for all),
   each bringing up a gloo group over tcp://localhost and calling the
   port's own ``fit()`` on bench_1b4 at full width and depth with
   ``mesh_shape=MeshShape(fsdp=2)`` and ``overlap_impl="pallas"``, phase
   5's recipe, data (global batch 8 x 2048, 4 x 2048 a rank) and initial
   parameters (each rank its blocks), 2 steps: each loss within 2e-2 of
   phase 5's at the same step; on each rank kernel 14 launched exactly
   24 layers x 7 projections x 4 x 2 times a step (the ring's forward, its
   recompute under remat, dx and dW, two chunks each) on its tensor-core
   instance, its plain version never, and each flash kernel once per
   layer and step; each rank's comms ledger (``obs/comms.py``) equals
   ``dist.BYTES`` by kind, and both are printed with the ledger's rows.
   The step time is printed beside the transport (gloo,
   host-staged): two ranks on one card, not an NCCL time;
8. ep training: in the same two rank processes, each
   calling ``fit()`` on bench_moe at full width and depth at
   ``mesh_shape=MeshShape(ep=2)`` (each rank its 4 experts and 4 x 2048
   rows of phase 6's batch), phase 6's recipe, data and initial
   parameters, 2 steps with the blocking ep combine and 2 with the
   overlapped one (``moe_overlap_impl="pallas"``, the auto split into 4
   token chunks): each step's loss and aux within 2e-2 of phase 6's, and
   the two combines' losses side by side; on each rank the grouped-matmul
   kernels launched exactly phase 6's count per layer and step (times the
   chunks with the overlap) and each flash kernel once per layer and
   step, on their tensor-core instances, no plain version. Its step time,
   payload bytes a rank a step and peak memory are printed beside the
   transport (gloo, host-staged). 8b, in the same processes: bench_moe
   at full width and 2 layers at ep 2, 4 steps uninterrupted, then 2
   steps, a sharded checkpoint save, a restore into a template drawn from
   another seed (every leaf bit-equal to the saved one) and 2 more steps,
   the losses within 1e-3 of the uninterrupted ones; each rank's file
   size and the save and restore seconds;
9. tp and sp training: in the same two rank processes,
   each calling ``fit()`` on bench_1b4 at full width and depth from phase
   5's initial parameters and batches (8 x 2048), 2 steps each: (9a)
   ``mesh_shape=MeshShape(tp=2)``, Megatron's trunk on each rank's 8 of
   the 16 heads and half the FFN, flash attention and ``ce_impl="pallas"``
   over the whole vocab; (9b) ``MeshShape(sp=2)`` with
   ``attention_impl="ring_flash"``, each rank its 1024-position block, K/V
   and the dk/dv accumulators riding the ring. Each step's loss within
   5e-3 of phase 5's and its grad norm within 2e-3 of it, relative; on
   each rank the flash kernels (and in 9a the CE kernels) launched
   exactly as the path implies (9a: 24 a step each, CE as phase 5b; 9b:
   24 x (r + 1) a step on sp rank r, the chunk pairs it runs), on their
   tensor-core instances, no plain version. Each run's step time, its
   transport (gloo, host-staged: not an NCCL time), its payload a rank a
   step by collective kind and peak memory are printed;
10. pipeline training: in the same two rank processes,
   ``fit()`` on bench_1b4 at full width and depth at
   ``MeshShape(pp=2)`` (12 layers a stage) from phase 5's initial
   parameters and batches, flash attention, remat, ``ce_impl="pallas"``:
   2 steps under ``pp_schedule="gpipe"`` and 2 under ``"1f1b"`` at 4
   microbatches, then one step of each at 8. Each step's loss and grad
   norm held as phase 9 holds them; on each rank the flash and CE kernels
   launched exactly as its stage's schedule implies (GPipe: the flash
   forward 2 x 12 x M a step, dq and dk/dv 12 x M, the CE head once on
   every rank; 1F1B: the forward 3 x 12 x M on the first stage, 2 x on
   the last, the CE head M times on the last stage alone), kernel 14
   never, no plain version; each run's step times, transport, payload a
   rank a step by kind and peak memory per rank printed, M 4 beside M 8;
11. MoE at tp: in the same two rank processes, ``fit()`` on bench_moe at
   full width and depth at ``MeshShape(tp=2)`` (each rank every expert's
   1408 of 2816 ffn columns, 8 of the 16 heads, all 8 x 2048 rows), phase
   6's recipe, data and initial parameters, 2 steps: each step's loss and
   aux within 2e-2 of phase 6's and its grad norm within 1e-2 relative;
   kernels 11-13 and the flash kernels launched phase 6's count per layer
   and step on each rank, on their tensor-core instances, no plain
   version; step time, payload a rank a step by kind and peak memory per
   rank printed;
12. a capacity dispatch over a mesh: in the same two rank processes,
   ``fit()`` on bench_moe at full width cut to 2 layers with
   ``moe_dispatch="gather"`` at ``MeshShape(dp=2)``, 2 steps, against the
   same fit() in the main process: losses and aux within 2e-2, each flash
   kernel once per layer and step, no grouped kernel, payload printed;
13. the observability spine (``spine_phase``; every other phase runs
   with it disarmed, ``disarm_spine``), under a temporary app dir: bench_1b4
   at full width for 4 steps over a token file written from the
   synthetic stream, through the native loader, disarmed and then armed
   (trace, memory watch, health sentinel and series sampling every
   step), a profile window on step 2 of each: the journal holds
   ``train.fit`` and the sampled step spans, the verdict is healthy, the
   memory watch's peak is ``max_memory_allocated``'s, the profile's
   Chrome trace names kernels 1-3, the window's anatomy budget
   (``obs/anatomy.py``: compute, exposed collective, input wait,
   host-blocked) sums to its step time within 10%, every push carries the
   device memory keys, and the step thread's device-to-host
   copies and synchronizing calls in the profiled step are as many armed
   as disarmed (the armed step's wall and device ms printed beside the
   disarmed one's); ``TONY_CHAOS_NAN_STEP=2`` on a 4-layer bench_1b4
   trips the sentinel at step 2 with a forensics bundle; phase 4's
   traffic through an armed engine at the default strides: the
   registry's TTFT, TPOT and step histograms count what ``DecodeMetrics``
   counts;
14. elastic training: in the same two rank processes, after phase 12,
   ``fit()`` on bench_1b4 at full width cut to 2 layers with 2 members of
   1 rank (dp 2), 6 steps under the plan ``{2: (0,), 4: (0, 1)}``: member
   1 leaves the group at step 2 and waits, the group is formed again over
   rank 0 alone, and at step 4 over both, member 1 receiving the whole
   state by broadcast. Held: both ranks' summaries (2 reshards,
   generation 2, members [0, 1]); the journal's skips ``{"1": [2, -1]}``
   then ``{"1": [2, 4]}``; every step's loss within 2e-2 (phase 7's
   bound) of a one-process run in the main process fed the same
   ``reference_batches`` (member 0's rows while member 1 is out); the
   grown rank's parameters bit-equal to rank 0's after the broadcast
   (digests); each flash kernel once per layer and step a rank ran, no
   plain version. Printed: each boundary's seconds and broadcast bytes
   per rank, the step times, and the cost of the step's generation
   broadcast (3 int64 from rank 0 over the group);
15. the job path, after phase 5b: (15a) ``python -m tony_tpu_torch.cli
   submit`` of ``examples/llama_pretrain_torch`` (the port's client, AM,
   local backend, executor and ``pytorch`` runtime) into a temporary stage
   dir, one worker whose user process is ``train.py --preset bench_1b4
   --ce-impl pallas --steps 10``: phase 5b's whole FitConfig, the spine
   disarmed through the job's config. Held: exit 0, ``SUCCEEDED``, the
   history from ``APPLICATION_INITED`` to ``APPLICATION_FINISHED`` with one
   ``TASK_FINISHED``, the first push in the history carrying ``step``,
   ``loss``, ``tokens_per_sec_per_chip``, ``mfu``, ``hbm_mb`` and the
   ``startup_*`` keys (no ``metrics_dropped``), kernels 1-6 launched as in
   phase 5b with no plain version, and the ten losses (the worker's logged
   pushes) within 1e-3 relative of phase 5b's. Printed: the submit latency
   (``am/events.py`` ``submit_latency``), the job's wall time and p50 step
   beside phase 5b's. (15b) the same job with two workers and ``train.py
   --backend gloo`` (both ranks on this card, fsdp 2), bench_1b4 at full
   width cut to 2 layers with the pallas CE head, 3 steps: both workers
   finish, worker 0's losses within 2e-2 of the same fit() in this
   process, on each rank the flash kernels 2 x 3 and the CE kernels once a
   step (ce_dh, ce_dw once per vocab chunk), no plain version; the step
   times beside the transport.
16. gang serving, after phase 13 with this process's Llama-3-8B freed:
   ``tony serve`` driven as ``cmd_serve`` drives it (the port's client
   stages the job and launches its AM, which gang-schedules the port's
   decode hosts, ``python -m tony_tpu_torch.serve.gang``, each building
   Llama-3-8B from seed 0 on the card; the port's ``GangFrontend`` routes
   in this process; the spine disarmed through the job's config). (16a)
   two bf16 hosts, 8 slots, max_len 2048, the prefix store on, phase 4's
   16 requests (each sampled one seeded as phase 4 seeds it): every
   request finishes with 64 in-vocabulary tokens, requests 6 and 7 land
   on one host (prefix affinity), each request's tokens against phase
   4's (any that differ are reported with their first differing
   position). (16b) the same requests again in the same job under the
   reference's schedule, ``kill_container`` on decode:0 with an
   ``on_file`` trigger written once a stream on it has 8 tokens: every
   request finishes, at least one replay, every replay consistent, the
   ledger ``write_ledger`` wrote saying the same, decode:0 relaunched
   alone (attempts 2 and 1), and the port's ``check_invariants`` clean
   over the job's app dir (``serve-no-request-lost`` included). (16c) one prefill and one decode host with
   int8 KV pools and int8 decode weights: every prompt of 64 tokens or
   more handed over (Prefill, then ShipBlocks), shipped = adopted + freed
   blocks, bytes = blocks x ``block_bytes``; the share of greedy tokens
   equal to phase 4b's reported. Every host logs its kernel counts each
   time its engine drains and at SIGTERM: each line holds kernel 8 (16a,
   16b) or kernels 9 and 10 (16c) at its decode steps x 32 and x 225, no
   plain version. Printed: submit to ready per host, TTFT per request,
   the frontend's wall, the hosts' decode steps, the replays, the kill to
   the last request's end and to the relaunched host, the handoffs' bytes
   and ms.
17. the operator's tools, after phase 15 (the example job of 15a): (17a)
   ``python -m tony_tpu_torch.cli chaos`` runs it with ``checkpoint.dir``
   set (a checkpoint every 5 steps) under ``kill_container`` on worker:0
   with an ``on_file`` trigger on step 5's checkpoint, the trace (every
   step) and the health sentinel armed: exit 0 with ``--expect
   SUCCEEDED`` and a clean invariant report (the lease store's
   invariants included), worker:0 at 2 attempts, the resumed attempt
   starting at step 6 with each loss within 1e-3 relative of 15a's same
   step, kernels 1-6 launched by it at its 5 steps' counts, no plain
   version; (17b) on 17a's app dir ``tony trace`` (exit 0, fit's step and
   fit spans, the killed attempt's begin-only spans), ``health`` (exit 0,
   healthy), ``elastic`` (exit 2), ``top --once`` (one row, worker 0),
   ``rm-status`` (no app holds a lease), and the portal (``python -m
   tony_tpu_torch.obs.portal``: the app list and 17a's page, both 200);
   (17c) ``tony profile <app> --steps 2`` against the example job live
   on the card: the anatomy report's capture holds the flash and CE
   kernels' events; the job is then stopped.

Every profile traces one warm-up step first; a window holding fewer
events of a kernel than the launch counters say it launched is traced
again, and the script raises after three such windows. The flash,
grouped-matmul, decode, dequant-matmul and CE kernels' launches are
matched by their tensor-core kernels' names (``tc::``), so a window in
which one ran another instance is short of events; a decode breakdown's attention share
counts the merge of a row's splits (``tc::decode_merge_kernel``) too.

The last three lines are the ``kernels`` JSON (fourteen kernels; quant_mm's
times are one decode step's 225 launches at their five shapes, summed;
chunk_mm's are the w1/w3 forward chunk's, its launches rank 0's in phase 7;
each kernel's ``phases`` holds its launches on every path that runs it,
phases 7 and 8 rank 0's, phases 9 to 12, 14 and 15b each rank's, 16's
each host incarnation's last count line, 4b's fp8 run, 5c, 13, 15a and
17a's resumed worker included),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
    # request i samples from seed i + 1: the seed a fresh gang frontend with
    # serve.gang.seed 0 gives its (i + 1)-th request (seed x 1_000_003 + seq),
    # so phase 16a's gang draws what these requests draw
    reqs = [
        Request(prompt=p, max_new_tokens=64) if i % 2 == 0 else
        Request(prompt=p, max_new_tokens=64, temperature=0.8, top_k=50, rng=i + 1)
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
    chunks0 = engine.prefill_chunks
    t0 = time.perf_counter()
    ids = [engine.submit(r) for r in reqs]
    steps = serve_steps(engine)
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
    if m.prefix_hit_tokens < 256 and not engine.serve.chunk_tokens:
        raise AssertionError(f"prefix reuse did not fire ({m.prefix_hit_tokens})")
    decoding = [r["wall_ms"] for r in steps if r["decode_ms"] > 0]
    figures = {
        "requests": len(out), "decode_steps": m.decode_steps,
        "decode_tokens_per_s": m.decode_tokens_per_sec,
        "mean_ttft_s": m.ttft_avg_s,
        "mean_decode_step_ms": m.decode_s / m.decode_steps * 1e3,
        "prefix_hit_tokens": m.prefix_hit_tokens,
        "kv_bytes_per_token": m.kv_bytes_per_token,
        "wall_s": wall, "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "steps": steps, "prefill_chunks": engine.prefill_chunks - chunks0,
        # the engine steps with slots decoding: their wall time is what a
        # decoding stream waits between two tokens
        "p50_step_ms": float(np.median(decoding)), "max_step_ms": max(decoding),
    }
    return {i: out[rid] for i, rid in enumerate(ids)}, launches, figures


def serve_steps(engine) -> list[dict]:
    """Drive ``engine`` step by step until its queue and slots drain: each
    step's wall time, its decode step's own time (``DecodeMetrics``; 0
    where no slot decoded) and the prompt chunks it prefilled."""
    rows = []
    while engine.stats_snapshot()["queue_depth"] or engine.n_live:
        m = engine.metrics
        t0, d0, c0 = time.perf_counter(), m.decode_s, engine.prefill_chunks
        engine.step()
        rows.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                     "decode_ms": (m.decode_s - d0) * 1e3,
                     "chunks": engine.prefill_chunks - c0})
    return rows


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
    figures["prefix_path"] = prefix_path_evidence(cfg, params, reqs, sv, out[7].tokens)
    return {**figures, **breakdown, "launches": launches["paged_decode_attention"],
            "tokens": [c.tokens for c in out.values()],
            "ttft_s": [c.ttft_s for c in out.values()]}


def prefix_path_evidence(cfg, params, reqs, sv: dict, busy: list[int]) -> dict:
    """Fault F6, held (closed): request 7 served alone, prefilled from
    position 0, gives the tokens it gave in phase 4's busy engine, where
    its first 256 tokens' K/V came from request 6's blocks in the prefix
    store and only its 44-token tail was prefilled; and the engine's own
    prefill paths give bit-equal first-token logits, request 7 after
    request 6 (a 256-token hit; both served to their first token) against
    request 7 alone (the last prefill piece's logits, read through a spy on
    ``forward_with_cache``)."""
    from unittest import mock

    from tony_tpu_torch.serve import Engine, ServeConfig
    from tony_tpu_torch.serve import engine as engine_mod

    real = engine_mod.forward_with_cache
    last: dict = {}

    def spy(*args, **kw):
        logits, kv = real(*args, **kw)
        last["logits"] = logits.clone()
        return logits, kv

    runs = {}
    one = dataclasses.replace(reqs[7], max_new_tokens=1)
    for label, donors, req in (("hit", [reqs[6]], one), ("alone", [], reqs[7])):
        engine = Engine(params, cfg, ServeConfig(**sv), device=params["tok_emb"].device)
        for d in donors:
            engine.run([dataclasses.replace(d, max_new_tokens=1)])
        hit0 = engine.metrics.prefix_hit_tokens
        with mock.patch.object(engine_mod, "forward_with_cache", spy):
            rid = engine.submit(req)
            tokens = engine.run()[rid].tokens
        runs[label] = {"tokens": tokens, "logits": last["logits"],
                       "hit": engine.metrics.prefix_hit_tokens - hit0}
        del engine
    hit, alone = runs["hit"], runs["alone"]
    diff = float((hit["logits"] - alone["logits"]).abs().max())
    out = {"hit_tokens": hit["hit"], "logit_max_abs_diff": diff,
           "bits_equal": bits_equal(hit["logits"], alone["logits"]),
           "first_diff": next((j for j, (x, y) in enumerate(zip(alone["tokens"], busy))
                               if x != y), None)}
    if (hit["hit"] != 256 or alone["hit"] != 0 or not out["bits_equal"]
            or alone["tokens"] != busy or hit["tokens"] != busy[:1]):
        raise AssertionError(f"4: the prefill is not match-invariant (fault F6): {out}")
    return out


def quant_serve_phase(cfg, params, bf16: dict, quant_kv: str = "int8",
                      breakdown: bool = True) -> dict:
    """Phase 4b: the same weights and requests through the quantized engine
    (``quant_kv`` KV pools: int8, then fp8 e4m3; int8 decode weights). Per
    decode step the quantized attention runs once per layer and the
    dequant-matmul 7 x 32 + 1 times; no plain version and no bf16 decode
    attention on the card; generate() equal to the engine on request 0;
    with ``breakdown`` the decode step's profile; and, reported only, the
    share of greedy tokens equal to phase 4's."""
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.serve import Engine, ServeConfig

    sv = dict(slots=8, max_len=2048, kv_block=64, prefix=True, quant_kv=quant_kv,
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
    if breakdown:
        breakdown = decode_breakdown(engine, cfg, rng, {
            "attention": QUANT_TC_EVENTS, "quant_mm": KERNEL_EVENTS["quant_mm"]})
    else:
        breakdown = {}
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
            "tokens": [c.tokens for c in out.values()],
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
SPEC_NEW = 2 * SPEC_BLOCK + 1     # a sixth of bench.py's 769 (a third until phase 17): the
#                                   run's time limit
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
    none, and a whole pass would cost as much as the timed one.
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
    the quantized engine (int8 KV, int8 weights) at batch 8 over 1 block +
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
    reference's argmax, the largest trail on and off, and the bf16 batch-8
    verify step's breakdown (the quantized one's 30,267 launches a step
    took about 90 s of profile windows and reading, and it is no longer
    profiled: the run's time limit)."""
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, SPEC_BLOCK)
    L = cfg.n_layers
    res = {}
    modes = [(f"b{b}", b, SPEC_NEW, {}) for b in (1, 8)]
    modes.append(("b8_int8", 8, SPEC_BLOCK + 1,
                  dict(quant_kv="int8", quant_weights=True)))
    for label, batch, new, quant in modes:
        off = spec_mode(cfg, params, prompt, False, batch, new, **quant)
        on = spec_mode(cfg, params, prompt, True, batch, new, seed=off["tokens"][0],
                       profile=label == "b8", **quant)
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
    r = res["b8"]["on"]
    log(f"verify step b8 (batch 8, G {SPEC_DRAFT + 1}, store warm): "
        f"{r['profile_step_ms']:.2f} ms wall, {r['profile_device_ms']:.2f} ms device "
        f"(busy {r['profile_device_busy']:.1%}), {r['profile_launches_per_step']:.0f} "
        f"kernel launches; decode attention {r['profile_attention_ms']:.2f} ms = "
        f"{r['profile_attention_share']:.1%} of device time  [{card}]")
    return res


# --- phase 4d: chunked prefill at full width -----------------------------------

# phase 4's engine with prompts past this many tokens prefilled a chunk per
# engine step (4 kv blocks of 64)
CHUNK_TOKENS = 256


def chunked_serve_phase(cfg, params, bf16: dict) -> dict:
    """Phase 4d: phase 4's engine, weights and 16 requests with
    ``chunk_tokens=CHUNK_TOKENS``. Held: the paged decode kernel once per
    layer and decode step, no plain version; as many chunks as the
    prompts imply (a prompt of n > 256 tokens ceil(n / 256), the others
    none: the two sharing a prefix are admitted in one step, so neither
    finds the other's blocks registered yet); and each greedy request's
    tokens, teacher-forced through the plain float32 forward
    (``teacher_forced``), within the limit of phase 4c's rule: twice the
    larger of twice the bf16 noise and how far phase 4's unchunked tokens
    of the same request trail. A chunk attends the bf16 K/V earlier chunks
    wrote, where an unchunked prefill attends its own: the same values,
    summed by other matmul shapes, so near-ties may part. Reported: TTFT of
    the prompts over 256 tokens beside phase 4's, the decode step's time
    and the step's wall time while a prompt chunks beside the other steps
    and phase 4's."""
    from tony_tpu_torch.serve import Engine, ServeConfig

    sv = dict(slots=8, max_len=2048, kv_block=64, prefix=True, chunk_tokens=CHUNK_TOKENS)
    engine = Engine(params, cfg, ServeConfig(**sv), device="cuda")
    prompts, reqs, rng = serve_requests(cfg)
    out, launches, figures = serve_run(engine, cfg, reqs, rng)
    del engine
    torch.cuda.empty_cache()
    want = figures["decode_steps"] * cfg.n_layers
    if launches["paged_decode_attention"] != want or launches["paged_decode_attention_plain"]:
        raise AssertionError(f"chunked: launches {launches} != decode steps x {cfg.n_layers}")
    long = [i for i, p in enumerate(prompts) if len(p) > CHUNK_TOKENS]
    chunks = sum(-(-len(prompts[i]) // CHUNK_TOKENS) for i in long)
    if figures["prefill_chunks"] != chunks:
        raise AssertionError(f"chunked: {figures['prefill_chunks']} chunks, the prompts "
                             f"imply {chunks}")
    greedy = [i for i in range(len(reqs)) if i % 2 == 0]
    gaps_on, gaps_off, noise = [], [], 0.0
    for i in greedy:
        gaps, n = teacher_forced(params, cfg, prompts[i], [out[i].tokens, bf16["tokens"][i]],
                                 False)
        gaps_on.append(gaps[0])
        gaps_off.append(gaps[1])
        noise = max(noise, n)
        torch.cuda.empty_cache()
    trail_on = max(float(g.max()) for g in gaps_on)
    trail_off = max(float(g.max()) for g in gaps_off)
    limit = 2 * max(2 * noise, trail_off)
    if not trail_on <= limit:
        raise AssertionError(f"chunked: an emitted token trails the reference's top logit by "
                             f"{trail_on:.4e}, over the limit {limit:.4e}")
    rows = figures["steps"]
    chunking = [r for r in rows if r["chunks"] and r["decode_ms"]]
    plain = [r for r in rows if not r["chunks"] and r["decode_ms"]]
    mean = lambda xs: sum(xs) / len(xs) if xs else math.nan  # noqa: E731
    return {**figures, "launches": launches["paged_decode_attention"], "chunks": chunks,
            "long": long, "trail_on": trail_on, "trail_off": trail_off, "noise": noise,
            "limit": limit,
            "equal": sum(out[i].tokens == bf16["tokens"][i] for i in greedy),
            "top": sum(int((g == 0).sum()) for g in gaps_on), "greedy": len(greedy),
            "ttft_long_s": mean([out[i].ttft_s for i in long]),
            "ttft_long_phase4_s": mean([bf16["ttft_s"][i] for i in long]),
            "decode_ms_chunking": mean([r["decode_ms"] for r in chunking]),
            "decode_ms_other": mean([r["decode_ms"] for r in plain]),
            "wall_ms_chunking": mean([r["wall_ms"] for r in chunking]),
            "wall_ms_other": mean([r["wall_ms"] for r in plain]),
            "steps_chunking": len(chunking)}


# --- phase 4e: the blockwise KV handoff between engines ---------------------------

HANDOFF_PREFIX = 256
HANDOFF_NEW = 32


def handoff_phase(cfg, params) -> dict:
    """Phase 4e: for a bf16 engine and an int8 one (int8 KV pools and int8
    decode weights), each with phase 4's ServeConfig on phase 4's weights:
    the exporter serves request 6 (whose first 256 tokens request 7
    shares) and exports the shared prefix's blocks; they cross the wire
    form (``pack_payload`` / ``unpack_payload``) and a fresh engine of the
    same config adopts them. Held: the first adopt takes every block and a
    second frees them all; the adopted blocks and scale rows, read back,
    byte-equal to the export; request 7's greedy tokens on the adopter
    equal the exporter's served from its own store (both a tail prefill
    over the same bytes, then the same decode steps), both hitting the
    whole prefix; the decode kernel (kernel 9 when quantized) once per
    layer and decode step, no plain version."""
    from tony_tpu_torch.serve import Engine, Request, ServeConfig
    from tony_tpu_torch.serve.cache import export_blocks, pack_payload, unpack_payload

    prompts, _, _ = serve_requests(cfg)
    prefix = prompts[6][:HANDOFF_PREFIX].tolist()
    out = {}
    for label, quant in (("bf16", {}), ("int8", dict(quant_kv="int8", quant_weights=True))):
        sv = dict(slots=8, max_len=2048, kv_block=64, prefix=True, **quant)
        src = Engine(params, cfg, ServeConfig(**sv), device="cuda")
        src.run([Request(prompt=prompts[6], max_new_tokens=1)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        covered, payload = src.export_prefix_blocks(prefix)
        export_s = time.perf_counter() - t0
        wire = pack_payload(payload)
        back = unpack_payload(**wire)
        n = payload.n_blocks
        dst = Engine(params, cfg, ServeConfig(**sv), device="cuda")
        t0 = time.perf_counter()
        first = dst.adopt_blocks(covered, back)
        torch.cuda.synchronize()
        adopt_s = time.perf_counter() - t0
        second = dst.adopt_blocks(covered, back)
        if covered != prefix or (first, second) != ((n, 0), (0, n)):
            raise AssertionError(f"handoff {label}: covered {len(covered)} tokens, adopt "
                                 f"{first} then {second}, not ({n}, 0) then (0, {n})")
        again = export_blocks(dst.cache, list(dst._store.match(covered, len(covered)).full))
        parts = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
        for part in parts:
            a, b = getattr(again, part), getattr(payload, part)
            if a.dtype != b.dtype or not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise AssertionError(f"handoff {label}: adopted {part} differs from the export")
        tokens, launches = [], []
        for engine in (dst, src):
            reset_counts()
            res = engine.run([Request(prompt=prompts[7], max_new_tokens=HANDOFF_NEW)])
            c = next(iter(res.values()))
            counts = launch_counts()
            kernel = "paged_decode_attention_quant" if quant else "paged_decode_attention"
            steps = engine.metrics.decode_steps
            if counts[kernel] != (HANDOFF_NEW - 1) * cfg.n_layers or any(
                    v for k, v in counts.items() if k.endswith("_plain")):
                raise AssertionError(f"handoff {label}: launches {counts} ({steps} steps)")
            tokens.append(c.tokens)
            launches.append(counts[kernel])
        hits = [e.metrics.prefix_hit_tokens for e in (dst, src)]
        if tokens[0] != tokens[1] or hits[0] < HANDOFF_PREFIX:
            raise AssertionError(f"handoff {label}: adopter's tokens {tokens[0][:8]}... differ "
                                 f"from the exporter's {tokens[1][:8]}..., or prefix hits {hits}")
        out[label] = {"blocks": n, "payload_bytes": payload.nbytes,
                      "wire_bytes": sum(len(v) for v in wire.values() if isinstance(v, bytes)),
                      "export_s": export_s, "adopt_s": adopt_s, "hits": hits,
                      "launches": launches[0], "first": first, "second": second}
        del src, dst, payload, back, again
        torch.cuda.empty_cache()
    return out


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

# (label, B, S, H, Hkv, hd, causal, pair): the last three are phase 9's
# shapes, each tp 2 rank's 8 heads and sp 2's ring_flash chunk pairs (the
# diagonal causal, the one below it full), the pairs through the ring's
# per-pair entries with K/V views of one stacked buffer, as a hop gives them
FLASH_SHAPES = (
    ("bench_1b4", 8, 2048, 16, 16, 128, True, False),
    ("bench_moe", 8, 2048, 16, 16, 64, True, False),
    ("llama3_8b_gqa", 2, 2048, 32, 8, 128, True, False),
    ("full", 2, 2048, 16, 16, 128, False, False),
    ("tp2_rank", 8, 2048, 8, 8, 128, True, False),
    ("ring_pair_diagonal", 8, 1024, 16, 16, 128, True, True),
    ("ring_pair_below", 8, 1024, 16, 16, 128, False, True),
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
                S: int, H: int, Hkv: int, hd: int, causal: bool,
                pair: bool) -> list[dict]:
    """flash_fwd, flash_dq and flash_dkv at one shape: each against its
    plain version on the same inputs, its time, its bound, the plain
    version's time, and SDPA's forward / backward time as the library
    yardstick (the port never calls SDPA). A ring chunk ``pair`` runs
    through ring_flash's entries (``flash_chunk_fwd`` / ``flash_chunk_bwd``)
    on K/V views of one stacked ``[2, B, S, Hkv, hd]`` buffer."""
    from tony_tpu_torch.ops.attention import (
        _delta, _dkv, _dq, _fwd, flash_chunk_bwd, flash_chunk_fwd, flash_dkv_plain,
        flash_dq_plain, flash_fwd_plain, kernel_instance,
    )

    gen = torch.Generator(device="cuda").manual_seed(S + H + Hkv)
    q, do = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    if pair:
        kv = torch.randn((2, B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
        k, v = kv[0], kv[1]
    else:
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
    scale = 1.0 / math.sqrt(hd)
    ref_out, ref_lse = flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    delta = _delta(do, ref_out)
    if pair:
        out, lse = flash_chunk_fwd(q, k, v, scale=scale, causal=causal)
        dq, dk, dv = flash_chunk_bwd(q, k, v, do, ref_lse, delta, scale=scale,
                                     causal=causal)
    else:
        out, lse = _fwd(q, k, v, scale, causal)
        dq = _dq(q, k, v, do, ref_lse, delta, scale, causal)
        dk, dv = _dkv(q, k, v, do, ref_lse, delta, scale, causal)
    got = {"flash_fwd": (out, lse), "flash_dq": (dq,), "flash_dkv": (dk, dv)}
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


def gmm_inputs(ep: int = 1, tp: int = 1) -> dict:
    """bench_moe's grouped-matmul operands, float32 on the card: a real
    router draw (normal activations, a float32 router scaled as
    ``init_moe_params`` scales it) with expert 7 forced empty, its top-2
    routes laid out as the MoE block lays them out (``route_rows``), the
    buffer's routed rows normal and its padding rows zero; the weights and
    the output grads of both SwiGLU directions (w1/w3: D -> F, w2: F -> D).
    With ``ep`` above 1, ep rank 0's layout at phase 8's shape: every
    token's routes (the batch's rows gathered over ep), those to the rank's
    E / ep experts in their groups, the others riding along in group 0
    (``parallel/moe.py`` ``_chunk_ffn``). With ``tp`` above 1, a tp rank's
    block at phase 11's shape: every expert's routes, each expert's
    ``F / tp`` ffn columns (1408 at tp 2: 5.5 of the kernels' 256-column
    tiles, so every forward and dW launch has a 128-column tail)."""
    from tony_tpu_torch.parallel.moe import (
        MoEConfig, _route_tokens, _top_k_select, route_rows,
    )

    T, D, F, E = MOE_T, MOE_D, MOE_F // tp, MOE_E
    gen = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    flat = randn(T, D)
    logits = flat @ (randn(D, E) / math.sqrt(D))
    logits[:, E - 1] = -1e9                     # expert 7 receives no route
    sel = _top_k_select(torch.softmax(logits, dim=-1),
                        MoEConfig(dim=D, ffn_dim=F, n_experts=E, top_k=MOE_K))[0]
    if ep > 1:
        E //= ep
        sel = torch.where(sel < E, sel, 0)
    dst, sizes, tile_group = route_rows(sel.reshape(-1), E, MOE_BLOCK)
    N, R = tile_group.shape[0] * MOE_BLOCK, dst.shape[0]

    def rows(src: torch.Tensor) -> torch.Tensor:
        return src.new_zeros((N, src.shape[1])).index_copy(0, dst, src)

    groups = torch.arange(E, dtype=torch.int32, device="cuda")
    ends = torch.searchsorted(tile_group, groups, right=True) * MOE_BLOCK
    return {
        "sizes": sizes.tolist(), "tile_group": tile_group, "rows": N, "routes": R, "ep": ep,
        "tp": tp,
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
    if not empty and inputs["ep"] == 1:
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
                "ep": inputs["ep"], "tp": inputs["tp"],
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


def dense_train_config(**kw):
    """bench_1b4's training recipe (``train/presets.py``), ``kw`` overriding."""
    from tony_tpu_torch.train.presets import bench_1b4_recipe

    return bench_1b4_recipe(**kw)


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
    check_memory_keys("5", steps)
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
        "losses": losses, "grad_norms": [m["grad_norm"] for m in steps],
        "launches": launches, "wall_s": wall, "final": final, "instances": instances,
        "mean_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu": tokens / step_s * flops / 989e12, "flops_per_token": flops,
        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ce_matmul": f32_matmul_route("cuda", cfg.dtype),
        **train_profile(cfg, data, FLASH_KERNELS),
    }


MEMORY_KEYS = ("hbm_mb", "hbm_peak_mb", "hbm_limit_mb")


def check_memory_keys(label: str, pushes: list[dict]) -> None:
    """fit()'s pushes carry the device memory keys (``obs/device_metrics.py``,
    the reference's names): allocated <= peak <= the card's total."""
    for m in pushes:
        vals = [m.get(k) for k in MEMORY_KEYS]
        if None in vals or not 0 < vals[0] <= vals[1] <= vals[2]:
            raise AssertionError(f"phase {label} push of step {m['step']}: memory keys "
                                 f"{dict(zip(MEMORY_KEYS, vals))}")


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
    """bench_moe's training recipe (``train/presets.py``): the reference
    bench's 'grouped_pallas' variant with the preset's own 8 experts."""
    from tony_tpu_torch.train.presets import bench_moe_recipe

    return bench_moe_recipe()


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
        "grad_norms": [m["grad_norm"] for m in steps], "instances": instances,
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
# steps of the rank phases (7-9) left out of their mean step time
RANK_WARMUP_STEPS = 1
FSDP_STEPS = 2      # 4 until phase 10 came, 3 until phase 16: the run's time limit
# the trunk projections the fsdp ring takes (models/llama.py _proj)
RING_PROJECTIONS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def rank_transport() -> str:
    """How a rank phase's ranks move CUDA tensors: every mesh axis fit()
    builds over them is a group of the world group's backend (fit() gives
    its mesh back when it returns, so the axis itself is gone by then)."""
    import torch.distributed as dist

    from tony_tpu_torch.parallel.dist import Axis, transport

    n = dist.get_world_size()
    return transport(Axis("world", n, dist.get_rank(), tuple(range(n)), dist.group.WORLD),
                     torch.device("cuda"))


def fsdp_runs(rank: int) -> dict:
    """Phase 7 on this rank of the shared rank processes (``rank_main``):
    the port's own fit() at fsdp 2 with the ring's pallas form; what it
    saw, with the payload bytes by kind (``dist.BYTES``) and the comms
    ledger's totals and rows."""
    from tony_tpu_torch.obs import comms
    from tony_tpu_torch.ops import attention, overlap
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = dense_train_config()
    steps: list[dict] = []
    overlap.reset_launches()
    attention.reset_launches()
    pdist.reset_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = fit(FitConfig(model=cfg, data=DataConfig(global_batch=8, seq_len=2048,
                                                     vocab_size=cfg.vocab_size),
                          mesh_shape=MeshShape(fsdp=FSDP), overlap_impl="pallas",
                          steps=FSDP_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                          mu_dtype="bfloat16", on_metrics=steps.append), device="cuda")
    res = {"rank": rank, "metrics": steps, "final": final,
           "wall_s": time.perf_counter() - t0,
           "launches": {**overlap.LAUNCHES, **attention.LAUNCHES},
           "bytes": dict(pdist.BYTES), "ledger": comms.totals(),
           "ledger_rows": [(r["name"], r["calls"], r["total_bytes"]) for r in comms.rows()],
           "instance": overlap.kernel_instance(cfg.dtype),
           "transport": rank_transport(),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    return res


def fsdp_phase(card: str, dense: dict, shared: list) -> dict:
    """Phase 7, from the shared rank processes' results (``rank_phases``):
    two ranks on this card, each calling fit() on bench_1b4 at fsdp 2 with overlap_impl=
    "pallas", phase 5's recipe, data and initial parameters (each rank its
    blocks). Each step's loss within 2e-2 of phase 5's (the same bf16
    model and batches; the ring sums each projection's partial products
    in another order, and the schedule matches phase 5's up to step
    FSDP_STEPS); on each rank kernel 14 launched exactly the count the
    ring implies and its plain version never; on each rank the comms
    ledger's totals by kind equal ``dist.BYTES``."""
    ranks = [r["7"] for r in shared]
    wall = max(r["wall_s"] for r in ranks)
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
        if r["ledger"] != r["bytes"] or not sum(r["bytes"].values()):
            raise AssertionError(f"rank {r['rank']}: comms ledger {r['ledger']} != "
                                 f"dist.BYTES {r['bytes']}")
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
    from tony_tpu_torch.obs.comms import KINDS

    for r in ranks:
        log(f"train fsdp={FSDP} rank {r['rank']}: comms ledger = dist.BYTES by kind over "
            f"{FSDP_STEPS} steps: " + ", ".join(f"{KINDS[k]} {v / 1e9:.4f} GB"
                                               for k, v in r["ledger"].items() if v)
            + "; rows " + ", ".join(f"{n} {c} calls {b / 1e9:.4f} GB"
                                    for n, c, b in r["ledger_rows"]) + f"  [{card}]")
    timed = [m["step_time_s"] for m in metrics[RANK_WARMUP_STEPS:]]
    return {"ranks": ranks, "losses": losses, "loss_diffs": diffs, "wall_s": wall,
            "per_step": per_step, "mean_step_ms": sum(timed) / len(timed) * 1e3,
            "transport": ranks[0]["transport"]}


# --- phase 8: MoE training at ep 2, two ranks on one card --------------------------

EP = 2
EP_STEPS = 2        # 4 until phase 10 came, 3 until phase 16: the run's time limit
EP_IMPLS = ("off", "pallas")
# 8b: the sharded checkpoint's round trip at full width, depth cut to 2
CKPT_LAYERS = 2
CKPT_STEPS = 4


def ep_checkpoint_round_trip(ckpt_dir: str) -> dict:
    """Phase 8b on this rank: bench_moe at full width and CKPT_LAYERS
    layers at ep 2, CKPT_STEPS steps uninterrupted; then 2 steps, a
    sharded save, a restore into a template drawn from another seed, and
    the 2 steps after. The restored leaves against the saved ones, bit for
    bit; the resumed losses against the uninterrupted ones."""
    from tony_tpu_torch.parallel.mesh import MeshShape, build_mesh, set_default_mesh
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.data import DataConfig, make_batches
    from tony_tpu_torch.train.prefetch import close_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step, state_specs, tree_leaves,
    )

    cfg = dataclasses.replace(moe_train_config(), n_layers=CKPT_LAYERS)
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    mesh = build_mesh(MeshShape(ep=EP))
    set_default_mesh(mesh)
    # fit()'s optimizer for a run of CKPT_STEPS steps
    opt = default_optimizer(lr=3e-4, warmup_steps=2, decay_steps=CKPT_STEPS,
                            mu_dtype="bfloat16")
    step = make_train_step(cfg, opt, mesh=mesh)

    def run(state, start: int, n: int):
        batches = make_batches(data, device="cuda", start_step=start, mesh=mesh)
        losses = []
        try:
            for _ in range(n):
                state, m = step(state, *next(batches))
                losses.append(float(m["loss"]))
        finally:
            close_batches(batches)
        return state, losses

    def leaves(state):
        return (tree_leaves(state.params) + tree_leaves(state.opt_state["mu"])
                + tree_leaves(state.opt_state["nu"]))

    _, straight = run(make_train_state(cfg, opt, seed=0, device="cuda", mesh=mesh), 0,
                      CKPT_STEPS)
    state, first = run(make_train_state(cfg, opt, seed=0, device="cuda", mesh=mesh), 0, 2)
    manager = CheckpointManager(ckpt_dir, mesh=mesh, specs=state_specs(cfg).params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.save(2, state, force=True)
    save_s = time.perf_counter() - t0
    template = make_train_state(cfg, opt, seed=1, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, at = manager.restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    equal = (at == 2 and restored.step == state.step
             and restored.opt_state["count"] == state.opt_state["count"]
             and all(torch.equal(a, b) for a, b in zip(leaves(restored), leaves(state))))
    _, rest = run(restored, 2, CKPT_STEPS - 2)
    set_default_mesh(None)
    return {"straight": straight, "first": first, "resumed": rest, "bit_equal": equal,
            "save_s": save_s, "restore_s": restore_s,
            "bytes": os.path.getsize(os.path.join(ckpt_dir, "2", f"rank{mesh.rank}.pt"))}


def ep_runs(rank: int, ckpt_dir: str) -> dict:
    """Phase 8 on this rank of the shared rank processes: fit() on
    bench_moe at ep 2, the blocking combine and then the overlapped one on
    the grouped kernels; then 8b's round trip; what it saw."""
    from tony_tpu_torch.ops import attention, grouped_mm
    from tony_tpu_torch.ops.moe_overlap import overlap_chunks
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    t_phase = time.perf_counter()
    cfg = moe_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    runs = {}
    for impl in EP_IMPLS:
        steps: list[dict] = []
        grouped_mm.reset_launches()
        attention.reset_launches()
        pdist.reset_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final = fit(FitConfig(model=cfg, data=data, mesh_shape=MeshShape(ep=EP),
                              steps=EP_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                              mu_dtype="bfloat16", moe_overlap_impl=impl,
                              moe_overlap_chunk=0, on_metrics=steps.append), device="cuda")
        runs[impl] = {"metrics": steps, "final": final, "wall_s": time.perf_counter() - t0,
                      "launches": {**grouped_mm.LAUNCHES, **attention.LAUNCHES},
                      "bytes_per_step": {k: v / EP_STEPS for k, v in pdist.BYTES.items()},
                      "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.empty_cache()
    tokens = data.global_batch * data.seq_len
    res = {"rank": rank, "runs": runs, "transport": rank_transport(),
           "instances": check_tensor_core_path(cfg),
           # the (dp, fsdp) block's rows gathered over ep: here every row
           "n_chunks": overlap_chunks(tokens, 0)}
    torch.cuda.empty_cache()
    res["ckpt"] = ep_checkpoint_round_trip(ckpt_dir)
    res["wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    return res


def ep_phase(card: str, moe: dict, shared: list) -> dict:
    """Phase 8, from the shared rank processes' results: two ranks on this
    card, each calling fit() on bench_moe at full width and depth at ep 2
    (each rank its 4 experts and 4 rows of phase 6's batch), phase 6's
    recipe, data and initial parameters, with the blocking ep combine and
    then the overlapped one (``moe_overlap_impl="pallas"``, the auto
    split). Each step's loss and aux within 2e-2 of phase 6's (the same
    bf16 model and batches; the combine and the statistics' sums run in
    another order, and the schedule matches phase 6's up to step
    EP_STEPS); on each rank kernels 11-13 launched exactly the count remat
    and the chunks imply and their plain versions never. Then 8b: the
    sharded checkpoint's round trip in the same processes."""
    ranks = [r["8"] for r in shared]
    wall = max(r["wall_s"] for r in ranks)
    cfg = moe_train_config()
    n_chunks = ranks[0]["n_chunks"]
    if n_chunks != 4:
        raise AssertionError(f"the auto split gave {n_chunks} chunks, not 4")
    for r in ranks:
        for impl, run in r["runs"].items():
            # the grouped kernels once per chunk where the combine is split
            k = n_chunks if impl != "off" else 1
            want = {n: per * cfg.n_layers * EP_STEPS * (k if n in GMM_KERNELS else 1)
                    for n, per in MOE_LAUNCHES_PER_LAYER_STEP.items()}
            want.update({f"{n}_plain": 0 for n in MOE_LAUNCHES_PER_LAYER_STEP})
            got = {n: run["launches"][n] for n in want}
            if got != want:
                raise AssertionError(f"rank {r['rank']} {impl}: launches {got} != {want}")
        if any(v != "tensor cores" for v in r["instances"].values()):
            raise AssertionError(f"rank {r['rank']} off the tensor cores: {r['instances']}")
        if r["runs"]["off"]["metrics"] and r["rank"]:
            raise AssertionError("rank 1 reported metrics: rank 0 alone reports")
    out = {"ranks": ranks, "wall_s": wall, "n_chunks": n_chunks,
           "transport": ranks[0]["transport"]}
    for impl in EP_IMPLS:
        metrics = ranks[0]["runs"][impl]["metrics"]
        losses = [m["loss"] for m in metrics]
        aux = [m["aux"] for m in metrics]
        if len(losses) != EP_STEPS or not all(math.isfinite(x) for x in losses + aux):
            raise AssertionError(f"ep {impl} losses {losses} aux {aux}")
        diffs = [abs(a - b) for a, b in zip(losses, moe["losses"])]
        aux_diffs = [abs(a - b) for a, b in zip(aux, moe["aux"])]
        if max(diffs + aux_diffs) > 2e-2:
            raise AssertionError(f"ep {impl} losses {losses}, aux {aux} against phase 6's "
                                 f"{moe['losses'][:EP_STEPS]}, {moe['aux'][:EP_STEPS]}")
        timed = [m["step_time_s"] for m in metrics[RANK_WARMUP_STEPS:]]
        out[impl] = {"losses": losses, "aux": aux, "loss_diffs": diffs,
                     "aux_diffs": aux_diffs, "mean_step_ms": sum(timed) / len(timed) * 1e3,
                     "step_ms": [m["step_time_s"] * 1e3 for m in metrics],
                     "bytes_per_step": ranks[0]["runs"][impl]["bytes_per_step"],
                     "peak_gb": [r["runs"][impl]["peak_allocated_gb"] for r in ranks],
                     "launches": ranks[0]["runs"][impl]["launches"]}
        for m, ref, ref_aux in zip(metrics, moe["losses"], moe["aux"]):
            log(f"train bench_moe ep={EP} {impl} step {m['step']}: loss {m['loss']:.4f} "
                f"(phase 6 {ref:.4f}) aux {m['aux']:.5f} ({ref_aux:.5f}) grad_norm "
                f"{m['grad_norm']:.4f} {m['step_time_s'] * 1e3:.1f} ms over "
                f"{out['transport']}  [{card}]")
    out["pallas_vs_off"] = [abs(a - b) for a, b in zip(out["pallas"]["losses"],
                                                       out["off"]["losses"])]
    ck = [r["ckpt"] for r in ranks]
    if not all(c["bit_equal"] for c in ck):
        raise AssertionError("8b: restored leaves differ from the saved ones")
    # steps 1-2 and the resumed 3-4 against the uninterrupted run: the same
    # model and batches; the card's scatter-adds may add in another order
    diffs = [abs(a - b) for a, b in zip(ck[0]["first"] + ck[0]["resumed"], ck[0]["straight"])]
    if len(diffs) != CKPT_STEPS or max(diffs) > 1e-3:
        raise AssertionError(f"8b: losses {ck[0]['first']} then resumed {ck[0]['resumed']} "
                             f"against {ck[0]['straight']}")
    out["ckpt"] = {"ranks": ck, "diffs": diffs}
    return out


# --- phase 9: tp and sp training, two ranks on one card -----------------------------

PAR = 2
PAR_STEPS = 2       # 3 until phase 16: the run's time limit
# each step's loss (absolute) and grad norm (relative) against phase 5's:
# about 10x the gaps measured on the H100 (loss 5e-4, grad norm 1.4e-4
# relative at step 3, where warm-up's end makes the loss jump); a gradient
# counted twice over tp or missing its 1/sp moves the norm far past it
PAR_LOSS_ATOL = 5e-3
PAR_GRAD_NORM_RTOL = 2e-3
# (label, mesh axis, attention_impl, ce_impl): 9a Megatron tp on the flash
# and CE kernels, 9b sp through ring_flash on the flash kernels
PAR_RUNS = (("9a", "tp", "flash", "pallas"), ("9b", "sp", "ring_flash", "scan"))


def par_runs(rank: int) -> dict:
    """Phase 9 on this rank of the shared rank processes: the port's own
    fit() at tp 2 (9a) and at sp 2 (9b); what each run saw."""
    from tony_tpu_torch.ops import attention, fused_ce
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    t_phase = time.perf_counter()
    base = dense_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=base.vocab_size)
    runs = {}
    for label, axis, impl, head in PAR_RUNS:
        cfg = dataclasses.replace(base, attention_impl=impl, ce_impl=head)
        steps: list[dict] = []
        attention.reset_launches()
        fused_ce.reset_launches()
        pdist.reset_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final = fit(FitConfig(model=cfg, data=data, mesh_shape=MeshShape(**{axis: PAR}),
                              steps=PAR_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                              mu_dtype="bfloat16", on_metrics=steps.append), device="cuda")
        runs[label] = {"metrics": steps, "final": final, "wall_s": time.perf_counter() - t0,
                       "launches": {**attention.LAUNCHES, **fused_ce.LAUNCHES},
                       "bytes_per_step": {k: v / PAR_STEPS for k, v in pdist.BYTES.items()},
                       "transport": rank_transport(),
                       "instances": check_tensor_core_path(cfg),
                       "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.empty_cache()
    return {"rank": rank, "runs": runs, "wall_s": time.perf_counter() - t_phase}


def par_launches(label: str, rank: int, layers: int, chunks: int) -> dict[str, int]:
    """The launches phase 9's run ``label`` implies on ``rank`` over
    PAR_STEPS steps. 9a: each flash kernel once per layer and step on the
    rank's heads (remat keeps the forward), ce_fwd once a step, ce_dh and
    ce_dw once per vocab chunk a step, on the whole vocabulary. 9b: sp
    rank r runs r + 1 chunk pairs a layer (the diagonal causal, the
    earlier ones full; none for keys after its queries), forward, dq and
    dk/dv alike; the scan head runs no CE kernel. No plain version."""
    if label == "9a":
        want = {**{n: layers * PAR_STEPS for n in FLASH_KERNELS}, "ce_fwd": PAR_STEPS,
                "ce_dh": PAR_STEPS * chunks, "ce_dw": PAR_STEPS * chunks}
    else:
        want = {**{n: layers * (rank + 1) * PAR_STEPS for n in FLASH_KERNELS},
                **{n: 0 for n in CE_KERNELS}}
    want.update({f"{n}_plain": 0 for n in list(want)})
    return want


def par_phase(card: str, dense: dict, shared: list) -> dict:
    """Phase 9, from the shared rank processes' results: two ranks on this
    card, each calling fit() on bench_1b4 at full width and depth from
    phase 5's initial parameters and batches (8 x 2048): 9a at tp 2 (the
    flash and CE kernels on each rank's 8 heads and the whole vocab), 9b
    at sp 2 under ring_flash (each rank its 1024-position block). Each
    step's loss and grad norm within PAR_LOSS_ATOL and PAR_GRAD_NORM_RTOL
    of phase 5's (the same bf16 model and batches; the tp all-reduces, the
    ring's merges and the CE head sum in another order, and the schedule
    matches phase 5's up to step PAR_STEPS); on each rank the kernels
    launched exactly the count the path implies (``par_launches``), on
    their tensor-core instances, no plain version."""
    from tony_tpu_torch.ops import fused_ce

    ranks = [r["9"] for r in shared]
    wall = max(r["wall_s"] for r in ranks)
    cfg = dense_train_config()
    chunks = len(fused_ce.dlogits_chunks(cfg.vocab_size))
    out = {"wall_s": wall, "ranks": ranks}
    for label, axis, impl, _ in PAR_RUNS:
        for r in ranks:
            run = r["runs"][label]
            want = par_launches(label, r["rank"], cfg.n_layers, chunks)
            got = {k: run["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"{label} rank {r['rank']} launches {got} != {want}")
            if any(v != "tensor cores" for v in run["instances"].values()):
                raise AssertionError(f"{label} rank {r['rank']} off the tensor cores: "
                                     f"{run['instances']}")
        if ranks[1]["runs"][label]["metrics"]:
            raise AssertionError(f"{label}: rank 1 reported metrics: rank 0 alone reports")
        metrics = ranks[0]["runs"][label]["metrics"]
        losses = [m["loss"] for m in metrics]
        if len(losses) != PAR_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label} losses {losses}")
        diffs = [abs(a - b) for a, b in zip(losses, dense["losses"])]
        if max(diffs) > PAR_LOSS_ATOL:
            raise AssertionError(f"{label} losses {losses} against phase 5's "
                                 f"{dense['losses'][:PAR_STEPS]}")
        norms = [m["grad_norm"] for m in metrics]
        norm_diffs = [abs(a - b) / b for a, b in zip(norms, dense["grad_norms"])]
        if not all(math.isfinite(x) for x in norms) or max(norm_diffs) > PAR_GRAD_NORM_RTOL:
            raise AssertionError(f"{label} grad norms {norms} against phase 5's "
                                 f"{dense['grad_norms'][:PAR_STEPS]}")
        run0 = ranks[0]["runs"][label]
        timed = [m["step_time_s"] for m in metrics[RANK_WARMUP_STEPS:]]
        out[label] = {"axis": axis, "impl": impl, "losses": losses, "loss_diffs": diffs,
                      "grad_norms": norms, "grad_norm_rel_diffs": norm_diffs,
                      "mean_step_ms": sum(timed) / len(timed) * 1e3,
                      "step_ms": [m["step_time_s"] * 1e3 for m in metrics],
                      "transport": run0["transport"],
                      "bytes_per_step": run0["bytes_per_step"],
                      "launches": [r["runs"][label]["launches"] for r in ranks],
                      "peak_gb": [r["runs"][label]["peak_allocated_gb"] for r in ranks]}
        for m, ref, ref_norm in zip(metrics, dense["losses"], dense["grad_norms"]):
            log(f"train {label} {axis}={PAR} {impl} step {m['step']}: loss {m['loss']:.4f} "
                f"(phase 5 {ref:.4f}) grad_norm {m['grad_norm']:.4f} ({ref_norm:.4f}) "
                f"{m['step_time_s'] * 1e3:.1f} ms over {run0['transport']}  [{card}]")
    return out


# --- phase 10: pipeline parallelism at pp 2, two ranks on one card ------------------

PP = 2
PP_STEPS = 2        # 3 until phase 16: the run's time limit
# (label, schedule, microbatches, steps): PP_STEPS steps of each schedule at M 4,
# then one of each at M 8 beside them for the peak memory
PP_RUNS = (("gpipe", "gpipe", 4, PP_STEPS), ("1f1b", "1f1b", 4, PP_STEPS),
           ("gpipe M8", "gpipe", 8, 1), ("1f1b M8", "1f1b", 8, 1))


def pp_runs() -> dict:
    """Phase 10 on this rank of the shared rank processes: the port's own
    fit() at pp 2 under each of PP_RUNS; what each run saw, and the
    phase's wall time on this rank."""
    from tony_tpu_torch.ops import attention, fused_ce, overlap
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = dataclasses.replace(dense_train_config(), ce_impl="pallas")
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    runs: dict = {}
    t_phase = time.perf_counter()
    for label, schedule, M, n in PP_RUNS:
        steps: list[dict] = []
        for module in (attention, fused_ce, overlap):
            module.reset_launches()
        pdist.reset_bytes()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final = fit(FitConfig(model=cfg, data=data, mesh_shape=MeshShape(pp=PP),
                              pp_schedule=schedule, pp_microbatches=M, steps=n, log_every=1,
                              lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
                              on_metrics=steps.append), device="cuda")
        runs[label] = {"metrics": steps, "final": final, "wall_s": time.perf_counter() - t0,
                       "launches": {**attention.LAUNCHES, **fused_ce.LAUNCHES,
                                    **overlap.LAUNCHES},
                       "bytes_per_step": {k: v / n for k, v in pdist.BYTES.items()},
                       "transport": rank_transport(),
                       "instances": check_tensor_core_path(cfg),
                       "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    return {"runs": runs, "wall_s": time.perf_counter() - t_phase}


def pp_launches(schedule: str, rank: int, M: int, steps: int, per_stage: int,
                chunks: int) -> dict[str, int]:
    """The launches a pp 2 run implies on ``rank`` (its stage) over
    ``steps`` steps of M microbatches, ``per_stage`` layers a stage, remat
    saving nothing inside a stage. GPipe: each layer and microbatch runs
    the flash forward twice (the forward, the block's remat in the
    backward), dq and dk/dv once; the CE head once a step on every rank
    over the broadcast outputs (ce_fwd 1, ce_dh and ce_dw once per vocab
    chunk). 1F1B: the first stage runs the forward three times (the
    forward slot, the backward slot's recompute, the block's remat), the
    last stage twice (its forward slot passes nothing on, so it only keeps
    the input); the CE head on the last stage alone, once a microbatch.
    Kernel 14 never (no fsdp ring inside a stage), and no plain version."""
    last = rank == PP - 1
    if schedule == "gpipe":
        fwd, heads = 2, 1
    else:
        fwd, heads = (2, M) if last else (3, 0)
    mb = per_stage * M * steps
    want = {"flash_fwd": fwd * mb, "flash_dq": mb, "flash_dkv": mb, "ce_fwd": heads * steps,
            "ce_dh": heads * chunks * steps, "ce_dw": heads * chunks * steps, "chunk_mm": 0}
    want.update({f"{n}_plain": 0 for n in list(want)})
    return want


def pp_phase(card: str, dense: dict, shared: list) -> dict:
    """Phase 10, from the shared rank processes' results: fit() on bench_1b4 at full width and depth at pp 2
    (12 layers a stage) from phase 5's initial parameters and batches (8 x
    2048), flash attention, remat, ``ce_impl="pallas"``: PP_STEPS steps
    under GPipe and PP_STEPS under 1F1B at 4 microbatches, then one of each
    at 8. Each
    step's loss and grad norm within PAR_LOSS_ATOL and PAR_GRAD_NORM_RTOL
    of phase 5's (the same bf16 model and batches; the microbatches sum
    their gradients in another order, and the schedule matches phase 5's
    up to step PP_STEPS); on each rank the kernels launched exactly as the
    schedule implies (``pp_launches``), on their tensor-core instances, no
    plain version."""
    from tony_tpu_torch.ops import fused_ce

    ranks = [{"rank": r["rank"], "runs": r["10"]["runs"]} for r in shared]
    wall = max(r["10"]["wall_s"] for r in shared)
    cfg = dense_train_config()
    chunks = len(fused_ce.dlogits_chunks(cfg.vocab_size))
    out = {"wall_s": wall, "ranks": ranks}
    for label, schedule, M, n in PP_RUNS:
        for r in ranks:
            run = r["runs"][label]
            want = pp_launches(schedule, r["rank"], M, n, cfg.n_layers // PP, chunks)
            got = {k: run["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"pp {label} rank {r['rank']} launches {got} != {want}")
            if any(v != "tensor cores" for v in run["instances"].values()):
                raise AssertionError(f"pp {label} rank {r['rank']} off the tensor cores: "
                                     f"{run['instances']}")
        if ranks[1]["runs"][label]["metrics"]:
            raise AssertionError(f"pp {label}: rank 1 reported metrics: rank 0 alone reports")
        metrics = ranks[0]["runs"][label]["metrics"]
        losses = [m["loss"] for m in metrics]
        if len(losses) != n or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"pp {label} losses {losses}")
        diffs = [abs(a - b) for a, b in zip(losses, dense["losses"])]
        if max(diffs) > PAR_LOSS_ATOL:
            raise AssertionError(f"pp {label} losses {losses} against phase 5's "
                                 f"{dense['losses'][:n]}")
        norms = [m["grad_norm"] for m in metrics]
        norm_diffs = [abs(a - b) / b for a, b in zip(norms, dense["grad_norms"])]
        if not all(math.isfinite(x) for x in norms) or max(norm_diffs) > PAR_GRAD_NORM_RTOL:
            raise AssertionError(f"pp {label} grad norms {norms} against phase 5's "
                                 f"{dense['grad_norms'][:n]}")
        out[label] = {"schedule": schedule, "M": M, "losses": losses, "loss_diffs": diffs,
                      "grad_norms": norms, "grad_norm_rel_diffs": norm_diffs,
                      "step_ms": [m["step_time_s"] * 1e3 for m in metrics],
                      # each rank's fit() p50 over its steps after the first
                      "p50_ms": [r["runs"][label]["final"].get("step_time_p50_s", math.nan)
                                 * 1e3 for r in ranks],
                      "transport": ranks[0]["runs"][label]["transport"],
                      "bytes_per_step": [r["runs"][label]["bytes_per_step"] for r in ranks],
                      "launches": [r["runs"][label]["launches"] for r in ranks],
                      "peak_gb": [r["runs"][label]["peak_allocated_gb"] for r in ranks]}
    return out


# --- phase 11: MoE at tp 2, two ranks on one card ----------------------------------

MOE_TP = 2
MOE_TP_STEPS = 2    # 3 until phase 16: the run's time limit
# each step's loss and aux (absolute) and grad norm (relative) against phase
# 6's: the bf16 expert FFN's two ffn halves rounded apart and summed over tp
# move a near-tie route now and then, as phase 8's ep sums do (2e-2 there),
# and the two runs part further with each update: the H100 measured 1.7e-3
# (loss), 4.3e-3 (aux) and 1.6e-3 (grad norm, relative) at step 3. The CPU
# tests hold the router's gradient over tp to 1e-4 (tests/test_torch_moe_tp.py)
MOE_TP_ATOL = 2e-2
MOE_TP_GRAD_NORM_RTOL = 1e-2


def moe_tp_runs(rank: int) -> dict:
    """Phase 11 on this rank of the shared rank processes: the port's own
    fit() on bench_moe at tp 2, phase 6's recipe; what it saw."""
    from tony_tpu_torch.ops import attention, grouped_mm
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = moe_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    steps: list[dict] = []
    grouped_mm.reset_launches()
    attention.reset_launches()
    pdist.reset_bytes()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = fit(FitConfig(model=cfg, data=data, mesh_shape=MeshShape(tp=MOE_TP),
                          steps=MOE_TP_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                          mu_dtype="bfloat16", on_metrics=steps.append), device="cuda")
    res = {"rank": rank, "metrics": steps, "final": final, "wall_s": time.perf_counter() - t0,
           "launches": {**grouped_mm.LAUNCHES, **attention.LAUNCHES},
           "bytes_per_step": {k: v / MOE_TP_STEPS for k, v in pdist.BYTES.items()},
           "transport": rank_transport(), "instances": check_tensor_core_path(cfg),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    return res


def moe_tp_phase(card: str, moe: dict, shared: list) -> dict:
    """Phase 11, from the shared rank processes' results: fit() on
    bench_moe at full width and depth at tp 2 (each rank every expert's
    1408 of 2816 ffn columns, 8 of the 16 heads, and all 8 x 2048 rows),
    phase 6's recipe, data and initial parameters, the grouped kernels
    (``moe_gmm_impl="pallas"``). Each step's loss and aux within
    MOE_TP_ATOL of phase 6's and its grad norm within MOE_TP_GRAD_NORM_RTOL
    (the same bf16 model and batches; the schedule matches phase 6's up to
    step MOE_TP_STEPS); on each rank kernels 11-13 and the flash kernels
    launched phase 6's count per layer and step (each rank runs every
    route through its ffn block), on their tensor-core instances, no plain
    version."""
    ranks = [r["11"] for r in shared]
    cfg = moe_train_config()
    want = {n: per * cfg.n_layers * MOE_TP_STEPS
            for n, per in MOE_LAUNCHES_PER_LAYER_STEP.items()}
    want.update({f"{n}_plain": 0 for n in MOE_LAUNCHES_PER_LAYER_STEP})
    for r in ranks:
        got = {n: r["launches"][n] for n in want}
        if got != want:
            raise AssertionError(f"moe tp rank {r['rank']}: launches {got} != {want}")
        if any(v != "tensor cores" for v in r["instances"].values()):
            raise AssertionError(f"moe tp rank {r['rank']} off the tensor cores: "
                                 f"{r['instances']}")
    if ranks[1]["metrics"]:
        raise AssertionError("moe tp: rank 1 reported metrics: rank 0 alone reports")
    metrics = ranks[0]["metrics"]
    losses = [m["loss"] for m in metrics]
    aux = [m["aux"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    if len(losses) != MOE_TP_STEPS or not all(math.isfinite(x) for x in losses + aux + norms):
        raise AssertionError(f"moe tp losses {losses} aux {aux} grad norms {norms}")
    diffs = [abs(a - b) for a, b in zip(losses, moe["losses"])]
    aux_diffs = [abs(a - b) for a, b in zip(aux, moe["aux"])]
    norm_diffs = [abs(a - b) / b for a, b in zip(norms, moe["grad_norms"])]
    if max(diffs + aux_diffs) > MOE_TP_ATOL or max(norm_diffs) > MOE_TP_GRAD_NORM_RTOL:
        raise AssertionError(f"moe tp losses {losses}, aux {aux}, grad norms {norms} against "
                             f"phase 6's {moe['losses'][:MOE_TP_STEPS]}, "
                             f"{moe['aux'][:MOE_TP_STEPS]}, {moe['grad_norms'][:MOE_TP_STEPS]}")
    for m, ref, ref_aux, ref_norm in zip(metrics, moe["losses"], moe["aux"],
                                         moe["grad_norms"]):
        log(f"train bench_moe tp={MOE_TP} step {m['step']}: loss {m['loss']:.4f} (phase 6 "
            f"{ref:.4f}) aux {m['aux']:.5f} ({ref_aux:.5f}) grad_norm {m['grad_norm']:.4f} "
            f"({ref_norm:.4f}) {m['step_time_s'] * 1e3:.1f} ms over "
            f"{ranks[0]['transport']}  [{card}]")
    return {"ranks": ranks, "losses": losses, "aux": aux, "grad_norms": norms,
            "loss_diffs": diffs, "aux_diffs": aux_diffs, "grad_norm_rel_diffs": norm_diffs,
            "step_ms": [m["step_time_s"] * 1e3 for m in metrics],
            "bytes_per_step": ranks[0]["bytes_per_step"], "transport": ranks[0]["transport"],
            "launches": [r["launches"] for r in ranks],
            "peak_gb": [r["peak_allocated_gb"] for r in ranks],
            "wall_s": max(r["wall_s"] for r in ranks)}


# --- phase 12: a capacity dispatch at dp 2, two ranks on one card --------------------

CAPACITY_LAYERS = 2
CAPACITY_STEPS = 2
# the same bf16 model and batches: the slot buffer's sum over dp adds each
# slot to zeros (exact) and the router's statistics sum in another order;
# the dp all-reduce sums the bf16 gradients in another order, which the
# second step's loss carries
CAPACITY_ATOL = 2e-2


def capacity_config():
    """bench_moe at full width, 2 layers, the capacity dispatch 'gather'
    (capacity factor 1.25, the reference's default), phase 6's recipe
    otherwise."""
    return dataclasses.replace(moe_train_config(), n_layers=CAPACITY_LAYERS,
                               moe_dispatch="gather")


def capacity_fit(mesh_shape) -> dict:
    """fit() on ``capacity_config()`` for CAPACITY_STEPS steps over
    ``mesh_shape`` (None: one process): the metrics, the flash launches,
    the payload a step and the peak memory."""
    from tony_tpu_torch.ops import attention, grouped_mm
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = capacity_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
    steps: list[dict] = []
    attention.reset_launches()
    grouped_mm.reset_launches()
    pdist.reset_bytes()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit(FitConfig(model=cfg, data=data, mesh_shape=mesh_shape, steps=CAPACITY_STEPS,
                  log_every=1, lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
                  on_metrics=steps.append), device="cuda")
    res = {"metrics": steps, "wall_s": time.perf_counter() - t0,
           "launches": {**attention.LAUNCHES, **grouped_mm.LAUNCHES},
           "bytes_per_step": {k: v / CAPACITY_STEPS for k, v in pdist.BYTES.items()},
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.empty_cache()
    return res


def capacity_runs(rank: int) -> dict:
    """Phase 12 on this rank of the shared rank processes: the capacity
    dispatch at dp 2."""
    from tony_tpu_torch.parallel.mesh import MeshShape

    return {"rank": rank, "transport": rank_transport(),
            **capacity_fit(MeshShape(dp=2))}


def capacity_phase(card: str, one: dict, shared: list) -> dict:
    """Phase 12, from the shared rank processes' results and ``one``, the
    same fit() in one process: each rank its 4 of the 8 x 2048 rows, the
    queue positions and the capacity over the global batch, the slot
    buffer all-reduced over dp. Each step's loss and aux within
    CAPACITY_ATOL of the one-process run's; on each rank each flash kernel
    once per layer and step, no grouped-matmul kernel (the capacity
    dispatch runs the expert FFN as batched matmuls), no plain version."""
    ranks = [r["12"] for r in shared]
    cfg = capacity_config()
    for r in ranks + [one]:
        want = {n: cfg.n_layers * CAPACITY_STEPS for n in FLASH_KERNELS}
        want.update({f"{n}_plain": 0 for n in FLASH_KERNELS})
        want.update({n: 0 for n in GMM_KERNELS})
        got = {n: r["launches"][n] for n in want}
        if got != want:
            raise AssertionError(f"capacity dp: launches {got} != {want}")
    if ranks[1]["metrics"]:
        raise AssertionError("capacity dp: rank 1 reported metrics: rank 0 alone reports")
    got, ref = ranks[0]["metrics"], one["metrics"]
    vals = [(m["loss"], m["aux"], r["loss"], r["aux"]) for m, r in zip(got, ref)]
    diffs = [max(abs(a - c), abs(b - d)) for a, b, c, d in vals]
    if len(vals) != CAPACITY_STEPS or not all(math.isfinite(x) for v in vals for x in v) \
            or max(diffs) > CAPACITY_ATOL:
        raise AssertionError(f"capacity dp (loss, aux, one-process loss, aux): {vals}")
    for m, r in zip(got, ref):
        log(f"train bench_moe {CAPACITY_LAYERS} layers dispatch=gather dp=2 step {m['step']}: "
            f"loss {m['loss']:.4f} (one process {r['loss']:.4f}) aux {m['aux']:.5f} "
            f"({r['aux']:.5f}) {m['step_time_s'] * 1e3:.1f} ms over {ranks[0]['transport']} "
            f"(one process {r['step_time_s'] * 1e3:.1f} ms)  [{card}]")
    return {"ranks": ranks, "diffs": diffs, "bytes_per_step": ranks[0]["bytes_per_step"],
            "step_ms": [m["step_time_s"] * 1e3 for m in got],
            "one_step_ms": [m["step_time_s"] * 1e3 for m in ref],
            "peak_gb": [r["peak_allocated_gb"] for r in ranks],
            "one_peak_gb": one["peak_allocated_gb"], "transport": ranks[0]["transport"],
            "launches": [r["launches"] for r in ranks],
            "wall_s": max(r["wall_s"] for r in ranks)}


# --- phase 14: elastic fit() over a re-formed process group, two ranks on one card -----

ELASTIC_LAYERS = 2
ELASTIC_STEPS = 6
# member 1 leaves at step 2 and grows back at step 4
ELASTIC_PLAN = {2: (0,), 4: (0, 1)}
ELASTIC_ATOL = 2e-2     # phase 7's loss bound: the same bf16 model, sums in another order
AGREE_REPS = 50


def elastic_config():
    """bench_1b4 at full width (dim 2048, 16 heads, vocab 32,000), cut to
    ELASTIC_LAYERS layers, phase 5's recipe otherwise."""
    return dataclasses.replace(dense_train_config(), n_layers=ELASTIC_LAYERS)


def elastic_data():
    from tony_tpu_torch.train import DataConfig

    return DataConfig(global_batch=8, seq_len=2048, vocab_size=elastic_config().vocab_size)


def elastic_runs(rank: int, work_dir: str) -> dict:
    """Phase 14 on this rank of the shared rank processes: elastic fit()
    with 2 members of 1 rank under ELASTIC_PLAN, its generation file and
    journal under ``work_dir``. The grow boundary's broadcast is followed
    by a digest of this rank's parameters (both ranks take part in it, the
    source too); after the run, the per-step agreement broadcast (an int64
    tensor of 3 from rank 0, what fit() sends a step when it watches a
    generation file) is timed over the group."""
    import hashlib

    import torch.distributed as dist

    from tony_tpu_torch.elastic import journal_path, read_journal
    from tony_tpu_torch.ops import attention
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.train import FitConfig, fit, loop

    cfg = elastic_config()
    digests: list[str] = []
    sync = loop._Elastic._sync_grown

    def digesting(self, members, old, state):
        moved = sync(self, members, old, state)
        if not moved:                   # no member grew at this boundary
            return moved
        h = hashlib.sha1()
        for t in loop.tree_leaves(state.params):
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        return moved

    loop._Elastic._sync_grown = digesting
    steps: list[dict] = []
    attention.reset_launches()
    pdist.reset_bytes()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        final = fit(FitConfig(model=cfg, data=elastic_data(), steps=ELASTIC_STEPS, log_every=1,
                              lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
                              elastic_members=2, elastic_plan=ELASTIC_PLAN,
                              elastic_dir=work_dir, elastic_shadow_steps=2,
                              on_metrics=steps.append), device="cuda")
    finally:
        loop._Elastic._sync_grown = sync
    wall = time.perf_counter() - t0
    buf = torch.zeros(3, dtype=torch.int64)
    dist.barrier()
    t1 = time.perf_counter()
    for _ in range(AGREE_REPS):
        dist.broadcast(buf, 0)
    agree_ms = (time.perf_counter() - t1) / AGREE_REPS * 1e3
    res = {"rank": rank, "metrics": steps, "final": final, "wall_s": wall,
           "launches": dict(attention.LAUNCHES), "digests": digests,
           "bytes": dict(pdist.BYTES), "agree_ms": agree_ms, "transport": rank_transport(),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        res["journal"] = read_journal(journal_path(work_dir, 0))
    torch.cuda.empty_cache()
    return res


def elastic_twin() -> dict:
    """The one-process run phase 14 is held to: fit()'s optimizer and
    initial state (seed 0) on ``elastic_config()``, fed ``reference_batches``
    (both members' rows at full membership, member 0's while ELASTIC_PLAN
    has member 1 out), each step's loss and grad norm."""
    from tony_tpu_torch.elastic import reference_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg, data = elastic_config(), elastic_data()
    opt = default_optimizer(lr=3e-4, warmup_steps=2, decay_steps=max(ELASTIC_STEPS, 3),
                            mu_dtype="bfloat16")
    state = make_train_state(cfg, opt, seed=0, device="cuda")
    step_fn = make_train_step(cfg, opt)
    stream = reference_batches(data, 2, device="cuda")
    members, out = (0, 1), []
    try:
        for i in range(ELASTIC_STEPS):
            members = ELASTIC_PLAN.get(i, members)
            x, y = next(stream)
            rows = data.global_batch // 2 * len(members)
            state, m = step_fn(state, x[:rows], y[:rows])
            out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    finally:
        stream.close()
    del state
    torch.cuda.empty_cache()
    return {"metrics": out}


def elastic_phase(card: str, twin: dict, shared: list) -> dict:
    """Phase 14, from the shared rank processes' results and ``twin``, the
    one-process run: the summary (2 reshards, generation 2, members [0,
    1]) on both ranks; the journal's boundaries and skips ({"1": [2, -1]},
    then {"1": [2, 4]}); every step's loss within ELASTIC_ATOL of the
    twin's; the grown rank's parameters bit-equal to rank 0's after the
    broadcast (their digests); each boundary's seconds and broadcast
    bytes; each flash kernel once per layer and step a rank ran (rank 1
    sits steps 2-3 out), no plain version."""
    ranks = [r["14"] for r in shared]
    for r in ranks:
        e = r["final"]["elastic"]
        if (e["reshards"], e["generation"], e["members"]) != (2, 2, [0, 1]) or \
                not e["reshard_s"] > 0:
            raise AssertionError(f"elastic rank {r['rank']}: summary {e}")
        ran = ELASTIC_STEPS if r["rank"] == 0 else ELASTIC_STEPS - 2
        want = {n: ELASTIC_LAYERS * ran for n in FLASH_KERNELS}
        want.update({f"{n}_plain": 0 for n in FLASH_KERNELS})
        got = {n: r["launches"][n] for n in want}
        if got != want:
            raise AssertionError(f"elastic rank {r['rank']}: launches {got} != {want}")
    reshards = [x for x in ranks[0]["journal"] if x["type"] == "reshard"]
    skips = [(x["boundary"], x["at_step"], x["skipped"]) for x in reshards]
    if skips != [("shrink", 2, {"1": [2, -1]}), ("grow", 4, {"1": [2, 4]})]:
        raise AssertionError(f"elastic journal boundaries {skips}")
    if len(ranks[0]["digests"]) != 1 or ranks[0]["digests"] != ranks[1]["digests"]:
        raise AssertionError(f"elastic: parameters after the grow broadcast differ: "
                             f"{[r['digests'] for r in ranks]}")
    got, ref = ranks[0]["metrics"], twin["metrics"]
    diffs = [abs(g["loss"] - w["loss"]) for g, w in zip(got, ref)]
    if len(got) != ELASTIC_STEPS or max(diffs) > ELASTIC_ATOL or \
            not all(math.isfinite(g["loss"]) for g in got):
        raise AssertionError(f"elastic losses {[g['loss'] for g in got]} against the "
                             f"one-process run's {[w['loss'] for w in ref]}")
    if ranks[1]["metrics"]:
        raise AssertionError("elastic: rank 1 reported metrics: rank 0 alone reports")
    bounds = [r["final"]["elastic_boundaries"] for r in ranks]
    for m, w in zip(got, ref):
        log(f"14 elastic step {m['step']}: loss {m['loss']:.4f} (one process "
            f"{w['loss']:.4f}) grad_norm {m['grad_norm']:.4f} ({w['grad_norm']:.4f}) "
            f"{m['step_time_s'] * 1e3:.1f} ms over {ranks[0]['transport']}  [{card}]")
    return {"ranks": ranks, "diffs": diffs, "bounds": bounds, "skips": skips,
            "launches": [r["launches"] for r in ranks],
            "step_ms": [m["step_time_s"] * 1e3 for m in got],
            "agree_ms": [r["agree_ms"] for r in ranks],
            "peak_gb": [r["peak_allocated_gb"] for r in ranks],
            "wall_s": max(r["wall_s"] for r in ranks), "transport": ranks[0]["transport"]}


# --- phase 16: gang serving --------------------------------------------------------

# a `tony serve` job's settings as phase 4 serves: Llama-3-8B from seed 0 (the
# weights llama_params() draws), 8 slots, max_len 2048, kv_block 64 (the
# engine's default), the prefix store on
GANG_KEYS = {"serve.gang.model": "llama3_8b", "serve.gang.seed": 0,
             "serve.gang.slots": 8, "serve.gang.max_len": 2048,
             "serve.prefix.enabled": True}
GANG_READY_S = 240          # submit to every host's engine built
GANG_RESULT_S = 300         # one request's end, from its submit
GANG_KILL_TOKENS = 8        # 16b: tokens a decode:0 stream delivers before the kill
GANG_KILL_WAIT_S = 60       # 16b: how long a stream on decode:0 may take to get there
GANG_NEW = 64               # phase 4's max_new_tokens
GANG_LINE = '{"host"'       # the start of a decode host's kernel-count line
GANG_COMMAND = f"{sys.executable} -m tony_tpu_torch.serve.gang"   # engines on the card


def gang_start(stage: str, **keys) -> dict:
    """Start one ``tony serve`` job as ``cmd_serve`` does: the port's client
    stages the job and launches its AM, which gang-schedules the port's
    decode hosts (``python -m tony_tpu_torch.serve.gang``: engines on the
    card), and the port's ``GangFrontend`` routes in this process. The
    spine is disarmed through the job's config, as in phase 15. Returns
    the client, the frontend and each host's seconds from submit until its
    engine was built (its DecodeStats reports slots)."""
    import grpc

    from tony_tpu_torch.cli.client import TonyClient
    from tony_tpu_torch.config.config import TonyConfig
    from tony_tpu_torch.config.keys import job_key
    from tony_tpu_torch.rpc.auth import read_token
    from tony_tpu_torch.serve.frontend import GangFrontend
    from tony_tpu_torch.serve.gang import GangSettings

    config = TonyConfig.load(overrides={
        "application.stage_dir": stage, "application.name": "chip-smoke-gang",
        "application.framework": "serve", "application.timeout_s": 900,
        "task.heartbeat_interval_ms": 200, "task.max_missed_heartbeats": 50,
        **{d.partition("=")[0]: False for d in JOB_SPINE_OFF}, **GANG_KEYS, **keys})
    settings = GangSettings.from_config(config)
    for job, n in ((settings.job_type, settings.hosts),
                   (settings.prefill_job_type, settings.prefill_hosts)):
        if n > 0:
            config.set(job_key(job, "instances"), n)
            config.set(job_key(job, "command"), GANG_COMMAND)
    t0 = time.perf_counter()
    client = TonyClient(config)
    client.stage()
    client.launch_am()
    fe = GangFrontend(client.am_address(), settings, app_dir=client.app_dir,
                      token=read_token(client.app_dir), app_id=client.app_id)
    gang = {"client": client, "fe": fe, "settings": settings, "t0": t0}
    want = settings.hosts + settings.prefill_hosts
    ready: dict[str, float] = {}
    deadline = time.monotonic() + GANG_READY_S
    try:
        while len(ready) < want:
            if time.monotonic() > deadline:
                raise AssertionError(f"16: hosts ready {ready} of {want} after "
                                     f"{GANG_READY_S} s")
            fe.refresh_hosts()
            for h in fe._snapshot_hosts():
                if h.task_id in ready:
                    continue
                try:
                    if h.client.decode_stats(timeout_s=2.0).slots:
                        ready[h.task_id] = time.perf_counter() - t0
                except grpc.RpcError:
                    pass
            time.sleep(0.1)
    except BaseException:
        gang_stop(gang)
        gang_dump_logs(gang)
        raise
    fe.wait_ready(want, timeout_s=30.0)
    gang["ready_s"] = ready
    return gang


def gang_stop(gang: dict) -> dict:
    """Close the frontend (its ledger into the app dir), stop the job through
    its AM, which SIGTERMs the hosts (each logs its kernel-count line), and
    wait for the client. Returns the ledger, the client's exit code and
    every host incarnation's count lines by log file."""
    from tony_tpu_torch.rpc import ApplicationRpcClient
    from tony_tpu_torch.rpc.auth import read_token

    client = gang["client"]
    ledger = gang["fe"].close(wait_s=0.0)
    try:
        with ApplicationRpcClient(client.am_address(timeout_s=5.0), timeout_s=5.0,
                                  token=read_token(client.app_dir)) as c:
            c.stop_application("chip_smoke phase 16 done")
    except Exception as e:
        log(f"16: stop_application: {e!r}")
    rc = client.monitor(quiet=True)
    logs = os.path.join(client.app_dir, "logs")
    lines = {}
    for name in sorted(os.listdir(logs)):
        with open(os.path.join(logs, name), errors="replace") as f:
            # a line of another thread's log may follow the JSON on its line
            found = [json.JSONDecoder().raw_decode(x)[0] for x in f.read().splitlines()
                     if x.startswith(GANG_LINE)]
        if name.startswith(("decode_", "prefill_")):
            lines[name.removesuffix(".log")] = found
    return {"ledger": ledger, "rc": rc, "lines": lines}


def gang_dump_logs(gang: dict, tail: int = 2000) -> None:
    """A failed phase 16 prints the end of each of its job's task logs and
    the frontend's ledger to stderr (the stage dir is removed)."""
    logs = os.path.join(gang["client"].app_dir, "logs")
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
        with open(os.path.join(logs, name), errors="replace") as f:
            print(f"--- 16: {name}\n{f.read()[-tail:]}", file=sys.stderr)
    print(f"--- 16: ledger {json.dumps(gang['fe'].ledger())[-tail:]}", file=sys.stderr)


def gang_relaunched(fe, task: str) -> float:
    """Wait for ``task``'s next incarnation to be built; the clock when it
    was."""
    import grpc

    deadline = time.monotonic() + GANG_READY_S
    while time.monotonic() < deadline:
        fe.refresh_hosts()
        for h in fe._snapshot_hosts():
            if h.task_id == task and h.attempt > 0:
                try:
                    if h.client.decode_stats(timeout_s=2.0).slots:
                        return time.perf_counter()
                except grpc.RpcError:
                    pass
        time.sleep(0.1)
    raise AssertionError(f"16b: {task} was not relaunched in {GANG_READY_S} s")


def gang_settle(fe, timeout_s: float = 30.0) -> None:
    """Wait until the frontend's stats poll reads every routable host idle
    (nothing in flight, no live slot)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        hosts = fe._snapshot_hosts()
        if hosts and all(h.stats is not None and not (h.stats.in_flight or h.stats.live_slots)
                         for h in hosts):
            return
        time.sleep(0.05)
    raise AssertionError(f"16: hosts not idle after {timeout_s} s: "
                         f"{[(h.task_id, h.stats) for h in fe._snapshot_hosts()]}")


def gang_submit(fe, prompts: list, reqs: list) -> list[str]:
    """Phase 4's requests through the frontend, in index order: a fresh
    frontend seeds the i-th one i + 1, as serve_requests() does."""
    return [fe.submit([int(t) for t in p], r.max_new_tokens, temperature=r.temperature,
                      top_k=r.top_k, top_p=r.top_p)
            for p, r in zip(prompts, reqs)]


def gang_results(fe, rids: list[str], label: str, vocab: int) -> list:
    """Every request's completion; each must finish with GANG_NEW in-vocabulary
    tokens."""
    done = [fe.result(rid, timeout_s=GANG_RESULT_S) for rid in rids]
    bad = [(c.rid, c.finish_reason, len(c.tokens), c.message) for c in done
           if c.finish_reason != "length" or len(c.tokens) != GANG_NEW
           or not all(0 <= t < vocab for t in c.tokens)]
    if bad:
        raise AssertionError(f"{label}: requests that did not finish: {bad}")
    return done


def gang_counts(label: str, lines: dict, per_step: dict[str, int], pool: str) -> dict:
    """Hold every count line of every ``pool`` host incarnation: each kernel in
    ``per_step`` launched that many times a decode step, no plain version.
    Returns each incarnation's last line."""
    last = {}
    for name, found in lines.items():
        if not name.startswith(pool):
            continue
        for line in found:
            got = line["launches"]
            want = {k: n * line["decode_steps"] for k, n in per_step.items()}
            plain = {k: v for k, v in got.items() if k.endswith("_plain") and v}
            if any(got[k] != v for k, v in want.items()) or plain:
                raise AssertionError(f"{label} {name} ({line['at']}): launches {got} != "
                                     f"{want} for {line['decode_steps']} decode steps")
        if found:
            last[name] = found[-1]
    return last


def gang_phase(card: str, bf16: dict, int8: dict) -> dict:
    """Phase 16 (16a, 16b, 16c): gang serving on the card, the hosts holding
    no weights of this process's (its Llama-3-8B is freed before)."""
    from tony_tpu_torch.chaos.invariants import check_invariants
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.serve.cache import block_bytes

    cfg = getattr(LlamaConfig, GANG_KEYS["serve.gang.model"])()
    prompts, reqs, _ = serve_requests(cfg)
    greedy = [i for i in range(len(reqs)) if i % 2 == 0]
    log(f"16 this process while the gang runs: {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved  [{card}]")
    out = {}
    stage = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    trigger = os.path.join(stage, "kill-decode-0")
    try:
        t_job = time.perf_counter()
        gang = gang_start(stage, **{
            "serve.gang.hosts": 2, "chaos.enabled": True,
            "chaos.faults": json.dumps([{"type": "kill_container", "task": "decode:0",
                                         "on_file": trigger}])})
        fe = gang["fe"]
        try:
            # 16a: phase 4's requests over two hosts
            t0 = time.perf_counter()
            rids = gang_submit(fe, prompts, reqs)
            a = gang_results(fe, rids, "16a", cfg.vocab_size)
            a_wall = time.perf_counter() - t0
            # 16b: the same requests again; decode:0 is killed once one of its
            # streams has delivered GANG_KILL_TOKENS tokens. First the
            # frontend's stats poll must see both hosts idle: stats read
            # during 16a's last steps put each host at 16 (8 streams, 8 live
            # slots), past the affinity bound (2 x slots), and a burst routed
            # on them can land on one host alone (it did, on two card runs)
            gang_settle(fe)
            t0 = time.perf_counter()
            rids = gang_submit(fe, prompts, reqs)
            deadline = time.monotonic() + GANG_KILL_WAIT_S
            while True:
                with fe._lock:
                    live = [f for f in fe._flights.values()
                            if f.result.hosts and f.result.hosts[-1] == "decode:0"
                            and len(f.result.tokens) >= GANG_KILL_TOKENS]
                if live:
                    break
                if time.monotonic() > deadline:
                    with fe._lock:
                        seen = [(f.rid, f.result.hosts, len(f.result.tokens))
                                for f in fe._flights.values()]
                    raise AssertionError(f"16b: no stream on decode:0 reached "
                                         f"{GANG_KILL_TOKENS} tokens in {GANG_KILL_WAIT_S} "
                                         f"s; 16a's hosts {[c.hosts for c in a]}, replays "
                                         f"{[c.replays for c in a]}; in flight {seen}")
                time.sleep(0.005)
            with open(trigger, "w"):
                pass
            t_kill = time.perf_counter()
            b = gang_results(fe, rids, "16b", cfg.vocab_size)
            b_wall = time.perf_counter() - t0
            kill_to_end = time.perf_counter() - t_kill
            # the AM relaunches decode:0 alone (restart.policy failed_only)
            relaunch = gang_relaunched(fe, "decode:0") - t_kill
        except BaseException:
            gang_stop(gang)
            gang_dump_logs(gang)
            raise
        stopped = gang_stop(gang)
        ab_job_s = time.perf_counter() - t_job
        with open(os.path.join(gang["client"].app_dir, "status.json")) as f:
            attempts = {t["task"]: t["attempts"] for t in json.load(f)["tasks"]}
        if attempts != {"decode:0": 2, "decode:1": 1}:
            raise AssertionError(f"16b: attempts {attempts}")
        replayed = [c for c in b if c.replays]
        if not replayed:
            raise AssertionError("16b: the kill interrupted no request")
        # a replay regenerates the prefix it delivered, draw for draw, on a
        # survivor whose prefix store held more or less of the prompt than
        # the dead host's did (fault F6, closed: the prefill is
        # match-invariant)
        parted = {i: next((j for j, (x, y) in enumerate(zip(c.tokens, a[i].tokens))
                           if x != y), None)
                  for i, c in enumerate(b) if c.replays and not c.replay_consistent}
        if parted:
            raise AssertionError(f"16b: replays regenerated another prefix than the one "
                                 f"delivered (first differing token by request {parted})")
        led = stopped["ledger"]
        rows = led["requests"]
        by_rid = {c.rid: c for c in a + b}
        if (led["pending"] or len(rows) != 2 * len(reqs)
                or any(e["finish_reason"] != "length" or e["tokens"] != GANG_NEW
                       or e["replay_consistent"] != by_rid[e["rid"]].replay_consistent
                       or e["replays"] != by_rid[e["rid"]].replays for e in rows)):
            raise AssertionError(f"16b: the ledger disagrees: {led}")
        with open(os.path.join(gang["client"].app_dir, "serve",
                               "requests_frontend.json")) as f:
            if json.load(f) != json.loads(json.dumps(led)):
                raise AssertionError("16b: the ledger file differs from the frontend's")
        report = check_invariants([gang["client"].app_dir])
        if not report.ok:
            raise AssertionError(f"16b: the invariant report is not clean: "
                                 f"{report.to_json()}")
        lines = stopped["lines"]
        last = gang_counts("16a/16b", lines, {"paged_decode_attention": cfg.n_layers,
                                              "paged_decode_attention_quant": 0,
                                              "quant_mm": 0}, "decode")
        if set(last) != {"decode_0_attempt0", "decode_0_attempt1", "decode_1_attempt0"}:
            raise AssertionError(f"16: host incarnations with a count line: {sorted(last)}")
        # each host's first line: its engine drained at the end of 16a
        after_a = {n: lines[n][0]["decode_steps"] for n in ("decode_0_attempt0",
                                                            "decode_1_attempt0")}
        hosts_a = [c.hosts for c in a]
        if hosts_a[6] != hosts_a[7]:
            raise AssertionError(f"16a: requests 6 and 7 on {hosts_a[6]} and {hosts_a[7]}")
        differ = [i for i, c in enumerate(a) if c.tokens != bf16["tokens"][i]]
        out["ab"] = {
            "ready_s": gang["ready_s"], "a_wall_s": a_wall, "b_wall_s": b_wall,
            "ttft_s": [c.ttft_s for c in a], "hosts": hosts_a, "differ": differ,
            "first_diff": {i: next(j for j, (x, y) in enumerate(zip(a[i].tokens,
                                                                 bf16["tokens"][i]))
                                   if x != y) for i in differ},
            "steps_after_a": after_a, "last": last, "rc": stopped["rc"],
            "replays": [(c.rid, c.replays, c.hosts) for c in replayed],
            "kill_to_end_s": kill_to_end, "relaunch_ready_s": relaunch, "job_s": ab_job_s,
            "b_ttft_s": [c.ttft_s for c in b], "checked": report.checked_apps,
        }
        gang_log_ab(card, out["ab"], bf16)
        # 16c: one prefill host hands every prompt's blocks to one decode host,
        # both quantized (int8 pools, int8 decode weights)
        t_job = time.perf_counter()
        # the prefill host's store must hold every prompt in flight until its
        # Prefill exports it: at the 64 MB default 16 prompts of 4 MiB int8
        # blocks evict each other (14 of 16 exports found nothing, the first
        # card run); 1 GiB holds all 16, on the decode host until adopted too
        gang = gang_start(stage, **{"serve.gang.hosts": 1, "serve.pool.prefill_hosts": 1,
                                    "serve.quant.enabled": True,
                                    "serve.quant.kv_dtype": "int8",
                                    "serve.quant.weights": True,
                                    "serve.prefix.budget_mb": 1024.0})
        try:
            t0 = time.perf_counter()
            rids = gang_submit(gang["fe"], prompts, reqs)
            c_ = gang_results(gang["fe"], rids, "16c", cfg.vocab_size)
            c_wall = time.perf_counter() - t0
        except BaseException:
            gang_stop(gang)
            gang_dump_logs(gang)
            raise
        stopped = gang_stop(gang)
        c_job_s = time.perf_counter() - t_job
        hand = stopped["ledger"]["handoffs"]
        blk = block_bytes(cfg, 64, quant_kv="int8")
        long_ = sum(len(p) >= gang["settings"].handoff_min_tokens for p in prompts)
        if (len(hand) != long_ or not all(h["ok"] for h in hand)
                or any(h["shipped"] != h["adopted"] + h["freed"] or h["shipped"] < 1
                       or h["bytes"] != h["shipped"] * blk for h in hand)):
            raise AssertionError(f"16c: handoffs {hand} ({long_} prompts of "
                                 f"{gang['settings'].handoff_min_tokens}+ tokens, "
                                 f"{blk} bytes a block)")
        if any(c.hosts != ["decode:0"] for c in c_):
            raise AssertionError(f"16c: hosts {[c.hosts for c in c_]}")
        quant = {"paged_decode_attention_quant": cfg.n_layers,
                 "quant_mm": 7 * cfg.n_layers + 1, "paged_decode_attention": 0}
        last = gang_counts("16c decode", stopped["lines"], quant, "decode")
        plast = gang_counts("16c prefill", stopped["lines"], quant, "prefill")
        if set(last) != {"decode_0_attempt0"} or set(plast) != {"prefill_0_attempt0"}:
            raise AssertionError(f"16c: count lines {sorted(stopped['lines'])}")
        same = sum(x == y for i in greedy for x, y in zip(c_[i].tokens, int8["tokens"][i]))
        out["c"] = {
            "ready_s": gang["ready_s"], "wall_s": c_wall, "job_s": c_job_s,
            "ttft_s": [c.ttft_s for c in c_], "handoffs": hand, "block_bytes": blk,
            "last": last, "prefill_last": plast, "rc": stopped["rc"],
            "greedy_equal_share": same / (GANG_NEW * len(greedy)),
            "greedy_equal_requests": sum(c_[i].tokens == int8["tokens"][i] for i in greedy),
        }
        gang_log_c(card, out["c"])
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    return out


def gang_log_ab(card: str, ab: dict, bf16: dict) -> None:
    """Print 16a's and 16b's figures (``bf16`` is phase 4's, whose TTFTs
    stand beside 16a's)."""
    s = bf16
    log(f"16a gang (python -m tony_tpu_torch.serve.gang x 2 under the port's AM, the "
        f"port's GangFrontend here; Llama-3-8B bf16 from seed 0, 8 slots, max_len 2048, "
        f"prefix store on; two host processes time-slicing this one card): submit to "
        f"ready " + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(ab["ready_s"].items()))
        + f"; 16 requests x {GANG_NEW} tokens in {ab['a_wall_s']:.2f} s at the frontend; "
        f"TTFT (s) " + ", ".join(f"{v:.3f}" for v in ab["ttft_s"])
        + f" (phase 4's engine: " + ", ".join(f"{v:.3f}" for v in s["ttft_s"])
        + f"); hosts " + ", ".join(h[0] for h in ab["hosts"])
        + f" (requests 6 and 7 on {ab['hosts'][6][0]}); decode steps after 16a "
        + ", ".join(f"{k} {v}" for k, v in ab["steps_after_a"].items())
        + f"; requests whose tokens differ from phase 4's: {ab['differ'] or 'none'}"
        + (f" (first differing token {ab['first_diff']})" if ab["differ"] else "")
        + f"  [{card}]")
    log(f"16b decode:0 killed (chaos kill_container on an on_file trigger) once a stream on "
        f"it had {GANG_KILL_TOKENS} tokens: 16 requests x {GANG_NEW} tokens in "
        f"{ab['b_wall_s']:.2f} s, every one finished, replays {ab['replays']}, every "
        f"replay consistent, the ledger agreeing, the port's check_invariants clean over "
        f"{ab['checked']}; kill to the last request's end "
        f"{ab['kill_to_end_s']:.2f} s, kill to the relaunched decode:0 built "
        f"{ab['relaunch_ready_s']:.1f} s; each host's last count line: "
        + "; ".join(f"{k} {v['decode_steps']} decode steps, paged_decode_attention "
                    f"{v['launches']['paged_decode_attention']}" for k, v in ab["last"].items())
        + f", plain 0; job {ab['job_s']:.1f} s, client exit {ab['rc']}  [{card}]")


def gang_log_c(card: str, gc: dict) -> None:
    """Print 16c's figures."""
    hand = gc["handoffs"]
    ms = sorted(h["ms"] for h in hand)
    dl = gc["last"]["decode_0_attempt0"]
    log(f"16c disaggregated and quantized (1 prefill + 1 decode host, int8 KV pools, int8 "
        f"decode weights, prefix budget 1 GiB): submit to ready "
        + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(gc["ready_s"].items()))
        + f"; 16 requests in {gc['wall_s']:.2f} s; {len(hand)} handoffs (Prefill -> "
        f"ShipBlocks), {sum(h['shipped'] for h in hand)} blocks shipped = "
        f"{sum(h['adopted'] for h in hand)} adopted + {sum(h['freed'] for h in hand)} freed, "
        f"{sum(h['bytes'] for h in hand) / 1e6:.1f} MB = blocks x {gc['block_bytes']} "
        f"bytes; handoff ms (prefill, export, ship, adopt) min {ms[0]:.1f} median "
        f"{ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}; TTFT (s) "
        + ", ".join(f"{v:.3f}" for v in gc["ttft_s"])
        + f"; decode host {dl['decode_steps']} decode steps, paged_decode_attention_quant "
        f"{dl['launches']['paged_decode_attention_quant']}, quant_mm "
        f"{dl['launches']['quant_mm']}, plain 0; greedy tokens equal to phase 4b's int8 "
        f"{gc['greedy_equal_share']:.1%} ({gc['greedy_equal_requests']} of 8 requests); "
        f"job {gc['job_s']:.1f} s  [{card}]")


# --- phases 7-12 and 14: one pair of rank processes on the card ---------------------

# --- phase 15: the job path -------------------------------------------------------

JOB_EXAMPLE = "examples/llama_pretrain_torch"
# every phase but 13 runs with the spine disarmed: the job's AM exports the
# spine's env from these keys, which outrank the env it inherits
JOB_SPINE_OFF = ("trace.enabled=false", "obs.hbm.enabled=false",
                 "obs.health.enabled=false", "obs.series.enabled=false",
                 "obs.profile.enabled=false")
JOB_TIMEOUT_S = 420
JOB_REL_TOL = 1e-3          # 15a against phase 5b: same code, card, seed and stream
JOB_GLOO_LAYERS = 2
JOB_GLOO_STEPS = 3
JOB_GLOO_ATOL = 2e-2        # phase 7's bound against one process
JOB_PUSH_KEYS = ("step", "loss", "tokens_per_sec_per_chip", "mfu", "hbm_mb")
_STEP_LINE = re.compile(r"step (\d+) loss=(\S+) ")


def submit_job(stage: str, workers: int, *defines: str, command: str = "") -> dict:
    """``python -m tony_tpu_torch.cli submit`` of the example job
    (``examples/llama_pretrain_torch``) into ``stage``, as a user submits it,
    with the spine disarmed and ``defines`` as ``-D`` overrides; waits for
    the client's exit. Returns the app dir, exit code, wall time, the
    status file, the history, each worker's log lines (its fit() step lines
    and the JSON line the script prints last) and the submit latency."""
    from tony_tpu_torch.am.events import read_history, submit_latency

    root = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(root, JOB_EXAMPLE)
    argv = [sys.executable, "-m", "tony_tpu_torch.cli", "submit", "--quiet",
            "--conf", os.path.join(ex, "tony.toml"), "--src-dir", ex,
            "-D", f"application.stage_dir={stage}", "-D", f"job.worker.instances={workers}"]
    for d in (*JOB_SPINE_OFF, *defines) + ((f"job.worker.command={command}",) if command
                                           else ()):
        argv += ["-D", d]
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=JOB_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        # stop the job through its AM (which releases its containers), then
        # the client
        for app in os.listdir(stage):
            subprocess.run([sys.executable, "-m", "tony_tpu_torch.cli", "stop",
                            os.path.join(stage, app)], cwd=root, env=env, timeout=60)
        proc.kill()
        proc.communicate()
        raise AssertionError(f"job did not finish in {JOB_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    apps = os.listdir(stage)
    if len(apps) != 1:
        raise AssertionError(f"stage dir holds {apps}: {out}")
    app_dir = os.path.join(stage, apps[0])
    with open(os.path.join(app_dir, "status.json")) as f:
        status = json.load(f)
    hist = os.path.join(app_dir, "events")
    events = read_history(os.path.join(hist, os.listdir(hist)[0]))
    workers_out = []
    for i in range(workers):
        with open(os.path.join(app_dir, "logs", f"worker_{i}_attempt0.log")) as f:
            lines = f.read().splitlines()
        result = next((json.loads(x) for x in reversed(lines) if x.startswith('{"rank"')),
                      None)
        losses = [float(m.group(2)) for x in lines if (m := _STEP_LINE.search(x))]
        workers_out.append({"result": result, "losses": losses, "tail": lines[-20:]})
    res = {"app_dir": app_dir, "rc": proc.returncode, "wall_s": wall, "status": status,
           "events": events, "workers": workers_out, "client": out}
    if proc.returncode == 0:
        res["latency"] = submit_latency(app_dir)
    return res


def check_job(label: str, job: dict, workers: int) -> None:
    """A job that ran to SUCCEEDED: exit 0, every task SUCCEEDED on its
    first attempt, the history from APPLICATION_INITED to
    APPLICATION_FINISHED with one TASK_FINISHED a worker, each worker's
    result line printed. Raises with the workers' logs otherwise."""
    types = [e["type"] for e in job["events"]]
    ok = (job["rc"] == 0 and job["status"]["state"] == "SUCCEEDED"
          and all(t["state"] == "SUCCEEDED" and t["attempts"] == 1
                  for t in job["status"]["tasks"])
          and len(job["status"]["tasks"]) == workers
          and types[0] == "APPLICATION_INITED" and types[-1] == "APPLICATION_FINISHED"
          and types.count("TASK_FINISHED") == workers
          and all(w["result"] is not None for w in job["workers"]))
    if not ok:
        tails = "\n".join(f"--- worker {i}\n" + "\n".join(w["tail"])
                          for i, w in enumerate(job["workers"]))
        raise AssertionError(f"{label}: rc {job['rc']}, status {job['status']}, events "
                             f"{types}\n{job['client']}\n{tails}")


def job_pushes(job: dict, task: str = "worker:0") -> list[dict]:
    """The task's pushes from fit() in the history (the ones carrying
    ``step``): the AM keeps a task's first and then one each 30 s."""
    return [e["samples"] for e in job["events"]
            if e["type"] == "METRICS" and e["task"] == task and "step" in e["samples"]]


def job_phase(card: str, ce: dict) -> dict:
    """Phase 15a: the example job through the port's CLI, AM, local
    backend, executor and ``pytorch`` runtime: one worker whose user
    process is ``train.py --preset bench_1b4 --ce-impl pallas --steps 10``,
    phase 5b's whole FitConfig. Held against phase 5b: the launches of
    kernels 1-6 equal, no plain version, each of the ten losses within
    JOB_REL_TOL relative; the history and the pushed keys as the
    reference's AM records them."""
    stage = tempfile.mkdtemp(prefix="chip_smoke_job_")
    try:
        job = submit_job(stage, 1)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    check_job("15a", job, 1)
    w = job["workers"][0]
    launches = w["result"]["launches"]
    want = {k: v for k, v in ce["launches"].items()
            if k.startswith(("flash_", "ce_"))}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"15a launches {launches} != phase 5b's {want}")
    others = {k: v for k, v in launches.items() if k not in want and v}
    if others:
        raise AssertionError(f"15a launched kernels off its path: {others}")
    if len(w["losses"]) != TRAIN_STEPS:
        raise AssertionError(f"15a logged losses {w['losses']}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(w["losses"], ce["losses"])]
    if max(gaps) > JOB_REL_TOL:
        raise AssertionError(f"15a losses {w['losses']} against phase 5b's {ce['losses']}")
    pushes = job_pushes(job)
    if not pushes or pushes[0]["step"] != 1:
        raise AssertionError(f"15a history holds no first-step push: {pushes}")
    missing = [k for k in JOB_PUSH_KEYS if k not in pushes[0]]
    startup = sorted(k for k in pushes[0] if k.startswith("startup_"))
    if missing or not startup or any(k.startswith("startup_") for p in pushes[1:] for k in p):
        raise AssertionError(f"15a pushes {pushes}: missing {missing}")
    dropped = [p.get("metrics_dropped", 0) for p in job_pushes(job)]
    if any(dropped):
        raise AssertionError(f"15a dropped pushes: {dropped}")
    return {"job": job, "launches": launches, "losses": w["losses"], "gaps": gaps,
            "final": w["result"]["final"], "pushes": pushes, "startup_keys": startup}


def job_gloo_config():
    """bench_1b4 at full width cut to JOB_GLOO_LAYERS layers with the
    pallas CE head: what 15b's train.py builds."""
    return dataclasses.replace(dense_train_config(), n_layers=JOB_GLOO_LAYERS,
                               ce_impl="pallas")


def job_gloo_twin() -> list[float]:
    """15b's fit() in this process, on one rank: the losses its two workers
    are held to."""
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    cfg = job_gloo_config()
    steps: list[dict] = []
    fit(FitConfig(model=cfg, data=DataConfig(global_batch=8, seq_len=2048,
                                             vocab_size=cfg.vocab_size),
                  steps=JOB_GLOO_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                  mu_dtype="bfloat16", on_metrics=steps.append), device="cuda")
    torch.cuda.empty_cache()
    return [m["loss"] for m in steps]


def job_gloo_phase(card: str) -> dict:
    """Phase 15b: the example job with two workers (``framework =
    "pytorch"``, ``train.py --backend gloo``: both ranks on this one card,
    the default group on gloo, fsdp over both), bench_1b4 at full width
    and JOB_GLOO_LAYERS layers, JOB_GLOO_STEPS steps. Both workers finish;
    worker 0's losses within JOB_GLOO_ATOL of the same fit() in one
    process; on each rank the flash kernels once per layer and step and
    the CE kernels once a step (ce_dh and ce_dw once per vocab chunk), no
    plain version."""
    from tony_tpu_torch.ops import fused_ce

    twin = job_gloo_twin()
    stage = tempfile.mkdtemp(prefix="chip_smoke_job_")
    cmd = (f"python train.py --preset bench_1b4 --layers {JOB_GLOO_LAYERS} --ce-impl "
           f"pallas --steps {JOB_GLOO_STEPS} --backend gloo")
    try:
        job = submit_job(stage, 2, command=cmd)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    check_job("15b", job, 2)
    chunks = len(fused_ce.dlogits_chunks(job_gloo_config().vocab_size))
    want = {"ce_fwd": JOB_GLOO_STEPS, "ce_dh": JOB_GLOO_STEPS * chunks,
            "ce_dw": JOB_GLOO_STEPS * chunks,
            **{n: JOB_GLOO_LAYERS * JOB_GLOO_STEPS for n in FLASH_KERNELS}}
    want.update({f"{n}_plain": 0 for n in list(want)})
    launches = [w["result"]["launches"] for w in job["workers"]]
    for r, lc in enumerate(launches):
        if any(lc[k] != v for k, v in want.items()):
            raise AssertionError(f"15b rank {r} launches {lc} != {want}")
    losses = job["workers"][0]["losses"]
    diffs = [abs(a - b) for a, b in zip(losses, twin)]
    if len(losses) != JOB_GLOO_STEPS or max(diffs) > JOB_GLOO_ATOL:
        raise AssertionError(f"15b losses {losses} against one process's {twin}")
    finals = [w["result"]["final"] for w in job["workers"]]
    return {"job": job, "launches": launches, "losses": losses, "twin": twin,
            "diffs": diffs, "finals": finals, "transport": "gloo, host-staged"}



# --- phase 17: the operator's tools -------------------------------------------------

CHAOS_CKPT_EVERY = 5        # 17a: a checkpoint every 5 steps; worker 0 dies once step 5's landed
TOOL_TIMEOUT_S = 120        # one read-side tool's run
PROFILE_STEPS = 2           # 17c: the live capture window
PROFILE_JOB_STEPS = 400     # 17c: the live job's length; it is stopped once the capture landed
PROFILE_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "ce_fwd", "ce_dh", "ce_dw")


def tony(*argv: str, timeout: float = TOOL_TIMEOUT_S) -> subprocess.CompletedProcess:
    """``python -m tony_tpu_torch.cli <argv>`` from the checkout's root, as
    a user runs it."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m", "tony_tpu_torch.cli", *argv], cwd=root,
                          env=env, capture_output=True, text=True, timeout=timeout)


def tool_failed(label: str, r: subprocess.CompletedProcess, app_dir: str = "") -> str:
    logs = ""
    if app_dir and os.path.isdir(os.path.join(app_dir, "logs")):
        for name in sorted(os.listdir(os.path.join(app_dir, "logs"))):
            with open(os.path.join(app_dir, "logs", name), errors="replace") as f:
                logs += f"\n--- {name}\n" + f.read()[-3000:]
    return (f"{label}: exit {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}{logs}")


def attempt_losses(app_dir: str, attempt: int) -> dict[int, float]:
    with open(os.path.join(app_dir, "logs", f"worker_0_attempt{attempt}.log")) as f:
        return {int(m.group(1)): float(m.group(2))
                for x in f.read().splitlines() if (m := _STEP_LINE.search(x))}


def chaos_job_phase(card: str, job: dict, ce: dict, work: str) -> dict:
    """Phase 17a: ``tony chaos`` over phase 15a's example job (``train.py
    --preset bench_1b4 --ce-impl pallas --steps 10``) with a checkpoint
    every CHAOS_CKPT_EVERY steps and a lease store, worker:0 killed once
    step 5's checkpoint is published (an ``on_file`` trigger on its
    directory, attempt 0 only), the trace journaling every step and the
    rest of the spine at its defaults. Held: exit 0 with ``--expect
    SUCCEEDED`` and a clean report; worker:0 at 2 attempts; the resumed
    attempt starting at step 6, its losses within JOB_REL_TOL of 15a's same
    steps (the killed attempt's too); kernels 1-6 launched by it at 5
    steps' counts (phase 5b's over 10 steps, halved), no plain version."""
    root = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(root, JOB_EXAMPLE)
    stage, ckpt, rm = (os.path.join(work, d) for d in ("apps", "ckpt", "rm"))
    faults = json.dumps([{"type": "kill_container", "task": "worker:0",
                          "on_file": os.path.join(ckpt, str(CHAOS_CKPT_EVERY))}])
    t0 = time.perf_counter()
    r = tony("chaos", "--quiet", "--conf", os.path.join(ex, "tony.toml"), "--src-dir", ex,
             "-D", f"application.stage_dir={stage}", "-D", f"checkpoint.dir={ckpt}",
             "-D", f"checkpoint.interval_steps={CHAOS_CKPT_EVERY}", "-D", "checkpoint.keep=1",
             "-D", f"cluster.rm_root={rm}", "-D", "task.heartbeat_interval_ms=200",
             "-D", "trace.sample_steps=1", "--faults", faults, "--expect", "SUCCEEDED",
             timeout=JOB_TIMEOUT_S)
    wall = time.perf_counter() - t0
    apps = os.listdir(stage) if os.path.isdir(stage) else []
    app_dir = os.path.join(stage, apps[0]) if len(apps) == 1 else ""
    if r.returncode != 0:
        raise AssertionError(tool_failed("17a tony chaos", r, app_dir))
    res = json.loads(r.stdout[r.stdout.index("{"):])
    if res["state"] != "SUCCEEDED" or not res["report"]["ok"] or res["app_dir"] != app_dir:
        raise AssertionError(tool_failed("17a report", r, app_dir))
    with open(os.path.join(app_dir, "status.json")) as f:
        attempts = {t["task"]: t["attempts"] for t in json.load(f)["tasks"]}
    if attempts != {"worker:0": 2}:
        raise AssertionError(f"17a: attempts {attempts}")
    killed, resumed = (attempt_losses(app_dir, a) for a in (0, 1))
    steps = TRAIN_STEPS - CHAOS_CKPT_EVERY
    if (sorted(resumed) != list(range(CHAOS_CKPT_EVERY + 1, TRAIN_STEPS + 1))
            or not set(range(1, CHAOS_CKPT_EVERY + 1)) <= set(killed)):
        raise AssertionError(f"17a: the killed attempt logged steps {sorted(killed)}, the "
                             f"resumed one {sorted(resumed)}")
    gaps = {f"{a}:{k}": abs(v - job["losses"][k - 1]) / abs(job["losses"][k - 1])
            for a, d in (("killed", killed), ("resumed", resumed)) for k, v in d.items()}
    if max(gaps.values()) > JOB_REL_TOL:
        raise AssertionError(f"17a: losses {killed} / {resumed} against 15a's "
                             f"{job['losses']}: relative gaps {gaps}")
    with open(os.path.join(app_dir, "logs", "worker_0_attempt1.log")) as f:
        lines = f.read().splitlines()
    result = next(json.loads(x) for x in reversed(lines) if x.startswith('{"rank"'))
    launches = result["launches"]
    want = {k: ce["launches"][k] // TRAIN_STEPS * steps for k in PROFILE_KERNELS}
    off = {k: v for k, v in launches.items() if v and k not in want}
    if any(launches[k] != v for k, v in want.items()) or off:
        raise AssertionError(f"17a: the resumed worker's launches {launches} != {want}")
    if f"resumed from checkpoint step {CHAOS_CKPT_EVERY}" not in "\n".join(lines):
        raise AssertionError("17a: the relaunched worker did not resume from step 5")
    return {"app_dir": app_dir, "stage": stage, "rm": rm, "wall_s": wall, "report": res,
            "killed": killed, "resumed": resumed, "gaps": gaps, "launches": launches,
            "final": result["final"]}


def tools_phase(card: str, a: dict) -> dict:
    """Phase 17b: the read-side tools on 17a's app dir, each a process as
    a user runs it: ``trace`` (exit 0, events, fit's ``train.fit`` and
    ``train.step`` spans, the killed attempt's begin-only spans),
    ``health`` (exit 0, healthy), ``elastic`` (exit 2: not an elastic
    job), ``top --once`` (one row: worker 0), ``rm-status`` (exit 0, no
    app holding a lease) and the portal (``python -m
    tony_tpu_torch.obs.portal`` over the stage dir: the app list and
    17a's page, both 200)."""
    import urllib.request

    from tony_tpu_torch.utils.net import find_free_port

    app, out = a["app_dir"], {}
    t0 = time.perf_counter()
    r = tony("trace", app)
    if r.returncode != 0:
        raise AssertionError(tool_failed("17b tony trace", r))
    summary = json.loads(r.stdout)
    with open(summary["out"]) as f:
        merged = json.load(f)["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in merged
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    spans = {(names.get(e.get("pid"), ""), e.get("ph"), e.get("name")) for e in merged}
    begin_only = sorted({(p, n) for p, ph, n in spans if ph == "B"})
    fit_spans = sorted(n for p, ph, n in spans if ph == "X" and n in ("train.fit",
                                                                      "train.step"))
    if (summary["events"] <= 0 or set(fit_spans) != {"train.fit", "train.step"}
            or not any(p.endswith("_a0") for p, _ in begin_only)):
        raise AssertionError(f"17b trace: {summary}; fit spans {fit_spans}, begin-only "
                             f"{begin_only}")
    steps = sum(1 for e in merged if e.get("name") == "train.step" and e.get("ph") == "X")
    out["trace"] = {"events": summary["events"], "goodput": summary["goodput"],
                    "begin_only": begin_only, "step_spans": steps}
    r = tony("health", app)
    if r.returncode != 0 or json.loads(r.stdout)["verdict"] != "healthy":
        raise AssertionError(tool_failed("17b tony health", r))
    out["health"] = json.loads(r.stdout)["procs"]
    r = tony("elastic", app)
    if r.returncode != 2:
        raise AssertionError(tool_failed("17b tony elastic", r))
    r = tony("top", app, "--once")
    rows = [ln.split()[0] for ln in r.stdout.splitlines() if ln.startswith("worker_")]
    if r.returncode != 0 or len(rows) != 1 or not rows[0].startswith("worker_0"):
        raise AssertionError(tool_failed("17b tony top --once", r))
    out["top"] = r.stdout.splitlines()
    r = tony("rm-status", "--rm-root", a["rm"])
    if r.returncode != 0 or json.loads(r.stdout)["apps"]:
        raise AssertionError(tool_failed("17b tony rm-status", r))
    out["rm"] = json.loads(r.stdout)
    root = os.path.dirname(os.path.abspath(__file__))
    port = find_free_port()
    portal = subprocess.Popen([sys.executable, "-m", "tony_tpu_torch.obs.portal", "--port",
                               str(port), "--apps-root", a["stage"]], cwd=root,
                              env={**os.environ, "PYTHONPATH": root},
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        codes, deadline = {}, time.monotonic() + 30
        for path in ("/", f"/job/{os.path.basename(app)}", "/api/jobs"):
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                                timeout=10) as resp:
                        codes[path], body = resp.status, resp.read().decode()
                    break
                except OSError:
                    if time.monotonic() > deadline or portal.poll() is not None:
                        raise
                    time.sleep(0.2)
            if os.path.basename(app) not in body:
                raise AssertionError(f"17b portal {path}: the app is not on the page")
    finally:
        portal.terminate()
        portal.wait(timeout=30)
    if set(codes.values()) != {200}:
        raise AssertionError(f"17b portal: {codes}")
    out["portal"] = codes
    out["wall_s"] = time.perf_counter() - t0
    return out


def live_profile_phase(card: str, work: str) -> dict:
    """Phase 17c: ``tony profile <app> --steps 2`` against the example job
    running on the card (``train.py --preset bench_1b4 --ce-impl pallas``,
    submitted ``--detach``): the AM broadcasts the window, the worker's
    profiler captures two steps, and the anatomy report's capture (its
    ``artifact``, a Chrome trace) holds at least one event of each of
    kernels 1-6 (their tensor-core names). The job is then stopped through
    its AM and must end KILLED."""
    root = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(root, JOB_EXAMPLE)
    stage = os.path.join(work, "live")
    r = tony("submit", "--detach", "--quiet", "--conf", os.path.join(ex, "tony.toml"),
             "--src-dir", ex, "-D", f"application.stage_dir={stage}",
             "-D", f"job.worker.command=python train.py --preset bench_1b4 --ce-impl pallas "
                   f"--steps {PROFILE_JOB_STEPS}")
    if r.returncode != 0:
        raise AssertionError(tool_failed("17c tony submit --detach", r))
    app = os.path.join(stage, r.stdout.strip().splitlines()[-1])
    log_path = os.path.join(app, "logs", "worker_0_attempt0.log")
    t0 = time.perf_counter()
    try:
        deadline = time.monotonic() + JOB_TIMEOUT_S
        while True:
            text = open(log_path, errors="replace").read() if os.path.exists(log_path) else ""
            if _STEP_LINE.search(text):
                break
            if time.monotonic() > deadline or os.path.exists(os.path.join(app, "status.json")):
                raise AssertionError(f"17c: the live job never logged a step:\n{text[-3000:]}")
            time.sleep(0.5)
        first_step = time.perf_counter() - t0
        t1 = time.perf_counter()
        r = tony("profile", app, "--steps", str(PROFILE_STEPS), "--wait", "120", timeout=240)
        profile_s = time.perf_counter() - t1
    finally:
        stop = tony("stop", app)
        deadline = time.monotonic() + 120
        while not os.path.exists(os.path.join(app, "status.json")):
            if time.monotonic() > deadline:
                raise AssertionError(tool_failed("17c: the job did not end after tony stop",
                                                 stop, app))
            time.sleep(0.5)
    if r.returncode != 0:
        raise AssertionError(tool_failed("17c tony profile", r, app))
    report = json.loads(r.stdout)
    procs = report["procs"]
    if list(procs) != ["worker_0_user_a0"] or procs["worker_0_user_a0"]["steps"] != PROFILE_STEPS:
        raise AssertionError(f"17c: the report's processes {list(procs)}: {report}")
    with open(procs["worker_0_user_a0"]["artifact"]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    events = {k: sum(any(has_kernel(n, t) for t in KERNEL_EVENTS[k]) for n in names)
              for k in PROFILE_KERNELS}
    if not all(events.values()):
        raise AssertionError(f"17c: the capture's kernel events {events}")
    with open(os.path.join(app, "status.json")) as f:
        state = json.load(f)["state"]
    if state != "KILLED":
        raise AssertionError(f"17c: the stopped job ended {state}")
    return {"events": events, "per_step_ms": procs["worker_0_user_a0"]["per_step_ms"],
            "first_step_s": first_step, "profile_s": profile_s,
            "wall_s": time.perf_counter() - t0, "profile_id": report["profile_id"]}


def operator_phase(card: str, job: dict, ce: dict) -> dict:
    """Phase 17 (17a, 17b, 17c) in a scratch directory it removes; logs
    each part and returns 17a's figures (its resumed worker's launches
    join the kernels line). ``job`` is phase 15a's, ``ce`` phase 5b's."""
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        t17 = time.perf_counter()
        ca = chaos_job_phase(card, job, ce, work)
        rep = ca["report"]
        log(f"17a tony chaos (python -m tony_tpu_torch.cli chaos of {JOB_EXAMPLE}, phase 15a's "
            f"job, checkpoint every {CHAOS_CKPT_EVERY} steps, kill_container on worker:0 once "
            f"step {CHAOS_CKPT_EVERY}'s checkpoint landed, the trace every step and the health "
            f"sentinel armed): exit 0, {rep['state']}, report ok {rep['report']['ok']} "
            f"(violations {len(rep['report']['violations'])}, notes "
            f"{rep['report']['notes']}); worker:0 attempts 2; killed attempt's losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ca["killed"].items()))
            + "; resumed " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ca["resumed"].items()))
            + f"; largest relative gap to 15a's same steps {max(ca['gaps'].values()):.3e} "
            f"(limit {JOB_REL_TOL}); the resumed worker's launches "
            + ", ".join(f"{k} {ca['launches'][k]}" for k in PROFILE_KERNELS)
            + f", plain 0; its p50 step {ca['final']['step_time_p50_s'] * 1e3:.1f} ms; "
            f"chaos run wall {ca['wall_s']:.1f} s  [{card}]")
        tb = tools_phase(card, ca)
        tr = tb["trace"]
        log(f"17b tools on 17a's app dir: tony trace exit 0, {tr['events']} events, "
            f"{tr['step_spans']} train.step spans, begin-only spans {tr['begin_only']}, "
            f"goodput {tr['goodput']}; tony health exit 0, healthy ({sorted(tb['health'])}); "
            f"tony elastic exit 2; tony top --once: {tb['top'][-1].split()[0]}; tony "
            f"rm-status exit 0, no app leased, hosts {sorted(tb['rm']['hosts'])}; the portal "
            f"{tb['portal']}; tools wall {tb['wall_s']:.1f} s  [{card}]")
        lp = live_profile_phase(card, work)
        log(f"17c tony profile --steps {PROFILE_STEPS} against the example job live on the "
            f"card (bench_1b4, ce_impl=pallas): submit to first step {lp['first_step_s']:.1f} "
            f"s, profile broadcast to report {lp['profile_s']:.1f} s; the capture's kernel "
            f"events " + ", ".join(f"{k} {v}" for k, v in lp["events"].items())
            + f"; anatomy per step (ms) {lp['per_step_ms']}; the job stopped, KILLED; phase "
            f"wall {lp['wall_s']:.1f} s; phase 17 wall {time.perf_counter() - t17:.1f} s  "
            f"[{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ca


RANKS = 2
RANK_TIMEOUT_S = 900


def rank_main(rank: int, port: int, out: str, ckpt_dir: str) -> int:
    """One of the two rank processes phases 7-12 and 14 share: bring up a
    gloo group over tcp://localhost on this card, then run phase 7's to
    12's and 14's fit() calls in turn (one process start and one warm-up
    for all seven), and write what each saw to ``out``. Phase 14 re-forms
    the group twice; the group it ends with closes the run."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=RANKS)
    res = {"rank": rank, "7": fsdp_runs(rank), "8": ep_runs(rank, ckpt_dir),
           "9": par_runs(rank), "10": pp_runs(), "11": moe_tp_runs(rank),
           "12": capacity_runs(rank),
           "14": elastic_runs(rank, os.path.join(os.path.dirname(ckpt_dir), "elastic"))}
    dist.barrier()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def rank_phases() -> list[dict]:
    """Start the two rank processes of phases 7-12 and 14 (``--rank``),
    wait for both within RANK_TIMEOUT_S, and return what each rank saw;
    the phases' checks read it (``fsdp_phase``, ``ep_phase``,
    ``par_phase``, ``pp_phase``, ``moe_tp_phase``, ``capacity_phase``,
    ``elastic_phase``). A rank that fails fails them all."""
    import shutil
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="ranks-")
    outs = [f"{tmp}/rank{r}.json" for r in range(RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(port),
                               outs[r], f"{tmp}/ckpt"]) for r in range(RANKS)]
    try:
        codes = [p.wait(timeout=max(1.0, RANK_TIMEOUT_S - (time.perf_counter() - t0)))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        shutil.rmtree(tmp, ignore_errors=True)
        raise AssertionError(f"phase 7-12 and 14 rank processes exited {codes}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phases 7-12 and 14 rank processes: {time.perf_counter() - t0:.1f} s")
    return ranks


# --- phase 4f: the slot budget from a probe of the decode step ------------------------


def capacity_probe_phase(cfg, params, bf16: dict) -> dict:
    """Phase 4f: ``derive_slot_budget`` for Llama-3-8B at max_len 2048 and
    kv_block 64 (phase 4's engine), from probe decode steps at 1 and 2
    slots on phase 4's weights: the bf16 budget with int8 and with fp8
    pools beside it, each with a 256-token shared prefix (phase 4's
    requests 6 and 7 share one), every component reported; the prediction
    for phase 4's 8 slots beside phase 4's measured peak."""
    from tony_tpu_torch.serve.capacity import derive_slot_budget

    out = {}
    t0 = time.perf_counter()
    for quant in ("int8", "fp8_e4m3"):
        b = derive_slot_budget(cfg, max_len=2048, kv_block=64, shared_prefix_tokens=256,
                               quant_kv=quant, params=params)
        torch.cuda.empty_cache()
        if not (b["per_slot_temp_bytes"] > 0 and b["max_slots_native"] > 8
                and b["max_slots_quant"] > b["max_slots_native"]
                and b["max_slots_prefix_shared"] >= b["max_slots_native"]):
            raise AssertionError(f"slot budget {quant} implausible: {b}")
        out[quant] = b
    out["probe_s"] = time.perf_counter() - t0
    # phase 4's bf16 engine at 8 slots: params + fixed temp + 8 x (KV + temp a slot)
    b = out["int8"]
    out["predicted_8_gb"] = (b["param_bytes"] + b["fixed_temp_bytes"] + 8 * (
        b["kv_bytes_per_slot_native"] + b["per_slot_temp_bytes"])) / 1e9
    out["phase4_peak_gb"] = bf16["peak_allocated_gb"]
    return out


# --- phase 5c: the matmul remat policies ----------------------------------------------

REMAT_POLICY_STEPS = 2


def remat_policy_phase(card: str, scan: dict) -> dict:
    """Phase 5c: phase 5's fit() under ``remat_policy="dots"`` and
    ``"checkpoint_dots"``, 2 steps each: step 1's loss within 1e-3 of phase
    5's (the same weights and batch; remat changes what is recomputed, not
    the arithmetic), the flash forward recomputed in the backward (neither
    policy saves a kernel's output: 2 launches a layer and step, dq and
    dkv 1), no plain version; peak memory and step time beside phase 5's."""
    from tony_tpu_torch.ops import attention
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    out = {}
    for policy in ("dots", "checkpoint_dots"):
        cfg = dense_train_config(remat_policy=policy)
        data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size)
        steps: list[dict] = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.reset_launches()
        fit(FitConfig(model=cfg, data=data, steps=REMAT_POLICY_STEPS, log_every=1,
                      lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
                      on_metrics=steps.append), device="cuda")
        launches = dict(attention.LAUNCHES)
        n = cfg.n_layers * REMAT_POLICY_STEPS
        want = {"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n, "flash_fwd_plain": 0,
                "flash_dq_plain": 0, "flash_dkv_plain": 0}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"{policy}: launches {launches} != {want}")
        diff = abs(steps[0]["loss"] - scan["losses"][0])
        if not all(math.isfinite(m["loss"]) for m in steps) or diff > 1e-3:
            raise AssertionError(f"{policy}: losses {[m['loss'] for m in steps]}, step 1 "
                                 f"{diff:.3e} from phase 5's")
        out[policy] = {"losses": [m["loss"] for m in steps], "loss_diff": diff,
                       "step_ms": steps[-1]["step_time_s"] * 1e3,
                       "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": launches}
        torch.cuda.empty_cache()
    return out


# --- phase 13: the observability spine armed --------------------------------------------

SPINE_ENV = ("TONY_OBS_HBM", "TONY_OBS_HEALTH", "TONY_OBS_SERIES", "TONY_OBS_PROFILE")
SPINE_STEPS = 4
SPINE_PROC = "chip_smoke"


def disarm_spine() -> None:
    """Every phase but 13 runs with the spine disarmed (it arms by default
    in fit() and the engine): their numbers stay comparable with earlier
    runs', and phase 13 measures what arming costs. Rank processes inherit
    this env."""
    for key in SPINE_ENV:
        os.environ[key] = "0"
    for key in ("TONY_TRACE_DIR", "TONY_APP_DIR", "TONY_CHAOS_NAN_STEP", "TONY_TRACE_PROC"):
        os.environ.pop(key, None)


def _spine_env(app_dir: str, armed: bool, every_step: bool = True, **extra) -> None:
    """The env of one phase-13 run: the app dir (the profile controller
    reads its requests there) and, armed, every part; ``every_step``
    samples each step, else at the default strides (16)."""
    from tony_tpu_torch.obs import hbm, health, profile, series, slo, trace

    for mod in (trace, hbm, health, series, slo, profile):
        mod.uninstall()
    disarm_spine()
    os.environ.update({"TONY_APP_DIR": app_dir, "TONY_OBS_PROFILE": "1",
                       "TONY_TRACE_PROC": SPINE_PROC, **extra})
    strides = ("TONY_TRACE_SAMPLE", "TONY_OBS_HBM_SAMPLE", "TONY_OBS_HEALTH_SAMPLE",
               "TONY_OBS_SERIES_SAMPLE")
    for key in strides:
        os.environ.pop(key, None)
    if armed:
        os.environ.update({"TONY_TRACE_DIR": os.path.join(app_dir, "trace"),
                           "TONY_OBS_HBM": "1", "TONY_OBS_HEALTH": "1",
                           "TONY_OBS_SERIES": "1"})
        if every_step:
            os.environ.update({key: "1" for key in strides})


def write_token_file(path: str, cfg, n_batches: int) -> None:
    """``n_batches`` batches of the synthetic stream (8 x 2048, seed 0), as
    the flat int32 windows of ``seq_len + 1`` tokens the loader reads."""
    from tony_tpu_torch.train.data import DataConfig, synthetic_batches

    it = synthetic_batches(DataConfig(global_batch=8, seq_len=2048,
                                      vocab_size=cfg.vocab_size))
    with open(path, "wb") as f:
        for _ in range(n_batches):
            inputs, targets = next(it)
            np.concatenate([inputs.numpy(), targets.numpy()[:, -1:]], axis=1) \
                .astype(np.int32).tofile(f)


def trace_counts(path: str) -> dict:
    """From a Chrome trace of one step: the device-to-host copies and the
    synchronizing runtime calls issued by the thread that ran the step
    (the one holding the ``anatomy.step`` region), the device time, and
    the kernels' names."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    main = {e["tid"] for e in events if e.get("name") == "anatomy.step"
            and e.get("cat") == "user_annotation"}
    runtime = {e["args"]["correlation"]: e["tid"] for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and e.get("name", "").startswith("Memcpy DtoH")]
    syncs = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return {
        "main_d2h": sum(runtime.get(e["args"].get("correlation")) in main for e in d2h),
        "other_d2h": sum(runtime.get(e["args"].get("correlation")) not in main for e in d2h),
        "main_syncs": sum(e.get("cat") == "cuda_runtime" and e.get("name") in syncs
                          and e.get("tid") in main for e in events),
        "device_ms": sum(e.get("dur", 0) for e in device) / 1e3,
        "kernels": {e["name"] for e in events if e.get("cat") == "kernel"},
        "main_tids": sorted(main),
    }


def spine_train_run(app_dir: str, token_file: str, armed: bool, **fit_kw) -> dict:
    """bench_1b4 through fit() for 4 steps over the token file through the
    native loader, a profile window requested for step 2 (from step 1's
    metrics callback; step 3 then pays the trace's export, so step 4 is
    the unprofiled one), with the spine armed or not."""
    from tony_tpu_torch.obs import profile
    from tony_tpu_torch.ops import attention
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    _spine_env(app_dir, armed)
    cfg = dense_train_config()
    data = DataConfig(global_batch=8, seq_len=2048, vocab_size=cfg.vocab_size,
                      path=token_file)
    steps: list[dict] = []

    def on_metrics(m: dict) -> None:
        steps.append(m)
        if m["step"] == 1:
            profile.active_controller().trigger(steps=1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launches()
    final = fit(FitConfig(model=cfg, data=data, steps=SPINE_STEPS, log_every=1, lr=3e-4,
                          warmup_steps=2, mu_dtype="bfloat16", on_metrics=on_metrics,
                          **fit_kw), device="cuda")
    peak = torch.cuda.max_memory_allocated()
    man = profile.read_manifests(app_dir)[SPINE_PROC]
    if man["steps"] != 1 or not man["artifact"]:
        raise AssertionError(f"profile window: {man}")
    check_memory_keys("13", steps)
    return {"final": final, "steps": steps, "peak_bytes": peak,
            "launches": dict(attention.LAUNCHES), "trace": trace_counts(man["artifact"]),
            "anatomy": window_anatomy(app_dir)}


def window_anatomy(app_dir: str) -> dict:
    """The anatomy report (``obs/anatomy.py``) of the profile window under
    ``app_dir``: its budget rows must sum to each captured step's time
    within 10%, as the reference's capture test holds its own, and the
    trace must show device compute."""
    from tony_tpu_torch.obs import anatomy

    rep_ = anatomy.build_anatomy(app_dir)["procs"][SPINE_PROC]
    for row in rep_["table"]:
        parts = sum(row[k] for k in ("compute_s", "exposed_collective_s", "input_wait_s",
                                     "host_blocked_s"))
        if not rep_["device_trace"] or row["compute_s"] <= 0 or \
                abs(parts - row["step_time_s"]) > 0.10 * row["step_time_s"]:
            raise AssertionError(f"anatomy budget of the profile window: {rep_['table']} "
                                 f"(device trace {rep_['device_trace']})")
    return rep_


def spine_phase(card: str, cfg8, params8, work_dir: str) -> dict:
    """Phase 13: the observability spine armed at full width.

    Training: bench_1b4 over a token file the script writes from the
    synthetic stream, through the native loader, 4 steps disarmed and 4
    armed (trace, memory watch, health sentinel and series each sampling
    every step), a profile window on step 2 of each. Held: the loader ran
    native; the losses armed are the disarmed ones; the journal has
    ``train.fit`` and the sampled ``train.step`` spans of steps 2-4; the
    verdict is healthy; the memory watch's
    peak is ``torch.cuda.max_memory_allocated``'s; the profile's Chrome
    trace names kernels 1-3; the step thread's device-to-host copies and
    synchronizing calls in the profiled step are as many armed as
    disarmed. Then the NaN seam (``TONY_CHAOS_NAN_STEP=2``, bench_1b4 at 4
    layers, 3 steps): the sentinel trips ``nonfinite`` at step 2 with a
    forensics bundle. Serving: phase 4's traffic through an armed engine
    at the default strides; the registry's TTFT, TPOT and step histograms
    count what ``DecodeMetrics`` counts."""
    from tony_tpu_torch.obs import health, hbm, profile, series, slo, trace
    from tony_tpu_torch.ops.decode_attention import LAUNCHES as ATTN_LAUNCHES
    from tony_tpu_torch.serve import Engine, ServeConfig
    from tony_tpu_torch.train.native_loader import available

    if not available():
        raise AssertionError("the native token loader did not build (g++)")
    token_file = os.path.join(work_dir, "tokens.bin")
    cfg = dense_train_config()
    write_token_file(token_file, cfg, SPINE_STEPS + 1)      # an epoch past the run
    t0 = time.perf_counter()
    off = spine_train_run(os.path.join(work_dir, "off"), token_file, armed=False)
    on_dir = os.path.join(work_dir, "on")
    on = spine_train_run(on_dir, token_file, armed=True)
    trace.flush()
    train_s = time.perf_counter() - t0
    for label, run in (("disarmed", off), ("armed", on)):
        if run["final"]["loader"] != "native":
            raise AssertionError(f"{label}: loader {run['final']['loader']}")
        names = run["trace"]["kernels"]
        missing = [k for k in ("tc::flash_fwd_kernel", "tc::flash_dq_kernel",
                               "tc::flash_dkv_kernel") if not any(k in n for n in names)]
        if missing or len(run["trace"]["main_tids"]) != 1:
            raise AssertionError(f"{label}: profile trace lacks {missing} or its step "
                                 f"thread ({run['trace']['main_tids']})")
    losses = [[m["loss"] for m in r["steps"]] for r in (off, on)]
    if not np.allclose(losses[0], losses[1], rtol=0, atol=2e-4) or \
            not all(math.isfinite(x) for x in losses[1]):
        raise AssertionError(f"armed losses {losses[1]} != disarmed {losses[0]}")
    recs = [json.loads(line) for line in open(os.path.join(on_dir, "trace",
                                                           f"{SPINE_PROC}.jsonl"))]
    spans = sorted((r["name"], r["args"].get("step")) for r in recs if r.get("ph") == "X")
    want = [("fit.startup.first_batch", None), ("train.fit", None),
            *(("train.step", i) for i in range(2, SPINE_STEPS + 1))]
    if spans != want:
        raise AssertionError(f"journal spans {spans} != {want}")
    verdicts = health.read_verdicts(on_dir)
    if on["final"].get("health_verdict") != "healthy" or \
            verdicts.get(SPINE_PROC, {}).get("verdict") != "healthy":
        raise AssertionError(f"health verdict {on['final'].get('health_verdict')}, "
                             f"file {verdicts}")
    peak_gib = on["peak_bytes"] / 2**30
    if not on["final"].get("peak_hbm_exact") or \
            abs(on["final"]["peak_hbm_gb"] - peak_gib) > 6e-4:
        raise AssertionError(f"hbm peak {on['final'].get('peak_hbm_gb')} GiB "
                             f"(exact {on['final'].get('peak_hbm_exact')}) != "
                             f"max_memory_allocated {peak_gib:.4f} GiB")
    for key in ("main_d2h", "main_syncs"):
        if on["trace"][key] != off["trace"][key]:
            raise AssertionError(f"armed step's {key} {on['trace'][key]} != disarmed "
                                 f"{off['trace'][key]}")
    for mod in (trace, hbm, health, series, slo, profile):
        mod.uninstall()

    # the NaN seam: a fresh sentinel, the reported loss NaN from step 2
    nan_dir = os.path.join(work_dir, "nan")
    _spine_env(nan_dir, armed=True, TONY_CHAOS_NAN_STEP="2")
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    small = dataclasses.replace(dense_train_config(), n_layers=4)
    nan_final = fit(FitConfig(model=small, data=DataConfig(
        global_batch=8, seq_len=2048, vocab_size=small.vocab_size), steps=SPINE_STEPS,
        log_every=1, lr=3e-4, warmup_steps=2, mu_dtype="bfloat16"), device="cuda")
    bundles = health.forensics_files(nan_dir)
    if nan_final.get("health_verdict") != "tripped" or \
            bundles != [f"{SPINE_PROC}_nonfinite_step2.trip.json"]:
        raise AssertionError(f"NaN seam: verdict {nan_final.get('health_verdict')}, "
                             f"trips {nan_final.get('health_trips')}, bundles {bundles}")
    with open(os.path.join(nan_dir, "health", bundles[0])) as f:
        bundle = json.load(f)
    for mod in (trace, hbm, health, series, slo, profile):
        mod.uninstall()

    # serving: phase 4's traffic through an armed engine
    serve_dir = os.path.join(work_dir, "serve")
    _spine_env(serve_dir, armed=True, every_step=False)
    engine = Engine(params8, cfg8, ServeConfig(slots=8, max_len=2048, kv_block=64,
                                               prefix=True), device="cuda")
    _, reqs, rng = serve_requests(cfg8)
    _, launches, figures = serve_run(engine, cfg8, reqs, rng)
    m = engine.metrics
    counts = {"ttft": engine._h_ttft.count, "tpot": engine._h_tpot.count,
              "decode_step": engine._h_step.count,
              "tokens": int(engine._c_tokens.value), "finished": int(engine._c_finished.value)}
    want = {"ttft": m.requests_started, "tpot": m.requests_finished,
            "decode_step": m.decode_steps, "tokens": m.generated_tokens,
            "finished": m.requests_finished}
    if counts != want:
        raise AssertionError(f"engine registry {counts} != DecodeMetrics {want}")
    summary = engine.close()
    del engine
    if summary.get("health_verdict") != "healthy" or \
            launches["paged_decode_attention"] != m.decode_steps * cfg8.n_layers:
        raise AssertionError(f"armed serving: verdict {summary.get('health_verdict')}, "
                             f"launches {launches}")
    trace.flush()
    serve_spans = sum(1 for line in open(os.path.join(serve_dir, "trace",
                                                      f"{SPINE_PROC}.jsonl"))
                      if '"serve.step"' in line)
    for mod in (trace, hbm, health, series, slo, profile):
        mod.uninstall()
    disarm_spine()
    torch.cuda.empty_cache()
    return {"off": off, "on": on, "train_s": train_s, "nan_final": nan_final,
            "bundle": bundle, "serve": {**figures, **counts, "launches": launches,
                                        "summary": summary, "step_spans": serve_spans},
            "peak_gib": peak_gib, "wall_s": time.perf_counter() - t0}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    disarm_spine()
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
    for label, B, S, H, Hkv, hd, causal, pair in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for c in flash_cases(dtype, flush, label, B, S, H, Hkv, hd, causal, pair):
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
    # phase 8's path: ep rank 0's local experts, bf16
    inputs = gmm_inputs(ep=EP)
    log(f"grouped matmul inputs at ep={EP}, rank 0: {inputs['routes']} routes in "
        f"{inputs['rows']} buffer rows; routes per local expert {inputs['sizes']} (group 0 "
        f"holds the routes to the other rank's experts at weight 0)")
    gmm_ep = gmm_cases(torch.bfloat16, flush, inputs)
    for c in gmm_ep:
        log(f"kernel {c['name']} {c['direction']} bf16 ep={EP} rank layout ({c['instance']}) "
            f"rows={c['rows']} {c['d_in']}->{c['d_out']} E={c['experts']}: max|err| "
            f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'})  {c['ms']:.3f} ms  "
            f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: {c['ops']:.4g} ops, "
            f"{c['bytes'] / 1e6:.1f} MB)  plain {c['plain_ms']:.3f} ms  torch._grouped_mm "
            + (f"{c['library_ms']:.3f} ms" if c["library_ms"] is not None else "-")
            + f"  [{card}]")
    bad = [(c["name"], c["direction"]) for c in gmm_ep
           if not c["ok"] or c["instance"] != "tensor cores"]
    if bad:
        raise AssertionError(f"grouped matmul at the ep rank's layout: over tolerance or "
                             f"off the tensor cores: {bad}")
    del inputs
    # phase 11's path: a tp rank's ffn block of every expert, bf16
    inputs = gmm_inputs(tp=MOE_TP)
    log(f"grouped matmul inputs at tp={MOE_TP}, rank block: {inputs['routes']} routes in "
        f"{inputs['rows']} buffer rows, F {MOE_F // MOE_TP} a rank (a 128-column tail past "
        f"the 256-column tiles)")
    gmm_tp = gmm_cases(torch.bfloat16, flush, inputs)
    for c in gmm_tp:
        log(f"kernel {c['name']} {c['direction']} bf16 tp={MOE_TP} rank block ({c['instance']}) "
            f"rows={c['rows']} {c['d_in']}->{c['d_out']} E={c['experts']}: max|err| "
            f"{c['max_abs_err']:.3e} ({'ok' if c['ok'] else 'OVER'})  {c['ms']:.3f} ms  "
            f"(bound {c['bound_ms']:.3f} ms by {c['bound_by']}: {c['ops']:.4g} ops, "
            f"{c['bytes'] / 1e6:.1f} MB)  plain {c['plain_ms']:.3f} ms  torch._grouped_mm "
            + (f"{c['library_ms']:.3f} ms" if c["library_ms"] is not None else "-")
            + f"  [{card}]")
    bad = [(c["name"], c["direction"]) for c in gmm_tp
           if not c["ok"] or c["instance"] != "tensor cores"]
    if bad:
        raise AssertionError(f"grouped matmul at the tp rank's block: over tolerance or "
                             f"off the tensor cores: {bad}")
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
    pe = s["prefix_path"]
    log(f"serve prefill paths (fault F6, held): request 7 alone (prefilled from position "
        f"0) gives the busy engine's 64 tokens (256 of its tokens from request 6's blocks "
        f"there); its first-token logits after request 6 ({pe['hit_tokens']}-token hit) "
        f"and alone bit-equal, max |difference| {pe['logit_max_abs_diff']}  [{card}]")
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
    qf = quant_serve_phase(cfg, params, s, quant_kv="fp8_e4m3", breakdown=False)
    fl = qf["launches"]
    log(f"serve quantized (fp8 e4m3 KV + int8 weights; phase 4 bf16 beside it): "
        f"{qf['requests']} requests, {qf['decode_steps']} decode steps "
        f"({s['decode_steps']}); launches paged_decode_attention_quant "
        f"{fl['paged_decode_attention_quant']}, quant_mm {fl['quant_mm']}; decode "
        f"{qf['decode_tokens_per_s']:.1f} tok/s ({s['decode_tokens_per_s']:.1f}), "
        f"mean TTFT {qf['mean_ttft_s'] * 1e3:.1f} ms ({s['mean_ttft_s'] * 1e3:.1f}), "
        f"mean decode step {qf['mean_decode_step_ms']:.2f} ms "
        f"({s['mean_decode_step_ms']:.2f}), {qf['kv_bytes_per_token']:.0f} KV "
        f"bytes/token ({s['kv_bytes_per_token']:.0f}), peak allocated "
        f"{qf['peak_allocated_gb']:.2f} GB ({s['peak_allocated_gb']:.2f}), prefix hit "
        f"{qf['prefix_hit_tokens']} tokens, int8 copy built in {qf['build_s']:.1f} s; "
        f"greedy tokens equal to phase 4's: {qf['greedy_equal_share']:.1%} "
        f"({qf['greedy_equal_requests']} of 8 requests whole); generate() equal to the "
        f"engine on request 0  [{card}]")
    torch.cuda.empty_cache()
    spec_serve_phase(cfg, params, card)
    torch.cuda.empty_cache()
    ch = chunked_serve_phase(cfg, params, s)
    log(f"serve chunked (chunk_tokens={CHUNK_TOKENS}; phase 4 beside it): {ch['requests']} "
        f"requests, {ch['chunks']} prompt chunks over {len(ch['long'])} prompts of more than "
        f"{CHUNK_TOKENS} tokens, {ch['decode_steps']} decode steps ({s['decode_steps']}), "
        f"{ch['launches']} kernel launches; mean TTFT of those prompts "
        f"{ch['ttft_long_s'] * 1e3:.1f} ms ({ch['ttft_long_phase4_s'] * 1e3:.1f}); decode "
        f"step {ch['decode_ms_chunking']:.2f} ms in the {ch['steps_chunking']} steps that "
        f"prefilled a chunk, {ch['decode_ms_other']:.2f} ms in the others (phase 4's mean "
        f"{s['mean_decode_step_ms']:.2f}); engine step wall {ch['wall_ms_chunking']:.1f} ms "
        f"with a chunk, {ch['wall_ms_other']:.1f} without; the largest step a decoding slot "
        f"waited {ch['max_step_ms']:.1f} ms ({s['max_step_ms']:.1f}), p50 "
        f"{ch['p50_step_ms']:.1f} ({s['p50_step_ms']:.1f}); decode {ch['decode_tokens_per_s']:.1f} "
        f"tok/s ({s['decode_tokens_per_s']:.1f}), wall {ch['wall_s']:.1f} s ({s['wall_s']:.1f}), "
        f"peak allocated {ch['peak_allocated_gb']:.2f} GB  [{card}]")
    log(f"serve chunked teacher-forced (float32 plain forward over each greedy request's "
        f"tokens): greedy requests equal to phase 4's {ch['equal']}/{ch['greedy']}; the "
        f"reference's argmax at {ch['top']}/{64 * ch['greedy']} positions; largest trail "
        f"chunked {ch['trail_on']:.4e}, phase 4 {ch['trail_off']:.4e}; bf16 noise "
        f"{ch['noise']:.4e}; limit {ch['limit']:.4e}  [{card}]")
    torch.cuda.empty_cache()
    ho = handoff_phase(cfg, params)
    for label, x in ho.items():
        quant = ", int8 KV + int8 weights" if label == "int8" else ""
        log(f"handoff {label} (Llama-3-8B, phase 4's ServeConfig{quant}): "
            f"{x['blocks']} blocks of the shared {HANDOFF_PREFIX}-token prefix, payload "
            f"{x['payload_bytes'] / 1e6:.2f} MB ({x['wire_bytes'] / 1e6:.2f} MB on the wire), "
            f"export {x['export_s'] * 1e3:.1f} ms, adopt {x['adopt_s'] * 1e3:.1f} ms; adopt "
            f"{x['first']} then {x['second']}; blocks and scale rows read back byte-equal; "
            f"request 7's {HANDOFF_NEW} greedy tokens on the adopter equal the exporter's, "
            f"prefix hits {x['hits']}, decode kernel launches {x['launches']}  [{card}]")
    cap = capacity_probe_phase(cfg, params, s)
    for quant in ("int8", "fp8_e4m3"):
        b = cap[quant]
        log(f"slot budget (Llama-3-8B, max_len 2048, kv_block 64, probe decode steps at 1 "
            f"and 2 slots on phase 4's weights, HBM {b['hbm_bytes'] / 1e9:.2f} GB): params "
            f"{b['param_bytes'] / 1e9:.3f} GB, fixed temp {b['fixed_temp_bytes'] / 1e6:.1f} MB, "
            f"per-slot temp {b['per_slot_temp_bytes'] / 1e6:.2f} MB, KV per slot "
            f"{b['kv_bytes_per_slot_native'] / 1e6:.1f} MB bf16 / "
            f"{b['kv_bytes_per_slot_quant'] / 1e6:.1f} MB {quant} (fixed temp "
            f"{b['fixed_temp_bytes_quant'] / 1e6:.1f} MB, per-slot temp "
            f"{b['per_slot_temp_bytes_quant'] / 1e6:.2f} MB); max slots bf16 "
            f"{b['max_slots_native']} (repeat-expanded KV {b['max_slots_repeat']}), {quant} "
            f"{b['max_slots_quant']} (x{b['quant_slot_ratio']}); with a 256-token shared "
            f"prefix bf16 {b['max_slots_prefix_shared']}, {quant} "
            f"{b['max_slots_quant_prefix_shared']}  [{card}]")
    log(f"slot budget's prediction for phase 4's 8 slots: {cap['predicted_8_gb']:.2f} GB "
        f"(params + fixed temp + 8 x (KV + temp) per slot) beside phase 4's measured peak "
        f"{cap['phase4_peak_gb']:.2f} GB (its pool grown by doubling, plus the prefix "
        f"store's budget); probes {cap['probe_s']:.1f} s  [{card}]")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_spine_")
    try:
        sp = spine_phase(card, cfg, params, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label in ("off", "on"):
        x = sp[label]
        tc_ = x["trace"]
        log(f"13 train bench_1b4 spine {'armed' if label == 'on' else 'disarmed'} (token "
            f"file through the {x['final']['loader']} loader, {SPINE_STEPS} steps): losses "
            + ", ".join(f"{m['loss']:.4f}" for m in x["steps"])
            + "; step ms " + ", ".join(f"{m['step_time_s'] * 1e3:.1f}" for m in x["steps"])
            + f"; profiled step 2: device {tc_['device_ms']:.1f} ms, step-thread "
            f"device-to-host copies {tc_['main_d2h']}, synchronizing calls "
            f"{tc_['main_syncs']}, other threads' device-to-host copies {tc_['other_d2h']}; "
            f"peak allocated {x['peak_bytes'] / 2**30:.3f} GiB; flash launches "
            f"{x['launches']['flash_fwd']}/{x['launches']['flash_dq']}/"
            f"{x['launches']['flash_dkv']}; pushes' hbm_mb "
            + ", ".join(f"{m['hbm_mb']:.0f}" for m in x["steps"])
            + f" (peak {x['steps'][-1]['hbm_peak_mb']:.0f}, limit "
            f"{x['steps'][-1]['hbm_limit_mb']:.0f})  [{card}]")
        a = x["anatomy"]["table"][0]
        log(f"13 anatomy of the {'armed' if label == 'on' else 'disarmed'} profile window "
            f"(step 2): step {a['step_time_s'] * 1e3:.1f} ms = compute "
            f"{a['compute_s'] * 1e3:.1f} + exposed collective "
            f"{a['exposed_collective_s'] * 1e3:.1f} + input wait {a['input_wait_s'] * 1e3:.1f} "
            f"+ host-blocked {a['host_blocked_s'] * 1e3:.1f} ms  [{card}]")
    on_, off_ = sp["on"], sp["off"]
    log(f"13 armed vs disarmed: step 4 wall {on_['steps'][3]['step_time_s'] * 1e3:.1f} vs "
        f"{off_['steps'][3]['step_time_s'] * 1e3:.1f} ms, profiled step 2 device "
        f"{on_['trace']['device_ms']:.1f} vs {off_['trace']['device_ms']:.1f} ms; journal "
        f"train.fit + train.step 2-4; verdict {on_['final']['health_verdict']}; memory "
        f"watch peak {on_['final']['peak_hbm_gb']:.3f} GiB = max_memory_allocated "
        f"{sp['peak_gib']:.4f} GiB; profile trace names tc::flash_fwd/dq/dkv_kernel  "
        f"[{card}]")
    nb = sp["bundle"]
    log(f"13 NaN seam (TONY_CHAOS_NAN_STEP=2, bench_1b4 at 4 layers): verdict "
        f"{sp['nan_final']['health_verdict']}, trips {sp['nan_final']['health_trips']}, "
        f"bundle {nb['rule']} at step {nb['step']} with {len(nb['ring'])} ring entries  "
        f"[{card}]")
    sv_ = sp["serve"]
    log(f"13 serve armed at the default strides (phase 4's traffic): {sv_['requests']} requests, "
        f"{sv_['decode_steps']} decode steps ({s['decode_steps']}), {sv_['step_spans']} "
        f"serve.step spans; registry TTFT {sv_['ttft']}, TPOT {sv_['tpot']}, step "
        f"{sv_['decode_step']} observations, tokens {sv_['tokens']} = DecodeMetrics'; mean "
        f"decode step {sv_['mean_decode_step_ms']:.2f} ms ({s['mean_decode_step_ms']:.2f}), "
        f"mean TTFT {sv_['mean_ttft_s'] * 1e3:.1f} ms ({s['mean_ttft_s'] * 1e3:.1f}), "
        f"decode {sv_['decode_tokens_per_s']:.1f} tok/s ({s['decode_tokens_per_s']:.1f}); "
        f"verdict {sv_['summary']['health_verdict']}; phase 13 wall {sp['wall_s']:.1f} s  "
        f"[{card}]")
    del params
    torch.cuda.empty_cache()
    g = gang_phase(card, s, qs)
    ab, dl = g["ab"], g["c"]["last"]["decode_0_attempt0"]
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
    rp = remat_policy_phase(card, t)
    for policy, x in rp.items():
        log(f"train bench_1b4 remat_policy={policy} (phase 5 save_attn_kernel beside it): "
            f"{REMAT_POLICY_STEPS} steps, loss " + ", ".join(f"{v:.4f}" for v in x["losses"])
            + f" (|step 1 - phase 5's| {x['loss_diff']:.2e}); step 2 "
            f"{x['step_ms']:.1f} ms (phase 5's mean {t['mean_step_ms']:.1f}); peak allocated "
            f"{x['peak_allocated_gb']:.2f} GB ({t['peak_allocated_gb']:.2f}); flash launches "
            f"{x['launches']['flash_fwd']}/{x['launches']['flash_dq']}/"
            f"{x['launches']['flash_dkv']}  [{card}]")

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

    ja = job_phase(card, tc)
    jl, jf = ja["job"]["latency"], ja["final"]
    log(f"15a job (python -m tony_tpu_torch.cli submit of {JOB_EXAMPLE}: client, AM, local "
        f"backend, executor, pytorch runtime, one worker, train.py --preset bench_1b4 "
        f"--ce-impl pallas --steps {TRAIN_STEPS}; the spine disarmed): exit "
        f"{ja['job']['rc']}, {ja['job']['status']['state']}, history "
        + " ".join(e["type"] for e in ja["job"]["events"] if e["type"] != "METRICS")
        + f"; losses " + ", ".join(f"{v:.4f}" for v in ja["losses"])
        + f", largest relative gap to phase 5b's {max(ja['gaps']):.3e} (limit "
        f"{JOB_REL_TOL}); launches "
        + ", ".join(f"{k} {ja['launches'][k]}" for k in (*FLASH_KERNELS, *CE_KERNELS))
        + f" (phase 5b's), plain 0; first push's keys {sorted(ja['pushes'][0])}; submit "
        f"latency {jl}; job wall {ja['job']['wall_s']:.1f} s; p50 step "
        f"{jf['step_time_p50_s'] * 1e3:.1f} ms (phase 5b's "
        f"{tc['final']['step_time_p50_s'] * 1e3:.1f} ms), "
        f"{jf['tokens_per_sec_per_chip']:.0f} tok/s (phase 5b's "
        f"{tc['final']['tokens_per_sec_per_chip']:.0f}), peak allocated "
        f"{jf['peak_allocated_gb']:.2f} GB  [{card}]")
    torch.cuda.empty_cache()
    jb = job_gloo_phase(card)
    jbl = jb["job"]["latency"]
    log(f"15b job (two workers, train.py --backend gloo: both ranks on this one card, fsdp "
        f"2, bench_1b4 at full width and {JOB_GLOO_LAYERS} layers, ce_impl=pallas, "
        f"{JOB_GLOO_STEPS} steps): exit {jb['job']['rc']}, "
        f"{jb['job']['status']['state']}; worker 0's losses "
        + ", ".join(f"{v:.4f}" for v in jb["losses"]) + ", one process's "
        + ", ".join(f"{v:.4f}" for v in jb["twin"])
        + f", max |difference| {max(jb['diffs']):.3e} (limit {JOB_GLOO_ATOL}); p50 step "
        + ", ".join(f"{f_['step_time_p50_s'] * 1e3:.1f}" for f_ in jb["finals"])
        + f" ms per rank over {jb['transport']} (two ranks share the card: not an NCCL "
        f"time); launches per rank "
        + "; ".join(", ".join(f"{k} {lc[k]}" for k in (*FLASH_KERNELS, *CE_KERNELS))
                    for lc in jb["launches"])
        + f", plain 0; submit latency {jbl}; job wall {jb['job']['wall_s']:.1f} s  "
        f"[{card}]")

    ca = operator_phase(card, ja, tc)

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
    cap_one = capacity_fit(None)            # phase 12's one-process run
    el_twin = elastic_twin()                # phase 14's one-process run

    shared = rank_phases()
    f = fsdp_phase(card, t, shared)
    r0 = f["ranks"][0]
    log(f"train bench_1b4 at fsdp={FSDP} through fit() (two rank processes on this one "
        f"card, overlap_impl=pallas, phase 5's recipe, data and initial parameters): "
        f"{FSDP_STEPS} steps, loss {f['losses'][0]:.4f} -> {f['losses'][-1]:.4f}, max "
        f"|loss - phase 5's| {max(f['loss_diffs']):.3e}; mean step {f['mean_step_ms']:.1f} "
        f"ms over steps {RANK_WARMUP_STEPS + 1}-{FSDP_STEPS} with the fsdp ring over "
        f"{f['transport']} (two ranks "
        f"share the card and the ring's hops go through host memory: not an NCCL time); "
        f"kernel 14 launches per rank {r0['launches']['chunk_mm']} = {f['per_step']} a "
        f"step ({r0['instance']}), plain 0; peak allocated per rank "
        + ", ".join(f"{r['peak_allocated_gb']:.2f}" for r in f["ranks"])
        + f" GB; phase wall {f['wall_s']:.1f} s  [{card}]")

    e = ep_phase(card, m, shared)
    for impl in EP_IMPLS:
        x = e[impl]
        split = f" in {e['n_chunks']} chunks" if impl != "off" else ""
        log(f"train bench_moe at ep={EP} through fit() (two rank processes on this one card, "
            f"4 experts and 4 x 2048 rows a rank, moe_overlap_impl={impl}{split}, "
            f"phase 6's recipe, data and initial parameters): {EP_STEPS} steps, loss "
            f"{x['losses'][0]:.4f} -> {x['losses'][-1]:.4f}, max |loss - phase 6's| "
            f"{max(x['loss_diffs']):.3e}, max |aux - phase 6's| {max(x['aux_diffs']):.3e}; "
            f"mean step {x['mean_step_ms']:.1f} ms over steps "
            f"{RANK_WARMUP_STEPS + 1}-{EP_STEPS} (each "
            + ", ".join(f"{t:.1f}" for t in x["step_ms"])
            + f" ms) with the ep collectives over {e['transport']} (two ranks share the "
            f"card and every collective goes through host memory: not an NCCL time); "
            f"payload bytes a rank a step: "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in x["bytes_per_step"].items() if v)
            + "; launches a rank " + ", ".join(f"{k} {x['launches'][k]}"
                                                for k in MOE_LAUNCHES_PER_LAYER_STEP)
            + ", plain 0; peak allocated per rank "
            + ", ".join(f"{g:.2f}" for g in x["peak_gb"]) + f" GB  [{card}]")
    log(f"ep={EP} |loss pallas - loss off| per step: "
        + ", ".join(f"{d:.3e}" for d in e["pallas_vs_off"])
        + f"; phase wall {e['wall_s']:.1f} s  [{card}]")
    ck = e["ckpt"]
    log(f"8b: sharded checkpoint at ep={EP}, bench_moe at full width and {CKPT_LAYERS} "
        f"layers: restored leaves bit-equal to the saved ones on both ranks; losses "
        + ", ".join(f"{v:.4f}" for v in ck["ranks"][0]["straight"])
        + " uninterrupted, max |difference| of steps 1-2 and of the resumed 3-4 "
        f"{max(ck['diffs']):.3e}; per rank: file "
        + ", ".join(f"{c['bytes'] / 1e9:.3f}" for c in ck["ranks"]) + " GB, save "
        + ", ".join(f"{c['save_s']:.2f}" for c in ck["ranks"]) + " s, restore "
        + ", ".join(f"{c['restore_s']:.2f}" for c in ck["ranks"]) + f" s  [{card}]")
    par = par_phase(card, t, shared)
    for label, axis, impl, head in PAR_RUNS:
        x = par[label]
        log(f"train bench_1b4 {label} at {axis}={PAR} through fit() (two rank processes on "
            f"this one card, attention_impl={impl}, ce_impl={head}, phase 5's weights and "
            f"8 x 2048 batches): {PAR_STEPS} steps, loss {x['losses'][0]:.4f} -> "
            f"{x['losses'][-1]:.4f}, max |loss - phase 5's| {max(x['loss_diffs']):.3e}; "
            f"step {PAR_STEPS}'s time {x['mean_step_ms']:.1f} ms (each "
            + ", ".join(f"{t:.1f}" for t in x["step_ms"])
            + f" ms) over {x['transport']} (two ranks share the card and every transfer "
            f"goes through host memory: not an NCCL time); payload bytes a rank a step: "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in x["bytes_per_step"].items() if v)
            + "; launches per rank "
            + "; ".join(", ".join(f"{k} {v}" for k, v in lc.items()
                                  if v and not k.endswith("_plain")) for lc in x["launches"])
            + ", plain 0; peak allocated per rank "
            + ", ".join(f"{g:.2f}" for g in x["peak_gb"]) + f" GB  [{card}]")
    log(f"phase 9 wall {par['wall_s']:.1f} s  [{card}]")
    pp = pp_phase(card, t, shared)
    for label, schedule, M, n in PP_RUNS:
        x = pp[label]
        log(f"train bench_1b4 at pp={PP} {schedule} through fit() (two rank processes on "
            f"this one card, 12 layers a stage, {M} microbatches of {8 // M} rows, flash, "
            f"remat, ce_impl=pallas, phase 5's weights and 8 x 2048 batches): {n} steps, "
            f"loss " + ", ".join(f"{v:.4f}" for v in x["losses"])
            + f", max |loss - phase 5's| {max(x['loss_diffs']):.3e}, max |grad norm - "
            f"phase 5's| / phase 5's {max(x['grad_norm_rel_diffs']):.3e}; step ms "
            + ", ".join(f"{v:.1f}" for v in x["step_ms"])
            + " (p50 of steps 2-3 per rank " + ", ".join(f"{v:.1f}" for v in x["p50_ms"])
            + f") over {x['transport']} (two ranks share the card and every transfer goes "
            f"through host memory: not an NCCL time); payload bytes a step per rank: "
            + "; ".join(", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in b.items() if v)
                        for b in x["bytes_per_step"])
            + "; launches per rank "
            + "; ".join(", ".join(f"{k} {v}" for k, v in lc.items()
                                  if v and not k.endswith("_plain")) for lc in x["launches"])
            + ", plain 0; peak allocated per rank "
            + ", ".join(f"{g:.2f}" for g in x["peak_gb"]) + f" GB  [{card}]")
    log("pp=2 peak allocated per rank (GB), M 4 beside M 8: " + "; ".join(
        f"{s_} rank {r}: {pp[s_]['peak_gb'][r]:.2f} -> {pp[s_ + ' M8']['peak_gb'][r]:.2f}"
        for s_ in ("gpipe", "1f1b") for r in range(PP)) + f"  [{card}]")
    log(f"phase 10 wall {pp['wall_s']:.1f} s  [{card}]")
    mt = moe_tp_phase(card, m, shared)
    log(f"train bench_moe at tp={MOE_TP} through fit() (two rank processes on this one card, "
        f"each rank every expert's {MOE_F // MOE_TP} of {MOE_F} ffn columns, 8 of 16 heads and "
        f"all 8 x 2048 rows, phase 6's recipe, data and initial parameters): {MOE_TP_STEPS} "
        f"steps, loss {mt['losses'][0]:.4f} -> {mt['losses'][-1]:.4f}, max |loss - phase 6's| "
        f"{max(mt['loss_diffs']):.3e}, max |aux - phase 6's| {max(mt['aux_diffs']):.3e}, max "
        f"|grad norm - phase 6's| / phase 6's {max(mt['grad_norm_rel_diffs']):.3e}; step ms "
        + ", ".join(f"{v:.1f}" for v in mt["step_ms"])
        + f" over {mt['transport']} (two ranks share the card and every transfer goes through "
        f"host memory: not an NCCL time); payload bytes a rank a step: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in mt["bytes_per_step"].items() if v)
        + "; launches per rank "
        + "; ".join(", ".join(f"{k} {lc[k]}" for k in MOE_LAUNCHES_PER_LAYER_STEP)
                    for lc in mt["launches"])
        + ", plain 0; peak allocated per rank "
        + ", ".join(f"{g:.2f}" for g in mt["peak_gb"])
        + f" GB; phase wall {mt['wall_s']:.1f} s  [{card}]")
    cp = capacity_phase(card, cap_one, shared)
    log(f"train bench_moe {CAPACITY_LAYERS} layers dispatch=gather at dp=2 through fit() (two "
        f"rank processes on this one card, 4 x 2048 rows a rank, capacity over the global "
        f"batch) against the same fit() in one process: {CAPACITY_STEPS} steps, max |loss or "
        f"aux difference| {max(cp['diffs']):.3e}; step ms "
        + ", ".join(f"{v:.1f}" for v in cp["step_ms"]) + " (one process "
        + ", ".join(f"{v:.1f}" for v in cp["one_step_ms"])
        + f") over {cp['transport']}; payload bytes a rank a step: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in cp["bytes_per_step"].items() if v)
        + "; launches per rank " + "; ".join(
            ", ".join(f"{k} {lc[k]}" for k in FLASH_KERNELS) for lc in cp["launches"])
        + ", grouped 0, plain 0; peak allocated per rank "
        + ", ".join(f"{g:.2f}" for g in cp["peak_gb"])
        + f" GB (one process {cp['one_peak_gb']:.2f}); phase wall {cp['wall_s']:.1f} s  "
        f"[{card}]")
    el = elastic_phase(card, el_twin, shared)
    b0 = el["bounds"][0]
    log(f"14 elastic fit() on bench_1b4 at full width and {ELASTIC_LAYERS} layers (2 members "
        f"of 1 rank, two rank processes on this one card, the group re-formed over gloo at "
        f"each boundary, plan {ELASTIC_PLAN}): {ELASTIC_STEPS} steps, max |loss - the "
        f"one-process run's| {max(el['diffs']):.3e}; summary "
        f"{el['ranks'][0]['final']['elastic']}; journal {el['skips']}; grown rank's "
        f"parameters bit-equal to rank 0's after the broadcast (sha1 "
        f"{el['ranks'][0]['digests'][0][:12]}); boundaries (rank 0, rank 1): "
        + "; ".join(f"gen {a['generation']} {a['boundary']} at step {a['at_step']} "
                    f"{a['reshard_s']:.3f} s / {b['reshard_s']:.3f} s, broadcast "
                    f"{a['broadcast_bytes'] / 1e9:.3f} GB / {b['broadcast_bytes'] / 1e9:.3f} GB"
                    for a, b in zip(b0, el["bounds"][1]))
        + "; step ms " + ", ".join(f"{v:.1f}" for v in el["step_ms"])
        + f" over {el['transport']}; the step's generation broadcast (3 int64 from rank 0) "
        + ", ".join(f"{v:.3f}" for v in el["agree_ms"]) + " ms per rank; launches per rank "
        + "; ".join(", ".join(f"{k} {lc[k]}" for k in FLASH_KERNELS) for lc in el["launches"])
        + ", plain 0; peak allocated per rank "
        + ", ".join(f"{g:.2f}" for g in el["peak_gb"])
        + f" GB; phase wall {el['wall_s']:.1f} s  [{card}]")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    main_case = cases[0]                            # G=1 bf16 at the serving shapes
    c7 = contig[0]                                  # the bench case, bf16
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "tony_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "tony_tpu/ops/decode_attention.py:214",
        "launches": loop["launches"], "phases": {"3f": loop["launches"]},
        "max_abs_err": c7["max_abs_err"],
        "ms": c7["ms"], "plain_ms": c7["plain_ms"], "bound_ms": c7["bound_ms"],
        "bound_by": c7["bound_by"], "library_ms": c7["library_ms"],
    }, {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "tony_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "tony_tpu/ops/decode_attention.py:346",
        "launches": s["launches"], "phases": {"4": s["launches"], "4d": ch["launches"],
                                              "4e bf16": ho["bf16"]["launches"],
                                              "13 serve": sv_["launches"][
                                                  "paged_decode_attention"],
                                              **{f"16ab {k}": v["launches"][
                                                  "paged_decode_attention"]
                                                 for k, v in ab["last"].items()}},
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
        "phases": {"4b": ql["paged_decode_attention_quant"],
                   "4b fp8": fl["paged_decode_attention_quant"],
                   "4e int8": ho["int8"]["launches"],
                   "16c decode": dl["launches"]["paged_decode_attention_quant"]},
        "max_abs_err": qmain["max_abs_err"], "ms": qmain["ms"],
        "plain_ms": qmain["plain_ms"], "bound_ms": qmain["bound_ms"],
        "bound_by": qmain["bound_by"], "library_ms": qmain["library_ms"],
    })
    # one decode step's 225 launches at their five shapes, bf16, summed
    kernels.append({
        "name": "quant_mm", "route": "cuda", "source": "tony_tpu_torch/csrc/quant_mm.cu",
        "replaces": "tony_tpu/ops/quant_mm.py:84", "launches": ql["quant_mm"],
        "phases": {"4b": ql["quant_mm"], "4b fp8": fl["quant_mm"],
                   "16c decode": dl["launches"]["quant_mm"]},
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
            "launches": t["launches"][name],
            # each path that runs it: its launches there (7 and 8 rank 0's,
            # 9a and 9b each rank's)
            "phases": {"5": t["launches"][name], "5b": tc["launches"][name],
                       **{f"5c {p}": rp[p]["launches"][name] for p in rp},
                       "13 disarmed": sp["off"]["launches"][name],
                       "13 armed": sp["on"]["launches"][name],
                       "6": m["launches"][name], "7": r0["launches"][name],
                       **{f"8 {impl}": e[impl]["launches"][name] for impl in EP_IMPLS},
                       **{f"{label} rank {r}": par[label]["launches"][r][name]
                          for label, *_ in PAR_RUNS for r in range(PAR)},
                       **{f"10 {label} rank {r}": pp[label]["launches"][r][name]
                          for label, *_ in PP_RUNS for r in range(PP)},
                       **{f"11 rank {r}": mt["launches"][r][name] for r in range(MOE_TP)},
                       **{f"12 rank {r}": cp["launches"][r][name] for r in range(2)},
                       **{f"14 rank {r}": el["launches"][r][name] for r in range(2)},
                       "15a": ja["launches"][name],
                       **{f"15b rank {r}": jb["launches"][r][name] for r in range(2)},
                       "17a resumed": ca["launches"][name]},
            "max_abs_err": c["max_abs_err"],
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
            "launches": m["launches"][name],
            "phases": {"6": m["launches"][name],
                       **{f"8 {impl}": e[impl]["launches"][name] for impl in EP_IMPLS},
                       **{f"11 rank {r}": mt["launches"][r][name] for r in range(MOE_TP)}},
            "max_abs_err": c["max_abs_err"],
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
            "launches": tc["launches"][name],
            "phases": {"5b": tc["launches"][name],
                       **{f"9a rank {r}": par["9a"]["launches"][r][name] for r in range(PAR)},
                       **{f"10 {label} rank {r}": pp[label]["launches"][r][name]
                          for label, *_ in PP_RUNS for r in range(PP)},
                       "15a": ja["launches"][name],
                       **{f"15b rank {r}": jb["launches"][r][name] for r in range(2)},
                       "17a resumed": ca["launches"][name]},
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    # kernel 14 at the largest forward chunk (w1/w3), bf16; launches: rank 0's
    # over phase 7's fit()
    c = next(c for c in chunks if c["label"] == "w1/w3" and c["dtype"] == "bfloat16")
    kernels.append({
        "name": "chunk_mm", "route": "cuda", "source": "tony_tpu_torch/csrc/overlap.cu",
        "replaces": "tony_tpu/ops/overlap.py:75", "launches": r0["launches"]["chunk_mm"],
        "phases": {"7": r0["launches"]["chunk_mm"]},
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
    if sys.argv[1:2] == ["--rank"]:           # one rank of phases 7-12 and 14, started by main()
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
