"""Slot-batched continuous decoding over a paged, prefix-shared KV cache.

The counterpart of ``tony_tpu/serve/engine.py`` in its default
configuration:

- **Slots, not batches.** A decode batch of ``slots`` rows; a request owns
  a slot only while it decodes, and a finished slot is refilled from the
  admission queue at the next step.
- **Paged block cache.** K/V live in the refcounted physical-block pool of
  ``serve/cache.py``; the engine plans each slot's block table on the host
  and the decode step attends through it with the paged decode-attention
  kernel (``ops/decode_attention.py``: CUDA on the card, the plain version
  on the CPU), once per layer per step.
- **Cross-request prefix reuse.** Admission matches each prompt against the
  radix store (``serve/prefix.py``): matched full blocks map shared into
  the slot's table, a mid-block match gets a private copy-on-write block,
  and prefill computes only the unshared tail, attending the prefix K/V
  gathered from the pool.
- **Per-slot state.** Position, sampling parameters and a
  ``torch.Generator`` per request, so a request samples the same alone or
  in a busy engine.
- **One host sync per decode step**: the sampled tokens come to the host
  once, to steer admission and finishing.
- **Quantized serving** (``quant_kv``, ``quant_weights``): block-scaled
  int8 or fp8 KV pools (``serve/cache.py``), written through a running
  per-block scale and read by the decode-attention kernel's quantized form;
  and an int8 copy of the decode weights, made once at build, that the
  decode step's seven layer matmuls and ``lm_head`` read through the
  dequant-matmul kernel (``ops/quant_mm.py``). Prefill keeps the bf16
  master weights; a prefix match dequantizes the gathered blocks.
- **Speculative decoding** (``spec``, ``serve/spec.py``): each live slot
  drafts up to ``spec_max_draft`` tokens on the host (the prefix store's
  longest extension, or the slot's own n-gram lookup), and one verify step
  feeds each row its last token and its drafts, G = ``spec_max_draft`` + 1
  positions, writes their K/V, attends with the paged kernel at G query
  rows and keeps the longest prefix the model agrees with, plus one token.
  Output is draw-for-draw the one-token engine's. Finished requests also
  register their generated blocks in the prefix store, the drafts' corpus.
- **Chunked prefill** (``chunk_tokens``): a prompt whose unshared tail is
  longer than a chunk has every block planned at admission and is
  prefilled one chunk per engine step, the first chunk on the admission
  step; each chunk attends the K/V that the slot's earlier chunks wrote,
  gathered from the pool through its table (dequantized on quantized
  pools). The slot holds its blocks but stays out of the decode batch
  until its last chunk samples the first token, so streams already
  decoding never wait behind a whole prompt. Only the last chunk samples:
  a request's generator draws what it would unchunked.
- **Blockwise KV handoff** (:meth:`Engine.export_prefix_blocks`,
  :meth:`Engine.adopt_blocks`): a prefill engine ships the store's blocks
  of a prefix (payload and scale rows, ``serve/cache.py``
  ``BlockPayload``, on the wire ``pack_payload``) and a decode engine
  adopts them into fresh blocks of its own pool and its prefix store, so
  a request there prefills only the tail.

What differs from the reference: PyTorch runs eagerly, so there are no jit
or AOT caches and no compile ledger; prefill runs at the prompt's exact
length (``prefill_buckets`` only bounds admissible prompt lengths, as in
the reference), and a mid-block prefix match is cut back to its full
blocks only where the prompt is chunked. The pools are updated in place.

Observability, as the reference's engine arms it (``obs/``): the
constructor arms the trace spine, the memory watch, the health sentinel,
the series recorder and the profile controller from the env, and keeps a
per-engine ``Registry`` with the reference's metric names (TTFT, TPOT and
decode-step histograms, queue depth, token/request/rejection/prefix/
draft/handoff counters). Requests carry ``serve.queued`` ->
``serve.prefill`` (``serve.prefill_chunk`` per chunk) -> ``serve.decode``
spans; the decode step is a sampled ``serve.step`` span. With a sentinel
armed, the decode and verify steps that it reads (``obs/health.py``
``due``) also return the per-slot logits nonfinite counts and sampling
entropy (``decode_monitors``), sampled with the slot -> request map after
the step's one sync, beside ``hbm.sample`` and ``series.sample``; a disarmed
engine computes none of it. ``stats_snapshot`` is the series source, and
``close()`` exports the verdicts and the registry snapshot. There is no
compile ledger.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models.generate import (
    KVCache, forward_with_cache, sample_tokens,
)
from tony_tpu_torch.models.llama import LlamaConfig, Params, rms_norm, rope_freqs
from tony_tpu_torch.obs import hbm, health, profile, series, slo, trace
from tony_tpu_torch.obs.metrics import DecodeMetrics
from tony_tpu_torch.obs.registry import HistogramWindow, Registry, snapshot_to_app_dir
from tony_tpu_torch.ops.decode_attention import check_kernel_shape, decode_attention
from tony_tpu_torch.ops.quant_mm import quant_matmul, quantize_weights
from tony_tpu_torch.serve.cache import (
    SCRATCH_BLOCK, BlockPayload, BlockPool, block_bytes, blocks_for, copy_block,
    create_cache, dequantize_values, export_blocks, gather_blocks, grow_cache,
    kv_quant_spec, payload_compatible, quant_scatter_span, scatter_block_kv, shrink_cache,
    write_block,
)
from tony_tpu_torch.serve.prefix import MatchResult, PrefixStore
from tony_tpu_torch.serve.spec import (
    DRAFT_SOURCES, SpecRows, advance_generators, propose_drafts, verify_and_accept,
)


@dataclass(frozen=True)
class ServeConfig:
    """Engine knobs: the reference's fields and defaults, less
    ``decode_impl`` (the port picks the decode attention by device: the
    CUDA kernel for CUDA tensors, the plain version for CPU ones)."""

    # concurrent decode slots (the decode batch width)
    slots: int = 8
    # longest prompt+generation admitted; 0 -> model.max_seq_len
    max_len: int = 0
    # KV cache block size (positions per physical block)
    kv_block: int = 64
    # prompt-length ladder; () -> powers of two from 16 up to max_len. The
    # largest bounds admissible prompts; prefill itself runs unpadded
    prefill_buckets: tuple[int, ...] = ()
    # static top-k slice width for sampling
    max_top_k: int = 64
    # release pool blocks / narrow the table when the live need halves
    shrink: bool = True
    # bounded admission: submit() raises AdmissionRejected past this many
    # queued requests (0 = unbounded)
    max_queue: int = 0
    # cross-request prefix reuse (serve/prefix.py)
    prefix: bool = True
    # device memory the store may pin for prefixes no live slot references
    prefix_budget_mb: float = 64.0
    # speculative decoding (serve/spec.py): each slot drafts up to
    # spec_max_draft tokens a step, and one verify step scores them all
    spec: bool = False
    # draft tokens per slot per step (k; the verify step feeds k + 1)
    spec_max_draft: int = 4
    # 'auto' (prefix store, then n-gram) | 'prefix' | 'ngram'
    spec_draft_source: str = "auto"
    # quantized KV pools: '' = pools in the model dtype, 'int8' | 'fp8_e4m3'
    # = block-scaled quantized pools (serve/cache.py)
    quant_kv: str = ""
    # int8 weight-only decode matmuls (ops/quant_mm.py): an int8 copy of the
    # decode weights made at build; prefill keeps the bf16 masters
    quant_weights: bool = False
    # chunked prefill: a tail longer than this many tokens prefills one chunk
    # per engine step (0 = whole prompts); a multiple of kv_block
    chunk_tokens: int = 0
    # pool label ('decode' | 'prefill') of a disaggregated deployment, whose
    # engines hand prefix blocks over (export_prefix_blocks / adopt_blocks)
    pool: str = "decode"


class AdmissionRejected(RuntimeError):
    """submit() refused: the admission queue is at ServeConfig.max_queue."""


@dataclass
class Request:
    """One generation request (a prompt row plus sampling parameters)."""

    prompt: Sequence[int] | np.ndarray | torch.Tensor
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int | None = None
    # int seed or a torch.Generator on the engine's device; None -> seeded
    # by the request id
    rng: Any = None


@dataclass
class Completion:
    """Result of one request: generated tokens (EOS included when hit)."""

    rid: int
    tokens: list[int] = field(default_factory=list)
    prompt_len: int = 0
    finish_reason: str = ""  # 'eos' | 'length'
    ttft_s: float = 0.0


@dataclass
class _ChunkedPrefill:
    """Host-side progress of one slot's chunked prefill: the slot owns its
    blocks (planned at admission) and ``pos`` advances one chunk per engine
    step until the last chunk samples the first token."""

    rid: int
    req: Request
    prompt: np.ndarray
    pos: int                              # tokens written: the match, then done chunks
    gen: torch.Generator | None           # drawn from by the last chunk only
    t0: float                             # admission (TTFT spans every chunk)


class _SlotState(NamedTuple):
    """Per-slot device state read by the decode step."""

    last_tok: torch.Tensor   # [S] int64, token to feed this step
    temp: torch.Tensor       # [S] float32
    top_k: torch.Tensor      # [S] int64
    top_p: torch.Tensor      # [S] float32
    eos: torch.Tensor        # [S] int64, -1 = none
    live: torch.Tensor       # [S] bool, slot owned by a request


def _default_buckets(max_len: int) -> tuple[int, ...]:
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Engine:
    """Continuous-batching decode engine over a paged KV cache::

        engine = Engine(params, cfg, ServeConfig(slots=8))   # on CUDA
        rid = engine.submit(Request(prompt=..., max_new_tokens=64))
        completions = engine.run()         # drain queue + live slots

    ``device=None`` runs on CUDA and raises without it; tests pass
    ``device="cpu"``.
    """

    def __init__(self, params: Params, cfg: LlamaConfig, serve: ServeConfig,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if cfg.is_moe:
            raise NotImplementedError(
                "serving MoE configs is not supported (prefill has no expert "
                "dispatch)"
            )
        if serve.chunk_tokens and serve.chunk_tokens % serve.kv_block:
            raise ValueError(
                f"chunk_tokens {serve.chunk_tokens} must be a multiple of "
                f"kv_block {serve.kv_block} (chunks start block-aligned so "
                "tail-prefill signatures stay bounded)"
            )
        if serve.spec_draft_source not in DRAFT_SOURCES:
            raise ValueError(f"spec_draft_source {serve.spec_draft_source!r} not in "
                             f"{DRAFT_SOURCES}")
        if serve.spec and serve.spec_max_draft < 1:
            raise ValueError("spec_max_draft must be >= 1 with spec on")
        # the quantized pools' largest stored magnitude; validates the knob
        self._qmax = kv_quant_spec(serve.quant_kv)[1] if serve.quant_kv else 0.0
        if self.device.type == "cuda":
            # the card's decode kernel refuses some block and head sizes, and
            # query counts (the verify step's G) whose rows overflow its
            # shared memory: refuse them here, before any request is admitted
            G = serve.spec_max_draft + 1 if serve.spec else 1
            check_kernel_shape(G, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               serve.kv_block,
                               1 if serve.quant_kv else cfg.dtype.itemsize,
                               cfg.dtype.itemsize)
        max_len = serve.max_len or cfg.max_seq_len
        buckets = tuple(sorted(serve.prefill_buckets)) or _default_buckets(max_len)
        cap = blocks_for(max_len, serve.kv_block) * serve.kv_block
        if buckets[-1] > cap:
            raise ValueError(
                f"prefill bucket {buckets[-1]} exceeds the cache capacity "
                f"ceiling {cap} (max_len {max_len} rounded up to kv_block)"
            )
        self.serve = dataclasses.replace(serve, max_len=max_len,
                                         prefill_buckets=buckets)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        # the decode step's weights: the bf16 masters, or their int8 copy
        # (made once here; prefill keeps the masters); per-layer views of
        # the stacked weights, made once
        self._decode_params = (_quantize_decode_params(self.params)
                               if self.serve.quant_weights else self.params)
        layers = self._decode_params["layers"]
        self._layers = [{k: t[l] for k, t in layers.items()}
                        for l in range(cfg.n_layers)]
        self._freqs = rope_freqs(cfg, self.device)
        S, B = self.serve.slots, self.serve.kv_block
        self.metrics = DecodeMetrics(n_chips=1)
        self._m_total = blocks_for(max_len, B)
        self._blk_bytes = block_bytes(cfg, B, quant_kv=self.serve.quant_kv)
        self.metrics.kv_bytes_per_token = self._blk_bytes / B
        budget_bytes = int(self.serve.prefix_budget_mb * 2**20)
        budget_blocks = (max(1, -(-budget_bytes // self._blk_bytes))
                         if budget_bytes else S * self._m_total)
        # every slot at max_len plus the store's budget (plus scratch):
        # growth stops here, eviction takes over
        self._pool_cap = 1 + S * self._m_total + (
            budget_blocks if self.serve.prefix else 0
        )
        self._p0 = max(2, min(1 + S, self._pool_cap))
        self._pool = BlockPool(self._p0)
        self.cache = create_cache(cfg, S, self._p0, B, device=self.device,
                                  quant_kv=self.serve.quant_kv)
        # quantized pools: blocks whose scale rows must be zeroed before the
        # next device write (a reused block must not keep its previous
        # tenant's scale)
        self._fresh_scale: list[int] = []
        self._store: PrefixStore | None = None
        if self.serve.prefix:
            self._store = PrefixStore(block=B, block_bytes=self._blk_bytes,
                                      budget_bytes=budget_bytes)
        self._table = np.zeros((S, self._m_total), np.int32)
        self._slot_blocks = [0] * S
        self._attended = 1
        self._table_dev = self._upload_table(1)
        self._table_dirty = False
        self._cow_copies = 0
        # slots mid-chunked-prefill, and the chunks prefilled so far
        self._chunking: dict[int, _ChunkedPrefill] = {}
        self.prefill_chunks = 0
        dev = self.device
        self.state = _SlotState(
            last_tok=torch.zeros(S, dtype=torch.int64, device=dev),
            temp=torch.zeros(S, dtype=torch.float32, device=dev),
            top_k=torch.zeros(S, dtype=torch.int64, device=dev),
            top_p=torch.zeros(S, dtype=torch.float32, device=dev),
            eos=torch.full((S,), -1, dtype=torch.int64, device=dev),
            live=torch.zeros(S, dtype=torch.bool, device=dev),
        )
        self._queue: deque[tuple[int, Request]] = deque()
        self._completions: dict[int, Completion] = {}
        self._slot_rid: list[int | None] = [None] * S
        self._slot_remaining = [0] * S
        self._slot_len = [0] * S            # host mirror of cache.lengths
        self._slot_eos = [-1] * S
        self._slot_gen: list[torch.Generator | None] = [None] * S
        # with spec on, each slot's context (prompt + every emitted token,
        # the next input token last): what the draft sources extend
        self._slot_ctx: list[list[int]] = [[] for _ in range(S)]
        self._submit_t: dict[int, float] = {}
        self._next_rid = 0
        # the observability spine, armed from the env (each idempotent): a
        # sentinel armed here puts the decode monitors in the steps it reads
        trace.install_from_env()
        hbm.install_from_env()
        health.install_from_env()
        self._monitors = health.active_sentinel() is not None
        series.install_from_env()
        profile.install_from_env()
        self._series = series.active_recorder()
        self._snap_window = HistogramWindow()   # since-last-scrape quantiles
        self._snap_prev: dict[str, float] = {}  # counter deltas (error rate)
        self._series_key = f"engine@{id(self):x}"
        # engine-scoped watermark: close() reports this engine's peak, not
        # the process's cumulative one
        watch = hbm.active_watch()
        self._hbm_mark = watch.mark() if watch is not None else None
        self._init_registry()
        self._queued_spans: dict[int, Any] = {}
        self._decode_spans: dict[int, Any] = {}
        self._first_tok_t: dict[int, float] = {}
        if self._series is not None:
            self._series.attach(self._series_key,
                                _weak_stats_source(self, self._series, self._series_key))

    # --- public API -----------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Queue a request; returns its id (the key into run()'s result)."""
        shape = tuple(req.prompt.shape) if isinstance(req.prompt, torch.Tensor) \
            else np.shape(req.prompt)
        plen = int(shape[-1]) if shape else 0
        if plen < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens} "
                "(prefill always samples the first token)"
            )
        if plen >= self.serve.max_len:
            raise ValueError(
                f"prompt length {plen} must be shorter than max_len "
                f"{self.serve.max_len} (at least one generated token must fit)"
            )
        if plen > max(self.serve.prefill_buckets):
            raise ValueError(
                f"prompt length {plen} exceeds the largest prefill bucket "
                f"{max(self.serve.prefill_buckets)}"
            )
        if plen + req.max_new_tokens > self.serve.max_len:
            raise ValueError(
                f"prompt {plen} + max_new_tokens {req.max_new_tokens} "
                f"exceeds max_len {self.serve.max_len}"
            )
        if self.serve.max_queue and len(self._queue) >= self.serve.max_queue:
            self._c_rejected.inc()
            raise AdmissionRejected(
                f"admission queue full ({len(self._queue)} >= max_queue "
                f"{self.serve.max_queue})"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, req))
        self._submit_t[rid] = time.perf_counter()
        self._g_queue.set(len(self._queue))
        tracer = trace.active_tracer()
        if tracer is not None:
            # queue-wait span: starts now, ends when the request is slotted
            self._queued_spans[rid] = tracer.span("serve.queued", rid=rid, prompt_len=plen)
        return rid

    @property
    def n_live(self) -> int:
        return sum(1 for r in self._slot_rid if r is not None)

    @property
    def n_decoding(self) -> int:
        """Live slots in the decode batch (a slot mid-chunked-prefill holds
        its blocks but does not decode yet)."""
        return sum(1 for s, r in enumerate(self._slot_rid)
                   if r is not None and s not in self._chunking)

    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet slotted."""
        return len(self._queue)

    @property
    def rejected_total(self) -> int:
        """Submissions refused by bounded admission since the last
        reset_metrics()."""
        return int(self._c_rejected.value)

    @property
    def attended_positions(self) -> int:
        """Positions the decode step's table covers per slot."""
        return self._attended * self.serve.kv_block

    def step(self) -> int:
        """Admit what fits, advance each chunking slot by one chunk, run one
        decode step; returns the live-slot count (chunking slots too)."""
        # coordinated-profiling seam: a requested window brackets decode
        # steps as it does train steps
        profile.maybe_capture()
        # slots already chunking advance one chunk each; those _admit parks
        # into chunking ran their first chunk inside admission
        pending = sorted(self._chunking)
        self._admit()
        for slot in pending:
            if slot in self._chunking:
                self._prefill_chunk(slot)
        if self.n_decoding:
            self._decode_once()
        return self.n_live

    def completion_of(self, rid: int) -> Completion | None:
        """Live view of a request's completion: ``tokens`` grows in place
        as the engine decodes and ``finish_reason`` lands when it ends.
        The gang worker's streaming seam (serve/gang.py); callers must not
        mutate the returned object."""
        return self._completions.get(rid)

    def take_completion(self, rid: int) -> Completion | None:
        """Pop one finished completion (the incremental form of what run()
        does wholesale, so a long-lived streaming driver never accumulates
        every Completion)."""
        return self._completions.pop(rid, None)

    def run(self, requests: Sequence[Request] | None = None) -> dict[int, Completion]:
        """Submit ``requests`` (if given), drain queue and live slots, and
        return (and evict) every completion finished by this call."""
        # an out-of-memory error escaping the loop dumps its forensics into
        # the app dir before it reaches the caller
        with hbm.oom_guard("engine.run"):
            for r in requests or ():
                self.submit(r)
            while self._queue or self.n_live:
                self.step()
        done, self._completions = self._completions, {}
        return done

    def _init_registry(self) -> None:
        reg = self.registry = Registry()
        self._h_ttft = reg.histogram("tony_ttft_seconds",
                                     "request submit -> first sampled token")
        self._h_tpot = reg.histogram("tony_tpot_seconds",
                                     "mean per-token latency after the first")
        self._h_step = reg.histogram("tony_decode_step_seconds",
                                     "one engine decode step (all live slots)")
        self._g_queue = reg.gauge("tony_queue_depth",
                                  "requests admitted but not yet slotted")
        self._c_tokens = reg.counter("tony_generated_tokens_total",
                                     "tokens sampled (prefill + decode)")
        self._c_finished = reg.counter("tony_requests_finished_total",
                                       "requests completed (eos or budget)")
        self._c_rejected = reg.counter(
            "tony_serve_rejected_total",
            "submissions rejected by bounded admission (queue at max_queue)")
        self._c_prefix_hit = reg.counter(
            "tony_serve_prefix_hit_tokens_total",
            "prompt tokens served from the prefix store (no re-prefill)")
        self._c_prompt_tokens = reg.counter(
            "tony_serve_prompt_tokens_total",
            "prompt tokens admitted (the prefix hit-rate denominator)")
        self._g_prefix_bytes = reg.gauge(
            "tony_serve_prefix_resident_bytes",
            "HBM pinned by prefix-store block references")
        self._g_prefix_nodes = reg.gauge(
            "tony_serve_prefix_nodes", "radix nodes resident in the store")
        self._c_draft_prop = reg.counter(
            "tony_serve_draft_proposed_total",
            "speculative draft tokens proposed (serve/spec.py)")
        self._c_draft_acc = reg.counter(
            "tony_serve_draft_accepted_total",
            "speculative draft tokens accepted (target sample agreed)")
        self._g_kv_bpt = reg.gauge(
            "tony_serve_kv_bytes_per_token",
            "HBM per cached token (quantized pools store int8/fp8 + scales)")
        self._g_kv_bpt.set(self._blk_bytes / self.serve.kv_block)
        self._g_quant_resident = reg.gauge(
            "tony_serve_quant_pool_resident_bytes",
            "HBM resident in the quantized KV pool (payload + scale rows)")
        self._c_handoff_shipped = reg.counter(
            "tony_serve_handoff_shipped_blocks_total",
            "physical blocks exported for a blockwise KV handoff")
        self._c_handoff_adopted = reg.counter(
            "tony_serve_handoff_adopted_blocks_total",
            "shipped blocks adopted into this pool (prefix-store owned)")
        self._c_handoff_freed = reg.counter(
            "tony_serve_handoff_freed_blocks_total",
            "shipped blocks freed on arrival (prefix already resident)")

    def reset_metrics(self) -> None:
        """Fresh throughput/latency counters (e.g. after a warm-up); the
        registry's histograms and counters reset too, so close()'s
        quantiles and the job-history snapshot leave the warm-up out."""
        self.metrics = DecodeMetrics(
            n_chips=1, kv_bytes_per_token=self.metrics.kv_bytes_per_token
        )
        self._init_registry()
        self._snap_prev.clear()
        self._g_queue.set(len(self._queue))

    def stats_snapshot(self, windowed: bool = False) -> dict[str, float]:
        """Host-side stats only (no device sync): queue depth, slot
        occupancy, token/request counters and TTFT/TPOT/step-time
        quantiles. ``windowed=True`` reports the quantiles since the
        previous windowed call (the series recorder's live view) and the
        window's error rate; the default reports them over the run."""
        snap: dict[str, float] = {
            "queue_depth": float(len(self._queue)),
            "live_slots": float(self.n_live),
            "slots": float(self.serve.slots),
            "occupancy": round(self.n_live / max(self.serve.slots, 1), 4),
            "generated_tokens": float(self._c_tokens.value),
            "requests_finished": float(self._c_finished.value),
            "rejected_total": float(self._c_rejected.value),
            # decode tokens emitted per decode step: 1.0 autoregressive,
            # > 1 when speculative drafts land
            "tokens_per_step": round(self.metrics.tokens_per_step, 4),
            "kv_bytes_per_token": round(self.metrics.kv_bytes_per_token, 2),
            # pool label (disaggregated deployments): a string
            "pool": self.serve.pool,
        }
        if self._chunking:
            # slots mid-chunked-prefill: occupied but not decoding yet
            snap["chunking_slots"] = float(len(self._chunking))
        shipped = float(self._c_handoff_shipped.value)
        adopted = float(self._c_handoff_adopted.value)
        freed = float(self._c_handoff_freed.value)
        if shipped or adopted or freed:
            snap["handoff_shipped_blocks"] = shipped
            snap["handoff_adopted_blocks"] = adopted
            snap["handoff_freed_blocks"] = freed
        if self.serve.quant_kv:
            resident = float(self._pool.n_blocks * self._blk_bytes)
            snap["quant_pool_resident_bytes"] = resident
            self._g_quant_resident.set(resident)
        if self.serve.spec:
            snap["draft_accept_rate"] = round(self.metrics.draft_accept_rate, 4)
            snap["spec_rollbacks"] = float(self.metrics.spec_rollbacks)
        if self._store is not None:
            snap.update(self._store.stats())
            snap["pool_blocks"] = float(self._pool.n_blocks)
        for hist, prefix in ((self._h_ttft, "ttft"), (self._h_tpot, "tpot"),
                             (self._h_step, "decode_step")):
            if windowed:
                d = self._snap_window.delta(hist)
                if d["count"]:
                    snap[f"{prefix}_p50_s"] = round(d["p50"], 4)
                    snap[f"{prefix}_p99_s"] = round(d["p99"], 4)
                    snap[f"{prefix}_n"] = d["count"]
            elif hist.count:
                snap[f"{prefix}_p50_s"] = round(hist.quantile(0.5), 4)
                snap[f"{prefix}_p99_s"] = round(hist.quantile(0.99), 4)
                snap[f"{prefix}_n"] = float(hist.count)
        if windowed:
            # the window's serve error rate: rejections over requests
            # resolved in the window (the slo.error_rate input)
            rej = snap["rejected_total"] - self._snap_prev.get("rejected", 0.0)
            fin = snap["requests_finished"] - self._snap_prev.get("finished", 0.0)
            self._snap_prev["rejected"] = snap["rejected_total"]
            self._snap_prev["finished"] = snap["requests_finished"]
            if rej + fin > 0:
                snap["error_rate"] = round(rej / (rej + fin), 4)
        return snap

    def close(self) -> dict:
        """Shutdown summary: the DecodeMetrics summary, TTFT/TPOT quantiles
        from the registry, prefix stats, the health and SLO verdicts and
        the engine-scoped memory peak; the registry is snapshotted into the
        job history. Requests still queued or decoding get their spans
        ended with reason=shutdown."""
        for spans in (self._queued_spans, self._decode_spans):
            for sp in spans.values():
                sp.end(reason="shutdown")
            spans.clear()
        self._first_tok_t.clear()
        # a profile window still open at shutdown finalises here
        profile.finish_capture()
        s = self.metrics.summary()
        if self._h_ttft.count:
            s["ttft_p50_s"] = round(self._h_ttft.quantile(0.5), 4)
            s["ttft_p99_s"] = round(self._h_ttft.quantile(0.99), 4)
        if self._h_tpot.count:
            s["tpot_p50_s"] = round(self._h_tpot.quantile(0.5), 4)
        if self._store is not None:
            s["prefix"] = dict(self._store.stats())
            s["prefix"]["cow_copies"] = self._cow_copies
        sentinel = health.active_sentinel()
        if sentinel is not None:
            # drain so a trip on the final decode steps reaches the summary
            sentinel.drain()
            s["health_verdict"] = sentinel.verdict
            trips = sentinel.trip_counts()
            if trips:
                s["health_trips"] = trips
            sentinel.export(self.registry)
            sentinel.write_verdict()
        if self._series is not None:
            self._series.force_sample()
            self._series.drain()
            self._series.detach(self._series_key)
        slo_engine = slo.active_engine()
        if slo_engine is not None:
            s["slo_verdict"] = slo_engine.verdict
            trips = slo_engine.trip_counts()
            if trips:
                s["slo_trips"] = trips
            slo_engine.export(self.registry)
            slo_engine.write_verdict()
        watch = hbm.active_watch()
        if watch is not None and self._hbm_mark is not None:
            peak_gb, peak_exact = watch.peak_since(self._hbm_mark)
            if peak_gb:
                s["peak_hbm_gb"] = peak_gb
                s["peak_hbm_exact"] = peak_exact
            watch.export_gauges(self.registry)
        # suffixed so a train-then-serve process keeps both snapshots
        snapshot_to_app_dir(trace.default_proc_name("serve") + "_engine", self.registry)
        return s

    # --- blockwise KV handoff between engines ---------------------------------

    def export_prefix_blocks(self, tokens: Sequence[int]
                             ) -> tuple[list[int], BlockPayload] | None:
        """The exporting side of the handoff: the store-resident full blocks
        covering ``tokens``, copied to the host as ``(covered_tokens,
        BlockPayload)``, quantized payload and scale rows together. Each
        block is pinned (one more pool reference) while it is gathered, so
        eviction cannot hand it away mid-export. None when nothing is
        resident."""
        if self._store is None:
            return None
        B = self.serve.kv_block
        toks = [int(t) for t in tokens]
        n_full = len(toks) // B
        if not n_full:
            return None
        m = self._store.match(toks, n_full * B)
        if not m.full:
            return None
        for pid in m.full:
            self._pool.retain(pid)
        try:
            payload = export_blocks(self.cache, list(m.full))
        finally:
            for pid in m.full:
                self._pool.release(pid)
        self._c_handoff_shipped.inc(len(m.full))
        return toks[:len(m.full) * B], payload

    def adopt_blocks(self, tokens: Sequence[int], payload: BlockPayload) -> tuple[int, int]:
        """The adopting side: shipped blocks enter this pool through the
        normal refcount rules. Every adopted block is freshly allocated (an
        allocation hands out only refcount-zero ids, so a handoff racing a
        slot's release never writes a block in use), written payload and
        scale rows together, and inserted into the prefix store, which
        takes the owning reference; a block whose prefix is already
        resident is freed instead. Returns ``(adopted, freed)``, which sum
        to the payload's blocks; raises ValueError on a payload this pool
        cannot adopt."""
        B = self.serve.kv_block
        nb = payload.n_blocks
        if len(tokens) != nb * B:
            raise ValueError(f"payload covers {nb} block(s) of {B} but {len(tokens)} "
                             "tokens were named")
        why = payload_compatible(self.cache, payload)
        if why:
            raise ValueError(f"incompatible handoff payload: {why}")
        if self._store is None:
            self._c_handoff_freed.inc(nb)
            return 0, nb              # no store to own them: nothing adopts
        toks = [int(t) for t in tokens]
        have = len(self._store.match(toks, nb * B).full)
        new_pids: list[int] = []
        for bi in range(have, nb):
            pid = self._alloc_block()
            if self.cache.quantized:
                # the adopt write lands the shipped scale rows as they are:
                # a queued allocation-time zeroing would erase them
                self._fresh_scale.remove(pid)
            write_block(self.cache, pid, payload, bi)
            new_pids.append(pid)
        phys = list(self._store.match(toks, nb * B).full)[:have] + new_pids
        created = self._store.insert(toks, phys, self._pool.retain)
        for pid in new_pids:
            self._pool.release(pid)
        if self._store.evict_to_budget(self._pool.release):
            self._maybe_shrink_pool()
        self._c_handoff_adopted.inc(created)
        self._c_handoff_freed.inc(nb - created)
        self._g_prefix_bytes.set(self._store.resident_bytes)
        self._g_prefix_nodes.set(self._store.n_nodes)
        return created, nb - created

    # --- admission ------------------------------------------------------------

    def _admit(self) -> None:
        free = [s for s, r in enumerate(self._slot_rid) if r is None]
        while free and self._queue:
            self._admit_one(free.pop(0), *self._queue.popleft())

    def _generator(self, req: Request, rid: int) -> torch.Generator:
        rng = rid if req.rng is None else req.rng
        if isinstance(rng, torch.Generator):
            if rng.device.type != self.device.type:
                raise ValueError(
                    f"request generator is on {rng.device}, engine on {self.device}"
                )
            return rng
        return torch.Generator(device=self.device).manual_seed(int(rng))

    def _admit_one(self, slot: int, rid: int, req: Request) -> None:
        t0 = time.perf_counter()
        qspan = self._queued_spans.pop(rid, None)
        if qspan is not None:
            qspan.end(slot=slot)
        self._g_queue.set(len(self._queue))
        prompt = req.prompt.cpu() if isinstance(req.prompt, torch.Tensor) else req.prompt
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = len(prompt)
        # prefix match, used only when it covers at least one full block
        match: MatchResult | None = None
        matched = 0
        if self._store is not None and plen > 1:
            m = self._store.match(prompt.tolist(), plen - 1)
            if m.full:
                match, matched = m, m.length
        ct = self.serve.chunk_tokens
        chunked = bool(ct) and plen - matched > ct
        if match is not None and match.partial is not None and (
                chunked or not self.cache.quantized):
            # a mid-block copy-on-write match is cut back to its full
            # blocks, so the tail's prefill pieces start block-aligned
            # (_prefill: in a pool of the model dtype a hit is then
            # bit-equal to a miss; every chunk starts block-aligned too).
            # Quantized pools keep it unchunked, as the reference does: a
            # hit attends a dequantized prefix, which no cut makes equal
            match = MatchResult(len(match.full) * self.serve.kv_block, match.full, None)
            matched = match.length
        if self._store is not None and plen > 1:
            self._store.record_prompt(plen, matched)
            self._c_prompt_tokens.inc(plen)
            if matched:
                self._c_prefix_hit.inc(matched)
        self.metrics.record_prompt(plen, matched)
        gen = self._generator(req, rid) if req.temperature > 0 else None
        bucket = next(b for b in self.serve.prefill_buckets if b >= plen)
        if chunked:
            # the slot holds its blocks and stays out of the decode batch
            # (state.live False: a decode step steers its row's write to the
            # scratch block) until its last chunk samples the first token
            with trace.span("serve.prefill", rid=rid, bucket=bucket, slot=slot,
                            matched=matched, chunked=1):
                self._plan_blocks(slot, plen, match)
            self._slot_rid[slot] = rid
            self._chunking[slot] = _ChunkedPrefill(rid, req, prompt, matched, gen, t0)
            self._prefill_chunk(slot)          # the first chunk rides admission
            return
        with trace.span("serve.prefill", rid=rid, bucket=bucket, slot=slot,
                        matched=matched):
            self._plan_blocks(slot, plen, match)
            tok = self._prefill(slot, prompt, matched, req, gen)
        self._activate_slot(slot, rid, req, prompt, tok, gen, t0)

    def _prefill_chunk(self, slot: int) -> None:
        """Advance a chunking slot by one chunk (at most ``chunk_tokens``
        tokens through the restartable prefill); the last chunk samples the
        first token and activates the slot."""
        job = self._chunking[slot]
        plen = len(job.prompt)
        end = min(job.pos + self.serve.chunk_tokens, plen)
        with trace.span("serve.prefill_chunk", rid=job.rid, slot=slot, start=job.pos,
                        end=end, final=int(end == plen)):
            tok = self._prefill(slot, job.prompt, job.pos, job.req, job.gen, end=end)
        self.prefill_chunks += 1
        if end < plen:
            job.pos = end
            return
        del self._chunking[slot]
        self._activate_slot(slot, job.rid, job.req, job.prompt, tok, job.gen, job.t0)

    def _prefill(self, slot: int, prompt: np.ndarray, matched: int,
                 req: Request, gen: torch.Generator | None, end: int | None = None
                 ) -> int | None:
        """Prefill ``prompt[matched:end]`` (``end`` the prompt's length by
        default) and, where it ends the prompt, sample the first token.

        The tail runs through ``forward_with_cache`` in pieces that end on
        ``kv_block`` boundaries (the last may end short of one), each
        attending a contiguous context of exactly ``blocks_for(piece_end) *
        kv_block`` positions. The ``matched`` positions (a prefix match, the
        COW copy included, or the earlier chunks of a chunked prefill) have
        their K/V gathered from the pool through the slot's own table into
        the context's head (quantized pools dequantize it to the model dtype
        through the blocks' scale rows). In a pool of the model dtype
        ``matched`` is a multiple of ``kv_block`` (admission cuts a mid-block
        match), so every position's K/V and the first token's logits come
        from the same sequence of (start, rows, context length) calls
        whatever the match, and a hit is bit-equal to a miss. Each piece's
        K/V stays in the context for the next; the new K/V is scattered into
        the slot's blocks at the end. A chunk that does not end the prompt
        samples nothing, so the request's generator draws only what an
        unchunked prefill draws; it returns None."""
        cfg, dev, B = self.cfg, self.device, self.serve.kv_block
        plen = len(prompt) if end is None else end
        n = blocks_for(plen, B) * B
        ctx = KVCache.create(cfg, 1, n, device=dev)
        if matched:
            ids = torch.as_tensor(self._table[slot, :blocks_for(matched, B)],
                                  dtype=torch.int64, device=dev)

            def gather(pool: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
                g = gather_blocks(pool, ids, dim=1)    # [L, n, Hkv, blk, hd]
                if scale is not None:
                    sc = scale.index_select(1, ids)    # [L, n, Hkv]
                    g = dequantize_values(g, sc[..., None, None], cfg.dtype)
                L, nb, Hkv, blk, hd = g.shape
                g = g.permute(0, 1, 3, 2, 4).reshape(L, 1, nb * blk, Hkv, hd)
                return g[:, :, :matched]

            c = self.cache
            ctx.k[:, :, :matched] = gather(c.k, c.k_scale)
            ctx.v[:, :, :matched] = gather(c.v, c.v_scale)
        tail = torch.as_tensor(prompt[matched:plen], dtype=torch.int64, device=dev)[None]
        bounds = [matched, *range((matched // B + 1) * B, plen, B), plen]
        for s, e in zip(bounds, bounds[1:]):
            m = blocks_for(e, B) * B
            piece = KVCache(ctx.k[:, :, :m].contiguous(), ctx.v[:, :, :m].contiguous())
            logits, _ = forward_with_cache(self.params, tail[:, s - matched:e - matched],
                                           piece, s, cfg, last_only=True)
            ctx.k[:, :, s:e] = piece.k[:, :, s:e]
            ctx.v[:, :, s:e] = piece.v[:, :, s:e]
        self._scatter_prompt(slot, ctx.k[:, 0, matched:plen], ctx.v[:, 0, matched:plen],
                             matched, plen)
        if plen < len(prompt):
            return None
        tok = sample_tokens(
            logits[:, 0],
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int64, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            [gen], max_k=self.serve.max_top_k,
        )
        # explicit sync: the first token steers admission on the host
        return int(tok[0])

    def _scatter_prompt(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                        start: int, plen: int) -> None:
        """Write prefilled K/V (``[L, W, Hkv, hd]``, positions ``start + i``
        up to ``plen``) into the slot's blocks, in place. Quantized pools
        quantize the span layer by layer, each touched block's running
        scale updated once. The slot's length is set when it activates: a
        chunking slot's stays 0, so the decode step reads none of its
        table."""
        B = self.serve.kv_block
        p = np.arange(start, plen)
        pids_np = self._table[slot, p // B]
        pids = torch.as_tensor(pids_np, dtype=torch.int64, device=self.device)
        offs = torch.as_tensor(p % B, dtype=torch.int64, device=self.device)
        c = self.cache
        if c.quantized:
            self._flush_fresh_scales()
            ub = torch.as_tensor(np.unique(pids_np), dtype=torch.int64,
                                 device=self.device)
            for l in range(self.cfg.n_layers):
                quant_scatter_span(c.k[l], c.k_scale[l], k[l].transpose(0, 1),
                                   pids, offs, ub, self._qmax)
                quant_scatter_span(c.v[l], c.v_scale[l], v[l].transpose(0, 1),
                                   pids, offs, ub, self._qmax)
        else:
            # advanced indices on dims 1 and 3 are not adjacent: the
            # indexed view is [W, L, Hkv, hd]
            c.k[:, pids, :, offs, :] = k.permute(1, 0, 2, 3)
            c.v[:, pids, :, offs, :] = v.permute(1, 0, 2, 3)

    def _activate_slot(self, slot: int, rid: int, req: Request, prompt: np.ndarray,
                       tok: int, gen: torch.Generator | None, t0: float) -> None:
        """The first token lands, TTFT is recorded, the slot joins the
        decode batch."""
        plen = len(prompt)
        self._register_prompt(slot, prompt)
        now = time.perf_counter()
        ttft = now - self._submit_t.pop(rid)
        self.metrics.record_prefill(now - t0, ttft)
        self._h_ttft.observe(ttft)
        self._c_tokens.inc()
        self._first_tok_t[rid] = now
        tracer = trace.active_tracer()
        if tracer is not None:
            # decode-lifetime span: first token -> finish
            self._decode_spans[rid] = tracer.span("serve.decode", rid=rid, slot=slot)
        st = self.state
        st.last_tok[slot] = tok
        st.temp[slot] = req.temperature
        st.top_k[slot] = req.top_k
        st.top_p[slot] = req.top_p
        st.live[slot] = True
        self.cache.lengths[slot] = plen
        eos = -1 if req.eos_id is None else int(req.eos_id)
        st.eos[slot] = eos
        if self.serve.spec:
            self._slot_ctx[slot] = prompt.tolist() + [tok]
        self._slot_rid[slot] = rid
        self._slot_len[slot] = plen
        self._slot_eos[slot] = eos
        self._slot_gen[slot] = gen
        self._slot_remaining[slot] = req.max_new_tokens - 1
        self._completions[rid] = Completion(
            rid=rid, tokens=[tok], prompt_len=plen, ttft_s=ttft
        )
        if tok == eos:
            self._finish(slot, "eos")
        elif self._slot_remaining[slot] <= 0:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str) -> None:
        rid = self._slot_rid[slot]
        comp = self._completions[rid]
        comp.finish_reason = reason
        if self._store is not None and self.serve.spec:
            # the drafts' corpus: the generated tokens' full blocks join the
            # store too (the prompt's joined at admission). The K/V written
            # is the context less its last token (sampled, never fed)
            B = self.serve.kv_block
            seq = self._slot_ctx[slot][:self._slot_len[slot]]
            n_full = len(seq) // B
            if n_full:
                self._store.insert(seq[:n_full * B], self._table[slot, :n_full].tolist(),
                                   self._pool.retain)
                self._store.evict_to_budget(self._pool.release)
                self._g_prefix_bytes.set(self._store.resident_bytes)
                self._g_prefix_nodes.set(self._store.n_nodes)
        self._slot_ctx[slot] = []
        self.metrics.requests_finished += 1
        self._c_finished.inc()
        t_first = self._first_tok_t.pop(rid, None)
        if t_first is not None and len(comp.tokens) > 1:
            # TPOT: decode-token cadence after the prefill-sampled first
            self._h_tpot.observe((time.perf_counter() - t_first) / (len(comp.tokens) - 1))
        dspan = self._decode_spans.pop(rid, None)
        if dspan is not None:
            dspan.end(tokens=len(comp.tokens), reason=reason)
        self._slot_rid[slot] = None
        self._slot_remaining[slot] = 0
        self._slot_len[slot] = 0
        self._slot_gen[slot] = None
        self.state.live[slot] = False
        self.cache.lengths[slot] = 0
        # a freed slot returns only the blocks whose refcount hits zero
        row = self._table[slot]
        for bi in range(self._slot_blocks[slot]):
            self._pool.release(int(row[bi]))
        row[:self._slot_blocks[slot]] = SCRATCH_BLOCK
        self._slot_blocks[slot] = 0
        self._table_dirty = True
        self._maybe_shrink_pool()

    # --- block planning (host side of the paged cache) ------------------------

    def _alloc_block(self) -> int:
        """One private physical block: free list, else grow the pool
        (doubling), else evict LRU leaves from the prefix store."""
        pid = self._pool.alloc()
        while pid is None:
            if self._pool.n_blocks < self._pool_cap:
                new = min(max(2 * self._pool.n_blocks, 4), self._pool_cap)
                self.cache = grow_cache(self.cache, new)
                self._pool.grow(new)
            elif self._store is None or self._store.evict_lru(self._pool.release) is None:
                raise RuntimeError(
                    "block pool exhausted (live slots + store exceed the pool "
                    "cap: engine accounting bug)"
                )
            pid = self._pool.alloc()
        if self.cache.quantized:
            # a reused block keeps its previous tenant's scale rows: queue
            # them for the batched zeroing (scale 0 = nothing real stored,
            # so the first write alone defines the scale)
            self._fresh_scale.append(pid)
        return pid

    def _flush_fresh_scales(self) -> None:
        """Zero the scale rows of freshly allocated blocks, all layers, in
        one indexed write per scale pool."""
        if not self._fresh_scale:
            return
        pids = torch.as_tensor(self._fresh_scale, dtype=torch.int64,
                               device=self.device)
        self._fresh_scale = []
        self.cache.k_scale[:, pids] = 0.0
        self.cache.v_scale[:, pids] = 0.0

    def _plan_blocks(self, slot: int, plen: int, match: MatchResult | None) -> None:
        """Fill the slot's table row for a prompt: matched full blocks map
        shared, a mid-block match gets a private copy-on-write block, the
        rest are fresh."""
        row = self._table[slot]
        nb = blocks_for(plen, self.serve.kv_block)
        next_bi = 0
        if match is not None:
            for bi, pid in enumerate(match.full):
                self._pool.retain(pid)
                row[bi] = pid
            next_bi = len(match.full)
            if match.partial is not None:
                # COW: the unshared tail writes into this block, so the
                # slot gets a private copy of the shared source first
                dst = self._alloc_block()
                if self.cache.quantized:
                    # the copy carries the source's scale rows, which a
                    # queued zeroing would erase
                    self._fresh_scale.remove(dst)
                copy_block(self.cache, match.partial, dst)
                row[next_bi] = dst
                next_bi += 1
                self._cow_copies += 1
        for bi in range(next_bi, nb):
            row[bi] = self._alloc_block()
        self._slot_blocks[slot] = nb
        self._table_dirty = True

    def _register_prompt(self, slot: int, prompt: np.ndarray) -> None:
        """Insert the prompt's full blocks into the prefix store, then evict
        back under its budget."""
        if self._store is None:
            return
        B = self.serve.kv_block
        n_full = len(prompt) // B
        if n_full:
            self._store.insert(prompt[:n_full * B].tolist(),
                               self._table[slot, :n_full].tolist(),
                               self._pool.retain)
            if self._store.evict_to_budget(self._pool.release):
                self._maybe_shrink_pool()
        self._g_prefix_bytes.set(self._store.resident_bytes)
        self._g_prefix_nodes.set(self._store.n_nodes)

    def _maybe_shrink_pool(self) -> None:
        """Halve the pool while its trailing half is entirely free."""
        if not self.serve.shrink:
            return
        new = self._pool.n_blocks
        target = self._pool.shrink_target(self._p0)
        while new // 2 >= target and new // 2 >= self._p0:
            new //= 2
        if new < self._pool.n_blocks:
            self.cache = shrink_cache(self.cache, new)
            self._pool.shrink(new)

    def _upload_table(self, width: int) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(self._table[:, :width]),
                               device=self.device)

    def _set_attended(self, need: int) -> None:
        """Size the decode step's table width to the live maximum: grow by
        doubling, shrink when the need halves; upload when it changed."""
        cur = self._attended
        if need > cur:
            cur = min(max(need, 2 * cur), self._m_total)
        elif self.serve.shrink and need <= cur // 2:
            cur = max(need, 1)
        if cur != self._attended or self._table_dirty:
            self._attended = cur
            self._table_dev = self._upload_table(cur)
            self._table_dirty = False

    # --- decode loop ----------------------------------------------------------

    def _propose_step_drafts(self, live: list[int]) -> tuple[np.ndarray | None, list[int]]:
        """With spec on, up to ``spec_max_draft`` draft tokens for each live
        slot, on the host; each is capped at ``remaining - 1`` so the
        emitted count (drafts plus the bonus token) never overruns the
        slot's budget. Returns ``(drafts [S, k], draft lengths)``."""
        k = self.serve.spec_max_draft if self.serve.spec else 0
        dlens = [0] * self.serve.slots
        if not k:
            return None, dlens
        drafts = np.zeros((self.serve.slots, k), np.int64)
        for s in live:
            cap = min(k, self._slot_remaining[s] - 1)
            if cap <= 0:
                continue
            prop = propose_drafts(self._slot_ctx[s], self._store, cap,
                                  self.serve.spec_draft_source)
            dlens[s] = len(prop)
            drafts[s, :len(prop)] = prop
        return drafts, dlens

    def _decode_once(self) -> None:
        # a live row allocates, on the host and before the step runs, the
        # blocks of every position the step may write: its next position,
        # and with drafts the draft positions after it
        B = self.serve.kv_block
        live = [s for s, r in enumerate(self._slot_rid)
                if r is not None and s not in self._chunking]
        drafts, dlens = self._propose_step_drafts(live)
        spec_step = any(dlens)
        need = 1
        for s in live:
            last = self._slot_len[s] + dlens[s]
            while self._slot_blocks[s] * B <= last:
                self._table[s, self._slot_blocks[s]] = self._alloc_block()
                self._slot_blocks[s] += 1
                self._table_dirty = True
            need = max(need, last // B + 1)
        if self.cache.quantized:
            self._flush_fresh_scales()
        self._set_attended(need)
        tracer = trace.active_tracer()
        sp = trace.NOOP_SPAN
        if tracer is not None:
            sp = tracer.sampled_span("serve.step", live=len(live))
        common = (self._decode_params, self._layers, self.cache, self._table_dev,
                  self.state, self._slot_gen, self._freqs)
        opts = dict(cfg=self.cfg, kv_block=B, max_top_k=self.serve.max_top_k,
                    qmax=self._qmax, quant_weights=self.serve.quant_weights,
                    monitors=self._monitors and health.due())
        with sp:
            t0 = time.perf_counter()
            if spec_step:
                dev = self.device
                toks, n_emit, rng_saved, hmon = _spec_decode_step(
                    *common, torch.as_tensor(drafts, device=dev),
                    torch.as_tensor(dlens, dtype=torch.int64, device=dev), **opts)
                # the engine's one host sync per decode step
                both = torch.cat([toks, n_emit[:, None]], dim=1).cpu().numpy()
                toks_np, emit_np = both[:, :-1], both[:, -1]
                advance_generators(self._slot_gen, rng_saved, emit_np)
            else:
                # no live slot drafted: the one-token step (the only step
                # with spec off)
                toks, hmon = _decode_step(*common, **opts)
                toks_np = toks.cpu().numpy()[:, None]     # the one host sync
                emit_np = np.ones(self.serve.slots, np.int64)
            dt = time.perf_counter() - t0
        new_total = int(sum(emit_np[s] for s in live))
        if spec_step:
            proposed = sum(dlens[s] for s in live)
            self.metrics.record_spec(proposed, new_total - len(live))
            self._c_draft_prop.inc(proposed)
            self._c_draft_acc.inc(new_total - len(live))
        self.metrics.record_decode(dt, new_total, len(live), self.serve.slots)
        hbm.sample()                 # allocator statistics: no sync
        if self._monitors:
            # device references and the slot -> request map on the steps
            # the sentinel reads (a counter bump on the others); the copies
            # to the host land on the sentinel's worker, never here
            health.sample(metrics=hmon, slot_rids=list(self._slot_rid), live_slots=live)
        series.sample()              # host-side stats only
        self._h_step.observe(dt)
        self._c_tokens.inc(new_total)
        for s in live:
            new_toks = [int(t) for t in toks_np[s, :emit_np[s]]]
            self._slot_len[s] += len(new_toks)
            self._completions[self._slot_rid[s]].tokens.extend(new_toks)
            if self.serve.spec:
                self._slot_ctx[s].extend(new_toks)
            self._slot_remaining[s] -= len(new_toks)
            if new_toks[-1] == self._slot_eos[s]:
                self._finish(s, "eos")
            elif self._slot_remaining[s] <= 0:
                self._finish(s, "length")


def _weak_stats_source(engine: Engine, recorder, key: str):
    """The engine's series source, holding it weakly: an engine dropped
    without close() must not be kept alive (params and KV pools) by the
    process-global recorder. Once the engine is collected the source
    detaches itself on its next scrape."""
    ref = weakref.ref(engine)

    def source() -> dict:
        eng = ref()
        if eng is None:
            recorder.detach(key)
            return {}
        return eng.stats_snapshot(windowed=True)

    return source


_QUANT_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
# lm_head quantizes in column slices of this width: each output channel's
# scale is its own column's, so the result is the same, with a bounded
# float32 transient (Llama-3-8B's whole lm_head would be 2.1 GB a copy)
_QUANT_COLUMNS = 16384


def _quantize_decode_params(params: Params) -> Params:
    """One-time int8 copy of the decode-path weights (``ops/quant_mm.py``):
    every layer matmul and lm_head become ``<name>_q`` int8 /
    ``<name>_s`` float32 pairs; norms and the embedding are shared with
    the masters, which stay untouched for prefill. Stacked layer weights
    quantize one layer at a time, lm_head one column slice at a time, so
    the float32 transient stays small."""
    layers = params["layers"]
    out_layers = {k: t for k, t in layers.items() if k not in _QUANT_WEIGHT_NAMES}
    for name in _QUANT_WEIGHT_NAMES:
        w = layers[name]                                     # [L, D, N]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        sc = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                         device=w.device)
        for l in range(w.shape[0]):
            q[l], sc[l] = quantize_weights(w[l])
        out_layers[name + "_q"], out_layers[name + "_s"] = q, sc
    head = params["lm_head"]                                 # [D, V]
    q = torch.empty(head.shape, dtype=torch.int8, device=head.device)
    sc = torch.empty(head.shape[1], dtype=torch.float32, device=head.device)
    for c0 in range(0, head.shape[1], _QUANT_COLUMNS):
        cols = slice(c0, c0 + _QUANT_COLUMNS)
        q[:, cols], sc[cols] = quantize_weights(head[:, cols])
    out = {k: t for k, t in params.items() if k not in ("layers", "lm_head")}
    out.update(layers=out_layers, lm_head_q=q, lm_head_s=sc)
    return out


def _mm(h: torch.Tensor, lp: dict, name: str, quant_weights: bool) -> torch.Tensor:
    """One decode matmul: the master weight, or its int8 copy through the
    dequant-matmul kernel when quantized."""
    if quant_weights:
        return quant_matmul(h, lp[name + "_q"], lp[name + "_s"])
    return h @ lp[name]


def _rope_rows(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE of ``t [..., H', hd]`` with one angle per position
    (cos/sin ``[..., 1, hd/2]``: one row per slot, or per slot and fed
    position)."""
    t1, t2 = t.float().chunk(2, dim=-1)
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)


def _forward_positions(params: Params, layers: list[dict], cache, table: torch.Tensor,
                       tokens: torch.Tensor, pos: torch.Tensor, pid: torch.Tensor,
                       off: torch.Tensor, lengths: torch.Tensor, freqs: torch.Tensor, *,
                       cfg: LlamaConfig, qmax: float,
                       quant_weights: bool) -> torch.Tensor:
    """The decode forward over fed ``tokens`` ``[S]`` or ``[S, G]`` at
    absolute positions ``pos`` (the same shape): each layer writes the new
    K/V at ``(pid, off)`` in place, then attends through the table with the
    paged kernel, ``lengths`` counting each row's cache after the writes
    (query g of G sees positions ``< lengths - (G - 1) + g``). Returns
    float32 logits ``[S, V]`` or ``[S, G, V]``.

    A quantized cache folds each write into the running block scale
    (``qmax`` is its storage's largest magnitude) and attends through the
    scale pools. ``quant_weights``: ``params``/``layers`` are the int8 copy,
    and the seven layer matmuls and lm_head run the dequant-matmul."""
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    lead = tokens.shape
    x = params["tok_emb"][tokens]                          # [*lead, D]
    ang = pos.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]                     # [*lead, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    scales = (zip(cache.k_scale, cache.v_scale) if cache.quantized
              else [(None, None)] * cfg.n_layers)
    for lp, k_pool, v_pool, (k_sc, v_sc) in zip(layers, cache.k, cache.v, scales):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _rope_rows(_mm(h, lp, "wq", quant_weights).view(*lead, H, hd), cos, sin)
        k_new = _rope_rows(_mm(h, lp, "wk", quant_weights).view(*lead, Hkv, hd), cos, sin)
        v_new = _mm(h, lp, "wv", quant_weights).view(*lead, Hkv, hd)
        scatter_block_kv(k_pool, k_new, pid, off, scale=k_sc, qmax=qmax)
        scatter_block_kv(v_pool, v_new, pid, off, scale=v_sc, qmax=qmax)
        attn = decode_attention(q, k_pool, v_pool, lengths, tables=table,
                                k_scale=k_sc, v_scale=v_sc)
        x = x + _mm(attn.reshape(*lead, H * hd), lp, "wo", quant_weights)
        h2 = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        ffn = F.silu(_mm(h2, lp, "w1", quant_weights)) * _mm(h2, lp, "w3", quant_weights)
        x = x + _mm(ffn, lp, "w2", quant_weights)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x, params, "lm_head", quant_weights).float()


def _decode_step(params: Params, layers: list[dict], cache, table: torch.Tensor,
                 state: _SlotState, gens: Sequence[torch.Generator | None],
                 freqs: torch.Tensor, *, cfg: LlamaConfig, kv_block: int,
                 max_top_k: int, qmax: float = 0.0, quant_weights: bool = False,
                 monitors: bool = False) -> tuple[torch.Tensor, dict]:
    """One token for every slot: write K/V at each row's position (into the
    physical block its table names; dead slots steer to the scratch block),
    attend over its written prefix through the table, sample with its own
    generator. Updates ``cache`` (pools, scales, lengths) and
    ``state.last_tok`` in place; returns the sampled tokens ``[S]`` on the
    device and, with ``monitors``, the per-slot health monitors over the
    sampling logits (``obs/health.py`` ``decode_monitors``; else {})."""
    pos = cache.lengths                                    # [S] int32
    # row s writes position pos into block table[s, pos // block]
    bi = (pos // kv_block).long()
    off = (pos % kv_block).long()
    pid = torch.where(state.live, table.gather(1, bi[:, None])[:, 0].long(),
                      SCRATCH_BLOCK)
    logits = _forward_positions(                           # [S, V]
        params, layers, cache, table, state.last_tok, pos, pid, off,
        pos + 1, freqs, cfg=cfg, qmax=qmax, quant_weights=quant_weights)
    nxt = sample_tokens(logits, state.temp, state.top_k, state.top_p, gens,
                        max_k=max_top_k)
    cache.lengths.add_(state.live.to(torch.int32))
    state.last_tok.copy_(nxt)
    return nxt, (health.decode_monitors(logits) if monitors else {})


def _spec_decode_step(params: Params, layers: list[dict], cache, table: torch.Tensor,
                      state: _SlotState, gens: Sequence[torch.Generator | None],
                      freqs: torch.Tensor, drafts: torch.Tensor,
                      draft_len: torch.Tensor, *, cfg: LlamaConfig, kv_block: int,
                      max_top_k: int, qmax: float = 0.0, quant_weights: bool = False,
                      monitors: bool = False):
    """The speculative verify step: feed every row G = k + 1 tokens (its
    last sampled token and its ``drafts [S, k]``, of which ``draft_len``
    are real), write their K/V at positions ``pos .. pos + k``, attend all
    G query positions in one call of the paged kernel per layer, and run
    the rejection rule (``serve/spec.py``). Dead rows, and a row's padding
    positions past its draft length, write into the scratch block.

    With ``monitors`` the health monitors judge the step by the last
    emitted position's logits, the frontier the one-token step reports, so
    accepted drafts cannot trip the entropy or nonfinite rules.

    Updates ``cache`` in place (its lengths advance by the emitted count
    only, so rejected positions lie past them and later steps overwrite
    them; on a quantized cache their amaxes stay folded into the block
    scales, which only grow, so a rollback never leaves a payload over its
    scale) and ``state.last_tok``. Returns ``(toks [S, G], n_emit [S],
    rng_saved, monitors)`` with toks and n_emit on the device; the caller
    brings them to the host and hands ``n_emit`` to
    ``advance_generators``."""
    S, k = drafts.shape
    G = k + 1
    dev = drafts.device
    tokens = torch.cat([state.last_tok[:, None], drafts], dim=1)   # [S, G]
    pos0 = cache.lengths                                   # [S] int32
    goff = torch.arange(G, dtype=torch.int32, device=dev)
    pos = pos0[:, None] + goff[None, :]                    # [S, G]
    # position g of row s lands in block table[s, pos // block]
    bi = (pos // kv_block).long()
    write_ok = state.live[:, None] & (goff[None, :] <= draft_len[:, None])
    M = table.shape[1]
    pid = torch.where(write_ok, table.gather(1, bi.clamp(max=M - 1)).long(),
                      SCRATCH_BLOCK)
    off = torch.where(write_ok, (pos % kv_block).long(), 0)
    logits = _forward_positions(                           # [S, G, V]
        params, layers, cache, table, tokens, pos, pid, off, pos0 + G, freqs,
        cfg=cfg, qmax=qmax, quant_weights=quant_weights)
    rows = SpecRows(state.temp, state.top_k, state.top_p, state.eos,
                    torch.zeros_like(state.live), gens)
    toks, n_emit, _, last_tok, rng_saved, _ = verify_and_accept(
        logits, drafts, draft_len, rows, max_top_k=max_top_k)
    cache.lengths.add_((n_emit * state.live).to(torch.int32))
    state.last_tok.copy_(torch.where(state.live, last_tok, state.last_tok))
    hmon = {}
    if monitors:
        last = (n_emit - 1).clamp(min=0)
        hmon = health.decode_monitors(
            logits.gather(1, last[:, None, None].expand(-1, 1, logits.shape[-1]))[:, 0])
    return toks, n_emit, rng_saved, hmon


__all__ = [
    "AdmissionRejected", "Completion", "Engine", "Request", "ServeConfig",
]
