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

What differs from the reference: PyTorch runs eagerly, so there are no jit
or AOT caches and no compile ledger; prefill runs at the prompt's exact
length (``prefill_buckets`` only bounds admissible prompt lengths, as in
the reference). The pools are updated in place. Not ported yet, and
refused rather than ignored: ``chunk_tokens`` and the blockwise handoff
between pools (ROADMAP queue 1, item 4), and the observability spine
(tracing, registry histograms, health, series, profile, SLO; queue 1,
item 6).
"""

from __future__ import annotations

import dataclasses
import time
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
from tony_tpu_torch.obs.metrics import DecodeMetrics
from tony_tpu_torch.ops.decode_attention import check_kernel_shape, decode_attention
from tony_tpu_torch.ops.quant_mm import quant_matmul, quantize_weights
from tony_tpu_torch.serve.cache import (
    SCRATCH_BLOCK, BlockPool, block_bytes, blocks_for, copy_block, create_cache,
    dequantize_values, gather_blocks, grow_cache, kv_quant_spec,
    quant_scatter_span, scatter_block_kv, shrink_cache,
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
    # chunked prefill: not ported yet (ROADMAP queue 1, item 4)
    chunk_tokens: int = 0
    # pool label ('decode' | 'prefill'); the handoff between pools is not
    # ported yet (ROADMAP queue 1, item 4)
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


class _SlotState(NamedTuple):
    """Per-slot device state read by the decode step."""

    last_tok: torch.Tensor   # [S] int64, token to feed this step
    temp: torch.Tensor       # [S] float32
    top_k: torch.Tensor      # [S] int64
    top_p: torch.Tensor      # [S] float32
    eos: torch.Tensor        # [S] int64, -1 = none
    live: torch.Tensor       # [S] bool, slot owned by a request


# ServeConfig knobs not ported yet: (field, what, ROADMAP queue 1 item)
_UNPORTED = (
    ("chunk_tokens", "chunked prefill", 4),
)


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
        for name, what, item in _UNPORTED:
            if getattr(serve, name):
                raise NotImplementedError(
                    f"ServeConfig.{name}: {what} is not ported yet (ROADMAP "
                    f"queue 1, item {item})"
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
            raise AdmissionRejected(
                f"admission queue full ({len(self._queue)} >= max_queue "
                f"{self.serve.max_queue})"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, req))
        self._submit_t[rid] = time.perf_counter()
        return rid

    @property
    def n_live(self) -> int:
        return sum(1 for r in self._slot_rid if r is not None)

    @property
    def attended_positions(self) -> int:
        """Positions the decode step's table covers per slot."""
        return self._attended * self.serve.kv_block

    def step(self) -> int:
        """Admit what fits, run one decode step; returns live-slot count."""
        self._admit()
        if self.n_live:
            self._decode_once()
        return self.n_live

    def run(self, requests: Sequence[Request] | None = None) -> dict[int, Completion]:
        """Submit ``requests`` (if given), drain queue and live slots, and
        return (and evict) every completion finished by this call."""
        for r in requests or ():
            self.submit(r)
        while self._queue or self.n_live:
            self.step()
        done, self._completions = self._completions, {}
        return done

    def reset_metrics(self) -> None:
        """Fresh throughput/latency counters (e.g. after a warm-up)."""
        self.metrics = DecodeMetrics(
            n_chips=1, kv_bytes_per_token=self.metrics.kv_bytes_per_token
        )

    def stats_snapshot(self) -> dict[str, float]:
        """Host-side counters only (no device sync)."""
        snap: dict[str, float] = {
            "queue_depth": float(len(self._queue)),
            "live_slots": float(self.n_live),
            "slots": float(self.serve.slots),
            "occupancy": round(self.n_live / max(self.serve.slots, 1), 4),
            "generated_tokens": float(self.metrics.generated_tokens),
            "requests_finished": float(self.metrics.requests_finished),
            "kv_bytes_per_token": round(self.metrics.kv_bytes_per_token, 2),
            "pool_blocks": float(self._pool.n_blocks),
        }
        if self.serve.quant_kv:
            snap["quant_pool_resident_bytes"] = float(self._pool.n_blocks
                                                      * self._blk_bytes)
        if self._store is not None:
            snap.update(self._store.stats())
        return snap

    def close(self) -> dict:
        """Shutdown summary: the DecodeMetrics summary plus prefix stats."""
        s = self.metrics.summary()
        if self._store is not None:
            s["prefix"] = dict(self._store.stats())
            s["prefix"]["cow_copies"] = self._cow_copies
        return s

    def export_prefix_blocks(self, tokens: Sequence[int]):
        raise NotImplementedError(
            "blockwise KV handoff (export_prefix_blocks) is not ported yet "
            "(ROADMAP queue 1, item 4)"
        )

    def adopt_blocks(self, tokens: Sequence[int], payload):
        raise NotImplementedError(
            "blockwise KV handoff (adopt_blocks) is not ported yet (ROADMAP "
            "queue 1, item 4)"
        )

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
            self._store.record_prompt(plen, matched)
        self.metrics.record_prompt(plen, matched)
        gen = self._generator(req, rid) if req.temperature > 0 else None
        self._plan_blocks(slot, plen, match)
        tok = self._prefill(slot, prompt, matched, req, gen)
        self._activate_slot(slot, rid, req, prompt, tok, gen, t0)

    def _prefill(self, slot: int, prompt: np.ndarray, matched: int,
                 req: Request, gen: torch.Generator | None) -> int:
        """Prefill ``prompt[matched:]`` and sample the first token. With a
        prefix match, the matched K/V is gathered from the pool (through
        the slot's own table, COW copy included) into a contiguous context
        that the tail attends (quantized pools dequantize it to the model
        dtype through the blocks' scale rows); without one the context is
        just the prompt. The new K/V is scattered into the slot's blocks."""
        cfg, dev, B = self.cfg, self.device, self.serve.kv_block
        plen = len(prompt)
        if matched:
            n_have = blocks_for(plen, B)
            ids = torch.as_tensor(self._table[slot, :n_have], dtype=torch.int64,
                                  device=dev)

            def gather(pool: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
                g = gather_blocks(pool, ids, dim=1)    # [L, n, Hkv, blk, hd]
                if scale is not None:
                    sc = scale.index_select(1, ids)    # [L, n, Hkv]
                    g = dequantize_values(g, sc[..., None, None], cfg.dtype)
                L, n, Hkv, blk, hd = g.shape
                return g.permute(0, 1, 3, 2, 4).reshape(L, 1, n * blk, Hkv, hd)

            c = self.cache
            ctx = KVCache(gather(c.k, c.k_scale), gather(c.v, c.v_scale))
        else:
            ctx = KVCache.create(cfg, 1, plen, device=dev)
        tail = torch.as_tensor(prompt[matched:], dtype=torch.int64, device=dev)[None]
        logits, kv = forward_with_cache(self.params, tail, ctx, matched, cfg,
                                        last_only=True)
        tok = sample_tokens(
            logits[:, 0],
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int64, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            [gen], max_k=self.serve.max_top_k,
        )
        self._scatter_prompt(slot, kv.k[:, 0, matched:plen],
                             kv.v[:, 0, matched:plen], matched, plen)
        # explicit sync: the first token steers admission on the host
        return int(tok[0])

    def _scatter_prompt(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                        start: int, plen: int) -> None:
        """Write prefilled K/V (``[L, W, Hkv, hd]``, positions ``start + i``)
        into the slot's blocks, in place. Quantized pools quantize the span
        layer by layer, each touched block's running scale updated once."""
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
        c.lengths[slot] = plen

    def _activate_slot(self, slot: int, rid: int, req: Request, prompt: np.ndarray,
                       tok: int, gen: torch.Generator | None, t0: float) -> None:
        """The first token lands, TTFT is recorded, the slot joins the
        decode batch."""
        plen = len(prompt)
        self._register_prompt(slot, prompt)
        now = time.perf_counter()
        ttft = now - self._submit_t.pop(rid)
        self.metrics.record_prefill(now - t0, ttft)
        st = self.state
        st.last_tok[slot] = tok
        st.temp[slot] = req.temperature
        st.top_k[slot] = req.top_k
        st.top_p[slot] = req.top_p
        st.live[slot] = True
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
        self._completions[self._slot_rid[slot]].finish_reason = reason
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
        self._slot_ctx[slot] = []
        self.metrics.requests_finished += 1
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
        live = [s for s, r in enumerate(self._slot_rid) if r is not None]
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
        t0 = time.perf_counter()
        common = (self._decode_params, self._layers, self.cache, self._table_dev,
                  self.state, self._slot_gen, self._freqs)
        opts = dict(cfg=self.cfg, kv_block=B, max_top_k=self.serve.max_top_k,
                    qmax=self._qmax, quant_weights=self.serve.quant_weights)
        if spec_step:
            dev = self.device
            toks, n_emit, rng_saved = _spec_decode_step(
                *common, torch.as_tensor(drafts, device=dev),
                torch.as_tensor(dlens, dtype=torch.int64, device=dev), **opts)
            # the engine's one host sync per decode step
            both = torch.cat([toks, n_emit[:, None]], dim=1).cpu().numpy()
            toks_np, emit_np = both[:, :-1], both[:, -1]
            advance_generators(self._slot_gen, rng_saved, emit_np)
        else:
            # no live slot drafted: the one-token step (the only step with
            # spec off)
            toks = _decode_step(*common, **opts)
            toks_np = toks.cpu().numpy()[:, None]     # the one host sync
            emit_np = np.ones(self.serve.slots, np.int64)
        dt = time.perf_counter() - t0
        new_total = int(sum(emit_np[s] for s in live))
        if spec_step:
            self.metrics.record_spec(sum(dlens[s] for s in live), new_total - len(live))
        self.metrics.record_decode(dt, new_total, len(live), self.serve.slots)
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
                 max_top_k: int, qmax: float = 0.0,
                 quant_weights: bool = False) -> torch.Tensor:
    """One token for every slot: write K/V at each row's position (into the
    physical block its table names; dead slots steer to the scratch block),
    attend over its written prefix through the table, sample with its own
    generator. Updates ``cache`` (pools, scales, lengths) and
    ``state.last_tok`` in place; returns the sampled tokens ``[S]`` on the
    device."""
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
    return nxt


def _spec_decode_step(params: Params, layers: list[dict], cache, table: torch.Tensor,
                      state: _SlotState, gens: Sequence[torch.Generator | None],
                      freqs: torch.Tensor, drafts: torch.Tensor,
                      draft_len: torch.Tensor, *, cfg: LlamaConfig, kv_block: int,
                      max_top_k: int, qmax: float = 0.0, quant_weights: bool = False):
    """The speculative verify step: feed every row G = k + 1 tokens (its
    last sampled token and its ``drafts [S, k]``, of which ``draft_len``
    are real), write their K/V at positions ``pos .. pos + k``, attend all
    G query positions in one call of the paged kernel per layer, and run
    the rejection rule (``serve/spec.py``). Dead rows, and a row's padding
    positions past its draft length, write into the scratch block.

    Updates ``cache`` in place (its lengths advance by the emitted count
    only, so rejected positions lie past them and later steps overwrite
    them; on a quantized cache their amaxes stay folded into the block
    scales, which only grow, so a rollback never leaves a payload over its
    scale) and ``state.last_tok``. Returns ``(toks [S, G], n_emit [S],
    rng_saved)`` with toks and n_emit on the device; the caller brings
    them to the host and hands ``n_emit`` to ``advance_generators``."""
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
    return toks, n_emit, rng_saved


__all__ = [
    "AdmissionRejected", "Completion", "Engine", "Request", "ServeConfig",
]
