"""Measured decode-slot budgets from a probe of the decode step.

The port's counterpart of ``tony_tpu/serve/capacity.py``. The reference
reads XLA's compiled memory plan of the decode step at 1 and 2 slots.
PyTorch has no compiled plan, so :func:`decode_step_analysis` runs the
engine's own decode step on the card at 1 and 2 slots instead: parameters,
the paged pools (sized so every slot reaches ``capacity`` privately, the
scratch block included), the table and the slot state are allocated
first, a warm-up step runs (the kernels' first launch, cuBLAS's
workspace), then ``torch.cuda.reset_peak_memory_stats`` and one measured
step. What the step adds over what was resident before it is its
temporaries (``temp_bytes``); the components stay apart as in the
reference:

- **param bytes**: the weights (the engine's int8 decode copy too, with
  ``quant_weights``),
- **cache bytes**: the pools and, quantized, their scale pools,
- **fixed temp**: per-step scratch independent of the slot count,
- **per-slot temp**: what one more slot costs (the slot-count difference).

There is no generated-code term (kernels live outside the allocator). The
budget is then the reference's arithmetic::

    slots = (hbm - params - fixed_temp) // (kv_per_slot + temp_per_slot)

``hbm_bytes`` defaults to the card's total from ``torch.cuda.mem_get_info``.
Without CUDA there is nothing to measure and it raises, as the reference
raises on a backend without a memory analysis.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tony_tpu_torch.models.llama import LlamaConfig, Params, init_params, rope_freqs
from tony_tpu_torch.serve.cache import block_bytes, blocks_for, create_cache, kv_quant_spec


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if tree is not None else 0


def decode_step_analysis(cfg: LlamaConfig, *, slots: int, capacity: int,
                         kv_block: int = 64, max_top_k: int = 64, quant_kv: str = "",
                         quant_weights: bool = False, params: Params | None = None,
                         seed: int = 0) -> dict[str, Any]:
    """Run the serve engine's decode step at ``slots`` slots, every slot at
    ``capacity - 1`` cached positions (the widest table the step attends),
    and return its measured memory components. ``params`` on the card, or
    random ones from ``seed``; ``quant_kv`` and ``quant_weights`` run the
    quantized engine's step over its own pools and weights. Raises without
    CUDA."""
    from tony_tpu_torch.serve.engine import _SlotState, _decode_step, _quantize_decode_params

    if not torch.cuda.is_available():
        raise RuntimeError("the decode-step probe needs a CUDA device; slot budget "
                           "cannot be measured")
    dev = torch.device("cuda")
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    dec = _quantize_decode_params(params) if quant_weights else params
    layers = [{k: t[l] for k, t in dec["layers"].items()} for l in range(cfg.n_layers)]
    blocks = blocks_for(capacity, kv_block)
    cache = create_cache(cfg, slots, 1 + slots * blocks, kv_block, device=dev,
                         quant_kv=quant_kv)
    table = (1 + torch.arange(slots * blocks, dtype=torch.int32, device=dev)
             ).reshape(slots, blocks)
    state = _SlotState(
        last_tok=torch.zeros(slots, dtype=torch.int64, device=dev),
        temp=torch.zeros(slots, dtype=torch.float32, device=dev),
        top_k=torch.zeros(slots, dtype=torch.int64, device=dev),
        top_p=torch.ones(slots, dtype=torch.float32, device=dev),
        eos=torch.full((slots,), -1, dtype=torch.int64, device=dev),
        live=torch.ones(slots, dtype=torch.bool, device=dev),
    )
    freqs = rope_freqs(cfg, dev)
    qmax = kv_quant_spec(quant_kv)[1] if quant_kv else 0.0

    def step() -> None:
        cache.lengths.fill_(capacity - 1)
        _decode_step(dec, layers, cache, table, state, [None] * slots, freqs, cfg=cfg,
                     kv_block=kv_block, max_top_k=max_top_k, qmax=qmax,
                     quant_weights=quant_weights)
        torch.cuda.synchronize(dev)

    step()                                   # warm-up: first launches, workspaces
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    step()
    peak = torch.cuda.max_memory_allocated(dev)
    pools = [cache.k, cache.v, cache.k_scale, cache.v_scale]
    param_bytes = _tree_bytes(params)
    if quant_weights:
        param_bytes += _tree_bytes({k: v for k, v in dec.items() if k not in params}) + \
            _tree_bytes({k: v for k, v in dec["layers"].items()
                         if k not in params["layers"]})
    return {
        "slots": slots,
        "capacity": capacity,
        "param_bytes": int(param_bytes),
        "cache_bytes": _tree_bytes(pools),
        "table_bytes": _tree_bytes([table]),
        "kv_bytes_per_slot": blocks * block_bytes(cfg, kv_block, quant_kv=quant_kv),
        "resident_bytes": int(resident),
        "peak_bytes": int(peak),
        "temp_bytes": int(peak - resident),
    }


def _components(one: dict, two: dict) -> tuple[int, int, int]:
    """(fixed temp, per-slot temp, generated code) from the 1- and 2-slot
    analyses: the reference's split."""
    temp1 = int(one.get("temp_bytes", 0))
    temp2 = int(two.get("temp_bytes", temp1))
    per_slot_temp = max(temp2 - temp1, 0)
    return (max(temp1 - per_slot_temp, 0), per_slot_temp,
            int(one.get("generated_code_bytes", 0)))


def derive_slot_budget(cfg: LlamaConfig, *, max_len: int, hbm_bytes: int | None = None,
                       kv_block: int = 64, shared_prefix_tokens: int = 0,
                       quant_kv: str = "", params: Params | None = None,
                       analysis: Callable[..., dict] | None = None) -> dict[str, Any]:
    """Slot budget at ``max_len`` from the probed decode step's components
    (params + fixed/per-slot temp), with every component returned.

    ``shared_prefix_tokens``: when every request carries that much shared
    prefix, its blocks are paid once (one refcounted copy in the pool) and
    each slot holds only its unshared tail. ``quant_kv`` ('int8' |
    'fp8_e4m3') also probes the quantized step at the same two slot counts
    and reports its budget (``max_slots_quant``, ``quant_slot_ratio``)
    beside the model-dtype one. ``analysis`` replaces
    :func:`decode_step_analysis` (same keywords): the arithmetic over
    injected components."""
    analyse = analysis or decode_step_analysis
    if hbm_bytes is None:
        if not torch.cuda.is_available():
            raise RuntimeError("hbm_bytes not given and no CUDA device to read it from")
        hbm_bytes = int(torch.cuda.mem_get_info()[1])
    capacity = blocks_for(max_len, kv_block) * kv_block
    probe = dict(capacity=capacity, kv_block=kv_block, params=params)
    one = analyse(cfg, slots=1, **probe)
    if "temp_bytes" not in one:
        raise RuntimeError("the decode-step analysis measured no temporaries; slot "
                           "budget cannot be measured")
    two = analyse(cfg, slots=2, **probe)
    fixed_temp, per_slot_temp, code = _components(one, two)
    param_bytes = one["param_bytes"]
    # per-slot KV bytes are exact from the block math (one slot's private
    # blocks; the shared scratch block sits in cache_bytes, not here)
    per_slot_kv = one["kv_bytes_per_slot"]
    # the repeat-expanded layout keeps K/V at n_heads width: the capacity
    # the native-GQA decode kernel exists to avoid paying
    per_slot_kv_repeat = per_slot_kv * cfg.n_heads // cfg.n_kv_heads
    budget = hbm_bytes - param_bytes - fixed_temp - code
    native = max(budget // (per_slot_kv + per_slot_temp), 0) if budget > 0 else 0
    repeat = (max(budget // (per_slot_kv_repeat + per_slot_temp), 0)
              if budget > 0 else 0)
    out = {
        "hbm_bytes": int(hbm_bytes),
        "param_bytes": int(param_bytes),
        "fixed_temp_bytes": int(fixed_temp),
        "per_slot_temp_bytes": int(per_slot_temp),
        "generated_code_bytes": code,
        "kv_bytes_per_slot_native": int(per_slot_kv),
        "kv_bytes_per_slot_repeat": int(per_slot_kv_repeat),
        "max_slots_native": int(native),
        "max_slots_repeat": int(repeat),
        "source": "decode_step_probe",
    }
    if shared_prefix_tokens > 0:
        shared_bytes, per_slot_private, slots_shared = _shared_budget(
            per_slot_kv, per_slot_temp, budget, shared_prefix_tokens, max_len, kv_block)
        out["shared_prefix_tokens"] = int(shared_prefix_tokens)
        out["shared_prefix_bytes"] = int(shared_bytes)
        out["kv_bytes_per_slot_prefix_shared"] = int(per_slot_private)
        out["max_slots_prefix_shared"] = int(slots_shared)
    if quant_kv:
        q1 = analyse(cfg, slots=1, quant_kv=quant_kv, **probe)
        q2 = analyse(cfg, slots=2, quant_kv=quant_kv, **probe)
        q_fixed, q_slot_temp, q_code = _components(q1, q2)
        per_slot_kv_q = q1["kv_bytes_per_slot"]
        budget_q = hbm_bytes - q1["param_bytes"] - q_fixed - q_code
        quant = (max(budget_q // (per_slot_kv_q + q_slot_temp), 0)
                 if budget_q > 0 else 0)
        out["quant_kv"] = quant_kv
        out["fixed_temp_bytes_quant"] = int(q_fixed)
        out["per_slot_temp_bytes_quant"] = int(q_slot_temp)
        out["kv_bytes_per_slot_quant"] = int(per_slot_kv_q)
        out["max_slots_quant"] = int(quant)
        out["quant_slot_ratio"] = round(quant / native, 3) if native else 0.0
        if shared_prefix_tokens > 0:
            # shared blocks priced at quantized bytes: payload plus scale rows
            q_shared, q_private, q_slots_shared = _shared_budget(
                per_slot_kv_q, q_slot_temp, budget_q, shared_prefix_tokens, max_len,
                kv_block)
            out["shared_prefix_bytes_quant"] = int(q_shared)
            out["kv_bytes_per_slot_quant_prefix_shared"] = int(q_private)
            out["max_slots_quant_prefix_shared"] = int(q_slots_shared)
    return out


def _shared_budget(per_slot_kv: int, per_slot_temp: int, budget: int,
                   shared_prefix_tokens: int, max_len: int,
                   kv_block: int) -> tuple[int, int, int]:
    """(shared bytes paid once, per-slot private KV bytes, slot budget)
    under prefix sharing: the common math for the model-dtype and
    quantized variants, each feeding its own per-slot KV price."""
    total_blocks = blocks_for(max_len, kv_block)
    shared_blocks = min(shared_prefix_tokens // kv_block, total_blocks)
    per_block = per_slot_kv // total_blocks
    shared_bytes = shared_blocks * per_block
    per_slot_private = per_slot_kv - shared_bytes
    budget_shared = budget - shared_bytes
    slots_shared = (
        max(budget_shared // (per_slot_private + per_slot_temp), 0)
        if budget_shared > 0 and (per_slot_private + per_slot_temp) > 0
        else 0
    )
    return shared_bytes, per_slot_private, slots_shared


__all__ = ["decode_step_analysis", "derive_slot_budget"]
