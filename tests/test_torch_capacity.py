"""The port's slot-budget derivation (tony_tpu_torch/serve/capacity.py)
against the JAX package's: the same measured components injected into
both (the reference reads them from XLA's compiled plan, the port from a
probe step on the card), equal budgets, Llama-3-8B's shapes at max_len
2048 and kv_block 64, in bf16, int8 and fp8, with and without a shared
prefix. The probe itself runs only on the card and raises without it."""

import numpy as np
import pytest
import torch

from tony_tpu.models import llama as jl
from tony_tpu.serve import capacity as jcap
from tony_tpu.serve.cache import block_bytes as jblock_bytes, blocks_for
from tony_tpu_torch.models.llama import LlamaConfig
from tony_tpu_torch.serve import capacity

HBM = 80 * 10**9


def _fake(cfg, block_bytes):
    """A decode-step analysis: the bytes a probe (or a compiled plan)
    would measure, linear in the slot count, by pool dtype."""

    def analysis(_cfg, *, slots, capacity, kv_block=64, quant_kv="", **_):
        blocks = blocks_for(capacity, kv_block)
        temp = {"": (900_000_000, 41_000_000), "int8": (930_000_000, 44_000_000),
                "fp8_e4m3": (925_000_000, 43_500_000)}[quant_kv]
        return {"slots": slots, "capacity": capacity,
                "param_bytes": 16_060_522_496 + (4096 if quant_kv else 0),
                "kv_bytes_per_slot": blocks * block_bytes(cfg, kv_block, quant_kv=quant_kv),
                "temp_bytes": temp[0] + slots * temp[1],
                "generated_code_bytes": 3_000_000}

    return analysis


@pytest.mark.parametrize("quant_kv", ["", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("shared", [0, 256, 1000])
def test_budget_arithmetic_matches_reference(monkeypatch, quant_kv, shared):
    """Every key of ``derive_slot_budget`` equal to the reference's over the
    same injected components (``source`` names where they came from)."""
    jcfg = jl.LlamaConfig.llama3_8b()
    monkeypatch.setattr(jcap, "decode_step_analysis", _fake(jcfg, jblock_bytes))
    want = jcap.derive_slot_budget(jcfg, max_len=2048, hbm_bytes=HBM, kv_block=64,
                                   shared_prefix_tokens=shared, quant_kv=quant_kv)
    from tony_tpu_torch.serve.cache import block_bytes

    cfg = LlamaConfig.llama3_8b()
    got = capacity.derive_slot_budget(cfg, max_len=2048, hbm_bytes=HBM, kv_block=64,
                                      shared_prefix_tokens=shared, quant_kv=quant_kv,
                                      analysis=_fake(cfg, block_bytes))
    assert want.pop("source") == "memory_analysis"
    assert got.pop("source") == "decode_step_probe"
    assert got == want
    assert got["max_slots_native"] > 0


def test_shared_budget_matches_reference():
    """``_shared_budget`` on random components, including a prefix longer
    than max_len and an exhausted budget."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        args = (int(rng.integers(1, 10**9)), int(rng.integers(0, 10**8)),
                int(rng.integers(-10**9, 10**11)), int(rng.integers(0, 5000)),
                int(rng.integers(64, 4096)), int(rng.choice([16, 64, 128])))
        assert capacity._shared_budget(*args) == jcap._shared_budget(*args)


def test_probe_needs_cuda(monkeypatch):
    """Without CUDA there is nothing to measure: the probe raises, as the
    reference raises without a memory analysis."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        capacity.decode_step_analysis(cfg, slots=1, capacity=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        capacity.derive_slot_budget(cfg, max_len=64, hbm_bytes=HBM)
    with pytest.raises(RuntimeError, match="CUDA"):
        capacity.derive_slot_budget(cfg, max_len=64)
