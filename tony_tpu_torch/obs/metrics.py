"""Throughput and MFU accounting: the port's copies of ``DecodeMetrics``,
``StepTimer`` and ``chip_peak_flops`` from ``tony_tpu/obs/metrics.py``.

MFU is achieved model FLOP/s over the card's peak. The peaks are NVIDIA's
data-sheet dense bf16 tensor-core rates, keyed by the name
``torch.cuda.get_device_name`` reports; a card not in the table raises
rather than being guessed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# dense bf16 FLOP/s per card (NVIDIA H100 data sheet, without sparsity),
# matched against the device name in this order
PEAK_BF16_FLOPS: tuple[tuple[str, float], ...] = (
    ("H100 PCIe", 756e12),
    ("H100 80GB HBM3", 989e12),   # the SXM part's reported name
    ("H100 SXM", 989e12),
)


def chip_peak_flops(device: torch.device | str | int | None = None) -> float:
    """Peak dense bf16 FLOP/s of the CUDA device (the current one by
    default). Raises for a card without a data-sheet entry here, and when
    there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_peak_flops needs a CUDA device")
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_BF16_FLOPS:
        if key in name:
            return peak
    raise ValueError(f"no peak FLOP/s known for {name!r}; add its data-sheet "
                     "dense bf16 rate to PEAK_BF16_FLOPS")


@dataclass
class StepTimer:
    """Accumulates steps and wall time to report tokens/s and MFU."""

    flops_per_token: float
    tokens_per_step: int
    n_chips: int = 1
    elapsed_s: float = 0.0
    steps: int = 0
    # wall time the host spent blocked producing/placing input batches
    # (time inside next(batches))
    host_blocked_s: float = 0.0

    def record(self, dt_s: float, n_steps: int = 1, host_blocked_s: float = 0.0) -> None:
        self.elapsed_s += dt_s
        self.steps += n_steps
        self.host_blocked_s += host_blocked_s

    @property
    def host_blocked_ms_per_step(self) -> float:
        if self.steps == 0:
            return 0.0
        return self.host_blocked_s / self.steps * 1e3

    @property
    def host_blocked_frac(self) -> float:
        """Fraction of wall time spent input-blocked (0 = stall-free loop)."""
        if self.elapsed_s == 0:
            return 0.0
        return self.host_blocked_s / self.elapsed_s

    @property
    def tokens_per_sec(self) -> float:
        if self.elapsed_s == 0:
            return 0.0
        return self.steps * self.tokens_per_step / self.elapsed_s

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / self.n_chips

    def mfu(self, peak_flops_per_chip: float | None = None) -> float:
        peak = peak_flops_per_chip or chip_peak_flops()
        return self.tokens_per_sec_per_chip * self.flops_per_token / peak


@dataclass
class DecodeMetrics:
    """Serving-side counters fed by the decode engine (serve/engine.py):
    decode tokens/s is the throughput headline, time-to-first-token the
    latency one, and slot occupancy the continuous-batching health
    signal."""

    n_chips: int = 1
    generated_tokens: int = 0      # sampled tokens (prefill firsts + decode)
    decode_s: float = 0.0          # wall time inside decode steps
    prefill_s: float = 0.0         # wall time inside prefill calls
    decode_steps: int = 0
    occupancy_sum: float = 0.0     # sum over decode steps of live/slots
    ttft_sum_s: float = 0.0        # submit -> first token, summed
    ttft_max_s: float = 0.0
    requests_started: int = 0
    requests_finished: int = 0
    prefill_compiles: int = 0      # always 0 in the port: it runs eagerly
    decode_compiles: int = 0       # always 0 in the port: it runs eagerly
    prompt_tokens: int = 0         # prompt tokens admitted
    prefix_hit_tokens: int = 0     # prompt tokens served from the prefix store
    decode_tokens: int = 0         # tokens emitted by decode steps only
    decode_live_sum: int = 0       # sum over decode steps of live slots
    draft_proposed: int = 0        # speculative draft tokens proposed
    draft_accepted: int = 0        # ... of which the target accepted
    spec_rollbacks: int = 0        # ... of which were rejected
    kv_bytes_per_token: float = 0.0  # device bytes per cached token

    def record_prompt(self, plen: int, hit_tokens: int = 0) -> None:
        self.prompt_tokens += plen
        self.prefix_hit_tokens += hit_tokens

    def record_spec(self, proposed: int, accepted: int) -> None:
        self.draft_proposed += proposed
        self.draft_accepted += accepted
        self.spec_rollbacks += proposed - accepted

    def record_prefill(self, dt_s: float, ttft_s: float) -> None:
        self.prefill_s += dt_s
        self.ttft_sum_s += ttft_s
        self.ttft_max_s = max(self.ttft_max_s, ttft_s)
        self.requests_started += 1
        self.generated_tokens += 1  # prefill samples the first token

    def record_decode(self, dt_s: float, new_tokens: int, live: int,
                      slots: int) -> None:
        self.decode_s += dt_s
        self.decode_steps += 1
        self.generated_tokens += new_tokens
        self.decode_tokens += new_tokens
        self.decode_live_sum += live
        self.occupancy_sum += live / max(slots, 1)

    @property
    def elapsed_s(self) -> float:
        return self.decode_s + self.prefill_s

    @property
    def tokens_per_sec(self) -> float:
        if self.elapsed_s == 0:
            return 0.0
        return self.generated_tokens / self.elapsed_s

    @property
    def tokens_per_sec_per_chip(self) -> float:
        return self.tokens_per_sec / self.n_chips

    @property
    def decode_tokens_per_sec(self) -> float:
        """Decode-step tokens over decode-step wall time."""
        if self.decode_s == 0:
            return 0.0
        return self.decode_tokens / self.decode_s

    @property
    def slot_occupancy(self) -> float:
        if self.decode_steps == 0:
            return 0.0
        return self.occupancy_sum / self.decode_steps

    @property
    def ttft_avg_s(self) -> float:
        if self.requests_started == 0:
            return 0.0
        return self.ttft_sum_s / self.requests_started

    @property
    def prefix_hit_rate(self) -> float:
        if self.prompt_tokens == 0:
            return 0.0
        return self.prefix_hit_tokens / self.prompt_tokens

    @property
    def tokens_per_step(self) -> float:
        """Decode tokens per step per live slot (1.0 autoregressively)."""
        if self.decode_live_sum == 0:
            return 0.0
        return self.decode_tokens / self.decode_live_sum

    @property
    def draft_accept_rate(self) -> float:
        if self.draft_proposed == 0:
            return 0.0
        return self.draft_accepted / self.draft_proposed

    def summary(self) -> dict:
        out = {
            "tokens_per_sec_per_chip": round(self.tokens_per_sec_per_chip, 1),
            "generated_tokens": self.generated_tokens,
            "ttft_avg_s": round(self.ttft_avg_s, 4),
            "ttft_max_s": round(self.ttft_max_s, 4),
            "slot_occupancy": round(self.slot_occupancy, 3),
            "decode_steps": self.decode_steps,
            "requests_finished": self.requests_finished,
            "prefill_compiles": self.prefill_compiles,
            "decode_compiles": self.decode_compiles,
        }
        if self.decode_steps:
            out["tokens_per_step"] = round(self.tokens_per_step, 3)
        if self.prompt_tokens:
            out["prefix_hit_tokens"] = self.prefix_hit_tokens
            out["prefix_hit_rate"] = round(self.prefix_hit_rate, 4)
        if self.draft_proposed:
            out["draft_accept_rate"] = round(self.draft_accept_rate, 4)
            out["spec_rollbacks"] = self.spec_rollbacks
        if self.kv_bytes_per_token:
            out["kv_bytes_per_token"] = round(self.kv_bytes_per_token, 2)
        return out


__all__ = ["DecodeMetrics", "PEAK_BF16_FLOPS", "StepTimer", "chip_peak_flops"]
