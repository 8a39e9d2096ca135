"""Llama-family decoder configuration, parameters and building blocks, in
PyTorch.

The counterpart of ``tony_tpu/models/llama.py``. The parameter tree keeps
that module's layout exactly, so one numpy tree loads into both packages
(``models/convert.py``):

- a plain dict of tensors, per-layer tensors stacked on axis 0 (``[L, ...]``);
- projections are ``x @ w`` with ``w`` of shape ``[in, out]``;
- norm statistics and RoPE angles in float32, everything else in
  ``cfg.dtype``.

This slice of the port serves (``serve/engine.py``); the training forward,
the loss heads and the remat policies are not ported yet, so the
training-only fields of :class:`LlamaConfig` are carried for parity of the
config and read by nothing here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from tony_tpu_torch._device import resolve_device

Params = dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # training knobs, kept so a config means the same in both packages
    remat: bool = True
    remat_policy: str = "nothing"
    attention_impl: str = "dot"
    flash_block_q: int = 1024
    flash_block_k: int = 1024
    scan_unroll: int = 1
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "grouped"
    moe_group_block: int = 128
    moe_gmm_impl: str = "scan"
    moe_overlap_impl: str = "off"
    moe_overlap_chunk: int = 0
    moe_aux_coef: float = 0.01
    ce_impl: str = "scan"
    ce_vocab_chunk: int = 4096
    ce_block_n: int = 512
    ce_block_v: int = 512
    overlap_impl: str = ""

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_params(self) -> int:
        """Exact parameter count (embeddings included, tied=False)."""
        d, h = self.dim, self.head_dim
        attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h + self.n_heads * h * d
        if self.is_moe:
            ffn = d * self.n_experts + 3 * self.n_experts * d * self.ffn_dim
        else:
            ffn = 3 * d * self.ffn_dim
        per_layer = attn + ffn + 2 * d
        return self.vocab_size * d * 2 + self.n_layers * per_layer + d

    # --- presets -----------------------------------------------------------

    @classmethod
    def llama2_7b(cls, **kw: Any) -> "LlamaConfig":
        return cls(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
            ffn_dim=11008, max_seq_len=4096, **kw,
        )

    @classmethod
    def llama2_13b(cls, **kw: Any) -> "LlamaConfig":
        return cls(
            vocab_size=32000, dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
            ffn_dim=13824, max_seq_len=4096, **kw,
        )

    @classmethod
    def llama3_8b(cls, **kw: Any) -> "LlamaConfig":
        return cls(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            ffn_dim=14336, max_seq_len=8192, rope_theta=500000.0, **kw,
        )

    @classmethod
    def bench_410m(cls, **kw: Any) -> "LlamaConfig":
        return cls(
            vocab_size=32000, dim=1024, n_layers=24, n_heads=16, n_kv_heads=16,
            ffn_dim=2816, max_seq_len=2048, **kw,
        )

    @classmethod
    def bench_1b4(cls, **kw: Any) -> "LlamaConfig":
        return cls(
            vocab_size=32000, dim=2048, n_layers=24, n_heads=16, n_kv_heads=16,
            ffn_dim=5504, max_seq_len=2048, **kw,
        )

    @classmethod
    def tiny(cls, **kw: Any) -> "LlamaConfig":
        """Test-size config (CPU-fast)."""
        kw.setdefault("dtype", torch.float32)
        kw.setdefault("remat", False)
        return cls(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=64, **kw,
        )

    @classmethod
    def tiny_moe(cls, **kw: Any) -> "LlamaConfig":
        kw.setdefault("n_experts", 4)
        return cls.tiny(**kw)

    @classmethod
    def bench_moe(cls, **kw: Any) -> "LlamaConfig":
        kw.setdefault("n_experts", 8)
        return cls.bench_410m(**kw)


# --- parameter tree -----------------------------------------------------------


def param_shapes(cfg: LlamaConfig) -> Params:
    """The parameter tree's shapes, keyed as :func:`init_params` keys it."""
    d, hd, L, F, E = cfg.dim, cfg.head_dim, cfg.n_layers, cfg.ffn_dim, cfg.n_experts
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    if cfg.is_moe:
        ffn = {"router": (L, d, E), "w1": (L, E, d, F), "w3": (L, E, d, F),
               "w2": (L, E, F, d)}
    else:
        ffn = {"w1": (L, d, F), "w3": (L, d, F), "w2": (L, F, d)}
    return {
        "tok_emb": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (L, d), "wq": (L, d, nq), "wk": (L, d, nkv),
            "wv": (L, d, nkv), "wo": (L, nq, d), "ffn_norm": (L, d), **ffn,
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> Params:
    """Random parameters in the reference layout: every matrix a normal
    scaled by ``1/sqrt(fan_in)`` (the reference's ``dense``), norms ones.
    Draws come from ``generator`` (on ``device``), so they are not the
    reference's numbers; parity tests carry the reference's tree across
    with ``models.convert.params_from_numpy`` instead. ``device=None``
    means CUDA, and raises without it."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)

    def dense(shape: tuple[int, ...], fan_in: int, dtype=cfg.dtype) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)

    layers: Params = {}
    for name, shape in shapes["layers"].items():
        if name.endswith("_norm"):
            layers[name] = torch.ones(shape, dtype=cfg.dtype, device=device)
        elif name == "router":  # routing statistics stay float32
            layers[name] = dense(shape, cfg.dim, torch.float32)
        else:
            layers[name] = dense(shape, shape[-2])
    return {
        "tok_emb": dense(shapes["tok_emb"], cfg.dim),
        "layers": layers,
        "final_norm": torch.ones(shapes["final_norm"], dtype=cfg.dtype,
                                 device=device),
        "lm_head": dense(shapes["lm_head"], cfg.dim),
    }


# --- building blocks ----------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to ``x``'s dtype, then scale."""
    x32 = x.float()
    rms = torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def rope_freqs(cfg: LlamaConfig, device: str | torch.device = "cpu") -> torch.Tensor:
    """Rotary frequency vector ``[head_dim/2]`` float32."""
    half = cfg.head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                  device=device), exps)


def rope_table(cfg: LlamaConfig, seq_len: int, offset: int = 0,
               device: str | torch.device = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[seq, head_dim/2]`` float32."""
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)
    angles = pos[:, None] * rope_freqs(cfg, device)[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, H, hd]`` rotated in the half-split form (first half paired
    with second half, not HF's interleaved pairs); same dtype out."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


__all__ = [
    "LlamaConfig", "Params", "apply_rope", "init_params", "param_shapes",
    "rms_norm", "rope_freqs", "rope_table",
]
