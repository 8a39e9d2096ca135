"""Fused chunked cross-entropy head: per-token loss from hidden states
without ever holding ``[N, V]`` logits or dlogits.

The counterpart of ``tony_tpu/ops/fused_ce.py``'s ``scan`` path, the one
every training preset uses:

- the forward walks the vocabulary in ``vocab_chunk`` columns, keeping an
  online logsumexp ``(m, s)`` and the target logit per row, so at most one
  ``[N, Vc]`` float32 logits block is live (the reference's ``_scan_fwd``);
- the backward recomputes each chunk's logits from the saved ``(h, lse)``,
  forms ``dlogits = (softmax - onehot) * g`` for that chunk only, and
  accumulates ``dh`` in float32 and writes the chunk's ``dW`` columns once
  (``_scan_bwd``);
- the tail chunk (``V % vocab_chunk`` columns) is one more, narrower step.

The chunk products are plain matrix products that the reference leaves to
XLA outside Pallas, so they go to cuBLAS here. Their logits are float32
(the reference's ``preferred_element_type=float32``): bfloat16 operands on
a CUDA device go through ``torch.mm(..., out_dtype=torch.float32)`` where
this torch has it, else through float32 operands
(:func:`f32_matmul_route` says which). The backward's bfloat16 products
round dlogits to bfloat16 for the tensor cores, as a TPU's default matmul
precision does with its float32 operands.

``ce_impl="pallas"`` (the reference's three CE kernels) is not ported yet.
"""

from __future__ import annotations

import torch

_NEG = -0.7 * torch.finfo(torch.float32).max


def f32_matmul_route(device: torch.device | str, dtype: torch.dtype) -> str:
    """How :func:`_mm_f32` multiplies ``dtype`` operands on ``device``:
    ``"float32"`` (float32 operands and sums), ``"mm out_dtype"`` (low
    precision operands, float32 output from one cuBLAS call) or
    ``"upcast"`` (low-precision operands cast to float32 first)."""
    if dtype == torch.float32:
        return "float32"
    if torch.device(device).type == "cuda" and hasattr(torch.ops.aten.mm, "dtype"):
        return "mm out_dtype"
    return "upcast"


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result (operands of one dtype)."""
    route = f32_matmul_route(a.device, a.dtype)
    if route == "float32":
        return a @ b
    if route == "mm out_dtype":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_fwd(m, s, tl, logits, start, tgt):
    """Online-logsumexp update for one ``[N, Vc]`` float32 logits block."""
    m_new = torch.maximum(m, logits.amax(dim=1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
    rel = tgt - start
    in_chunk = (rel >= 0) & (rel < logits.shape[1])
    got = logits.gather(1, rel.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, got, tl)


def _chunks(V: int, vc: int):
    """(start, stop) of each vocab chunk: full ones, then the tail."""
    vc = min(vc, V)
    nfull = V // vc
    out = [(j * vc, (j + 1) * vc) for j in range(nfull)]
    if V % vc:
        out.append((nfull * vc, V))
    return out


def _scan_fwd(h, w, tgt, vc):
    """h ``[N, D]``, w ``[D, V]``, tgt ``[N]`` -> (lse, target logit), both
    ``[N]`` float32."""
    N = h.shape[0]
    m = torch.full((N,), _NEG, dtype=torch.float32, device=h.device)
    s = torch.zeros(N, dtype=torch.float32, device=h.device)
    tl = torch.zeros(N, dtype=torch.float32, device=h.device)
    for start, stop in _chunks(w.shape[1], vc):
        m, s, tl = _chunk_fwd(m, s, tl, _mm_f32(h, w[:, start:stop]), start, tgt)
    return m + torch.log(s), tl


def _scan_bwd(h, w, tgt, lse, g, vc):
    """(dh in h's dtype, dw in w's dtype): each chunk's dW columns written
    once, dh accumulated in float32."""
    N = h.shape[0]
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    rows = torch.arange(N, device=h.device)
    low = h.dtype != torch.float32
    for start, stop in _chunks(w.shape[1], vc):
        wc = w[:, start:stop]
        dl = torch.exp(_mm_f32(h, wc) - lse[:, None])       # softmax
        rel = tgt - start
        hit = (rel >= 0) & (rel < stop - start)
        dl[rows[hit], rel[hit]] -= 1.0                      # - onehot(target)
        dl *= g[:, None]
        if low:
            dl = dl.to(h.dtype)
        dh += _mm_f32(dl, wc.t())
        dw[:, start:stop] = _mm_f32(h.t(), dl).to(w.dtype)
    return dh.to(h.dtype), dw


class _FusedCE(torch.autograd.Function):
    """Per-token CE ``lse - target_logit`` with the scan backward; saves
    ``(h, w, tgt, lse)``, never logits."""

    @staticmethod
    def forward(ctx, h, w, tgt, vc):
        lse, tl = _scan_fwd(h, w, tgt, vc)
        ctx.save_for_backward(h, w, tgt, lse)
        ctx.vc = vc
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        h, w, tgt, lse = ctx.saved_tensors
        dh, dw = _scan_bwd(h, w, tgt, lse, g.float(), ctx.vc)
        return dh, dw, None, None


def fused_ce_tokens(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    cfg=None, *, impl: str | None = None,
                    vocab_chunk: int | None = None, block_n: int | None = None,
                    block_v: int | None = None) -> torch.Tensor:
    """Per-token cross-entropy ``[B, S]`` float32 from hidden states ``h
    [B, S, D]``, lm_head ``w [D, V]`` and ``targets [B, S]``, without full
    logits. Knobs come from ``cfg.ce_impl`` / ``cfg.ce_vocab_chunk`` when a
    config is passed (kwargs win); ``block_n``/``block_v`` are the pallas
    path's and are not read. Callers take the mean."""
    if impl is None:
        impl = getattr(cfg, "ce_impl", None) or "scan"
    if vocab_chunk is None:
        vocab_chunk = getattr(cfg, "ce_vocab_chunk", None) or 4096
    if impl == "pallas":
        raise NotImplementedError(
            "ce_impl='pallas' needs the fused-CE kernels (TPU kernels 4-6: "
            "_ce_fwd_kernel, _ce_dh_kernel, _ce_dw_kernel), not ported yet "
            "(ROADMAP queue 1); use ce_impl='scan'"
        )
    if impl != "scan":
        raise ValueError(f"unknown ce_impl {impl!r} (expected scan | pallas)")
    B, S, D = h.shape
    if w.shape[0] != D:
        raise ValueError(f"lm_head {tuple(w.shape)} does not match hidden dim {D}")
    if tuple(targets.shape) != (B, S):
        raise ValueError(f"targets {tuple(targets.shape)} != batch/seq {(B, S)}")
    losses = _FusedCE.apply(h.reshape(B * S, D), w, targets.reshape(B * S).long(),
                            int(vocab_chunk))
    return losses.reshape(B, S)


def reference_ce_tokens(h: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Full-logits logsumexp oracle (materialises ``[B, S, V]`` float32)."""
    B, S, D = h.shape
    logits = _mm_f32(h.reshape(B * S, D), w).reshape(B, S, -1)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - tgt


__all__ = ["f32_matmul_route", "fused_ce_tokens", "reference_ce_tokens"]
