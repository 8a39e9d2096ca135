"""Llama-family decoder configuration, parameters and building blocks, in
PyTorch.

The counterpart of ``tony_tpu/models/llama.py``. The parameter tree keeps
that module's layout exactly, so one numpy tree loads into both packages
(``models/convert.py``):

- a plain dict of tensors, per-layer tensors stacked on axis 0 (``[L, ...]``);
- projections are ``x @ w`` with ``w`` of shape ``[in, out]``;
- norm statistics and RoPE angles in float32, everything else in
  ``cfg.dtype``.

The serving path (``serve/engine.py``) uses the parameters and the rotary
helpers; the training path (``train/trainer.py``) uses the forward below:
the layer loop with its remat policies, the flash attention kernels
(``ops/attention.py``) and the chunked CE head (``ops/fused_ce.py``).

Remat. A layer under ``cfg.remat`` runs inside
``torch.utils.checkpoint`` with a selective-checkpoint policy that keeps
the reference's named save points: ``attn_qkv`` (q/k/v after rope),
``flash_res`` (the flash kernel's out and lse, kept by saving the kernel's
custom op), ``attn_out`` and ``ffn_gate``. Everything else is recomputed
in the backward, so under ``save_attn_kernel`` the projections and the FFN
run again but the flash forward kernel never does. MoE layers
(``n_experts > 0``) run ``parallel/moe.py``'s ``moe_block`` in place of the
dense FFN (its grouped matmuls recomputed in the backward, as the FFN is)
and add ``moe_aux_coef`` times the layers' mean aux loss to the loss.
The reference's two matmul policies select aten ops instead of tags:
``dots`` (``dots_with_no_batch_dims_saveable``) saves the ``mm`` outputs,
the trunk projections and the router, and ``checkpoint_dots`` also the
batched ``bmm`` ones (the plain attention's einsums); both leave out the
FFN's w2 product, which only feeds the residual add, as JAX's partial
evaluation does.

Meshes. :func:`logical_axes` names every parameter dimension as the
reference does; ``parallel/sharding.py`` turns the names into each rank's
blocks. With ``overlap_impl`` set, a trunk projection whose weight the
rules shard over fsdp runs through the decomposed ring
(``ops/overlap.py`` ``overlap_matmul``, the weight this rank's shard);
anywhere the ring does not apply it is the plain matmul over the weight
the trainer gathered. MoE layers over a mesh take the router's global
statistics and, at ep above 1, the expert-parallel dispatch with its
blocking or overlapped combine (``parallel/moe.py``).

tp and sp (the default mesh's axes, as the reference's hooks read them;
``train/trainer.py`` sets the mesh). At tp above 1 a rank holds its tp
block of the wide dims and the trunk is Megatron's: wq, wk, wv, w1 and w3
column-parallel after :func:`~tony_tpu_torch.parallel.dist.copy_to_tp`,
wo and w2 row-parallel before
:func:`~tony_tpu_torch.parallel.dist.reduce_from_tp`, attention on the
rank's heads. Where tp does not divide the kv heads the trainer hands the
trunk wk and wv whole, and each local query head takes the kv head it
reads (the reference expands K/V to full width there). At sp above 1 a
rank holds its block of the sequence: RoPE starts at the block's offset
and the attention hook decides how the blocks meet (``dot`` and
``flash`` gather the sequence, ``ring`` and ``ring_flash`` rotate K/V
around the sp ring, ``ulysses`` trades sequence for heads by two
all-to-alls; ``parallel/ring_attention.py``, ``parallel/ulysses.py``).

Pipeline stages (pp above 1, ``train/trainer.py``) run a block of the
stacked layers through :func:`run_layers` with the RoPE table of
:func:`rope_for`, as the one-device trunk does; the ring, ring_flash and
Ulysses hooks never run inside a stage (the trainer refuses them first).
"""

from __future__ import annotations

import contextvars
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.parallel import dist as pdist

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

    @property
    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only top_k experts fire), the
        N of 6 * N FLOPs accounting."""
        if not self.is_moe:
            return self.n_params
        inactive = 3 * (self.n_experts - self.moe_top_k) * self.dim * self.ffn_dim
        return self.n_params - self.n_layers * inactive

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


def logical_axes(cfg: LlamaConfig) -> Params:
    """The tree of :func:`param_shapes` with each leaf's logical axis
    names (the reference's ``logical_axes``): wide dims (heads, ffn,
    vocab) on ``tp``, the model dim on ``fsdp`` under the default rules;
    the stacked-layer dim is never sharded."""
    if cfg.is_moe:
        ffn = {"router": ("layers", "embed", "expert"),
               "w1": ("layers", "expert", "embed", "ffn"),
               "w3": ("layers", "expert", "embed", "ffn"),
               "w2": ("layers", "expert", "ffn", "embed")}
    else:
        ffn = {"w1": ("layers", "embed", "ffn"), "w3": ("layers", "embed", "ffn"),
               "w2": ("layers", "ffn", "embed")}
    return {
        "tok_emb": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "norm"), "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"), "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"), "ffn_norm": ("layers", "norm"), **ffn,
        },
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
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


# --- named save points ----------------------------------------------------------


@torch.library.custom_op("tony_tpu_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    # a custom op's output may not alias its input: the tag is a copy
    return x.clone()


torch.library.register_autograd(
    "tony_tpu_torch::checkpoint_name",
    lambda ctx, grad: (grad, None),
)

CHECKPOINT_NAME_OP = torch.ops.tony_tpu_torch.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` as the save point ``name`` (the reference's
    ``jax.ad_checkpoint.checkpoint_name``): a remat policy that lists the
    name keeps the tagged tensor instead of recomputing it."""
    return _checkpoint_name(x, name)


def _no_tag(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


# save points each policy keeps (the reference's save_only_these_names)
_POLICY_NAMES: dict[str, tuple[str, ...]] = {
    "nothing": (),
    "save_attn": ("attn_out",),
    "save_gate": ("ffn_gate",),
    "save_attn_gate": ("attn_out", "ffn_gate"),
    "save_attn_kernel": ("attn_qkv", "flash_res"),
    "save_attn_kernel_gate": ("attn_qkv", "flash_res", "ffn_gate"),
    "save_flash_gate": ("flash_res", "ffn_gate"),
}


# the aten matmuls a layer's forward reaches (``x @ w`` over ``[B, S, D]``
# folds to ``mm``; an einsum with batch dims, as the plain attention's over
# b and h, to ``bmm``): JAX's dot_general with and without batch dims
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCH_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
# the reference's jax.checkpoint_policies that save matmul outputs:
# 'dots' is dots_with_no_batch_dims_saveable (the trunk projections and
# the router are products without batch dims, so they are saved; the
# attention einsums carry b and h and are recomputed, as are the flash
# and grouped-matmul kernels, which are no dots), 'checkpoint_dots' saves
# every matmul output
_DOT_POLICIES: dict[str, tuple] = {
    "dots": _NO_BATCH_DOTS,
    "checkpoint_dots": _NO_BATCH_DOTS + _BATCH_DOTS,
}
# set around a product the backward never reads (the FFN's w2 output only
# feeds the residual add): JAX's partial evaluation leaves it out of the
# saved set, so the matmul policies do too, where a selective-checkpoint
# policy would otherwise store every product it names
_RESIDUAL_ONLY: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "residual_only", default=False)


def _remat_policy(name: str) -> Callable:
    """The selective-checkpoint policy for ``cfg.remat_policy``: MUST_SAVE
    for the tags it names (and for the flash and ring-flash forward ops
    under ``flash_res``), or under ``dots`` / ``checkpoint_dots`` for the
    matmul ops that policy saves; recompute for everything else."""
    if name in _DOT_POLICIES:
        saved = _DOT_POLICIES[name]

        def dot_policy(ctx, op, *args, **kwargs):
            if op in saved and not _RESIDUAL_ONLY.get():
                return CheckpointPolicy.MUST_SAVE
            return CheckpointPolicy.PREFER_RECOMPUTE

        return dot_policy
    if name not in _POLICY_NAMES:
        raise ValueError(f"unknown remat_policy {name!r} (expected "
                         f"{sorted(_POLICY_NAMES) + sorted(_DOT_POLICIES)})")
    names = frozenset(_POLICY_NAMES[name])
    from tony_tpu_torch.ops.attention import FLASH_FWD_OP
    from tony_tpu_torch.parallel.ring_attention import RING_FLASH_FWD_OP

    def policy(ctx, op, *args, **kwargs):
        if op == CHECKPOINT_NAME_OP and args[1] in names:
            return CheckpointPolicy.MUST_SAVE
        if op in (FLASH_FWD_OP, RING_FLASH_FWD_OP) and "flash_res" in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


# --- training forward ---------------------------------------------------------


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: LlamaConfig | None = None) -> torch.Tensor:
    """Plain causal attention, float32 softmax; q/k/v ``[B, S, H, hd]``
    with as many kv heads as query heads."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    S = q.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal, scores * scale, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _get_attention(cfg: LlamaConfig) -> Callable:
    if cfg.attention_impl == "dot":
        # over the whole sequence where the default mesh splits it over sp,
        # as GSPMD runs the reference's
        from tony_tpu_torch.ops.attention import sequence_gathered

        return functools.partial(sequence_gathered, dot_attention)
    if cfg.attention_impl == "flash":
        from tony_tpu_torch.ops.attention import sharded_flash_attention

        return sharded_flash_attention
    if cfg.attention_impl == "ring":
        from tony_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention
    if cfg.attention_impl == "ring_flash":
        from tony_tpu_torch.parallel.ring_attention import ring_flash_attention

        return ring_flash_attention
    if cfg.attention_impl == "ulysses":
        from tony_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention
    raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


def mesh_axis(name: str):
    """The default mesh's axis ``name`` when it spans more than one rank,
    else None: the trunk then runs as on one device."""
    from tony_tpu_torch.parallel.mesh import get_default_mesh

    mesh = get_default_mesh()
    if mesh is None:
        return None
    axis = mesh.axis(name)
    return axis if axis.size > 1 else None


def _proj(x: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig,
          axes: tuple[str | None, ...]) -> torch.Tensor:
    """One trunk projection ``x [B, S, D] @ w``. With ``cfg.overlap_impl``
    set, the fsdp weight all-gather streams chunk by chunk through the
    decomposed ring (``ops/overlap.py``), ``w`` this rank's shard; ``axes``
    are the weight's per-layer logical axes, and which dim rides the ring
    is read off the sharding rules. The plain matmul wherever the
    decomposition does not apply, as in the reference."""
    if cfg.overlap_impl:
        from tony_tpu_torch.ops.overlap import overlap_matmul
        from tony_tpu_torch.parallel.sharding import overlap_gather_dim

        gd = overlap_gather_dim(axes)
        if gd is not None:
            y = overlap_matmul(x, w, gather_dim=gd, impl=cfg.overlap_impl)
            if y is not None:
                return y
    return x @ w


def attention_block(x: torch.Tensor, lp: Params, cfg: LlamaConfig,
                    cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Attention on this rank's heads: all of them on one device, its tp
    block of them at tp above 1 (read off the weights' widths)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    tag = checkpoint_name if cfg.remat else _no_tag
    tp = mesh_axis("tp")
    if tp is not None:
        x = pdist.copy_to_tp(x, tp)
    q = _proj(x, lp["wq"], cfg, ("embed", "heads"))
    k = _proj(x, lp["wk"], cfg, ("embed", "kv_heads"))
    v = _proj(x, lp["wv"], cfg, ("embed", "kv_heads"))
    H = q.shape[-1] // hd
    q = tag(apply_rope(q.reshape(B, S, H, hd), cos, sin), "attn_qkv")
    k = tag(apply_rope(k.reshape(B, S, -1, hd), cos, sin), "attn_qkv")
    v = tag(v.reshape(B, S, -1, hd), "attn_qkv")
    if tp is not None and cfg.n_kv_heads % tp.size:
        # every kv head computed: each local query head takes the one it reads
        rep = cfg.n_heads // cfg.n_kv_heads
        idx = torch.arange(tp.index * H, (tp.index + 1) * H, device=q.device) // rep
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    # GQA: the flash kernels read each kv head H / Hkv times by index; the
    # plain impls get the expanded tensors
    if k.shape[2] != H and cfg.attention_impl not in ("flash", "ring_flash"):
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = tag(_get_attention(cfg)(q, k, v, cfg), "attn_out")
    y = _proj(out.reshape(B, S, H * hd), lp["wo"], cfg, ("heads", "embed"))
    return y if tp is None else pdist.reduce_from_tp(y, tp)


def ffn_block(x: torch.Tensor, lp: Params, cfg: LlamaConfig) -> torch.Tensor:
    """The SwiGLU FFN on this rank's ffn columns (its tp block at tp above
    1)."""
    tag = checkpoint_name if cfg.remat else _no_tag
    tp = mesh_axis("tp")
    if tp is not None:
        x = pdist.copy_to_tp(x, tp)
    gate = tag(F.silu(_proj(x, lp["w1"], cfg, ("embed", "ffn")))
               * _proj(x, lp["w3"], cfg, ("embed", "ffn")), "ffn_gate")
    token = _RESIDUAL_ONLY.set(True)
    try:
        y = _proj(gate, lp["w2"], cfg, ("ffn", "embed"))
    finally:
        _RESIDUAL_ONLY.reset(token)
    return y if tp is None else pdist.reduce_from_tp(y, tp)


def moe_ffn_block(x: torch.Tensor, lp: Params, cfg: LlamaConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN: (y, aux_loss). See ``tony_tpu_torch.parallel.moe``."""
    from tony_tpu_torch.parallel.moe import MoEConfig, moe_block

    mcfg = MoEConfig(
        dim=cfg.dim, ffn_dim=cfg.ffn_dim, n_experts=cfg.n_experts,
        top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
        dispatch=cfg.moe_dispatch, group_block=cfg.moe_group_block,
        gmm_impl=cfg.moe_gmm_impl, overlap_impl=cfg.moe_overlap_impl,
        overlap_chunk=cfg.moe_overlap_chunk,
    )
    return moe_block({name: lp[name] for name in ("router", "w1", "w3", "w2")},
                     x, mcfg)


def transformer_block(x: torch.Tensor, lp: Params, cfg: LlamaConfig,
                      cos: torch.Tensor, sin: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer: (x, lp) -> (x', aux_loss); aux is 0 for dense."""
    h = x + attention_block(rms_norm(x, lp["attn_norm"], cfg.norm_eps), lp, cfg,
                            cos, sin)
    normed = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.is_moe:
        delta, aux = moe_ffn_block(normed, lp, cfg)
    else:
        delta = ffn_block(normed, lp, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + delta, aux


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather ``[B, S] -> [B, S, D]``."""
    return F.embedding(tokens.long(), params["tok_emb"])


def rope_for(cfg: LlamaConfig, seq_len: int, device: str | torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RoPE table of this rank's ``seq_len`` positions: from 0, or
    under sp from its block's offset."""
    sp = mesh_axis("sp")
    offset = sp.index * seq_len if sp is not None else 0
    return rope_table(cfg, seq_len, offset, device=device)


def run_layers(x: torch.Tensor, layers: Params, block: Callable
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` through the stacked ``layers`` in turn, ``block(x, lp) -> (x,
    aux)``; returns (x, the layers' aux summed). Layer i reads the i-th
    slice of each stacked leaf (one ``unbind`` per leaf, so the backward
    stacks the layer grads once); the stack may be a pipeline stage's
    block of the layers."""
    unbound = {name: t.unbind(0) for name, t in layers.items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(next(iter(layers.values())).shape[0]):
        x, a = block(x, {name: t[i] for name, t in unbound.items()})
        aux = aux + a
    return x, aux


def hidden_states_with_aux(params: Params, tokens: torch.Tensor,
                           cfg: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (post-final-norm hidden ``[B, S, D]``, aux
    loss). The trunk without the vocab projection, which the fused CE head
    consumes directly."""
    x = embed_tokens(params, tokens)
    # under sp the rows are this rank's block of the sequence
    cos, sin = rope_for(cfg, tokens.shape[1], x.device)
    if cfg.remat:
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _remat_policy(cfg.remat_policy))

        def block(x, lp):
            return checkpoint(transformer_block, x, lp, cfg, cos, sin,
                              use_reentrant=False, context_fn=context)
    else:
        def block(x, lp):
            return transformer_block(x, lp, cfg, cos, sin)
    x, aux = run_layers(x, params["layers"], block)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux / cfg.n_layers


def forward_with_aux(params: Params, tokens: torch.Tensor, cfg: LlamaConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (logits ``[B, S, vocab]`` float32, aux loss)."""
    x, aux = hidden_states_with_aux(params, tokens, cfg)
    return (x @ params["lm_head"]).float(), aux


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """tokens ``[B, S]`` -> logits ``[B, S, vocab]`` float32."""
    return forward_with_aux(params, tokens, cfg)[0]


def ce_tokens(h: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
              cfg: LlamaConfig) -> torch.Tensor:
    """Per-token CE ``[B, S]`` float32 from post-norm hidden states,
    dispatched on ``cfg.ce_impl`` ('dense' is the full-logits oracle)."""
    from tony_tpu_torch.ops.fused_ce import fused_ce_tokens, reference_ce_tokens

    if cfg.ce_impl == "dense":
        return reference_ce_tokens(h, lm_head, targets)
    return fused_ce_tokens(h, lm_head, targets, cfg)


def loss_and_aux(params: Params, inputs: torch.Tensor, targets: torch.Tensor,
                 cfg: LlamaConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, aux): the loss of :func:`loss_from_pairs` and the layers'
    mean MoE aux loss inside it (0 for dense configs), both float32."""
    h, aux = hidden_states_with_aux(params, inputs, cfg)
    ce = ce_tokens(h, params["lm_head"], targets, cfg).mean()
    if cfg.is_moe:
        ce = ce + cfg.moe_aux_coef * aux
    return ce, aux


def loss_from_pairs(params: Params, inputs: torch.Tensor, targets: torch.Tensor,
                    cfg: LlamaConfig) -> torch.Tensor:
    """Mean cross-entropy (float32) of predicting ``targets [B, S]`` from
    ``inputs [B, S]`` (pre-shifted pairs), plus ``moe_aux_coef`` times the
    layers' mean aux loss for MoE configs, as the reference adds it."""
    return loss_and_aux(params, inputs, targets, cfg)[0]


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy over tokens ``[B, S+1]`` (shifts inside)."""
    return loss_from_pairs(params, tokens[:, :-1], tokens[:, 1:], cfg)


def train_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token: 6 * N_active plus the causal
    attention score/value matmuls (12 * L * D * S / 2)."""
    return 6.0 * cfg.n_active_params + 6.0 * cfg.n_layers * cfg.dim * seq_len


__all__ = [
    "CHECKPOINT_NAME_OP", "LlamaConfig", "Params", "apply_rope", "ce_tokens",
    "checkpoint_name", "dot_attention", "embed_tokens", "forward",
    "forward_with_aux", "hidden_states_with_aux", "init_params", "logical_axes",
    "loss_and_aux", "loss_fn", "loss_from_pairs", "mesh_axis", "moe_ffn_block",
    "param_shapes", "rms_norm", "rope_for", "rope_freqs", "rope_table", "run_layers",
    "train_flops_per_token", "transformer_block",
]
