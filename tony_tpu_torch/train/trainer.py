"""Training-step construction on one device: state, optimizer, update.

The counterpart of ``tony_tpu/train/trainer.py`` for a single device. The
reference's optax chain (``clip_by_global_norm`` then ``adamw`` on a
``warmup_cosine_decay_schedule``) is written out here as plain functions
on tensors, keeping its semantics:

- the schedule reads the update count before it is incremented, so step
  0's learning rate is 0 under warmup;
- Adam's bias correction uses ``count + 1``;
- clipping leaves the grads as they are when their global norm is below
  ``grad_clip``, else scales them by ``grad_clip / norm``;
- weight decay applies to every parameter, norms and embeddings too;
- the first moment is stored in ``mu_dtype`` and the second in the
  parameter's dtype.

Arithmetic inside one update runs in float32 and rounds once into each
stored tensor; parameters, grads and moments are updated in place. Grads
come in the parameters' dtype and the loss is the float32 mean over
``B * S`` tokens (plus the aux term for MoE configs). MoE trees go through
the same chain leaf by leaf: the ``[L, E, D, F]`` expert weights and the
float32 router, whose second moment is float32 with it.

Meshes (dp, pp, fsdp, ep, tp and sp; the counterpart of the reference's
GSPMD step). Each rank holds its blocks of the parameters and moments under the
rules' specs (:func:`state_specs`, ``parallel/sharding.py``) and its block
of the global batch: rows split over (dp, fsdp, ep), the sequence over
sp. tp splits no rows: every rank of a tp group trains on the same ones.
In the step:

- a weight is all-gathered blocking over each axis that splits it before
  the forward, as GSPMD would, and its gradient reduce-scattered back to
  the block in the backward, except where its consumer takes the block
  itself: the trunk projections the fsdp ring takes (``ops/overlap.py``,
  with ``overlap_impl`` set and the mesh the default one; the ring's
  backward reduce-scatters their gradients), the MoE expert weights at ep
  above 1, whose ep block is this rank's experts (their fsdp split still
  takes the blocking gather), and at tp above 1 every trunk projection's
  tp block (Megatron's column- and row-parallel trunk, ``models/llama.py``);
- over tp the weights the trunk does not take as blocks are gathered for
  a consumer every tp rank runs alike (tok_emb, lm_head: the reference
  pins a replicated table and its pallas CE hook takes W whole), their
  gradients cut back without a sum (``parallel/dist.py``
  :func:`~tony_tpu_torch.parallel.dist.gather_whole`); wk and wv, where
  tp does not divide the kv heads, are gathered and their gradients
  summed, each rank's query heads reading their own kv heads;
- the batch axes are dp, fsdp, ep and sp: the loss is scaled by their
  size, and a gradient is summed over each of fsdp, ep and sp that does
  not split its leaf, and every gradient over dp: one all-reduce, or with
  ``grad_bucket_bytes > 0`` and dp > 1 the reference's manual-dp path
  (each dp shard's mean loss, grads scaled by 1/dp, ``bucketed_psum``
  buckets in leaf order). tp is not a batch axis: no scale and no sum;
- ``global_norm`` sums the squares across the blocks, each block once
  (a leaf that an axis does not split counted on that axis's index 0),
  with one all-reduce over each of fsdp, ep, tp and sp, and AdamW updates
  the local blocks.

A step over a mesh with tp or sp above 1, or of a MoE config, reads the
mesh from the default mesh, as the trunk, its attention hooks and
``moe_block`` do (``fit()`` sets it): the router's statistics are the
global batch's, and ep above 1 runs the expert-parallel dispatch.

pp above 1 (the reference's pipeline loss, ``parallel/pipeline.py``):
the rules become :func:`pp_rules`, so a rank holds its stage's ``n_layers
/ pp`` layers, and the loss is :func:`pp_loss_from_pairs` (GPipe) or
:func:`pp_1f1b_loss_from_pairs` (1F1B) over ``n_microbatches`` (default
``2 * pp``) microbatches of the rank's rows. Every pp rank of a (dp,
fsdp, ep, sp) block holds the same rows: pp is not a batch axis, so no
loss scale. Inside a stage the weights take the blocking gathers (the
fsdp ring declines there, as the reference's does in a manual region),
and each leaf's gradient over pp is its own case: a layer leaf is this
stage's block, summed nowhere over pp; tok_emb's is whole on every pp
rank, as the pipeline broadcasts the first stage's input gradient; the
head's is the same on every pp rank (GPipe runs it alike on the
broadcast outputs; 1F1B broadcasts the last stage's). ``global_norm``
counts a leaf pp does not split on pp index 0 only.

MoE at tp above 1: each rank holds its ``F / tp`` block of its experts'
ffn dim (the expert leaves keep their tp block as the trunk projections
do), and ``moe_block`` sums the expert FFN over tp; the router is whole
and its gradient whole on every tp rank, so it is summed nowhere over tp
and the global norm counts it on tp index 0 only.

Pipeline stages refuse the ring, ring_flash and Ulysses attentions, and
1F1B refuses MoE, with the reference's messages.

Health monitors (``monitors``; None means "on the steps an armed
sentinel reads", ``obs/health.py`` ``due``, where the reference's None
means "a sentinel is armed": the other steps' would go unread): the step
adds the reference's ``health/...`` metrics,
fresh float32 device tensors (the fingerprint int64). AdamW updates in
place, so ``|Δθ|²`` is accumulated inside its chunk loop and the
parameters' norm and nonfinite count are taken after the update. Over a
mesh every monitor is the global batch's: each leaf's block counted once,
as the global norm counts it; the grads' nonfinite count and the
per-layer squares (placed at each pp stage's layers of the whole stack)
ride the global norm's all-reduce, the batch fingerprint rides the loss
mean's as two exact 16-bit float32 halves of each rank's positional
partial sum (positions from ``train/data.py`` ``rank_rows``), and the
post-update sums take one more all-reduce. ``TONY_CHAOS_NAN_STEP`` adds
NaN to the reported loss from that step on, monitors or not, as the
reference does.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models import llama
from tony_tpu_torch.obs import health
from tony_tpu_torch.ops.overlap import bucketed_psum
from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.mesh import Mesh, get_default_mesh, manual_region
from tony_tpu_torch.parallel.pipeline import (
    microbatch, pipeline_local, pipeline_train_1f1b, unmicrobatch,
)
from tony_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, Rules, entry_axes, local_shape, mesh_rules, pp_rules, shard_tree,
    spec_for, tree_specs,
)
from tony_tpu_torch.train.data import rank_rows

Params = dict[str, Any]

_CHUNK = 1 << 24   # elements per optimizer chunk: bounds the float32 temporaries


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """The tensors of a nested dict, in its insertion order."""
    out: list[torch.Tensor] = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn: Callable, tree: Params) -> Params:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32 (optax's
    ``global_norm``)."""
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32)
                         for t in tensors])
    return torch.linalg.vector_norm(norms)


@dataclass
class TrainState:
    step: int
    params: Params
    opt_state: dict   # {"count": int, "mu": params-shaped, "nu": params-shaped}


def _dtype(d: torch.dtype | str) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


@dataclass(frozen=True)
class AdamW:
    """``clip_by_global_norm(grad_clip)`` then ``adamw(schedule, b1, b2,
    eps, weight_decay, mu_dtype)`` with ``warmup_cosine_decay_schedule(0,
    lr, warmup_steps, decay_steps)``."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10000
    grad_clip: float = 1.0
    mu_dtype: torch.dtype = torch.float32
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def learning_rate(self, count: int) -> float:
        """Linear warmup from 0, then cosine decay to 0 at
        ``decay_steps``."""
        if count < self.warmup_steps:
            return self.lr * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        t = min(count - self.warmup_steps, span)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype,
                                                      requires_grad=False), params),
            "nu": tree_map(lambda p: torch.zeros_like(p, requires_grad=False), params),
        }

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], opt_state: dict, params: Params,
               grad_norm: torch.Tensor | None = None,
               update_sq_of: list[bool] | None = None) -> torch.Tensor | None:
        """One step, in place on ``params`` and ``opt_state``; ``grads`` in
        ``tree_leaves(params)`` order. With ``update_sq_of`` (a flag per
        leaf) it returns the float32 sum of the squared updates ``Δθ =
        -lr·(u + wd·θ)`` over the flagged leaves, accumulated chunk by chunk
        as the update folds into the parameters (the health monitors'
        ``|Δθ|²``, which no later read could recover); else None."""
        if grad_norm is None:
            grad_norm = global_norm(grads)
        clip = torch.where(grad_norm < self.grad_clip, 1.0,
                           self.grad_clip / grad_norm)
        count = opt_state["count"]
        lr = self.learning_rate(count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        leaves = tree_leaves(params)
        upd_sq = None
        if update_sq_of is not None:
            upd_sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        flags = update_sq_of or [False] * len(leaves)
        for p, g, mu, nu, track in zip(leaves, grads, tree_leaves(opt_state["mu"]),
                                       tree_leaves(opt_state["nu"]), flags):
            for pc, gc, mc, nc in zip(p.view(-1).split(_CHUNK),
                                      g.reshape(-1).split(_CHUNK),
                                      mu.view(-1).split(_CHUNK),
                                      nu.view(-1).split(_CHUNK)):
                g32 = gc.float() * clip
                mc.copy_(self.b1 * mc.float() + (1.0 - self.b1) * g32)
                nc.copy_(self.b2 * nc.float() + (1.0 - self.b2) * g32 * g32)
                u = (mc.float() / bc1) / (torch.sqrt(nc.float() / bc2) + self.eps)
                p32 = pc.float()
                delta = lr * (u + self.weight_decay * p32)
                pc.copy_(p32 - delta)
                if track:
                    upd_sq += torch.linalg.vector_norm(delta).square()
        opt_state["count"] = count + 1
        return upd_sq


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100, decay_steps: int = 10000,
                      grad_clip: float = 1.0,
                      mu_dtype: torch.dtype | str = torch.float32) -> AdamW:
    """The reference's default chain; ``decay_steps`` is raised to
    ``warmup_steps + 1`` as there."""
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 decay_steps=max(decay_steps, warmup_steps + 1),
                 grad_clip=grad_clip, mu_dtype=_dtype(mu_dtype))


# the dense trunk projections (models/llama.py _proj): the fsdp ring takes
# them under overlap_impl, and at tp the trunk runs on their tp blocks; a
# MoE layer's w1/w3/w2 are expert weights, never these
_TRUNK_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
_EXPERT_LEAVES = ("w1", "w3", "w2")
PP_SCHEDULES = ("gpipe", "1f1b")


def _pp_guard(cfg: llama.LlamaConfig, pp: int) -> None:
    """The reference's refusals for a pipeline over ``pp`` stages."""
    if cfg.attention_impl in ("ring", "ring_flash", "ulysses"):
        raise NotImplementedError(
            f"pp + attention_impl={cfg.attention_impl!r} is not supported: "
            "sequence-parallel attention cannot nest inside pipeline stages; "
            "use 'flash' or 'dot' with pp, or sp without pp")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")


def check_1f1b(cfg: llama.LlamaConfig) -> None:
    """The reference's refusal of MoE under the 1F1B schedule."""
    if cfg.is_moe:
        raise NotImplementedError(
            "pp_schedule='1f1b' + MoE not supported (aux loss is not "
            "threaded through the interleaved schedule); use 'gpipe'")


def check_model_mesh(cfg: llama.LlamaConfig, shape: dict[str, int]) -> None:
    """Raise for a model the mesh cannot split: query heads that tp does
    not split, Ulysses with local heads that sp does not split (the
    reference's error), and at pp above 1 the reference's pipeline
    refusals (:func:`_pp_guard`)."""
    tp, sp, pp = shape.get("tp", 1), shape.get("sp", 1), shape.get("pp", 1)
    if pp > 1:
        _pp_guard(cfg, pp)
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} does not split over tp={tp}")
    if cfg.attention_impl == "ulysses" and (cfg.n_heads // tp) % sp:
        raise ValueError(f"n_heads={cfg.n_heads // tp} not divisible by sp size {sp}")


def _sharded(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` spans more than one rank."""
    return mesh is not None and mesh.size > 1


def _check_default_mesh(mesh: Mesh | None) -> None:
    """The trunk reads tp and sp off the default mesh, so a step raises
    when the default mesh spans more than one rank and is not the step's
    own: a mesh left set by the caller would split its model silently."""
    default = get_default_mesh()
    if default is not None and default is not mesh and default.size > 1:
        raise ValueError(
            f"the default mesh ({default.size} ranks) is not this step's mesh, and the "
            "trunk reads tp and sp there: set_default_mesh() to the step's mesh, or to "
            "None for a one-device step")


def state_specs(cfg: llama.LlamaConfig, rules: Rules = DEFAULT_RULES) -> TrainState:
    """Specs for the whole TrainState (the reference's ``state_shardings``):
    the parameters' from their logical axes, the moments mirroring them
    leaf by leaf, the counts replicated. A pp mesh's rules are
    ``pp_rules(rules)`` (``parallel/sharding.py`` ``mesh_rules``)."""
    p = tree_specs(llama.logical_axes(cfg), rules)
    return TrainState(step=(), params=p, opt_state={"count": (), "mu": p, "nu": p})


def _paths(tree: Params, prefix: tuple = ()) -> list[tuple]:
    """The key path of every leaf, in ``tree_leaves`` order."""
    out: list[tuple] = []
    for k, v in tree.items():
        out.extend(_paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)])
    return out


def _at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def make_train_state(cfg: llama.LlamaConfig, optimizer: AdamW, *, seed: int = 0,
                     params: Params | None = None,
                     device: str | torch.device | None = None,
                     mesh: Mesh | None = None, rules: Rules = DEFAULT_RULES) -> TrainState:
    """Step 0: parameters and zeroed moments. ``params``: given, or random
    ones from ``seed`` on ``device`` (``None`` means CUDA, and raises
    without it). Over a ``mesh`` of more than one rank the state is this
    rank's blocks under the rules' specs: random parameters are drawn
    whole (every rank the same numbers) and cut; given ``params`` must be
    the rank's blocks already (``models.convert.shards_from_numpy``). At
    pp above 1 the blocks are ``pp_rules(rules)``'s, as the step's are."""
    sharded = _sharded(mesh)
    specs = state_specs(cfg, mesh_rules(rules, mesh)).params
    if params is None:
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llama.init_params(cfg, gen, device=device)
        if sharded:
            params = shard_tree(params, specs, mesh)
    elif sharded:
        shapes = llama.param_shapes(cfg)
        for path in _paths(params):
            want = local_shape(_at(shapes, path), _at(specs, path), mesh)
            if tuple(_at(params, path).shape) != want:
                raise ValueError(f"{'.'.join(path)}: shape {tuple(_at(params, path).shape)} "
                                 f"is not this rank's block {want}")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


# --- the pipeline loss (pp above 1) -------------------------------------------------


def _ce_head(final_norm: torch.Tensor, lm_head: torch.Tensor, h: torch.Tensor,
             targets: torch.Tensor, cfg: llama.LlamaConfig) -> torch.Tensor:
    """Final norm, lm head and the mean cross-entropy: the one copy both
    pipeline schedules share, through ``llama.ce_tokens``, so
    ``ce_impl="pallas"`` runs the fused CE kernels here too."""
    h = llama.rms_norm(h, final_norm, cfg.norm_eps)
    return llama.ce_tokens(h, lm_head, targets, cfg).mean()


def _pp_stage_fn(cfg: llama.LlamaConfig, cos: torch.Tensor, sin: torch.Tensor) -> Callable:
    """One pipeline stage: this stage's ``[L/P]`` layers over a microbatch
    in turn, returning (y, their aux summed). Under ``cfg.remat`` each
    block is checkpointed saving nothing, whatever ``remat_policy`` says
    (the reference's ``nothing_saveable``): the flash forward re-runs in
    the backward. Each block runs as a manual region, so the fsdp ring
    declines inside it, in the remat recompute too."""

    def block(x, lp):
        with manual_region():
            return llama.transformer_block(x, lp, cfg, cos, sin)

    if cfg.remat:
        plain = block

        def block(x, lp):
            return checkpoint(plain, x, lp, use_reentrant=False)

    return lambda lp_stack, mb: llama.run_layers(mb, lp_stack, block)


def pp_loss_from_pairs(params: Params, inputs: torch.Tensor, targets: torch.Tensor, *,
                       cfg: llama.LlamaConfig, mesh: Mesh, n_microbatches: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The GPipe pipeline loss, ``(loss, aux)`` as ``llama.loss_and_aux``
    gives them: the embedding, the layer stack as pp stages
    (``parallel/pipeline.py`` ``pipeline_local``) over ``n_microbatches``
    microbatches of this rank's rows, then the head on every pp rank alike
    over the broadcast outputs, plus ``moe_aux_coef`` times the layers'
    mean aux (each microbatch's router statistics, averaged over the
    microbatches). Reference: GPipe (arXiv:1811.06965); bubble (P - 1) /
    (M + P - 1)."""
    _pp_guard(cfg, mesh.shape["pp"])
    x = llama.embed_tokens(params, inputs)
    cos, sin = llama.rope_for(cfg, inputs.shape[1], x.device)
    stage = _pp_stage_fn(cfg, cos, sin)
    xs = microbatch(x, n_microbatches)
    axis = mesh.axis("pp")
    if cfg.is_moe:
        h, aux = pipeline_local(stage, params["layers"], xs, axis=axis, with_aux=True)
        aux = aux / cfg.n_layers
    else:
        h = pipeline_local(lambda lp, mb: stage(lp, mb)[0], params["layers"], xs, axis=axis)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ce = _ce_head(params["final_norm"], params["lm_head"], unmicrobatch(h), targets, cfg)
    if cfg.is_moe:
        ce = ce + cfg.moe_aux_coef * aux
    return ce, aux


def pp_1f1b_loss_from_pairs(params: Params, inputs: torch.Tensor, targets: torch.Tensor, *,
                            cfg: llama.LlamaConfig, mesh: Mesh, n_microbatches: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 1F1B pipeline loss, ``(loss, 0)``: the stage decomposition of
    :func:`pp_loss_from_pairs` under the hand-scheduled backward
    (``parallel/pipeline.py`` ``pipeline_train_1f1b``), the head inside
    the last stage so each microbatch's cotangent is seeded as soon as its
    forward is done. O(P) saved activations, where GPipe's are O(M)."""
    check_1f1b(cfg)
    _pp_guard(cfg, mesh.shape["pp"])
    x = llama.embed_tokens(params, inputs)
    cos, sin = llama.rope_for(cfg, inputs.shape[1], x.device)
    stage = _pp_stage_fn(cfg, cos, sin)
    head = {"final_norm": params["final_norm"], "lm_head": params["lm_head"]}
    loss = pipeline_train_1f1b(
        lambda lp, mb: stage(lp, mb)[0],
        lambda hp, y, t: _ce_head(hp["final_norm"], hp["lm_head"], y, t, cfg),
        params["layers"], head, microbatch(x, n_microbatches),
        microbatch(targets, n_microbatches), mesh=mesh)
    return loss, torch.zeros((), dtype=torch.float32, device=x.device)


def _poison(loss: torch.Tensor, step: int, nan_step: int | None) -> torch.Tensor:
    """The numerics chaos seam (``TONY_CHAOS_NAN_STEP``): the reported loss
    plus NaN from step ``nan_step`` on (1-based, persistent like a real
    NaN'd state); the gradients are untouched."""
    if nan_step is not None and step + 1 >= nan_step:
        return loss + float("nan")
    return loss


def _global_positions(inputs: torch.Tensor, mesh: Mesh, rules: Rules,
                      microbatches: int) -> torch.Tensor:
    """The flat positions in the global batch of this rank's ``inputs``
    block, as ``train/data.py`` ``rank_rows`` lays the rows out."""
    b_entry, s_entry = spec_for(("batch", "seq"), rules)
    B = inputs.shape[0] * math.prod(mesh.shape[a] for a in entry_axes(b_entry))
    S = inputs.shape[1] * math.prod(mesh.shape[a] for a in entry_axes(s_entry))
    flat = torch.arange(B * S, dtype=torch.int64).reshape(B, S)
    return rank_rows(flat, mesh, rules, microbatches).to(inputs.device)


def _sharded_step(cfg: llama.LlamaConfig, optimizer: AdamW, mesh: Mesh, rules: Rules,
                  grad_bucket_bytes: int, n_microbatches: int, pp_schedule: str,
                  monitors_due: Callable[[], bool], nan_step: int | None) -> Callable:
    """The step over a dp x pp x fsdp x ep x tp x sp mesh (see the
    module's docstring)."""
    fsdp, dp, ep = mesh.axis("fsdp"), mesh.axis("dp"), mesh.axis("ep")
    tp, sp, pp = mesh.axis("tp"), mesh.axis("sp"), mesh.axis("pp")
    specs = state_specs(cfg, mesh_rules(rules, mesh)).params
    # the reference reads the bucket size at pp 1 only
    bucketed = grad_bucket_bytes > 0 and dp.size > 1 and pp.size == 1
    pp_loss = pp_loss_from_pairs if pp_schedule == "gpipe" else pp_1f1b_loss_from_pairs
    if (cfg.is_moe or tp.size > 1 or sp.size > 1) and get_default_mesh() is not mesh:
        raise ValueError("a step over tp or sp, or of a MoE model, reads its mesh from the "
                         "default mesh: set_default_mesh(mesh) first, as fit() does")
    # the ring takes a dense trunk projection where overlap_matmul will
    # apply: never inside a pipeline stage
    ring = bool(cfg.overlap_impl) and get_default_mesh() is mesh and pp.size == 1
    # tp does not divide the kv heads: wk and wv reach the trunk whole
    whole_kv = tp.size > 1 and cfg.n_kv_heads % tp.size != 0

    def plan(path: tuple) -> tuple[list[tuple[int, str, Callable]], set[str]]:
        """(the (dim, axis, gather) all-gathers before the forward, in
        order; the axes that split the stored block)."""
        spec = _at(specs, path)
        split = []
        for d, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):      # innermost first, as unshard
                if mesh.shape[a] > 1:
                    if a == "pp" and (path[0], d) != ("layers", 0):
                        raise NotImplementedError(
                            f"{'.'.join(path)}: spec {spec} splits over pp a dim other "
                            "than the stacked layers', which a pipeline stage takes")
                    split.append((d, a))
        trunk = path[0] == "layers" and path[-1] in _TRUNK_LEAVES
        kv = trunk and path[-1] in ("wk", "wv")
        kept = {"pp"} if path[0] == "layers" else set()     # a stage takes its block
        if cfg.is_moe and path[0] == "layers" and path[-1] in _EXPERT_LEAVES:
            kept.add("ep")         # the MoE block consumes this rank's experts
        elif ring and trunk:
            kept.add("fsdp")       # the ring streams the fsdp blocks
        if trunk and not (kv and whole_kv):
            kept.add("tp")         # Megatron: the trunk runs on its tp block

        def gather(a: str) -> Callable:
            # over tp, a whole tensor every tp rank consumes alike keeps its
            # gradient's block unsummed; wk/wv's per-rank parts are summed
            if a == "tp" and not kv:
                return pdist.gather_whole
            return pdist.all_gather_ad

        return ([(d, a, gather(a)) for d, a in split if a not in kept],
                {a for _, a in split})

    def step(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor):
        _check_default_mesh(mesh)
        monitors = monitors_due()
        paths = _paths(state.params)
        leaves = tree_leaves(state.params)
        plans = [plan(p) for p in paths]
        used = []
        for t, (gathers, _) in zip(leaves, plans):
            for d, a, gather in gathers:
                t = gather(t, mesh.axis(a), d)
            used.append(t)
        it = iter(used)
        view = tree_map(lambda _: next(it), state.params)
        if pp.size > 1:
            loss, aux = pp_loss(view, inputs, targets, cfg=cfg, mesh=mesh,
                                n_microbatches=n_microbatches)
        else:
            loss, aux = llama.loss_and_aux(view, inputs, targets, cfg)
        # every rank's loss is the mean over its rows (its sequence block
        # under sp); bucketed, the gradient is the dp shard's mean loss's,
        # scaled by 1/dp below. tp and pp ranks share their rows: no scale
        scale = 1.0 / (fsdp.size * ep.size * sp.size * (1 if bucketed else dp.size))
        grads = list(torch.autograd.grad(loss * scale, leaves))
        for axis in (fsdp, ep, sp):
            # a block this axis does not split was used whole on each of its ranks
            rep = [i for i, (_, split) in enumerate(plans) if axis.name not in split]
            if axis.size > 1 and rep:
                summed = bucketed_psum([grads[i] for i in rep], axis.name, mesh=mesh,
                                       bucket_bytes=_total_bytes([grads[i] for i in rep]))
                for i, g in zip(rep, summed):
                    grads[i] = g
        if dp.size > 1:
            if bucketed:
                grads = [g / dp.size for g in grads]
            grads = bucketed_psum(grads, "dp", mesh=mesh, bucket_bytes=grad_bucket_bytes
                                  if bucketed else _total_bytes(grads))
        # squares of the blocks summed across them, each block counted on
        # the first index of every axis it is not split over
        counted = (fsdp, ep, tp, sp, pp)
        once = [all(a.name in split or a.index == 0 for a in counted)
                for _, split in plans]
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g, c in zip(grads, once):
            if c:
                sq = sq + torch.linalg.vector_norm(g, dtype=torch.float32).square()
        sq = sq.reshape(1)
        mean = loss.detach().reshape(1)
        if monitors:
            # the grads' monitors ride the global norm's all-reduce, the
            # fingerprint the loss mean's (batch_monitor_parts)
            sq = torch.cat([sq, *_grad_monitor_parts(grads, once, paths, plans)])
            mean = torch.cat([mean, *_fingerprint_parts(inputs)])
        for axis in counted:
            sq = pdist.all_reduce(sq, axis)
        for axis in (fsdp, ep, sp, dp):
            mean = torch.cat([mean[:1] / axis.size, mean[1:]]) if monitors \
                else mean / axis.size
            mean = pdist.all_reduce(mean, axis)
        gnorm = sq[0].sqrt()
        upd_sq = optimizer.update(grads, state.opt_state, state.params, grad_norm=gnorm,
                                  update_sq_of=once if monitors else None)
        loss_out = _poison(mean[0], state.step, nan_step)
        state.step += 1
        metrics = {"loss": loss_out, "grad_norm": gnorm, "step": state.step}
        if cfg.is_moe:
            metrics["aux"] = aux.detach()       # the global batch's on every rank
        if monitors:
            leaves = tree_leaves(state.params)
            post = torch.stack([
                health.nonfinite_count([p for p, c in zip(leaves, once) if c], loss.device),
                health.sq_norm([p for p, c in zip(leaves, once) if c], loss.device),
                upd_sq])
            for axis in counted:
                post = pdist.all_reduce(post, axis)
            fp = ((mean[1].long() << 16) + mean[2].long()) & 0xFFFFFFFF
            layer_rms = (torch.sqrt(sq[2:] / float(layer_count))
                         if sq.numel() > 2 else None)
            metrics.update(health.monitors_from_sums(
                loss_out, sq[1], post[0], post[1], post[2], fp, layer_rms))
        return state, metrics

    # the monitors' global sums (module docstring): per-layer squares placed
    # at the stage's offset of the whole [L] stack, over the reference's
    # layer-leaf selection and its element count from the global shapes
    layer_count = sum(math.prod(shape[1:]) or 1
                      for shape in llama.param_shapes(cfg)["layers"].values()
                      if len(shape) >= 1)
    positions: dict[tuple[int, ...], torch.Tensor] = {}

    def _grad_monitor_parts(grads, once, paths, plans) -> list[torch.Tensor]:
        dev = grads[0].device
        nf = health.nonfinite_count([g for g, c in zip(grads, once) if c], dev)
        layer_sq = torch.zeros((cfg.n_layers,), dtype=torch.float32, device=dev)
        for g, c, path, (_, split) in zip(grads, once, paths, plans):
            if c and path[0] == "layers" and g.is_floating_point() and g.ndim >= 1:
                n = g.shape[0]
                lo = pp.index * n if "pp" in split else 0
                layer_sq[lo:lo + n] += health.layer_sq(g)
        return [nf.reshape(1), layer_sq]

    def _fingerprint_parts(inputs: torch.Tensor) -> list[torch.Tensor]:
        key = tuple(inputs.shape)
        if key not in positions:
            positions[key] = _global_positions(inputs, mesh, rules,
                                               n_microbatches if pp.size > 1 else 0)
        part = health.fingerprint_sum(inputs, positions[key])
        # two 16-bit halves: float32 sums of them stay exact over the ranks
        return [(part >> 16).float().reshape(1), (part & 0xFFFF).float().reshape(1)]

    return step


def _total_bytes(tensors: list[torch.Tensor]) -> int:
    return max(1, sum(t.numel() * t.element_size() for t in tensors))


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW, *, mesh: Mesh | None = None,
                    rules: Rules = DEFAULT_RULES, n_microbatches: int = 0,
                    pp_schedule: str = "gpipe", monitors: bool | None = None,
                    grad_bucket_bytes: int | None = None
                    ) -> Callable[..., tuple[TrainState, dict[str, Any]]]:
    """``(state, inputs [B, S], targets [B, S]) -> (state, metrics)``: the
    loss and its grads through autograd, then the optimizer in place.
    ``metrics`` holds ``loss`` and ``grad_norm`` (of the unclipped grads)
    as 0-d float32 device tensors, and ``step``; for MoE configs also
    ``aux``, the layers' mean aux loss that the loss includes times
    ``moe_aux_coef``. Over a ``mesh`` of more than one rank, ``state`` is
    this rank's blocks and ``inputs``/``targets`` its rows
    (``make_batches(mesh=)``), and the metrics are the global batch's.
    ``grad_bucket_bytes`` (> 0, dp > 1, pp 1) reduces the dp gradients in
    buckets of that many bytes; elsewhere it is not read, as in the
    reference. A mesh with pp above 1 trains under ``pp_rules(rules)``
    with the ``pp_schedule`` pipeline ('gpipe' or '1f1b') over
    ``n_microbatches`` microbatches (0: two a stage); at pp 1 neither is
    read, but an unknown schedule raises there too, as in the
    reference."""
    if pp_schedule not in PP_SCHEDULES:
        raise ValueError(f"unknown pp_schedule {pp_schedule!r} (expected gpipe | 1f1b)")
    sharded = _sharded(mesh)
    if sharded:
        check_model_mesh(cfg, mesh.shape)
        if mesh.shape["pp"] > 1 and pp_schedule == "1f1b":
            check_1f1b(cfg)
    # per call: always, never, or (None with a sentinel armed) on the
    # steps it reads
    armed = monitors is None and health.active_sentinel() is not None
    monitors_due = health.due if armed else functools.partial(bool, monitors)
    nan_step = health.nan_inject_step()
    if cfg.remat:
        llama._remat_policy(cfg.remat_policy)     # an unknown name fails here
    if sharded:
        return _sharded_step(cfg, optimizer, mesh, rules, int(grad_bucket_bytes or 0),
                             n_microbatches or 2 * mesh.shape["pp"], pp_schedule,
                             monitors_due, nan_step)

    def step(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor):
        _check_default_mesh(None)
        monitors = monitors_due()
        leaves = tree_leaves(state.params)
        loss, aux = llama.loss_and_aux(state.params, inputs, targets, cfg)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = global_norm(grads)
        upd_sq = optimizer.update(grads, state.opt_state, state.params, grad_norm=gnorm,
                                  update_sq_of=[True] * len(leaves) if monitors else None)
        loss = _poison(loss.detach(), state.step, nan_step)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": gnorm, "step": state.step}
        if cfg.is_moe:
            metrics["aux"] = aux.detach()
        if monitors:
            it = iter(grads)
            grad_tree = tree_map(lambda _: next(it), state.params)
            metrics.update(health.monitors_from_sums(
                loss, health.nonfinite_count(grads, loss.device),
                health.nonfinite_count(leaves, loss.device),
                health.sq_norm(leaves, loss.device), upd_sq,
                health.batch_fingerprint(inputs), health.layer_grad_rms(grad_tree)))
        return state, metrics

    return step


__all__ = [
    "AdamW", "PP_SCHEDULES", "TrainState", "check_1f1b", "check_model_mesh",
    "default_optimizer", "global_norm", "make_train_state", "make_train_step",
    "pp_1f1b_loss_from_pairs", "pp_loss_from_pairs", "pp_rules", "state_specs",
    "tree_leaves", "tree_map",
]
