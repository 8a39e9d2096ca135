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

Meshes (dp and fsdp; the counterpart of the reference's GSPMD step). Each
rank holds its blocks of the parameters and moments under the rules'
specs (:func:`state_specs`, ``parallel/sharding.py``) and its rows of the
global batch. In the step:

- a weight the fsdp ring does not take (``ops/overlap.py``, with
  ``overlap_impl`` set and the mesh the default one) is all-gathered
  blocking before the forward, as GSPMD would, and its gradient
  reduce-scattered back to the shard in the backward; the trunk
  projections the ring takes stay shards, and the ring's backward
  reduce-scatters their gradients;
- a replicated leaf's gradient (the norms) is summed over fsdp, and every
  gradient over dp: one all-reduce, or with ``grad_bucket_bytes > 0`` and
  dp > 1 the reference's manual-dp path (each dp shard's mean loss, grads
  scaled by 1/dp, ``bucketed_psum`` buckets in leaf order);
- ``global_norm`` sums the squares across shards with one all-reduce over
  fsdp, and AdamW updates the local blocks.

tp, sp, pp and ep above 1, MoE over a mesh, pipeline microbatches and the
numerics-health monitors are not ported yet and raise (ROADMAP queue 1,
item 8 for the parallelism, item 6 for the monitors).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models import llama
from tony_tpu_torch.ops.overlap import bucketed_psum
from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.mesh import Mesh, get_default_mesh
from tony_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, Rules, local_shape, shard_tree, tree_specs,
)

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
               grad_norm: torch.Tensor | None = None) -> None:
        """One step, in place on ``params`` and ``opt_state``; ``grads`` in
        ``tree_leaves(params)`` order."""
        if grad_norm is None:
            grad_norm = global_norm(grads)
        clip = torch.where(grad_norm < self.grad_clip, 1.0,
                           self.grad_clip / grad_norm)
        count = opt_state["count"]
        lr = self.learning_rate(count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        leaves = zip(tree_leaves(params), grads, tree_leaves(opt_state["mu"]),
                     tree_leaves(opt_state["nu"]))
        for p, g, mu, nu in leaves:
            for pc, gc, mc, nc in zip(p.view(-1).split(_CHUNK),
                                      g.reshape(-1).split(_CHUNK),
                                      mu.view(-1).split(_CHUNK),
                                      nu.view(-1).split(_CHUNK)):
                g32 = gc.float() * clip
                mc.copy_(self.b1 * mc.float() + (1.0 - self.b1) * g32)
                nc.copy_(self.b2 * nc.float() + (1.0 - self.b2) * g32 * g32)
                u = (mc.float() / bc1) / (torch.sqrt(nc.float() / bc2) + self.eps)
                p32 = pc.float()
                pc.copy_(p32 - lr * (u + self.weight_decay * p32))
        opt_state["count"] = count + 1


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup_steps: int = 100, decay_steps: int = 10000,
                      grad_clip: float = 1.0,
                      mu_dtype: torch.dtype | str = torch.float32) -> AdamW:
    """The reference's default chain; ``decay_steps`` is raised to
    ``warmup_steps + 1`` as there."""
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 decay_steps=max(decay_steps, warmup_steps + 1),
                 grad_clip=grad_clip, mu_dtype=_dtype(mu_dtype))


# the trunk projections _proj routes through the fsdp ring (models/llama.py)
_RING_LEAVES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def check_mesh_axes(shape: dict[str, int]) -> None:
    """Raise for what the port does not train over: mesh axes other than
    dp and fsdp above 1."""
    for name, n in shape.items():
        if n > 1 and name not in ("dp", "fsdp"):
            raise NotImplementedError(
                f"mesh axis {name}={n}: the port trains over dp and fsdp; tp, sp, pp "
                "and ep are not ported yet (ROADMAP queue 1, item 8, multi-process "
                "parallelism)")


def _check_mesh(mesh: Mesh | None, cfg: llama.LlamaConfig) -> bool:
    """Whether ``mesh`` spans more than one rank; raises for what the port
    does not train over."""
    if mesh is None or mesh.size == 1:
        return False
    check_mesh_axes(mesh.shape)
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE over a mesh of more than one rank (expert parallelism and the "
            "router's global statistics) is not ported yet (ROADMAP queue 1, item 8)")
    return True


def state_specs(cfg: llama.LlamaConfig, rules: Rules = DEFAULT_RULES) -> TrainState:
    """Specs for the whole TrainState (the reference's ``state_shardings``):
    the parameters' from their logical axes, the moments mirroring them
    leaf by leaf, the counts replicated."""
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
    the rank's blocks already (``models.convert.shards_from_numpy``)."""
    sharded = _check_mesh(mesh, cfg)
    specs = state_specs(cfg, rules).params
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


class _Gather(torch.autograd.Function):
    """A blocking all-gather of a weight's fsdp blocks; its gradient is
    reduce-scattered back to the block."""

    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return pdist.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return pdist.reduce_scatter(g, ctx.axis, ctx.dim), None, None


def _sharded_step(cfg: llama.LlamaConfig, optimizer: AdamW, mesh: Mesh, rules: Rules,
                  grad_bucket_bytes: int) -> Callable:
    """The step over a dp x fsdp mesh (see the module's docstring)."""
    fsdp, dp = mesh.axis("fsdp"), mesh.axis("dp")
    specs = state_specs(cfg, rules).params
    bucketed = grad_bucket_bytes > 0 and dp.size > 1

    def fsdp_dim(path: tuple) -> int | None:
        """The dim the rules split over fsdp (None: replicated there)."""
        spec = _at(specs, path)
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            if any(a is not None and a != "fsdp" and mesh.shape[a] > 1 for a in axes):
                raise NotImplementedError(
                    f"{'.'.join(path)}: spec {spec} splits a parameter over a mesh axis "
                    "other than fsdp (ROADMAP queue 1, item 8)")
            if "fsdp" in axes and fsdp.size > 1:
                return d
        return None

    def step(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor):
        paths = _paths(state.params)
        leaves = tree_leaves(state.params)
        dims = [fsdp_dim(p) for p in paths]
        # the ring takes a trunk projection where overlap_matmul will apply
        ring = bool(cfg.overlap_impl) and get_default_mesh() is mesh
        used = [t if d is None or (ring and p[0] == "layers" and p[-1] in _RING_LEAVES)
                else _Gather.apply(t, fsdp, d) for p, t, d in zip(paths, leaves, dims)]
        it = iter(used)
        view = tree_map(lambda _: next(it), state.params)
        loss, _ = llama.loss_and_aux(view, inputs, targets, cfg)
        # every rank's loss is the mean over its rows; bucketed, the
        # gradient is the dp shard's mean loss's, scaled by 1/dp below
        scale = 1.0 / fsdp.size if bucketed else 1.0 / (fsdp.size * dp.size)
        grads = list(torch.autograd.grad(loss * scale, leaves))
        rep = [i for i, d in enumerate(dims) if d is None]
        if fsdp.size > 1 and rep:
            summed = bucketed_psum([grads[i] for i in rep], "fsdp", mesh=mesh,
                                   bucket_bytes=_total_bytes([grads[i] for i in rep]))
            for i, g in zip(rep, summed):
                grads[i] = g
        if dp.size > 1:
            if bucketed:
                grads = [g / dp.size for g in grads]
            grads = bucketed_psum(grads, "dp", mesh=mesh, bucket_bytes=grad_bucket_bytes
                                  if bucketed else _total_bytes(grads))
        # squares of fsdp blocks summed across the blocks, replicated
        # leaves counted once
        sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g, d in zip(grads, dims):
            if d is not None or fsdp.index == 0:
                sq = sq + torch.linalg.vector_norm(g, dtype=torch.float32).square()
        gnorm = pdist.all_reduce(sq.reshape(1), fsdp)[0].sqrt()
        mean = pdist.all_reduce(loss.detach().reshape(1) / fsdp.size, fsdp)
        mean = pdist.all_reduce(mean / dp.size, dp)[0]
        optimizer.update(grads, state.opt_state, state.params, grad_norm=gnorm)
        state.step += 1
        return state, {"loss": mean, "grad_norm": gnorm, "step": state.step}

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
    ``grad_bucket_bytes`` (> 0, dp > 1) reduces the dp gradients in
    buckets of that many bytes; elsewhere it is not read, as in the
    reference."""
    if pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {pp_schedule!r} (expected gpipe | 1f1b)")
    sharded = _check_mesh(mesh, cfg)
    if n_microbatches:
        raise NotImplementedError("pipeline microbatches need a pp mesh, not ported yet "
                                  "(ROADMAP queue 1, item 8)")
    if monitors:
        raise NotImplementedError(
            "the numerics-health monitors are not ported yet (ROADMAP queue 1, "
            "observability)")
    llama._check_trainable(cfg)
    if cfg.remat:
        llama._remat_policy(cfg.remat_policy)     # an unknown name fails here
    if sharded:
        return _sharded_step(cfg, optimizer, mesh, rules, int(grad_bucket_bytes or 0))

    def step(state: TrainState, inputs: torch.Tensor, targets: torch.Tensor):
        leaves = tree_leaves(state.params)
        loss, aux = llama.loss_and_aux(state.params, inputs, targets, cfg)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = global_norm(grads)
        optimizer.update(grads, state.opt_state, state.params, grad_norm=gnorm)
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": gnorm, "step": state.step}
        if cfg.is_moe:
            metrics["aux"] = aux.detach()
        return state, metrics

    return step


__all__ = [
    "AdamW", "TrainState", "check_mesh_axes", "default_optimizer", "global_norm",
    "make_train_state", "make_train_step", "state_specs", "tree_leaves", "tree_map",
]
