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
float32 router, whose second moment is float32 with it. Meshes (dp/fsdp/tp/pp), bucketed gradient reduction and
the numerics-health monitors are not ported yet and raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.models import llama

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


def _single_device(mesh) -> None:
    if mesh is None:
        return
    size = mesh.size() if callable(getattr(mesh, "size", None)) else getattr(mesh, "size", 1)
    if size > 1:
        raise NotImplementedError(
            "multi-device meshes (dp/fsdp/tp/pp) are not ported yet (ROADMAP "
            "queue 1, parallelism); the port trains on one device"
        )


def make_train_state(cfg: llama.LlamaConfig, optimizer: AdamW, *, seed: int = 0,
                     params: Params | None = None,
                     device: str | torch.device | None = None,
                     mesh=None) -> TrainState:
    """Step 0: ``params`` (or random ones from ``seed`` on ``device``;
    ``None`` means CUDA, and raises without it) and zeroed moments."""
    _single_device(mesh)
    if params is None:
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        params = llama.init_params(cfg, gen, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(cfg: llama.LlamaConfig, optimizer: AdamW, *, mesh=None,
                    n_microbatches: int = 0, pp_schedule: str = "gpipe",
                    monitors: bool | None = None,
                    grad_bucket_bytes: int | None = None
                    ) -> Callable[..., tuple[TrainState, dict[str, Any]]]:
    """``(state, inputs [B, S], targets [B, S]) -> (state, metrics)``: the
    loss and its grads through autograd, then the optimizer in place.
    ``metrics`` holds ``loss`` and ``grad_norm`` (of the unclipped grads)
    as 0-d float32 device tensors, and ``step``; for MoE configs also
    ``aux``, the layers' mean aux loss that the loss includes times
    ``moe_aux_coef``."""
    if pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {pp_schedule!r} (expected gpipe | 1f1b)")
    _single_device(mesh)
    if n_microbatches:
        raise NotImplementedError("pipeline microbatches need a pp mesh, not ported yet")
    if grad_bucket_bytes:
        raise NotImplementedError(
            "bucketed dp gradient reduction is not ported yet (ROADMAP queue 1)")
    if monitors:
        raise NotImplementedError(
            "the numerics-health monitors are not ported yet (ROADMAP queue 1, "
            "observability)")
    llama._check_trainable(cfg)
    if cfg.remat:
        llama._remat_policy(cfg.remat_policy)     # an unknown name fails here

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
    "AdamW", "TrainState", "default_optimizer", "global_norm", "make_train_state",
    "make_train_step", "tree_leaves", "tree_map",
]
