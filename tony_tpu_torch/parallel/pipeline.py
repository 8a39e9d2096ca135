"""Pipeline parallelism over the ``pp`` axis of torch.distributed ranks.

The counterpart of ``tony_tpu/parallel/pipeline.py``. Stages are the
ranks along a mesh axis (``parallel/mesh.py``); each holds its block of
the stacked layers and runs it on every microbatch in turn. Activations
pass to the next stage and their gradients back to the previous one by
:func:`~tony_tpu_torch.parallel.dist.start_stage_hop`, a one-way
point-to-point hop: the reference's ``lax.ppermute`` over ``[(i, i + 1)]``
without its wrap-around edge, whose payload no stage reads.

Two schedules, each a ``torch.autograd.Function`` whose backward is
written out, so every rank issues its hops in one fixed order, whatever
order autograd would pick:

- GPipe (:func:`pipeline_local`): forward ticks ``t = 0 .. M + P - 2``,
  stage ``s`` running microbatch ``t - s``, each microbatch's stage graph
  kept until the backward, which runs the ticks in reverse (O(M) saved
  activations a stage). The last stage's outputs are broadcast to every
  stage, so the loss head runs alike on every pp rank; its cotangent is
  taken from the last stage only, once.
- 1F1B (:func:`pipeline_train_1f1b`): one forward and one backward slot
  a tick over ``t = 0 .. M + 2P - 3``, microbatch i's forward on stage s
  at tick ``i + s`` and its backward at ``i + 2P - 2 - s``; at most ``2P -
  1`` stage inputs are kept, and the backward slot recomputes its stage
  with grad from the saved input (O(P) saved activations). The loss head
  runs on the last stage only, seeded with ``1/M``.

A tick whose slot is empty runs no stage compute and sends nothing, in
both schedules (the reference skips 1F1B's with ``lax.cond`` and runs
GPipe's stage on garbage there, which changes no value). The first
stage's input cotangents are broadcast to every stage, the transpose of
the reference's replicated input, so each pp rank's embedding gets its
whole gradient.

A stage function maps a microbatch to a tensor of its own shape and
dtype, as the reference's schedule requires: stage s > 0 reads the
previous stage's output where stage 0 reads ``xs``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.mesh import Mesh
from tony_tpu_torch.parallel.sharding import shard

StageFn = Callable[[Any, torch.Tensor], Any]
_FWD_TAG, _BWD_TAG = 0, 1


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """``[B, ...] -> [M, B/M, ...]``."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by n_microbatches={n_microbatches}")
    return x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """``[M, mb, ...] -> [M * mb, ...]``."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


# --- parameter trees (a tensor, or nested dicts of tensors) ------------------------


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _rebuild(tree: Any, leaves: list[torch.Tensor]) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return next(it)

    return build(tree)


def _aliases(leaves) -> list[torch.Tensor]:
    """Leaves of the schedule's own graphs: the same storage, cut from the
    caller's graph, each requiring grad where its leaf does."""
    return [t.detach().requires_grad_(t.requires_grad) for t in leaves]


def _grads(outs: list, seeds: list, inputs: list[torch.Tensor]) -> list:
    """``torch.autograd.grad`` over the inputs that require grad; None for
    the rest and for inputs the outputs do not reach."""
    want = [t for t in inputs if t.requires_grad]
    got = iter(torch.autograd.grad(outs, want, seeds, allow_unused=True) if want else ())
    return [next(got) if t.requires_grad else None for t in inputs]


def _accumulate(acc: list, grads: list) -> None:
    """Sum each gradient into its float32 accumulator."""
    for j, g in enumerate(grads):
        if g is not None:
            acc[j] = g.float() if acc[j] is None else acc[j].add_(g)


def _finish(acc: list, leaves, scale=None) -> list:
    """The accumulators in their leaves' dtypes (zeros where nothing was
    reached), times ``scale``."""
    out = []
    for a, leaf in zip(acc, leaves):
        if a is None:
            out.append(torch.zeros_like(leaf) if leaf.requires_grad else None)
            continue
        out.append((a if scale is None else a * scale).to(leaf.dtype))
    return out


# --- GPipe --------------------------------------------------------------------------


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: dict, xs: torch.Tensor, *leaves: torch.Tensor):
        axis, stage_fn, with_aux = run["axis"], run["stage_fn"], run["with_aux"]
        P, s, M = axis.size, axis.index, xs.shape[0]
        params = _aliases(leaves)
        tree = _rebuild(run["tree"], params)
        kept: dict[int, tuple] = {}
        outs: list[torch.Tensor] = []
        aux_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
        prev = None                          # the output of last tick's slot
        for t in range(M + P - 1):
            i = t - s
            valid = 0 <= i < M
            x_in = pdist.start_stage_hop(prev if s < P - 1 else None,
                                         xs[0] if s > 0 and valid else None, axis,
                                         1, _FWD_TAG).wait()
            prev = None
            if not valid:
                continue
            with torch.enable_grad():
                x_leaf = (xs[i] if s == 0 else x_in).detach().requires_grad_(True)
                res = stage_fn(tree, x_leaf)
            y, aux = res if with_aux else (res, None)
            kept[i] = (x_leaf, y, aux)
            prev = y.detach()
            if aux is not None:
                aux_sum += aux.detach()
            if s == P - 1:
                outs.append(prev)
        out = torch.stack(outs) if s == P - 1 else torch.empty_like(xs)
        out = pdist.broadcast(out, axis, P - 1)
        ctx.run, ctx.kept, ctx.params, ctx.like = run, kept, params, xs
        if not with_aux:
            return out
        # each stage's real ticks, summed over the stages, averaged over M
        return out, pdist.all_reduce(aux_sum, axis) / M

    @staticmethod
    def backward(ctx, dout, daux=None):
        axis, kept, params, xs = ctx.run["axis"], ctx.kept, ctx.params, ctx.like
        P, s, M = axis.size, axis.index, xs.shape[0]
        acc: list = [None] * len(params)
        dxs = torch.zeros_like(xs)
        prev = None                          # the input cotangent of last tick's slot
        for t in reversed(range(M + P - 1)):
            i = t - s
            valid = 0 <= i < M
            g = pdist.start_stage_hop(prev if s > 0 else None,
                                      xs[0] if s < P - 1 and valid else None, axis,
                                      -1, _BWD_TAG).wait()
            prev = None
            if not valid:
                continue
            x_leaf, y, aux = kept.pop(i)
            # every pp rank ran the same head on the broadcast outputs: the
            # last stage takes the cotangent, once
            if s == P - 1:
                g = dout[i] if dout is not None else torch.zeros_like(y)
            outs, seeds = [y], [g]
            if aux is not None and daux is not None:
                outs.append(aux)
                seeds.append(daux / M)
            grads = _grads(outs, seeds, [x_leaf, *params])
            _accumulate(acc, grads[1:])
            if s == 0:
                dxs[i] = grads[0]
            else:
                prev = grads[0]
        return (None, pdist.broadcast(dxs, axis, 0), *_finish(acc, params))


def pipeline_local(stage_fn: StageFn, stage_params: Any, xs: torch.Tensor, *,
                   axis: pdist.Axis, with_aux: bool = False):
    """The GPipe schedule on this rank of ``axis`` (the reference's
    ``pipeline_local`` inside its shard_map).

    ``stage_params``: this stage's parameters (a tensor or nested dicts of
    tensors); ``stage_fn(stage_params, x_mb) -> y_mb``. ``xs``: ``[M, mb,
    ...]`` microbatched input, the same on every rank of the axis (stage 0
    reads it). Returns the last stage's ``[M, mb, ...]`` outputs on every
    rank. With ``with_aux`` the stage returns ``(y, aux_scalar)`` and the
    result is ``(out, aux)``: each stage's aux summed over its microbatches,
    summed over the stages, divided by M (the reference's per-microbatch
    aux semantics). Gradients reach ``stage_params`` (this stage's) and
    ``xs`` (whole on every rank)."""
    run = {"axis": axis, "stage_fn": stage_fn, "with_aux": with_aux, "tree": stage_params}
    return _GPipe.apply(run, xs, *_leaves(stage_params))


def pipeline_apply(stage_fn: StageFn, stacked_stage_params: Any, x: torch.Tensor, *,
                   mesh: Mesh, axis_name: str = "pp") -> torch.Tensor:
    """The reference's full-array entry: ``stacked_stage_params``' leaves
    carry a leading stage dim of the axis's size, whole on every rank; this
    rank's stage is cut from them (its gradient lands in that block), the
    schedule runs, and every rank gets the outputs for all microbatches."""
    axis = mesh.axis(axis_name)

    def local(t: torch.Tensor) -> torch.Tensor:
        return shard(t, (axis_name,), mesh)[0] if axis.size > 1 else t[0]

    params = _rebuild(stacked_stage_params, [local(t) for t in _leaves(stacked_stage_params)])
    return pipeline_local(stage_fn, params, x, axis=axis)


# --- 1F1B ---------------------------------------------------------------------------


class _OneFOneB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: dict, xs: torch.Tensor, targets: torch.Tensor,
                *leaves: torch.Tensor):
        axis, stage_fn, head_fn = run["axis"], run["stage_fn"], run["head_fn"]
        P, s, M = axis.size, axis.index, xs.shape[0]
        last = P - 1
        n_stage = run["n_stage"]
        params = _aliases(leaves)
        stage_p, head_p = params[:n_stage], params[n_stage:]
        stage_tree = _rebuild(run["stage_tree"], stage_p)
        head_tree = _rebuild(run["head_tree"], head_p)
        acc: list = [None] * len(params)
        dxs = torch.zeros_like(xs)
        loss = torch.zeros((), dtype=torch.float32, device=xs.device)
        seed = torch.full((), 1.0 / M, dtype=torch.float32, device=xs.device)
        saved: dict[int, torch.Tensor] = {}     # stage inputs awaiting their backward
        y_prev = dx_prev = None
        for t in range(M + 2 * P - 2):
            i_f, i_b = t - s, t - (2 * P - 2 - s)
            valid_f, valid_b = 0 <= i_f < M, 0 <= i_b < M
            fwd = pdist.start_stage_hop(y_prev if s < last else None,
                                        xs[0] if s > 0 and valid_f else None, axis, 1,
                                        _FWD_TAG)
            bwd = pdist.start_stage_hop(dx_prev if s > 0 else None,
                                        xs[0] if s < last and valid_b else None, axis, -1,
                                        _BWD_TAG)
            x_in, g_in = fwd.wait(), bwd.wait()
            y_prev = dx_prev = None
            # forward slot: microbatch i_f enters this stage. The last stage
            # passes its output nowhere, and its backward slot runs the same
            # microbatch in this tick: it only keeps the input
            if valid_f:
                saved[i_f] = xs[i_f] if s == 0 else x_in
                if s < last:
                    with torch.no_grad():
                        y_prev = stage_fn(stage_tree, saved[i_f])
            # backward slot: microbatch i_b leaves this stage
            if not valid_b:
                continue
            with torch.enable_grad():
                x_leaf = saved.pop(i_b).detach().requires_grad_(True)
                y = stage_fn(stage_tree, x_leaf)
                if s == last:
                    loss_i = head_fn(head_tree, y, targets[i_b])
                    grads = _grads([loss_i], [seed], [x_leaf, *params])
                    loss += loss_i.detach().float() / M
                else:
                    grads = _grads([y], [g_in], [x_leaf, *stage_p]) + [None] * len(head_p)
            _accumulate(acc, grads[1:])
            if s == 0:
                dxs[i_b] = grads[0]
            else:
                dx_prev = grads[0].to(xs.dtype)
        # the loss and head grads live on the last stage, dxs on the first
        ctx.dxs = pdist.broadcast(dxs, axis, 0)
        ctx.acc, ctx.params, ctx.n_stage, ctx.axis = acc, params, n_stage, axis
        return pdist.broadcast(loss, axis, last)

    @staticmethod
    def backward(ctx, g):
        grads = _finish(ctx.acc, ctx.params, g)
        head = [pdist.broadcast(t, ctx.axis, ctx.axis.size - 1) if t is not None else None
                for t in grads[ctx.n_stage:]]
        return (None, ctx.dxs * g.to(ctx.dxs.dtype), None, *grads[:ctx.n_stage], *head)


def pipeline_train_1f1b(stage_fn: StageFn, head_fn: Callable, stage_params: Any,
                        head_params: Any, xs: torch.Tensor, targets: torch.Tensor, *,
                        mesh: Mesh, axis_name: str = "pp") -> torch.Tensor:
    """Pipelined training under the 1F1B schedule (the reference's
    ``pipeline_train_1f1b``, its ``custom_vjp`` a Function here): the mean
    over microbatches of ``head_fn(head_params, y_mb, tgt_mb)``, with
    gradients to ``stage_params``, ``head_params`` and ``xs`` computed in
    the forward and handed back, times the loss's cotangent, by the
    backward.

    ``stage_params``: this rank's stage (as the trainer holds it; the
    reference's shard_map cuts the same block); ``stage_fn(stage_params,
    x_mb) -> y_mb``. ``head_fn`` runs on the last stage only. ``xs``:
    ``[M, mb, ...]`` microbatched inputs, ``targets`` ``[M, mb, ...]``
    labels, the same on every rank of the axis. The loss, the head's
    gradients and ``xs``'s are the same on every rank; the stage
    gradients are this stage's."""
    axis = mesh.axis(axis_name)
    stage_leaves, head_leaves = _leaves(stage_params), _leaves(head_params)
    run = {"axis": axis, "stage_fn": stage_fn, "head_fn": head_fn,
           "stage_tree": stage_params, "head_tree": head_params,
           "n_stage": len(stage_leaves)}
    return _OneFOneB.apply(run, xs, targets, *stage_leaves, *head_leaves)


__all__ = ["microbatch", "pipeline_apply", "pipeline_local", "pipeline_train_1f1b",
           "unmicrobatch"]
