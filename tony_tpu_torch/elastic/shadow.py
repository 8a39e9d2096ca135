"""Checkpoint shadowing: a host-memory replica of the train state. The
counterpart of ``tony_tpu/elastic/shadow.py``.

The elastic recovery point must not live on disk. The
:class:`ShadowStore` keeps a recent copy of the state in pinned host
memory:

- **async stride shadows** — every ``interval_steps`` the fit loop hands
  the store this rank's live state. The store copies it on the device
  behind the step (the optimizer updates parameters in place, so the
  next step must not race the transfer), then to pinned host memory on
  its own CUDA stream, which waits on an event recorded on the step's
  stream: the step loop never waits for it. If a transfer is still in
  flight the new request is dropped and counted in ``dropped``, as the
  reference drops a request its busy worker cannot take. On the CPU the
  copy is made at once.
- **fence shadows** — at a generation boundary the loop calls
  :meth:`capture_sync` after synchronizing the device: the exact current
  state, which is what makes a shrink lose zero steps. ``fit()`` hands
  it the member's whole state (gathered over the member's own axes), the
  one full replica a reshard onto a new mesh reads.
- **donation / restore** — :func:`reshard_state` puts a host shadow back
  as this rank's blocks on a (new) mesh, through ``models/convert.py``
  ``shards_from_numpy``, the cut sharded checkpoints use.

The store never touches disk and holds at most one host replica plus one
transfer in flight.
"""

from __future__ import annotations

import threading
from typing import Any

import torch


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer of ``t``'s shape and dtype (plain memory on a
    host without a card)."""
    return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=torch.cuda.is_available())


class ShadowStore:
    """Bounded device-to-host state replica (see the module's docstring)."""

    def __init__(self, interval_steps: int = 16):
        self.interval_steps = max(int(interval_steps), 1)
        self._lock = threading.Lock()
        self._step = -1
        self._host: Any = None
        self._dropped = 0
        self._stream = None
        # (done event, step, host tree, device snapshot) of the transfer in flight
        self._inflight: tuple | None = None

    # --- producer side (fit loop) --------------------------------------------

    def _settle(self, wait: bool = False) -> bool:
        """Install the transfer in flight as the shadow once it is done
        (waiting for it with ``wait``); True when none is left in flight."""
        item = self._inflight
        if item is None:
            return True
        done, step, host, _ = item
        if wait:
            done.synchronize()
        elif not done.query():
            return False
        self._inflight = None
        with self._lock:
            if step > self._step:
                self._step, self._host = step, host
        return True

    def maybe_update(self, step: int, state: Any) -> bool:
        """Stride-gated async shadow request; returns whether one was
        issued. Never blocks: a transfer still in flight means this stride
        is dropped (counted in ``dropped``)."""
        if step % self.interval_steps:
            return False
        if not self._settle():
            self._dropped += 1
            return False
        leaves = _leaves(state)
        if not any(t.is_cuda for t in leaves):
            with self._lock:
                self._step, self._host = step, _tree_map(lambda t: t.detach().clone(), state)
            return True
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        # the snapshot on the step's stream (in-place updates of the next
        # step are ordered after it), its transfer on the shadow's stream
        snap = _tree_map(lambda t: t.detach().clone(), state)
        ready = torch.cuda.Event()
        ready.record()
        host = _tree_map(_host, snap)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for h, d in zip(_leaves(host), _leaves(snap)):
                h.copy_(d, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the snapshot's memory stays allocated until the transfer is done
        for d in _leaves(snap):
            d.record_stream(self._stream)
        self._inflight = (done, step, host, snap)
        return True

    def capture_sync(self, step: int, state: Any) -> Any:
        """Synchronous full device-to-host capture (the fence-boundary
        path, after the caller synchronized): also installs the result as
        the current shadow and returns it."""
        self._settle(wait=True)
        host = _tree_map(lambda t: _host(t).copy_(t.detach()), state)
        with self._lock:
            self._step, self._host = step, host
        return host

    # --- consumer side --------------------------------------------------------

    def snapshot(self) -> tuple[int, Any] | None:
        """(step, host state) of the most recent completed shadow, or None
        when nothing has been shadowed yet."""
        self._settle()
        with self._lock:
            if self._host is None:
                return None
            return self._step, self._host

    @property
    def dropped(self) -> int:
        return self._dropped

    def close(self) -> None:
        self._settle(wait=True)


def reshard_state(host_state: dict, mesh, rules=None, *, model,
                  device: str | torch.device | None = None):
    """A host shadow of a member's whole state (``{"step", "params",
    "opt_state": {"count", "mu", "nu"}}``, as :meth:`ShadowStore.
    capture_sync` holds it) as this rank's ``TrainState`` on ``mesh``:
    every parameter-shaped tree cut by ``shards_from_numpy`` under the
    rules' specs (``rules`` None: the default rules), the counts as they
    are. The parameters require grad, as ``make_train_state`` leaves them."""
    from tony_tpu_torch.models.convert import shards_from_numpy
    from tony_tpu_torch.parallel.sharding import DEFAULT_RULES
    from tony_tpu_torch.train.trainer import TrainState, tree_leaves

    rules = DEFAULT_RULES if rules is None else rules
    cut = {name: shards_from_numpy(tree, model, mesh, rules, device=device)
           for name, tree in (("params", host_state["params"]),
                              ("mu", host_state["opt_state"]["mu"]),
                              ("nu", host_state["opt_state"]["nu"]))}
    for p in tree_leaves(cut["params"]):
        p.requires_grad_(True)
    return TrainState(step=int(host_state["step"]), params=cut["params"],
                      opt_state={"count": int(host_state["opt_state"]["count"]),
                                 "mu": cut["mu"], "nu": cut["nu"]})


__all__ = ["ShadowStore", "reshard_state"]
