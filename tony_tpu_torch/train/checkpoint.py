"""Checkpoint and resume of a training state, with the crash-safety
contract of ``tony_tpu/train/checkpoint.py``'s ``CheckpointManager``,
without orbax:

- a save is written into ``<step>.tmp-<pid>/`` and published by an atomic
  rename to ``<step>/``, so a process killed mid-save never leaves a torn
  step behind;
- temp directories left by a killed save are reaped when a manager opens
  the directory;
- the newest ``keep`` steps are kept;
- ``restore`` of the latest step falls back to the previous one when the
  newest is unreadable.

The format is the port's own. One rank writes one ``torch.save`` file
holding the step, the parameters and the optimizer state. Over a mesh of
more than one rank (``mesh=``) a save is sharded, the counterpart of
orbax's multi-host save: each rank writes its own blocks as
``rank<r>.pt`` into one temp directory and rank 0 a manifest beside them
(the mesh shape; every leaf's spec, global shape and dtype). After a
barrier in which every rank has synced its file to disk, rank 0 renames
the directory into place, keeps the newest steps and reaps, and a barrier
closes the save. The directory must be one that every rank sees.

``restore`` is the counterpart of orbax's restore into the template's
shardings: each rank reads, from the rank files whose blocks overlap its
own under the template's specs and mesh, the parts it holds, so a step
restores onto any mesh whose blocks cut evenly (fsdp 2 onto fsdp 4 or dp
2 x fsdp 2, or onto one rank). Every rank restores the same step: rank 0
names it, and the one-step fallback is taken on all ranks when any rank
could not read its blocks. Cross-loading the reference's orbax
checkpoints is out of scope.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh
from tony_tpu_torch.parallel.sharding import entry_axes
from tony_tpu_torch.train.trainer import TrainState, _at, _paths, tree_leaves

log = logging.getLogger(__name__)

_TMP_MARKER = ".tmp-"
_FILE = "state.pt"
_MANIFEST = "manifest.json"
_GROUPS = ("params", "mu", "nu")       # the state's parameter-shaped trees


def _write(path: str, write) -> None:
    """``write(f)`` into ``path``, synced to disk before returning."""
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _trees(state: dict) -> dict[str, dict]:
    """The parameter-shaped trees of a saved or live state by group."""
    return {"params": state["params"], "mu": state["opt_state"]["mu"],
            "nu": state["opt_state"]["nu"]}


def _block_ranges(shape: tuple[int, ...], spec: tuple, mesh_shape: dict[str, int],
                  rank: int) -> tuple[tuple[int, int], ...]:
    """The [lo, hi) index range per dim of rank ``rank``'s block of a
    tensor of global ``shape`` under ``spec``, on a mesh of ``mesh_shape``
    laid out row-major in ``MESH_AXES`` order (``parallel/mesh.py``)."""
    sizes = [mesh_shape.get(a, 1) for a in MESH_AXES]
    coords = dict(zip(MESH_AXES, (int(c) for c in np.unravel_index(rank, sizes))))
    out = []
    for dim, n in enumerate(shape):
        idx, count = 0, 1
        for a in entry_axes(spec[dim] if dim < len(spec) else None):
            idx, count = idx * mesh_shape.get(a, 1) + coords[a], count * mesh_shape.get(a, 1)
        out.append((idx * n // count, (idx + 1) * n // count))
    return tuple(out)


def _spec_json(spec: tuple) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(spec: list) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


class CheckpointManager:
    """Save and restore :class:`TrainState` under ``directory``. With a
    ``mesh`` of more than one rank, every rank of it constructs the
    manager and calls ``save`` and ``restore`` together, and ``specs`` is
    the parameters' spec tree (``state_specs(cfg).params``)."""

    def __init__(self, directory: str, *, keep: int = 3, save_interval_steps: int = 0,
                 mesh: Mesh | None = None, specs: dict | None = None):
        self.directory = directory
        self.keep = keep
        self._interval = save_interval_steps
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and specs is None:
            raise ValueError("a sharded checkpoint needs the parameters' specs")
        self.specs = specs
        if self._lead:
            os.makedirs(directory, exist_ok=True)
            self._reap_interrupted_saves()
        self._barrier()

    # --- the ranks' agreement (no-ops on one rank) ------------------------------

    @property
    def _lead(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def _from_lead(self, value: Any) -> Any:
        """Rank 0's ``value`` on every rank."""
        if self.mesh is None:
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _everywhere(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank."""
        if self.mesh is None:
            return ok
        flags: list = [None] * self.mesh.size
        dist.all_gather_object(flags, ok)
        return all(flags)

    # --- the directory -----------------------------------------------------------

    def _reap_interrupted_saves(self) -> None:
        """Drop the temp directories a killed save left behind. Committed
        steps are plain ``<step>/`` names and never match."""
        for name in os.listdir(self.directory):
            if _TMP_MARKER in name:
                path = os.path.join(self.directory, name)
                log.warning("reaping interrupted checkpoint save %s", path)
                shutil.rmtree(path, ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        return self._interval > 0 and step % self._interval == 0

    def _publish(self, tmp: str, final: str) -> None:
        """Rename the written ``tmp`` into place and keep the newest
        steps (rank 0 only)."""
        if os.path.exists(final):          # a forced re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    # --- save --------------------------------------------------------------------

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Write ``state`` as ``step``; returns whether a save was made
        (without ``force``, only on the save interval and for a new step)."""
        if not force and (not self.should_save(step) or step in self.all_steps()):
            return False
        final = os.path.join(self.directory, str(step))
        blob = {"step": state.step, "params": state.params, "opt_state": state.opt_state}
        if self.mesh is None:
            tmp = f"{final}{_TMP_MARKER}{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            _write(os.path.join(tmp, _FILE), lambda f: torch.save(blob, f))
            self._publish(tmp, final)
            return True
        tmp = None
        if self._lead:
            tmp = f"{final}{_TMP_MARKER}{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        tmp = self._from_lead(tmp)         # the directory exists once this returns
        _write(os.path.join(tmp, f"rank{self.mesh.rank}.pt"), lambda f: torch.save(blob, f))
        if self._lead:
            manifest = self._manifest(state)
            _write(os.path.join(tmp, _MANIFEST),
                   lambda f: f.write(json.dumps(manifest).encode()))
        self._barrier()                    # every rank's file is on disk
        if self._lead:
            self._publish(tmp, final)
        self._barrier()
        return True

    def _manifest(self, state: TrainState) -> dict:
        mesh = self.mesh
        leaves = {}
        for group, tree in _trees({"params": state.params,
                                   "opt_state": state.opt_state}).items():
            for path in _paths(tree):
                t, spec = _at(tree, path), _at(self.specs, path)
                # each dim's block times the blocks its axes cut it into
                shape = [n * math.prod(mesh.shape[a] for a in entry_axes(
                    spec[d] if d < len(spec) else None)) for d, n in enumerate(t.shape)]
                leaves["/".join((group,) + path)] = {
                    "spec": _spec_json(spec), "shape": shape,
                    "dtype": str(t.dtype).removeprefix("torch.")}
        return {"step": state.step, "count": state.opt_state["count"],
                "mesh": mesh.shape, "world": mesh.size, "leaves": leaves}

    # --- restore -----------------------------------------------------------------

    def _load(self, step: int, template: TrainState) -> TrainState:
        """The state of ``step`` as the template holds it: this rank's
        blocks under the template's mesh and specs."""
        step_dir = os.path.join(self.directory, str(step))
        device = tree_leaves(template.params)[0].device
        if self.mesh is None and not os.path.exists(os.path.join(step_dir, _MANIFEST)):
            blob = torch.load(os.path.join(step_dir, _FILE), map_location=device,
                              weights_only=True)
            params, opt_state, count = blob["params"], blob["opt_state"], blob["step"]
        else:
            params, opt_state, count = self._read_blocks(step_dir, template, device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return TrainState(step=int(count), params=params, opt_state=opt_state)

    def _read_blocks(self, step_dir: str, template: TrainState, device):
        """(params, opt_state, step) of a sharded save, cut to this rank's
        blocks: each block is copied together from the saved blocks that
        overlap it (one saved copy of each distinct block is read)."""
        with open(os.path.join(step_dir, _MANIFEST)) as f:
            man = json.load(f)
        saved_mesh, world = man["mesh"], man["world"]
        mesh_shape = self.mesh.shape if self.mesh is not None else {}
        rank = self.mesh.rank if self.mesh is not None else 0
        files: dict[int, dict] = {}

        def rank_file(r: int) -> dict:
            if r not in files:
                files[r] = torch.load(os.path.join(step_dir, f"rank{r}.pt"),
                                      map_location="cpu", mmap=True, weights_only=True)
            return files[r]

        live = _trees({"params": template.params, "opt_state": template.opt_state})
        out: dict[str, dict] = {g: {} for g in _GROUPS}
        for group in _GROUPS:
            for path in _paths(live[group]):
                info = man["leaves"]["/".join((group,) + path)]
                like = _at(live[group], path)
                spec = _at(self.specs, path) if self.mesh is not None else ()
                shape = tuple(info["shape"])
                want = _block_ranges(shape, spec, mesh_shape, rank)
                if tuple(hi - lo for lo, hi in want) != tuple(like.shape):
                    raise ValueError(f"{group}/{'/'.join(path)}: saved global shape {shape} "
                                     f"does not cut to this rank's block {tuple(like.shape)}")
                if info["dtype"] != str(like.dtype).removeprefix("torch."):
                    raise ValueError(f"{group}/{'/'.join(path)}: saved as {info['dtype']}, "
                                     f"the template holds {like.dtype}")
                block = torch.empty(like.shape, dtype=like.dtype, device=device)
                filled, seen = 0, set()
                saved_spec = _spec_from_json(info["spec"])
                for r in range(world):
                    have = _block_ranges(shape, saved_spec, saved_mesh, r)
                    if have in seen:            # a replica of a block already read
                        continue
                    seen.add(have)
                    lap = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(want, have)]
                    if any(lo >= hi for lo, hi in lap):
                        continue
                    src = _at(_trees(rank_file(r))[group], path)
                    dst_idx = tuple(slice(lo - w, hi - w) for (lo, hi), (w, _) in zip(lap, want))
                    src_idx = tuple(slice(lo - h, hi - h) for (lo, hi), (h, _) in zip(lap, have))
                    block[dst_idx] = src[src_idx].to(device)
                    filled += math.prod(hi - lo for lo, hi in lap)
                if filled != block.numel():
                    raise ValueError(f"{group}/{'/'.join(path)}: the saved blocks cover "
                                     f"{filled} of this rank's {block.numel()} elements")
                node = out[group]
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = block
        opt_state = {"count": int(man["count"]), "mu": out["mu"], "nu": out["nu"]}
        return out["params"], opt_state, man["step"]

    def _attempt(self, step: int, template: TrainState) -> tuple[TrainState | None, Exception | None]:
        try:
            return self._load(step, template), None
        except Exception as err:          # judged with every rank's outcome
            return None, err

    def restore(self, template: TrainState, step: int | None = None
                ) -> tuple[TrainState, int]:
        """(state, step) of the latest (or given) step, as the template
        holds it (its device, and over a mesh its blocks); (template, -1)
        when there is none. An unreadable latest step (on any rank) falls
        back to the previous one, once, on every rank; an explicit step
        raises."""
        steps = self._from_lead(self.all_steps())
        target = step if step is not None else (steps[-1] if steps else None)
        if target is None or target < 0:
            return template, -1
        state, err = self._attempt(target, template)
        if self._everywhere(err is None):
            return state, target
        earlier = [s for s in steps if s < target]
        if step is not None or not earlier:
            raise err or RuntimeError(f"checkpoint step {target} unreadable on another rank")
        prev = max(earlier)
        log.warning("checkpoint step %d unreadable (interrupted save?); falling back to "
                    "step %d", target, prev, exc_info=err)
        state, err = self._attempt(prev, template)
        if not self._everywhere(err is None):
            raise err or RuntimeError(f"checkpoint step {prev} unreadable on another rank")
        return state, prev

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        self.wait()


__all__ = ["CheckpointManager"]
