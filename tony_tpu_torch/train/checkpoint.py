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

The format is the port's own: one ``torch.save`` file holding the step,
the parameters and the optimizer state. Cross-loading the reference's
orbax checkpoints is out of scope.
"""

from __future__ import annotations

import logging
import os
import shutil

import torch

from tony_tpu_torch.train.trainer import TrainState, tree_leaves

log = logging.getLogger(__name__)

_TMP_MARKER = ".tmp-"
_FILE = "state.pt"


class CheckpointManager:
    """Save and restore :class:`TrainState` under ``directory``."""

    def __init__(self, directory: str, *, keep: int = 3, save_interval_steps: int = 0):
        self.directory = directory
        self.keep = keep
        self._interval = save_interval_steps
        os.makedirs(directory, exist_ok=True)
        self._reap_interrupted_saves()

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

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Write ``state`` as ``step``; returns whether a save was made
        (without ``force``, only on the save interval and for a new step)."""
        if not force and (not self.should_save(step) or step in self.all_steps()):
            return False
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}{_TMP_MARKER}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, _FILE)
        with open(path, "wb") as f:
            torch.save({"step": state.step, "params": state.params,
                        "opt_state": state.opt_state}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):          # a forced re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        return True

    def _load(self, step: int, template: TrainState) -> TrainState:
        device = tree_leaves(template.params)[0].device
        blob = torch.load(os.path.join(self.directory, str(step), _FILE),
                          map_location=device, weights_only=True)
        params = blob["params"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return TrainState(step=int(blob["step"]), params=params,
                          opt_state=blob["opt_state"])

    def restore(self, template: TrainState, step: int | None = None
                ) -> tuple[TrainState, int]:
        """(state, step) of the latest (or given) step, on the template's
        device; (template, -1) when there is none. An unreadable latest step
        falls back to the previous one, once; an explicit step raises."""
        target = step if step is not None else self.latest_step()
        if target is None or target < 0:
            return template, -1
        try:
            return self._load(target, template), target
        except Exception:
            if step is not None:
                raise
            earlier = [s for s in self.all_steps() if s < target]
            if not earlier:
                raise
            prev = max(earlier)
            log.warning("checkpoint step %d unreadable (interrupted save?); "
                        "falling back to step %d", target, prev, exc_info=True)
            return self._load(prev, template), prev

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        self.wait()


__all__ = ["CheckpointManager"]
