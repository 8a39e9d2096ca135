"""Membership-aware batch streams: skip exactly the dead member's data.
The counterpart of ``tony_tpu/elastic/data.py``.

Every member draws its per-step rows from its OWN deterministic substream
keyed by ``(seed + member, step)`` (the reference's tokens, bit for bit),
so a member's stream position is always exactly the global step index.
Shrink and grow then never move any survivor's position: membership only
selects which substreams make the global batch, and the skipped ranges
are pure intervals ``[shrink_step, grow_step)`` per dead member.

Two views of one stream. Without a ``member`` it yields the live
membership's global batch, the members' rows concatenated in member
order, as the reference does (:func:`reference_batches`, the no-fault
run a loss-continuity comparison trains against). With ``member`` and a
``mesh`` (what ``fit()`` builds) it yields only this rank's rows: its
member's rows, split over the member's own axes by ``train/data.py``
``rank_rows``. That is the rank's block of the global batch, since the
dp coordinate of a live mesh is the member's place among the survivors;
no rank draws another member's rows.

``prefetch`` composes as in the reference: the generator is wrapped in a
:class:`~tony_tpu_torch.train.prefetch.PrefetchIterator`, which a reshard
closes and rebuilds from the boundary step.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tony_tpu_torch.parallel.dist import Axis
from tony_tpu_torch.parallel.sharding import DEFAULT_RULES, Rules
from tony_tpu_torch.train.data import Batch, DataConfig, rank_rows


class _MemberView:
    """A live mesh as one member sees its rows: the dp axis (the members)
    taken out, every other axis as it is."""

    def __init__(self, mesh):
        self._mesh = mesh
        self.shape = {**mesh.shape, "dp": 1}
        self.size = mesh.size // mesh.shape["dp"]

    def axis(self, name: str) -> Axis:
        return Axis("dp") if name == "dp" else self._mesh.axis(name)


class ElasticBatchStream:
    """Synthetic per-member token stream for elastic ``fit()``.

    ``cfg.global_batch`` is the FULL-membership global batch; each member
    contributes ``global_batch / n_members`` rows. ``next()`` yields the
    live membership's (inputs, targets): the global pair, or with
    ``member`` this rank's block of it (see the module's docstring), on
    ``device``. :meth:`reshard` swaps membership (and the mesh) at a step
    boundary and records what the dead members will skip.
    """

    def __init__(self, cfg: DataConfig, n_members: int,
                 members: tuple[int, ...], mesh=None, start_step: int = 0,
                 prefetch: int | None = None, *, member: int | None = None,
                 rules: Rules = DEFAULT_RULES, microbatches: int = 0,
                 device: str | torch.device = "cpu"):
        if cfg.path:
            raise NotImplementedError(
                "elastic fit currently streams the synthetic pipeline; "
                "token-file streams need per-member shard ownership "
                "(DataConfig.path with elastic_members is not supported yet)"
            )
        if n_members < 1 or cfg.global_batch % n_members:
            raise ValueError(
                f"global batch {cfg.global_batch} not divisible by "
                f"{n_members} members"
            )
        self.cfg = cfg
        self.n_members = n_members
        self.per_member = cfg.global_batch // n_members
        self.members: tuple[int, ...] = tuple(sorted(members))
        self.member = member
        self.step = start_step
        self._mesh = mesh
        self._rules = rules
        self._microbatches = microbatches
        self._device = torch.device(device)
        self._prefetch = cfg.prefetch if prefetch is None else prefetch
        # member -> [from_step, to_step) ranges this stream skipped; an
        # open range (to_step == -1) means the member never came back
        self.skipped: dict[int, list[list[int]]] = {}
        self._cum = self._zipf_table(cfg.vocab_size)
        self._it: Iterator[Batch] | None = None
        self._rebuild()

    @staticmethod
    def _zipf_table(vocab_size: int) -> np.ndarray:
        # same marginals as train.data.synthetic_batches (inverse-CDF over
        # a one-time cumulative table; tail pinned so rounding can't
        # index past vocab_size-1)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        cum = np.cumsum(probs)
        cum[-1] = 1.0
        return cum

    def member_rows(self, member: int, step: int) -> np.ndarray:
        """Member ``member``'s [per_member, seq+1] token block at ``step``
        — the deterministic substream contract (position == step)."""
        rng = np.random.default_rng((self.cfg.seed + member, step))
        draws = rng.random((self.per_member, self.cfg.seq_len + 1))
        return np.searchsorted(self._cum, draws, side="right").astype(np.int32)

    def _generate(self, members: tuple[int, ...], start: int) -> Iterator[Batch]:
        step = start
        rows_of = (members if self.member is None else (self.member,))
        view = None if self._mesh is None or self.member is None else _MemberView(self._mesh)
        while True:
            tokens = np.concatenate([self.member_rows(m, step) for m in rows_of], axis=0)
            step += 1
            pair = (torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
                    torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])))
            if view is not None and view.size > 1:
                pair = tuple(rank_rows(t, view, self._rules, self._microbatches)
                             for t in pair)
            yield pair

    def _rebuild(self) -> None:
        from tony_tpu_torch.train.prefetch import PrefetchIterator, to_device

        if self.member is not None and self.member not in self.members:
            self._it = iter(())          # sitting this generation out
            return
        it: Iterator[Batch] = self._generate(self.members, self.step)
        if self._prefetch > 0:
            it = PrefetchIterator(it, depth=self._prefetch, device=self._device)
        else:
            it = (to_device(batch, self._device) for batch in it)
        self._it = it

    def __iter__(self) -> "ElasticBatchStream":
        return self

    def __next__(self) -> Batch:
        batch = next(self._it)
        self.step += 1
        return batch

    @property
    def global_batch(self) -> int:
        """Live global batch rows (shrinks/grows with membership)."""
        return self.per_member * len(self.members)

    def reshard(self, members: tuple[int, ...], mesh=None) -> dict[int, tuple[int, int]]:
        """Swap membership (and the live mesh) at the current step boundary.

        Returns the skip bookkeeping delta: ``{member: (from, to)}`` —
        a newly-dead member opens ``(step, -1)``; a returning member
        closes its open range at ``(from, step)``. Survivor positions are
        untouched by construction. A rank that sat a generation out sets
        ``step`` to the boundary it rejoins at first."""
        from tony_tpu_torch.train.prefetch import close_batches

        members = tuple(sorted(members))
        delta: dict[int, tuple[int, int]] = {}
        for m in self.members:
            if m not in members:
                self.skipped.setdefault(m, []).append([self.step, -1])
                delta[m] = (self.step, -1)
        for m in members:
            if m not in self.members:
                ranges = self.skipped.get(m, [])
                if ranges and ranges[-1][1] == -1:
                    ranges[-1][1] = self.step
                    delta[m] = (ranges[-1][0], self.step)
        close_batches(self._it)
        self.members = members
        self._mesh = mesh
        self._rebuild()
        return delta

    def close(self) -> None:
        from tony_tpu_torch.train.prefetch import close_batches

        close_batches(self._it)


def reference_batches(cfg: DataConfig, n_members: int, start_step: int = 0,
                      device: str | torch.device = "cpu") -> ElasticBatchStream:
    """A full-membership elastic stream of global batches — the no-fault
    reference a loss-continuity comparison trains against (same
    substreams, no boundary)."""
    return ElasticBatchStream(cfg, n_members, tuple(range(n_members)),
                              start_step=start_step, device=device)


__all__ = ["ElasticBatchStream", "reference_batches"]
