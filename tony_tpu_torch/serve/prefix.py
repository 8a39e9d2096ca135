"""Radix-tree prefix store: cross-request KV reuse over the paged cache.

A copy of ``tony_tpu/serve/prefix.py``, kept here so this package imports
nothing of the reference; the module is host-only Python and works on
block ids, so it needs no change for PyTorch.

At millions of users the dominant redundant serving work is re-prefilling
the shared system/template prefix on every request. This module is the
sharing policy over serve/cache.py's physical-block pool (SGLang
RadixAttention lineage, arXiv:2312.07104, over vLLM-style paged KV,
arXiv:2309.06180):

- the tree is keyed by **token blocks**: each node owns exactly one
  ``kv_block``-sized token chunk and the physical block holding that
  chunk's K/V across all layers; a path root -> node spells a prefix;
- **admission matching** walks full chunks by hash (dict lookup per
  block), then extends *into* the next block by longest common token
  prefix — so a match can end mid-block;
- matched full blocks are mapped **shared** into the slot's table (the
  slot takes a pool reference, never writes them — prefill starts at the
  match boundary and decode appends strictly beyond the prompt);
- a mid-block match is the **copy-on-write** case: the slot would write
  its unshared tail into that block, so admission hands it a private copy
  first (``MatchResult.partial`` names the source block to copy);
- after prefill the prompt's full blocks are **inserted**, each new node
  taking its own pool reference — the slot can finish and free, the
  prefix stays resident;
- unreferenced-by-slots nodes persist until **LRU-by-leaf eviction**
  under the ``serve.prefix.budget_mb`` HBM budget (or allocation
  pressure): leaves drop in last-use order, releasing their pool
  reference — a block still referenced by a live slot leaves the *index*
  but frees no HBM until that slot finishes.

The store is pure host-side bookkeeping: matching and hashing run on the
admission path in plain Python (GL001 — no host syncs in jitted code; the
device only ever sees block tables). ``_lock`` guards tree mutations
against concurrent stats readers (RPC threads calling
``Engine.stats_snapshot``); nothing blocking runs under it (GL004).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Sequence


class _Node:
    """One token block: ``chunk`` (the block's tokens), ``phys`` (the
    physical block id holding its K/V), children keyed by their full
    chunk tuple (hash lookup per block on the match walk)."""

    __slots__ = ("chunk", "phys", "parent", "children", "last_used", "hits")

    def __init__(self, chunk: tuple[int, ...], phys: int, parent: "_Node | None"):
        self.chunk = chunk
        self.phys = phys
        self.parent = parent
        self.children: dict[tuple[int, ...], _Node] = {}
        self.last_used = 0
        self.hits = 0


class MatchResult(NamedTuple):
    """Longest cached prefix of a prompt.

    ``length`` tokens matched; ``full`` — physical block ids covering the
    matched *full* blocks (safe to map shared); ``partial`` — physical id
    of the block a mid-block match ended in (the COW source: the slot
    must copy it before writing its tail), or None when the match ended
    exactly on a block boundary.
    """

    length: int
    full: tuple[int, ...]
    partial: int | None


class PrefixStore:
    """See module docstring. One instance per engine; ``block`` must be
    the engine's ``kv_block`` and ``block_bytes`` the HBM cost of one
    physical block (serve/cache.py:block_bytes)."""

    def __init__(self, block: int, block_bytes: int, budget_bytes: int = 0):
        self.block = int(block)
        self.block_bytes = int(block_bytes)
        # 0 = unbounded (tests); the engine passes serve.prefix.budget_mb
        self.budget_bytes = int(budget_bytes)
        self._root = _Node((), -1, None)
        self._lock = threading.Lock()
        self._clock = 0
        self._n_nodes = 0
        self.hit_tokens = 0      # tokens served from the store (cumulative)
        self.prompt_tokens = 0   # prompt tokens seen (hit-rate denominator)
        self.evicted_blocks = 0

    # --- stats ----------------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def resident_bytes(self) -> int:
        """HBM pinned by the tree's own references (one block per node)."""
        return self._n_nodes * self.block_bytes

    @property
    def hit_rate(self) -> float:
        if not self.prompt_tokens:
            return 0.0
        return self.hit_tokens / self.prompt_tokens

    def stats(self) -> dict[str, float]:
        with self._lock:
            return {
                "prefix_nodes": float(self._n_nodes),
                "prefix_resident_mb": round(self.resident_bytes / 2**20, 3),
                "prefix_hit_tokens": float(self.hit_tokens),
                "prefix_hit_rate": round(self.hit_rate, 4),
                "prefix_evicted_blocks": float(self.evicted_blocks),
            }

    # --- matching -------------------------------------------------------------

    def _walk_locked(
        self, tokens: Sequence[int], limit: int
    ) -> tuple[_Node, list[_Node], int, "_Node | None", int]:
        """THE radix walk (caller holds ``_lock``): full chunks by hash,
        then longest-common-prefix into the best child — shared by
        admission matching and the speculative draft source
        (``longest_extension``) so the two can never diverge. Returns
        ``(node, full_nodes, matched, best, best_cp)``: the deepest
        fully-matched node, the full-chunk chain under it, total tokens
        matched, and the partially-entered child (``best_cp`` of its
        chunk consumed) or None when the match ends on a boundary."""
        B = self.block
        node = self._root
        full_nodes: list[_Node] = []
        i = 0
        while i < limit:
            if limit - i >= B:
                child = node.children.get(tuple(tokens[i:i + B]))
                if child is not None:
                    node = child
                    full_nodes.append(node)
                    i += B
                    continue
            # no full-chunk match left: extend into the best child by
            # longest common token prefix (the mid-block / COW case)
            want = tuple(tokens[i:limit])
            best_cp = 0
            best: _Node | None = None
            for child in node.children.values():
                cp = _common_prefix(child.chunk, want)
                if cp > best_cp:
                    best_cp, best = cp, child
            return node, full_nodes, i + best_cp, best, best_cp
        return node, full_nodes, i, None, 0

    def match(self, tokens: Sequence[int], limit: int) -> MatchResult:
        """Longest cached prefix of ``tokens[:limit]``. ``limit`` is the
        admission cap (``plen - 1``: at least one token must remain for
        prefill to compute the first sampled logits). Accounts the hit
        into the hit-rate counters."""
        full: list[int] = []
        partial: int | None = None
        with self._lock:
            self._clock += 1
            node, full_nodes, i, best, _cp = self._walk_locked(tokens, limit)
            for n in full_nodes:
                n.last_used = self._clock
                n.hits += 1
                full.append(n.phys)
            if best is not None:
                best.last_used = self._clock
                best.hits += 1
                partial = best.phys
            # touch the matched chain so no ancestor is ever older than a
            # descendant (eviction is leaf-first, LRU by leaf)
            walk = node
            while walk is not self._root:
                walk.last_used = self._clock
                walk = walk.parent
        return MatchResult(i, tuple(full), partial)

    def longest_extension(self, tokens: Sequence[int], max_k: int) -> list[int]:
        """Up to ``max_k`` tokens the store predicts follow ``tokens``:
        walk the radix path the WHOLE context follows (the exact
        ``match`` semantics via ``_walk_locked`` — full chunks by hash,
        then longest common prefix into the best child, so a context may
        end mid-block), then read onward along the tree, descending into
        the most-hit child at each node boundary. Returns ``[]`` when the
        context leaves the tree — the store has never observed any
        continuation of it. The speculative draft source (serve/spec.py):
        pure host-side python (GL001), and read-only — drafting touches
        neither the LRU clock nor the hit counters, so it cannot perturb
        eviction order or the admission hit-rate."""
        if max_k <= 0:
            return []
        out: list[int] = []
        with self._lock:
            node, _full, matched, best, best_cp = self._walk_locked(
                tokens, len(tokens)
            )
            if matched != len(tokens):
                return []
            if best is not None:
                # mid-block end: the remainder of the partially-entered
                # chunk is the first (and already-ordered) continuation
                out.extend(best.chunk[best_cp:])
                node = best
            while len(out) < max_k and node.children:
                node = max(
                    node.children.values(),
                    key=lambda c: (c.hits, c.last_used),
                )
                out.extend(node.chunk)
        return out[:max_k]

    def record_prompt(self, plen: int, hit: int) -> None:
        """Hit-rate accounting: ``hit`` of ``plen`` prompt tokens were
        served from the store (the engine calls this per admission with
        the match length it actually *used*)."""
        with self._lock:
            self.prompt_tokens += int(plen)
            self.hit_tokens += int(hit)

    # --- insertion ------------------------------------------------------------

    def insert(self, tokens: Sequence[int], phys: Sequence[int], retain) -> int:
        """Register the full blocks of ``tokens`` (length must be a
        multiple of ``block``): walk existing nodes, create the rest with
        the slot's physical ids from ``phys``. Each *created* node calls
        ``retain(pid)`` — the tree's own pool reference, independent of
        the inserting slot's. Returns the number of nodes created."""
        B = self.block
        n_full = len(tokens) // B
        created = 0
        with self._lock:
            self._clock += 1
            node = self._root
            for bi in range(n_full):
                chunk = tuple(tokens[bi * B:(bi + 1) * B])
                child = node.children.get(chunk)
                if child is None:
                    child = _Node(chunk, int(phys[bi]), node)
                    retain(child.phys)
                    node.children[chunk] = child
                    self._n_nodes += 1
                    created += 1
                child.last_used = self._clock
                node = child
        return created

    # --- eviction -------------------------------------------------------------

    def evict_lru(self, release) -> int | None:
        """Drop the least-recently-used *leaf* and release its pool
        reference via ``release(pid)``. Returns the freed physical id, or
        None when the tree is empty. The block's HBM frees only when no
        live slot still references it (release returns False then — the
        index entry is gone either way)."""
        with self._lock:
            leaf = self._lru_leaf()
            if leaf is None:
                return None
            del leaf.parent.children[leaf.chunk]
            self._n_nodes -= 1
            self.evicted_blocks += 1
            pid = leaf.phys
        release(pid)
        return pid

    def evict_to_budget(self, release) -> int:
        """LRU-evict leaves until resident bytes fit the budget (0 =
        unbounded). Returns how many nodes were dropped."""
        if not self.budget_bytes:
            return 0
        dropped = 0
        while self.resident_bytes > self.budget_bytes:
            if self.evict_lru(release) is None:
                break
            dropped += 1
        return dropped

    def _lru_leaf(self) -> _Node | None:
        # walk the whole tree for the oldest leaf: tree sizes are bounded
        # by the block budget, so O(nodes) here beats carrying a heap
        # through every match/insert touch
        best: _Node | None = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif node is not self._root:
                if best is None or node.last_used < best.last_used:
                    best = node
        return best


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def fingerprint(tokens: Sequence[int], n: int) -> int | None:
    """Routing fingerprint of a prompt's leading ``n`` tokens (the
    frontend's prefix-affinity key, serve/frontend.py). None when the
    prompt is shorter than ``n`` — too little shared prefix to be worth
    pinning a host for."""
    if n <= 0 or len(tokens) < n:
        return None
    return hash(tuple(int(t) for t in tokens[:n]))


__all__ = ["MatchResult", "PrefixStore", "fingerprint"]
