"""Mixture-of-Experts FFN on one device.

The counterpart of ``tony_tpu/parallel/moe.py``. Three interchangeable
dispatches behind ``MoEConfig.dispatch``, as there:

- ``'grouped'`` (the default): dropless grouped GEMM (MegaBlocks,
  arXiv:2211.15841). Routes are laid out by expert into ragged contiguous
  groups and the expert FFN runs as three grouped matmuls over
  block-aligned row tiles (``ops/grouped_mm.py``: the CUDA kernels under
  ``gmm_impl='pallas'``, the plain version under ``'scan'``). Nothing is
  dropped and nothing is padded beyond one row tile per expert.
- ``'gather'``: scatter/gather into fixed ``[E, C]`` capacity slots;
  over-capacity routes are dropped.
- ``'einsum'``: GShard/Switch one-hot dispatch/combine einsums over the same
  slots, the parity reference for the others.

The router, its softmax, the gates and the Switch aux loss are float32
whatever the activations' dtype; the expert FFN runs in the input dtype.
The grouped path has no host sync: group sizes are one-hot sums into a
fixed ``[E]``, each route's row in the padded buffer comes from a cumsum,
and every shape is static.

Over a mesh (the default mesh, ``parallel/mesh.py``, of more than one
rank; the reference's GSPMD sees the global batch where a rank here holds
its rows of it, split over the rules' batch axes dp, fsdp and ep):

- the router's statistics are the global batch's: the per-expert route
  counts and probability sums are all-reduced over the batch axes under
  autograd (the backward an all-reduce, the transpose of a psum), so the
  aux loss is the reference's over every token;
- with ``ep > 1`` the grouped dispatch is the reference's
  ``_moe_grouped_ep``: each rank routes its rows, all-gathers them (and
  their routes) over ep into its (dp, fsdp) block, runs the grouped FFN
  for its ``E / ep`` local experts (``_chunk_ffn``; routes to other
  ranks' experts ride along to local group 0 at weight 0, so shapes stay
  static and nothing syncs with the host), and reduce-scatters the
  ``[T_ep, D]`` partial over ep back to its rows: the reference's psum
  and GSPMD's slice. ``overlap_impl`` splits that combine into token
  chunks that overlap the FFN (``ops/moe_overlap.py``);
- the capacity dispatches ('gather', 'einsum') place routes by queue
  positions over the global batch and are not ported over a mesh: they
  raise.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.nn.functional as F

from tony_tpu_torch._device import resolve_device
from tony_tpu_torch.ops.grouped_mm import grouped_layout, grouped_matmul
from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.mesh import Mesh, get_default_mesh

# the mesh axes a batch's rows are split over (DEFAULT_RULES["batch"])
BATCH_AXES = ("dp", "fsdp", "ep")


@dataclass(frozen=True)
class MoEConfig:
    dim: int
    ffn_dim: int
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # 'grouped' (dropless grouped GEMM), 'gather' (capacity slots by
    # scatter/gather) or 'einsum' (capacity slots by one-hot einsums)
    dispatch: str = "grouped"
    # dispatch='grouped': row-tile size of the grouped GEMM; each expert's
    # ragged group is padded up to a multiple of it
    group_block: int = 128
    # dispatch='grouped': 'scan' (the plain version, any device) | 'pallas'
    # (the CUDA kernels for CUDA tensors)
    gmm_impl: str = "scan"
    # dispatch='grouped' on an ep mesh: 'off' keeps the single blocking
    # combine; 'scan' | 'pallas' split it into token chunks whose
    # reduce-scatters overlap the next chunk's FFN (ops/moe_overlap.py),
    # the impl naming the chunk FFN's grouped-matmul kernel
    overlap_impl: str = "off"
    # overlap_impl != 'off': tokens per combine chunk, per (dp, fsdp)
    # block of ep-gathered rows (0: the largest clean split in {4, 3, 2});
    # a size that does not divide them keeps the single combine
    overlap_chunk: int = 0

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token slots, rounded up to a multiple of 8 as the
        reference rounds them."""
        cap = max(1, int(math.ceil(self.capacity_factor * self.top_k * n_tokens
                                   / self.n_experts)))
        return -(-cap // 8) * 8


def init_moe_params(cfg: MoEConfig, generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device | None = None) -> dict[str, torch.Tensor]:
    """Random expert parameters in the reference's layout: normals scaled
    by ``1/sqrt(fan_in)``, the router in float32. ``device=None`` means
    CUDA, and raises without it."""
    device = resolve_device(device)
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts

    def dense(shape, fan_in, dt=dtype):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dt)

    return {"router": dense((d, e), d, torch.float32), "w1": dense((e, d, f), d),
            "w3": dense((e, d, f), d), "w2": dense((e, f, d), f)}


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot by comparison (no host sync on any device)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).float()


def _cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, dim=0)`` of a ``[N, C]`` count matrix (N large, C
    the few experts), through one scan of its transpose flattened: on CUDA
    a dim-0 scan over few columns runs nearly serially along N (5 ms at
    N = 32,768, C = 8 on an H100), a 1-D scan in parallel. The counts are
    integers, exact in either order (float32 below 2^24)."""
    N, C = x.shape
    flat = torch.cumsum(x.t().reshape(-1), dim=0).reshape(C, N)
    # each column's scan also counted every earlier column's total
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return (flat - before[:, None]).t()


def _route_tokens(T: int, k: int, device) -> torch.Tensor:
    """[T * k] token index of each route, token-major (0, 0, 1, 1, ...)."""
    return torch.arange(T, device=device).unsqueeze(1).expand(T, k).reshape(-1)


def _batch_axes(mesh: Mesh | None) -> list[pdist.Axis]:
    """The batch axes of ``mesh`` this rank's rows are split over (size
    above 1); none without a mesh."""
    if mesh is None:
        return []
    return [mesh.axis(a) for a in BATCH_AXES if mesh.shape[a] > 1]


def _top_k_select(probs: torch.Tensor, cfg: MoEConfig):
    """One top-k routing pass shared by every dispatch.

    probs: [T, E]. Returns ``(experts [T, k] int32, gates [T, k] float32,
    pos [T, k] int32, aux float32 scalar)``: each token's chosen experts,
    their router probabilities, the token's place in each chosen expert's
    queue, and the Switch load-balancing loss. Selection is k rounds of
    argmax-and-mask: ``torch.argmax`` returns the first maximal index, so
    ties go to the lower expert index, as ``lax.top_k`` breaks them
    (``torch.topk`` documents no order). Queue places are round-major
    (every token's round-0 pick queues before any round-1 pick), one cumsum
    over the ``[k*T, E]`` route sequence."""
    T, E = probs.shape
    k = cfg.top_k
    p32 = probs.float()
    masked = p32.detach().clone()
    picks = []
    for _ in range(k):
        idx = masked.argmax(dim=-1, keepdim=True)
        picks.append(idx)
        masked.scatter_(1, idx, -1.0)          # below every probability
    sel = torch.cat(picks, dim=1)                                # [T, k]
    gates = p32.gather(1, sel)
    onehot = _one_hot(sel, E)                                    # [T, k, E]
    rm = onehot.transpose(0, 1).reshape(k * T, E)                # round-major
    pos_rm = _cumsum_rows(rm) - rm                               # [k*T, E]
    pos = (pos_rm.reshape(k, T, E).transpose(0, 1) * onehot).sum(-1)
    # Switch eq. 4: E * sum(frac_routed * mean_prob)
    importance = onehot.mean(dim=0).sum(dim=0)                   # [E]
    aux = cfg.n_experts * torch.sum(importance / k * p32.mean(dim=0))
    return sel.to(torch.int32), gates, pos.to(torch.int32), aux


def _route(probs: torch.Tensor, cfg: MoEConfig, mesh: Mesh | None):
    """(experts [T, k], gates [T, k], aux) of :func:`_top_k_select`, the
    aux loss over ``mesh``'s global batch: each expert's route count and
    probability sum are summed over the batch axes (the probability sums
    differentiably), then divided by the global token count."""
    sel, gates, _, aux = _top_k_select(probs, cfg)     # pos unused: dropless
    axes = _batch_axes(mesh)
    if axes:
        E, k = cfg.n_experts, cfg.top_k
        counts = _one_hot(sel.reshape(-1), E).sum(dim=0)
        stats = pdist.all_reduce_ad(torch.cat([counts, probs.float().sum(dim=0)]), axes)
        n = probs.shape[0] * math.prod(a.size for a in axes)
        aux = E * torch.sum(stats[:E] / n / k * (stats[E:] / n))
    return sel, gates, aux


def routing_stats(probs: torch.Tensor, cfg: MoEConfig) -> dict[str, float]:
    """Routing health under the capacity semantics: the route fraction the
    fixed [E, C] slots would drop, and the expert load imbalance (max/mean
    assigned routes). Reads the values back to the host: not for the
    step's path."""
    T = probs.shape[0]
    sel, _, pos, _ = _top_k_select(probs, cfg)
    cap = cfg.capacity(T)
    kept = (pos < cap).float().mean()
    counts = _one_hot(sel.reshape(-1), cfg.n_experts).sum(dim=0)
    imb = counts.max() / torch.clamp(counts.mean(), min=1.0)
    return {
        "dropped_frac": round(float(1.0 - kept), 4),
        "load_imbalance": round(float(imb), 3),
        "capacity": int(cap),
        "capacity_factor": cfg.capacity_factor,
    }


def _top_k_dispatch(probs: torch.Tensor, cfg: MoEConfig, capacity: int):
    """(dispatch [T, E, C] in {0, 1}, combine [T, E, C] float32 gates
    renormalised over the kept selections, aux). Routes past an expert's
    capacity are dropped (combine weight zero), the Switch/GShard
    contract."""
    E = probs.shape[1]
    sel, gates, pos, aux = _top_k_select(probs, cfg)
    within = (pos < capacity).float()                            # [T, k]
    oh_e = _one_hot(sel, E)                                      # [T, k, E]
    oh_c = _one_hot(torch.clamp(pos, 0, capacity - 1), capacity)  # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", oh_e * within[..., None], oh_c)
    combine = torch.einsum("tke,tkc->tec", oh_e * (gates * within)[..., None], oh_c)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    return dispatch, combine / torch.clamp(denom, min=1e-9), aux


def _expert_ffn(params: dict[str, Any], expert_in: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert, ``[E, C, D] -> [E, C, D]``."""
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["w1"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, params["w3"])
    return torch.einsum("ecf,efd->ecd", h, params["w2"])


def _moe_gather(params: dict[str, Any], flat: torch.Tensor, cfg: MoEConfig,
                capacity: int, probs: torch.Tensor):
    """Scatter/gather capacity dispatch: the slot->token map (one int32
    scatter), tokens gathered into [E, C, D], the expert FFN, and each
    token's expert outputs gathered back gate-weighted. The einsum
    reference's drop semantics with no routing matmuls."""
    T, D = flat.shape
    E, k = cfg.n_experts, cfg.top_k
    sel, gates, pos, aux = _top_k_select(probs, cfg)
    valid = pos < capacity                                       # [T, k]
    flat_slot = (sel * capacity + torch.clamp(pos, 0, capacity - 1)).reshape(T * k)
    tok = _route_tokens(T, k, flat.device)
    # slot -> token; empty slots point at T, a zero pad row. Dropped routes
    # land on one extra slot that is cut off (the reference's mode="drop");
    # kept slots are unique, so one scatter covers all k rounds
    target = torch.where(valid.reshape(T * k), flat_slot, E * capacity).long()
    slot_token = torch.full((E * capacity + 1,), T, dtype=torch.long,
                            device=flat.device).scatter(0, target, tok)[:-1]
    padded = torch.cat([flat, flat.new_zeros((1, D))], dim=0)
    expert_out = _expert_ffn(params, padded[slot_token].reshape(E, capacity, D))
    denom = torch.clamp((gates * valid).sum(dim=1), min=1e-9)      # [T]
    out_flat = expert_out.reshape(E * capacity, D)
    tok_out = out_flat[torch.where(valid.reshape(T * k), flat_slot, 0).long()]
    w = ((gates * valid) / denom[:, None]).reshape(T * k).to(flat.dtype)
    y = flat.new_zeros((T, D)).index_add(0, tok, w[:, None] * tok_out)
    return y, aux


# --- grouped (dropless) dispatch ----------------------------------------------


def route_rows(group: torch.Tensor, n_groups: int, block: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each of ``R`` routes goes in the block-aligned buffer:
    ``(dst [R] int64, sizes [G] int32, tile_group [n_tiles] int32)``, with
    the static ``n_tiles = cdiv(R, block) + G``. A route's row is its
    group's aligned start plus its rank among the group's routes in route
    order: the place the reference's stable sort by group gives it
    (:248-254), counted here by one cumsum with no sort and no host sync
    (sizes are a one-hot sum, not a bincount)."""
    R = group.shape[0]
    onehot = (group.unsqueeze(1) == torch.arange(n_groups, device=group.device)
              ).to(torch.int32)                                   # [R, G]
    sizes = onehot.sum(dim=0, dtype=torch.int32)
    rank = (_cumsum_rows(onehot) * onehot).sum(dim=1) - 1          # [R]
    n_tiles = -(-R // block) + n_groups     # static bound: 1 part tile/group
    starts, tile_group = grouped_layout(sizes, block, n_tiles)
    dst = starts.long().index_select(0, group.long()) + rank
    return dst, sizes, tile_group


def _grouped_ffn(params: dict[str, Any], flat: torch.Tensor, tok: torch.Tensor,
                 group: torch.Tensor, weight: torch.Tensor, n_groups: int,
                 cfg: MoEConfig) -> torch.Tensor:
    """Grouped-GEMM expert FFN over a flat route list.

    ``tok``/``group``/``weight``: [R] routes, the token row each reads, its
    expert group, and its combine weight. Token rows are copied into the
    block-aligned buffer (:func:`route_rows`), the SwiGLU FFN runs as three
    grouped matmuls, and the weighted outputs are added back per token.
    Returns [T, D]."""
    T, D = flat.shape
    block = cfg.group_block
    dst, _, tile_group = route_rows(group, n_groups, block)
    n_tiles = tile_group.shape[0]
    # out of place: every buffer row that no route fills stays zero
    x_pad = flat.new_zeros((n_tiles * block, D)).index_copy(
        0, dst, flat.index_select(0, tok))
    h = (F.silu(grouped_matmul(x_pad, params["w1"], tile_group, impl=cfg.gmm_impl))
         * grouped_matmul(x_pad, params["w3"], tile_group, impl=cfg.gmm_impl))
    y_pad = grouped_matmul(h, params["w2"], tile_group, impl=cfg.gmm_impl)
    contrib = weight.to(flat.dtype)[:, None] * y_pad.index_select(0, dst)
    # each token gets its k routes added onto zero. For k = 2 the sum is
    # exact in either order (0 + a + b), so the atomics of a CUDA
    # index_add give one answer; for k > 2 the order would round
    return flat.new_zeros((T, D)).index_add(0, tok, contrib)


def _moe_grouped(params: dict[str, Any], flat: torch.Tensor, cfg: MoEConfig,
                 probs: torch.Tensor, mesh: Mesh | None = None):
    """Dropless grouped dispatch: every route is served, the combine weight
    is the gate renormalised over all k selections."""
    T = flat.shape[0]
    k = cfg.top_k
    sel, gates, aux = _route(probs, cfg, mesh)
    denom = torch.clamp(gates.sum(dim=1), min=1e-9)
    tok = _route_tokens(T, k, flat.device)
    weight = (gates / denom[:, None]).reshape(T * k)
    y = _grouped_ffn(params, flat, tok, sel.reshape(T * k), weight,
                     cfg.n_experts, cfg)
    return y, aux


def _chunk_ffn(w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
               flat: torch.Tensor, sel: torch.Tensor, weight: torch.Tensor, *,
               cfg: MoEConfig, e_local: int, offset: int) -> torch.Tensor:
    """The rank-local grouped FFN over rows ``flat [t, D]`` and their routes
    ``sel``/``weight [t, k]``: the routes to this rank's ``e_local``
    experts (from ``offset``) run through them, every other route rides
    along to local group 0 at weight 0. Returns the local partial ``[t,
    D]``; the combine over ep stays with the caller."""
    t, k = flat.shape[0], cfg.top_k
    rel = sel - offset
    mine = (rel >= 0) & (rel < e_local)
    group = torch.where(mine, rel, 0).reshape(t * k)
    wgt = torch.where(mine, weight, 0.0).reshape(t * k)
    return _grouped_ffn({"w1": w1, "w3": w3, "w2": w2}, flat,
                        _route_tokens(t, k, flat.device), group, wgt, e_local, cfg)


def _moe_grouped_ep(params: dict[str, Any], flat: torch.Tensor, cfg: MoEConfig,
                    probs: torch.Tensor, mesh: Mesh):
    """Expert-parallel grouped dispatch (see the module docstring).
    ``params``' expert weights are this rank's ``E / ep`` experts; the rows
    gathered over ep are this rank's (dp, fsdp) block in index order,
    because ep is the innermost of the batch axes that cut the rows
    (``train/data.py``)."""
    from tony_tpu_torch.ops.moe_overlap import overlap_chunks, overlapped_combine

    ep = mesh.axis("ep")
    e_local = cfg.n_experts // ep.size
    sel, gates, aux = _route(probs, cfg, mesh)
    weight = gates / torch.clamp(gates.sum(dim=1), min=1e-9)[:, None]   # [T, k]
    flat_g = pdist.all_gather_ad(flat, ep, 0)
    sel_g = pdist.all_gather(sel, ep, 0)
    weight_g = pdist.all_gather_ad(weight, ep, 0)
    w = (params["w1"], params["w3"], params["w2"])
    n_chunks = None
    if cfg.overlap_impl not in ("", "off"):
        # the reference's chunk count over the (dp, fsdp) block's rows; it
        # must also split this rank's rows, else the single combine runs
        n_chunks = overlap_chunks(flat_g.shape[0], cfg.overlap_chunk)
        if n_chunks is not None and flat.shape[0] % n_chunks:
            n_chunks = None
    local = functools.partial(_chunk_ffn, e_local=e_local, offset=ep.index * e_local)
    if n_chunks is not None:
        # the overlap impl names the chunk FFN's grouped-matmul kernel
        ffn = functools.partial(local, cfg=replace(cfg, gmm_impl=cfg.overlap_impl))
        y = overlapped_combine(ffn, ep, n_chunks, *w, flat_g, sel_g, weight_g)
    else:
        y = pdist.reduce_scatter_ad(local(*w, flat_g, sel_g, weight_g, cfg=cfg), ep, 0)
    return y, aux


def _moe_grouped_entry(params: dict[str, Any], flat: torch.Tensor, cfg: MoEConfig,
                       probs: torch.Tensor, mesh: Mesh | None):
    """The reference's ``_moe_grouped_entry``: the ep path where the mesh
    has ep above 1 (and tp 1, and experts that ep divides); else the plain
    grouped path, whose statistics are the mesh's global batch's. Where the
    reference would fall back to GSPMD over an ep-sharded expert dim (tp
    above 1, E not a multiple of ep), the port raises: it holds no such
    blocks (tp is refused by the trainer, uneven blocks by the sharding).
    The reference's third condition, rows that dp x fsdp split evenly,
    always holds here: each rank holds its own even block of the rows
    (``train/data.py`` raises otherwise)."""
    ep = mesh.shape["ep"] if mesh is not None else 1
    if ep > 1:
        if mesh.shape["tp"] > 1:
            raise NotImplementedError("MoE over ep x tp is not ported yet (ROADMAP "
                                      "queue 1, item 8)")
        if cfg.n_experts % ep:
            raise ValueError(f"{cfg.n_experts} experts do not split over ep={ep}: the "
                             "port cuts even blocks only")
        return _moe_grouped_ep(params, flat, cfg, probs, mesh)
    return _moe_grouped(params, flat, cfg, probs, mesh)


def moe_block(params: dict[str, Any], x: torch.Tensor, cfg: MoEConfig):
    """MoE SwiGLU FFN: x ``[B, S, D]`` -> (y ``[B, S, D]``, aux float32
    scalar). Capacity dispatches pass dropped tokens through with a zero
    FFN delta (the residual outside keeps them); 'grouped' serves every
    route. Over the default mesh (more than one rank) ``x`` is this rank's
    rows, the router whole, and with ep above 1 the expert weights this
    rank's ``E / ep`` experts; ``aux`` is the global batch's."""
    B, S, D = x.shape
    T = B * S
    flat = x.reshape(T, D)
    mesh = get_default_mesh()
    if mesh is not None and mesh.size == 1:
        mesh = None
    if cfg.dispatch == "grouped" and cfg.overlap_impl not in ("", "off", "scan", "pallas"):
        raise ValueError(f"unknown MoE overlap impl {cfg.overlap_impl!r}; "
                         "expected 'off' | 'scan' | 'pallas'")
    if mesh is not None and cfg.dispatch != "grouped":
        raise NotImplementedError(
            f"dispatch={cfg.dispatch!r} over a mesh of more than one rank (capacity "
            "slots over the global batch) is not ported yet (ROADMAP queue 1, item 8); "
            "use 'grouped'")

    # router math is always float32: a bf16 softmax loses about two
    # decimal digits, and the aux loss is a mean of small fractions
    logits = flat.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)

    if cfg.dispatch == "grouped":
        y, aux = _moe_grouped_entry(params, flat, cfg, probs, mesh)
        return y.reshape(B, S, D), aux
    capacity = cfg.capacity(T)
    if cfg.dispatch == "gather":
        y, aux = _moe_gather(params, flat, cfg, capacity, probs)
        return y.reshape(B, S, D), aux
    if cfg.dispatch != "einsum":
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")
    dispatch, combine, aux = _top_k_dispatch(probs, cfg, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), flat)
    expert_out = _expert_ffn(params, expert_in)
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return y.reshape(B, S, D), aux


__all__ = [
    "MoEConfig", "init_moe_params", "moe_block", "route_rows",
    "routing_stats",
]
