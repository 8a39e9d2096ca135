"""Communication–compute overlap: the decomposed fsdp collectives.

The counterpart of ``tony_tpu/ops/overlap.py``. Where the reference's
partitioner would gather an fsdp-sharded weight with one blocking
all-gather per matmul and reduce its gradient with one blocking
reduce-scatter, the collective matmul decomposition (Wang et al., ASPLOS'23)
splits the gathered operand into ring chunks and runs each hop against a
chunk's matmul: a rank issues the hop (``parallel/dist.py``
:func:`~tony_tpu_torch.parallel.dist.start_hop`, the reference's
``lax.ppermute`` to the next index), runs the chunk, then waits.

Each primitive runs per rank over one mesh axis (the reference calls them
inside a shard_map manual over that axis), in the reference's two impls:
``'scan'`` multiplies each chunk in float32 with plain PyTorch, and
``'pallas'`` runs it through :func:`chunk_mm`, TPU kernel 14's port
(``csrc/overlap.cu``): the hand-written Hopper kernel for a CUDA tensor,
its plain version :func:`chunk_mm_plain` for a CPU one.

- :func:`all_gather_matmul_local`: ``x @ W`` with W sharded over the ring
  on ``gather_dim`` (0: contraction rows, partial products accumulated; 1:
  output columns, written as slices). Its backward (:class:`_AllGatherMatmul`)
  is the reference's ``_agm_bwd``: dx over the mirrored ring against W^T, dW
  through the reduce-scatter ring.
- :func:`matmul_reduce_scatter_local`: ``x^T @ g`` reduce-scattered over
  the ring, the accumulator riding it; the full product never exists.
- :func:`bucketed_psum`: the dp gradient reduction in byte-budgeted
  buckets, one all-reduce per bucket and dtype.

:func:`overlap_matmul` is the entry ``models/llama.py`` calls with this
rank's rows and weight shard; it returns None where the reference's does
(no mesh, axis size 1, already inside a ring) and the caller runs the plain
matmul. The reference's fourth case, shapes the ring cannot split evenly,
cannot arise here: the port cuts even shards only (``parallel/sharding.py``
raises otherwise).

``LAUNCHES`` counts :func:`chunk_mm`'s two paths: the kernel's launches
and the plain version's calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any

import torch

from tony_tpu_torch.ops._build import TMA_ERRORS, load
from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.mesh import (
    Mesh, get_default_mesh, inside_manual_region, manual_region,
)

_IMPLS = ("scan", "pallas")

# one count per path, bumped where the path runs: the CUDA kernel's launch
# and the plain version's call
LAUNCHES: dict[str, int] = {"chunk_mm": 0, "chunk_mm_plain": 0}

_SOURCE = "overlap"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INSTANCES = {2: "tensor cores", 0: "scalar"}
# the C entry point's own codes (other nonzero returns are cudaError_t)
_ERRORS = {-1: "no instance for this dtype", **TMA_ERRORS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pick_block(n: int, block_n: int) -> int:
    """Largest divisor of N out of (block_n, halvings of it, N itself)."""
    bn = min(block_n, n)
    while bn > 1 and n % bn:
        bn //= 2
    return bn if n % bn == 0 else n


# --- kernel 14: one ring chunk's a [M, K] @ b [K, N] -> float32 [M, N] ----------


def chunk_mm_plain(a: torch.Tensor, b: torch.Tensor, block_n: int = 256) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch: float32 products of
    the whole ``a`` and each column tile of ``b``, tiles of
    ``_pick_block(N, block_n)`` as its grid cuts them."""
    M, N = a.shape[0], b.shape[1]
    bn = _pick_block(N, block_n) if N else 1
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    a32 = a.float()
    for j in range(0, N, bn):
        out[:, j:j + bn] = a32 @ b[:, j:j + bn].float()
    return out


@functools.cache
def _kernels():
    """The C entry points, built and bound on first use."""
    lib = load(_SOURCE).lib
    lib.chunk_mm.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.chunk_mm.restype = ctypes.c_int
    lib.chunk_mm_route.argtypes = [ctypes.c_int]
    lib.chunk_mm_route.restype = ctypes.c_int
    return lib


def kernel_instance(dtype: torch.dtype) -> str:
    """Which CUDA instance :func:`chunk_mm` runs for ``dtype``, as the
    built library dispatches it: ``"tensor cores"`` (wgmma + TMA) or
    ``"scalar"`` (float32 FMA). Builds the library on first use, so it
    needs nvcc."""
    route = _kernels().chunk_mm_route(_DTYPE_CODES.get(dtype, -1))
    if route < 0:
        raise ValueError(f"chunk_mm has no instance for {dtype}")
    return _INSTANCES[route]


def _layout(t: torch.Tensor) -> tuple[torch.Tensor, int, bool]:
    """``(t, ld, transposed)`` for a 2-D view: rows contiguous (element
    (i, j) at ``i * ld + j``) or, transposed, columns contiguous (at
    ``j * ld + i``); a contiguous copy where neither holds."""
    r, c = t.shape
    if t.stride(1) == 1 or c == 1:
        return t, (t.stride(0) if r > 1 else c), False
    if t.stride(0) == 1 or r == 1:
        return t, (t.stride(1) if c > 1 else r), True
    t = t.contiguous()
    return t, c, False


def _tma_ready(t: torch.Tensor) -> tuple[torch.Tensor, int, bool]:
    """:func:`_layout` of ``t`` where TMA can read it as it lies (a
    16-byte-aligned base, a leading dimension of a multiple of 8 bf16),
    else of a contiguous copy; raises when the copy is not readable
    either. The kernel never falls back to another path."""
    t, ld, tr = _layout(t)
    if t.data_ptr() % 16 == 0 and ld % 8 == 0:
        return t, ld, tr
    t = t.contiguous()
    if t.data_ptr() % 16 or t.shape[1] % 8:
        raise ValueError(f"chunk_mm: no 16-byte-strided copy of a {tuple(t.shape)} "
                         "bf16 operand for TMA (rows must be multiples of 8)")
    return t, t.shape[1], False


def chunk_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One ring chunk's ``a [M, K] @ b [K, N]`` -> float32 ``[M, N]``:
    kernel 14 for CUDA tensors (which raise rather than fall back), the
    plain version for CPU ones. ``a`` and ``b`` are read as the views they
    are (a column slice, a transpose), copied only where the kernel cannot
    read them."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"chunk_mm shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        LAUNCHES["chunk_mm_plain"] += 1
        return chunk_mm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no chunk_mm for device {a.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"chunk_mm takes float32 or bfloat16 operands of one dtype, "
                        f"not {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"chunk_mm operands on {a.device} and {b.device}")
    (M, K), N = a.shape, b.shape[1]
    bf16 = a.dtype == torch.bfloat16
    if bf16 and N % 2:
        raise ValueError(f"chunk_mm's tensor-core instance stores column pairs: N={N} "
                         "must be even")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    a, lda, a_mn = (_tma_ready if bf16 else _layout)(a)
    b, ldb, b_k = (_tma_ready if bf16 else _layout)(b)
    err = _kernels().chunk_mm(a.data_ptr(), lda, int(a_mn), b.data_ptr(), ldb, int(b_k),
                              out.data_ptr(), M, N, K, _DTYPE_CODES[a.dtype],
                              torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_mm launch failed: {_ERRORS.get(err, f'cudaError {err}')}")
    LAUNCHES["chunk_mm"] += 1
    return out


def _chunk_mm(a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    """One ring chunk's float32 product under ``impl``."""
    if impl == "pallas":
        return chunk_mm(a, b)
    return a.float() @ b.float()


# --- the rings ------------------------------------------------------------------
# Each runs per rank over one mesh axis of n ranks. The ring operand is a
# contiguous tensor that hops to the next index; with ``trans`` the chunk
# multiplies its transpose (the backward's W^T), so no transposed copy ever
# hops. Step j holds the shard of index (my - j) mod n. The last step's hop
# would carry nothing the ring still needs, so it is not issued.


def _ring_contract(x2, w_loc, axis, impl, trans=False):
    """``sum_i x2[:, rows_i] @ W_i``: W gathered on its contraction dim.
    x2 [M, D] full width, the ring operand this rank's [D/n, N] shard."""
    n, my = axis.size, axis.index
    w_cur, y = w_loc, None
    for j in range(n):
        hop = pdist.start_hop(w_cur, axis, op="ring_contract") if j < n - 1 else None
        w = w_cur.T if trans else w_cur
        Dl = w.shape[0]
        idx = (my - j) % n
        part = _chunk_mm(x2[:, idx * Dl:(idx + 1) * Dl], w, impl)
        y = part if y is None else y + part
        if hop is not None:
            w_cur = hop.wait()
    return y


def _ring_concat(x2, w_loc, axis, impl, trans=False):
    """``y[:, cols_i] = x2 @ W_i``: W gathered on its output dim. x2 [M, D],
    the ring operand this rank's [D, N/n] column shard; the full [M, N] is
    written a column block per step."""
    n, my = axis.size, axis.index
    w_cur, y = w_loc, None
    for j in range(n):
        hop = pdist.start_hop(w_cur, axis, op="ring_concat") if j < n - 1 else None
        w = w_cur.T if trans else w_cur
        Nl = w.shape[1]
        if y is None:
            y = torch.empty((x2.shape[0], Nl * n), dtype=torch.float32, device=x2.device)
        idx = (my - j) % n
        y[:, idx * Nl:(idx + 1) * Nl] = _chunk_mm(x2, w, impl)
        if hop is not None:
            w_cur = hop.wait()
    return y


def _ring_reduce_scatter(partial_fn, axis):
    """Ring reduce-scatter of ``sum_ranks partial_fn(chunk)``: this rank's
    float32 contribution to chunk ``c`` is ``partial_fn(c)``. The
    accumulator rides the ring (chunk schedule ``(my - j - 1) mod n``, so
    a rank adds its own chunk last and the final hop lands shard ``my``
    home fully reduced); each hop flies while the next partial product
    runs."""
    n, my = axis.size, axis.index
    acc = partial_fn((my - 1) % n)
    for j in range(1, n):
        hop = pdist.start_hop(acc, axis, op="ring_reduce_scatter")
        part = partial_fn((my - j - 1) % n)
        acc = hop.wait() + part
    return acc


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"unknown overlap impl {impl!r} (scan | pallas)")


def _flat2(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _axis(axis_name: str, mesh: Mesh | None) -> pdist.Axis:
    mesh = mesh if mesh is not None else get_default_mesh()
    if mesh is None:
        raise ValueError(f"no mesh for axis {axis_name!r}: pass mesh= or set a default mesh")
    return mesh.axis(axis_name)


# --- all-gather-matmul --------------------------------------------------------


class _AllGatherMatmul(torch.autograd.Function):
    """The reference's ``all_gather_matmul_local`` custom_vjp: forward
    through the gather ring, backward ``_agm_bwd`` (dx over the mirrored
    ring against W^T, dW through the reduce-scatter ring)."""

    @staticmethod
    def forward(ctx, x, w_loc, axis, gather_dim, impl):
        ctx.save_for_backward(x, w_loc)
        ctx.axis, ctx.gather_dim, ctx.impl = axis, gather_dim, impl
        with manual_region():
            y = (_ring_contract if gather_dim == 0 else _ring_concat)(
                _flat2(x), w_loc, axis, impl)
        out_dtype = torch.promote_types(x.dtype, w_loc.dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w_loc = ctx.saved_tensors
        axis, impl = ctx.axis, ctx.impl
        x2, g2 = _flat2(x), _flat2(dy)
        with manual_region():
            if ctx.gather_dim == 0:
                # dx[:, rows_i] = dy @ W_i^T ; dW_i = sum_ranks x[:, rows_i]^T @ dy
                dx2 = _ring_concat(g2, w_loc, axis, impl, trans=True)
                Dl = w_loc.shape[0]
                dw = _ring_reduce_scatter(
                    lambda c: _chunk_mm(x2[:, c * Dl:(c + 1) * Dl].T, g2, impl), axis)
            else:
                # dx = sum_i dy[:, cols_i] @ W_i^T ; dW_i = sum_ranks x^T @ dy[:, cols_i]
                dx2 = _ring_contract(g2, w_loc, axis, impl, trans=True)
                Nl = w_loc.shape[1]
                dw = _ring_reduce_scatter(
                    lambda c: _chunk_mm(x2.T, g2[:, c * Nl:(c + 1) * Nl], impl), axis)
        return dx2.reshape(x.shape).to(x.dtype), dw.to(w_loc.dtype), None, None, None


def all_gather_matmul_local(x: torch.Tensor, w_loc: torch.Tensor, axis_name: str = "fsdp",
                            gather_dim: int = 0, impl: str = "scan", *,
                            mesh: Mesh | None = None) -> torch.Tensor:
    """``x [..., D] @ W [D, N] -> [..., N]`` with W ring-sharded on
    ``gather_dim`` over ``axis_name`` (this rank's shard ``w_loc``) and x
    this rank's rows. Exact float32 accumulation; the gathered W never
    exists. ``mesh`` defaults to the default mesh."""
    _check_impl(impl)
    return _AllGatherMatmul.apply(x, w_loc, _axis(axis_name, mesh), gather_dim, impl)


# --- matmul-reduce-scatter ----------------------------------------------------


class _MatmulReduceScatter(torch.autograd.Function):
    """The reference's ``matmul_reduce_scatter_local`` custom_vjp; the
    transpose all-gathers dy around the same ring (``_mrs_bwd``)."""

    @staticmethod
    def forward(ctx, x, g, axis, scatter_dim, impl):
        ctx.save_for_backward(x, g)
        ctx.axis, ctx.scatter_dim, ctx.impl = axis, scatter_dim, impl
        x2, g2 = _flat2(x), _flat2(g)
        n = axis.size
        with manual_region():
            if scatter_dim == 0:
                Dl = x2.shape[1] // n
                out = _ring_reduce_scatter(
                    lambda c: _chunk_mm(x2[:, c * Dl:(c + 1) * Dl].T, g2, impl), axis)
            else:
                Nl = g2.shape[1] // n
                out = _ring_reduce_scatter(
                    lambda c: _chunk_mm(x2.T, g2[:, c * Nl:(c + 1) * Nl], impl), axis)
        return out.to(torch.promote_types(x.dtype, g.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        axis, impl = ctx.axis, ctx.impl
        x2, g2 = _flat2(x), _flat2(g)
        dy = dy.contiguous()
        with manual_region():
            if ctx.scatter_dim == 0:
                dx2 = _ring_concat(g2, dy, axis, impl, trans=True)     # [M, D]
                dg2 = _ring_contract(x2, dy, axis, impl)               # [M, N]
            else:
                dx2 = _ring_contract(g2, dy, axis, impl, trans=True)   # [M, D]
                # dg[:, cols_c] = x2 @ dy_c: dy [D, Nl] is the chunk's
                # column block, concatenated around the ring
                dg2 = _ring_concat(x2, dy, axis, impl)                 # [M, N]
        return (dx2.reshape(x.shape).to(x.dtype), dg2.reshape(g.shape).to(g.dtype),
                None, None, None)


def matmul_reduce_scatter_local(x: torch.Tensor, g: torch.Tensor, axis_name: str = "fsdp",
                                scatter_dim: int = 0, impl: str = "scan", *,
                                mesh: Mesh | None = None) -> torch.Tensor:
    """``reduce_scatter(x^T @ g)`` over ``axis_name``: x [..., D], g [..., N]
    (this rank's rows) -> this rank's shard of the [D, N] product (rows for
    scatter_dim 0, columns for 1), summed over the axis."""
    _check_impl(impl)
    return _MatmulReduceScatter.apply(x, g, _axis(axis_name, mesh), scatter_dim, impl)


# --- the model's entry ----------------------------------------------------------


def overlap_matmul(x: torch.Tensor, w: torch.Tensor, *, gather_dim: int,
                   impl: str = "scan", axis_name: str = "fsdp",
                   mesh: Mesh | None = None) -> torch.Tensor | None:
    """``x [..., D] @ W`` through the ring over ``axis_name``, with ``x``
    this rank's rows and ``w`` its shard of W on ``gather_dim``; None when
    the decomposition does not apply (no mesh, axis size 1, already inside
    a ring), and the caller runs the plain matmul."""
    _check_impl(impl)
    mesh = mesh if mesh is not None else get_default_mesh()
    if mesh is None or inside_manual_region():
        return None
    if int(mesh.shape.get(axis_name, 1)) <= 1:
        return None
    return all_gather_matmul_local(x, w, axis_name, gather_dim, impl, mesh=mesh)


# --- bucketed gradient reduction ----------------------------------------------


def bucket_plan(nbytes: list[int], bucket_bytes: int) -> list[list[int]]:
    """Group leaf indices (in order) into buckets of ~bucket_bytes each.

    Order-preserving greedy fill; a leaf larger than the budget gets its
    own bucket (never split)."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    plan: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, b in enumerate(nbytes):
        if cur and cur_bytes + b > bucket_bytes:
            plan.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += b
    if cur:
        plan.append(cur)
    return plan


def _flatten(tree: Any) -> tuple[list[torch.Tensor], Any]:
    if isinstance(tree, dict):
        pairs = [_flatten(v) for v in tree.values()]
        return [t for p in pairs for t in p[0]], (dict, list(tree), [p[1] for p in pairs])
    if isinstance(tree, (list, tuple)):
        pairs = [_flatten(v) for v in tree]
        return [t for p in pairs for t in p[0]], (type(tree), None, [p[1] for p in pairs])
    return [tree], None


def _unflatten(leaves: list[torch.Tensor], spec: Any, pos: list[int]) -> Any:
    if spec is None:
        pos[0] += 1
        return leaves[pos[0] - 1]
    kind, keys, children = spec
    vals = [_unflatten(leaves, c, pos) for c in children]
    return dict(zip(keys, vals)) if kind is dict else kind(vals)


def bucketed_psum(tree: Any, axis_name: str, *, bucket_bytes: int,
                  mesh: Mesh | None = None) -> Any:
    """All-reduce a grad tree (nested dicts, lists or tuples of tensors)
    over ``axis_name`` in byte-budgeted buckets, issued in leaf order: one
    all-reduce per bucket and dtype, over the bucket's leaves laid end to
    end. Value-exact against one whole-tree all-reduce: grouping never
    changes which elements are summed."""
    leaves, spec = _flatten(tree)
    if not leaves:
        return tree
    axis = _axis(axis_name, mesh)
    out: list[Any] = list(leaves)
    if axis.size > 1:
        sizes = [t.numel() * t.element_size() for t in leaves]
        for idx in bucket_plan(sizes, bucket_bytes):
            by_dtype: dict[torch.dtype, list[int]] = {}
            for i in idx:
                by_dtype.setdefault(leaves[i].dtype, []).append(i)
            for members in by_dtype.values():
                flat = pdist.all_reduce(torch.cat([leaves[i].reshape(-1) for i in members]),
                                        axis)
                for i, part in zip(members, flat.split([leaves[i].numel() for i in members])):
                    out[i] = part.view(leaves[i].shape)
    return _unflatten(out, spec, [0])


def bucket_bytes_from_report(step_anatomy: dict[str, Any] | None, *,
                             n_layers: int,
                             default_bytes: int = 8 << 20) -> int:
    """Solve the bucket size from a measured step-anatomy section: a
    bucket's reduce hides iff it finishes within one layer's backward
    window, so ``bytes = achieved_gbps x window`` with ``window = backward
    share (2/3) x compute_ms / n_layers``. Falls back to ``default_bytes``
    without a measured bandwidth; clamped to [1 MiB, 128 MiB]."""
    if not step_anatomy or n_layers <= 0:
        return default_bytes
    top = step_anatomy.get("top_collective") or {}
    gbps = float(top.get("achieved_gbps") or 0.0)
    compute_ms = float(step_anatomy.get("compute_ms") or 0.0)
    if gbps <= 0.0 or compute_ms <= 0.0:
        return default_bytes
    window_s = (2.0 / 3.0) * (compute_ms / 1e3) / n_layers
    raw = int(gbps * 1e9 * window_s)
    return max(1 << 20, min(raw, 128 << 20))


__all__ = [
    "LAUNCHES", "all_gather_matmul_local", "bucket_bytes_from_report", "bucket_plan",
    "bucketed_psum", "chunk_mm", "chunk_mm_plain", "kernel_instance",
    "matmul_reduce_scatter_local", "overlap_matmul", "reset_launches",
]
