"""Grouped (ragged) matmul: one GEMM over per-expert row groups.

The counterpart of ``tony_tpu/ops/grouped_mm.py``, the MoE dispatch's
matmul (MegaBlocks, arXiv:2211.15841): routes sorted by expert into
contiguous row groups, each padded up to a multiple of a row tile, and the
expert FFN run as one matmul stream in which row tile ``i`` contracts
against expert ``tile_group[i]``'s weights. The caller owns the layout:
:func:`grouped_layout` gives the block-aligned starts and the tile->group
map, ``parallel/moe.py`` scatters rows into it.

Two implementations behind :func:`grouped_matmul`, as in the reference:

- ``'scan'``: the plain version :func:`gmm_fwd_plain` (one float32 matmul
  per row tile) on any device, differentiated by autograd. The
  reference's ``lax.scan`` is XLA, not a kernel.
- ``'pallas'``: three hand-written CUDA kernels (``csrc/grouped_mm.cu``,
  built with ``nvcc`` at first use by ``ops/_build.py``) replace the three
  Pallas kernels: ``gmm_fwd``, ``gmm_dx`` (contracting w's last dim in
  place) and ``gmm_dw`` (float32, cast to w's dtype by the backward, as
  ``_gmm_pallas_bwd`` does). CUDA tensors launch them or raise; CPU
  tensors take :func:`gmm_fwd_plain`, :func:`gmm_dx_plain` and
  :func:`gmm_dw_plain`, which the tests hold against the reference. In
  bf16 at row tiles of a multiple of 128 rows (the training path's) all
  three run on wgmma with TMA staging, at other row tiles on mma.sync
  tiles; float32 runs scalar FMA (:func:`kernel_instance` says which).

``LAUNCHES`` counts both paths. The forward and the backward are
``torch.library`` custom ops (``tony_tpu_torch::gmm`` and ``::gmm_bwd``):
a ctypes launch is invisible to PyTorch's dispatcher, and an op it can see
is what a selective-checkpoint policy decides about (the training policies
leave it to be recomputed, as JAX's ``save_attn_kernel`` does).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tony_tpu_torch.ops._build import TMA_ERRORS, load

# one count per path, bumped where the path runs: the CUDA kernel's launch
# and the plain version's dispatch
LAUNCHES: dict[str, int] = {
    "gmm_fwd": 0, "gmm_dx": 0, "gmm_dw": 0,
    "gmm_fwd_plain": 0, "gmm_dx_plain": 0, "gmm_dw_plain": 0,
}

_SOURCE = "grouped_mm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128                 # the kernels' output tile (csrc/grouped_mm.cu kTile)
_MAX_GRID_Y = 65535         # CUDA's grid.y limit: row tiles x 128-row slices
_KERNEL_CODES = {"gmm_fwd": 0, "gmm_dx": 1, "gmm_dw": 2}
_INSTANCES = {2: "tensor cores", 1: "mma.sync", 0: "scalar"}
# the C entry points' own codes (other nonzero returns are cudaError_t)
_ERRORS = {-1: "no instance for this dtype", **TMA_ERRORS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def grouped_layout(group_sizes: torch.Tensor, block: int, n_tiles: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-aligned ragged layout for ``G`` row groups.

    ``group_sizes``: [G] integers. Returns ``(aligned_starts [G], tile_group
    [n_tiles] int32)``: group ``g``'s rows occupy ``aligned_starts[g] ..
    aligned_starts[g] + group_sizes[g]`` in a buffer of ``n_tiles * block``
    rows, every start a multiple of ``block``, and ``tile_group[i]`` is the
    group row tile ``i`` belongs to. Every group gets at least one tile (a
    zero-load expert still has a defined, zero, dW block) and trailing
    tiles clamp to ``G - 1`` (their rows are zero padding). ``n_tiles`` must
    be a static bound of at least ``cdiv(sum(sizes), block) + G``. All on
    the sizes' device, with no host sync."""
    g = group_sizes.shape[0]
    tiles_per = torch.clamp((group_sizes + block - 1) // block, min=1)
    tile_cum = torch.cumsum(tiles_per, 0).to(group_sizes.dtype)
    aligned_starts = (tile_cum - tiles_per) * block
    idx = torch.arange(n_tiles, dtype=tile_cum.dtype, device=tile_cum.device)
    tile_group = torch.searchsorted(tile_cum, idx, right=True).clamp_(0, g - 1)
    return aligned_starts, tile_group.to(torch.int32)


# --- plain versions -------------------------------------------------------------
# x [N, D], w [G, D, F], dy [N, F]; N = n_tiles * br rows, row tile i is rows
# [i * br, (i + 1) * br)


def _tiles(x: torch.Tensor, n_tiles: int) -> torch.Tensor:
    return x.reshape(n_tiles, x.shape[0] // n_tiles, x.shape[1])


def gmm_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                  tile_group: torch.Tensor) -> torch.Tensor:
    """y ``[N, F]`` in x's dtype: each row tile times its group's weights,
    in float32 (the reference's ``_gmm_scan``: one dot per tile with
    float32 accumulation)."""
    n = tile_group.shape[0]
    y = torch.bmm(_tiles(x, n).float(), w.float()[tile_group.long()])
    return y.reshape(x.shape[0], w.shape[2]).to(x.dtype)


def gmm_dx_plain(dy: torch.Tensor, w: torch.Tensor,
                 tile_group: torch.Tensor) -> torch.Tensor:
    """dx ``[N, D]`` in dy's dtype: each dy tile times its group's
    weights transposed, in float32."""
    n = tile_group.shape[0]
    dx = torch.bmm(_tiles(dy, n).float(),
                   w.float()[tile_group.long()].transpose(1, 2))
    return dx.reshape(dy.shape[0], w.shape[1]).to(dy.dtype)


def gmm_dw_plain(x: torch.Tensor, dy: torch.Tensor, tile_group: torch.Tensor,
                 n_groups: int) -> torch.Tensor:
    """dW ``[G, D, F]`` float32: each tile's ``x^T dy`` summed into its
    group. A group that owns no tile gets zeros."""
    n = tile_group.shape[0]
    per_tile = torch.bmm(_tiles(x, n).float().transpose(1, 2), _tiles(dy, n).float())
    dw = torch.zeros((n_groups, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    return dw.index_add_(0, tile_group.long(), per_tile)


# --- the kernels ----------------------------------------------------------------


@functools.cache
def _kernels():
    """The three C entry points, built and bound on first use."""
    lib = load(_SOURCE).lib
    fns = {}
    # (name, ints after the four pointers): fwd/dx take n_tiles, br, G, D,
    # F, dtype; dw takes br, G, D, F, dtype; the stream comes last
    for name, n_int in (("gmm_fwd", 6), ("gmm_dx", 6), ("gmm_dw", 5)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.gmm_route.argtypes = [ctypes.c_int] * 3
    lib.gmm_route.restype = ctypes.c_int
    fns["gmm_route"] = lib.gmm_route
    return fns


def kernel_instance(name: str, dtype: torch.dtype, block: int) -> str:
    """Which CUDA instance ``name`` (gmm_fwd, gmm_dx or gmm_dw) runs for
    ``dtype`` and row tile ``block``, as the built library dispatches it:
    ``"tensor cores"`` (wgmma + TMA), ``"mma.sync"`` or ``"scalar"``
    (float32 FMA). Builds the library on first use, so it needs nvcc."""
    route = _kernels()["gmm_route"](_KERNEL_CODES[name], _DTYPE_CODES.get(dtype, -1), block)
    if route < 0:
        raise ValueError(f"{name} has no instance for {dtype}, row tile {block}")
    return _INSTANCES[route]


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` dense and 16-byte aligned (the kernels load 16 bytes at a
    time), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(a: torch.Tensor, b: torch.Tensor, tile_group: torch.Tensor,
                D: int, F: int, a_cols: int, b_shape: tuple[int, ...]) -> None:
    """What the kernels take: ``a`` the ``[N, a_cols]`` row operand with N
    a whole number of row tiles, ``b`` of ``b_shape``, one dtype, one
    device, widths that are multiples of 8, and a grid CUDA can launch.
    Widths of 8 make every row stride a multiple of 16 bytes in either
    dtype, and ``_ready`` gives 16-byte-aligned starts: TMA's rule for the
    tensor-core instances' maps."""
    if a.ndim != 2 or a.shape[1] != a_cols or tuple(b.shape) != tuple(b_shape):
        raise ValueError(f"grouped_mm kernel shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}: expected [N, {a_cols}] and {tuple(b_shape)}")
    if tile_group.ndim != 1 or tile_group.shape[0] == 0 or a.shape[0] % tile_group.shape[0]:
        raise ValueError(f"rows {a.shape[0]} not a whole number of "
                         f"{tile_group.shape[0]} tiles")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"grouped_mm kernels take float32 or bfloat16, not {a.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"grouped_mm operand dtypes differ: {a.dtype} {b.dtype}")
    devs = {t.device for t in (a, b, tile_group)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if D % 8 or F % 8:
        raise ValueError(f"grouped_mm kernels take widths that are multiples of 8 "
                         f"(16-byte rows, as TMA needs), not D={D} F={F}")
    n_tiles = tile_group.shape[0]
    if n_tiles * -(-(a.shape[0] // n_tiles) // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"{a.shape[0]} rows in {n_tiles} tiles exceed the "
                         f"kernels' grid ({_MAX_GRID_Y} slices of {_TILE} rows)")


def _launch(name: str, *args: int, device: torch.device) -> None:
    err = _kernels()[name](*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_ERRORS.get(err, f'cudaError {err}')}")
    LAUNCHES[name] += 1


def _on_device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); raises for anything else."""
    if x.device.type == "cpu":
        LAUNCHES[f"{what}_plain"] += 1
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no grouped matmul for device {x.device}")
    return True


def gmm_fwd(x: torch.Tensor, w: torch.Tensor, tile_group: torch.Tensor) -> torch.Tensor:
    """y ``[N, F]`` in x's dtype: kernel or plain version by device."""
    if not _on_device(x, "gmm_fwd"):
        return gmm_fwd_plain(x, w, tile_group)
    x, w, tg = _ready(x), _ready(w), _ready(tile_group.to(torch.int32))
    G, D, F = w.shape
    _check_cuda(x, w, tg, D, F, D, w.shape)
    y = torch.empty((x.shape[0], F), dtype=x.dtype, device=x.device)
    _launch("gmm_fwd", x.data_ptr(), w.data_ptr(), tg.data_ptr(), y.data_ptr(),
            tg.shape[0], x.shape[0] // tg.shape[0], G, D, F,
            _DTYPE_CODES[x.dtype], device=x.device)
    return y


def gmm_dx(dy: torch.Tensor, w: torch.Tensor, tile_group: torch.Tensor) -> torch.Tensor:
    """dx ``[N, D]`` in dy's dtype: kernel or plain version by device."""
    if not _on_device(dy, "gmm_dx"):
        return gmm_dx_plain(dy, w, tile_group)
    dy, w, tg = _ready(dy), _ready(w), _ready(tile_group.to(torch.int32))
    G, D, F = w.shape
    _check_cuda(dy, w, tg, D, F, F, w.shape)
    dx = torch.empty((dy.shape[0], D), dtype=dy.dtype, device=dy.device)
    _launch("gmm_dx", dy.data_ptr(), w.data_ptr(), tg.data_ptr(), dx.data_ptr(),
            tg.shape[0], dy.shape[0] // tg.shape[0], G, D, F,
            _DTYPE_CODES[dy.dtype], device=dy.device)
    return dx


def gmm_dw(x: torch.Tensor, dy: torch.Tensor, tile_group: torch.Tensor,
           n_groups: int) -> torch.Tensor:
    """dW ``[G, D, F]`` float32: kernel or plain version by device. The
    kernel needs ``tile_group`` non-decreasing (``grouped_layout``'s map):
    each group's tiles are found by two searches of it on the device."""
    if not _on_device(x, "gmm_dw"):
        return gmm_dw_plain(x, dy, tile_group, n_groups)
    x, dy, tg = _ready(x), _ready(dy), _ready(tile_group.to(torch.int32))
    D, F = x.shape[1], dy.shape[1]
    _check_cuda(x, dy, tg, D, F, D, (x.shape[0], F))
    groups = torch.arange(n_groups, dtype=torch.int32, device=x.device)
    bounds = torch.cat([torch.searchsorted(tg, groups, out_int32=True),
                        torch.searchsorted(tg, groups, right=True, out_int32=True)])
    dw = torch.empty((n_groups, D, F), dtype=torch.float32, device=x.device)
    _launch("gmm_dw", x.data_ptr(), dy.data_ptr(), bounds.data_ptr(), dw.data_ptr(),
            x.shape[0] // tg.shape[0], n_groups, D, F, _DTYPE_CODES[x.dtype],
            device=x.device)
    return dw


# --- custom ops and their gradient ----------------------------------------------


@torch.library.custom_op("tony_tpu_torch::gmm", mutates_args=())
def _gmm_op(x: torch.Tensor, w: torch.Tensor, tile_group: torch.Tensor) -> torch.Tensor:
    return gmm_fwd(x, w, tile_group)


@torch.library.custom_op("tony_tpu_torch::gmm_bwd", mutates_args=())
def _gmm_bwd_op(x: torch.Tensor, w: torch.Tensor, tile_group: torch.Tensor,
                dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dx = gmm_dx(dy, w, tile_group)
    dw = gmm_dw(x, dy, tile_group, w.shape[0]).to(w.dtype)
    return dx, dw


def _setup_context(ctx, inputs, output):
    x, w, tile_group = inputs
    ctx.save_for_backward(x, w, tile_group)


def _backward(ctx, dy):
    x, w, tile_group = ctx.saved_tensors
    dx, dw = _gmm_bwd_op(x, w, tile_group, dy)
    return dx, dw, None


torch.library.register_autograd("tony_tpu_torch::gmm", _backward,
                                setup_context=_setup_context)


# --- public entry ---------------------------------------------------------------


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, tile_group: torch.Tensor, *,
                   impl: str = "scan", block_cols: int = 512) -> torch.Tensor:
    """``[N, D] x [G, D, F] -> [N, F]`` where row tile ``i`` (of
    ``N / len(tile_group)`` rows) contracts against ``w[tile_group[i]]``.

    ``x`` must be laid out by :func:`grouped_layout` (group-contiguous,
    block-aligned, zero padding rows). Differentiable under both impls.
    ``block_cols`` is the TPU kernel's column tile, accepted for the
    signature and not read: the CUDA kernels keep their own tiles."""
    if x.ndim != 2 or w.ndim != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_matmul shapes {tuple(x.shape)} x {tuple(w.shape)}")
    n_tiles = tile_group.shape[0]
    if n_tiles == 0 or x.shape[0] % n_tiles:
        raise ValueError(f"rows {x.shape[0]} not a whole number of {n_tiles} tiles")
    if impl == "pallas":
        return _gmm_op(x, w, tile_group)
    if impl != "scan":
        raise ValueError(f"unknown gmm impl {impl!r} (expected scan | pallas)")
    LAUNCHES["gmm_fwd_plain"] += 1
    return gmm_fwd_plain(x, w, tile_group)


__all__ = [
    "LAUNCHES", "gmm_dw", "gmm_dw_plain", "gmm_dx", "gmm_dx_plain",
    "gmm_fwd", "gmm_fwd_plain", "grouped_layout", "grouped_matmul",
    "kernel_instance", "reset_launches",
]
