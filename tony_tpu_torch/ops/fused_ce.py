"""Fused chunked cross-entropy head: per-token loss from hidden states
without ever holding ``[N, V]`` logits or dlogits.

The counterpart of ``tony_tpu/ops/fused_ce.py``'s ``scan`` path, the one
every training preset uses:

- the forward walks the vocabulary in ``vocab_chunk`` columns, keeping an
  online logsumexp ``(m, s)`` and the target logit per row, so at most one
  ``[N, Vc]`` float32 logits block is live (the reference's ``_scan_fwd``);
- the backward recomputes each chunk's logits from the saved ``(h, lse)``,
  forms ``dlogits = (softmax - onehot) * g`` for that chunk only, and
  accumulates ``dh`` in float32 and writes the chunk's ``dW`` columns once
  (``_scan_bwd``);
- the tail chunk (``V % vocab_chunk`` columns) is one more, narrower step.

The chunk products are plain matrix products that the reference leaves to
XLA outside Pallas, so they go to cuBLAS here. Their logits are float32
(the reference's ``preferred_element_type=float32``): bfloat16 operands on
a CUDA device go through ``torch.mm(..., out_dtype=torch.float32)`` where
this torch has it, else through float32 operands
(:func:`f32_matmul_route` says which). The backward's bfloat16 products
round dlogits to bfloat16 for the tensor cores, as a TPU's default matmul
precision does with its float32 operands.

``ce_impl="pallas"`` is the counterpart of the reference's three CE
kernels (``_ce_fwd_kernel`` :164, ``_ce_dh_kernel`` :204, ``_ce_dw_kernel``
:236), hand-written in CUDA in ``csrc/fused_ce.cu`` and built with ``nvcc``
at first use by ``ops/_build.py``:

- ``ce_fwd``: lse and the target logit per row, online over vocab tiles,
  the vocab split across CTAs and merged per row;
- ``ce_dh``: per vocab chunk of ``_DL_COLS`` columns, the chunk's logits
  recomputed once and its dlogits written in h's dtype to a ``[N, Vc]``
  scratch, then ``dh += dlogits W_c^T`` in float32;
- ``ce_dw``: the chunk's dW columns, ``h^T dlogits``, from that scratch.

bfloat16 runs all three on wgmma with TMA staging, float32 on scalar FMA
(:func:`kernel_instance` says which, from the library's ``ce_route``). CUDA tensors launch the
routed instance or raise; CPU tensors take the plain versions
:func:`ce_fwd_plain`, :func:`ce_dh_plain` and :func:`ce_dw_plain`, which
walk the reference's ``block_v`` vocab tiles (and ``block_n`` row blocks
for dW's sum) and which the tests hold against the reference. The kernels
keep their own tiles and read neither knob. ``LAUNCHES`` counts both
paths.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tony_tpu_torch.ops._build import TMA_ERRORS, load

_NEG = -0.7 * torch.finfo(torch.float32).max
# the pallas path's tile defaults (the reference's _BLOCK_N / _BLOCK_V)
_BLOCK_N = 512
_BLOCK_V = 512
# one count per path, bumped where the path runs: the CUDA entry's launch
# and the plain version's dispatch
LAUNCHES: dict[str, int] = {
    "ce_fwd": 0, "ce_dh": 0, "ce_dw": 0,
    "ce_fwd_plain": 0, "ce_dh_plain": 0, "ce_dw_plain": 0,
}
_SOURCE = "fused_ce"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODES = {"ce_fwd": 0, "ce_dh": 1, "ce_dw": 2}
_INSTANCES = {2: "tensor cores", 0: "scalar"}
_ERRORS = {-1: "no instance for this dtype",
           -4: "ce_fwd's splits do not match its instance's workspace", **TMA_ERRORS}
_TILE = 128                 # the scalar kernels' tile (csrc/fused_ce.cu kTile)
_MAX_GRID_Y = 65535         # CUDA's grid.y limit: row blocks of 128
_DL_COLS = 4096             # vocab columns per backward chunk (dlogits scratch)
_FWD_COLS = 256             # the tensor-core ce_fwd's column tile (sm90.cuh pgemm::kCols)
_WAVES = 8                  # the scalar ce_fwd's CTAs per SM to aim for (vocab splits)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def f32_matmul_route(device: torch.device | str, dtype: torch.dtype) -> str:
    """How :func:`_mm_f32` multiplies ``dtype`` operands on ``device``:
    ``"float32"`` (float32 operands and sums), ``"mm out_dtype"`` (low
    precision operands, float32 output from one cuBLAS call) or
    ``"upcast"`` (low-precision operands cast to float32 first)."""
    if dtype == torch.float32:
        return "float32"
    if torch.device(device).type == "cuda" and hasattr(torch.ops.aten.mm, "dtype"):
        return "mm out_dtype"
    return "upcast"


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result (operands of one dtype)."""
    route = f32_matmul_route(a.device, a.dtype)
    if route == "float32":
        return a @ b
    if route == "mm out_dtype":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_fwd(m, s, tl, logits, start, tgt):
    """Online-logsumexp update for one ``[N, Vc]`` float32 logits block."""
    m_new = torch.maximum(m, logits.amax(dim=1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
    rel = tgt - start
    in_chunk = (rel >= 0) & (rel < logits.shape[1])
    got = logits.gather(1, rel.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, got, tl)


def _chunks(V: int, vc: int):
    """(start, stop) of each vocab chunk: full ones, then the tail."""
    vc = min(vc, V)
    nfull = V // vc
    out = [(j * vc, (j + 1) * vc) for j in range(nfull)]
    if V % vc:
        out.append((nfull * vc, V))
    return out


def _scan_fwd(h, w, tgt, vc):
    """h ``[N, D]``, w ``[D, V]``, tgt ``[N]`` -> (lse, target logit), both
    ``[N]`` float32."""
    N = h.shape[0]
    m = torch.full((N,), _NEG, dtype=torch.float32, device=h.device)
    s = torch.zeros(N, dtype=torch.float32, device=h.device)
    tl = torch.zeros(N, dtype=torch.float32, device=h.device)
    for start, stop in _chunks(w.shape[1], vc):
        m, s, tl = _chunk_fwd(m, s, tl, _mm_f32(h, w[:, start:stop]), start, tgt)
    return m + torch.log(s), tl


def _scan_bwd(h, w, tgt, lse, g, vc):
    """(dh in h's dtype, dw in w's dtype): each chunk's dW columns written
    once, dh accumulated in float32."""
    N = h.shape[0]
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty_like(w)
    rows = torch.arange(N, device=h.device)
    low = h.dtype != torch.float32
    for start, stop in _chunks(w.shape[1], vc):
        wc = w[:, start:stop]
        dl = torch.exp(_mm_f32(h, wc) - lse[:, None])       # softmax
        rel = tgt - start
        hit = (rel >= 0) & (rel < stop - start)
        dl[rows[hit], rel[hit]] -= 1.0                      # - onehot(target)
        dl *= g[:, None]
        if low:
            dl = dl.to(h.dtype)
        dh += _mm_f32(dl, wc.t())
        dw[:, start:stop] = _mm_f32(h.t(), dl).to(w.dtype)
    return dh.to(h.dtype), dw


# --- the pallas path: plain versions ------------------------------------------
# h [N, D], w [D, V], tgt [N] int, lse and g [N] float32


def _dlogits(logits, lse, tgt, g, start, dtype):
    """``(exp(logits - lse) - onehot) * g`` for the columns from ``start``,
    rounded to ``dtype`` (h's) before the products, as the kernels do."""
    cols = torch.arange(start, start + logits.shape[1], device=logits.device)
    onehot = (cols[None, :] == tgt[:, None]).float()
    return ((torch.exp(logits - lse[:, None]) - onehot) * g[:, None]).to(dtype).float()


def ce_fwd_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
                 block_v: int = _BLOCK_V) -> tuple[torch.Tensor, torch.Tensor]:
    """(lse, target logit), both ``[N]`` float32: the reference's
    ``_ce_fwd_kernel`` over ``block_v``-column tiles, the last padded with
    ``_NEG`` columns, an online max and sum per row, float32 logits from
    h's and w's values. A target outside ``[0, V)`` leaves its logit 0."""
    N, V = h.shape[0], w.shape[1]
    bv = min(block_v, V)
    m = torch.full((N,), _NEG, dtype=torch.float32, device=h.device)
    s = torch.zeros(N, dtype=torch.float32, device=h.device)
    tl = torch.zeros(N, dtype=torch.float32, device=h.device)
    hf = h.float()
    for start, stop in _chunks(V, bv):
        logits = F.pad(hf @ w[:, start:stop].float(), (0, bv - (stop - start)),
                       value=_NEG)
        m_new = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        rel = tgt - start
        hit = (rel >= 0) & (rel < stop - start)
        got = logits.gather(1, rel.clamp(0, bv - 1)[:, None])[:, 0]
        tl = torch.where(hit, got, tl)
    # max(s, 1e-30) keeping a NaN s, as jnp.maximum does
    return m + torch.log(torch.maximum(s, s.new_tensor(1e-30))), tl


def ce_dh_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, lse: torch.Tensor,
                g: torch.Tensor, block_v: int = _BLOCK_V) -> torch.Tensor:
    """dh ``[N, D]`` in h's dtype: the reference's ``_ce_dh_kernel``, the
    logits recomputed per ``block_v`` tile and ``dlogits W^T`` summed in
    float32 across the tiles."""
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    hf = h.float()
    for start, stop in _chunks(w.shape[1], block_v):
        wt = w[:, start:stop].float()
        dh += _dlogits(hf @ wt, lse, tgt, g, start, h.dtype) @ wt.t()
    return dh.to(h.dtype)


def ce_dw_plain(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, lse: torch.Tensor,
                g: torch.Tensor, block_n: int = _BLOCK_N,
                block_v: int = _BLOCK_V) -> torch.Tensor:
    """dW ``[D, V]`` in w's dtype: the reference's ``_ce_dw_kernel``, each
    ``block_v`` tile's ``h^T dlogits`` summed in float32 over ``block_n``
    row blocks and written once."""
    N = h.shape[0]
    dw = torch.empty_like(w)
    hf = h.float()
    bn = min(block_n, N)
    for start, stop in _chunks(w.shape[1], block_v):
        wt = w[:, start:stop].float()
        acc = torch.zeros((w.shape[0], stop - start), dtype=torch.float32, device=h.device)
        for r0 in range(0, N, bn):
            hb = hf[r0:r0 + bn]
            acc += hb.t() @ _dlogits(hb @ wt, lse[r0:r0 + bn], tgt[r0:r0 + bn],
                                     g[r0:r0 + bn], start, h.dtype)
        dw[:, start:stop] = acc.to(w.dtype)
    return dw


# --- the pallas path: the kernels ------------------------------------------------


@functools.cache
def _kernels():
    """The three C entry points, built and bound on first use."""
    lib = load(_SOURCE).lib
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"ce_fwd": [p] * 6 + [i] * 5 + [p],
            "ce_dh": [p] * 8 + [i] * 9 + [p],
            "ce_dw": [p] * 3 + [i] * 7 + [p]}
    fns = {}
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@functools.cache
def _route(kernel: int, dtype: int) -> int:
    route = load(_SOURCE).lib.ce_route
    route.argtypes = [ctypes.c_int] * 2
    route.restype = ctypes.c_int
    return route(kernel, dtype)


def kernel_instance(name: str, dtype: torch.dtype) -> str:
    """Which CUDA instance ``name`` (ce_fwd, ce_dh or ce_dw) runs for
    ``dtype``, as the built library dispatches it: ``"tensor cores"``
    (wgmma + TMA) or ``"scalar"`` (float32 FMA). Builds the library on
    first use, so it needs nvcc."""
    got = _route(_KERNEL_CODES[name], _DTYPE_CODES.get(dtype, -1))
    if got < 0:
        raise ValueError(f"{name} has no instance for {dtype}")
    return _INSTANCES[got]


def fwd_splits(instance: str, N: int, V: int, sms: int) -> int:
    """The vocab splits of ce_fwd's partials workspace ``[3, splits, N]``
    for the instance that runs: the tensor-core one writes one partial per
    256-column tile of its persistent grid; the scalar one splits its
    128-column tiles so that about ``_WAVES`` CTAs of 128 rows run per SM,
    with no split left without a tile."""
    if instance == "tensor cores":
        return -(-V // _FWD_COLS)
    n_tiles = -(-V // _TILE)
    splits = max(1, min(n_tiles, -(-_WAVES * sms // -(-N // _TILE))))
    return -(-n_tiles // -(-n_tiles // splits))


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` dense and 16-byte aligned (the kernels load 16 bytes at a
    time, and TMA needs aligned bases), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, *args: int, device: torch.device) -> None:
    err = _kernels()[name](*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_ERRORS.get(err, f'cudaError {err}')}")
    LAUNCHES[name] += 1


def _on_device(h: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); raises for anything else."""
    if h.device.type == "cpu":
        LAUNCHES[f"{what}_plain"] += 1
        return False
    if h.device.type != "cuda":
        raise ValueError(f"no fused CE kernels for device {h.device}")
    return True


def _cuda_operands(h, w, tgt, *rows):
    """What the kernels take: h ``[N, D]`` and w ``[D, V]`` of one dtype
    (float32 or bfloat16), D and V multiples of 8, every tensor on one
    device; returns them ready, tgt as int32 and the row vectors float32."""
    if h.ndim != 2 or w.ndim != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"fused CE kernel shapes h {tuple(h.shape)} w {tuple(w.shape)}")
    if h.dtype not in _DTYPE_CODES or w.dtype != h.dtype:
        raise TypeError(f"fused CE kernels take float32 or bfloat16 h and w of one "
                        f"dtype, not {h.dtype} / {w.dtype}")
    N, (D, V) = h.shape[0], w.shape
    if D % 8 or V % 8:
        raise ValueError(f"fused CE kernels take D and V that are multiples of 8, "
                         f"not D={D} V={V}")
    if N == 0 or -(-N // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"{N} rows: the kernels take 1 to {_MAX_GRID_Y * _TILE}")
    devs = {t.device for t in (h, w, tgt, *rows)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    for t in (tgt, *rows):
        if t.shape != (N,):
            raise ValueError(f"row vector {tuple(t.shape)} does not match {N} rows")
    return (_ready(h), _ready(w), _ready(tgt.to(torch.int32)),
            *(_ready(r.float()) for r in rows))


def ce_fwd(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor,
           block_v: int = _BLOCK_V) -> tuple[torch.Tensor, torch.Tensor]:
    """(lse, target logit) ``[N]`` float32: kernel or plain version by
    device (``block_v`` is the plain version's)."""
    if not _on_device(h, "ce_fwd"):
        return ce_fwd_plain(h, w, tgt, block_v)
    h, w, t32 = _cuda_operands(h, w, tgt)
    N, (D, V) = h.shape[0], w.shape
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    splits = fwd_splits(kernel_instance("ce_fwd", h.dtype), N, V, sms)
    part = torch.empty((3, splits, N), dtype=torch.float32, device=h.device)
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    tl = torch.empty_like(lse)
    _launch("ce_fwd", h.data_ptr(), w.data_ptr(), t32.data_ptr(), part.data_ptr(),
            lse.data_ptr(), tl.data_ptr(), N, D, V, splits, _DTYPE_CODES[h.dtype],
            device=h.device)
    return lse, tl


def dlogits_chunks(V: int) -> list[tuple[int, int]]:
    """(start, stop) of the backward's vocab chunks on the card."""
    return _chunks(V, _DL_COLS)


def ce_dw_chunk(h: torch.Tensor, dl: torch.Tensor, dw: torch.Tensor, start: int,
                stop: int) -> None:
    """``dw[:, start:stop] = h^T dl[:, :stop - start]`` from the dlogits
    scratch ``dl`` that :func:`ce_bwd`'s ce_dh launch wrote for that
    chunk (CUDA tensors, prepared by :func:`ce_bwd`)."""
    N, D = h.shape
    _launch("ce_dw", h.data_ptr(), dl.data_ptr(), dw.data_ptr(), N, D, dw.shape[1],
            start, stop - start, dl.shape[1], _DTYPE_CODES[h.dtype], device=h.device)


def ce_bwd(h: torch.Tensor, w: torch.Tensor, tgt: torch.Tensor, lse: torch.Tensor,
           g: torch.Tensor, block_n: int = _BLOCK_N, block_v: int = _BLOCK_V, *,
           dw: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(dh in h's dtype, dW in w's dtype): on the card one ce_dh and one
    ce_dw launch per vocab chunk, sharing the chunk's recomputed dlogits;
    on the CPU the plain versions. ``dw=False`` runs the dh half alone (dW
    is then None)."""
    if not _on_device(h, "ce_dh"):
        dh = ce_dh_plain(h, w, tgt, lse, g, block_v)
        if not dw:
            return dh, None
        LAUNCHES["ce_dw_plain"] += 1
        return dh, ce_dw_plain(h, w, tgt, lse, g, block_n, block_v)
    h, w, t32, lse, g = _cuda_operands(h, w, tgt, lse, g)
    N, (D, V) = h.shape[0], w.shape
    chunks = dlogits_chunks(V)
    dl = torch.empty((N, chunks[0][1]), dtype=h.dtype, device=h.device)
    # dh's float32 sum between chunks (one chunk writes dh directly)
    acc = torch.empty((N, D) if len(chunks) > 1 else (1,), dtype=torch.float32,
                      device=h.device)
    dh = torch.empty_like(h)
    dw_out = torch.empty_like(w) if dw else None
    for i, (start, stop) in enumerate(chunks):
        _launch("ce_dh", h.data_ptr(), w.data_ptr(), t32.data_ptr(), lse.data_ptr(),
                g.data_ptr(), dl.data_ptr(), acc.data_ptr(), dh.data_ptr(), N, D, V,
                start, stop - start, dl.shape[1], int(i == 0), int(i == len(chunks) - 1),
                _DTYPE_CODES[h.dtype], device=h.device)
        if dw:
            ce_dw_chunk(h, dl, dw_out, start, stop)
    return dh, dw_out


# --- the autograd function -------------------------------------------------------


class _FusedCE(torch.autograd.Function):
    """Per-token CE ``lse - target_logit``; saves ``(h, w, tgt, lse)``,
    never logits (the reference's ``_fused_ce_fwd`` residuals)."""

    # each pass runs under a profiler range of its name: a profile reads
    # the device time of the PyTorch ops inside it (not of the ctypes
    # kernel launches, which are no PyTorch ops)
    @staticmethod
    def forward(ctx, h, w, tgt, impl, vc, block_n, block_v):
        with torch.profiler.record_function("fused_ce.fwd"):
            if impl == "pallas":
                lse, tl = ce_fwd(h, w, tgt, block_v)
            else:
                lse, tl = _scan_fwd(h, w, tgt, vc)
        ctx.save_for_backward(h, w, tgt, lse)
        ctx.knobs = (impl, vc, block_n, block_v)
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        h, w, tgt, lse = ctx.saved_tensors
        impl, vc, block_n, block_v = ctx.knobs
        with torch.profiler.record_function("fused_ce.bwd"):
            if impl == "pallas":
                dh, dw = ce_bwd(h, w, tgt, lse, g.float(), block_n, block_v)
            else:
                dh, dw = _scan_bwd(h, w, tgt, lse, g.float(), vc)
        return dh, dw, None, None, None, None, None


def fused_ce_tokens(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    cfg=None, *, impl: str | None = None,
                    vocab_chunk: int | None = None, block_n: int | None = None,
                    block_v: int | None = None) -> torch.Tensor:
    """Per-token cross-entropy ``[B, S]`` float32 from hidden states ``h
    [B, S, D]``, lm_head ``w [D, V]`` and ``targets [B, S]``, without full
    logits. Knobs come from ``cfg.ce_impl`` / ``cfg.ce_vocab_chunk`` /
    ``cfg.ce_block_n`` / ``cfg.ce_block_v`` when a config is passed
    (kwargs win); ``block_n``/``block_v`` are read by the pallas path's
    plain versions, the CUDA kernels keep their own tiles. Callers take
    the mean."""
    if impl is None:
        impl = getattr(cfg, "ce_impl", None) or "scan"
    if vocab_chunk is None:
        vocab_chunk = getattr(cfg, "ce_vocab_chunk", None) or 4096
    if block_n is None:
        block_n = getattr(cfg, "ce_block_n", None) or _BLOCK_N
    if block_v is None:
        block_v = getattr(cfg, "ce_block_v", None) or _BLOCK_V
    if impl not in ("scan", "pallas"):
        raise ValueError(f"unknown ce_impl {impl!r} (expected scan | pallas)")
    B, S, D = h.shape
    if w.shape[0] != D:
        raise ValueError(f"lm_head {tuple(w.shape)} does not match hidden dim {D}")
    if tuple(targets.shape) != (B, S):
        raise ValueError(f"targets {tuple(targets.shape)} != batch/seq {(B, S)}")
    losses = _FusedCE.apply(h.reshape(B * S, D), w, targets.reshape(B * S).long(),
                            impl, int(vocab_chunk), int(block_n), int(block_v))
    return losses.reshape(B, S)


def reference_ce_tokens(h: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Full-logits logsumexp oracle (materialises ``[B, S, V]`` float32)."""
    B, S, D = h.shape
    logits = _mm_f32(h.reshape(B * S, D), w).reshape(B, S, -1)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - tgt


__all__ = [
    "LAUNCHES", "ce_bwd", "ce_dh_plain", "ce_dw_chunk", "ce_dw_plain", "ce_fwd",
    "ce_fwd_plain", "dlogits_chunks", "f32_matmul_route", "fused_ce_tokens",
    "fwd_splits", "kernel_instance", "reference_ce_tokens", "reset_launches",
]
