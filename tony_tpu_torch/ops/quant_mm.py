"""Int8 weight-only matmul with per-output-channel scales, for the serving
engine's decode step.

The counterpart of ``tony_tpu/ops/quant_mm.py``. ``W [D, N]`` is stored as
int8 with one float32 scale per output channel (``amax over D / 127``);
the decode step reads the int8 copy, so each step streams half the bytes
of the bf16 weights. Prefill keeps the bf16 masters.

What the product computes is what the reference's kernel computes
(``_qmm_kernel``): each weight is dequantized on its own,
``float(wq) * scale``, and rounded to ``x.dtype`` before the product; the
product accumulates in float32 and the output is ``x.dtype``. (The
reference module's docstring speaks of folding the scale in after the
contraction; its kernel does not, and neither does this port.)

Where it runs is decided by the tensors' device alone:

- CUDA tensors launch the hand-written kernel ``csrc/quant_mm.cu`` (built
  with ``nvcc`` at first use, ``ops/_build.py``), or raise. There is no
  fallback. bfloat16 x runs on the tensor cores, every row of x up to 128
  in one CTA so the weight is read once, D split :func:`split_k` ways for
  narrow N; float32 x on scalar FMA (:func:`kernel_instance` says which,
  from the library's ``quant_mm_route``).
- CPU tensors take :func:`quant_matmul_plain`, the plain PyTorch version.

``LAUNCHES`` counts both. The kernel's sums do not depend on how many rows
share a call: the split of D comes from the weight's shape and the card
alone, so a row decodes to the same bits alone, in 8 slots or in a
verify step's 128 rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

WEIGHT_QMAX = 127.0

LAUNCHES: dict[str, int] = {"quant_mm": 0, "quant_mm_plain": 0}

_KERNEL = "quant_mm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INSTANCES = {1: "tensor cores", 0: "scalar"}
# the entry point's own return codes; other nonzero returns are cudaError_t
_ERRORS = {-1: "no instance for this dtype", -2: "a split of D outside 1..8"}
# the tensor-core instance's tiles and its largest split (csrc/quant_mm.cu
# tc::kCols, kDepth, kMaxSplits: a portable cluster of CTAs)
_COLS = 256
_DEPTH = 64
_MAX_SPLITS = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``w [..., D, N]`` -> (int8 ``[..., D, N]``, float32 scales
    ``[..., N]``): symmetric per-output-channel quantization (amax over the
    contraction dim / 127), rounded half to even as the reference rounds.
    Leading dims quantize independently."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / WEIGHT_QMAX
    q = wf / torch.clamp(scale[..., None, :], min=1e-30)
    q = torch.clamp(torch.round(q), -WEIGHT_QMAX, WEIGHT_QMAX)
    return q.to(torch.int8), scale


def quant_matmul_plain(x2: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``x2 [M, D] @ dequant(wq [D, N], scale [N])``: the
    whole weight dequantized and rounded to ``x2.dtype``, a float32 product,
    the result in ``x2.dtype``. Each row is its own one-row product, so a
    row's result does not depend on how many rows share the call (a BLAS
    picks its summation order by shape): a slot decodes the same alone and
    in a busy batch, as it does through the kernel, whose sums do not
    depend on M either."""
    w = (wq.float() * scale.float()).to(x2.dtype).float()
    rows = [x2[i:i + 1].float() @ w for i in range(x2.shape[0])]
    out = torch.cat(rows) if rows else x2.new_zeros((0, w.shape[1]), dtype=torch.float32)
    return out.to(x2.dtype)


def split_k(D: int, N: int, sms: int, clusters: dict[int, int]) -> int:
    """How many ways the tensor-core instance splits D for a ``[D, N]``
    weight on a card of ``sms`` SMs that holds ``clusters[s]`` clusters of
    ``s`` CTAs at once: the most splits, up to a cluster of 8 (the split
    partials meet in the cluster's shared memory), that keep every CTA of
    the call in one wave (no more CTAs than SMs, a column tile's cluster
    for each), no split without a 64-deep slice. It reads no row count, so
    a row's float32 sum runs in the same order at every M."""
    tiles = -(-N // _COLS)
    slices = -(-D // _DEPTH)
    want = max([1] + [s for s in range(2, min(_MAX_SPLITS, slices) + 1)
                      if tiles * s <= sms and tiles <= clusters[s]])
    per = -(-slices // want)
    return -(-slices // per)


@functools.cache
def _lib():
    """The library's entry points, built and bound on first use."""
    from tony_tpu_torch.ops._build import load

    lib = load(_KERNEL).lib
    lib.quant_mm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.quant_mm.restype = ctypes.c_int
    lib.quant_mm_route.argtypes = [ctypes.c_int]
    lib.quant_mm_route.restype = ctypes.c_int
    lib.quant_mm_max_clusters.argtypes = [ctypes.c_int]
    lib.quant_mm_max_clusters.restype = ctypes.c_int
    return lib


def kernel_instance(dtype: torch.dtype) -> str:
    """Which CUDA instance quant_mm runs for x of ``dtype``, as the built
    library dispatches it: ``"tensor cores"`` (bfloat16) or ``"scalar"``
    (float32). Builds the library on first use, so it needs nvcc."""
    got = _lib().quant_mm_route(_DTYPE_CODES.get(dtype, -1))
    if got < 0:
        raise ValueError(f"quant_mm has no instance for {dtype}")
    return _INSTANCES[got]


@functools.cache
def card_shape(index: int) -> tuple[int, dict[int, int]]:
    """Card ``index``'s SM count and how many clusters of 1 to 8 CTAs of
    the tensor-core instance it holds at once (the library asks the
    occupancy calculator); what :func:`split_k` reads of the card."""
    with torch.cuda.device(index):
        clusters = {s: _lib().quant_mm_max_clusters(s) for s in range(1, _MAX_SPLITS + 1)}
    if min(clusters.values()) < 1:
        raise RuntimeError(f"quant_mm cluster occupancy query failed: {clusters}")
    return torch.cuda.get_device_properties(index).multi_processor_count, clusters


def _quant_mm_cuda(x2: torch.Tensor, wq: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    M, D = x2.shape
    N = wq.shape[1]
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"quant_mm kernel takes float32 or bfloat16 x, not {x2.dtype}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"quant_mm takes int8 weights and float32 scales, not "
                        f"{wq.dtype} / {scale.dtype}")
    devs = {t.device for t in (x2, wq, scale)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    for name, t in (("x", x2), ("wq", wq), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D % 8 or x2.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("quant_mm kernel reads x and wq in 16-byte loads: D must be "
                         f"a multiple of 8 (not {D}) and both 16-byte aligned")
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M == 0 or N == 0:
        return out
    splits = (split_k(D, N, *card_shape(x2.device.index))
              if kernel_instance(x2.dtype) == "tensor cores" else 1)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _lib().quant_mm(x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          M, D, N, splits, _DTYPE_CODES[x2.dtype], stream)
    if err != 0:
        raise RuntimeError(f"quant_mm launch failed: {_ERRORS.get(err, f'cudaError {err}')}")
    LAUNCHES[_KERNEL] += 1
    return out


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., D] @ dequant(wq [D, N], scale [N]) -> [..., N]`` in
    ``x.dtype``. CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if wq.dim() != 2 or tuple(scale.shape) != tuple(wq.shape[-1:]):
        raise ValueError(f"quant_matmul weight shapes wq={tuple(wq.shape)} "
                         f"scale={tuple(scale.shape)}")
    D, N = wq.shape
    if x.shape[-1] != D:
        raise ValueError(f"quant_matmul x={tuple(x.shape)} vs wq={tuple(wq.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, D)
    if x2.device.type == "cuda":
        out = _quant_mm_cuda(x2.contiguous(), wq, scale)
    elif x2.device.type == "cpu":
        LAUNCHES["quant_mm_plain"] += 1
        out = quant_matmul_plain(x2, wq, scale)
    else:
        raise ValueError(f"no quant_matmul for device {x2.device}")
    return out.reshape(*lead, N)


__all__ = [
    "LAUNCHES", "WEIGHT_QMAX", "card_shape", "kernel_instance", "quant_matmul",
    "quant_matmul_plain", "quantize_weights", "reset_launches", "split_k",
]
