"""Flash attention for training: a causal forward that never holds the
``[S, S]`` score matrix, and its backward from the saved logsumexp.

The counterpart of ``tony_tpu/ops/attention.py``. Three hand-written CUDA
kernels (``csrc/flash_attention.cu``, built with ``nvcc`` at first use by
``ops/_build.py``) replace its three Pallas kernels:

- ``flash_fwd``: out ``[B, S, H, hd]`` and lse ``[B, H, S]`` float32;
- ``flash_dq``: dq from explicit lse and ``delta = rowsum(dO * out)``;
- ``flash_dkv``: dk/dv ``[B, S, Hkv, hd]``, summed over each GQA group.

bf16 inputs run on the tensor cores (wgmma, with tiles staged by TMA);
float32 inputs run scalar float32 instances (:func:`kernel_instance` says
which). TMA reads a tensor only from a 16-byte-aligned start with 16-byte
strides, so the wrapper hands those kernels aligned copies of tensors that
are not (:func:`_tma_ready`).

K/V may carry fewer heads than Q: head h reads kv head ``h // (H / Hkv)``
by index, never through a repeat in memory. ``delta`` is computed here in
float32 outside the kernels, as the reference's ``_flash_bwd`` computes it
outside Pallas.

Where each runs is decided by the tensors' device alone:

- CUDA tensors launch the kernel, or raise. There is no fallback.
- CPU tensors take the plain versions :func:`flash_fwd_plain`,
  :func:`flash_dq_plain` and :func:`flash_dkv_plain` (masked float32
  softmax over the whole sequence), which the tests hold against the
  reference.

``LAUNCHES`` counts both. The kernels are registered as
``torch.library`` custom ops (``tony_tpu_torch::flash_fwd`` and
``::flash_bwd``): a ctypes launch is invisible to PyTorch's dispatcher, and
an op it can see is what lets a selective-checkpoint policy keep the
forward's residuals (``models/llama.py``'s ``flash_res``) so that the
backward never re-runs the forward kernel.

Over a mesh: the model-level ``flash`` hook (:func:`sharded_flash_attention`)
runs on the rank's heads over the whole sequence, gathered where sp
splits it (:func:`sequence_gathered`); ``parallel/ring_attention.py``'s
ring_flash runs the kernels per chunk pair through
:func:`flash_chunk_fwd` and :func:`flash_chunk_bwd`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tony_tpu_torch.ops._build import TMA_ERRORS, load

# one count per path, bumped where the path runs: the CUDA kernel's launch
# and the plain version's CPU dispatch
LAUNCHES: dict[str, int] = {
    "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
    "flash_fwd_plain": 0, "flash_dq_plain": 0, "flash_dkv_plain": 0,
}

_NEG = -0.7 * torch.finfo(torch.float32).max
_SOURCE = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_KERNEL_CODES = {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 2}
# the C entry points' own codes (other nonzero returns are cudaError_t)
_ERRORS = {-1: "no instance for this dtype / head_dim", **TMA_ERRORS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --- plain versions -------------------------------------------------------------
# q-like tensors [B, S, H, hd], k-like [B, S, Hkv, hd], lse/delta [B, H, S]
# float32; strided views are fine.


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 scores ``[B, Hkv, rep, S, S]`` (masked to ``_NEG``) and the
    mask (True where attended)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.float().reshape(B, S, Hkv, H // Hkv, hd)
    s = torch.einsum("bqxrd,bkxd->bxrqk", qg, k.float()) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    else:
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device)
    return torch.where(keep, s, _NEG), keep


def _group(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """``[B, H, S]`` -> ``[B, Hkv, rep, S, 1]``."""
    B, H, S = x.shape
    return x.reshape(B, Hkv, H // Hkv, S, 1)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B, S, H, hd]`` in q's dtype, lse ``[B, H, S]`` float32): one
    masked float32 softmax over the sequence, p rounded to v's dtype before
    P.V, as the TPU kernel rounds it (:74)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    s, keep = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bxrqk,bkxd->bqxrd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, H, S)
    return out.reshape(B, S, H, hd).to(q.dtype), lse


def _probs(q, k, lse, scale, causal):
    s, keep = _scores(q, k, scale, causal)
    return torch.where(keep, torch.exp(s - _group(lse, k.shape[2])), 0.0)


def flash_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                   scale: float, causal: bool) -> torch.Tensor:
    """dq ``[B, S, H, hd]`` in q's dtype from explicit lse and delta:
    ``p = exp(s - lse)``, ``ds = p (dO.V^T - delta) scale``, ``dq = ds K``,
    all in float32 (the TPU kernel casts dO, V and K up, :152/:163/:168)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    p = _probs(q, k, lse, scale, causal)
    dog = do.float().reshape(B, S, Hkv, H // Hkv, hd)
    dp = torch.einsum("bqxrd,bkxd->bxrqk", dog, v.float())
    ds = p * (dp - _group(delta, Hkv)) * scale
    dq = torch.einsum("bxrqk,bkxd->bqxrd", ds, k.float())
    return dq.reshape(B, S, H, hd).to(q.dtype)


def flash_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                    scale: float, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) ``[B, S, Hkv, hd]`` in k's dtype, summed over each GQA
    group: ``dv = p^T dO``, ``dk = ds^T Q``, with p and ds in float32 (the
    TPU kernel keeps p in float32 for dv, :206)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    p = _probs(q, k, lse, scale, causal)
    dog = do.float().reshape(B, S, Hkv, H // Hkv, hd)
    dp = torch.einsum("bqxrd,bkxd->bxrqk", dog, v.float())
    ds = p * (dp - _group(delta, Hkv)) * scale
    dv = torch.einsum("bxrqk,bqxrd->bkxd", p, dog)
    qg = q.float().reshape(B, S, Hkv, H // Hkv, hd)
    dk = torch.einsum("bxrqk,bqxrd->bkxd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


# --- the kernels ----------------------------------------------------------------


@functools.cache
def _kernels():
    """The three C entry points, built and bound on first use."""
    lib = load(_SOURCE).lib
    tail = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fns = {}
    for name, n_ptr in (("flash_fwd", 5), ("flash_dq", 7), ("flash_dkv", 8)):
        fn = getattr(lib, name)
        # B, H, Hkv, S, hd follow the pointers
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
        fn.restype = ctypes.c_int
        fns[name] = fn
    lib.flash_route.argtypes = [ctypes.c_int] * 3
    lib.flash_route.restype = ctypes.c_int
    fns["flash_route"] = lib.flash_route
    return fns


def kernel_instance(name: str, dtype: torch.dtype, head_dim: int) -> str:
    """Which CUDA instance ``name`` (flash_fwd, flash_dq or flash_dkv) runs
    for ``dtype`` and ``head_dim``, as the built library dispatches it:
    ``"tensor cores"`` (wgmma + TMA) or ``"scalar"`` (float32 FMA). Builds
    the library on first use, so it needs nvcc."""
    route = _kernels()["flash_route"](_KERNEL_CODES[name], _DTYPE_CODES[dtype], head_dim)
    if route < 0:
        raise ValueError(f"{name} has no instance for {dtype}, head_dim {head_dim}")
    return "tensor cores" if route == 1 else "scalar"


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, position) element strides of a ``[B, S, H, hd]`` view."""
    return x.stride(0), x.stride(2), x.stride(1)


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` with ``ref``'s strides (a copy only when they differ)."""
    if x.stride() == ref.stride():
        return x
    return torch.empty_like(ref).copy_(x)


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when ``empty_like`` keeps its strides (a dense view,
    any order), else a contiguous copy: outputs are allocated with
    ``empty_like`` and the kernels write them with their input's strides."""
    if torch.empty_like(x).stride() == x.stride():
        return x
    return x.contiguous()


def _tma_aligned(x: torch.Tensor) -> bool:
    """Whether TMA can read ``x`` as it lies: a 16-byte-aligned start and a
    multiple of 16 bytes for the stride of every dimension longer than 1
    (the kernels give a dimension of size 1 a stride of their own), the
    unit-stride head_dim aside."""
    item = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or st == 1 or st * item % 16 == 0 for n, st in zip(x.shape, x.stride()))


def _tma_ready(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The tensors themselves when TMA can read all of them as they lie,
    else contiguous copies of all of them (a fresh allocation is aligned,
    and tensors that shared strides keep sharing them). Raises if a copy
    is still not readable: the kernels never fall back to another path."""
    if all(map(_tma_aligned, xs)):
        return xs
    out = tuple(x.clone(memory_format=torch.contiguous_format) for x in xs)
    if not all(map(_tma_aligned, out)):
        raise ValueError("flash kernels: no 16-byte-aligned copy of the inputs for TMA")
    return out


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_HEAD_DIMS}, not {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim must have unit stride")
    if k.stride() != v.stride():
        raise ValueError("k and v must share strides")


def _launch(name: str, *ptrs: int, q: torch.Tensor, k: torch.Tensor,
            scale: float, causal: bool) -> None:
    B, S, H, hd = q.shape
    err = _kernels()[name](
        *ptrs, B, H, k.shape[2], S, hd, *_strides(q), *_strides(k),
        scale, int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_ERRORS.get(err, f'cudaError {err}')}")
    LAUNCHES[name] += 1


def _fwd(q, k, v, scale: float, causal: bool):
    """(out, lse) for ``[B, S, H, hd]`` views: kernel or plain version by
    device."""
    if q.device.type == "cpu":
        LAUNCHES["flash_fwd_plain"] += 1
        return flash_fwd_plain(q, k, v, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    q, k, v = _dense(q), _dense(k), _dense(v)
    _check_cuda(q, k, v)
    if q.dtype == torch.bfloat16:
        (q,), (k, v) = _tma_ready(q), _tma_ready(k, v)
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), q=q, k=k, scale=scale, causal=causal)
    return out, lse


def _dq(q, k, v, do, lse, delta, scale: float, causal: bool):
    if q.device.type == "cpu":
        LAUNCHES["flash_dq_plain"] += 1
        return flash_dq_plain(q, k, v, do, lse, delta, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    q, k, v = _dense(q), _dense(k), _dense(v)
    _check_cuda(q, k, v)
    do = _like(do.to(q.dtype), q)
    if q.dtype == torch.bfloat16:
        (q, do), (k, v) = _tma_ready(q, do), _tma_ready(k, v)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty_like(q)
    _launch("flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q=q, k=k,
            scale=scale, causal=causal)
    return dq


def _dkv(q, k, v, do, lse, delta, scale: float, causal: bool):
    if q.device.type == "cpu":
        LAUNCHES["flash_dkv_plain"] += 1
        return flash_dkv_plain(q, k, v, do, lse, delta, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    q, k, v = _dense(q), _dense(k), _dense(v)
    _check_cuda(q, k, v)
    do = _like(do.to(q.dtype), q)
    if q.dtype == torch.bfloat16:
        (q, do), (k, v) = _tma_ready(q, do), _tma_ready(k, v)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q=q,
            k=k, scale=scale, causal=causal)
    return dk, dv


def _delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * out) in float32, ``[B, H, S]``."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


# --- custom ops and their gradient ----------------------------------------------


@torch.library.custom_op("tony_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    return _fwd(q, k, v, scale, causal)


@torch.library.custom_op("tony_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  scale: float, causal: bool
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    delta = _delta(do, out)
    dq = _dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = _dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def _setup_context(ctx, inputs, output):
    q, k, v, scale, causal = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale, ctx.causal = scale, causal


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _flash_bwd_op(q, k, v, out, lse, dout, ctx.scale, ctx.causal)
    return dq, dk, dv, None, None


torch.library.register_autograd("tony_tpu_torch::flash_fwd", _backward,
                                setup_context=_setup_context)

# the op a remat policy saves to keep the kernel's residuals (out, lse)
FLASH_FWD_OP = torch.ops.tony_tpu_torch.flash_fwd.default


# --- explicit-residual entries (folded [B * heads, S, hd] layout) ---------------


def _unfold(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B * heads, S, hd]`` -> a ``[B, S, heads, hd]`` view."""
    BH, S, D = x.shape
    return x.reshape(BH // heads, heads, S, D).permute(0, 2, 1, 3)


def _fold(x: torch.Tensor) -> torch.Tensor:
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, D)


def flash_fwd_pass(q, k, v, *, scale, blk_q=None, blk_k=None, causal=True,
                   heads, kv_heads):
    """q ``[B*heads, S, D]``, k/v ``[B*kv_heads, S, D]`` -> (out
    ``[B*heads, S, D]``, lse ``[B*heads, 1, S]`` float32), the reference's
    explicit-residual entry for blockwise/ring composition. ``blk_q`` and
    ``blk_k`` are the TPU's tile sizes, accepted for the signature and not
    read: the CUDA kernel keeps its own tiles."""
    out, lse = _fwd(_unfold(q, heads), _unfold(k, kv_heads), _unfold(v, kv_heads),
                    scale, causal)
    return _fold(out), lse.reshape(q.shape[0], 1, q.shape[1])


def flash_dq_pass(q, k, v, do, lse, delta, *, scale, blk_q=None, blk_k=None,
                  causal=True, heads, kv_heads):
    """dq ``[B*heads, S, D]`` from explicit lse/delta ``[B*heads, 1, S]``
    float32 (usable with a global lse and delta, as ring backward passes
    need)."""
    BH, S, _ = q.shape
    dq = _dq(_unfold(q, heads), _unfold(k, kv_heads), _unfold(v, kv_heads),
             _unfold(do, heads), lse.reshape(BH // heads, heads, S),
             delta.reshape(BH // heads, heads, S), scale, causal)
    return _fold(dq)


def flash_dkv_pass(q, k, v, do, lse, delta, *, scale, blk_q=None, blk_k=None,
                   causal=True, heads, kv_heads):
    """(dk, dv) ``[B*kv_heads, S, D]`` from explicit lse/delta, summed over
    each GQA group; see :func:`flash_dq_pass`."""
    BH, S, _ = q.shape
    dk, dv = _dkv(_unfold(q, heads), _unfold(k, kv_heads), _unfold(v, kv_heads),
                  _unfold(do, heads), lse.reshape(BH // heads, heads, S),
                  delta.reshape(BH // heads, heads, S), scale, causal)
    return _fold(dk), _fold(dv)


# --- public entries -------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg=None,
                    *, causal: bool = True, block_q: int | None = None,
                    block_k: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention, q/k/v ``[B, S, H, hd]`` (k/v may have fewer heads)
    -> ``[B, S, H, hd]``, differentiable. The reference's contract: the
    sequence must be a multiple of the (clipped) block sizes, read from
    ``cfg.flash_block_q/k`` when a config is passed (kwargs win). Those are
    the TPU's tiles and only gate the shapes here; the CUDA kernels tile
    the sequence their own way."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {Hkv}")
    if v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if block_q is None:
        block_q = getattr(cfg, "flash_block_q", None) or 512
    if block_k is None:
        block_k = getattr(cfg, "flash_block_k", None) or 1024
    blk_q, blk_k = min(block_q, S), min(block_k, S)
    if S % blk_q or S % blk_k:
        raise ValueError(f"seq len {S} must be a multiple of block sizes ({blk_q}, {blk_k})")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    return _flash_fwd_op(q, k, v, float(scale), bool(causal))[0]


def flash_chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B, S, H, hd]``, lse ``[B, H, S]`` float32) of one (q chunk,
    kv chunk) pair of equal lengths, in the kernels' own layout: the
    forward kernel for CUDA tensors, its plain version for CPU ones. A
    ring's per-pair entry (``parallel/ring_attention.py``); ``causal``
    masks by position within the pair, as on the diagonal."""
    return _fwd(q, k, v, scale, causal)


def flash_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                    lse: torch.Tensor, delta: torch.Tensor, *, scale: float, causal: bool
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one chunk pair from explicit lse and delta ``[B, H,
    S]`` (the ring's global ones): the dq and dk/dv kernels, or their
    plain versions for CPU tensors."""
    dq = _dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = _dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


def sequence_gathered(attn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg=None,
                      **kwargs) -> torch.Tensor:
    """``attn(q, k, v, cfg)`` over the whole sequence where the default mesh
    splits it over sp: q, k and v all-gathered over sp (their gradients
    reduce-scattered back), attention on this rank's heads, and this
    rank's rows of the output kept. The reference's semantics for ``dot``
    and ``flash``: its flash spec leaves the sequence device-local, so
    GSPMD gathers it. Without sp it is ``attn`` itself."""
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import get_default_mesh

    mesh = get_default_mesh()
    sp = mesh.axis("sp") if mesh is not None else None
    if sp is None or sp.size == 1:
        return attn(q, k, v, cfg, **kwargs)
    S = q.shape[1]
    q, k, v = (pdist.all_gather_ad(t, sp, 1) for t in (q, k, v))
    return attn(q, k, v, cfg, **kwargs).narrow(1, sp.index * S, S)


def sharded_flash_attention(q, k, v, cfg=None, **kwargs) -> torch.Tensor:
    """The model-level ``flash`` hook, over the default mesh as the
    reference's reads it: :func:`flash_attention` on this rank's heads
    (its tp block), over the whole sequence (gathered where sp splits it,
    :func:`sequence_gathered`). Without a mesh, or on one rank, it is
    :func:`flash_attention`."""
    return sequence_gathered(flash_attention, q, k, v, cfg, **kwargs)


__all__ = [
    "FLASH_FWD_OP", "LAUNCHES", "flash_attention", "flash_chunk_bwd", "flash_chunk_fwd",
    "flash_dkv_pass", "flash_dkv_plain", "flash_dq_pass", "flash_dq_plain",
    "flash_fwd_pass", "flash_fwd_plain", "kernel_instance", "reset_launches",
    "sequence_gathered", "sharded_flash_attention",
]
