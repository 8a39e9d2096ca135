"""GQA decode attention: one decode step per row, read at native
``n_kv_heads`` width, over paged KV pools through a block table or over a
contiguous cache.

The counterpart of ``tony_tpu/ops/decode_attention.py``. The serving
engine calls :func:`decode_attention` in its paged form once per layer per
decode step (``serve/engine.py``). Layouts are the reference's:

- ``q [B, G, H, hd]`` (or ``[B, H, hd]`` for one query per row): G query
  positions per row, query g attends positions
  ``< lengths[b] - (G - 1) + g`` (G = 1 is the one-token rule; the
  speculative verify step feeds G = draft + 1);
- paged form: ``k``/``v`` pools ``[P, Hkv, block, hd]`` and ``tables [B,
  M]`` int32: row b's logical block j is physical block ``tables[b, j]``;
  entries past a row's length are never read by the kernel, and must still
  be valid ids for the plain version (the engine points them at the
  scratch block 0);
- contiguous form (``tables=None``): ``k``/``v [B, Hkv, T, hd]``, ``T`` a
  multiple of ``min(block, T)``;
- ``lengths [B]`` int32, at least 1.

Where it runs is decided by the tensors' device alone:

- CUDA tensors launch the hand-written kernel
  ``csrc/paged_decode_attention.cu`` (built with ``nvcc`` at first use,
  ``ops/_build.py``), or raise. There is no fallback. Both forms share the
  kernel's shape rule (:func:`check_kernel_shape`) and its two designs:
  bf16 queries run on the tensor cores with a fixed split over the
  sequence (``tc::paged_decode_kernel``, ``tc::paged_quant_decode_kernel``
  over quantized pools, ``tc::decode_kernel``, then
  ``tc::decode_merge_kernel`` over a float32 workspace this wrapper
  allocates, :func:`split_plan`); float32 queries and the bf16 shapes that
  instance does not take run the scalar CTA body. :func:`kernel_instance`
  says which, from the built library's ``decode_route``.
- CPU tensors take the plain PyTorch versions that the tests hold against
  the reference: :func:`decode_attention_plain` (a masked float32 softmax)
  and :func:`paged_decode_attention_plain` (a gather through the table,
  then the same).

``LAUNCHES`` counts both, so a run can show which one its path went
through.

**Quantized pools** (``k_scale``/``v_scale [P, Hkv]`` float32 given, the
paged form only): the pools hold int8 or ``float8_e4m3fn`` payloads with
one scale per physical block per kv head (``serve/cache.py``). Each K/V
element is dequantized as ``float(payload) * scale`` and rounded to
``q.dtype`` before the dot, as the reference's ``_paged_quant_kernel``
does. CUDA tensors launch the same kernel's quantized form: with bf16
queries its tensor-core instance stages one-byte tiles and dequantizes
each tile once into the bf16 layout kernel 8's math reads, so its output
equals kernel 8's over pools dequantized beforehand; with float32 queries
the scalar CTA dequantizes each chunk in registers while staging it. CPU
tensors take the plain version with the scale rows gathered beside the
blocks.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# one count per path, bumped where the path runs: the CUDA kernel's launch
# and the plain version's CPU dispatch
LAUNCHES: dict[str, int] = {
    "decode_attention": 0,
    "decode_attention_plain": 0,
    "paged_decode_attention": 0,
    "paged_decode_attention_plain": 0,
    "paged_decode_attention_quant": 0,
    "paged_decode_attention_quant_plain": 0,
}

_NEG = -0.7 * torch.finfo(torch.float32).max
_KERNEL = "paged_decode_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAYLOAD_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper CTA may use
_CHUNK_BYTES = 64 * 1024      # K+V staged per chunk at most
# positions a split of the tensor-core instance covers (the library's
# decode_split_positions; checked when the library is bound)
SPLIT = 256
_FORMS = ("decode_attention", "paged_decode_attention", "paged_decode_attention_quant")
_INSTANCES = {1: "tensor cores", 0: "scalar"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reference_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lengths: torch.Tensor, *,
                               scale: float | None = None) -> torch.Tensor:
    """Repeat-expanded contiguous oracle: q ``[B, H, hd]`` or
    ``[B, G, H, hd]``; k/v ``[B, Hkv, T, hd]``; positions < lengths[b]
    (minus G-1-g for query g) are attended."""
    if q.dim() == 4:
        G = q.shape[1]
        return torch.stack([
            reference_decode_attention(q[:, g], k, v, lengths - (G - 1) + g,
                                       scale=scale)
            for g in range(G)
        ], dim=1)
    B, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k.float())
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None].long()
    s = torch.where(valid[:, None, :], s * scale, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bhkd->bhd", p, v)


def _gather_blocks(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pool[idx]`` along the block axis; one-byte payloads move as raw
    bytes, so float8 pools need no float8 indexing kernel."""
    if pool.element_size() == 1 and pool.dtype != torch.uint8:
        return pool.view(torch.uint8)[idx].view(pool.dtype)
    return pool[idx]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Plain PyTorch decode attention over a contiguous cache: q ``[B, G,
    H, hd]``, k/v ``[B, Hkv, T, hd]``. One masked float32 softmax over the
    positions under the G rule, scores scaled after the dot, probabilities
    cast to the K/V dtype before P.V with a float32 sum (the reference's
    ``_decode_kernel`` numerics, in one pass)."""
    B, G, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    qg = q.reshape(B, G, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bgxrd,bxkd->bgxrk", qg, k.float()) * scale
    limit = lengths.long()[:, None] - (G - 1) + torch.arange(G, device=q.device)
    valid = torch.arange(T, device=q.device)[None, None, :] < limit[:, :, None]
    vmask = valid[:, :, None, None, :]                        # [B, G, 1, 1, T]
    s = torch.where(vmask, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1)
    # p rounds to the K/V dtype before P.V; the sum accumulates in fp32
    acc = torch.einsum("bgxrk,bxkd->bgxrd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, G, H, hd).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 lengths: torch.Tensor, tables: torch.Tensor, *,
                                 scale: float, k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch paged decode attention, q ``[B, G, H, hd]``: gather
    every table entry's block into a contiguous ``[B, Hkv, M * block, hd]``
    cache, then :func:`decode_attention_plain` (the reference's
    ``_paged_scan`` numerics, in one pass). With ``k_scale``/``v_scale``
    the gathered blocks dequantize through their scale rows to ``q.dtype``
    first, ``(float(payload) * scale).to(q.dtype)``."""
    B, hd = q.shape[0], q.shape[3]
    Hkv, blk = k.shape[1], k.shape[2]
    T = tables.shape[1] * blk
    idx = tables.long()
    kb, vb = _gather_blocks(k, idx), _gather_blocks(v, idx)    # [B, M, Hkv, blk, hd]
    if k_scale is not None:
        kb = (kb.float() * k_scale[idx][..., None, None]).to(q.dtype)
        vb = (vb.float() * v_scale[idx][..., None, None]).to(q.dtype)
    # [B, M, Hkv, blk, hd] -> [B, Hkv, T, hd]
    kb = kb.permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, hd)
    vb = vb.permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, hd)
    return decode_attention_plain(q, kb, vb, lengths, scale=scale)


def _chunk(blk: int, hd: int, itemsize: int) -> int:
    """Positions staged per shared-memory chunk: the whole block when K+V
    of it fit in ``_CHUNK_BYTES``, else the largest halving that does.
    ``itemsize`` is the staged dtype's, which is q's for quantized pools
    too: their chunks are dequantized while staged, so a one-byte payload
    takes as much shared memory as the query dtype's K/V would."""
    chunk = blk
    while 2 * chunk * hd * itemsize > _CHUNK_BYTES and chunk % 16 == 0:
        chunk //= 2
    return chunk


def _smem_bytes(R: int, hd: int, chunk: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA (layout in the .cu source)."""
    return 2 * chunk * hd * itemsize + 4 * (2 * R * hd + R * chunk + 3 * R)


def check_kernel_shape(G: int, H: int, Hkv: int, hd: int, blk: int,
                       payload_itemsize: int, q_itemsize: int) -> tuple[int, int]:
    """The CUDA kernel's shape rule, shared by its wrapper and by the
    engine (which checks it at construction, before any request is
    admitted): returns the scalar CTA body's ``(chunk, shared-memory
    bytes)`` or raises ValueError. Every shape it accepts has an instance
    (:func:`kernel_instance`; the tensor-core one sizes its own shared
    memory). ``payload_itemsize`` is the pools' element size (1 for
    quantized pools), ``q_itemsize`` the queries' (K/V are staged in q's
    dtype)."""
    # the staging loads are 16 bytes of payload per thread
    vec = max(8, 16 // payload_itemsize)
    if hd > 256 or hd % vec:
        raise ValueError(f"head_dim {hd} must be a multiple of {vec}, at most 256")
    if blk % 16 or not 16 <= blk <= 128:
        raise ValueError(f"block {blk} must be a multiple of 16 in [16, 128]")
    chunk = _chunk(blk, hd, q_itemsize)
    smem = _smem_bytes(G * (H // Hkv), hd, chunk, q_itemsize)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"G={G} x rep={H // Hkv} query rows at head_dim {hd} need {smem} B "
            f"of shared memory (limit {_SMEM_LIMIT})"
        )
    return chunk, smem


def split_plan(M: int, blk: int, R: int, hd: int) -> tuple[int, int]:
    """The tensor-core instance's split of a row of ``M`` blocks of ``blk``
    positions at ``R`` query rows a kv head: ``(splits, workspace floats
    per (row, kv head))``. Splits sit at fixed multiples of :data:`SPLIT`
    positions; with more than one, each keeps float32 partials (acc ``[R,
    hd]``, then m and l per query row) for the merge, and with one there
    is no workspace."""
    splits = -(-M * blk // SPLIT)
    return splits, (splits * R * (hd + 2) if splits > 1 else 0)


@functools.cache
def _kernel(form: str):
    """One of the kernel's C entry points, built and bound on first use:
    ``"paged"``, its quantized form ``"quant"``, ``"contiguous"``, or
    ``"route"`` (``decode_route``)."""
    from tony_tpu_torch.ops._build import load

    lib = load(_KERNEL).lib
    lib.decode_split_positions.restype = ctypes.c_int
    if lib.decode_split_positions() != SPLIT:
        raise RuntimeError(f"{_KERNEL} splits at {lib.decode_split_positions()} "
                           f"positions, the wrapper at {SPLIT}")
    if form == "quant":
        fn = lib.paged_decode_attention_quant
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
    elif form == "paged":
        fn = lib.paged_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    elif form == "contiguous":
        fn = lib.decode_attention_contiguous
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    else:
        fn = lib.decode_route
        fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _route(quant: bool, dtype_code: int, hd: int, R: int) -> int:
    """The library's ``decode_route`` for R = G * rep query rows a kv head:
    1 tensor cores, 0 scalar."""
    return _kernel("route")(int(quant), dtype_code, hd, R)


def kernel_instance(name: str, dtype: torch.dtype, hd: int, blk: int, G: int,
                    rep: int) -> str:
    """Which design the CUDA kernel ``name`` (decode_attention,
    paged_decode_attention or paged_decode_attention_quant) runs for
    queries of ``dtype`` at head_dim ``hd``, block ``blk``, G query
    positions and ``rep`` heads a kv head, as the built library dispatches
    it: ``"tensor cores"`` (bf16 queries, over bf16 or quantized pools,
    mma.sync with a split over the sequence) or ``"scalar"``. A shape
    :func:`check_kernel_shape` refuses raises its ValueError before
    anything is built; otherwise this builds the library on first use, so
    it needs nvcc."""
    if name not in _FORMS:
        raise ValueError(f"no decode kernel {name!r}; one of {_FORMS}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16 queries, not {dtype}")
    quant = name == "paged_decode_attention_quant"
    itemsize = torch.empty((), dtype=dtype).element_size()
    check_kernel_shape(G, rep, 1, hd, blk, 1 if quant else itemsize, itemsize)
    return _INSTANCES[_route(quant, _DTYPE_CODES[dtype], hd, G * rep)]


def _check_operands(named: list[tuple[str, torch.Tensor]]) -> None:
    """One device for every operand, each contiguous."""
    devs = {t.device for _, t in named}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aligned(*named: tuple[str, torch.Tensor]) -> None:
    """Both designs stage K/V in 16-byte copies, the tensor-core instance
    the queries too."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _workspace(q: torch.Tensor, Hkv: int, M: int, blk: int,
               quant: bool = False) -> torch.Tensor | None:
    """The tensor-core instance's float32 partials (:func:`split_plan`), or
    None for the scalar body and for a grid of one split; ``quant`` asks
    the route for quantized pools."""
    B, G, H, hd = q.shape
    R = G * (H // Hkv)
    if _route(quant, _DTYPE_CODES[q.dtype], hd, R) != 1:
        return None
    _check_aligned(("q", q))
    _, per = split_plan(M, blk, R, hd)
    return torch.empty(B * Hkv * per, dtype=torch.float32, device=q.device) if per else None


def _paged_cuda(q, k, v, lengths, tables, *, scale: float, k_scale=None,
                v_scale=None) -> torch.Tensor:
    B, G, H, hd = q.shape
    _, Hkv, blk, _ = k.shape
    M = tables.shape[1]
    quant = k_scale is not None
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged decode kernel takes float32 or bfloat16, not {q.dtype}")
    if quant:
        if k.dtype not in _PAYLOAD_CODES or v.dtype != k.dtype:
            raise TypeError(f"quantized pools must be int8 or float8_e4m3fn, not "
                            f"{k.dtype} / {v.dtype}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 or \
                k_scale.shape != k.shape[:2] or v_scale.shape != k.shape[:2]:
            raise ValueError(f"scales must be float32 {tuple(k.shape[:2])}, not "
                             f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError("lengths and tables must be int32")
    named = [("q", q), ("k", k), ("v", v), ("lengths", lengths), ("tables", tables)]
    if quant:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    _check_operands(named)
    chunk, smem = check_kernel_shape(G, H, Hkv, hd, blk, k.element_size(),
                                     q.element_size())
    _check_aligned(("k", k), ("v", v))
    ws = _workspace(q, Hkv, M, blk, quant)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    shape = (B, G, H, Hkv, hd, blk, M, chunk, scale, smem, _DTYPE_CODES[q.dtype])
    if quant:
        err = _kernel("quant")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), tables.data_ptr(),
            out.data_ptr(), 0 if ws is None else ws.data_ptr(), *shape,
            _PAYLOAD_CODES[k.dtype], stream,
        )
        name = "paged_decode_attention_quant"
    else:
        err = _kernel("paged")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            tables.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(),
            *shape, stream,
        )
        name = _KERNEL
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def _contiguous_cuda(q, k, v, lengths, *, block: int, scale: float) -> torch.Tensor:
    B, G, H, hd = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode kernel takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    _check_operands([("q", q), ("k", k), ("v", v), ("lengths", lengths)])
    chunk, smem = check_kernel_shape(G, H, Hkv, hd, block, k.element_size(),
                                     q.element_size())
    _check_aligned(("k", k), ("v", v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = _workspace(q, Hkv, T // block, block)
    err = _kernel("contiguous")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), B, G, H, Hkv, hd, block, T // block,
        chunk, scale, smem, _DTYPE_CODES[q.dtype], stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, tables: torch.Tensor | None = None,
                     block: int = 128, scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One decode step of attention (see the module docstring for shapes):
    over paged pools when ``tables`` is given (quantized when
    ``k_scale``/``v_scale`` are), else over a contiguous cache read in
    tiles of ``min(block, T)`` positions. Returns ``[B, G, H, hd]``, or
    ``[B, H, hd]`` for a 3-D ``q``. CUDA tensors run the kernel; CPU
    tensors the plain version."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is not None and tables is None:
        raise ValueError("quantized decode_attention requires the paged form (tables)")
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    B, G, H, hd = q.shape
    if tables is None:
        if k.shape != v.shape or k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd:
            raise ValueError(f"decode_attention shapes q={tuple(q.shape)} "
                             f"k={tuple(k.shape)} v={tuple(v.shape)}")
        T = k.shape[2]
        blk = min(block, T)
        if T % blk:
            raise ValueError(f"cache length {T} must be a multiple of block {blk}")
    else:
        if k.shape != v.shape or k.dim() != 4 or k.shape[3] != hd:
            raise ValueError(f"paged decode_attention shapes q={tuple(q.shape)} "
                             f"k={tuple(k.shape)} v={tuple(v.shape)}")
        if tables.dim() != 2 or tables.shape[0] != B:
            raise ValueError(f"tables {tuple(tables.shape)} do not match batch {B}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} do not match batch {B}")
    if H % k.shape[1]:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {k.shape[1]}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cuda":
        if tables is None:
            out = _contiguous_cuda(q, k, v, lengths, block=blk, scale=scale)
        else:
            out = _paged_cuda(q, k, v, lengths, tables, scale=scale,
                              k_scale=k_scale, v_scale=v_scale)
    elif q.device.type == "cpu":
        if tables is None:
            LAUNCHES["decode_attention_plain"] += 1
            out = decode_attention_plain(q, k, v, lengths, scale=scale)
        else:
            plain = "paged_decode_attention" + ("_quant" if k_scale is not None else "")
            LAUNCHES[plain + "_plain"] += 1
            out = paged_decode_attention_plain(q, k, v, lengths, tables, scale=scale,
                                               k_scale=k_scale, v_scale=v_scale)
    else:
        raise ValueError(f"no decode attention for device {q.device}")
    return out[:, 0] if squeeze else out


__all__ = [
    "LAUNCHES", "SPLIT", "check_kernel_shape", "decode_attention",
    "decode_attention_plain", "kernel_instance", "paged_decode_attention_plain",
    "reference_decode_attention", "reset_launches", "split_plan",
]
