"""Ring attention: sequence (context) parallelism over the sp ring.

The counterpart of ``tony_tpu/parallel/ring_attention.py``. The sequence
is split over the ``sp`` axis in contiguous blocks (block i on sp index
i, as ``train/data.py`` cuts a batch); each rank keeps its queries and
passes K/V around the ring, one hop to the next index a step
(:func:`~tony_tpu_torch.parallel.dist.start_hop`, issued before the
step's chunk and waited on after it), folding each arriving chunk into its
queries' output. After n steps every query has met every key, exactly.

- :func:`ring_attention_local`: the plain float32 online-softmax ring
  (scores and the accumulators in float32; masked positions take a large
  negative filler, not -inf, so a fully masked chunk stays finite). Its
  gradient runs through autograd, each hop's gradient going back one
  index (:func:`~tony_tpu_torch.parallel.dist.hop_arrived`).
- :func:`ring_flash_attention_local`: the flash kernels as the chunk's
  inner (``ops/attention.py`` :func:`flash_chunk_fwd` /
  :func:`flash_chunk_bwd`: kernels 1-3 for CUDA tensors, their plain
  versions for CPU ones). A pair whose keys all lie before the queries
  runs the non-causal instance, the diagonal pair the causal one, and a
  pair whose keys all lie after them runs nothing; the partial outputs
  merge by their logsumexps. The backward runs the dq and dk/dv kernels
  per pair against the global logsumexp, the dk/dv accumulators riding
  the ring back to their owners. It is a ``torch.library`` custom op, so
  a remat policy keeping ``flash_res`` keeps its output and logsumexp and
  the backward never re-runs the ring's forward.

The reference permutes K/V n times in the forward, the last hop bringing
them home; nothing reads them there, so the port issues n - 1 (and in the
backward n - 1 K/V hops beside the n hops of the accumulators).

The model hooks :func:`ring_attention` and :func:`ring_flash_attention`
read the default mesh and raise the reference's error without one. They
take this rank's blocks (its rows, its sequence block, its tp heads):
where the reference's closure shard_maps full arrays, a rank here
already holds its block.
"""

from __future__ import annotations

import math

import torch

from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.dist import Axis
from tony_tpu_torch.parallel.mesh import Mesh, get_default_mesh

_NEG = -0.7 * torch.finfo(torch.float32).max


# --- the plain ring -------------------------------------------------------------


def _chunk_scores(q, k, scale, q_start, k_start, causal):
    """float32 scores ``[B, H, Sq, Sk]``, masked at global positions."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_start + torch.arange(q.shape[1], device=q.device)
        k_pos = k_start + torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, _NEG)
    return s


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, axis: Axis,
                         causal: bool = True) -> torch.Tensor:
    """This rank's ring attention over ``axis``: q, k, v ``[B, S_local, H,
    hd]`` are its contiguous sequence block (block index = its index on
    the axis); returns its queries' output, exact. Differentiable."""
    n, my = axis.size, axis.index
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    o = q.new_zeros((B, H, S, D), dtype=torch.float32)
    m = q.new_full((B, H, S), _NEG, dtype=torch.float32)
    l = q.new_zeros((B, H, S), dtype=torch.float32)
    kv = torch.stack([k, v])
    for j in range(n):
        hop = pdist.start_hop(kv, axis) if j < n - 1 else None
        kv_idx = (my - j) % n
        k_cur, v_cur = kv.unbind(0)
        s = _chunk_scores(q, k_cur, scale, my * S, kv_idx * S, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_cur.float())
        m = m_new
        if hop is not None:
            kv = pdist.hop_arrived(kv, hop.wait(), axis)
    return (o / l[..., None]).transpose(1, 2).to(q.dtype)


# --- the ring over the flash kernels --------------------------------------------


# the axes the custom op's string keys name (a custom op takes no Python
# objects), keyed by what the axis spans: a rebuilt mesh's axis replaces
# its predecessor, so the registry holds one entry per distinct axis
_AXES: dict[str, Axis] = {}


def _axis_key(axis: Axis) -> str:
    key = f"{axis.name}:{axis.size}:{axis.index}:{','.join(map(str, axis.ranks))}"
    _AXES[key] = axis
    return key


def _ring_flash_fwd(q, k, v, axis: Axis, scale: float):
    """(out ``[B, S, H, hd]`` in q's dtype, global lse ``[B, H, S]``)."""
    from tony_tpu_torch.ops.attention import flash_chunk_fwd

    n, my = axis.size, axis.index
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), _NEG, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack([k, v])
    for j in range(n):
        hop = pdist.start_hop(kv, axis) if j < n - 1 else None
        kv_idx = (my - j) % n
        if kv_idx <= my:           # keys after the queries: nothing to run
            out_c, lse_c = flash_chunk_fwd(q, kv[0], kv[1], scale=scale,
                                           causal=kv_idx == my)
            new = torch.logaddexp(lse, lse_c)
            w_old = torch.exp(lse - new).transpose(1, 2)[..., None]
            w_new = torch.exp(lse_c - new).transpose(1, 2)[..., None]
            o = o * w_old + out_c.float() * w_new
            lse = new
        if hop is not None:
            kv = hop.wait()
    return o.to(q.dtype), lse


def _ring_flash_bwd(q, k, v, out, lse, do, axis: Axis, scale: float):
    """(dq, dk, dv): per pair the dq and dk/dv passes against the global
    lse and delta; each K/V chunk's float32 dk/dv accumulator travels with
    it and is home after n hops, each hop in flight while the next pair's
    kernels run."""
    from tony_tpu_torch.ops.attention import flash_chunk_bwd

    n, my = axis.size, axis.index
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    acc_hop = None
    for j in range(n):
        hop = pdist.start_hop(kv, axis, tag=1) if j < n - 1 else None
        kv_idx = (my - j) % n
        part = None
        if kv_idx <= my:
            dq_c, dk_c, dv_c = flash_chunk_bwd(q, kv[0], kv[1], do, lse, delta, scale=scale,
                                               causal=kv_idx == my)
            dq += dq_c.float()
            part = torch.stack([dk_c, dv_c]).float()
        # the accumulator of the chunk held now: fresh for this rank's own
        # chunk, else the one the previous index sent on with it
        acc = torch.zeros(kv.shape, dtype=torch.float32, device=q.device) if j == 0 \
            else acc_hop.wait()
        if part is not None:
            acc = acc + part
        acc_hop = pdist.start_hop(acc, axis, tag=2)
        if hop is not None:
            kv = hop.wait()
    dkv = acc_hop.wait()
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


@torch.library.custom_op("tony_tpu_torch::ring_flash_fwd", mutates_args=())
def _ring_flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis_key: str,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    return _ring_flash_fwd(q, k, v, _AXES[axis_key], scale)


def _setup_context(ctx, inputs, output):
    q, k, v, axis_key, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.axis_key, ctx.scale = axis_key, scale


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, dout, _AXES[ctx.axis_key], ctx.scale)
    return dq, dk, dv, None, None


torch.library.register_autograd("tony_tpu_torch::ring_flash_fwd", _backward,
                                setup_context=_setup_context)

# the op a remat policy saves under flash_res (models/llama.py)
RING_FLASH_FWD_OP = torch.ops.tony_tpu_torch.ring_flash_fwd.default


def ring_flash_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               axis: Axis) -> torch.Tensor:
    """Ring attention with the flash kernels per chunk pair: causal, exact,
    the contract of :func:`ring_attention_local`; k/v may carry fewer
    heads (GQA, read by index and riding the ring at their own width).
    The reference's TPU tiles must divide its chunk; the kernels here take
    any chunk length, so the port takes no tile sizes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _ring_flash_fwd_op(q, k, v, _axis_key(axis), scale)[0]


# --- the model hooks ------------------------------------------------------------


def make_ring_attention(mesh: Mesh, *, axis_name: str = "sp", causal: bool = True):
    """The attention hook over ``mesh``'s ``axis_name`` ring: q, k, v this
    rank's blocks (rows, sequence block, tp heads)."""
    axis = mesh.axis(axis_name)

    def attn(q, k, v, cfg=None):
        return ring_attention_local(q, k, v, axis=axis, causal=causal)

    return attn


def ring_attention(q, k, v, cfg=None):
    """Model hook (``attention_impl="ring"``): the default mesh's ring."""
    mesh = get_default_mesh()
    if mesh is None:
        raise RuntimeError(
            "ring attention needs a mesh: call "
            "tony_tpu_torch.parallel.set_default_mesh(mesh) (fit() does this "
            "automatically for its training mesh)"
        )
    return make_ring_attention(mesh)(q, k, v, cfg)


def make_ring_flash_attention(mesh: Mesh, *, axis_name: str = "sp"):
    """The ring x flash hook over ``mesh``'s ``axis_name`` ring, the flash
    kernels within each chunk pair."""
    axis = mesh.axis(axis_name)

    def attn(q, k, v, cfg=None):
        return ring_flash_attention_local(q, k, v, axis)

    return attn


def ring_flash_attention(q, k, v, cfg=None):
    """Model hook (``attention_impl="ring_flash"``): the default mesh's
    ring."""
    mesh = get_default_mesh()
    if mesh is None:
        raise RuntimeError(
            "ring-flash attention needs a mesh: call "
            "tony_tpu_torch.parallel.set_default_mesh(mesh) first"
        )
    return make_ring_flash_attention(mesh)(q, k, v, cfg)


__all__ = [
    "RING_FLASH_FWD_OP", "make_ring_attention", "make_ring_flash_attention",
    "ring_attention", "ring_attention_local", "ring_flash_attention",
    "ring_flash_attention_local",
]
