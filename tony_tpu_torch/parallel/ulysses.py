"""Ulysses sequence parallelism: heads and sequence traded by all-to-all.

The counterpart of ``tony_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses,
arXiv:2309.14509), the alternative to ring attention: one all-to-all
re-shards this rank's ``[B, S/n, H, hd]`` blocks from sequence-split to
head-split ``[B, S, H/n, hd]``, exact causal attention runs over the
whole sequence on those heads (the port's plain ``dot_attention``, as the
reference runs its own), and a second all-to-all restores the sequence
split. Each all-to-all's gradient is the inverse all-to-all
(``parallel/dist.py`` :func:`~tony_tpu_torch.parallel.dist.all_to_all_ad`).
It needs this rank's heads to split over the axis and runs no kernel.
"""

from __future__ import annotations

from tony_tpu_torch.parallel import dist as pdist
from tony_tpu_torch.parallel.dist import Axis
from tony_tpu_torch.parallel.mesh import Mesh, get_default_mesh


def ulysses_attention_local(q, k, v, *, axis: Axis):
    """This rank's Ulysses attention over ``axis``: q, k, v ``[B, S_local,
    H, hd]`` sequence blocks in, its block of the output out."""
    from tony_tpu_torch.models.llama import dot_attention

    n, H = axis.size, q.shape[2]
    if H % n:
        raise ValueError(f"n_heads={H} not divisible by {axis.name} size {n}")

    def to_heads(x):          # split heads (dim 2), gather the sequence (dim 1)
        return pdist.all_to_all_ad(x, axis, 2, 1)

    def to_seq(x):            # split the sequence, gather heads
        return pdist.all_to_all_ad(x, axis, 1, 2)

    return to_seq(dot_attention(to_heads(q), to_heads(k), to_heads(v)))


def make_ulysses_attention(mesh: Mesh, *, axis_name: str = "sp"):
    """The Ulysses hook over ``mesh``'s ``axis_name``: q, k, v this rank's
    blocks."""
    axis = mesh.axis(axis_name)

    def attn(q, k, v, cfg=None):
        return ulysses_attention_local(q, k, v, axis=axis)

    return attn


def ulysses_attention(q, k, v, cfg=None):
    """Model hook (``attention_impl="ulysses"``): the default mesh's sp
    axis."""
    mesh = get_default_mesh()
    if mesh is None:
        raise RuntimeError(
            "ulysses attention needs a mesh: call "
            "tony_tpu_torch.parallel.set_default_mesh(mesh) (fit() does this "
            "automatically for its training mesh)"
        )
    return make_ulysses_attention(mesh)(q, k, v, cfg)


__all__ = ["make_ulysses_attention", "ulysses_attention", "ulysses_attention_local"]
