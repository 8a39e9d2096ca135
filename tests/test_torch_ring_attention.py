"""The port's sequence-parallel attentions (tony_tpu_torch.parallel
ring_attention and ulysses) on gloo ranks against the JAX package's on a
CPU mesh of the same shape, on the CPU.

The port's ranks are processes of ``tests/torch_ranks.py`` (JAX-free);
each holds its block of q, k and v under ``attn_spec(mesh, "sp")`` (the
sequence over sp, heads over tp) and runs the hook over the mesh; its
output and the gradients of ``sum(out ** 2)`` are all-gathered whole.
The reference runs ``make_ring_attention`` / ``make_ulysses_attention`` /
``make_ring_flash_attention`` on the full arrays over its CPU mesh, at
the shapes and meshes of its own tests (``tests/test_parallel.py``).
Same numpy inputs, float32. Tolerances: the reference's own, ring and
Ulysses outputs atol 1e-4, ring's gradients 1e-3 (the same float32 sums
in another order), ring_flash's output 1e-5 and dq, dk, dv 5e-5 (the
flash passes' plain versions here, the reference's Pallas kernels in
interpret mode there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tony_tpu.parallel import make_ring_attention, make_ulysses_attention
from tony_tpu.parallel import make_ring_flash_attention
from tony_tpu.parallel.mesh import MeshShape, build_mesh
from torch_ranks import spawn

DENSE = (2, 64, 8, 8, 16)          # B, S, H, Hkv, hd: tests/test_parallel.py:64
FLASH = (2, 256, 4, 4, 32)         # :566
GQA = (2, 128, 4, 2, 32)           # :602
# name -> (impl, mesh, shape)
CASES = {
    "ring-sp2": ("ring", {"sp": 2}, DENSE),
    "ring-sp4": ("ring", {"sp": 4}, DENSE),
    "ring-tp2-sp2": ("ring", {"tp": 2, "sp": 2}, DENSE),
    "ulysses-sp2": ("ulysses", {"sp": 2}, DENSE),
    "ulysses-sp4": ("ulysses", {"sp": 4}, DENSE),
    "ulysses-tp2-sp2": ("ulysses", {"tp": 2, "sp": 2}, DENSE),
    "ring_flash-sp2": ("ring_flash", {"sp": 2}, FLASH),
    "ring_flash-sp4": ("ring_flash", {"sp": 4}, FLASH),
    "ring_flash-tp2-sp2": ("ring_flash", {"tp": 2, "sp": 2}, FLASH),
    "ring_flash-gqa-sp2": ("ring_flash", {"sp": 2}, GQA),
}
MAKE = {"ring": make_ring_attention, "ulysses": make_ulysses_attention,
        "ring_flash": make_ring_flash_attention}
# (output atol, gradient atol)
TOL = {"ring": (1e-4, 1e-3), "ulysses": (1e-4, 1e-3), "ring_flash": (1e-5, 5e-5)}


def _inputs(shape, seed=0):
    B, S, H, Hkv, hd = shape
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((B, S, H, hd)).astype(np.float32),
            "k": rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            "v": rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)}


def _world(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("attn")
    paths = {}
    for shape in {c[2] for c in CASES.values()}:
        paths[shape] = tmp / f"qkv-{'x'.join(map(str, shape))}.npz"
        np.savez(paths[shape], **_inputs(shape))
    port = {}
    for world in (2, 4):
        names = [n for n, c in CASES.items() if _world(c[1]) == world]
        ranks = spawn(world, "attention",
                      {"runs": [{"impl": CASES[n][0], "mesh": CASES[n][1],
                                 "inputs": str(paths[CASES[n][2]])} for n in names]},
                      tmp / f"w{world}")
        for j, n in enumerate(names):
            port[n] = [r["runs"][j] for r in ranks]
        port[f"jax_loaded_{world}"] = any(r["jax_loaded"] or r["tony_tpu_loaded"]
                                          for r in ranks)
    ref = {}
    for name, (impl, mesh_d, shape) in CASES.items():
        data = {k: jnp.asarray(v) for k, v in _inputs(shape).items()}
        n = _world(mesh_d)
        attn = MAKE[impl](build_mesh(MeshShape(**mesh_d), devices=jax.devices()[:n]))

        def loss(q, k, v, attn=attn):
            out = attn(q, k, v)
            return jnp.sum(out ** 2), out

        # one compile for the output and its gradients
        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            data["q"], data["k"], data["v"])
        ref[name] = (np.asarray(out), [np.asarray(g) for g in grads])
    return port, ref


@pytest.mark.parametrize("name", list(CASES))
def test_hook_matches_the_reference_on_the_same_mesh(runs, name):
    """Output and the q, k, v gradients, all-gathered on every rank,
    against the reference's on its CPU mesh."""
    port, ref = runs
    impl = CASES[name][0]
    out_tol, grad_tol = TOL[impl]
    want_out, want_grads = ref[name]
    for r in port[name]:
        np.testing.assert_allclose(r["out"], want_out, atol=out_tol, rtol=0,
                                   err_msg=f"{name} out")
        for what, got, want in zip(("dq", "dk", "dv"), r["grads"], want_grads):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=grad_tol, rtol=0,
                                       err_msg=f"{name} {what}")


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0] == "ring_flash"])
def test_ring_flash_runs_each_pair_once_and_skips_the_rest(runs, name):
    """sp index i runs the flash passes on i + 1 chunk pairs (the diagonal
    causal, the earlier chunks full) and launches nothing for the pairs
    whose keys lie after its queries: forward, dq and dk/dv alike. Here
    they are the plain versions (CPU tensors), never a kernel."""
    port, _ = runs
    mesh_d = CASES[name][1]
    sp = mesh_d["sp"]
    for rank, r in enumerate(port[name]):
        pairs = rank % sp + 1            # sp is the innermost axis
        assert r["launches"] == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                                 "flash_fwd_plain": pairs, "flash_dq_plain": pairs,
                                 "flash_dkv_plain": pairs}, (rank, r["launches"])


def test_rank_processes_import_no_jax(runs):
    port, _ = runs
    assert not port["jax_loaded_2"] and not port["jax_loaded_4"]


def test_what_the_hooks_refuse_matches_the_reference():
    """Without a default mesh the model hooks raise the reference's
    RuntimeError; Ulysses refuses local heads that sp does not split with
    the reference's ValueError (it raises before any transfer, so one
    process with a two-index axis shows it). The reference's ring_flash
    also refuses a chunk its TPU tiles do not divide; the port's kernels
    take any chunk, so such a chunk runs, as flash_attention on one rank."""
    import dataclasses

    import torch

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.dist import Axis
    from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh, MeshShape as PortShape
    from tony_tpu_torch.ops.attention import flash_attention
    from tony_tpu_torch.parallel.mesh import build_mesh
    from tony_tpu_torch.parallel.ring_attention import (
        make_ring_flash_attention as port_ring_flash, ring_attention, ring_flash_attention,
    )
    from tony_tpu_torch.parallel.ulysses import make_ulysses_attention as port_ulysses
    from tony_tpu_torch.parallel.ulysses import ulysses_attention

    q = torch.zeros(1, 32, 4, 16)
    for hook, what in ((ring_attention, "ring attention"),
                       (ring_flash_attention, "ring-flash attention"),
                       (ulysses_attention, "ulysses attention")):
        with pytest.raises(RuntimeError, match=f"{what} needs a mesh"):
            hook(q, q, q)
    shape = PortShape(sp=2)
    mesh = Mesh(shape, 0, {a: Axis(a, n) for a, n in zip(MESH_AXES, shape.sizes)})
    with pytest.raises(ValueError, match="n_heads=3 not divisible by sp size 2"):
        port_ulysses(mesh)(*(torch.zeros(1, 32, 3, 16),) * 3)
    cfg = dataclasses.replace(LlamaConfig.tiny(), flash_block_q=64, flash_block_k=64)
    q, k, v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 1, 96, 4, 16), dtype=np.float32))
    torch.testing.assert_close(port_ring_flash(build_mesh())(q, k, v, cfg),
                               flash_attention(q, k, v), atol=1e-6, rtol=1e-6)
