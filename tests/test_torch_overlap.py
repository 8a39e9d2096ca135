"""The port's decomposed fsdp collectives (tony_tpu_torch.ops.overlap) and
sharding rules against the JAX package's, on the CPU.

The port's ring ops run on gloo ranks, each a process of its own
(``tests/torch_ranks.py``, JAX-free), joined under a 120 s limit; the
reference runs here, in its ``impl="scan"`` form under shard_map on a mesh
of as many CPU devices (its pallas form is not a trusted oracle under this
jax line). Inputs are numpy arrays from a seed, each rank taking its rows
and weight shard; results come back as numpy and are assembled along the
same dims. Values and grads of ``sin(op(.)).sum()`` agree within atol 1e-5
/ rtol 1e-4: only the order of float32 sums differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tony_tpu.models import llama as jl
from tony_tpu.ops import overlap as jov
from tony_tpu.ops.compat import shard_map_compat as _shard_map
from tony_tpu.parallel import sharding as jsh
from tony_tpu.parallel.mesh import MeshShape as JMeshShape, build_mesh as jbuild_mesh
from tony_tpu_torch.models import llama as pl
from tony_tpu_torch.ops import overlap as ov
from tony_tpu_torch.parallel import sharding as psh
from tony_tpu_torch.parallel.dist import Axis
from tony_tpu_torch.parallel.mesh import (
    MESH_AXES, Mesh, MeshShape, build_mesh, set_default_mesh,
)
from torch_ranks import spawn

M, D, N = 8, 16, 24
TOL = dict(atol=1e-5, rtol=1e-4)
CASES = [(op, dim, impl) for op in ("agm", "mrs") for dim in (0, 1)
         for impl in ("scan", "pallas")]


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((M, D)).astype(np.float32),
            "w": rng.standard_normal((D, N)).astype(np.float32),
            "g": rng.standard_normal((M, N)).astype(np.float32),
            "x3": rng.standard_normal((M, 4, D)).astype(np.float32)}


def _reference(n: int, data: dict) -> dict:
    """The reference's scan rings under shard_map on n CPU devices: value
    and grads of ``sin(op).sum()`` per (op, dim)."""
    mesh = jbuild_mesh(JMeshShape(fsdp=n), devices=jax.devices()[:n])
    rows = P("fsdp", None)
    out = {}
    for dim in (0, 1):
        side = P("fsdp", None) if dim == 0 else P(None, "fsdp")

        def agm(x, w, dim=dim, side=side):
            return _shard_map(
                lambda xl, wl: jov.all_gather_matmul_local(xl, wl, "fsdp", dim, "scan"),
                mesh=mesh, in_specs=(rows, side), out_specs=rows,
                axis_names={"fsdp"})(x, w)

        def mrs(x, g, dim=dim, side=side):
            return _shard_map(
                lambda xl, gl: jov.matmul_reduce_scatter_local(xl, gl, "fsdp", dim, "scan"),
                mesh=mesh, in_specs=(rows, rows), out_specs=side,
                axis_names={"fsdp"})(x, g)

        for name, fn, other in (("agm", agm, data["w"]), ("mrs", mrs, data["g"])):
            x, o = jnp.asarray(data["x"]), jnp.asarray(other)
            y = fn(x, o)
            gx, go = jax.grad(lambda a, b: jnp.sin(fn(a, b)).sum(), argnums=(0, 1))(x, o)
            out[(name, dim)] = tuple(np.asarray(t) for t in (y, gx, go))
    out["entry"] = np.asarray(jov.overlap_matmul(
        jnp.asarray(data["x3"]), jnp.asarray(data["w"]), gather_dim=0, impl="scan",
        mesh=mesh))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def rings(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"ring{n}")
    data = _inputs()
    np.savez(tmp / "inputs.npz", **data)
    ranks = spawn(n, "ring", {"runs": [{"mesh": {"fsdp": n},
                                        "inputs": str(tmp / "inputs.npz")}]}, tmp)
    return n, data, ranks, _reference(n, data)


@pytest.mark.parametrize("op,dim,impl", CASES)
def test_ring_ops_match_the_reference_scan_form(rings, op, dim, impl):
    """Each rank's rows of the value and dx, and its block of dW (or dg),
    assembled, against the reference's scan ring on the same mesh size."""
    n, _, ranks, ref = rings
    parts = [r["runs"][0][(op, dim, impl)] for r in ranks]
    y_dim = 0 if op == "agm" else dim          # mrs: each rank holds a block
    got = (np.concatenate([p[0] for p in parts], y_dim),
           np.concatenate([p[1] for p in parts], 0),
           np.concatenate([p[2] for p in parts], dim if op == "agm" else 0))
    for name, a, b in zip(("value", "d_first", "d_second"), got, ref[(op, dim)]):
        np.testing.assert_allclose(a, b, err_msg=f"n={n} {op} dim={dim} {impl} {name}",
                                   **TOL)


def test_rank_processes_import_no_jax(rings):
    _, _, ranks, _ = rings
    assert not any(r["jax_loaded"] or r["tony_tpu_loaded"] for r in ranks)


def test_overlap_matmul_entry_and_its_none_cases(rings):
    """The model's entry: a 3-D x against the reference's overlap_matmul;
    None inside a ring and on a mesh whose fsdp axis is 1 (as the
    reference's at axis size 1), and without any mesh."""
    n, data, ranks, ref = rings
    got = np.concatenate([r["runs"][0]["entry"] for r in ranks], 0)
    np.testing.assert_allclose(got, ref["entry"], **TOL)
    assert all(r["runs"][0]["entry_inside_ring"] is None for r in ranks)
    assert all(r["runs"][0]["entry_fsdp1"] is None for r in ranks)
    set_default_mesh(None)
    x, w = torch.ones(8, 16), torch.ones(16, 8)
    assert ov.overlap_matmul(x, w, gather_dim=0) is None
    # a one-rank mesh: the fsdp axis is 1
    assert ov.overlap_matmul(x, w, gather_dim=0, mesh=build_mesh(MeshShape())) is None
    with pytest.raises(ValueError, match="unknown overlap impl"):
        ov.overlap_matmul(x, w, gather_dim=0, impl="mosaic")


def test_bucketed_psum_is_bit_equal_to_one_all_reduce(rings):
    """Small buckets, one bucket and one all-reduce per leaf, in each
    leaf's dtype and the tree's structure. Over two ranks they give the
    same bits (a sum of two is one rounding in either order). Over four,
    gloo's ring all-reduce orders each element's three additions by the
    buffer's length and the element's place in it, so bucketing reorders
    them: float32 within a few ulps (rtol 1e-6), bfloat16 within one of
    its ulps (2^-7 relative)."""
    n, _, ranks, _ = rings
    for r in ranks:
        assert r["runs"][0]["psum_tuple"]
        for small, one, per_leaf in r["runs"][0]["psum"]:
            assert small.dtype == one.dtype == per_leaf.dtype
            if n == 2:
                assert torch.equal(small, one) and torch.equal(small, per_leaf)
            else:
                rtol = 2**-7 if small.dtype == torch.bfloat16 else 1e-6
                for other in (one, per_leaf):
                    torch.testing.assert_close(small.float(), other.float(), rtol=rtol,
                                               atol=1e-6)


@pytest.mark.parametrize("budget", [1, 100, 4096, 1 << 20])
def test_bucket_plan_and_budget_match_the_reference(budget):
    sizes = [4096, 16, 16, 8192, 100, 3, 4096, 4096, 1 << 16]
    assert ov.bucket_plan(sizes, budget) == jov.bucket_plan(sizes, budget)
    with pytest.raises(ValueError):
        ov.bucket_plan(sizes, 0)
    report = {"top_collective": {"achieved_gbps": budget / 1e4}, "compute_ms": 300.0}
    for r in (report, None, {"compute_ms": 0.0}):
        assert (ov.bucket_bytes_from_report(r, n_layers=24)
                == jov.bucket_bytes_from_report(r, n_layers=24))


@pytest.mark.parametrize("n", [8, 24, 256, 1000, 5504, 2048, 7])
def test_chunk_plain_cuts_n_as_the_reference_kernel(n):
    """``_pick_block`` is the reference's; the plain chunk (the CPU's
    kernel 14) equals the reference's float32 chunk product, and counts
    its calls as the plain path's."""
    assert ov._pick_block(n, 256) == jov._pick_block(n, 256)
    rng = np.random.default_rng(n)
    a = rng.standard_normal((12, 40)).astype(np.float32)
    b = rng.standard_normal((40, n)).astype(np.float32)
    ov.reset_launches()
    got = ov.chunk_mm(torch.from_numpy(a), torch.from_numpy(b))
    want = jov._chunk_mm(jnp.asarray(a), jnp.asarray(b), "scan")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert ov.LAUNCHES == {"chunk_mm": 0, "chunk_mm_plain": 1}
    # a transposed view reads as the matrix it is
    got_t = ov.chunk_mm(torch.from_numpy(a.T.copy()).T, torch.from_numpy(b))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown overlap impl"):
        ov.all_gather_matmul_local(torch.ones(4, 4), torch.ones(4, 4), "fsdp", 0, "mosaic",
                                   mesh=build_mesh(MeshShape()))


def test_specs_and_gather_dims_match_the_reference():
    """spec_for over every parameter's logical axes, the batch's spec, and
    overlap_gather_dim over the projections' per-layer axes, under the
    default rules and under a rules table that moves embed off fsdp."""
    for cfg_p, cfg_j in ((pl.LlamaConfig.tiny(), jl.LlamaConfig.tiny()),
                         (pl.LlamaConfig.tiny_moe(), jl.LlamaConfig.tiny_moe())):
        pa, ja = pl.logical_axes(cfg_p), jl.logical_axes(cfg_j)
        assert pa == ja
        for rules in (psh.DEFAULT_RULES, {**psh.DEFAULT_RULES, "embed": None,
                                          "ffn": ("fsdp", "tp")}):
            jspecs = jsh.tree_specs(ja, dict(rules))
            pspecs = psh.tree_specs(pa, rules)
            for key in ("tok_emb", "final_norm", "lm_head"):
                assert pspecs[key] == tuple(jspecs[key])
            for key, spec in pspecs["layers"].items():
                assert spec == tuple(jspecs["layers"][key]), key
                axes = pa["layers"][key][1:]
                assert (psh.overlap_gather_dim(axes, rules)
                        == jsh.overlap_gather_dim(axes, dict(rules)))
    assert psh.spec_for(("batch", "seq")) == tuple(jsh.spec_for(("batch", "seq")))


def _fake_mesh(shape: MeshShape, rank: int) -> Mesh:
    coords, r = [], rank
    for s in reversed(shape.sizes):
        coords.append(r % s)
        r //= s
    coords = coords[::-1]
    return Mesh(shape, rank, {a: Axis(a, s, c) for a, s, c in
                              zip(MESH_AXES, shape.sizes, coords)})


@pytest.mark.parametrize("shape", [MeshShape(fsdp=4), MeshShape(dp=2, fsdp=2),
                                   MeshShape(dp=4)])
def test_shard_blocks_tile_the_tensor(shape):
    """Every rank's block, laid back in rank order along its dims, is the
    whole tensor: parameters by their specs, the batch by ("batch",
    "seq") over dp then fsdp; an indivisible dim raises."""
    full = torch.arange(8 * 12 * 16, dtype=torch.float32).reshape(8, 12, 16)
    spec = (None, "fsdp", None)
    blocks = [psh.shard(full, spec, _fake_mesh(shape, r)) for r in range(shape.n_devices)]
    per_fsdp = {b.shape[1] for b in blocks}
    assert per_fsdp == {12 // shape.fsdp}
    rebuilt = torch.cat(blocks[:shape.fsdp], 1)
    assert torch.equal(rebuilt, full)
    batch = torch.arange(8 * 6).reshape(8, 6)
    bspec = psh.spec_for(("batch", "seq"))
    rows = [psh.shard(batch, bspec, _fake_mesh(shape, r)) for r in range(shape.n_devices)]
    assert torch.equal(torch.cat(rows, 0), batch)
    with pytest.raises(ValueError, match="even blocks"):
        psh.shard(torch.zeros(3, 10), ("fsdp", None), _fake_mesh(MeshShape(fsdp=4), 0))
