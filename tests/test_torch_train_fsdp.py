"""The port's training over a dp x fsdp mesh (tony_tpu_torch.train with
parallel/ and ops/overlap.py) against the JAX package's step on the same
mesh, on the CPU.

The port's ranks are gloo processes (``tests/torch_ranks.py``, JAX-free),
joined under a 120 s limit; the reference's ``make_train_step`` runs here
on a mesh of as many CPU devices. Both start from the reference's
parameters (each rank its blocks, ``shards_from_numpy``) and read the same
synthetic batches (each rank its rows). Five float32 steps of the tiny
config: per-step loss and grad norm within 1e-4, final parameters within
atol 1e-4 / rtol 1e-3, as the one-device parity tests hold them; only the
order of float32 sums differs (the ring's partial products, the
collectives' sums).

The reference's bucketed dp path (a shard_map manual over dp) does not
trace under this jax line (its scan carry's varying-axes types differ; the
MoE case of it is among the known failures), so the port's bucketed runs
are held against the reference's GSPMD step on the same mesh, as the
reference's own test holds its bucketed trajectory against that step."""

import jax
import numpy as np
import pytest

from tony_tpu.models import llama as jl
from tony_tpu.parallel.mesh import MeshShape as JMeshShape, build_mesh, set_default_mesh
from tony_tpu.train import data as jdata
from tony_tpu.train import trainer as jtrainer
from tony_tpu_torch.models import llama as pl
from torch_ranks import spawn

STEPS = 5
DATA = dict(global_batch=4, seq_len=32, vocab_size=256)
OPT = dict(lr=5e-3, warmup_steps=2, decay_steps=5)
# name -> (mesh, model knobs of both packages, the port's overlap impl,
# grad_bucket_bytes); the reference runs the ring's scan form wherever the
# port runs either form
CONFIGS = {
    "fsdp2": ({"fsdp": 2}, {}, "", None),
    "fsdp2-scan-remat": ({"fsdp": 2}, {"remat": True, "remat_policy": "nothing"},
                         "scan", None),
    "fsdp4-pallas": ({"fsdp": 4}, {}, "pallas", None),
    "dp2-fsdp2": ({"dp": 2, "fsdp": 2}, {}, "", None),
    "dp2-fsdp2-one-bucket": ({"dp": 2, "fsdp": 2}, {}, "", 1 << 30),
    "dp2-fsdp2-buckets": ({"dp": 2, "fsdp": 2}, {}, "", 4096),
}
WORLD = {2: ("fsdp2", "fsdp2-scan-remat"),
         4: ("fsdp4-pallas", "dp2-fsdp2", "dp2-fsdp2-one-bucket", "dp2-fsdp2-buckets")}
# kernel 14's launches a step through the production recipe (flash,
# remat save_attn_kernel): every trunk projection's ring runs n chunks in
# the forward, again in the backward's recompute, n for dx and n for dW
COUNT_RUN = {"mesh": {"fsdp": 2}, "steps": 2, "data": DATA, "opt": OPT,
             "model": {"attention_impl": "flash", "flash_block_q": 16, "flash_block_k": 16,
                       "remat": True, "remat_policy": "save_attn_kernel",
                       "overlap_impl": "pallas"}}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


def _reference(name: str, params) -> dict:
    mesh_d, knobs, impl, _ = CONFIGS[name]
    shape = JMeshShape(**mesh_d)
    mesh = build_mesh(shape, devices=jax.devices()[:shape.n_devices])
    set_default_mesh(mesh)
    cfg = jl.LlamaConfig.tiny(attention_impl="dot", overlap_impl="scan" if impl else "",
                              **knobs)
    opt = jtrainer.default_optimizer(**OPT)
    state = jtrainer.make_train_state(jax.random.key(0), cfg, mesh, opt)
    step = jtrainer.make_train_step(cfg, mesh, opt)
    batches = jdata.synthetic_batches(jdata.DataConfig(**DATA))
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, *next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    set_default_mesh(None)
    return {"loss": losses, "grad_norm": norms,
            "params": _flatten(jax.tree.map(np.asarray, state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    mesh1 = build_mesh(JMeshShape(), devices=jax.devices()[:1])
    init = jtrainer.make_train_state(jax.random.key(0), jl.LlamaConfig.tiny(), mesh1,
                                     jtrainer.default_optimizer(**OPT))
    np.savez(tmp / "params.npz", **_flatten(jax.tree.map(np.asarray, init.params)))
    port = {}
    for world, names in WORLD.items():
        args = []
        for name in names:
            mesh_d, knobs, impl, bucket = CONFIGS[name]
            args.append({"mesh": mesh_d, "steps": STEPS, "data": DATA, "opt": OPT,
                         "params": str(tmp / "params.npz"), "grad_bucket_bytes": bucket,
                         "model": {"attention_impl": "dot", "overlap_impl": impl, **knobs}})
        if world == 2:
            args.append({**COUNT_RUN, "params": str(tmp / "params.npz")})
        ranks = spawn(world, "train", {"runs": args}, tmp / f"w{world}")
        for j, name in enumerate(names):
            port[name] = [r["runs"][j] for r in ranks]
        if world == 2:
            port["counts"] = [r["runs"][-1] for r in ranks]
        port[f"jax_loaded_{world}"] = any(r["jax_loaded"] or r["tony_tpu_loaded"]
                                          for r in ranks)
    ref = {name: _reference(name, init.params) for name in CONFIGS}
    return port, ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_the_reference_on_the_same_mesh(runs, name):
    port, ref = runs
    ranks = port[name]
    for key in ("loss", "grad_norm"):
        # every rank reports the global batch's figures
        assert all(r[key] == ranks[0][key] for r in ranks), key
        np.testing.assert_allclose(ranks[0][key], ref[name][key], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {key}")
    # the final parameters, all-gathered from the blocks (sharding.unshard)
    # on every rank
    got = ranks[0]["params"]
    assert set(got) == set(ref[name]["params"])
    for key, want in ref[name]["params"].items():
        assert all(np.array_equal(r["params"][key], got[key]) for r in ranks), key
        np.testing.assert_allclose(got[key], want, atol=1e-4, rtol=1e-3,
                                   err_msg=f"{name} {key}")


def test_bucketing_is_bit_equal_to_the_single_reduction(runs):
    """Small buckets, one bucket and the unbucketed dp reduction give the
    same loss and grad-norm bits at every step, and the same parameters: a
    bucket is a schedule, not an approximation (dp 2: each element's sum
    is one rounding in any grouping; the 1/2 and 1/4 scalings are exact)."""
    port, _ = runs
    base = port["dp2-fsdp2"]
    for name in ("dp2-fsdp2-one-bucket", "dp2-fsdp2-buckets"):
        for a, b in zip(port[name], base):
            assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"], name
            for key in a["params"]:
                np.testing.assert_array_equal(a["params"][key], b["params"][key], err_msg=key)


def test_kernel_14_launches_equal_the_count_the_ring_implies(runs):
    """Under the production recipe with ``overlap_impl="pallas"`` (the
    plain chunk on the CPU), each step launches 4n chunks per trunk
    projection and layer: n in the forward ring, n again in the
    backward's recompute (remat re-runs the projections), n in dx's ring
    and n in dW's reduce-scatter ring; none on another path."""
    port, _ = runs
    n, cfg = 2, pl.LlamaConfig.tiny()
    want = cfg.n_layers * 7 * 4 * n
    for r in port["counts"]:
        assert all(step == {"chunk_mm": 0, "chunk_mm_plain": want}
                   for step in r["launches"]), r["launches"]
        assert all(np.isfinite(r["loss"]))


def test_rank_processes_import_no_jax(runs):
    port, _ = runs
    assert not port["jax_loaded_2"] and not port["jax_loaded_4"]


def test_fit_trains_at_fsdp_2_on_the_cpu(tmp_path):
    """fit() over two gloo ranks that brought their group up themselves:
    the mesh is fsdp 2, the ring's pallas form runs (the plain chunk),
    rank 0 alone calls on_metrics, and both ranks return the same final
    loss. With a checkpoint directory the same run saves sharded (each
    rank's blocks and rank 0's manifest) and trains the same losses."""
    run = {"model": {"attention_impl": "dot"}, "data": DATA, "mesh": {"fsdp": 2},
           "steps": 3, "overlap_impl": "pallas"}
    ranks = spawn(2, "fit", {"runs": [run, {**run, "checkpoint_dir": str(tmp_path / "ck")}]},
                  tmp_path)
    assert sorted(p.name for p in (tmp_path / "ck" / "3").iterdir()) == [
        "manifest.json", "rank0.pt", "rank1.pt"]
    first, second = (r["runs"][0] for r in ranks)
    assert [m["step"] for m in first["metrics"]] == [1, 2, 3]
    assert second["metrics"] == []
    assert first["final"]["final_loss"] == second["final"]["final_loss"]
    assert np.isfinite(first["final"]["final_loss"])
    assert first["final"]["steps"] == 3
    saving = ranks[0]["runs"][1]
    assert [m["loss"] for m in saving["metrics"]] == [m["loss"] for m in first["metrics"]]
    assert not any(r["jax_loaded"] for r in ranks)


def _mesh(shape) -> "Mesh":
    from tony_tpu_torch.parallel.dist import Axis
    from tony_tpu_torch.parallel.mesh import MESH_AXES, Mesh

    return Mesh(shape, 0, {a: Axis(a, n) for a, n in zip(MESH_AXES, shape.sizes)})


def test_what_the_mesh_does_not_train_over_raises():
    """MoE at tp above 1 builds from the default mesh, each rank holding
    its ffn block of every expert and the router whole; pp
    builds, each rank holding its stage's block of the stacked layers
    (``pp_rules``), and refuses 1f1b with MoE and a layer count pp does
    not split with the reference's messages; tp and sp build, from the
    default mesh (the trunk and its attention hooks read their axes
    there), each rank holding its tp block of the wide dims; ep trains
    (MoE's expert parallelism), and a MoE step over a mesh that is not
    the default mesh raises, since its MoE blocks read their mesh there;
    a one-rank mesh trains as no mesh."""
    from tony_tpu_torch.parallel.mesh import MeshShape, set_default_mesh
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    opt = default_optimizer()
    cfg = pl.LlamaConfig.tiny()
    make_train_step(cfg, opt, mesh=_mesh(MeshShape(pp=2)))
    assert make_train_state(cfg, opt, mesh=_mesh(MeshShape(pp=2)), device="cpu").params[
        "layers"]["wq"].shape == (1, 64, 64)
    with pytest.raises(NotImplementedError, match="MoE"):
        make_train_step(pl.LlamaConfig.tiny_moe(), opt, mesh=_mesh(MeshShape(pp=2)),
                        pp_schedule="1f1b")
    with pytest.raises(ValueError, match="n_layers=2 not divisible by pp=4"):
        make_train_step(cfg, opt, mesh=_mesh(MeshShape(pp=4)))
    # MoE at tp builds from the default mesh, each rank its ffn block of
    # every expert (tests/test_torch_moe_tp.py trains it)
    moe_tp = _mesh(MeshShape(tp=2))
    with pytest.raises(ValueError, match="default mesh"):
        make_train_step(pl.LlamaConfig.tiny_moe(), opt, mesh=moe_tp)
    set_default_mesh(moe_tp)
    try:
        make_train_step(pl.LlamaConfig.tiny_moe(), opt, mesh=moe_tp)
        layers = make_train_state(pl.LlamaConfig.tiny_moe(), opt, mesh=moe_tp,
                                  device="cpu").params["layers"]
        assert (layers["w1"].shape, layers["w2"].shape) == ((2, 4, 64, 64), (2, 4, 64, 64))
        assert layers["router"].shape == (2, 64, 4)
    finally:
        set_default_mesh(None)
    for shape, wq in ((MeshShape(tp=2), (2, 64, 32)), (MeshShape(fsdp=2, sp=2), (2, 32, 64))):
        mesh = _mesh(shape)
        with pytest.raises(ValueError, match="default mesh"):
            make_train_step(cfg, opt, mesh=mesh)
        set_default_mesh(mesh)
        try:
            make_train_step(cfg, opt, mesh=mesh)
            assert make_train_state(cfg, opt, mesh=mesh, device="cpu").params[
                "layers"]["wq"].shape == wq
        finally:
            set_default_mesh(None)
    make_train_step(cfg, opt, mesh=_mesh(MeshShape(ep=2)))
    with pytest.raises(ValueError, match="default mesh"):
        make_train_step(pl.LlamaConfig.tiny_moe(), opt, mesh=_mesh(MeshShape(fsdp=2)))
    state = make_train_state(cfg, opt, mesh=_mesh(MeshShape()), device="cpu")
    assert state.params["layers"]["wq"].shape == (2, 64, 64)
    with pytest.raises(ValueError, match="block"):
        make_train_state(cfg, opt, mesh=_mesh(MeshShape(fsdp=2)), device="cpu",
                         params=state.params)


def test_fit_scopes_its_default_mesh():
    """fit() makes its mesh the default only while it runs and gives the
    caller's back after it; a step under a default mesh of more than one
    rank that is not its own raises, where it would read tp there."""
    from tony_tpu_torch.parallel.mesh import MeshShape, get_default_mesh, set_default_mesh
    from tony_tpu_torch.train import DataConfig, FitConfig, fit
    from tony_tpu_torch.train.data import synthetic_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg = pl.LlamaConfig.tiny()
    data = DataConfig(global_batch=2, seq_len=16, vocab_size=cfg.vocab_size)
    during: list = []
    fit(FitConfig(model=cfg, data=data, steps=1,
                  on_metrics=lambda m: during.append(get_default_mesh())), device="cpu")
    assert during[0] is not None and get_default_mesh() is None
    stale = _mesh(MeshShape(tp=2))
    set_default_mesh(stale)
    try:
        fit(FitConfig(model=cfg, data=data, steps=1), device="cpu")
        assert get_default_mesh() is stale
        opt = default_optimizer()
        step = make_train_step(cfg, opt)
        with pytest.raises(ValueError, match="not this step's mesh"):
            step(make_train_state(cfg, opt, device="cpu"), *next(synthetic_batches(data)))
    finally:
        set_default_mesh(None)
