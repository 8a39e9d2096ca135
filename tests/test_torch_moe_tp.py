"""MoE at tp above 1 and the capacity dispatches over a mesh
(tony_tpu_torch.parallel.moe with the sharded step) on gloo ranks of
``tests/torch_ranks.py``, against the JAX package on the CPU.

- ``moe_block`` (the grouped dispatch) at tp 2, ep 2 x tp 2 (the blocking
  ep combine and the overlapped one, scan and pallas: the grouped
  kernels' plain versions here) and fsdp 2 x tp 2: each rank holds its
  ``F / tp`` block of its ``E / ep`` experts, and ``y``, ``aux`` and the
  gradients of ``sum(y * y) + aux`` (router, w1, w3, w2, x), assembled
  whole, match the reference's unsharded ``moe_block`` on the global
  batch at the ep tolerances of ``tests/test_torch_moe_mesh.py`` (aux
  1e-6, y atol 1e-5, grads atol 1e-4).
- The capacity dispatches, ``gather`` and ``einsum``, at capacity factor
  0.6 (the reference's own tight factor, ``tests/test_parallel.py``),
  which drops routes on every mesh: at dp 2, ep 2, fsdp 2 x ep 2, sp 2
  and tp 2 the same figures against the reference's ``moe_block`` on the
  global batch, and each rank's kept-route mask, assembled whole, equal
  to the reference's (``_top_k_select``'s positions over the global
  batch against its capacity).
- Five ``make_train_step`` steps of ``tiny_moe`` at tp 2, ep 2 x tp 2 and
  fsdp 2 x tp 2: loss, grad norm and aux within 1e-4, the final
  parameters within atol 1e-4 / rtol 1e-3, against the reference's step
  on the same CPU mesh (at tp above 1 it declines its ep shard_map and
  its GSPMD plain path agrees with its one-device step, so the ROADMAP's
  ep caveat does not arise) and against its one-device step. A router
  gradient counted tp times moves the grad norm far past 1e-4. No route
  lies within 1e-4 of a top-k flip.
- A sharded checkpoint saved by ``fit()`` at tp 2 restores at fsdp 2 and
  in one process to the same global tensors, bit for bit; each rank's
  file holds its tp block of the expert leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tony_tpu.parallel import moe as jm
from torch_mesh_parity import reference_params, reference_run
from torch_ranks import spawn

GROUPED = dict(dim=32, ffn_dim=64, n_experts=4, top_k=2, capacity_factor=8.0,
               dispatch="grouped")
CAPACITY = dict(GROUPED, capacity_factor=0.6)
# 8 sequences of 6 tokens: 48 tokens, capacity(48) = 16 slots an expert
# for 96 routes, so routes drop whatever the draw
X_SHAPE = (8, 6, 32)
# name -> (mesh, grouped cases (overlap impl))
BLOCK = {"tp2": ({"tp": 2}, ["off"]),
         "ep2-tp2": ({"ep": 2, "tp": 2}, ["off", "scan", "pallas"]),
         "fsdp2-tp2": ({"fsdp": 2, "tp": 2}, ["off"])}
CAPACITY_MESHES = {"dp2": {"dp": 2}, "ep2": {"ep": 2}, "fsdp2-ep2": {"fsdp": 2, "ep": 2},
                   "sp2": {"sp": 2}, "tp2": {"tp": 2}}
DISPATCHES = ("gather", "einsum")
MOE = {"n_experts": 4, "attention_impl": "dot"}
# the reference's parameters for the steps (key 1 keeps every route more
# than 1e-4 from a flip over the five steps, tests/test_torch_moe_mesh.py)
KEY = 1
TRAIN = {"tp2": {"tp": 2}, "ep2-tp2": {"ep": 2, "tp": 2}, "fsdp2-tp2": {"fsdp": 2, "tp": 2}}
CKPT_DATA = dict(global_batch=4, seq_len=32, vocab_size=256)


def _world(mesh_d: dict) -> int:
    return int(np.prod(list(mesh_d.values())))


def _inputs():
    cfg = jm.MoEConfig(**GROUPED)
    params = jax.tree.map(np.asarray, jm.init_moe_params(jax.random.key(0), cfg,
                                                         dtype=jnp.float32))
    x = np.random.default_rng(1).standard_normal(X_SHAPE).astype(np.float32)
    return params, x


def _reference_block(params, x, knobs) -> dict:
    """The reference's moe_block on the global batch: y, aux, the grads of
    sum(y*y) + aux, and for a capacity dispatch the kept-route mask."""
    cfg = jm.MoEConfig(**knobs)

    def loss(p, xx):
        y, aux = jm.moe_block(p, xx, cfg)
        return jnp.sum(y * y) + aux

    y, aux = jax.jit(lambda p, a: jm.moe_block(p, a, cfg))(params, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    out = {"y": np.asarray(y), "aux": float(aux), "x": np.asarray(gx),
           **{k: np.asarray(v) for k, v in gp.items()}}
    if cfg.dispatch != "grouped":
        flat = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.asarray(flat) @ params["router"], axis=-1)
        _, _, pos, _ = jm._top_k_select(probs, cfg)
        cap = cfg.capacity(flat.shape[0])
        out["kept"] = np.asarray(pos < cap).reshape(*x.shape[:2], -1)
        out["capacity"] = cap
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_tp")
    params, x = _inputs()
    np.savez(tmp / "block.npz", x=x, **params)
    tree, path = reference_params(tmp, key=KEY, **MOE)

    def block_run(mesh_d, cfg, cases):
        return {"task": "moe_block", "mesh": mesh_d, "inputs": str(tmp / "block.npz"),
                "cfg": cfg, "cases": cases}

    def train_run(mesh_d):
        return {"task": "train", "mesh": mesh_d, "steps": 5, "params": path, "model": MOE,
                "data": CKPT_DATA, "opt": dict(lr=5e-3, warmup_steps=2, decay_steps=5)}

    ckpt = tmp / "ckpt-tp2"
    plan: dict[int, list] = {2: [], 4: []}
    for name, (mesh_d, impls) in BLOCK.items():
        plan[_world(mesh_d)].append((f"block-{name}", block_run(
            mesh_d, GROUPED, [{"impl": i} for i in impls])))
    for name, mesh_d in CAPACITY_MESHES.items():
        plan[_world(mesh_d)].append((f"capacity-{name}", block_run(
            mesh_d, CAPACITY, [{"impl": "off", "cfg": {"dispatch": d}} for d in DISPATCHES])))
    for name, mesh_d in TRAIN.items():
        plan[_world(mesh_d)].append((f"train-{name}", train_run(mesh_d)))
    plan[2].append(("fit-tp2", {"task": "fit", "mesh": {"tp": 2}, "model": MOE,
                                "data": CKPT_DATA, "steps": 3, "checkpoint_dir": str(ckpt),
                                "fit": {"checkpoint_every": 3}}))
    plan[2].append(("restore-fsdp2", {"task": "restore", "mesh": {"fsdp": 2}, "model": MOE,
                                      "checkpoint_dir": str(ckpt)}))
    port, loaded = {}, False
    for world, named in plan.items():
        ranks = spawn(world, "moe_block", {"runs": [r for _, r in named]}, tmp / f"w{world}")
        for j, (name, _) in enumerate(named):
            port[name] = [r["runs"][j] for r in ranks]
        loaded |= any(r["jax_loaded"] or r["tony_tpu_loaded"] for r in ranks)
    port["jax_loaded"] = loaded
    ref = {"grouped": _reference_block(params, x, GROUPED),
           **{d: _reference_block(params, x, dict(CAPACITY, dispatch=d)) for d in DISPATCHES},
           **{f"train-{n}": reference_run(m, MOE, key=KEY) for n, m in TRAIN.items()},
           "train-one": reference_run({}, MOE, key=KEY)}
    return port, ref, ckpt


def _assert_block(got: dict, want: dict, label: str) -> None:
    assert abs(got["aux"] - want["aux"]) < 1e-6, label
    np.testing.assert_allclose(got["y"], want["y"].reshape(got["y"].shape), atol=1e-5,
                               err_msg=label)
    for k in ("router", "w1", "w3", "w2", "x"):
        np.testing.assert_allclose(got[k], want[k].reshape(got[k].shape), atol=1e-4,
                                   err_msg=f"{label} {k}")


@pytest.mark.parametrize("name", list(BLOCK))
def test_grouped_block_at_tp_matches_the_reference(runs, name):
    """Each case (the ep combine blocking, scan and pallas at ep 2 x tp 2)
    against the reference's unsharded block; every rank holds the same
    assembled figures and its expert block of shape (E / ep, D, F / tp)
    and (E / ep, F / tp, D)."""
    port, ref, _ = runs
    mesh_d, impls = BLOCK[name]
    ep, tp = mesh_d.get("ep", 1), mesh_d.get("tp", 1)
    ranks = port[f"block-{name}"]
    for i, impl in enumerate(impls):
        cases = [r["cases"][i] for r in ranks]
        for c in cases:
            assert c["shapes"] == {"w1": (4 // ep, 32, 64 // tp), "w3": (4 // ep, 32, 64 // tp),
                                   "w2": (4 // ep, 64 // tp, 32)}
            assert c["aux"] == cases[0]["aux"]
            for k in ("y", "router", "w1", "w3", "w2", "x"):
                np.testing.assert_array_equal(c[k], cases[0][k], err_msg=f"{impl} {k}")
        _assert_block(cases[0], ref["grouped"], f"{name} {impl}")


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("name", list(CAPACITY_MESHES))
def test_capacity_dispatch_over_a_mesh_matches_the_global_batch(runs, name, dispatch):
    """y, aux, every gradient and the drop mask against the reference's
    moe_block on the global batch; the tight factor drops routes here."""
    port, ref, _ = runs
    want = ref[dispatch]
    for r in port[f"capacity-{name}"]:
        got = r["cases"][DISPATCHES.index(dispatch)]
        assert got["capacity"] == want["capacity"] == 16
        np.testing.assert_array_equal(got["kept"], want["kept"])
        _assert_block(got, want, f"{name} {dispatch}")
    assert not want["kept"].all() and want["kept"].any()


def test_the_two_capacity_dispatches_drop_alike(runs):
    """gather and einsum keep the same routes and give the same y on every
    mesh (within 1e-5)."""
    port, _, _ = runs
    for name in CAPACITY_MESHES:
        g, e = port[f"capacity-{name}"][0]["cases"]
        np.testing.assert_array_equal(g["kept"], e["kept"])
        np.testing.assert_allclose(g["y"], e["y"], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("against", ["mesh", "one"])
@pytest.mark.parametrize("name", list(TRAIN))
def test_moe_steps_at_tp_match_the_reference(runs, name, against):
    """Five steps: loss, grad norm and aux within 1e-4 of the reference's
    step on the same CPU mesh and of its one-device step, the same on every
    rank; the final parameters, all-gathered, within atol 1e-4 / rtol
    1e-3; no route within 1e-4 of a flip."""
    port, ref, _ = runs
    want = ref[f"train-{name}" if against == "mesh" else "train-one"]
    ranks = port[f"train-{name}"]
    assert min(r["margin"] for r in ranks) > 1e-4
    for key in ("loss", "grad_norm"):
        assert all(r[key] == ranks[0][key] for r in ranks), key
        np.testing.assert_allclose(ranks[0][key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {key}")
    got = ranks[0]["params"]
    assert set(got) == set(want["params"])
    for key, value in want["params"].items():
        assert all(np.array_equal(r["params"][key], got[key]) for r in ranks), key
        np.testing.assert_allclose(got[key], value, atol=1e-4, rtol=1e-3,
                                   err_msg=f"{name} {key}")


def test_aux_at_tp_is_the_global_batchs(runs):
    """Each step's aux is the same on every rank and meshes agree within
    1e-6: the router's statistics are the global batch's at every mesh."""
    port, _, _ = runs
    aux = [port[f"train-{n}"][0]["aux"] for n in TRAIN]
    for a in aux[1:]:
        np.testing.assert_allclose(a, aux[0], atol=1e-6)
    for n in TRAIN:
        assert all(r["aux"] == port[f"train-{n}"][0]["aux"] for r in port[f"train-{n}"])


def test_a_step_saved_at_tp_2_restores_at_fsdp_2_and_in_one_process(runs):
    """fit() at tp 2 saved step 3: restored at fsdp 2 and onto one process,
    the same global parameters and moments bit for bit; each rank's file
    holds its tp block of every expert leaf, the two laid side by side
    along the ffn dim being the whole leaf."""
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.trainer import default_optimizer, make_train_state

    port, _, ckpt = runs
    assert all("refused" not in r for r in port["fit-tp2"])
    cfg = LlamaConfig.tiny(**MOE)
    template = make_train_state(cfg, default_optimizer(), seed=3, device="cpu")
    one, step = CheckpointManager(str(ckpt)).restore(template)
    assert step == 3
    whole = {"params": one.params, "mu": one.opt_state["mu"], "nu": one.opt_state["nu"]}
    for got in port["restore-fsdp2"]:
        assert got["step"] == 3
        for part, tree in whole.items():
            for key, want in _leaves(tree).items():
                np.testing.assert_array_equal(got["whole"][part][key], want.detach().numpy(),
                                              err_msg=f"{part} {key}")
    blocks = [torch.load(ckpt / "3" / f"rank{r}.pt", weights_only=True)["params"]["layers"]
              for r in range(2)]
    for name, dim in (("w1", 3), ("w3", 3), ("w2", 2)):
        parts = [b[name] for b in blocks]
        assert parts[0].shape[dim] == cfg.ffn_dim // 2, name
        assert torch.equal(torch.cat(parts, dim), one.params["layers"][name].detach()), name


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_rank_processes_import_no_jax(runs):
    port, _, _ = runs
    assert not port["jax_loaded"]
