"""What the port's tp and sp training tests share: the reference's
parameters and its step on a CPU mesh, the port's one-rank step, the
port's steps on gloo ranks (``tests/torch_ranks.py``), and the comparison.

Five float32 steps of the tiny config from the reference's parameters
(key 0) over the same synthetic batches. Loss and grad norm within 1e-4,
final parameters within atol 1e-4 / rtol 1e-3, as the one-device parity
tests hold them: only the order of float32 sums differs (the collectives'
sums, the ring's partial outputs, the flash passes' tiles)."""

from __future__ import annotations

import jax
import numpy as np

from torch_ranks import tiny_config

STEPS = 5
DATA = dict(global_batch=4, seq_len=32, vocab_size=256)
OPT = dict(lr=5e-3, warmup_steps=2, decay_steps=5)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


def reference_params(tmp, key: int = 0, **model) -> tuple[dict, str]:
    """The reference's initial parameters for ``tiny(**model)`` (a nested
    dict of numpy arrays) and the ``.npz`` the ranks read them from."""
    from tony_tpu.models import llama as jl
    from tony_tpu.parallel.mesh import MeshShape, build_mesh
    from tony_tpu.train import trainer as jtrainer

    mesh1 = build_mesh(MeshShape(), devices=jax.devices()[:1])
    init = jtrainer.make_train_state(jax.random.key(key), tiny_config(jl.LlamaConfig, model),
                                     mesh1, jtrainer.default_optimizer(**OPT))
    tree = jax.tree.map(np.asarray, init.params)
    path = tmp / f"params-{key}.npz"
    np.savez(path, **flatten(tree))
    return tree, str(path)


def reference_run(mesh_d: dict, knobs: dict, key: int = 0, **step_kw) -> dict:
    """The reference's ``make_train_step`` (``step_kw`` its pipeline
    arguments) on a CPU mesh of ``mesh_d``: each step's loss and grad norm,
    and the final parameters. At pp above 1 the state is made under
    ``pp_rules``, as the reference's own pp tests make it."""
    from tony_tpu.models import llama as jl
    from tony_tpu.parallel.mesh import MeshShape, build_mesh, set_default_mesh
    from tony_tpu.train import data as jdata
    from tony_tpu.train import trainer as jtrainer

    shape = MeshShape(**mesh_d)
    mesh = build_mesh(shape, devices=jax.devices()[:shape.n_devices])
    set_default_mesh(mesh)
    cfg = tiny_config(jl.LlamaConfig, knobs)
    opt = jtrainer.default_optimizer(**OPT)
    rules = jtrainer.pp_rules() if shape.pp > 1 else jtrainer.DEFAULT_RULES
    state = jtrainer.make_train_state(jax.random.key(key), cfg, mesh, opt, rules)
    step = jtrainer.make_train_step(cfg, mesh, opt, **step_kw)
    batches = jdata.synthetic_batches(jdata.DataConfig(**DATA))
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, *next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    set_default_mesh(None)
    return {"loss": losses, "grad_norm": norms,
            "params": flatten(jax.tree.map(np.asarray, state.params))}


def port_one_rank(knobs: dict, tree: dict) -> dict:
    """The port's own step on one process, from ``tree``: each step's loss
    and grad norm, the kernels' plain launches a step, and the final
    parameters. Its default mesh is one rank's (the ring and Ulysses hooks
    need a mesh, as the reference's do)."""
    from tony_tpu_torch.models.convert import params_from_numpy
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.ops import attention, fused_ce
    from tony_tpu_torch.parallel.mesh import build_mesh, set_default_mesh
    from tony_tpu_torch.train.data import DataConfig, synthetic_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg = tiny_config(LlamaConfig, knobs)
    opt = default_optimizer(**OPT)
    state = make_train_state(cfg, opt, params=params_from_numpy(tree, cfg, device="cpu"))
    step = make_train_step(cfg, opt)
    batches = synthetic_batches(DataConfig(**DATA))
    losses, norms, kernels = [], [], []
    set_default_mesh(build_mesh())
    try:
        for _ in range(STEPS):
            attention.reset_launches()
            fused_ce.reset_launches()
            state, m = step(state, *next(batches))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            kernels.append({**attention.LAUNCHES, **fused_ce.LAUNCHES})
    finally:
        set_default_mesh(None)
    return {"loss": losses, "grad_norm": norms, "kernels": kernels,
            "params": flatten(_numpy(state.params))}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in tree.items()}


def port_runs(configs: dict, params: str, tmp, step_args: dict | None = None) -> dict:
    """Each config's ``make_train_step`` run on gloo ranks (``step_args``:
    name -> its pipeline arguments, ``pp_schedule`` and ``microbatches``):
    one spawn per world size; name -> every rank's result, and
    ``jax_loaded``."""
    from torch_ranks import spawn

    worlds: dict[int, list[str]] = {}
    for name, (mesh_d, *_rest) in configs.items():
        worlds.setdefault(int(np.prod(list(mesh_d.values()))), []).append(name)
    out, loaded = {}, False
    for world, names in sorted(worlds.items()):
        args = [{"mesh": configs[n][0], "steps": STEPS, "data": DATA, "opt": OPT,
                 "params": params, "model": configs[n][1], **(step_args or {}).get(n, {})}
                for n in names]
        ranks = spawn(world, "train", {"runs": args}, tmp / f"w{world}")
        for j, name in enumerate(names):
            out[name] = [r["runs"][j] for r in ranks]
        loaded |= any(r["jax_loaded"] or r["tony_tpu_loaded"] for r in ranks)
    out["jax_loaded"] = loaded
    return out


def assert_run_matches(ranks: list, want: dict, name: str) -> None:
    """Every rank reports the global batch's loss and grad norm, within
    1e-4 of ``want``'s, and the same final parameters (all-gathered from
    the blocks), within atol 1e-4 / rtol 1e-3 of ``want``'s."""
    for key in ("loss", "grad_norm"):
        assert all(r[key] == ranks[0][key] for r in ranks), f"{name} {key}"
        np.testing.assert_allclose(ranks[0][key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} {key}")
    got = ranks[0]["params"]
    assert set(got) == set(want["params"])
    for key, value in want["params"].items():
        assert all(np.array_equal(r["params"][key], got[key]) for r in ranks), key
        np.testing.assert_allclose(got[key], value, atol=1e-4, rtol=1e-3,
                                   err_msg=f"{name} {key}")
