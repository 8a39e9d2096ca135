"""One rank of a gloo process group for the port's multi-rank CPU tests.

Run as a script, one process per rank::

    python tests/torch_ranks.py JOB.json

``JOB.json`` names the world size, this rank, a ``FileStore`` path (each
test's own ``tmp_path``, so concurrent tests never share a port), the
task and its runs (a run may name a task of its own); the rank writes its results with ``torch.save`` to
the job's ``out`` path. This file imports neither JAX nor the JAX package
(``tests/test_torch_imports.py`` checks), and each rank reports whether
JAX was loaded by the time it finished. :func:`spawn` starts the ranks and
joins them under one time limit. A task may kill its own rank (a crash
mid-save); ``spawn(may_die=...)`` names the ranks allowed to end so, and a
rank whose group a dead peer broke returns its results without the final
barrier.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spawn(world: int, task: str, args: dict, tmp: Path, timeout_s: float = 120.0,
          may_die: tuple[int, ...] = ()) -> list:
    """Run ``task`` on ``world`` gloo ranks, each its own process, and
    return their results in rank order (None for a rank of ``may_die``
    that was killed). Raises if a rank fails, or kills them all and raises
    if they have not all finished within ``timeout_s``."""
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store-{task}-{time.monotonic_ns()}"
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(world):
        job = {"world": world, "rank": rank, "store": str(store), "task": task,
               "args": args, "out": str(tmp / f"{task}-{rank}.pt")}
        path = tmp / f"{task}-{rank}.json"
        path.write_text(json.dumps(job))
        procs.append(subprocess.Popen([sys.executable, __file__, str(path)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError(f"{task} on {world} ranks did not finish in {timeout_s} s")
    killed = {r for r, p in enumerate(procs) if r in may_die and p.returncode < 0}
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs)
           if p.returncode and r not in killed]
    if bad:
        raise RuntimeError(f"{task}: ranks failed: {bad}")
    import torch

    return [None if r in killed else torch.load(tmp / f"{task}-{r}.pt", weights_only=False)
            for r in range(world)]


# --- tasks (run inside a rank) ----------------------------------------------------


def _ring(args: dict, mesh) -> dict:
    """The ring ops on this rank's rows: values and grads of
    ``sin(op(x, .)).sum()``, for each (op, dim, impl); the overlap_matmul
    entry; bucketed_psum against one all-reduce."""
    import numpy as np
    import torch

    from tony_tpu_torch.ops import overlap as ov
    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.mesh import build_mesh, manual_region, MeshShape

    data = np.load(args["inputs"])
    n, i = mesh.axis("fsdp").size, mesh.axis("fsdp").index
    rows = lambda a: torch.from_numpy(np.ascontiguousarray(np.split(a, n, 0)[i]))
    out: dict = {}
    for impl in ("scan", "pallas"):
        for dim in (0, 1):
            x = rows(data["x"]).requires_grad_(True)
            w = torch.from_numpy(np.ascontiguousarray(
                np.split(data["w"], n, dim)[i])).requires_grad_(True)
            y = ov.all_gather_matmul_local(x, w, "fsdp", dim, impl, mesh=mesh)
            gx, gw = torch.autograd.grad(torch.sin(y).sum(), (x, w))
            out[("agm", dim, impl)] = (y.detach().numpy(), gx.numpy(), gw.numpy())
            x = rows(data["x"]).requires_grad_(True)
            g = rows(data["g"]).requires_grad_(True)
            y = ov.matmul_reduce_scatter_local(x, g, "fsdp", dim, impl, mesh=mesh)
            gx, gg = torch.autograd.grad(torch.sin(y).sum(), (x, g))
            out[("mrs", dim, impl)] = (y.detach().numpy(), gx.numpy(), gg.numpy())
    x3 = rows(data["x3"])
    w_rows = torch.from_numpy(np.ascontiguousarray(np.split(data["w"], n, 0)[i]))
    out["entry"] = ov.overlap_matmul(x3, w_rows, gather_dim=0, impl="scan",
                                     mesh=mesh).numpy()
    with manual_region():
        out["entry_inside_ring"] = ov.overlap_matmul(x3, w_rows, gather_dim=0, mesh=mesh)
    # a mesh whose fsdp axis is 1 (every rank on dp)
    dp_mesh = build_mesh(MeshShape(dp=n))
    out["entry_fsdp1"] = ov.overlap_matmul(x3, w_rows, gather_dim=0, mesh=dp_mesh)
    # bucketed_psum: small buckets, one bucket, and one all-reduce per leaf
    gen = torch.Generator().manual_seed(100 + i)
    tree = {"a": torch.randn(64, 8, generator=gen),
            "b": [torch.randn(1000, generator=gen).to(torch.bfloat16),
                  torch.randn(3, 5, generator=gen)],
            "c": torch.randn(4096, generator=gen)}
    small = ov.bucketed_psum(tree, "fsdp", bucket_bytes=1024, mesh=mesh)
    one = ov.bucketed_psum(tree, "fsdp", bucket_bytes=1 << 30, mesh=mesh)
    axis = mesh.axis("fsdp")
    leaves = [tree["a"], tree["b"][0], tree["b"][1], tree["c"]]
    got = [small["a"], small["b"][0], small["b"][1], small["c"]]
    whole = [one["a"], one["b"][0], one["b"][1], one["c"]]
    per_leaf = [pdist.all_reduce(t, axis) for t in leaves]
    out["psum"] = list(zip(got, whole, per_leaf))
    out["psum_tuple"] = isinstance(small["b"], list) and small["b"][0].dtype == torch.bfloat16
    return out


def _train(args: dict, mesh) -> dict:
    """``make_train_step`` from the reference's parameters (cut into this
    rank's blocks) over ``args["steps"]`` synthetic batches: each step's
    loss and grad norm, kernel 14's plain launches per step and the final
    parameters, unsharded."""
    import dataclasses

    import numpy as np
    import torch

    from tony_tpu_torch.models.convert import shards_from_numpy
    from tony_tpu_torch.models.llama import LlamaConfig, logical_axes
    from tony_tpu_torch.ops import overlap as ov
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import tree_specs, unshard_tree
    from tony_tpu_torch.train.data import DataConfig, make_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg = LlamaConfig.tiny(**args["model"])
    opt = default_optimizer(**args["opt"])
    tree = _load_tree(args["params"])
    set_default_mesh(mesh)
    state = make_train_state(cfg, opt, mesh=mesh, device="cpu",
                             params=shards_from_numpy(tree, cfg, mesh, device="cpu"))
    step = make_train_step(cfg, opt, mesh=mesh,
                           grad_bucket_bytes=args.get("grad_bucket_bytes"))
    batches = make_batches(dataclasses.replace(DataConfig(**args["data"]), prefetch=0),
                           device="cpu", mesh=mesh)
    # top-k is discrete: the smallest gap between each row's k-th and
    # (k+1)-th router probability over every call, so a test can tell a
    # route that flipped from a numerical error
    margins: list = []
    if cfg.is_moe:
        import torch

        from tony_tpu_torch.parallel import moe as pm

        select = pm._top_k_select

        def recording(probs, mcfg):
            top = torch.sort(probs.detach(), dim=-1, descending=True).values
            margins.append(float((top[:, mcfg.top_k - 1] - top[:, mcfg.top_k]).min()))
            return select(probs, mcfg)

        pm._top_k_select = recording
    losses, norms, launches, aux = [], [], [], []
    for _ in range(args["steps"]):
        ov.reset_launches()
        state, m = step(state, *next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        launches.append(dict(ov.LAUNCHES))
        if "aux" in m:
            aux.append(float(m["aux"]))
    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v.detach().numpy()})
        return out

    # the whole parameters again, all-gathered from every rank's blocks
    full = unshard_tree(state.params, tree_specs(logical_axes(cfg)), mesh)
    if cfg.is_moe:
        pm._top_k_select = select
    return {"loss": losses, "grad_norm": norms, "launches": launches, "aux": aux,
            "margin": min(margins, default=None), "params": flat(full)}


def _load_tree(path: str) -> dict:
    """A nested dict of numpy arrays from an ``.npz`` of ``/``-joined keys."""
    import numpy as np

    flat = np.load(path)
    tree: dict = {}
    for key in flat.files:
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = flat[key]
    return tree


def _fit(args: dict, mesh) -> dict:
    """``fit()`` on the CPU over the group this rank joined; ``args["fit"]``
    holds further ``FitConfig`` fields."""
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    seen: list = []
    cfg = FitConfig(model=LlamaConfig.tiny(**args["model"]), data=DataConfig(**args["data"]),
                    mesh_shape=MeshShape(**args["mesh"]), steps=args["steps"], log_every=1,
                    lr=5e-3, warmup_steps=1, overlap_impl=args.get("overlap_impl", ""),
                    checkpoint_dir=args.get("checkpoint_dir", ""), on_metrics=seen.append,
                    **args.get("fit", {}))
    try:
        final = fit(cfg, device="cpu")
    except NotImplementedError as err:
        return {"refused": str(err)}
    return {"final": final, "metrics": seen}


def _moe_block(args: dict, mesh) -> dict:
    """``moe_block`` on this rank's rows of ``x`` with the whole router and
    this rank's ep block of the experts, for each case of ``args["cases"]``
    (overlap impl, chunk, poisoned rows): the global ``y``, ``aux`` and the
    gradients of ``sum(y * y) + aux`` (each rank adds ``aux / n``) for the
    router, w1, w3, w2 and x, assembled whole on every rank."""
    import dataclasses

    import numpy as np
    import torch

    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel import moe as pm
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import shard, unshard

    data = np.load(args["inputs"])
    rows = (("dp", "fsdp", "ep"), None, None)
    experts = ("ep", None, None)
    base = pm.MoEConfig(**args["cfg"])
    n = mesh.size
    set_default_mesh(mesh)
    out = []
    for case in args["cases"]:
        cfg = dataclasses.replace(base, overlap_impl=case["impl"],
                                  overlap_chunk=case.get("chunk", 0))
        x_full = data["x_poisoned"] if case.get("poison") else data["x"]
        x = shard(torch.from_numpy(x_full), rows, mesh).requires_grad_(True)
        params = {"router": torch.from_numpy(data["router"]).requires_grad_(True)}
        for name in ("w1", "w3", "w2"):
            params[name] = shard(torch.from_numpy(data[name]), experts, mesh).requires_grad_(True)
        y, aux = pm.moe_block(params, x, cfg)
        loss = (y * y).sum() + aux / n
        names = ["router", "w1", "w3", "w2"]
        grads = dict(zip(names + ["x"], torch.autograd.grad(
            loss, [params[k] for k in names] + [x])))
        router = grads["router"]
        for a in ("dp", "fsdp", "ep"):
            router = pdist.all_reduce(router, mesh.axis(a))
        res = {"y": unshard(y.detach(), rows, mesh).numpy(), "aux": float(aux),
               "router": router.numpy(), "x": unshard(grads["x"], rows, mesh).numpy()}
        for name in ("w1", "w3", "w2"):
            g = grads[name]
            for a in ("dp", "fsdp"):
                g = pdist.all_reduce(g, mesh.axis(a))
            res[name] = unshard(g, experts, mesh).numpy()
        out.append(res)
    set_default_mesh(None)
    return {"cases": out}


def _restore(args: dict, mesh) -> dict:
    """A template state at ``args["mesh"]`` restored from
    ``args["checkpoint_dir"]``: the step restored and the parameters and
    moments, all-gathered whole."""
    from tony_tpu_torch.models.llama import LlamaConfig, logical_axes
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import tree_specs, unshard_tree
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.trainer import default_optimizer, make_train_state

    cfg = LlamaConfig.tiny(**args["model"])
    set_default_mesh(mesh)
    template = make_train_state(cfg, default_optimizer(), seed=7, mesh=mesh, device="cpu")
    specs = tree_specs(logical_axes(cfg))
    state, step = CheckpointManager(args["checkpoint_dir"], mesh=mesh,
                                    specs=specs).restore(template)
    whole = {k: unshard_tree(t, specs, mesh) for k, t in
             (("params", state.params), ("mu", state.opt_state["mu"]),
              ("nu", state.opt_state["nu"]))}
    set_default_mesh(None)
    return {"step": step, "state_step": state.step, "count": state.opt_state["count"],
            "whole": {g: {"/".join(p): t.detach().numpy() for p, t in _items(tree)}
                      for g, tree in whole.items()}}


def _items(tree: dict, prefix: tuple = ()) -> list:
    out: list = []
    for k, v in tree.items():
        out.extend(_items(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])
    return out


def _killed_save(args: dict, mesh) -> dict:
    """A save at step 1, then a save at step 2 during which rank 1 is
    killed right after its rank file is on disk: rank 0 meets the broken
    group in the barrier and reports what it raised."""
    import os
    import signal

    from tony_tpu_torch.models.llama import LlamaConfig, logical_axes
    from tony_tpu_torch.parallel.sharding import tree_specs
    from tony_tpu_torch.train import checkpoint as ck
    from tony_tpu_torch.train.trainer import default_optimizer, make_train_state

    cfg = LlamaConfig.tiny(**args["model"])
    state = make_train_state(cfg, default_optimizer(), mesh=mesh, device="cpu")
    manager = ck.CheckpointManager(args["checkpoint_dir"], mesh=mesh,
                                   specs=tree_specs(logical_axes(cfg)))
    manager.save(1, state, force=True)
    write = ck._write

    def dying_write(path, fn):
        write(path, fn)
        if mesh.rank == 1 and path.endswith("rank1.pt"):
            os.kill(os.getpid(), signal.SIGKILL)

    ck._write = dying_write
    try:
        manager.save(2, state, force=True)
    except Exception as err:       # the dead peer, met in the barrier
        return {"raised": type(err).__name__, "group_broken": True}
    return {"raised": None}


TASKS = {"ring": _ring, "train": _train, "fit": _fit, "moe_block": _moe_block,
         "restore": _restore, "killed_save": _killed_save}


def main(path: str) -> None:
    job = json.loads(Path(path).read_text())
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.parallel.mesh import MeshShape, build_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], job["world"]),
                            rank=job["rank"], world_size=job["world"],
                            timeout=timedelta(seconds=job["args"].get("timeout_s", 1800)))
    results = []
    for run in job["args"]["runs"]:
        task = run.get("task", job["task"])
        if task == "fit":              # fit() builds its own mesh
            results.append(_fit(run, None))
            continue
        mesh = build_mesh(MeshShape(**run["mesh"]))
        results.append(TASKS[task](run, mesh))
    broken = any(isinstance(r, dict) and r.get("group_broken") for r in results)
    if not broken:
        dist.barrier()
        dist.destroy_process_group()
    torch.save({"runs": results, "jax_loaded": "jax" in sys.modules,
                "tony_tpu_loaded": "tony_tpu" in sys.modules}, job["out"])
    if broken:                     # a peer died: leave without the group's teardown
        os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
