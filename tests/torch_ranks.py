"""One rank of a gloo process group for the port's multi-rank CPU tests.

Run as a script, one process per rank::

    python tests/torch_ranks.py JOB.json

``JOB.json`` names the world size, this rank, a ``FileStore`` path (each
test's own ``tmp_path``, so concurrent tests never share a port), the
task and its inputs; the rank writes its results with ``torch.save`` to
the job's ``out`` path. This file imports neither JAX nor the JAX package
(``tests/test_torch_imports.py`` checks), and each rank reports whether
JAX was loaded by the time it finished. :func:`spawn` starts the ranks and
joins them under one time limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spawn(world: int, task: str, args: dict, tmp: Path, timeout_s: float = 120.0) -> list:
    """Run ``task`` on ``world`` gloo ranks, each its own process, and
    return their results in rank order. Raises if a rank fails, or kills
    them all and raises if they have not all finished within
    ``timeout_s``."""
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
    bad = [(r, p.returncode, logs[r][-3000:]) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"{task}: ranks failed: {bad}")
    import torch

    return [torch.load(tmp / f"{task}-{r}.pt", weights_only=False) for r in range(world)]


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
    flat = np.load(args["params"])
    tree: dict = {}
    for key in flat.files:
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = flat[key]
    set_default_mesh(mesh)
    state = make_train_state(cfg, opt, mesh=mesh, device="cpu",
                             params=shards_from_numpy(tree, cfg, mesh, device="cpu"))
    step = make_train_step(cfg, opt, mesh=mesh,
                           grad_bucket_bytes=args.get("grad_bucket_bytes"))
    batches = make_batches(dataclasses.replace(DataConfig(**args["data"]), prefetch=0),
                           device="cpu", mesh=mesh)
    losses, norms, launches = [], [], []
    for _ in range(args["steps"]):
        ov.reset_launches()
        state, m = step(state, *next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        launches.append(dict(ov.LAUNCHES))
    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v.detach().numpy()})
        return out

    # the whole parameters again, all-gathered from every rank's blocks
    full = unshard_tree(state.params, tree_specs(logical_axes(cfg)), mesh)
    return {"loss": losses, "grad_norm": norms, "launches": launches, "params": flat(full)}


def _fit(args: dict, mesh) -> dict:
    """``fit()`` on the CPU over the group this rank joined."""
    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    seen: list = []
    cfg = FitConfig(model=LlamaConfig.tiny(**args["model"]), data=DataConfig(**args["data"]),
                    mesh_shape=MeshShape(**args["mesh"]), steps=args["steps"], log_every=1,
                    lr=5e-3, warmup_steps=1, overlap_impl=args["overlap_impl"],
                    checkpoint_dir=args.get("checkpoint_dir", ""), on_metrics=seen.append)
    try:
        final = fit(cfg, device="cpu")
    except NotImplementedError as err:
        return {"refused": str(err)}
    return {"final": final, "metrics": seen}


TASKS = {"ring": _ring, "train": _train, "fit": _fit}


def main(path: str) -> None:
    job = json.loads(Path(path).read_text())
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.parallel.mesh import MeshShape, build_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], job["world"]),
                            rank=job["rank"], world_size=job["world"])
    results = []
    for run in job["args"]["runs"]:
        if job["task"] == "fit":       # fit() builds its own mesh
            results.append(_fit(run, None))
            continue
        mesh = build_mesh(MeshShape(**run["mesh"]))
        results.append(TASKS[job["task"]](run, mesh))
    dist.barrier()
    dist.destroy_process_group()
    torch.save({"runs": results, "jax_loaded": "jax" in sys.modules,
                "tony_tpu_loaded": "tony_tpu" in sys.modules}, job["out"])


if __name__ == "__main__":
    main(sys.argv[1])
