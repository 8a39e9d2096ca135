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


def _attention(args: dict, mesh) -> dict:
    """An attention hook (``args["impl"]``: ring, ring_flash or ulysses)
    over this rank's block of q, k, v (rows, sequence block over sp, heads
    over tp): the output and the gradients of ``sum(out ** 2)``, each
    all-gathered whole, and the flash passes' plain launches."""
    import numpy as np
    import torch

    from tony_tpu_torch.ops import attention as at
    from tony_tpu_torch.parallel.ring_attention import (
        make_ring_attention, make_ring_flash_attention,
    )
    from tony_tpu_torch.parallel.sharding import attn_spec, shard, unshard
    from tony_tpu_torch.parallel.ulysses import make_ulysses_attention

    data = np.load(args["inputs"])
    spec = attn_spec(mesh, seq_axis="sp")
    make = {"ring": make_ring_attention, "ring_flash": make_ring_flash_attention,
            "ulysses": make_ulysses_attention}[args["impl"]]
    xs = [shard(torch.from_numpy(data[n]), spec, mesh).requires_grad_(True)
          for n in ("q", "k", "v")]
    at.reset_launches()
    out = make(mesh)(*xs)
    grads = torch.autograd.grad((out * out).sum(), xs)
    return {"out": unshard(out.detach(), spec, mesh).numpy(),
            "grads": [unshard(g, spec, mesh).numpy() for g in grads],
            "launches": dict(at.LAUNCHES)}


def _pipeline(args: dict, mesh) -> dict:
    """The pipeline schedules on toy stages over this rank's pp axis, for
    each case of ``args["cases"]`` (the reference's ``TestPipeline`` and
    ``Test1F1B`` shapes): ``gpipe`` runs ``pipeline_apply`` and the
    gradients of ``sum(out ** 2)``; ``1f1b`` runs ``pipeline_train_1f1b``
    with a CE head. Each returns the values and the gradients, the stage
    weights' summed over pp into the whole stack."""
    import numpy as np
    import torch

    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel.pipeline import (
        microbatch, pipeline_apply, pipeline_train_1f1b, unmicrobatch,
    )
    from tony_tpu_torch.parallel.sharding import shard

    data = np.load(args["inputs"])
    axis = mesh.axis("pp")

    def head_fn(hw, y, t):
        logits = y @ hw
        sel = logits.gather(-1, t.long().unsqueeze(-1)).squeeze(-1)
        return (torch.logsumexp(logits, dim=-1) - sel).mean()

    out = []
    for case in args["cases"]:
        name, M = case["name"], case["M"]
        Ws = torch.from_numpy(data[f"{name}/Ws"]).requires_grad_(True)
        x = torch.from_numpy(data[f"{name}/x"]).requires_grad_(True)
        if case["kind"] == "gpipe":
            y = unmicrobatch(pipeline_apply(lambda W, h: torch.tanh(h @ W), Ws,
                                            microbatch(x, M), mesh=mesh))
            gW, gx = torch.autograd.grad((y * y).sum(), (Ws, x))
            res = {"out": y.detach().numpy(), "Ws": pdist.all_reduce(gW, axis).numpy(),
                   "x": gx.numpy()}
        else:
            hw = torch.from_numpy(data[f"{name}/head"]).requires_grad_(True)
            tgt = torch.from_numpy(data[f"{name}/tgt"])
            block = shard(Ws, ("pp",), mesh)
            loss = pipeline_train_1f1b(lambda W, h: torch.tanh(h @ W[0]), head_fn, block, hw,
                                       microbatch(x, M), microbatch(tgt, M), mesh=mesh)
            gW, gh, gx = torch.autograd.grad(loss, (Ws, hw, x))
            res = {"loss": float(loss), "Ws": pdist.all_reduce(gW, axis).numpy(),
                   "head": gh.numpy(), "x": gx.numpy()}
        out.append(res)
    return {"cases": out}


def _pp_memory(args: dict, mesh) -> dict:
    """The bytes autograd holds for the backward at their peak, over one
    forward and backward of each pipeline loss of the trainer on this
    rank's stage (``saved_tensors_hooks``: each saved tensor counted from
    its pack until its graph lets it go)."""
    import dataclasses

    import torch

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.train.data import DataConfig, make_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, pp_1f1b_loss_from_pairs, pp_loss_from_pairs,
    )

    cfg = tiny_config(LlamaConfig, args["model"])
    state = make_train_state(cfg, default_optimizer(), mesh=mesh, device="cpu")
    M = args["microbatches"]
    inputs, targets = next(make_batches(
        dataclasses.replace(DataConfig(**args["data"]), prefetch=0), device="cpu", mesh=mesh,
        microbatches=M))
    live, peak = [0], [0]

    class Held:
        def __init__(self, t):
            self.t, self.n = t, t.numel() * t.element_size()
            live[0] += self.n
            peak[0] = max(peak[0], live[0])

        def __del__(self):
            live[0] -= self.n

    out = {}
    for name, loss_fn in (("gpipe", pp_loss_from_pairs), ("1f1b", pp_1f1b_loss_from_pairs)):
        live[0] = peak[0] = 0
        with torch.autograd.graph.saved_tensors_hooks(Held, lambda h: h.t):
            loss, _ = loss_fn(state.params, inputs, targets, cfg=cfg, mesh=mesh,
                              n_microbatches=M)
            torch.autograd.grad(loss, [state.params["layers"]["wq"]])
        out[name] = {"peak_bytes": peak[0], "loss": float(loss)}
    return out


def pp_card_run(args: dict, mesh) -> dict:
    """The trainer's 1F1B loss (``pipeline_train_1f1b`` over real
    transformer stages) of a bf16 model from a seed on the card, this
    rank's stage of it under ``pp_rules``: the loss, every parameter's
    gradient all-gathered whole (float32), and the flash kernels'
    launches. At a one-rank ``mesh`` the whole model is one stage: the
    one-rank schedule."""
    import dataclasses

    import numpy as np
    import torch

    from tony_tpu_torch.models.llama import LlamaConfig, init_params, logical_axes
    from tony_tpu_torch.ops import attention as at
    from tony_tpu_torch.parallel.sharding import pp_rules, shard_tree, tree_specs, unshard_tree
    from tony_tpu_torch.train.trainer import pp_1f1b_loss_from_pairs, tree_leaves, tree_map

    cfg = dataclasses.replace(LlamaConfig(**args["model"]), dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(args["seed"]),
                         device="cuda")
    specs = tree_specs(logical_axes(cfg), pp_rules())
    local = shard_tree(params, specs, mesh)
    for t in tree_leaves(local):
        t.requires_grad_(True)
    tokens = np.random.default_rng(args["seed"]).integers(
        0, cfg.vocab_size, (args["batch"], args["seq"] + 1))
    tokens = torch.from_numpy(tokens).to("cuda")
    at.reset_launches()
    loss, _ = pp_1f1b_loss_from_pairs(local, tokens[:, :-1], tokens[:, 1:], cfg=cfg, mesh=mesh,
                                      n_microbatches=args["microbatches"])
    grads = iter(torch.autograd.grad(loss, tree_leaves(local)))
    whole = unshard_tree(tree_map(lambda _: next(grads), local), specs, mesh)
    return {"loss": float(loss.detach()), "launches": dict(at.LAUNCHES),
            "grads": {"/".join(p): t.float().cpu().numpy() for p, t in _items(whole)}}


def moe_tp_card_run(args: dict, mesh) -> dict:
    """One loss and backward of a MoE model from a seed on the card
    (``args["preset"]`` with ``args["knobs"]``, in ``args["dtype"]``), the
    layers this rank's tp
    blocks under the rules' specs and the tables whole, under ``mesh`` as
    the default mesh: the loss, the aux, every parameter's gradient
    (float32; the layers' all-gathered whole) and kernels 11-13's
    launches. At a one-rank ``mesh`` this is the one-rank step."""
    import dataclasses

    import numpy as np
    import torch

    from tony_tpu_torch.models import llama
    from tony_tpu_torch.ops import grouped_mm
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import shard_tree, tree_specs, unshard_tree
    from tony_tpu_torch.train.trainer import tree_leaves, tree_map

    # the preset fixes n_layers: it is replaced after, as tiny_config does
    cfg = dataclasses.replace(getattr(llama.LlamaConfig, args["preset"])(
        dtype=getattr(torch, args["dtype"])), **args["knobs"])
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(args["seed"]),
                               device="cuda")
    specs = tree_specs(llama.logical_axes(cfg))["layers"]
    local = {**params, "layers": shard_tree(params["layers"], specs, mesh)}
    for t in tree_leaves(local):
        t.requires_grad_(True)
    tokens = np.random.default_rng(args["seed"]).integers(
        0, cfg.vocab_size, (args["batch"], args["seq"] + 1))
    tokens = torch.from_numpy(tokens).to("cuda")
    set_default_mesh(mesh)
    try:
        grouped_mm.reset_launches()
        loss, aux = llama.loss_and_aux(local, tokens[:, :-1], tokens[:, 1:], cfg)
        grads = iter(torch.autograd.grad(loss, tree_leaves(local)))
        whole = tree_map(lambda _: next(grads), local)
        whole["layers"] = unshard_tree(whole["layers"], specs, mesh)
    finally:
        set_default_mesh(None)
    return {"loss": float(loss.detach()), "aux": float(aux.detach()),
            "launches": dict(grouped_mm.LAUNCHES),
            "shapes": {k: tuple(local["layers"][k].shape) for k in ("w1", "w3", "w2")},
            "grads": {"/".join(p): t.float().cpu().numpy() for p, t in _items(whole)}}


def _train(args: dict, mesh) -> dict:
    """``make_train_step`` from the reference's parameters (cut into this
    rank's blocks) over ``args["steps"]`` synthetic batches: each step's
    loss and grad norm, kernel 14's plain launches per step (and the
    flash and CE kernels'), its health monitors (``args["monitors"]``)
    and the final parameters, unsharded. With ``args["reseed"]`` (one
    ``{"params", "mu", "nu"}`` of ``.npz`` paths a step) each step starts
    from that state, cut into this rank's blocks."""
    import dataclasses

    import numpy as np
    import torch

    from tony_tpu_torch.models.convert import shards_from_numpy
    from tony_tpu_torch.models.llama import LlamaConfig, logical_axes
    from tony_tpu_torch.ops import attention as at
    from tony_tpu_torch.ops import fused_ce as fc
    from tony_tpu_torch.ops import overlap as ov
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import (
        DEFAULT_RULES, mesh_rules, tree_specs, unshard_tree,
    )
    from tony_tpu_torch.train.data import DataConfig, make_batches
    from tony_tpu_torch.train.trainer import (
        default_optimizer, make_train_state, make_train_step,
    )

    cfg = tiny_config(LlamaConfig, args["model"])
    opt = default_optimizer(**args["opt"])
    tree = _load_tree(args["params"])
    set_default_mesh(mesh)
    state = make_train_state(cfg, opt, mesh=mesh, device="cpu",
                             params=shards_from_numpy(tree, cfg, mesh, device="cpu"))
    pp = mesh.shape["pp"]
    microbatches = (args.get("microbatches") or 2 * pp) if pp > 1 else 0
    step = make_train_step(cfg, opt, mesh=mesh, n_microbatches=microbatches,
                           pp_schedule=args.get("pp_schedule", "gpipe"),
                           grad_bucket_bytes=args.get("grad_bucket_bytes"),
                           monitors=args.get("monitors"))
    batches = make_batches(dataclasses.replace(DataConfig(**args["data"]), prefetch=0),
                           device="cpu", mesh=mesh, microbatches=microbatches)
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
    losses, norms, launches, aux, kernels, monitors = [], [], [], [], [], []
    for i in range(args["steps"]):
        if args.get("reseed"):
            files = args["reseed"][i]
            for dst, part in ((state.params, "params"), (state.opt_state["mu"], "mu"),
                              (state.opt_state["nu"], "nu")):
                copy_tree(dst, shards_from_numpy(_load_tree(files[part]), cfg, mesh,
                                                 device="cpu"))
        ov.reset_launches()
        at.reset_launches()
        fc.reset_launches()
        state, m = step(state, *next(batches))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        launches.append(dict(ov.LAUNCHES))
        kernels.append({**at.LAUNCHES, **fc.LAUNCHES})
        if "aux" in m:
            aux.append(float(m["aux"]))
        monitors.append({k: v.detach().numpy() for k, v in m.items()
                         if k.startswith("health/")})

    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v.detach().numpy()})
        return out

    # the whole parameters again, all-gathered from every rank's blocks
    full = unshard_tree(state.params, tree_specs(logical_axes(cfg), mesh_rules(DEFAULT_RULES,
                                                                               mesh)), mesh)
    if cfg.is_moe:
        pm._top_k_select = select
    return {"loss": losses, "grad_norm": norms, "launches": launches, "aux": aux,
            "kernels": kernels, "margin": min(margins, default=None), "params": flat(full),
            "monitors": monitors}


def tiny_config(cls, knobs: dict):
    """``cls.tiny(**knobs)``, with ``n_layers`` among the knobs too (the
    preset fixes it, so it is replaced after)."""
    import dataclasses

    knobs = dict(knobs)
    layers = knobs.pop("n_layers", None)
    cfg = cls.tiny(**knobs)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def copy_tree(dst: dict, src: dict) -> None:
    """``src``'s tensors copied into ``dst``'s of the same paths, in place."""
    import torch

    with torch.no_grad():
        for k, v in dst.items():
            if isinstance(v, dict):
                copy_tree(v, src[k])
            else:
                v.copy_(src[k])


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
    cfg = FitConfig(model=tiny_config(LlamaConfig, args["model"]),
                    data=DataConfig(**args["data"]),
                    mesh_shape=MeshShape(**args["mesh"]), steps=args["steps"], log_every=1,
                    lr=5e-3, warmup_steps=1, overlap_impl=args.get("overlap_impl", ""),
                    checkpoint_dir=args.get("checkpoint_dir", ""), on_metrics=seen.append,
                    **args.get("fit", {}))
    try:
        final = fit(cfg, device="cpu")
    except NotImplementedError as err:
        return {"refused": str(err)}
    return {"final": final, "metrics": seen}


def _anatomy(args: dict, mesh) -> dict:
    """``fit()`` (the ``fit`` task's run) with a profile controller armed
    on ``<args["app"]>``, whose broadcast request (written before the ranks
    start) opens one window on every rank, captured through
    ``obs/profile.py`` into ``<app>/profile/rank<r>/``; the byte counters
    and the comms ledger zeroed first. Returns the fit task's results,
    ``dist.BYTES`` and the ledger's totals after it."""
    import torch.distributed as dist

    from tony_tpu_torch.obs import comms, profile
    from tony_tpu_torch.parallel import dist as pdist

    app = args["app"]
    profile.install(profile.ProfileController(
        profile.profile_dir(app), f"rank{dist.get_rank()}",
        request_path=profile.request_path(app)))
    pdist.reset_bytes()
    try:
        out = _fit(args, mesh)
    finally:
        profile.uninstall()
    return {**out, "bytes": dict(pdist.BYTES), "totals": comms.totals()}


def _elastic(args: dict, mesh) -> dict:
    """Elastic ``fit()`` on the CPU over the group this rank joined:
    ``args["fit"]`` holds the ``FitConfig`` fields (``mesh`` the
    per-member shape, ``plan`` the scripted plan as ``[step, members]``
    pairs); ``args["params"]`` an ``.npz`` of the initial parameters (the
    reference's), cut into this rank's blocks; with ``args["poison"]`` a
    member rejoining a generation starts from a copy of the state filled
    with NaN; with ``args["kill"]`` a rank dies mid-step (:func:`_arm_kill`).
    Returns the final report,
    every push, the steps a poisoned join was made at and this rank's
    blocks of the parameters after the last step."""
    import torch

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.mesh import MeshShape
    from tony_tpu_torch.train import DataConfig, FitConfig, fit, loop

    join = loop._Elastic._join
    poisoned: list = []

    def poisoning_join(self, rec, step, host, state, rebuild, t0):
        if host is None:
            with torch.no_grad():
                for tree in (state.params, state.opt_state["mu"], state.opt_state["nu"]):
                    for t in loop.tree_leaves(tree):
                        t.fill_(float("nan"))
            poisoned.append(step)
        return join(self, rec, step, host, state, rebuild, t0)

    if args.get("poison"):
        loop._Elastic._join = poisoning_join
    if args.get("kill"):
        _arm_kill(args["kill"], args["fit"]["elastic_dir"])
    make_state = loop.make_train_state
    if args.get("params"):
        from tony_tpu_torch.models.convert import shards_from_numpy

        tree = _load_tree(args["params"])

        def seeded(model, optimizer, **kw):
            kw["params"] = shards_from_numpy(tree, model, kw["mesh"], kw["rules"], device="cpu")
            return make_state(model, optimizer, **kw)

        loop.make_train_state = seeded
    seen: list = []
    kw = dict(args["fit"])
    plan = {int(step): tuple(members) for step, members in kw.pop("plan", [])}
    cfg = FitConfig(model=tiny_config(LlamaConfig, args["model"]),
                    data=DataConfig(**args["data"]),
                    mesh_shape=MeshShape(**kw.pop("mesh")) if "mesh" in kw else None,
                    log_every=1, on_metrics=seen.append, elastic_plan=plan or None, **kw)
    last: dict = {}
    step_fn = loop.make_train_step

    def recording_step(*a, **k):
        fn = step_fn(*a, **k)

        def step(state, inputs, targets):
            out = fn(state, inputs, targets)
            last["params"] = out[0].params
            return out
        return step

    loop.make_train_step = recording_step
    try:
        final = fit(cfg, device="cpu")
    finally:
        loop.make_train_step = step_fn
        loop.make_train_state = make_state
        loop._Elastic._join = join
    return {"final": final, "metrics": seen, "poisoned": poisoned,
            "params": {"/".join(p): t.detach().numpy() for p, t in _items(last["params"])}}


def _arm_kill(kill: dict, elastic_dir: str) -> None:
    """Rank ``kill["rank"]`` (one rank a member) dies by SIGKILL right after
    its dp gradient sum of step ``kill["step"]``, before the step's loss
    mean and the update, once it has declared its own loss in the
    generation file as a job's AM would: a shrink to the other members."""
    import signal

    import torch.distributed as dist

    from tony_tpu_torch import elastic
    from tony_tpu_torch.train import trainer

    me = dist.get_rank()
    if me != kill["rank"]:
        return
    psum, calls = trainer.bucketed_psum, []

    def dying(grads, axis, **kw):
        out = psum(grads, axis, **kw)
        if axis == "dp":
            calls.append(axis)
            if len(calls) == kill["step"] + 1:
                survivors = tuple(m for m in range(dist.get_world_size()) if m != me)
                elastic.write_generation(elastic_dir, elastic.GenerationRecord(
                    generation=1, members=survivors, boundary="shrink", dead=(me,),
                    reason="killed after its gradient sum"))
                os.kill(os.getpid(), signal.SIGKILL)
        return out

    trainer.bucketed_psum = dying


def _moe_block(args: dict, mesh) -> dict:
    """``moe_block`` on this rank's block of ``x`` (rows over dp, fsdp and
    ep, the sequence over sp) with the whole router and this rank's block
    of the experts (``E / ep`` of them, ``F / tp`` ffn columns), for each
    case of ``args["cases"]`` (overlap impl, chunk, poisoned rows, further
    ``MoEConfig`` fields): the global ``y``, ``aux`` and the gradients of
    ``sum(y * y) + aux`` (each rank of the batch axes adds ``aux / n``)
    for the router, w1, w3, w2 and x, assembled whole on every rank; for
    a capacity dispatch also the kept-route mask ``[B, S, k]`` and the
    capacity."""
    import dataclasses

    import numpy as np
    import torch

    from tony_tpu_torch.parallel import dist as pdist
    from tony_tpu_torch.parallel import moe as pm
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import shard, unshard

    data = np.load(args["inputs"])
    rows = (("dp", "fsdp", "ep"), "sp", None)
    experts = {"w1": ("ep", None, "tp"), "w3": ("ep", None, "tp"), "w2": ("ep", "tp", None)}
    base = pm.MoEConfig(**args["cfg"])
    n = mesh.size // mesh.shape["tp"]          # tp ranks share their rows
    set_default_mesh(mesh)
    out = []
    for case in args["cases"]:
        cfg = dataclasses.replace(base, overlap_impl=case["impl"],
                                  overlap_chunk=case.get("chunk", 0), **case.get("cfg", {}))
        x_full = data["x_poisoned"] if case.get("poison") else data["x"]
        x = shard(torch.from_numpy(x_full), rows, mesh).requires_grad_(True)
        params = {"router": torch.from_numpy(data["router"]).requires_grad_(True)}
        for name, spec in experts.items():
            params[name] = shard(torch.from_numpy(data[name]), spec, mesh).requires_grad_(True)
        y, aux = pm.moe_block(params, x, cfg)
        loss = (y * y).sum() + aux / n
        names = ["router", "w1", "w3", "w2"]
        grads = dict(zip(names + ["x"], torch.autograd.grad(
            loss, [params[k] for k in names] + [x])))
        router = grads["router"]
        for a in ("dp", "fsdp", "ep", "sp"):
            router = pdist.all_reduce(router, mesh.axis(a))
        res = {"y": unshard(y.detach(), rows, mesh).numpy(), "aux": float(aux),
               "router": router.numpy(), "x": unshard(grads["x"], rows, mesh).numpy(),
               "shapes": {k: tuple(params[k].shape) for k in experts}}
        for name, spec in experts.items():
            g = grads[name]
            for a in ("dp", "fsdp", "sp"):
                g = pdist.all_reduce(g, mesh.axis(a))
            res[name] = unshard(g, spec, mesh).numpy()
        if cfg.dispatch != "grouped":
            B, S, D = x.shape
            with torch.no_grad():
                probs = torch.softmax(x.reshape(-1, D) @ params["router"], dim=-1)
                _, _, pos, cap, _ = pm.capacity_routes(probs, cfg, mesh, (B, S))
            res["kept"] = unshard((pos < cap).reshape(B, S, -1), rows, mesh).numpy()
            res["capacity"] = cap
        out.append(res)
    set_default_mesh(None)
    return {"cases": out}


def _restore(args: dict, mesh) -> dict:
    """A template state at ``args["mesh"]`` restored from
    ``args["checkpoint_dir"]``: the step restored and the parameters and
    moments, all-gathered whole."""
    from tony_tpu_torch.models.llama import LlamaConfig, logical_axes
    from tony_tpu_torch.parallel.mesh import set_default_mesh
    from tony_tpu_torch.parallel.sharding import (
        DEFAULT_RULES, mesh_rules, tree_specs, unshard_tree,
    )
    from tony_tpu_torch.train.checkpoint import CheckpointManager
    from tony_tpu_torch.train.trainer import default_optimizer, make_train_state

    cfg = tiny_config(LlamaConfig, args["model"])
    set_default_mesh(mesh)
    template = make_train_state(cfg, default_optimizer(), seed=7, mesh=mesh, device="cpu")
    specs = tree_specs(logical_axes(cfg), mesh_rules(DEFAULT_RULES, mesh))
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


TASKS = {"ring": _ring, "attention": _attention, "train": _train, "fit": _fit,
         "elastic": _elastic, "anatomy": _anatomy,
         "moe_block": _moe_block, "restore": _restore, "killed_save": _killed_save,
         "pipeline": _pipeline, "pp_memory": _pp_memory, "pp_card": pp_card_run,
         "moe_tp_card": moe_tp_card_run}


def main(path: str) -> None:
    job = json.loads(Path(path).read_text())
    import torch
    import torch.distributed as dist

    from tony_tpu_torch.parallel.mesh import MeshShape, build_mesh

    torch.set_num_threads(1)
    if job["args"].get("cuda"):
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], job["world"]),
                            rank=job["rank"], world_size=job["world"],
                            timeout=timedelta(seconds=job["args"].get("timeout_s", 1800)))
    results = []
    for run in job["args"]["runs"]:
        task = run.get("task", job["task"])
        if task in ("fit", "elastic", "anatomy"):     # fit() builds its own mesh
            results.append(TASKS[task](run, None))
            continue
        mesh = build_mesh(MeshShape(**run["mesh"]))
        results.append(TASKS[task](run, mesh))
    broken = any(isinstance(r, dict) and r.get("group_broken") for r in results)
    # an elastic run re-forms the group; a rank it left out holds none
    if not broken and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    torch.save({"runs": results, "jax_loaded": "jax" in sys.modules,
                "tony_tpu_loaded": "tony_tpu" in sys.modules}, job["out"])
    if broken:                     # a peer died: leave without the group's teardown
        os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1])
