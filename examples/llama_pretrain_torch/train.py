"""Llama pretraining under ``tony submit``, through the port's ``fit()``.

The port's counterpart of ``examples/llama_pretrain/train.py``. At
``--preset bench_1b4`` the model is ``train/presets.py``'s
``bench_1b4_recipe`` (flash attention, remat ``save_attn_kernel``) and
the defaults are the recipe's bench run: batch 8 x 2048, lr 3e-4, warmup
2, a bfloat16 first moment, a push every step. The device defaults to
CUDA and raises without it; ``--device cpu`` runs on the CPU.

Inside a job the ``pytorch`` runtime exports ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, and
``fit()`` forms the default process group from them (NCCL on a card,
gloo on the CPU). ``--backend gloo`` forms it on gloo here first, which
``fit()`` keeps: two ranks on one card cannot share NCCL, since the
runtime gives every rank ``LOCAL_RANK`` 0. ``fit()`` pushes its metrics
to the job's AM and reads the ``checkpoint.*`` keys from the env.

Under the ``elastic`` runtime the script is the chief's command, and each
other member runs it as its rank through ``python -m
tony_tpu_torch.elastic.member``; a relaunched member joins the running
gang instead of forming a group (``parallel/dist.py`` ``initialize``).

At the end each rank prints one JSON line: the final report and every
kernel module's launch counts.

Submit:
    python -m tony_tpu_torch.cli submit \\
        --conf examples/llama_pretrain_torch/tony.toml \\
        --src-dir examples/llama_pretrain_torch
Standalone, one process:
    python examples/llama_pretrain_torch/train.py --preset bench_1b4 --steps 10
"""

import argparse
import importlib
import json
import logging
import os
import time
from dataclasses import replace


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="bench_1b4", choices=["bench_1b4", "tiny"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--layers", type=int, default=0, help="cut the depth (0: the preset's)")
    p.add_argument("--seed", type=int, default=0, help="the synthetic stream's seed")
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--ce-impl", default="", help="loss head: scan | pallas | dense")
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    p.add_argument("--backend", default="", choices=["", "gloo"],
                   help="form the default group on gloo before fit()")
    p.add_argument("--marker", default="",
                   help="touch this file after every step, on rank 0 (a chaos fault's "
                        "on_file arms on it); in a job it takes the place of the "
                        "metric pushes")
    p.add_argument("--pace", type=float, default=0.0,
                   help="with --marker, sleep this many seconds after a step while the "
                        "group is smaller than the launch's world (an elastic job short "
                        "of a member: the relaunch's window)")
    args = p.parse_args()

    import torch
    import torch.distributed as dist

    from tony_tpu_torch.models.llama import LlamaConfig
    from tony_tpu_torch.parallel.dist import initialize
    from tony_tpu_torch.train import DataConfig, FitConfig, fit
    from tony_tpu_torch.train.presets import bench_1b4_recipe

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.backend == "gloo":
        initialize(torch.device(args.device or "cuda"), backend="gloo")
    model = bench_1b4_recipe() if args.preset == "bench_1b4" else LlamaConfig.tiny()
    if args.layers:
        model = replace(model, n_layers=args.layers)
    on_metrics = None
    if args.marker:
        world = int(os.environ.get("WORLD_SIZE", "1"))

        def on_metrics(m: dict) -> None:
            open(args.marker, "a").close()
            if dist.is_initialized() and dist.get_world_size() < world:
                time.sleep(args.pace)
    final = fit(FitConfig(
        model=model,
        data=DataConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                        vocab_size=model.vocab_size, seed=args.seed),
        steps=args.steps, log_every=1, lr=3e-4, warmup_steps=2, mu_dtype="bfloat16",
        ce_impl=args.ce_impl, on_metrics=on_metrics,
    ), device=args.device)
    launches = {}
    for name in ("attention", "fused_ce", "decode_attention", "grouped_mm", "quant_mm",
                 "overlap"):
        launches.update(importlib.import_module(f"tony_tpu_torch.ops.{name}").LAUNCHES)
    rank = dist.get_rank() if dist.is_initialized() else 0
    print(json.dumps({"rank": rank, "final": final, "launches": launches}), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
