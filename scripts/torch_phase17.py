#!/usr/bin/env python3
"""chip_smoke's phase 17 alone on one GPU: the operator's tools.

Run from the root of the repository on a machine with the card::

    python3 scripts/torch_phase17.py

It builds every kernel source, trains phase 5b's fit() in this process
(bench_1b4, ``ce_impl="pallas"``, 10 steps; no profile window), submits
phase 15a's example job through the port's CLI (``chip_smoke.job_phase``,
held against that fit()), then runs ``chip_smoke.operator_phase``: 17a
``tony chaos`` over the same job with a checkpoint every 5 steps and
worker:0 killed once step 5's landed, 17b the read-side tools and the
portal on its app dir, 17c ``tony profile`` against the job live on the
card. It prints what chip_smoke prints for phases 15a and 17, beside the
card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase17: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.disarm_spine()
    torch.backends.cuda.matmul.allow_tf32 = False
    from tony_tpu_torch.ops import attention, fused_ce
    from tony_tpu_torch.ops._build import load
    from tony_tpu_torch.train import DataConfig, FitConfig, fit

    card = cs.card_line()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cs.KERNEL_SOURCES)) as pool:
        list(pool.map(load, cs.KERNEL_SOURCES))
    cs.log(f"build {time.perf_counter() - t0:.1f} s  [{card}]")
    cfg = cs.dense_train_config()
    steps: list[dict] = []
    attention.reset_launches()
    fused_ce.reset_launches()
    final = fit(FitConfig(model=cfg, data=DataConfig(global_batch=8, seq_len=2048,
                                                     vocab_size=cfg.vocab_size),
                          steps=cs.TRAIN_STEPS, log_every=1, lr=3e-4, warmup_steps=2,
                          mu_dtype="bfloat16", ce_impl="pallas", on_metrics=steps.append),
                device="cuda")
    ce = {"losses": [m["loss"] for m in steps], "final": final,
          "launches": {**attention.LAUNCHES, **fused_ce.LAUNCHES}}
    cs.log(f"5b's fit(): losses {ce['losses']}, p50 {final['step_time_p50_s'] * 1e3:.1f} ms"
           f"  [{card}]")
    torch.cuda.empty_cache()
    ja = cs.job_phase(card, ce)
    cs.log(f"15a: submit latency {ja['job']['latency']}, job wall {ja['job']['wall_s']:.1f} s, "
           f"losses {ja['losses']}  [{card}]")
    t0 = time.perf_counter()
    cs.operator_phase(card, ja, ce)
    cs.log(f"phase 17 wall {time.perf_counter() - t0:.1f} s  [{card}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
