#!/usr/bin/env python3
"""chip_smoke's phase 18 alone on one GPU: an elastic job that survives a
dead member.

Run from the root of the repository on a machine with the card::

    python3 scripts/torch_phase18.py [--steps N] [--pace S]

It builds every kernel source, then runs ``chip_smoke.elastic_job_phase``:
``tony chaos`` of the example job under the ``elastic`` runtime, a chief
and one member on gloo sharing the card (bench_1b4 at full width and 2
layers, ``ce_impl=pallas``), the member's container killed after the
chief's first step, the shrink, the relaunch and the grow, held against a
one-process twin. ``--steps`` and ``--pace`` set the chief's step count
and its pause a step (chip_smoke's ELASTIC_JOB_STEPS and
ELASTIC_JOB_PACE_S). It prints what chip_smoke prints for phase 18,
beside the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=cs.ELASTIC_JOB_STEPS)
    p.add_argument("--pace", type=float, default=cs.ELASTIC_JOB_PACE_S)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_phase18: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    cs.disarm_spine()
    torch.backends.cuda.matmul.allow_tf32 = False
    from tony_tpu_torch.ops._build import load

    cs.ELASTIC_JOB_STEPS, cs.ELASTIC_JOB_PACE_S = args.steps, args.pace
    card = cs.card_line()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cs.KERNEL_SOURCES)) as pool:
        list(pool.map(load, cs.KERNEL_SOURCES))
    cs.log(f"build {time.perf_counter() - t0:.1f} s  [{card}]")
    ej = cs.elastic_job_phase(card)
    cs.elastic_job_log(card, ej)
    cs.log(f"total {time.perf_counter() - t0:.1f} s  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
